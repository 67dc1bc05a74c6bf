"""The port's caller (pecaller_tpu_torch.caller.run_caller, the screen on
the CPU) against the JAX package's run_caller on tests/test_screen.py's
fuzzed cohorts: (3, diploid), (5, diploid), (2, haploid), a pedigree
and a guide bed, each with the host phase 0 (host_screen True) and with
both screen phases on the device (host_screen False), and with the
exact native path (device_screen False).  A further cohort has enough
UNRES sites in a window (3 samples x 30,000 sites) that the host phase
0 hands them to the device's phase 1.

Tolerance: every artifact byte-equal (.snp, .dist; .base.gz and
.piles.gz decompressed).

With device_beam=True (the HARD sites through the joint-configuration
beam, caller/device_beam.py) the port's run_caller, host_screen True and
False, is byte-equal to its own run without the beam and to the JAX
run_caller with the beam, on the fuzzed cohorts above."""

import gzip
import os

import numpy as np
import pytest

import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu.caller import CallerConfig as JaxConfig
from pecaller_tpu.caller import run_caller as jax_run_caller
from pecaller_tpu.formats.pileup import write_pileup
from pecaller_tpu.index import build_index
from pecaller_tpu_torch.caller import CallerConfig, run_caller
from test_screen import _fuzz_counts, _mk_sdx
from util import make_genome, write_fasta

ARTIFACTS = (".snp", ".dist", ".base.gz", ".piles.gz")


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def _same(a, b):
    for ext in ARTIFACTS:
        assert _read(a + ext) == _read(b + ext), ext


def _run_pair(d, out, **kw):
    """The JAX and the port's caller on the cohort in d, for each screen
    mode; every artifact byte-equal.  Returns the port's last result."""
    args = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, directory=d, nthreads=2,
                **kw)
    res = None
    for mode in (dict(host_screen=True), dict(host_screen=False),
                 dict(device_screen=False)):
        tag = "_".join(f"{k}{int(v)}" for k, v in mode.items())
        jb, pb = str(out / f"jax_{tag}"), str(out / f"port_{tag}")
        jax_run_caller(JaxConfig(out_base=jb, **args, **mode))
        res = run_caller(CallerConfig(out_base=pb, device="cpu", **args,
                                      **mode))
        _same(pb, jb)
    return res


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_caller_matches_jax(tmp_path, indiv, haploid):
    rng = np.random.default_rng(42 + indiv + (100 if haploid else 0))
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, indiv, 600)
    for i in range(indiv):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    res = _run_pair(d, tmp_path, haploid=haploid)
    assert res["n_sites"] == 600 and res["screen_sites"] is None


def test_caller_matches_jax_ped(tmp_path):
    rng = np.random.default_rng(7)
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, 3, 400)
    for i, nm in enumerate(["dad", "mom", "kid"]):
        write_pileup(os.path.join(d, f"{nm}.pileup.gz"), pos, cnt[i])
    with open(os.path.join(d, "trio.ped"), "w") as f:
        f.write("fam1\tdad\t0\t0\t1\nfam1\tmom\t0\t0\t2\n"
                "fam1\tkid\tdad\tmom\t1\n")
    _run_pair(d, tmp_path, use_ped=True,
              ped_path=os.path.join(d, "trio.ped"), denovo_rate=1e-8)


def test_caller_matches_jax_guide(tmp_path):
    rng = np.random.default_rng(11)
    d = str(tmp_path / "work")
    os.makedirs(d)
    names, seqs = make_genome(rng, [3000, 1500], names=["chr1", "chrY"])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    for i in range(3):
        p1, c1 = _fuzz_counts(rng, seqs[0], 1, 300)
        p2, c2 = _fuzz_counts(rng, seqs[1], 1, 150)
        off = len(seqs[0]) + 15
        pos = np.concatenate([p1, p2 + off]).astype(np.uint32)
        cnt = np.concatenate([c1[0], c2[0]], axis=0)
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt)
    bed = os.path.join(d, "regions.bed")
    with open(bed, "w") as f:
        f.write("chr1\t10\t2990\nchrY\t10\t1490\n")
    _run_pair(d, tmp_path, guide_path=bed)


def test_caller_phase1_on_device_matches_jax(tmp_path):
    """30,000 het-ish sites of 3 samples in one window: more UNRES sites
    than the small-set rule (len(un) * indiv <= 65536) keeps on the
    host, so the host phase 0 hands them to the device's phase 1."""
    rng = np.random.default_rng(5)
    d = str(tmp_path / "work")
    os.makedirs(d)
    names, seqs = make_genome(rng, [32000], names=["chr1"])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    col = np.full(256, 0, np.int64)
    col[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    n = 30000
    pos = np.arange(1000, 1000 + n, dtype=np.uint32)
    rc = col[seqs[0][pos]]
    for i in range(3):
        depth = rng.integers(10, 40, n)
        alt = rng.integers(0, 12, n)          # 0-3 alt reads: UNRES-ish
        cnt = np.zeros((n, 6), np.uint16)
        cnt[np.arange(n), rc] = depth
        cnt[np.arange(n), (rc + 1) % 4] = np.where(alt < 4, alt,
                                                   alt - 4 + depth // 3)
        cnt[:, 5] = rng.random(n) < 0.3      # an Ins read: never simple
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt)
    _run_pair(d, tmp_path)
    # the default mode again, for its counts
    res = run_caller(CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
        out_base=str(tmp_path / "again"), directory=d, nthreads=2,
        device="cpu"))
    assert res["screen_sites"]["phase1"] > 65536 // 3
    assert res["screen_sites"]["phase0"] == 0
    codes = res["codes"]
    assert sum(codes.values()) == n and res["native_sites"] == codes["hard"]


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_caller_beam_matches_exact_and_jax(tmp_path, indiv, haploid):
    rng = np.random.default_rng(42 + indiv + (100 if haploid else 0))
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, indiv, 600)
    for i in range(indiv):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    args = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, directory=d, nthreads=2,
                haploid=haploid)
    for host in (True, False):
        bases = {k: str(tmp_path / f"{k}_{int(host)}")
                 for k in ("beam", "exact", "jax")}
        res = run_caller(CallerConfig(out_base=bases["beam"], device="cpu",
                                      host_screen=host, device_beam=True,
                                      **args))
        run_caller(CallerConfig(out_base=bases["exact"], device="cpu",
                                host_screen=host, **args))
        jax_run_caller(JaxConfig(out_base=bases["jax"], host_screen=host,
                                 device_beam=True, **args))
        _same(bases["beam"], bases["exact"])
        _same(bases["beam"], bases["jax"])
        assert res["beam_sites"] > 0
        assert res["beam_flagged"] < res["beam_sites"]
        assert res["native_sites"] == \
            res["codes"]["hard"] - res["beam_sites"] + res["beam_flagged"]
        assert {"beam", "beam_finish"} <= set(res["phases"])


def test_caller_beam_on_a_missing_card_raises(tmp_path):
    """device_beam=True with device="cuda" and no card raises: no quiet
    drop to the CPU or to the exact path."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(3)
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, 3, 50)
    for i in range(3):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_caller(CallerConfig(
            pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
            out_base=str(tmp_path / "out"), directory=d, device="cuda",
            device_beam=True))
