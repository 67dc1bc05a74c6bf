"""The port's run_mapper(device=True) and its command line against the
host path (byte-equal artifacts), its engine choice (v2 on the nbr
index, v2 on the quartered-key index where the nbr index refuses, v1
where both refuse) against the JAX runner's, its mesh_shards (a
reads-axis mesh of CPU shards), the quartered-key index builder's refusals
against the JAX builder's, and the threshold-boundary inputs of
tests/test_fused2.py.

Tolerance: byte equality of .summary.txt, the decompressed .pileup.gz
and .indel.txt.gz, and both .mfile dumps."""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2 as JaxEngine
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from pecaller_tpu_torch.mapper.runner import MapperConfig, run_mapper
from torch_util import make_fused2_data, shared_nbr
from util import BASES, REPO, make_genome, write_fasta

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused2_data(tmp_path_factory.mktemp("torch_runner"))


def _artifacts(out_base, r1, r2):
    got = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(out_base + ext, "rb") as f:
            got[ext] = f.read()
    with open(out_base + ".summary.txt", "rb") as f:
        got[".summary.txt"] = f.read()
    for r in (r1, r2):
        with open(r + ".mfile", "rb") as f:
            got[os.path.basename(r) + ".mfile"] = f.read()
    return got


def _reads_copy(data, d):
    """Own copies of the fastqs: each run writes <fastq>.mfile beside
    them."""
    d.mkdir()
    for r in ("r1.fastq", "r2.fastq"):
        shutil.copy(data / r, d / r)
    return str(d / "r1.fastq"), str(d / "r2.fastq")


def test_run_mapper_and_cli_match_host(data, tmp_path):
    sdx = str(data / "g.sdx")
    outs = {}
    for how in ("host", "device"):
        r1, r2 = _reads_copy(data, tmp_path / how)
        base = str(tmp_path / how / "out")
        cfg = MapperConfig(out_base=base, sdx_path=sdx, paired=True,
                           files1=[r1], files2=[r2], max_dist=500,
                           min_dist=0, batch_size=600,
                           device=how == "device", nthreads=2)
        eng = run_mapper(cfg, device=CPU)
        assert isinstance(eng, FusedMapperEngine2) == (how == "device")
        outs[how] = _artifacts(base, r1, r2)

    r1, r2 = _reads_copy(data, tmp_path / "cli")
    base = str(tmp_path / "cli" / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    subprocess.run(
        [sys.executable, "-m", "pecaller_tpu_torch", "pemapper", base, sdx,
         "p", r1, r2, "500", "0", "n", "0.9", "3", "2000000000",
         "--device=cpu", "--batch-size", "600"],
        cwd=REPO, env=env, check=True, capture_output=True, timeout=600)
    outs["cli"] = _artifacts(base, r1, r2)
    assert outs["host"][".summary.txt"].count(b"\n") > 5
    for how in ("device", "cli"):
        for k, v in outs["host"].items():
            assert outs[how][k] == v, (how, k)


def test_parse_pemapper_single_end():
    from pecaller_tpu_torch.cli import parse_pemapper
    cfg = parse_pemapper(["o", "g.sdx", "s", "r.fq", "y", "0.85", "4",
                          "100", "--device", "--batch-size", "8192"])
    assert (cfg.paired, cfg.bisulfite, cfg.min_align, cfg.nthreads,
            cfg.max_reads, cfg.device, cfg.batch_size, cfg.files1) == \
        (False, True, 0.85, 3, 100, True, 8192, ["r.fq"])


def _refuse(*a, **k):
    raise ValueError("index would hold too many positions")


def test_runner_refuses_what_is_not_ported(data, monkeypatch):
    """Where the nbr index refuses the genome the runner takes the
    quartered-key index (ROADMAP item 6, ported); multi-device mapping
    (item 8, ported) maps over a reads-axis mesh of mesh_shards shards,
    and refuses a mesh larger than its devices."""
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.mapper import runner
    monkeypatch.setattr(runner, "load_nbr_index", _refuse)
    cfg = MapperConfig(out_base=str(data / "x"),
                       sdx_path=str(data / "g.sdx"), paired=True,
                       files1=[], files2=[], device=True)
    sdx = read_sdx(cfg.sdx_path)
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    index = load_index(str(data / "g"))
    eng = runner.build_device_engine(cfg, sdx, genome, index,
                                     str(data / "g"), CPU)
    assert isinstance(eng, FusedMapperEngine2)
    assert eng.state.dnbr.mode == "quarter"
    cfg.mesh_shards = 4
    eng = run_mapper(cfg, device=[CPU] * 4)
    assert isinstance(eng, FusedMapperEngine2) and eng._n_sh == 4
    assert eng.state.dnbr.mode == "quarter"
    with pytest.raises(ValueError, match="needs 4 devices"):
        run_mapper(cfg, device=CPU)


def test_quarter_builder_refusals_agree_with_jax(data):
    """The port's build_quarter_index refuses (ValueError) exactly where
    the JAX builder does: a cap below the entries it needs, and a
    position at 2^30."""
    from pecaller_tpu.index.quarter import build_quarter_index as jax_build
    from pecaller_tpu_torch.formats.index_files import SeedIndex, load_index
    from pecaller_tpu_torch.index.quarter import build_quarter_index
    index = load_index(str(data / "g"))
    counts = np.diff(np.asarray(index.starts, np.int64))
    ab = counts >= 100
    per_q = int(counts[~ab].sum()) + int(ab.sum())
    far = SeedIndex(index.keys, index.starts,
                    np.where(np.arange(len(index.positions)) == 7, 1 << 30,
                             index.positions).astype(np.uint32))
    cases = [(index, m) for m in (100, 4 * per_q - 1, 4 * per_q,
                                  6_000_000_000)] + [(far, 6_000_000_000)]
    got = []
    for idx, m in cases:
        refused = []
        for build in (jax_build, build_quarter_index):
            try:
                build(idx, max_positions=m)
                refused.append(False)
            except ValueError:
                refused.append(True)
        assert refused[0] == refused[1], m
        got.append(refused[1])
    assert got == [True, True, False, False, True]


def test_run_mapper_v1_route_matches_jax(data, tmp_path, monkeypatch):
    """Both packages' runners with the nbr index and the quartered-key
    index refusing: both map with their fused v1 engine."""
    import pecaller_tpu.index.nbr as jnbr
    import pecaller_tpu.index.quarter as jquarter
    from pecaller_tpu.mapper.runner import MapperConfig as JaxConfig
    from pecaller_tpu.mapper.runner import run_mapper as jax_run_mapper
    from pecaller_tpu_torch.mapper import runner
    from pecaller_tpu_torch.mapper.device_pipeline import FusedMapperEngine
    monkeypatch.setattr(jnbr, "load_nbr_index", _refuse)
    monkeypatch.setattr(jquarter, "load_quarter_index", _refuse)
    monkeypatch.setattr(runner, "load_nbr_index", _refuse)
    monkeypatch.setattr(runner, "load_quarter_index", _refuse)
    outs = {}
    for how, cfg_cls, run in (("jax", JaxConfig, jax_run_mapper),
                              ("port", MapperConfig, run_mapper)):
        r1, r2 = _reads_copy(data, tmp_path / how)
        base = str(tmp_path / how / "out")
        cfg = cfg_cls(out_base=base, sdx_path=str(data / "g.sdx"),
                      paired=True, files1=[r1], files2=[r2], max_dist=500,
                      min_dist=0, batch_size=600, device=True, nthreads=2)
        eng = run(cfg, device=CPU) if how == "port" else run(cfg)
        assert type(eng).__name__ == "FusedMapperEngine"
        outs[how] = _artifacts(base, r1, r2)
    assert isinstance(eng, FusedMapperEngine)
    assert outs["jax"][".summary.txt"].count(b"\n") > 5
    for k, v in outs["jax"].items():
        assert outs["port"][k] == v, k


def _pair_dir(data, d):
    """A directory of two read pairs for map_directory: data's pairs
    split in two, named as map_directory_array.pl pairs them."""
    d.mkdir()
    for e in (1, 2):
        with open(data / f"r{e}.fastq") as f:
            lines = f.readlines()
        half = 4 * (len(lines) // 8)
        for name, part in (("a", lines[:half]), ("b", lines[half:])):
            with open(d / f"{name}_{e}_x.fastq", "w") as f:
                f.writelines(part)
    return d


_RUN_MAPPER = """
import sys
from pecaller_tpu_torch.mapper.runner import MapperConfig, run_mapper
run_mapper(MapperConfig(out_base=sys.argv[1], sdx_path=sys.argv[2],
                        paired=True, files1=[sys.argv[3]],
                        files2=[sys.argv[4]], max_dist=500, nthreads=2))
"""


@pytest.mark.parametrize("how", ["pemapper", "pemapper-bare-device",
                                 "pemapper_tsw", "map_directory",
                                 "run_mapper"])
def test_device_path_needs_cuda_unless_asked(data, tmp_path, how):
    """Without a CUDA device the mapper's entry points raise "no CUDA
    device" in process and through ``python -m pecaller_tpu_torch``
    (``run_mapper``: ``python -c``) where the caller names neither the
    CPU nor the host engine: no flag, a bare --device, and a
    MapperConfig without ``device=``.  Nothing falls back to the host
    engine or the CPU: no artifact is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    from pecaller_tpu_torch.cli import main as cli_main
    from pecaller_tpu_torch.cli import parse_pemapper
    sdx = str(data / "g.sdx")
    r1, r2 = _reads_copy(data, tmp_path / "nocuda")
    out = str(tmp_path / "nocuda" / "out")
    pe = [out, sdx, "p", r1, r2, "500", "0", "n", "0.9", "3", "100"]
    argv = {"pemapper": ["pemapper", *pe],
            "pemapper-bare-device": ["pemapper", *pe, "--device"],
            "pemapper_tsw": ["pemapper_tsw", *pe, "0", "0"],
            "map_directory": ["map_directory",
                              str(_pair_dir(data, tmp_path / "fq")), sdx],
            "run_mapper": None}[how]
    if argv is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mapper(MapperConfig(out_base=out, sdx_path=sdx, paired=True,
                                    files1=[r1], files2=[r2], max_dist=500,
                                    nthreads=2))
        cmd = ["-c", _RUN_MAPPER, out, sdx, r1, r2]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(argv)
        cmd = ["-m", "pecaller_tpu_torch", *argv]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not [f for f in tmp_path.rglob("*")
                if f.name.endswith((".mfile", ".txt.gz", ".pileup.gz"))]
    cfg = parse_pemapper(pe + ["--device=cpu"])
    assert (cfg.device, cfg.torch_device) == (True, "cpu")


def _route_artifacts(base, fastqs):
    """A run's artifacts by extension and .mfile name (gzip decompressed)."""
    got = {}
    for ext in (".pileup.gz", ".indel.txt.gz", ".summary.txt"):
        with open(base + ext, "rb") as f:
            got[ext] = f.read()
    for fq in fastqs:
        with open(fq + ".mfile", "rb") as f:
            got[os.path.basename(fq)] = f.read()
    return {k: gzip.decompress(v) if k.endswith(".gz") else v
            for k, v in got.items()}


@pytest.mark.parametrize("command", ["pemapper", "map_directory"])
def test_host_and_device_routes_agree(data, tmp_path, monkeypatch,
                                      command):
    """``--host`` builds the exact host engine (MapperEngine) and
    ``--device=cpu`` the device route (the v2 engine on the nbr index,
    on the CPU); their artifacts (.pileup.gz, .indel.txt.gz,
    .summary.txt and every .mfile) are byte-equal.  ``map_directory``
    on a directory of two read pairs."""
    from pecaller_tpu_torch.cli import main as cli_main
    from pecaller_tpu_torch.mapper import runner
    from pecaller_tpu_torch.mapper.engine import MapperEngine as HostEngine
    built = []
    run = runner.run_mapper
    monkeypatch.setattr(runner, "run_mapper",
                        lambda cfg: built.append((cfg, run(cfg))))
    outs = {}
    for flag in ("--host", "--device=cpu"):
        d = tmp_path / flag.strip("-").replace("=", "_")
        if command == "pemapper":
            r1, r2 = _reads_copy(data, d)
            base = str(d / "out")
            argv = [base, str(data / "g.sdx"), "p", r1, r2, "500", "0", "n",
                    "0.9", "3", "2000000000", "--batch-size", "600"]
            fastqs = [r1, r2]
        else:
            fq = _pair_dir(data, d)
            base = str(fq)
            argv = [base + "/", str(data / "g.sdx")]
            fastqs = sorted(str(fq / f) for f in os.listdir(fq))
        assert cli_main([command, *argv, flag]) == 0
        outs[flag] = _route_artifacts(base, fastqs)
    (hcfg, host), (dcfg, dev) = built
    assert not hcfg.device and type(host) is HostEngine
    assert (dcfg.device, dcfg.torch_device) == (True, "cpu")
    assert isinstance(dev, FusedMapperEngine2) and dev.device == CPU
    assert dev.state.dnbr.mode != "quarter"
    assert len(outs["--host"]) == (5 if command == "pemapper" else 7)
    assert outs["--host"][".summary.txt"].count(b"\n") > 5
    assert outs["--device=cpu"] == outs["--host"]


@pytest.fixture(scope="module")
def boundary(tmp_path_factory):
    """tests/test_fused2.py:208-255: single-end reads whose exact best
    score sits on the min_align threshold (seed 99)."""
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    from pecaller_tpu.index import build_index
    d = tmp_path_factory.mktemp("torch_boundary")
    rng = np.random.default_rng(99)
    names, seqs = make_genome(rng, [20000])
    write_fasta(str(d / "t.fa"), names, seqs)
    build_index(str(d / "t.fa"), str(d / "t"), write_idx=False)
    sdx = read_sdx(str(d / "t.sdx"))
    genome = read_seq(str(d / "t.seq"), sdx.genome_size)
    index = load_index(str(d / "t"))
    B = 64
    reads = np.zeros((B, 100), np.uint8)
    lens = np.full(B, 100, np.int64)
    for b in range(B):
        start = int(rng.integers(200, 18000))
        ref = genome[start:start + 101].copy()
        read = np.concatenate([ref[:50], ref[51:101]])
        for p in rng.choice(100, size=6, replace=False):
            c = read[p]
            read[p] = BASES[(np.searchsorted(BASES, c) + 1) % 4] \
                if c in BASES else ord("A")
        reads[b] = read
    kw = dict(paired=False, min_align=0.9, nthreads=2)
    nbr = shared_nbr(d, "t", index, binsearch=False)
    port = FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU, **kw)
    got = port.map_batch(reads, lens, read_nos=np.arange(B))
    return d, sdx, genome, index, nbr, kw, reads, lens, port, got


def test_threshold_boundary_matches_jax(boundary):
    """The port against the JAX engine on the threshold-boundary reads:
    equal on every read where the JAX engine agrees with the host oracle.
    Where it does not, the JAX engine never saw the read's last seed
    segment (its segment axis is 100 // 16 = 6 wide for 7 segments, a
    fault of the reference, ROADMAP queue 3) and the port, which sizes
    the axis by the reads' segments, gives the host oracle's answer."""
    d, sdx, genome, index, nbr, kw, reads, lens, port, got = boundary
    nos = np.arange(len(lens))
    want = JaxEngine(sdx, genome, index, nbr=nbr, **kw).map_batch(
        reads, lens, read_nos=nos)
    host = MapperEngine(sdx, genome, index, **kw).map_batch(
        reads, lens, read_nos=nos)
    same = np.logical_and.reduce([a == h for a, h in zip(want, host)])
    assert 0 < (~same).sum() < len(lens) // 2
    for a, b, h in zip(want, got, host):
        assert np.array_equal(b[same], a[same])
        assert np.array_equal(b[~same], h[~same])


def test_threshold_boundary_matches_host(boundary):
    d, sdx, genome, index, nbr, kw, reads, lens, port, got = boundary
    host = MapperEngine(sdx, genome, index, **kw)
    want = host.map_batch(reads, lens, read_nos=np.arange(len(lens)))
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert np.array_equal(host.final_pileup(), port.final_pileup())
