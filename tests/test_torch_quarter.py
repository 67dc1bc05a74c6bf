"""The port's quartered-key seed path ("v2.5") against the JAX package's:
the host index (build, fresh load, cached load; refusals are held in
tests/test_torch_runner.py), its candidate sets, the sort that stands in
for the reference's bitonic network, the fused step seeded through the
index, the engine on the index against the JAX engine and the host
oracle, and the runner's route to it.

Data: tests/test_quarter.py's (seed 47: 30 kb + 20 kb with an N block,
900 pairs of 100 bp) and the bisulfite configuration of torch_util.
Tolerance: bitwise (byte-equal arrays, equal codes, .mfile values,
pileup, insertion records and statistics)."""

import gzip
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pecaller_tpu.index.quarter as jq
from pecaller_tpu.mapper import device_map2 as jdm
from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2 as JaxEngine
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu.ops.encode import mismatch_neighborhood_keys
from pecaller_tpu_torch.index import quarter as tq
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from torch_util import (CASES, CPU, PAIRED, SINGLE, StepCase, batches,
                        check_step, load_genome, make_bisulfite_data,
                        make_fused2_data, step_closures)

PARTS = ("starts", "cnts", "pos", "qw")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quarter")
    make_fused2_data(d, seed=47)
    make_bisulfite_data(d)
    return d


_QI = {}                # one JAX quarter build per genome


def jax_quarter(d, base):
    key = str(d / base)
    if key not in _QI:
        _QI[key] = jq.build_quarter_index(load_genome(d, base)[2])
    return _QI[key]


def _same_arrays(a, b):
    for part in PARTS:
        x, y = np.asarray(getattr(a, part)), np.asarray(getattr(b, part))
        assert x.dtype == y.dtype and np.array_equal(x, y), part


@pytest.mark.parametrize("how", ["build", "load_fresh", "load_cached"])
def test_quarter_index_matches_jax(data, tmp_path, how):
    _, _, index = load_genome(data, "g")
    want = jax_quarter(data, "g")
    if how == "build":
        got = tq.build_quarter_index(index)
    else:
        base = str(tmp_path / "q")
        open(base + ".mdx", "wb").close()        # the cache's mtime anchor
        got = tq.load_quarter_index(base, index)
        assert all(os.path.exists(p) for p in tq._cache_paths(base).values())
        if how == "load_cached":
            got = tq.load_quarter_index(base, index)
            assert isinstance(got.pos, np.memmap)
    _same_arrays(got, want)


def _host_quarter_probe(qi, key):
    """Host replica of the device quarter probe (tests/test_quarter.py):
    (sorted candidate positions, poisoned)."""
    starts = np.asarray(qi.starts)
    pos = np.asarray(qi.pos)
    qb_all = np.asarray(qi.qw).view(np.uint8)
    cands, poison = [], False
    for q in range(4):
        s = (3 - q) * 8
        qb_p = (key >> s) & 0xFF
        sub = (((key >> s) >> 8) << s) | (key & ((1 << s) - 1))
        base = q * tq.N_SUB + sub
        for g in range(int(starts[base]), int(starts[base + 1])):
            x = int(qb_all[g]) ^ qb_p
            f = (x | (x >> 1)) & 0x55
            nm = (f & 1) + ((f >> 2) & 1) + ((f >> 4) & 1) + ((f >> 6) & 1)
            if pos[g] >= tq.MARKER:
                poison |= nm <= 1
            elif nm == 1 or (nm == 0 and q == 0):
                cands.append(int(pos[g]))
    return sorted(cands), poison


def test_quarter_candidates_match_closure(data):
    """tests/test_quarter.py's probes (present keys, their 1-mismatch
    variants, random keys) on the port's index give the reference's
    Hamming<=1 candidate set and the too_many_spots poison flag."""
    _, _, index = load_genome(data, "g")
    qi = tq.build_quarter_index(index)
    keys = np.asarray(index.keys, np.uint32)
    starts = np.asarray(index.starts, np.int64)
    positions = np.asarray(index.positions, np.uint32)
    counts = np.diff(starts)
    rng = np.random.default_rng(0)
    probes = list(rng.choice(keys, size=40))
    nb = mismatch_neighborhood_keys(np.asarray(probes[:20], np.uint32))
    probes += [nb[i, 1 + rng.integers(48)] for i in range(20)]
    probes += list(rng.integers(0, 1 << 32, 20).astype(np.uint32))
    n_cands = 0
    for pk in map(int, probes):
        want, want_poison = [], False
        for k in set(int(v) for v in mismatch_neighborhood_keys(
                np.asarray([pk], np.uint32))[0]):
            i = np.searchsorted(keys, np.uint32(k))
            if i >= len(keys) or keys[i] != np.uint32(k):
                continue
            if counts[i] >= tq.TOO_MANY:
                want_poison = True
            else:
                want.extend(int(p) for p in
                            positions[starts[i]:starts[i + 1]])
        got, got_poison = _host_quarter_probe(qi, pk)
        assert got == sorted(want), hex(pk)
        assert got_poison == want_poison, hex(pk)
        n_cands += len(got)
    assert n_cands >= 60


@pytest.mark.parametrize("width", [16, 64])
def test_sort_matches_bitonic(data, monkeypatch, width):
    """torch.sort stands in for the reference's bitonic_sort_last: on
    random int32 rows with POS_PAD entries both give the same rows."""
    c = StepCase(data, *CASES["paired"], seed=3, monkeypatch=monkeypatch,
                 quarter=jax_quarter(data, "g"))
    probe = step_closures(c.jax_raw())["seed_probe"]
    bitonic = step_closures(probe)["bitonic_sort_last"]
    rng = np.random.default_rng(width)
    x = rng.integers(0, 5000, (64, 2, 6, width)).astype(np.int32)
    x[rng.random(x.shape) < 0.4] = jdm.POS_PAD
    x[0, 0, 0] = jdm.POS_PAD
    x[1, 0, 0] = 7                                  # ties
    want = np.asarray(jax.jit(bitonic)(jnp.asarray(x)))
    got = torch.sort(torch.from_numpy(x), dim=-1).values.numpy()
    assert np.array_equal(got, want)


STEPS = {"paired": ("paired", "g", {}), "single": ("single", "g", {}),
         "bisulfite": ("bisulfite", "b", {}),
         # T1 1 and a spill budget of 64 lookups: the spill tier takes
         # every run longer than one entry (~120 a batch here), and
         # heavy_over fires
         "small_rcap": ("paired", "g", dict(t1=1, rcap=4, hv=64))}


@pytest.mark.parametrize("name", list(STEPS))
def test_quarter_step_matches_jax(data, monkeypatch, name):
    """The port's FusedStep2 on a QuarterDeviceIndex against the JAX
    step on the JAX QuarterDeviceIndex: the packed output block and the
    pileup counters."""
    case, base, qkw = STEPS[name]
    c, out = check_step(data, case, monkeypatch=monkeypatch,
                        quarter=jax_quarter(data, base), qkw=qkw)
    assert c.jd.mode == c.state.dnbr.mode == "quarter"
    n = CASES[case][-1]                          # pairs, then padding
    n_fb = int(out[:n, 5].sum())
    if name == "small_rcap":
        assert (c.state.dnbr.t1, c.state.dnbr.rcap) == (1, 4)
        assert n_fb > n // 10                        # heavy_over fired
    else:
        assert n_fb < n // 50


ENGINES = {"paired": ("g", "r1.fastq", "r2.fastq", PAIRED, 900),
           "single": ("g", "r1.fastq", None, SINGLE, 512),
           "bisulfite": ("b", "b1.fastq", "b2.fastq",
                         dict(PAIRED, bisulfite=True), 400)}


@pytest.mark.parametrize("name", list(ENGINES))
def test_quarter_engine_matches_jax_and_host(data, name):
    """tests/test_quarter.py's contract (codes, .mfile values, mate
    counts, statistics, pileup, insertion multiset) for the port's
    FusedMapperEngine2(quarter=...) against the host oracle, and the
    same state as the JAX engine on the same index."""
    base, f1, f2, kw, bs = ENGINES[name]
    sdx, genome, index = load_genome(data, base)
    jqi = jax_quarter(data, base)
    host = MapperEngine(sdx, genome, index, **kw)
    jeng = JaxEngine(sdx, genome, index, quarter=jqi, **kw)
    port = FusedMapperEngine2(
        sdx, genome, index, device=CPU, quarter=tq.QuarterIndex(
            jqi.starts, jqi.cnts, jqi.pos, jqi.qw), **kw)
    assert port.state.dnbr.mode == jeng._dnbr.mode == "quarter"
    for s1, l1, s2, l2, nos in batches(data, f1, f2, bs):
        outs = [e.map_batch(s1, l1, s2, l2, read_nos=nos) if kw["paired"]
                else e.map_batch(s1, l1, read_nos=nos)
                for e in (host, jeng, port)]
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert np.array_equal(a, b)
    for ref in (host, jeng):
        assert np.array_equal(ref.stats.mate_counts, port.stats.mate_counts)
        assert ref.stats.total_dist == port.stats.total_dist
        assert ref.stats.total_bases == port.stats.total_bases
        assert np.array_equal(ref.final_pileup(), port.final_pileup())
        assert (sorted((k, len(s)) for k, _, s in ref.ins_records)
                == sorted((k, len(s)) for k, _, s in port.ins_records))
    assert sorted(jeng.ins_records) == sorted(port.ins_records)
    assert port.final_pileup().any() and port.ins_records
    assert (port.n_fallback, port.n_tiefix) == (jeng.n_fallback,
                                                 jeng.n_tiefix)


def _refuse(*a, **k):
    raise ValueError("index would hold too many positions")


@pytest.mark.parametrize("how", ["force_quarter", "nbr_refuses"])
def test_engine_builds_the_quarter_index(data, monkeypatch, how):
    """FusedMapperEngine2 with neither index given builds the
    quartered-key index where asked (force_quarter, the JAX knob
    PECALLER_FORCE_Q4) or where the nbr index refuses the genome, with
    the probe parameters it is given."""
    import pecaller_tpu_torch.index.nbr as tnbr
    sdx, genome, index = load_genome(data, "g")
    if how == "nbr_refuses":
        monkeypatch.setattr(tnbr, "build_nbr_index", _refuse)
    eng = FusedMapperEngine2(sdx, genome, index, device=CPU, rcap=10,
                             force_quarter=how == "force_quarter", **PAIRED)
    dq = eng.state.dnbr
    assert (dq.mode, dq.t1, dq.rcap) == ("quarter", 4, 10)
    want = jax_quarter(data, "g")
    assert np.array_equal(dq.args[0].numpy().view(np.uint32),
                          np.asarray(want.starts))
    assert np.array_equal(dq.args[2][:-18].numpy(), np.asarray(want.pos))


def _artifacts(d):
    got = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(str(d / ("out" + ext)), "rb") as f:
            got[ext] = f.read()
    for name in ("out.summary.txt", "r1.fastq.mfile", "r2.fastq.mfile"):
        got[name] = (d / name).read_bytes()
    return got


def test_runner_quarter_route_matches_jax(data, tmp_path, monkeypatch):
    """Both runners with the nbr index refusing the genome: each maps on
    the quartered-key index it loads (and caches), and the artifacts
    are byte-equal."""
    import pecaller_tpu.index.nbr as jnbr
    from pecaller_tpu.mapper.runner import MapperConfig as JaxConfig
    from pecaller_tpu.mapper.runner import run_mapper as jax_run_mapper
    from pecaller_tpu_torch.mapper import runner
    monkeypatch.setattr(jnbr, "load_nbr_index", _refuse)
    monkeypatch.setattr(runner, "load_nbr_index", _refuse)
    outs = {}
    for how, cfg_cls, run in (("jax", JaxConfig, jax_run_mapper),
                              ("port", runner.MapperConfig,
                               runner.run_mapper)):
        d = tmp_path / how
        d.mkdir()
        for f in ("g.sdx", "g.seq", "g.mdx", "g.sidx.npz", "r1.fastq",
                  "r2.fastq"):
            if (data / f).exists():
                shutil.copy(data / f, d / f)
        cfg = cfg_cls(out_base=str(d / "out"), sdx_path=str(d / "g.sdx"),
                      paired=True, files1=[str(d / "r1.fastq")],
                      files2=[str(d / "r2.fastq")], max_dist=500,
                      min_dist=0, batch_size=600, device=True, nthreads=2)
        eng = run(cfg, device=CPU) if how == "port" else run(cfg)
        assert type(eng).__name__ == "FusedMapperEngine2"
        if how == "port":
            assert eng.state.dnbr.mode == "quarter"
            assert os.path.exists(str(d / "g.q4x.pos.npy"))
        outs[how] = _artifacts(d)
    assert outs["jax"]["out.summary.txt"].count(b"\n") > 5
    for k, v in outs["jax"].items():
        assert outs["port"][k] == v, k
