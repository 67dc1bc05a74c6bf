"""The port's split engine (pecaller_tpu_torch/mapper/device_engine.py:
host seeds or device seeds, SW scores through K3, traceback and pileup
on the device) and its ops against the JAX package's: pileup_scatter,
sw_align_device_packed and sw_traceback_scatter on pileup counters seeded
near 65,535 (so that the uint16 adds wrap), DeviceMapperEngine with
device_seeds True and False on paired, single-end and bisulfite data,
and the runner's route function (the split engine at 2^30 bases and
more, without a genome of that size).  The tests marked cuda run the
engine's K3 scores and a whole batch on the card against the CPU.

Data: tests/test_quarter.py's genome and reads (seed 47) and the
bisulfite configuration of torch_util.  Tolerance: bitwise (codes, .mfile
values, pileup counters, insertion records, fallback counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pecaller_tpu.mapper.device_engine import \
    DeviceMapperEngine as JaxSplitEngine
from pecaller_tpu.ops import sw as jsw
from pecaller_tpu_torch.mapper.device_engine import DeviceMapperEngine
from pecaller_tpu_torch.mapper.runner import SPLIT_GENOME, device_route
from pecaller_tpu_torch.ops import sw, sw_cuda
from torch_util import (CPU, PAIRED, SINGLE, batches, cuda_device,  # noqa
                        load_genome, make_bisulfite_data, make_fused2_data,
                        record_split, same_records)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_split")
    make_fused2_data(d, seed=47)
    make_bisulfite_data(d)
    return d


def _near_wrap(rng, shape):
    """uint16 counters within a few counts of 65,535 (and some small)."""
    c = rng.integers(65530, 65536, shape)
    c[rng.random(shape) < 0.3] = rng.integers(0, 3)
    return c.astype(np.uint16)


def _i16(counts):
    return torch.from_numpy(counts.copy().view(np.int16))


def test_pileup_scatter_matches_jax():
    rng = np.random.default_rng(11)
    gs, E = 3000, 40000
    pos = rng.integers(-50, gs + 50, E)
    pos[rng.random(E) < 0.1] = -1
    pos[:5000] = rng.integers(0, 40, 5000)          # hot rows wrap
    kind = rng.integers(0, 6, E).astype(np.int8)     # EV_NONE included
    ins = rng.random(E) < 0.2
    seed = _near_wrap(rng, (gs, 6))
    want = (seed + np.asarray(jsw.pileup_scatter(
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(kind),
        jnp.asarray(ins), genome_size=gs))).astype(np.uint16)
    got = sw.pileup_scatter(torch.from_numpy(pos), torch.from_numpy(kind),
                            torch.from_numpy(ins), _i16(seed))
    assert got.dtype == torch.int16 and got.shape == (gs, 6)
    assert np.array_equal(got.numpy().view(np.uint16), want)
    assert (want[:40] < seed[:40]).any()             # wrapped past 65,535


def _lanes(seed, B, bis):
    """Raw-byte lanes at the split engine's widths (N 128, M 128): 100 bp
    reads, windows up to 121 rows, lowercase, IUPAC and N bytes."""
    rng = np.random.default_rng(seed)
    refs, bl, reads, rl = chip_smoke.mk_lanes(rng, B, 128, 128, 90, 101,
                                              raw=True)
    return rng, refs, bl, reads, rl


@pytest.mark.parametrize("bis", [False, True])
def test_sw_align_device_packed_matches_jax(bis):
    _, refs, bl, reads, rl = _lanes(21 + bis, 384, bis)
    want = np.asarray(jsw.sw_align_device_packed(
        refs, bl, reads, rl, bisulfite=bis, n_rows=128))
    got = sw.sw_align_device_packed(*(torch.from_numpy(x) for x in (
        refs, bl, reads, rl)), bisulfite=bis, n_rows=128)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bis", [False, True])
def test_sw_traceback_scatter_matches_jax(bis):
    rng, refs, bl, reads, rl = _lanes(31 + bis, 256, bis)
    score, bk, bi = jsw.sw_align_device(refs, bl, reads, rl, bisulfite=bis,
                                        n_rows=128)
    bk, bi = np.array(bk), np.array(bi)
    gs = 4000
    pos0 = rng.integers(0, gs - 64, len(bl)).astype(np.int64)
    pos0[:40] = rng.integers(0, 8, 40)               # overlapping lanes
    pos0[40:48] = gs - rng.integers(1, 60, 8)        # past the genome end
    seed = _near_wrap(rng, (gs, 6))
    d_j, rec_j = jsw.sw_traceback_scatter(
        refs, bl, reads, rl, bk, bi, jnp.asarray(pos0.astype(np.int32)),
        bisulfite=bis, n_rows=128, genome_size=gs, ins_cap=64)
    want = (seed + np.asarray(d_j)).astype(np.uint16)
    counts = _i16(seed)
    got, rec = sw.sw_traceback_scatter(
        *(torch.from_numpy(x) for x in (refs, bl, reads, rl, bk, bi, pos0)),
        counts, bisulfite=bis, n_rows=128, ins_cap=64)
    assert got is counts
    assert np.array_equal(counts.numpy().view(np.uint16), want)
    assert np.array_equal(rec.numpy(), np.asarray(rec_j))
    assert 0 < int(rec[-1, 0]) and (want != seed).any()


ENGINES = {"paired": ("g", "r1.fastq", "r2.fastq", PAIRED, 900),
           "single": ("g", "r1.fastq", None, SINGLE, 512),
           "bisulfite": ("b", "b1.fastq", "b2.fastq",
                         dict(PAIRED, bisulfite=True), 400)}


def _run(engines, bl, paired):
    for s1, l1, s2, l2, nos in bl:
        outs = [e.map_batch(s1, l1, s2, l2, read_nos=nos) if paired
                else e.map_batch(s1, l1, read_nos=nos) for e in engines]
        for a, b in zip(*outs):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("device_seeds", [False, True],
                         ids=["host_seeds", "device_seeds"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_split_engine_matches_jax(data, name, device_seeds):
    """The port's DeviceMapperEngine on the CPU against the JAX one:
    codes, m1 and m2 of every batch, final_pileup, insertion records and
    the fallback count."""
    base, f1, f2, kw, bs = ENGINES[name]
    sdx, genome, index = load_genome(data, base)
    jeng = JaxSplitEngine(sdx, genome, index, device_seeds=device_seeds,
                          **kw)
    port = DeviceMapperEngine(sdx, genome, index, device=CPU,
                              device_seeds=device_seeds, **kw)
    assert (port._seed_fns is None) == (not device_seeds)
    _run((jeng, port), batches(data, f1, f2, bs), kw["paired"])
    assert np.array_equal(jeng.final_pileup(), port.final_pileup())
    assert sorted(jeng.ins_records) == sorted(port.ins_records)
    assert np.array_equal(jeng.stats.mate_counts, port.stats.mate_counts)
    assert jeng.n_fallback == port.n_fallback
    assert port.dev_counts.dtype == torch.int16 and port.dev_counts.any()
    assert port.ins_records


@pytest.mark.parametrize("name", list(ENGINES))
def test_host_and_device_seeds_agree(data, name):
    """The split engine with host seeds against the same engine with
    device seeds, both on the CPU: codes, m1 and m2 of every batch, every
    traceback's insertion records, final_pileup, the insertion records
    and the mate counts bitwise.  chip_smoke.py's phase 7 relies on it:
    there the host-seed engine runs only the first batches, held to the
    device-seed gate run's outputs on those batches."""
    base, f1, f2, kw, bs = ENGINES[name]
    sdx, genome, index = load_genome(data, base)
    engs = [DeviceMapperEngine(sdx, genome, index, device=CPU,
                               device_seeds=s, **kw) for s in (False, True)]
    seen = [record_split(e) for e in engs]
    _run(engs, batches(data, f1, f2, bs), kw["paired"])
    assert seen[0]["rec"] and same_records(seen[0]["rec"], seen[1]["rec"])
    assert np.array_equal(engs[0].final_pileup(), engs[1].final_pileup())
    assert sorted(engs[0].ins_records) == sorted(engs[1].ins_records)
    assert np.array_equal(engs[0].stats.mate_counts,
                          engs[1].stats.mate_counts)


@pytest.mark.parametrize("name", list(ENGINES))
def test_split_graph_matches_eager_and_jax(data, name):
    """Device seeds, the engine's seed steps and tracebacks as programs
    (graph=True) against the same engine with graph=False and against
    the JAX engine: every seed step's and traceback's output bitwise,
    then codes, m1 and m2 of every batch, final_pileup and insertion
    records.  The repeated shape keys reuse their programs."""
    base, f1, f2, kw, bs = ENGINES[name]
    sdx, genome, index = load_genome(data, base)
    jeng = JaxSplitEngine(sdx, genome, index, device_seeds=True, **kw)
    engs = [DeviceMapperEngine(sdx, genome, index, device=CPU, graph=g,
                               **kw) for g in (True, False)]
    seen = [record_split(e) for e in engs]
    for s1, l1, s2, l2, nos in batches(data, f1, f2, bs):
        outs = [e.map_batch(s1, l1, s2, l2, read_nos=nos) if kw["paired"]
                else e.map_batch(s1, l1, read_nos=nos)
                for e in (jeng, *engs)]
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert np.array_equal(a, b)
    for k in ("seeds", "rec"):
        assert seen[0][k] and same_records(seen[0][k], seen[1][k])
    for e in engs:
        assert np.array_equal(jeng.final_pileup(), e.final_pileup())
        assert sorted(jeng.ins_records) == sorted(e.ins_records)
    progs = engs[0].programs
    assert all(p.graph for p in progs)
    assert not any(p.graph for p in engs[1].programs)
    assert max(p.calls for p in progs) > 1
    assert sum(p.calls for p in progs) == sum(map(len, seen[0].values()))


def _loader(result):
    def load():
        if result is None:
            raise ValueError("refused")
        return result
    return load


def _never():
    raise AssertionError("no index is loaded past 2^30 bases")


@pytest.mark.parametrize("gs, nbr, quarter, want", [
    (SPLIT_GENOME, _never, _never, ("split", None)),
    (3_100_000_000, _never, _never, ("split", None)),
    (SPLIT_GENOME - 1, _loader("N"), _never, ("nbr", "N")),
    (47_000_000, _loader(None), _loader("Q"), ("quarter", "Q")),
    (600_000_000, _loader(None), _loader(None), ("v1", None))])
def test_device_route(gs, nbr, quarter, want):
    """The JAX runner's routes (pecaller_tpu/mapper/runner.py:80-117):
    the split engine at 2^30 bases and more, else the nbr index, else
    the quartered-key index, else the fused v1 engine."""
    assert device_route(gs, nbr, quarter) == want


def _engine_lanes(eng, rng, H):
    """A batch end's SW lanes as the engine's _score_end makes them:
    windows of 100 bp reads (up to 121 bytes) and the reads."""
    g = eng.genome
    starts = rng.integers(0, len(g) - 130, H)
    blens = rng.integers(100, 122, H).astype(np.int32)
    refs = eng._gather_refs(starts, blens, int(blens.max()))
    reads = np.stack([g[s + 8:s + 108] for s in starts]).astype(np.uint8)
    reads[rng.random(reads.shape) < 0.02] = ord("G")
    return refs, blens, reads, np.full(H, 100, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paired", "bisulfite"])
def test_split_sw_scores_on_card_match_cpu(data, cuda_device, name):
    """_sw_scores through K3 on the card (M = 128: K3's 16-thread
    instance) against the plain version on the CPU, at the engine's
    bucketed shapes (H 700 and 5000 lanes: Hp 1024 and 8192)."""
    base, _, _, kw, _ = ENGINES[name]
    sdx, genome, index = load_genome(data, base)
    engs = [DeviceMapperEngine(sdx, genome, index, device=dev,
                               device_seeds=False, **kw)
            for dev in (CPU, cuda_device)]
    rng = np.random.default_rng(5)
    for H in (700, 5000):
        lanes = _engine_lanes(engs[0], rng, H)
        before = sw_cuda.LAUNCHES["sw_align"]
        cpu, card = (e._sw_scores(*lanes) for e in engs)
        assert sw_cuda.LAUNCHES["sw_align"] == before + 1
        for a, b in zip(cpu, card):
            assert np.array_equal(a, b)


@pytest.mark.cuda
def test_split_engine_on_card_matches_cpu(data, cuda_device):
    """A paired batch through the whole split engine on the card against
    the CPU: codes, .mfile values, pileup and insertion records."""
    sdx, genome, index = load_genome(data, "g")
    engs = [DeviceMapperEngine(sdx, genome, index, device=dev,
                               device_seeds=True, **PAIRED)
            for dev in (CPU, cuda_device)]
    _run(engs, batches(data, "r1.fastq", "r2.fastq", 900), True)
    assert np.array_equal(engs[0].final_pileup(), engs[1].final_pileup())
    assert sorted(engs[0].ins_records) == sorted(engs[1].ins_records)
