"""The port's one device program per batch (``mapper/program.py``):
the StepProgram's slots and launch accounting, ``group_k`` in the v2
engine against the JAX package's grouped engine, batches in flight (the
split engine's two seed ends too), and on the card each engine graphed
against itself eager.

Tolerance: exact equality of codes, .mfile values, mate counts,
pileup, insertion records and (on the card) raw output blocks."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2 as JaxEngine
from pecaller_tpu_torch.mapper.device_engine import DeviceMapperEngine
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2, fetched
from pecaller_tpu_torch.mapper.device_pipeline import FusedMapperEngine
from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
from pecaller_tpu_torch.mapper.program import StepProgram, capture_stats
from pecaller_tpu_torch.ops import sw_cuda
from torch_util import (PAIRED, batches, cuda_device, load_genome,
                        make_fused2_data, port_genome_mesh, record_split,
                        shared_nbr)

CPU = torch.device("cpu")
__all__ = ["cuda_device"]           # the fixture, imported for the tests


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused2_data(tmp_path_factory.mktemp("torch_program"))


@pytest.fixture
def launches(monkeypatch):
    """sw_cuda.LAUNCHES, zeroed for the test and restored after it."""
    monkeypatch.setattr(sw_cuda, "LAUNCHES",
                        dict.fromkeys(sw_cuda.LAUNCHES, 0))
    return sw_cuda.LAUNCHES


def _fake_step(a, b):
    """A step that "launches" K1 twice and K2 once, as its wrappers
    would count them."""
    sw_cuda.LAUNCHES["sw_align_x"] += 2
    sw_cuda.LAUNCHES["sw_tb_rows"] += 1
    return a.to(torch.int64) * 2 + b.sum()


def test_launch_accounting_with_a_fake_step(launches):
    """A capture runs no kernel: launches_since takes the counts the
    wrappers made while it ran back out, and count_replay adds them
    once a replay."""
    launches["sw_align"] = 5
    before = dict(launches)
    _fake_step(torch.arange(4), torch.ones(2))
    moved = sw_cuda.launches_since(before)
    assert moved == {"sw_align_x": 2, "sw_tb_rows": 1, "sw_align": 0,
                     "chain_votes": 0, "chain_select": 0}
    assert launches == before
    for _ in range(3):
        sw_cuda.count_replay(moved)
    assert launches == {"sw_align_x": 6, "sw_tb_rows": 3, "sw_align": 5,
                        "chain_votes": 0, "chain_select": 0}


def test_program_slots_on_the_cpu(launches):
    """On the CPU the program runs the step on its slots at every call
    (a group of K batches stacked) and returns its one static output,
    which the next call overwrites as a replay on the card would;
    graph=False returns a fresh tensor.  Nothing is captured."""
    a = [np.arange(6, dtype=np.int32).reshape(2, 3) + i for i in range(3)]
    b = [np.full(4, i, np.int16) for i in range(3)]
    want1 = torch.stack([torch.from_numpy(a[i]).to(torch.int64) * 2
                         + int(b[i].sum()) for i in range(3)])
    prog = StepProgram(_fake_step, CPU, group=3)
    out1 = prog([(a[i], b[i]) for i in range(3)])
    assert torch.equal(out1, want1)
    first = out1.clone()
    out2 = prog([(a[2 - i], b[2 - i]) for i in range(3)])
    assert out2 is out1                       # the static output
    assert torch.equal(out2, want1.flip(0))
    assert not torch.equal(out1, first)       # overwritten by call 2
    assert launches == {"sw_align_x": 2 * 2 * 3, "sw_tb_rows": 2 * 3,
                        "sw_align": 0, "chain_votes": 0, "chain_select": 0}
    assert prog.launches is None and prog.capture_s is None
    assert capture_stats([prog])["graphs"] == 0

    eager = StepProgram(_fake_step, CPU, graph=False)
    e1 = eager([(a[0], b[0])])
    e2 = eager([(a[1], b[1])])
    assert e1 is not e2 and not torch.equal(e1, e2)
    with pytest.raises(ValueError, match="does not fit"):
        eager([(a[0][:1], b[0])])
    with pytest.raises(ValueError, match="1 batches a call"):
        eager([(a[0], b[0])] * 2)


def _engine_kw(d):
    sdx, genome, index = load_genome(d)
    return (sdx, genome, index), shared_nbr(d, "g", index, binsearch=False)


def _trimmed(batch, n=70):
    """The batch's reads cut to ``n`` bases: another shape key (M 80)."""
    s1, l1, s2, l2, nos = batch
    return (np.ascontiguousarray(s1[:, :n]), np.minimum(l1, n),
            np.ascontiguousarray(s2[:, :n]), np.minimum(l2, n), nos)


def test_grouped_matches_single_and_jax(data):
    """tests/test_fused2.py::test_fused2_grouped_scan on the port:
    group_k=3 (three batches of a key as one program, one fetch a group)
    equals group_k=1 bitwise, and both equal the JAX engine at
    group_k=3.  A trimmed batch changes the shape key between two groups
    (a partial group of one is flushed, and the trimmed batch runs
    alone), and the 4-pair tail is a partial group that resolve flushes
    at the stream's end."""
    (sdx, genome, index), nbr = _engine_kw(data)
    e_one = FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                               group_k=1, **PAIRED)
    e_grp = FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                               group_k=3, **PAIRED)
    e_jax = JaxEngine(sdx, genome, index, nbr=nbr, group_k=3, **PAIRED)
    bl = batches(data, "r1.fastq", "r2.fastq", 128)
    assert len(bl) == 8 and len(bl[-1][1]) == 4
    bl = bl[:4] + [_trimmed(bl[3])] + bl[4:]
    res_one = [e_one.map_batch(s1, l1, s2, l2, read_nos=nos)
               for s1, l1, s2, l2, nos in bl]
    res = {}
    for name, eng in (("group", e_grp), ("jax", e_jax)):
        pend = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
                for s1, l1, s2, l2, nos in bl]
        res[name] = [eng.resolve(h) for h in pend]
    for name, eng in (("group", e_grp), ("jax", e_jax)):
        for a, b in zip(res_one, res[name]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y), name
        assert np.array_equal(e_one.stats.mate_counts,
                              eng.stats.mate_counts)
        assert np.array_equal(e_one.final_pileup(), eng.final_pileup())
        assert sorted(e_one.ins_records) == sorted(eng.ins_records)
    assert (res_one[0][2] != 8).any() and e_one.ins_records
    key, key_t = (sorted({k for _, k in e_grp._programs},
                         key=lambda k: -k[1]))
    assert key[1] == 112 and key_t[1] == 80
    assert sorted(e_grp._programs) == sorted(
        [(3, key), (1, key), (1, key_t)])
    assert [p.calls for p in (e_grp._programs[3, key],
                              e_grp._programs[1, key],
                              e_grp._programs[1, key_t])] == [2, 2, 1]


def test_group_k_defaults_from_the_environment(data, monkeypatch):
    (sdx, genome, index), nbr = _engine_kw(data)
    monkeypatch.setenv("PECALLER_GROUP_K", "3")
    assert FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                              **PAIRED)._group_k == 3
    assert FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                              group_k=2, **PAIRED)._group_k == 2
    monkeypatch.delenv("PECALLER_GROUP_K")
    assert FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                              **PAIRED)._group_k == 1


def _artifacts(out_base, reads):
    got = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(out_base + ext, "rb") as f:
            got[ext] = f.read()
    with open(out_base + ".summary.txt", "rb") as f:
        got[".summary.txt"] = f.read()
    for r in reads:
        with open(r + ".mfile", "rb") as f:
            got[os.path.basename(r) + ".mfile"] = f.read()
    return got


def test_runner_group_k_matches_host(data, tmp_path, monkeypatch):
    """run_mapper with PECALLER_GROUP_K=3 (7 batches in flight, grouped
    programs) writes the host oracle's five artifacts."""
    from pecaller_tpu_torch.mapper.runner import MapperConfig, run_mapper
    outs = {}
    for how in ("host", "device"):
        d = tmp_path / how
        d.mkdir()
        reads = [str(shutil.copy(data / r, d / r))
                 for r in ("r1.fastq", "r2.fastq")]
        cfg = MapperConfig(out_base=str(d / "out"),
                           sdx_path=str(data / "g.sdx"), paired=True,
                           files1=reads[:1], files2=reads[1:], max_dist=500,
                           min_dist=0, batch_size=128,
                           device=how == "device", nthreads=2)
        monkeypatch.setenv("PECALLER_GROUP_K", "3")
        eng = run_mapper(cfg, device=CPU)
        outs[how] = _artifacts(cfg.out_base, reads)
    assert eng._group_k == 3
    assert any(p.group == 3 for p in eng.programs)
    assert outs["host"][".summary.txt"].count(b"\n") > 5
    assert outs["device"] == outs["host"]


def _v1(d, device, graph=True):
    sdx, genome, index = load_genome(d)
    return FusedMapperEngine(sdx, genome, index, device=device, graph=graph,
                             **PAIRED)


@pytest.mark.parametrize("engine", ["v2", "v1"])
def test_in_flight_matches_one_at_a_time(data, engine):
    """Three batches enqueued before the first is resolved give what
    resolving each at once gives: the output a program's next call
    overwrites was fetched at its own call.  The same engine maps the
    batches twice, so its pileup doubles."""
    if engine == "v2":
        (sdx, genome, index), nbr = _engine_kw(data)
        eng = FusedMapperEngine2(sdx, genome, index, nbr=nbr, device=CPU,
                                 **PAIRED)
    else:
        eng = _v1(data, CPU)
    bl = batches(data, "r1.fastq", "r2.fastq", 128)[:3]

    def recs(before):
        return sorted(eng.ins_records[before:])
    once, ins_once = [], []
    for s1, l1, s2, l2, nos in bl:
        n = len(eng.ins_records)
        once.append(eng.map_batch(s1, l1, s2, l2, read_nos=nos))
        ins_once.append(recs(n))
    pile = eng.final_pileup()
    pend = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in bl]
    for h, want, ins_want in zip(pend, once, ins_once):
        n = len(eng.ins_records)
        got = eng.resolve(h)
        for x, y in zip(want, got):
            assert np.array_equal(x, y)
        assert recs(n) == ins_want
    assert np.array_equal(eng.final_pileup(), pile * np.uint16(2))
    assert any(ins_once) and pile.any()
    assert [p.calls for p in eng.programs] == [6]


def test_split_seed_ends_in_flight(data):
    """The split engine's seed step: both ends of a batch dispatched
    before the first fetch, as map_batch dispatches them, give what
    dispatching and fetching each end alone gives.  The ends share one
    program (one shape key), whose next call overwrites its output: the
    dispatch copied it out at once."""
    sdx, genome, index = load_genome(data)
    eng = DeviceMapperEngine(sdx, genome, index, device=CPU, **PAIRED)
    for s1, l1, s2, l2, _ in batches(data, "r1.fastq", "r2.fastq",
                                     128)[:3]:
        ends = ((s1, l1.astype(np.int64)), (s2, l2.astype(np.int64)))
        alone = [eng._initial_map_resolve(eng._initial_map_dispatch(s, ln))
                 for s, ln in ends]
        pend = [eng._initial_map_dispatch(s, ln) for s, ln in ends]
        both = [eng._initial_map_resolve(h) for h in pend]
        for a, b in zip(alone, both):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        assert not np.array_equal(both[0][0], both[1][0])
    assert [p.calls for p in eng.programs] == [12]


# ---- on the card: graphed against eager

def _raw(eng, bl):
    """The raw outputs of the batches ``bl``, all enqueued before the
    first is fetched: the v2 engines' and the genome mesh's (packed
    rows, insertion records, walk-tie records) a batch, v1's one block;
    the split engine's seed steps and tracebacks, then its pileup."""
    if isinstance(eng, DeviceMapperEngine):
        seen = record_split(eng)
        for s1, l1, s2, l2, nos in bl:
            eng.map_batch(s1, l1, s2, l2, read_nos=nos)
        return seen["seeds"] + seen["rec"] + [[eng.final_pileup()]]
    pend = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in bl]
    if isinstance(eng, FusedMapperEngine2):
        return [[np.array(x) for x in eng._blocks(h)] for h in pend]
    return [[fetched(h)] for h in pend]


@pytest.mark.cuda
@pytest.mark.parametrize("engine,batch,n", [
    ("v2", 128, 3), ("v2.5", 128, 3), ("v1", 128, 3), ("mesh", 128, 3),
    ("v2 group_k=3", 64, 9), ("gshard", 128, 3), ("split", 128, 3)])
def test_graph_equals_eager_on_the_card(data, cuda_device, engine, batch,
                                        n):
    """Each engine on cuda:0 with its programs graphed against the same
    engine with graph=False: n batches of one shape key (the first eager,
    the second captured and replayed, the rest replayed) give the same
    raw outputs bitwise, and the same launch counts; every program
    called twice or more captured a graph, and graph=False captures
    nothing.  The genome mesh: two shards on cuda:0, all of a batch one
    graph; the split engine (device seeds): its seed steps and
    tracebacks, K3 eager."""
    from pecaller_tpu_torch.parallel.mesh import make_mesh
    bl = batches(data, "r1.fastq", "r2.fastq", batch)[:n]
    got, counts = {}, {}
    for graph in (False, True):
        kw = dict(PAIRED, device=cuda_device, graph=graph)
        if engine == "v1":
            eng = _v1(data, cuda_device, graph)
        elif engine == "gshard":
            eng = OctileShardedEngine(*load_genome(data),
                                      port_genome_mesh(2, cuda_device),
                                      graph=graph, **PAIRED)
        elif engine == "split":
            eng = DeviceMapperEngine(*load_genome(data), device=cuda_device,
                                     graph=graph, **PAIRED)
        else:
            (sdx, genome, index), nbr = _engine_kw(data)
            if engine == "v2.5":
                kw.update(force_quarter=True)
            else:
                kw.update(nbr=nbr)
            if engine == "mesh":
                kw.update(mesh=make_mesh(2, 1, [cuda_device] * 2))
            if engine == "v2 group_k=3":
                kw.update(group_k=3)
            eng = FusedMapperEngine2(sdx, genome, index, **kw)
        sw_cuda.reset_launches()
        got[graph] = _raw(eng, bl)
        torch.cuda.synchronize(cuda_device)
        counts[graph] = dict(sw_cuda.LAUNCHES)
        stats = capture_stats(eng.programs)
        want = sum(p.calls > 1 for p in eng.programs) if graph else 0
        assert stats["graphs"] == want and (want > 0 or not graph)
        if engine == "v2.5":
            assert eng.state.dnbr.mode == "quarter"
    for a, b in zip(got[False], got[True]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert counts[True] == counts[False]
    assert sum(counts[True].values()) > 0
    if engine not in ("v1", "split"):          # the v2 step's seed stage
        assert (counts[True]["chain_votes"] == counts[True]["chain_select"]
                == counts[True]["sw_align_x"])
