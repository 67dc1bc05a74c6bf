"""The port's genome-sharded octile engine (mapper/gshard.py) where the
shards' merge passes its caps, and its step as a MeshProgram, on
tests/test_gshard.py's data: the walk-tie cap, where the port sends
the units past the merged cap to the host remap, and the insertion
cap, where the port keeps one record block a shard (the JAX engine
raises at both); the step as a MeshProgram (mapper/program.py:
segments between the 13 collectives, each collective reduced on each
device) over two and four device entries (cpu and cpu:0 stand for two
devices) against lockstep (graph=False); on the card two shards of
cuda:0, graphed against eager, and the same shards over two cards.
(The engine against the host oracle and the JAX engine:
tests/test_torch_gshard.py.)

Tolerance: bitwise (equal codes, .mfile values, mate counts,
statistics, pileup and insertion records)."""

from functools import partial

import numpy as np
import pytest
import torch

import pecaller_tpu.mapper.device_map2 as jdm
import pecaller_tpu.mapper.gshard as jgs
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu.mapper.gshard import OctileShardedEngine as JaxSharded
from pecaller_tpu_torch.index import shard as tsh
from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
from pecaller_tpu_torch.parallel.mesh import make_mesh
from test_torch_gshard import _run, _same_state
from torch_util import cuda_device  # noqa: F401  (fixture)
from torch_util import (CPU, PAIRED, batches, jax_genome_mesh, load_genome,
                        make_gshard_data, port_genome_mesh)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_gshard_data(tmp_path_factory.mktemp("torch_gshard_program"))


def test_tie_cap_overflow_goes_to_the_host(data, monkeypatch):
    """A walk-tie cap that each shard's records fit but their merge does
    not: the JAX engine raises in resolve; the port demotes the units
    past the cap to the host remap and equals the host oracle."""
    sdx, genome, index = load_genome(data)
    probe = OctileShardedEngine(sdx, genome, index, port_genome_mesh(2),
                                **PAIRED)
    (s1, l1, s2, l2, nos), = batches(data, "r1.fastq", "r2.fastq", 600)[:1]
    h = probe.map_batch_async(s1, l1, s2, l2, read_nos=nos)
    tail = h["B"] + probe.ins_cap + 1 + probe.tie_cap
    outs, = probe._fetch_shards(h)              # (shards, rows, 6)
    n_g = [int(out[tail, 0]) for out in outs]
    assert min(n_g) > 0
    cap = max(n_g)                                   # < sum(n_g)

    monkeypatch.setattr(jdm, "TIE_CAP", cap)
    jeng = JaxSharded(sdx, genome, index, jax_genome_mesh(2), **PAIRED)
    with pytest.raises(RuntimeError, match="tie_cap"):
        jeng.map_batch(s1, l1, s2, l2, read_nos=nos)

    host = MapperEngine(sdx, genome, index, **PAIRED)
    port, eager = (OctileShardedEngine(sdx, genome, index,
                                       port_genome_mesh(2), tie_cap=cap,
                                       graph=graph, **PAIRED)
                   for graph in (True, False))
    _run([host, port, eager], data)
    for ref in (host, eager):
        _same_state(ref, port)
    assert port.n_fallback > 0


def test_ins_cap_merge_past_the_cap(data, monkeypatch):
    """An insertion cap that each shard's records fit in every batch
    but their merge does not: the JAX engine merges the shards' records
    into one block of ins_cap rows and raises in resolve; the port keeps
    one block a shard, so its artifacts equal the host oracle's."""
    sdx, genome, index = load_genome(data)
    probe = OctileShardedEngine(sdx, genome, index, port_genome_mesh(2),
                                **PAIRED)
    bl = batches(data, "r1.fastq", "r2.fastq", 600)
    n_g = []
    for s1, l1, s2, l2, nos in bl:
        h = probe.map_batch_async(s1, l1, s2, l2, read_nos=nos)
        outs, = probe._fetch_shards(h)
        n_g.append([int(out[h["B"] + probe.ins_cap, 0]) for out in outs])
    cap = max(max(n) for n in n_g)
    assert min(min(n) for n in n_g) > 0 and max(sum(n) for n in n_g) > cap

    # the JAX engine's step and resolve at ins_cap = cap
    monkeypatch.setattr(jdm, "INS_CAP", cap)
    monkeypatch.setattr(jgs, "build_fused_step2",
                        partial(jdm.build_fused_step2, ins_cap=cap))
    jeng = JaxSharded(sdx, genome, index, jax_genome_mesh(2), **PAIRED)
    with pytest.raises(RuntimeError, match="merged insertion records"):
        for s1, l1, s2, l2, nos in bl:
            jeng.map_batch(s1, l1, s2, l2, read_nos=nos)

    host = MapperEngine(sdx, genome, index, **PAIRED)
    port, eager = (OctileShardedEngine(sdx, genome, index,
                                       port_genome_mesh(2), ins_cap=cap,
                                       graph=graph, **PAIRED)
                   for graph in (True, False))
    _run([host, port, eager], data)
    for ref in (host, eager):
        _same_state(ref, port)
    assert len(port.ins_records) > cap


def _raw(eng, d):
    """Each batch's raw step outputs: packed rows, insertion records and
    walk-tie records, every batch enqueued before the first is fetched
    (the runner keeps several in flight)."""
    pend = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in batches(d, "r1.fastq", "r2.fastq",
                                               600)]
    return [[np.array(x) for x in eng._blocks(h)] for h in pend]


def _same_raw(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.shape == v.shape and np.array_equal(u, v)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_graph_on_a_mesh_of_two_devices(data, n_shards):
    """A genome mesh over two device entries (cpu and cpu:0 alternate,
    as two cards would) with graph=True: the MeshProgram lays out one
    set of segments a shard and one set of reductions a device, 13
    collectives and 14 segments a shard, and every batch's packed rows,
    insertion and walk-tie records equal lockstep's (graph=False),
    bitwise."""
    sdx, genome, index = load_genome(data)
    two = [CPU, torch.device("cpu", 0)] * (n_shards // 2)
    plan = tsh.plan_shards(sdx, n_shards)
    shards = tsh.build_octile_shards(index, plan)
    engines = [OctileShardedEngine(sdx, genome, index,
                                   make_mesh(1, n_shards, two), plan=plan,
                                   shards=shards, graph=graph, **PAIRED)
               for graph in (True, False)]
    raws = [_raw(e, data) for e in engines]
    _same_raw(*raws)
    assert any(len(b[2]) for b in raws[0])          # walk-tie records
    assert any(len(b[1]) for b in raws[0])          # insertion records
    prog, = engines[0].programs
    assert prog.graph and prog.calls == len(raws[0])
    assert prog.by_device == {two[0]: list(range(0, n_shards, 2)),
                              two[1]: list(range(1, n_shards, 2))}
    assert prog.collectives == ["psum", "pmax", "psum", "pmax"]  \
        + ["all_gather"] * 5 + ["pmax", "psum", "all_gather", "pmax"]
    assert prog.segments == 14
    eager, = engines[1].programs
    assert not eager.graph and eager.capture_s is None


def _graphed_vs_eager(data, devs):
    """Engines over ``devs`` graphed and eager: raw outputs of every
    batch bitwise (first call eager, the second captured, the rest
    replayed), pileups equal; returns the graphed engine."""
    sdx, genome, index = load_genome(data)
    plan = tsh.plan_shards(sdx, len(devs))
    shards = tsh.build_octile_shards(index, plan)
    engines = [OctileShardedEngine(sdx, genome, index,
                                   make_mesh(1, len(devs), devs), plan=plan,
                                   shards=shards, graph=graph, **PAIRED)
               for graph in (True, False)]
    raws = [_raw(e, data) for e in engines]
    _same_raw(*raws)
    assert np.array_equal(engines[0].final_pileup(),
                          engines[1].final_pileup())
    return engines[0], raws[0]


@pytest.mark.cuda
def test_gshard_graph_on_the_card(data, cuda_device):
    """Two shards on cuda:0 as a MeshProgram (a graph a shard a segment,
    a graph a collective, one pool) against lockstep (graph=False) on
    the card: raw outputs bitwise."""
    from pecaller_tpu_torch.ops import sw_cuda
    eng, _ = _graphed_vs_eager(data, [cuda_device] * 2)
    prog, = eng.programs
    assert list(prog.pools) == [cuda_device] and prog.capture_s > 0
    assert prog.n_graphs == 2 * 14 + 13 + 1 and prog.n_copies == 0
    k0 = dict(sw_cuda.LAUNCHES)
    prog.replay()
    assert sw_cuda.LAUNCHES == k0                 # a bare replay counts none
    assert prog.launches == {"sw_align_x": 2, "sw_tb_rows": 2,
                             "sw_align": 0, "chain_votes": 2,
                             "chain_select": 2}


@pytest.mark.cuda
def test_gshard_on_two_cards(data, cuda_device):
    """The same two shards on cuda:0 and cuda:1 (skipped with fewer than
    two cards): graphed against lockstep over the two cards and against
    the program with both shards on cuda:0, bitwise; one pool a card and
    the copies between the cards' graphs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eng, raw = _graphed_vs_eager(data, cards)
    prog, = eng.programs
    assert list(prog.pools) == cards
    assert prog.n_graphs == 2 * 14 + 2 * 13 + 1
    assert prog.n_copies == 2 * 13 + 1
    _, one = _graphed_vs_eager(data, [cuda_device] * 2)
    _same_raw(raw, one)
