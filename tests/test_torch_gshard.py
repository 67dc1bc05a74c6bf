"""The port's genome-sharded octile engine (mapper/gshard.py) against the
host oracle and the JAX package's engine, on tests/test_gshard.py's
data and its cross-shard tie genome, its step as one program a shape
key (graph=True, the default) and eagerly (graph=False); the octile
engine at one shard against the port's quarter engine; the int64 shard
plan past 2^31; the walk-tie cap, where the port sends the units past
the merged cap to the host remap, and the insertion cap, where the
port keeps one record block a shard (the JAX engine raises at both);
a mesh over two devices, which one graph cannot hold.

Tolerance: bitwise (equal codes, .mfile values, mate counts,
statistics, pileup and insertion records)."""

from functools import partial

import numpy as np
import pytest
import torch

import pecaller_tpu.index.shard as jsh
import pecaller_tpu.mapper.device_map2 as jdm
import pecaller_tpu.mapper.gshard as jgs
from pecaller_tpu.formats.sdx import SdxInfo as JaxSdx
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu.mapper.gshard import OctileShardedEngine as JaxSharded
from pecaller_tpu_torch.formats.sdx import SdxInfo
from pecaller_tpu_torch.index import shard as tsh
from pecaller_tpu_torch.index.quarter import build_quarter_index
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
from pecaller_tpu_torch.parallel.mesh import Mesh
from torch_util import cuda_device  # noqa: F401  (fixture)
from torch_util import (CPU, PAIRED, batches, jax_genome_mesh, load_genome,
                        make_gshard_data, make_tie_genome_data,
                        port_genome_mesh)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_gshard_data(tmp_path_factory.mktemp("torch_gshard"))


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    return make_tie_genome_data(tmp_path_factory.mktemp("torch_gties"))


def _run(engines, d):
    """Map d's batches (600 pairs) with every engine; each batch's codes
    and .mfile values equal the first engine's."""
    for s1, l1, s2, l2, nos in batches(d, "r1.fastq", "r2.fastq", 600):
        outs = [e.map_batch(s1, l1, s2, l2, read_nos=nos) for e in engines]
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert np.array_equal(a, b)


def _same_state(ref, eng):
    assert np.array_equal(ref.stats.mate_counts, eng.stats.mate_counts)
    assert ref.stats.total_dist == eng.stats.total_dist
    assert ref.stats.total_bases == eng.stats.total_bases
    assert np.array_equal(ref.final_pileup(), eng.final_pileup())
    assert sorted(ref.ins_records) == sorted(eng.ins_records)


@pytest.mark.parametrize("n_shards,graph", [
    pytest.param(1, True, id="1"), pytest.param(2, True, id="2"),
    pytest.param(2, False, id="2-graph-vs-eager")])
def test_gshard_matches_oracle_and_jax(data, n_shards, graph):
    """The engine against the host oracle and the JAX engine; with
    graph=False also against the same engine with graph=True, whose
    step (every shard and the collectives) is one program a shape key
    and one stacked output a batch."""
    sdx, genome, index = load_genome(data)
    host = MapperEngine(sdx, genome, index, **PAIRED)
    jeng = JaxSharded(sdx, genome, index, jax_genome_mesh(n_shards),
                      **PAIRED)
    port = OctileShardedEngine(sdx, genome, index,
                               port_genome_mesh(n_shards), graph=graph,
                               **PAIRED)
    engines = [host, jeng, port]
    if not graph:
        engines.append(OctileShardedEngine(
            sdx, genome, index, port_genome_mesh(n_shards), **PAIRED))
    _run(engines, data)
    for ref in (host, jeng) + tuple(engines[3:]):
        _same_state(ref, port)
    assert port.ins_records and port.final_pileup().any()
    assert (port.n_fallback, port.n_tiefix) == (jeng.n_fallback,
                                                 jeng.n_tiefix)
    assert port.n_tiefix > 0
    assert port.mesh_timing["batches"] == 2
    # one program a shape key, one call a batch
    assert sum(p.calls for p in port.programs) == 2
    assert all(p.graph == graph for p in port.programs)


def test_gshard_cross_shard_ties(ties):
    """Exact repeat copies in different shards and across the boundary:
    the gathered decide classifies as the global-view oracle does."""
    sdx, genome, index = load_genome(ties)
    host = MapperEngine(sdx, genome, index, **PAIRED)
    jeng = JaxSharded(sdx, genome, index, jax_genome_mesh(2), **PAIRED)
    port = OctileShardedEngine(sdx, genome, index, port_genome_mesh(2),
                               **PAIRED)
    _run([host, jeng, port], ties)
    for ref in (host, jeng):
        _same_state(ref, port)
    # the repeat's reads really landed in both shards' candidate lists
    codes = host.stats.mate_counts
    assert codes[4] + codes[5] > 0               # non-unique classes


def test_octile_single_vs_quarter_engine(data):
    """The octile index through the engine at one shard equals the
    quartered-key engine batch for batch (the same candidate sets
    through another projection split)."""
    sdx, genome, index = load_genome(data)
    e_q = FusedMapperEngine2(sdx, genome, index, device=CPU,
                             quarter=build_quarter_index(index), **PAIRED)
    e_o = OctileShardedEngine(sdx, genome, index, port_genome_mesh(1),
                              **PAIRED)
    _run([e_q, e_o], data)
    assert np.array_equal(e_q.final_pileup(), e_o.final_pileup())


def _human_sdx(cls):
    """A 3.1 Gb genome of 24 contigs, as hg38's size (plan only)."""
    lens = np.full(24, 3_100_000_000 // 24 - 15, np.uint32)
    return cls(names=[f"chr{i + 1}" for i in range(24)], stored_lens=lens,
               idepth=16)


def test_plan_past_2_31_is_exact():
    """The port's gctx carries int64: past 2^31 its global bases are the
    plan's own, where the reference's int32 gctx wraps (equal mod 2^32,
    and equal outright below 2^31)."""
    got = tsh.plan_shards(_human_sdx(SdxInfo), 12)
    want = jsh.plan_shards(_human_sdx(JaxSdx), 12)
    g, w = got.gctx(), want.gctx()
    assert np.array_equal(g[:, 1], got.bases_seq)
    assert got.bases_seq.max() > 2 ** 31
    assert np.array_equal(g & 0xFFFFFFFF, w.astype(np.int64) & 0xFFFFFFFF)
    low = g < 2 ** 31
    assert np.array_equal(g[low], w[low]) and not low.all()
    assert (w[~low] < 0).all()                      # the reference wraps
    assert (got.cover_idx < 1 << 28).all()


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
    port = OctileShardedEngine(sdx, genome, index, port_genome_mesh(2),
                               tie_cap=cap, **PAIRED)
    _run([host, port], data)
    _same_state(host, port)
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
    port = OctileShardedEngine(sdx, genome, index, port_genome_mesh(2),
                               ins_cap=cap, **PAIRED)
    _run([host, port], data)
    _same_state(host, port)
    assert len(port.ins_records) > cap


def test_graph_on_a_mesh_of_two_devices_raises(data):
    """One CUDA graph cannot hold reductions across devices: a genome
    mesh over two devices raises with graph=True, before building
    anything, and names graph=False."""
    sdx, genome, index = load_genome(data)
    mesh = Mesh([CPU, torch.device("meta")], 1, 2)
    with pytest.raises(ValueError, match="graph=False"):
        OctileShardedEngine(sdx, genome, index, mesh, **PAIRED)


@pytest.mark.cuda
def test_gshard_on_the_card(data, cuda_device):
    """Two genome shards on cuda:0 (K1 and K2 on the card) against two
    on the CPU: codes, .mfile values, pileup and insertion records."""
    sdx, genome, index = load_genome(data)
    engines = [OctileShardedEngine(sdx, genome, index,
                                   port_genome_mesh(2, dev), **PAIRED)
               for dev in (CPU, cuda_device)]
    _run(engines, data)
    _same_state(*engines)
