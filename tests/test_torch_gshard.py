"""The port's genome-sharded octile engine (mapper/gshard.py) against the
host oracle and the JAX package's engine, on tests/test_gshard.py's
data and its cross-shard tie genome, its step as one program a shape
key (graph=True, the default) and eagerly (graph=False); the octile
engine at one shard against the port's quarter engine; the int64 shard
plan past 2^31; on the card two shards of cuda:0 against two on the
CPU.  (The merge's caps and the step as a MeshProgram over two device
entries: tests/test_torch_gshard_program.py.)

Tolerance: bitwise (equal codes, .mfile values, mate counts,
statistics, pileup and insertion records)."""

import numpy as np
import pytest

import pecaller_tpu.index.shard as jsh
from pecaller_tpu.formats.sdx import SdxInfo as JaxSdx
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu.mapper.gshard import OctileShardedEngine as JaxSharded
from pecaller_tpu_torch.formats.sdx import SdxInfo
from pecaller_tpu_torch.index import shard as tsh
from pecaller_tpu_torch.index.quarter import build_quarter_index
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
from pecaller_tpu_torch.utils.log import spans, spans_since
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
    pytest.param(2, False, id="2-graph-vs-eager"),
    pytest.param(4, True, id="4")])
def test_gshard_matches_oracle_and_jax(data, n_shards, graph):
    """The engine against the host oracle and the JAX engine; with
    graph=False (lockstep) also against the same engine with
    graph=True, whose step (every shard and the collectives) is one
    MeshProgram a shape key and one stacked output a batch."""
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
    before = spans()
    _run(engines, data)
    done = spans_since(before)
    for ref in (host, jeng) + tuple(engines[3:]):
        _same_state(ref, port)
    assert port.ins_records and port.final_pileup().any()
    assert (port.n_fallback, port.n_tiefix) == (jeng.n_fallback,
                                                 jeng.n_tiefix)
    assert port.n_tiefix > 0
    # each of the port's engines dispatched and waited for two batches
    n_port = len(engines) - 2
    assert done["engine.enqueue.dispatch"][0] == 2 * n_port
    assert done["engine.resolve.wait"][0] == 2 * n_port
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
