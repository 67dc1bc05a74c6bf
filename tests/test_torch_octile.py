"""The port's octile index and shard plan (index/quarter.py octile half,
index/shard.py), its OctileDeviceIndex and the genome-sharded step,
against the JAX package's.

Data: tests/test_gshard.py's (seed 91: contigs of 150 kb and 110 kb with
a repeated block, 1200 pairs of 100 bp).  Tolerance: bitwise (equal
arrays; the step's packed output blocks and each shard's pileup counters
equal), and for the plan equal integers (the port's gctx is int64, the
reference's int32: equal below 2^31)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pecaller_tpu.index.quarter as jq
import pecaller_tpu.index.shard as jsh
from pecaller_tpu.mapper.gshard import OctileShardedEngine as JaxSharded
from pecaller_tpu_torch.index import quarter as tq
from pecaller_tpu_torch.index import shard as tsh
from pecaller_tpu_torch.mapper import device_map2 as tdm
from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
from torch_util import (CPU, PAIRED, _bucket, batches, jax_genome_mesh,
                        load_genome, make_gshard_data, port_genome_mesh)

OCT_PARTS = ("tagt", "valt", "tb", "pos", "qw", "base", "owned_len",
             "cover_len")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_gshard_data(tmp_path_factory.mktemp("torch_octile"))


def _same_octile(a, b):
    for part in OCT_PARTS:
        x, y = np.asarray(getattr(a, part)), np.asarray(getattr(b, part))
        assert x.dtype == y.dtype and np.array_equal(x, y), part


@pytest.mark.parametrize("n_shards", [0, 2])
def test_octile_index_matches_jax(data, n_shards):
    """build_octile_index over the whole genome (0) and per shard of a
    2-shard plan, including build_octile_shards' common tb."""
    sdx, _, index = load_genome(data)
    if n_shards == 0:
        _same_octile(tq.build_octile_index(index),
                     jq.build_octile_index(index))
        return
    got = tsh.build_octile_shards(index, tsh.plan_shards(sdx, n_shards))
    want = jsh.build_octile_shards(index, jsh.plan_shards(sdx, n_shards))
    assert len(got) == len(want) == n_shards
    for a, b in zip(got, want):
        _same_octile(a, b)
    assert got[0].base == 0 and got[1].base > 0


def test_octile_refusals_match_jax(data):
    """A span of 2^28 or more is refused by both builders."""
    _, _, index = load_genome(data)
    for build in (tq.build_octile_index, jq.build_octile_index):
        with pytest.raises(ValueError, match="2\\^28"):
            build(index, cover_len=(1 << 28) + 1)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plan_matches_jax(data, n_shards):
    sdx, _, _ = load_genome(data)
    got, want = tsh.plan_shards(sdx, n_shards), jsh.plan_shards(sdx, n_shards)
    for part in ("bounds", "bases_idx", "bases_seq", "own_lo", "own_hi",
                 "c_lo", "cover_idx", "cover_seq"):
        assert np.array_equal(getattr(got, part), getattr(want, part)), part
    assert got.n_shards == want.n_shards == n_shards
    g = got.gctx()
    assert g.dtype == np.int64 and np.array_equal(g, want.gctx())


def test_plan_geometry(data):
    """tests/test_gshard.py's plan invariants on the port's plan: disjoint
    owned intervals tiling the genome, overlap >= read length + slop,
    local spans < 2^28."""
    sdx, _, _ = load_genome(data)
    plan = tsh.plan_shards(sdx, 4)
    ist = sdx.istarts
    assert plan.bounds[0] == 0 and plan.bounds[-1] == ist[-1]
    for g in range(plan.n_shards):
        assert plan.own_hi[g] - max(plan.own_lo[g], 0) > 0
        assert plan.cover_idx[g] <= (plan.bounds[g + 1]
                                     - plan.bounds[g]) + tsh.LM + tsh.OV
        assert plan.cover_idx[g] < tq.OCT_LOCAL_MAX
        if g > 0:
            assert plan.bases_idx[g] + plan.own_lo[g] == plan.bounds[g]


def test_octile_device_index_matches_jax(data, monkeypatch):
    """OctileDeviceIndex tensors (padded to the longest shard) equal the
    JAX one's arrays; t1 and rcap are constructor arguments where the
    JAX class reads PECALLER_Q8_T1 / PECALLER_Q8_RCAP."""
    sdx, _, index = load_genome(data)
    shards = tsh.build_octile_shards(index, tsh.plan_shards(sdx, 2))
    emax = max(len(s.pos) for s in shards)
    monkeypatch.setenv("PECALLER_Q8_RCAP", "10")
    for s in shards:
        want = jq.OctileDeviceIndex(s, pad_entries=emax, pad_tb=s.tb)
        got = tdm.OctileDeviceIndex(s, CPU, rcap=10, pad_entries=emax,
                                    pad_tb=s.tb)
        assert (got.mode, got.tb, got.t1, got.rcap) == (
            want.mode, want.tb, want.t1, want.rcap)
        for x, y in zip(got.args, want.host_args()):
            assert np.array_equal(x.numpy().view(y.dtype), y)
    with pytest.raises(ValueError, match="common tb"):
        tdm.OctileDeviceIndex(shards[0], CPU, pad_tb=shards[0].tb + 1)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_octile_step_matches_jax(data, n_shards):
    """The genome-sharded step of the port's engine (one FusedStep2 a
    shard, run in lockstep) against the JAX engine's shard_map program
    on one batch: each shard's output block and pileup counters."""
    sdx, genome, index = load_genome(data)
    jeng = JaxSharded(sdx, genome, index, jax_genome_mesh(n_shards),
                      **PAIRED)
    peng = OctileShardedEngine(sdx, genome, index,
                               port_genome_mesh(n_shards), **PAIRED)
    (s1, l1, s2, l2, _), = batches(data, "r1.fastq", "r2.fastq", 600)[:1]
    B, M, N, s_max, mr = _bucket(600), 112, 144, 6, 104
    ins = [np.concatenate([x, y]) for x, y in zip(
        jeng._prep_end2(s1, np.asarray(l1, np.int64), B, M, s_max),
        jeng._prep_end2(s2, np.asarray(l2, np.int64), B, M, s_max))]
    rng = np.random.default_rng(n_shards)
    counts = rng.integers(0, 7, (n_shards, peng._local_seq * 6)).astype(
        np.uint32)
    for g, st in enumerate(peng.states):
        st.dev_counts.copy_(torch.from_numpy(counts[g].view(np.int32)))
    fn = jeng._fn_for(B, M, N, s_max, mr)
    dc_j, out_j = fn(jnp.asarray(counts), *jeng._dnbr.args, jeng._gcode,
                     jeng._gmask, jeng._ist_dev, jeng._st_pad_dev, *ins)
    outs = peng._step_for(B, M, N, s_max, mr)(
        *(torch.from_numpy(x) for x in ins))
    out_j, dc_j = np.asarray(out_j), np.asarray(dc_j)
    for g in range(n_shards):
        assert np.array_equal(outs[g].numpy(), out_j[g])
        assert np.array_equal(
            peng.states[g].dev_counts.numpy().view(np.uint32), dc_j[g])
    assert (out_j[0, :B, 2] != 8).any()                      # mapped
    assert sum(int(out_j[g, B + tdm.INS_CAP, 0])
               for g in range(n_shards)) > 0                 # insertions
    assert not np.array_equal(dc_j, counts)


def test_sharded_step_does_not_run_alone(data):
    """A genome shard's step meets its shards at collectives: run alone
    (FusedStep2.__call__) it raises at the first, never carrying on
    unsharded."""
    sdx, genome, index = load_genome(data)
    peng = OctileShardedEngine(sdx, genome, index, port_genome_mesh(1),
                               **PAIRED)
    (s1, l1, s2, l2, _), = batches(data, "r1.fastq", "r2.fastq", 600)[:1]
    B = _bucket(600)
    ins = [np.concatenate([x, y]) for x, y in zip(
        peng._prep_end2(s1, np.asarray(l1, np.int64), B, 112, 6),
        peng._prep_end2(s2, np.asarray(l2, np.int64), B, 112, 6))]
    step = peng._step_for(B, 112, 144, 6, 104).steps[0]
    with pytest.raises(RuntimeError, match="outside a genome mesh"):
        step(peng.state, *(torch.from_numpy(x) for x in ins))
