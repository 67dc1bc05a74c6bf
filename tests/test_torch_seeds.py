"""The v1 seed + chain core of the port
(pecaller_tpu_torch/mapper/device_seeds.py) against the JAX package's
seed_chain_core, on tests/test_fused.py's genome (30 kb + 20 kb with an
N block, seed 42) and reads, paired ends and bisulfite conversion.

Tolerance: bitwise (hits, hits_off, orient, tot, fallback)."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecaller_tpu.mapper import device_pipeline as jdp
from pecaller_tpu.mapper import device_seeds as jds
from pecaller_tpu_torch.mapper import device_seeds as tds
from torch_util import batches, load_genome, make_fused_data

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused_data(tmp_path_factory.mktemp("torch_seeds"))


@pytest.fixture(scope="module")
def dindex(data):
    _, _, index = load_genome(data)
    return index, jds.DeviceSeedIndex(index)


def test_device_seed_index_matches_jax(dindex):
    index, jd = dindex
    port = tds.DeviceSeedIndex(index, CPU)
    for name in ("ptab", "keys", "starts", "hi_table", "positions"):
        want = np.asarray(getattr(jd, name)).view(np.int32)
        assert np.array_equal(getattr(port, name).numpy(), want), name
    assert (port.n_keys, port.max_subrange, port.compact_cap(10 ** 6)) == \
        (jd.n_keys, jd.max_subrange, jd.compact_cap(10 ** 6))


@pytest.mark.parametrize("bisulfite", [False, True])
def test_seed_chain_core_matches_jax(data, dindex, bisulfite):
    _, jd = dindex
    port_idx = tds.DeviceSeedIndex.from_arrays(
        jd.ptab, jd.keys, jd.starts, jd.hi_table, jd.positions, CPU)
    (s1, l1, s2, l2, _), = batches(data, "r1.fastq", "r2.fastq", 900)
    B, M, s_max = 1024, 112, 8
    host = SimpleNamespace(bisulfite=bisulfite, min_align=0.9)
    n_steps = max(1, int(np.ceil(np.log2(max(jd.max_subrange, 2)))) + 1)
    k_cap = jd.compact_cap(B * 2 * s_max * 49)
    kw = dict(s_max=s_max, n_steps=n_steps, n_keys=jd.n_keys, k_cap=k_cap)
    ref_fn = jax.jit(functools.partial(jds.seed_chain_core, **kw))
    for seqs, lens in ((s1, l1), (s2, l2)):
        (_, _, bf, br, _, offs, nsegs, mm0, skip, _) = \
            jdp.FusedMapperEngine._prep_end(
                host, seqs, np.asarray(lens, np.int64), B, M, s_max)
        args = (bf, br, offs, nsegs, mm0, skip)
        ref = ref_fn(jd.ptab, jd.keys, jd.starts, jd.hi_table,
                     jd.positions, *(jnp.asarray(a) for a in args))
        port = tds.seed_chain_core(
            port_idx.ptab, port_idx.keys, port_idx.starts,
            port_idx.hi_table, port_idx.positions,
            *(torch.from_numpy(np.array(a)) for a in args), **kw)
        for name, p, r in zip(("hits", "hits_off", "orient", "tot",
                               "fallback"), port, ref):
            r = np.asarray(r)
            assert p.shape == r.shape and np.array_equal(
                p.numpy().astype(np.int64), r.astype(np.int64)), name
        if not bisulfite:      # (the index is not a bisulfite one)
            assert int((port[3] > 0).sum()) > len(lens) // 2
