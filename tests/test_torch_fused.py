"""The fused v1 step and engine of the port
(pecaller_tpu_torch/mapper/device_pipeline.py) against the JAX
package's build_fused_step, fed the same state through carry_state_v1,
and the port's engine against the exact host engine as
tests/test_fused.py holds the JAX engine.

Data: tests/test_fused.py's genome (30 kb + 20 kb with an N block,
seed 42) and 900 read pairs.  Tolerance: the step is bitwise (packed
result, insertion records, the uint16 pileup); the engine matches the
host oracle's codes, .mfile positions, mate counts and stats exactly,
its pileup up to tie-local placement (tests/util.py
assert_tie_local_pileup: the int DP breaks exact-score ties by a fixed
priority where the f64 oracle breaks them by rounding) and its
insertion records as the same (read, length) multiset."""

import numpy as np
import pytest
import torch

from pecaller_tpu.mapper import device_pipeline as jdp
from pecaller_tpu_torch.formats.fastq import FastqBatcher
from pecaller_tpu_torch.formats.index_files import load_index
from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
from pecaller_tpu_torch.mapper import device_pipeline as tdp
from pecaller_tpu_torch.mapper.engine import MapperEngine
from pecaller_tpu_torch.mapper.host_prep import contig_pad
from torch_util import cuda_device  # noqa: F401  (fixture)
from torch_util import batches, load_genome, make_fused_data
from util import assert_tie_local_pileup

CPU = torch.device("cpu")
PAIRED = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
SINGLE = dict(paired=False, min_align=0.9, nthreads=2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused_data(tmp_path_factory.mktemp("torch_fused"))


@pytest.mark.parametrize("paired", [True, False])
def test_step_matches_jax(data, paired):
    import jax.numpy as jnp
    sdx, genome, index = load_genome(data)
    jeng = jdp.FusedMapperEngine(sdx, genome, index,
                                 **(PAIRED if paired else SINGLE))
    (s1, l1, s2, l2, _), = batches(data, "r1.fastq", "r2.fastq", 900)
    B, M, N, s_max = 1024, 112, 160, 8
    ins = list(jeng._prep_end(s1, np.asarray(l1, np.int64), B, M, s_max))
    if paired:
        ins += jeng._prep_end(s2, np.asarray(l2, np.int64), B, M, s_max)
    counts = np.random.default_rng(5).integers(
        0, 1 << 16, (sdx.genome_size, 6)).astype(np.uint16)
    jd = jeng._dindex
    fn = jeng._fn_for(B, M, N, s_max)
    dc_j, packed_j, rec1_j, rec2_j = fn(
        jnp.asarray(counts), jd.ptab, jd.keys, jd.starts, jd.hi_table,
        jd.positions, jeng.genome_dev, jeng._ist_dev, jeng._st_pad_dev,
        *(jnp.asarray(a) for a in ins))

    state = tdp.carry_state_v1(
        jd.ptab, jd.keys, jd.starts, jd.hi_table, jd.positions, genome,
        jeng._ist_dev, jeng._st_pad_dev, counts, CPU)
    step = tdp.FusedStep(state.dindex, paired=paired, bisulfite=False,
                         min_dist=0, max_dist=500 if paired else 0,
                         n_contigs=sdx.n_contigs,
                         genome_size=sdx.genome_size, B=B, M=M, N=N,
                         s_max=s_max)
    out = step(state, *(torch.from_numpy(np.array(a)) for a in ins))
    for name, p, r in zip(("packed", "rec1", "rec2"), out,
                          (packed_j, rec1_j, rec2_j)):
        r = np.asarray(r)
        assert p.shape == r.shape and np.array_equal(p.numpy(), r), name
    dc = state.dev_counts.numpy().reshape(-1, 6) & 0xFFFF
    assert np.array_equal(dc.astype(np.uint16), np.asarray(dc_j))
    assert (out[0][:900, 2] != 8).sum() > 800          # reads mapped
    assert int(out[1][-1, 0]) > 0                       # insertions
    assert not np.array_equal(np.asarray(dc_j), counts)


def _engines(d, kw):
    sdx = read_sdx(str(d / "g.sdx"))
    genome = read_seq(str(d / "g.seq"), sdx.genome_size)
    index = load_index(str(d / "g"))
    return (MapperEngine(sdx, genome, index, **kw),
            tdp.FusedMapperEngine(sdx, genome, index, device=CPU, **kw))


@pytest.mark.parametrize("paired,batch", [(True, 900), (False, 512)])
def test_engine_matches_host_oracle(data, paired, batch):
    e_ref, e_fus = _engines(data, PAIRED if paired else SINGLE)
    for s1, l1, s2, l2, nos in FastqBatcher(
            str(data / "r1.fastq"), str(data / "r2.fastq") if paired
            else None, batch_size=batch).batches():
        rm1, rm2, rc = e_ref.map_batch(s1, l1, s2, l2, read_nos=nos)
        fm1, fm2, fc = e_fus.map_batch(s1, l1, s2, l2, read_nos=nos)
        assert np.array_equal(rc, fc)
        assert np.array_equal(rm1, fm1)
        assert np.array_equal(rm2, fm2)
    for f in ("mate_counts", "total_reads", "total_bases", "total_dist",
              "no_dists"):
        assert np.array_equal(getattr(e_ref.stats, f),
                              getattr(e_fus.stats, f)), f
    assert_tie_local_pileup(e_ref.final_pileup().astype(np.int64),
                            e_fus.final_pileup().astype(np.int64))
    kr = sorted((k, len(s)) for k, _, s in e_ref.ins_records)
    kf = sorted((k, len(s)) for k, _, s in e_fus.ins_records)
    assert kr == kf


def test_engine_needs_a_device(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    sdx = read_sdx(str(data / "g.sdx"))
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tdp.FusedMapperEngine(sdx, genome, load_index(str(data / "g")),
                              **PAIRED)


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [True, False])
def test_step_on_card_matches_cpu(data, cuda_device, paired):
    """The whole v1 step on the card (K3, eager traceback) against the
    same step on the CPU (plain K3), bitwise."""
    sdx = read_sdx(str(data / "g.sdx"))
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    index = load_index(str(data / "g"))
    kw = PAIRED if paired else SINGLE
    host = tdp.FusedMapperEngine.__new__(tdp.FusedMapperEngine)
    MapperEngine.__init__(host, sdx, genome, index, **kw)
    (s1, l1, s2, l2, _), = batches(data, "r1.fastq", "r2.fastq", 900)
    B, M, N, s_max = 1024, 112, 160, 8
    ins = list(host._prep_end(s1, np.asarray(l1, np.int64), B, M, s_max))
    if paired:
        ins += host._prep_end(s2, np.asarray(l2, np.int64), B, M, s_max)
    dseeds = tdp.DeviceSeedIndex(index, CPU)
    ist = sdx.istarts.astype(np.int32)
    counts = np.random.default_rng(6).integers(
        0, 1 << 16, (sdx.genome_size, 6)).astype(np.uint16)
    outs = []
    for dev in (CPU, cuda_device):
        state = tdp.carry_state_v1(
            dseeds.ptab.numpy(), dseeds.keys.numpy(), dseeds.starts.numpy(),
            dseeds.hi_table.numpy(), dseeds.positions.numpy(), genome, ist,
            contig_pad(ist, sdx.n_contigs), counts, dev)
        step = tdp.FusedStep(state.dindex, paired=paired, bisulfite=False,
                             min_dist=0, max_dist=kw.get("max_dist", 0),
                             n_contigs=sdx.n_contigs,
                             genome_size=sdx.genome_size, B=B, M=M, N=N,
                             s_max=s_max)
        out = step(state, *(torch.from_numpy(np.array(a)).to(dev)
                            for a in ins))
        outs.append([x.cpu() for x in (*out, state.dev_counts)])
    for name, a, b in zip(("packed", "rec1", "rec2", "dev_counts"), *outs):
        assert torch.equal(a, b), name
