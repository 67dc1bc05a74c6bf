"""Shared inputs of the PyTorch port's tests (tests/test_torch_*.py).

The mapping data is that of tests/test_fused2.py (seed 43: two contigs
of 30 kb and 20 kb with an N block, 900 read pairs of 100 bp), made with
numpy so that both packages see identical inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecaller_tpu.index.nbr import NbrIndex, build_nbr_index
from pecaller_tpu.mapper import device_map2 as jdm
from pecaller_tpu_torch.mapper import device_map2 as tdm
from util import make_genome, sample_reads, write_fasta, write_fastq

# the suite runs in several worker processes: torch's CPU thread pool
# (spin-waiting OpenMP workers) oversubscribes the cores otherwise
torch.set_num_threads(1)

# genome kwargs of the reference tests/test_fused2.py configurations
PAIRED = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
SINGLE = dict(paired=False, min_align=0.9, nthreads=2)


def make_fused2_data(d, seed=43):
    """Write g.* (index without the dense .idx) and r1/r2.fastq into d
    (seed 47: the data of tests/test_quarter.py)."""
    rng = np.random.default_rng(seed)
    names, seqs = make_genome(rng, [30000, 20000], n_blocks=[(0, 5000, 30)])
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 900, read_len=100, err_rate=0.01,
                         paired=True, insert_lo=150, insert_hi=450,
                         indel_rate=0.15, max_indel=4)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def make_fused_data(d):
    """Write g.* and r1/r2.fastq of tests/test_fused.py (seed 42) into d."""
    rng = np.random.default_rng(42)
    names, seqs = make_genome(rng, [30000, 20000], n_blocks=[(0, 5000, 30)])
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 900, read_len=100, err_rate=0.01,
                         paired=True, insert_lo=150, insert_hi=450,
                         indel_rate=0.15, max_indel=4)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def make_bisulfite_data(d):
    """The bisulfite configuration of tests/test_fused2.py (seed 77)."""
    rng = np.random.default_rng(77)
    names, seqs = make_genome(rng, [20000])
    fa = str(d / "b.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "b"), bisulfite=True, write_idx=False)
    reads = sample_reads(rng, names, seqs, 400, read_len=100,
                         err_rate=0.01, paired=True, insert_lo=150,
                         insert_hi=400, indel_rate=0.05, max_indel=3)
    conv = []
    for r1, r2, info in reads:
        def cv(s):
            s = s.copy()
            m = (s == ord("C")) & (rng.random(len(s)) < 0.8)
            s[m] = ord("T")
            return s
        conv.append((cv(r1), cv(r2), info))
    write_fastq(str(d / "b1.fastq"), conv, which=0)
    write_fastq(str(d / "b2.fastq"), conv, which=1)
    return d


def load_genome(d, base="g"):
    from pecaller_tpu.formats.index_files import load_index
    from pecaller_tpu.formats.sdx import read_sdx, read_seq
    sdx = read_sdx(str(d / f"{base}.sdx"))
    genome = read_seq(str(d / f"{base}.seq"), sdx.genome_size)
    return sdx, genome, load_index(str(d / base))


def batches(d, f1, f2, batch_size):
    from pecaller_tpu.formats.fastq import FastqBatcher
    return list(FastqBatcher(str(d / f1), str(d / f2) if f2 else None,
                             batch_size=batch_size).batches())


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda", 0)


def record_split(eng):
    """Wrap the split engine ``eng``'s seed resolve and traceback so
    that each call's output (host arrays) is kept, in call order:
    returns {"seeds": [(hits, hits_off, orient, tot, rev), ...],
    "rec": [(insertion records,), ...]}."""
    seen = {"seeds": [], "rec": []}
    resolve, traceback = eng._initial_map_resolve, eng._traceback

    def seeds(handle):
        out = resolve(handle)
        seen["seeds"].append(tuple(np.array(x) for x in out))
        return out

    def rec(lanes):
        out = traceback(lanes)
        seen["rec"].append((np.array(out),))
        return out
    eng._initial_map_resolve, eng._traceback = seeds, rec
    return seen


def same_records(a, b):
    """Two record_split lists hold the same arrays, bitwise."""
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


# ---- the fused step on one batch, for both packages

CPU = torch.device("cpu")


def make_step_data(d):
    """Both mapping configurations."""
    make_fused2_data(d)
    make_bisulfite_data(d)
    return d


_NBR = {}               # one NbrIndex build per genome (~10 s each)


def shared_nbr(d, base, index, binsearch):
    key = str(d / base)
    if key not in _NBR:
        _NBR[key] = build_nbr_index(index).with_cuckoo()
    nbr = _NBR[key]
    if binsearch:                       # the same arrays, no cuckoo table
        nbr = NbrIndex(nbr.nkeys, nbr.val_start, nbr.positions,
                       nbr.hi_table)
    return nbr


class StepCase:
    """One batch of one configuration, ready for both steps."""

    def __init__(self, d, base, f1, f2, paired, bisulfite, n, seed,
                 binsearch=False, monkeypatch=None, quarter=None,
                 qkw=None):
        """``quarter``: seed through this (JAX package's) QuarterIndex,
        with the probe parameters ``qkw`` (t1, rcap, hv; the JAX step
        reads them from its environment knobs, set through
        ``monkeypatch``), instead of the nbr index."""
        from pecaller_tpu.mapper.engine import MapperEngine
        self.sdx, self.genome, index = load_genome(d, base)
        if quarter is not None:
            from pecaller_tpu.index.quarter import QuarterDeviceIndex
            from pecaller_tpu_torch.index.quarter import QuarterIndex
            qkw = {"t1": 4, "rcap": 12, "hv": 0, **(qkw or {})}
            for knob, k in (("T1", "t1"), ("RCAP", "rcap"), ("HV", "hv")):
                monkeypatch.setenv(f"PECALLER_Q4_{knob}", str(qkw[k]))
            self.jd = QuarterDeviceIndex(quarter)
            nbr = QuarterIndex(quarter.starts, quarter.cnts, quarter.pos,
                               quarter.qw)
        else:
            qkw = {}
            nbr = shared_nbr(d, base, index, binsearch)
            if binsearch:
                monkeypatch.setenv("PECALLER_NO_CUCKOO", "1")
            self.jd = jdm.NbrDeviceIndex(nbr)
        self.kw = dict(paired=paired, bisulfite=bisulfite, min_dist=0,
                       max_dist=500, n_contigs=self.sdx.n_contigs)
        self.shape = dict(B=_bucket(n), M=112, N=144, s_max=6,
                          max_rlen=104)
        cw, mw = jdm.pack_genome(self.genome)
        ist = self.sdx.istarts.astype(np.int32)
        st_pad = np.full(max(self.sdx.n_contigs + 1, 70) + 1, 2 ** 31 - 1,
                         np.int32)
        st_pad[:len(ist)] = ist
        self.jfixed = (jnp.asarray(cw), jnp.asarray(mw), jnp.asarray(ist),
                       jnp.asarray(st_pad))
        rng = np.random.default_rng(seed)
        self.counts = rng.integers(
            0, 7, (self.sdx.genome_size + tdm.SCATTER_PAD) * 6).astype(
                np.uint32)
        self.state = tdm.carry_state(nbr, cw, mw, self.sdx.istarts,
                                     self.sdx.n_contigs, self.counts, CPU,
                                     **qkw)
        # the reference engine's host prep makes the batch tensors
        host = jdm.FusedMapperEngine2.__new__(jdm.FusedMapperEngine2)
        MapperEngine.__init__(host, self.sdx, self.genome, index,
                              min_align=0.9, paired=paired, nthreads=1)
        (s1, l1, s2, l2, _), = batches(d, f1, f2, n)[:1]
        B = self.shape["B"]
        ins = host._prep_end2(s1, np.asarray(l1, np.int64), B, 112, 6)
        if paired:
            ins2 = host._prep_end2(s2, np.asarray(l2, np.int64), B, 112, 6)
            ins = [np.concatenate([x, y]) for x, y in zip(ins, ins2)]
        self.ins = ins

    def jax_raw(self):
        return jdm.build_fused_step2(self.jd, genome_size=0, jit=False,
                                     **self.kw, **self.shape)

    def port_step(self):
        return tdm.FusedStep2(self.state.dnbr, **self.kw, **self.shape)

    def tins(self):
        return [torch.from_numpy(np.array(x)) for x in self.ins]


def _bucket(n):
    from pecaller_tpu_torch.mapper.host_prep import _bucket_b
    return _bucket_b(n)


def step_closures(raw):
    return dict(zip(raw.__code__.co_freevars,
                    (c.cell_contents for c in raw.__closure__)))


def bit_equal(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    return port.shape == ref.shape and np.array_equal(
        port.astype(np.int64), ref.astype(np.int64))


CASES = {
    "paired": ("g", "r1.fastq", "r2.fastq", True, False, 900),
    "single": ("g", "r1.fastq", None, False, False, 900),
    "bisulfite": ("b", "b1.fastq", "b2.fastq", True, True, 400),
}


def check_step(data, name, **case_kw):
    """Whole step of one configuration: packed output and dev_counts.
    Returns the case and the port's output."""
    c = StepCase(data, *CASES[name], seed=len(name), **case_kw)
    fn = jax.jit(c.jax_raw())
    dc_j, out_j = fn(jnp.asarray(c.counts), *c.jd.args, *c.jfixed, *c.ins)
    out_t = c.port_step()(c.state, *c.tins())
    assert bit_equal(out_t, out_j)
    assert np.array_equal(c.state.dev_counts.numpy().view(np.uint32),
                          np.asarray(dc_j))
    B = c.shape["B"]
    assert (out_t[:B, 2] != 8).any()                  # reads mapped
    assert int(out_t[B + tdm.INS_CAP, 0]) > 0         # insertion records
    assert not np.array_equal(np.asarray(dc_j), c.counts)
    return c, out_t


# ---- the genome-sharded octile engine

def make_gshard_data(d):
    """tests/test_gshard.py's data (seed 91): two contigs of 150 kb and
    110 kb with a repeated block, 1200 pairs of 100 bp; g.* and
    r1/r2.fastq in d."""
    rng = np.random.default_rng(91)
    names, seqs = make_genome(rng, [150_000, 110_000],
                              n_blocks=[(0, 9000, 25)])
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 1200, read_len=100, err_rate=0.01,
                         paired=True, insert_lo=150, insert_hi=450,
                         indel_rate=0.1, max_indel=4)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def make_tie_genome_data(d):
    """tests/test_gshard.py's cross-shard tie genome (seed 17): one 200 kb
    contig with copies of a 400 bp block in each half of a 2-shard plan
    and across its boundary, 600 pairs."""
    rng = np.random.default_rng(17)
    names, seqs = make_genome(rng, [200_000])
    s = seqs[0]
    block = s[20_000:20_400].copy()
    s[150_000:150_400] = block
    s[99_800:100_200] = block
    fa = str(d / "g.fa")
    write_fasta(fa, names, seqs)
    from pecaller_tpu.index import build_index
    build_index(fa, str(d / "g"), write_idx=False)
    reads = sample_reads(rng, names, seqs, 600, read_len=100, err_rate=0.005,
                         paired=True, insert_lo=150, insert_hi=450)
    write_fastq(str(d / "r1.fastq"), reads, which=0)
    write_fastq(str(d / "r2.fastq"), reads, which=1)
    return d


def jax_genome_mesh(n):
    """The JAX tests' 1-D genome mesh over n virtual CPU devices."""
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("genome",))


def port_genome_mesh(n, device=CPU):
    from pecaller_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(1, n, [device] * n)
