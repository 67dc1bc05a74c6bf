"""K3's thread-group decomposition (pecaller_tpu_torch/csrc/sw_align.cu)
rehearsed on the CPU: the numpy model of the group algorithm of
test_torch_sw_group (the row of csrc/sw_group.cuh) under K3's byte match
rule, against the port's plain sw.sw_align_device, the JAX package's
sw.sw_align_device and its Pallas kernel sw_align_pallas in interpret
mode.

The byte rule is modelled as the kernel computes it (SwByteMatch): a
read byte's register holds the byte and three flags (bit 8 wildcard
N/n, bit 9 bisulfite T/t, bit 10 always), a reference byte's row value
the byte and the flags it matches (bit 8 always, bit 9 bisulfite C/c,
bit 10 wildcard); a cell matches when the bytes are equal or the two
share a flag.  Inputs: chip_smoke.k3_edge_lanes (rlen at 0, M, M + 1,
M + 7, -1 and at k*C - 1, k*C, k*C + 1; N/n, lowercase, IUPAC and
bisulfite C/T pairs at segment boundaries; blen past N, below 0 and 0)
at every (G, C) instance of the kernel's table at the widest width it
takes and at the 100 bp and 250 bp widths with each group size that
takes them, with all rows and with n_rows < N.  Tolerance: bitwise
(integer DP)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pecaller_tpu.ops import sw as jsw
from pecaller_tpu.ops.sw_pallas import sw_align_pallas
from pecaller_tpu_torch.ops import sw, sw_cuda
from test_torch_sw_group import K1_COLS, Rule, group_align, k1_cols
from torch_util import cuda_device  # noqa: F401  (fixture)

_N, _n = ord("N"), ord("n")


def byte_code(b, bis):
    """SwByteMatch::code: the registers of read bytes b."""
    b = b.astype(np.int64)
    wild = (b == _N) | (b == _n)
    bis_t = bis & ((b == ord("T")) | (b == ord("t")))
    return b | 0x400 | wild << 8 | bis_t << 9


def byte_ref(b, bis):
    """SwByteMatch::ref: the row values of reference bytes b."""
    b = b.astype(np.int64)
    wild = (b == _N) | (b == _n)
    bis_c = bis & ((b == ord("C")) | (b == ord("c")))
    return b | 0x100 | bis_c << 9 | wild << 10


def byte_match(r, q, bisulfite):
    """SwByteMatch::bump's test."""
    return (((r ^ q) & 0xFF) == 0) | ((r & q & 0x700) != 0)


BYTES = Rule(byte_code, byte_ref, byte_match)

# (M, N, threads a lane): each instance (G, C) of the table at the widest
# width it takes (G x C - 1), then the v1 main-path width (100 bp reads,
# M 112, N 160) with each group size and 250 bp reads
CASES = ([(G * C - 1, G * C + 47, G) for G, cs in K1_COLS.items()
          for C in cs]
         + [(112, 160, 8), (112, 160, 16), (112, 160, 32), (256, 288, 32)])


def edge_inputs(seed, M, N):
    """Every edge lane of k3_edge_lanes for the group sizes the kernel
    has at width M, then 41 lanes of the random mix."""
    cols = sorted({k1_cols(M, g) for g in (8, 16, 32)} - {0})
    B = 3 * len(chip_smoke.edge_marks(M, cols)) + 41
    return chip_smoke.k3_edge_lanes(np.random.default_rng(seed), B, N, M,
                                    cols)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("bis", [False, True])
@pytest.mark.parametrize("M,N,G", CASES,
                         ids=[f"M{m}-G{g}" for m, _, g in CASES])
def test_k3_group_model_matches_plain(M, N, G, bis):
    refs, bl, reads, rl = edge_inputs(110 + M + G + bis, M, N)
    C = k1_cols(M, G)
    assert C, f"no K3 instance with {G} threads a lane at width {M}"
    for n_rows in (N, N - 29):
        model = group_align(refs, bl, reads, rl, G, C, bis, n_rows,
                            rule=BYTES)[:3]
        port = sw.sw_align_device(*_t(refs, bl, reads, rl), bisulfite=bis,
                                  n_rows=n_rows)
        ref = jsw.sw_align_device(*_j(refs, bl, reads, rl), bisulfite=bis,
                                  n_rows=n_rows)
        for x, y, z in zip(model, port, ref):
            assert np.array_equal(x, y.numpy().astype(np.int64))
            assert np.array_equal(y.numpy(), np.asarray(z))
        if n_rows == N:         # the Pallas kernel takes n_rows >= N
            pal = sw_align_pallas(*_j(refs, bl, reads, rl), bisulfite=bis,
                                  n_rows=n_rows, interpret=True)
            # it reads its zero padding for M < rlen < round_up(M + 1, 8)
            # where the plain version has no column rlen (ROADMAP queue 3)
            ok = ~((rl > M) & (rl < -(-(M + 1) // 8) * 8))
            for x, y in zip(model, pal):
                assert np.array_equal(x[ok], np.asarray(y)[ok])
    # the edge cases are there: every rlen mark, every blen edge, the
    # raw letters, and best cells in the diagonal and insertion planes
    assert (rl > M).any() and (rl < 0).any() and (rl == 0).any()
    assert (bl > N).any() and (bl < 0).any() and (bl == 0).any()
    for ch in b"NnTtCcaR":
        assert (reads == ch).any() or (refs == ch).any(), chr(ch)
    assert {0, 2} <= set(np.unique(model[1]).tolist())


@pytest.mark.parametrize("bis", [False, True])
def test_byte_rule_matches_plain_bump(bis):
    """The register encoding against the plain version's match rule on
    every pair of bytes."""
    b = np.arange(256)
    r = byte_ref(b, bis)[:, None]
    q = byte_code(b, bis)[None, :]
    m = byte_match(r, q, bis)
    reads = torch.arange(256, dtype=torch.int32)[None, :].repeat(256, 1)
    plain = sw._bump_row(torch.arange(256, dtype=torch.int32), reads,
                         sw._read_flags(reads, bis), bis)
    assert np.array_equal(np.where(m, sw.MATCH, sw.MISMATCH),
                          plain.numpy())


@pytest.mark.cuda
def test_k3_cols_table_matches_kernel(cuda_device):
    """The model's (G, C) at each case above against the kernel's
    sw_lane_cols, and the kernel forced to each of those instances
    against the plain version on the card, on the cases' edge lanes in
    both modes (the model equals the plain version on them, above)."""
    lib = sw_cuda.load_kernels()
    for M, N, G in CASES:
        assert lib.sw_lane_cols(M, G) == k1_cols(M, G), (M, G)
        args = [x.to(cuda_device) for x in _t(*edge_inputs(7 + M, M, N))]
        for bis in (False, True):
            p = sw.sw_align_device(*args, bisulfite=bis)
            k = sw_cuda.sw_align(*args, bisulfite=bis, group=G)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(p, k)), (M, G)
