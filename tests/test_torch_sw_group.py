"""K1's thread-group decomposition (pecaller_tpu_torch/csrc/sw_align_x.cu)
rehearsed on the CPU: a numpy model of the group algorithm against the
plain sw2.sw_align_x of the port, and the port's sw2 against the JAX
package's on the same edge cases.

The model computes each DP row as the kernel's group of G threads does:
thread g owns the C columns [g*C, g*C + C), C the columns per thread of
the kernel's instance for the width (K1_COLS); c0 and c1 take the left
neighbour's old max(o0, o1, o2) (a shfl_up); the insertion plane is a
running max over each thread's columns, whose first element takes the
neighbour's new c0 (a second shfl_up), combined with an exclusive
max-scan of the segment maxima over the group in log2(G) shfl_up steps
with identity NEG; the thread that owns column rlen keeps best / k / i /
tie.  The match rule is an argument (Rule, the kernels' Match policy):
K1 and K2 take the xcode rule, test_torch_k3_group K3's byte rule.
Tolerance: bitwise (integer DP)."""

from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from pecaller_tpu.ops import sw2 as jsw2
from pecaller_tpu_torch.ops import sw2, sw_cuda
from pecaller_tpu_torch.ops.sw2 import EXT, MATCH, MISMATCH, NEG, OPEN, XN
from torch_util import cuda_device  # noqa: F401  (fixture)

# (M, N, n_rows): 100 bp reads on the main path's widths, 250 bp, and
# the widest reads the launch gives 8 and 16 threads a lane
WIDTHS = {"100bp": (112, 144, 125), "250bp": (256, 288, 270),
          "128col": (127, 160, 140), "256col": (255, 288, 270)}
# (width, threads a lane): each group size the kernel has at each width
CASES = [("100bp", 8), ("100bp", 16), ("100bp", 32), ("250bp", 32),
         ("128col", 8), ("256col", 16)]
# kSwXCols of sw_align_x.cu: the columns per thread instantiated for
# each group size; a launch takes the smallest C with G x C >= M + 1
K1_COLS = {8: (8, 15, 16), 16: (8, 12, 16), 32: (4, 10, 12, 14, 16, 18)}


def k1_cols(M, G):
    """sw_lane_cols(M, G): the kernel's columns per thread, 0 where
    no instance takes width M."""
    return next((C for C in K1_COLS[G] if G * C >= M + 1), 0)


def shfl_up(x, d):
    """__shfl_up_sync over axis 1 (the group): thread g gets thread
    g - d's value, threads below d keep their own."""
    out = x.copy()
    out[:, d:] = x[:, :-d]
    return out


def xcode_match(rb, rd, bisulfite):
    """K1's and K2's match rule (sw_bump): reference codes rb against
    read codes rd, broadcast."""
    m = (rd == rb) | (rb == XN) | (rd == XN)
    if bisulfite:
        m |= (rb == 1) & (rd == 3)
    return m


class Rule(NamedTuple):
    """A match rule of the kernels' row (the policy Match of
    sw_group.cuh): code(reads, bisulfite) the read registers
    (Match::code), ref(refs, bisulfite) a row's reference values, and
    match(rb, rd, bisulfite) (Match::bump's test)."""
    code: Callable
    ref: Callable
    match: Callable


XCODES = Rule(lambda x, bis: x, lambda x, bis: x, xcode_match)


def group_init(reads, G, C, code=None):
    """Row 0 of the three planes and the read codes, (B, G, C) each, and
    the global column of each slot (G, C) (sw_group_init); ``code`` maps
    the read bytes to their registers (identity: xcodes)."""
    B, M = reads.shape
    assert G * C >= M + 1
    j = np.arange(G * C, dtype=np.int32).reshape(G, C)
    b = -(OPEN + (j - 1) * EXT)
    S0 = np.broadcast_to(np.where(j == 0, 0, b), (B, G, C)).copy()
    S1 = S0.copy()
    S2 = np.broadcast_to(np.where(j == 0, -OPEN, b), (B, G, C)).copy()
    inside = (j >= 1) & (j <= M)
    rd = np.zeros((B, G, C), np.int32)
    x = reads[:, j[inside] - 1]
    rd[:, inside] = x if code is None else code(x)
    return S0, S1, S2, rd, j


def group_row(S0, S1, S2, rd, rb, j, bisulfite, match=xcode_match):
    """The new row (c0, c1, c2) of every lane's group (sw_group_row);
    rb (B,) the row's reference values, ``match`` the rule."""
    G = j.shape[0]
    rb = rb.astype(np.int32)[:, None, None]
    m = match(rb, rd, bisulfite)
    old3 = np.maximum(np.maximum(S0, S1), S2)
    p3 = np.concatenate([shfl_up(old3[:, :, -1], 1)[:, :, None],
                         old3[:, :, :-1]], axis=2)
    c0 = p3 + np.where(m, MATCH, MISMATCH)
    c1 = np.maximum(S0 - OPEN, S1 - EXT)
    c0[:, 0, 0] = 0                                      # column 0
    c1[:, 0, 0] = 0
    first = shfl_up(c0[:, :, -1], 1) - OPEN + j[:, 0]
    first[:, 0] = -OPEN                                  # a[0]
    a = np.concatenate([first[:, :, None],
                        c0[:, :, :-1] - OPEN + j[:, 1:]], axis=2)
    run = np.maximum.accumulate(a, axis=2)
    x = run[:, :, -1]
    d = 1
    while d < G:
        x = np.where(np.arange(G) >= d, np.maximum(x, shfl_up(x, d)), x)
        d *= 2
    ex = shfl_up(x, 1)
    ex[:, 0] = NEG
    return c0, c1, np.maximum(ex[:, :, None], run) - j


def group_align(refs, blens, reads, rlens, G, C, bisulfite, n_rows,
                rule=XCODES):
    """The kernel's results (score, k, i, tie) from the group model:
    K1's under XCODES; K3 returns the first three under its byte rule."""
    B = refs.shape[0]
    M = reads.shape[1]
    S0, S1, S2, rd, j = group_init(reads, G, C,
                                   lambda x: rule.code(x, bisulfite))
    rlens = rlens.astype(np.int64)
    rows = np.clip(np.minimum(n_rows, blens.astype(np.int64)), 0, None)
    in_range = (rlens >= 0) & (rlens <= M)
    lanes = np.arange(B)
    g_own = np.where(in_range, rlens // C, 0)
    c_own = np.where(in_range, rlens % C, 0)
    best = np.where(rlens == 0, 0, -(OPEN + (rlens - 1) * EXT))
    bk = np.zeros(B, np.int64)
    bi = np.zeros(B, np.int64)
    n_at = np.ones(B, np.int64)
    for i in range(1, int(rows[in_range].max(initial=0)) + 1):
        S0, S1, S2 = group_row(S0, S1, S2, rd,
                               rule.ref(refs[:, i - 1], bisulfite), j,
                               bisulfite, rule.match)
        active = in_range & (i <= rows)
        for k, P in enumerate((S0, S1, S2)):
            v = P[lanes, g_own, c_own]
            upd = active & (v > best)
            n_at = np.where(upd, 1, np.where(active & (v == best), n_at + 1,
                                             n_at))
            best = np.where(upd, v, best)
            bk = np.where(upd, k, bk)
            bi = np.where(upd, i, bi)
    best = np.where(in_range, best, NEG)
    n_at = np.where(in_range, n_at, 1 + 3 * rows)
    return best, bk, bi, n_at >= 2


def edge_inputs(seed, width):
    """Every edge lane of k1_edge_lanes for the group sizes the kernel
    has at the width, then 41 lanes of the random mix."""
    M, N, n_rows = WIDTHS[width]
    cols = sorted({k1_cols(M, g) for g in (8, 16, 32)} - {0})
    B = 3 * (M + 4) + 41
    lanes = chip_smoke.k1_edge_lanes(np.random.default_rng(seed), B, N, M,
                                     cols)
    return lanes, n_rows


@pytest.mark.parametrize("bis", [False, True])
@pytest.mark.parametrize("width,G", CASES)
def test_group_model_matches_plain(width, G, bis):
    (rx, bl, dx, rl), n_rows = edge_inputs(70 + G + bis, width)
    C = k1_cols(dx.shape[1], G)
    assert C, f"no K1 instance with {G} threads a lane at {width}"
    model = group_align(rx, bl, dx, rl, G, C, bis, n_rows)
    plain = sw2.sw_align_x(*(torch.from_numpy(np.asarray(x))
                             for x in (rx, bl, dx, rl)),
                           bisulfite=bis, n_rows=n_rows)
    for x, y in zip(model, plain):
        assert np.array_equal(x.astype(np.int64), y.numpy().astype(np.int64))
    assert plain[3].any() and not plain[3].all()
    assert (rl > dx.shape[1]).any() and (rl == 0).any()


@pytest.mark.parametrize("width", ["100bp", "250bp"])
@pytest.mark.parametrize("bis", [False, True])
def test_plain_matches_jax_on_edges(bis, width):
    (rx, bl, dx, rl), n_rows = edge_inputs(90 + bis, width)
    port = sw2.sw_align_x(*(torch.from_numpy(np.asarray(x))
                            for x in (rx, bl, dx, rl)),
                          bisulfite=bis, n_rows=n_rows)
    ref = jsw2.sw_align_x(*(jnp.asarray(x) for x in (rx, bl, dx, rl)),
                          bisulfite=bis, n_rows=n_rows)
    for x, y in zip(port, ref):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.cuda
def test_cols_table_matches_kernel(cuda_device):
    """K1_COLS, the model's copy of the kernel's instance table, against
    the kernel's own sw_lane_cols, and every case above against the
    group size the launch picks or a forced one that exists."""
    lib = sw_cuda.load_kernels()
    for M in range(-1, 600):
        for G in (8, 16, 32):
            assert lib.sw_lane_cols(M, G) == (k1_cols(M, G) if M >= 0
                                                 else 0), (M, G)
    assert lib.sw_lane_group(112) == 8
    assert lib.sw_lane_group(127) == 8
    assert lib.sw_lane_group(255) == 16
    assert lib.sw_lane_group(256) == 32
