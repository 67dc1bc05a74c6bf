"""K2's thread-group decomposition (pecaller_tpu_torch/csrc/sw_tb_rows.cu)
rehearsed on the CPU: a numpy model of the group algorithm against the
plain sw2.sw_traceback_rows of the port, and the port's traceback
against the JAX package's on the same edge cases.

The model runs each lane as the kernel's group of G threads does, thread
g owning the C columns [g*C, g*C + C) of the instance for the width
(K2 takes K1's instance table, sw_group.cuh).  Phase 1: the DP rows of
test_torch_sw_group's group_row; per row, the parts of the old row at
each own column (b1, t1 into its byte, a0, t0 into the next column's)
and of the new row (b2, t2 into the next column's), the thread's first
byte taking its left neighbour's last column (one shfl_up); a row past
blen holds its values; rows 1..min(bt_i, n_rows) are stored.  Phase 2,
one row per step: each thread's highest column <= jj whose b2 bit is 0,
the highest thread that has one (a ballot) and its column (a shuffle)
give jc; a ballot of the threads with a t2 bit in [max(jc, 1), jj]
gives the run's tie; the byte of column cstep comes from its owner (a
shuffle); thread r % G keeps row r's outputs, and every G rows the
group stores G rows, the read code of a diagonal step looked up only
then.  Tolerance: bitwise (integer DP)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from pecaller_tpu.ops import sw2 as jsw2
from pecaller_tpu_torch.ops import sw2, sw_cuda
from pecaller_tpu_torch.ops.sw2 import EV_DEL, EV_NONE, EXT, OPEN, XN
from test_torch_sw_group import CASES, WIDTHS, group_init, group_row, shfl_up
from test_torch_sw_group import k1_cols as k2_cols  # K2 takes K1's table
from torch_util import cuda_device  # noqa: F401  (fixture)


def k2_slot(C):
    """sw_tb_slot: bytes of a thread's slot in a cube row."""
    return 4 if C <= 4 else 8 if C <= 8 else 16 if C <= 16 else 32


def group_cube(refs, blens, reads, bt_i, rlens, G, C, bisulfite, n_rows):
    """Phase 1: the decision bytes (B, n_rows, G, C) of rows
    1..min(bt_i, n_rows) of each lane that walks (zero elsewhere), and
    each lane's last row."""
    B = refs.shape[0]
    S0, S1, S2, rd, j = (x.astype(np.int32)
                         for x in group_init(reads, G, C))
    alive = (bt_i > 0) & (rlens > 0)
    rmax = np.where(alive, np.minimum(bt_i, n_rows), 0)
    cube = np.zeros((B, n_rows, G, C), np.int32)
    for i in range(1, int(rmax.max(initial=0)) + 1):
        m = np.maximum(S0, S1)
        a0 = np.where(S2 > m, 2, np.where(S1 > S0, 1, 0))
        t0 = (S1 == S0) | (S2 == m)
        x, y = S1 - EXT, S0 - OPEN
        byte = ((x > y) << 2) | ((x == y) << 5)
        carry = a0 | (t0 << 4)
        c0, c1, c2 = group_row(S0, S1, S2, rd, refs[:, i - 1], j, bisulfite)
        hold = (i > blens)[:, None, None]
        S0 = np.where(hold, S0, c0)
        S1 = np.where(hold, S1, c1)
        S2 = np.where(hold, S2, c2)
        x, y = S2 - EXT, S0 - OPEN
        carry = carry | ((x > y) << 3) | ((x == y) << 6)
        byte[:, :, 1:] |= carry[:, :, :-1]
        left = shfl_up(carry[:, :, -1], 1)
        left[:, 0] = 0
        byte[:, :, 0] |= left
        cube[i <= rmax, i - 1] = byte[i <= rmax]
    return cube, rmax


def highest(mask):
    """Index of the highest set element along the last axis, -1 if
    none (31 - clz)."""
    n = mask.shape[-1]
    idx = n - 1 - np.argmax(mask[..., ::-1], axis=-1)
    return np.where(mask.any(axis=-1), idx, -1)


def group_traceback(refs, blens, reads, rlens, bt_k, bt_i, G, C, bisulfite,
                    n_rows):
    B, M = reads.shape
    W = M + 1
    cube, rmax = group_cube(refs, blens, reads, bt_i, rlens, G, C,
                            bisulfite, n_rows)
    j = np.arange(G * C).reshape(G, C)
    lanes = np.arange(B)
    jj = rlens.astype(np.int64)
    kk = bt_k.astype(np.int64)
    alive = rmax > 0
    tie = np.zeros(B, bool)
    ev_kind = np.zeros((B, n_rows), np.int64)
    ins_j = np.zeros((B, n_rows), np.int64)
    ins_len = np.zeros((B, n_rows), np.int64)
    rec = [np.full((B, G), EV_NONE), np.full((B, G), -1),
           np.zeros((B, G), np.int64)]
    wmax = int(rmax.max(initial=0))
    for r in range(-(-n_rows // G) * G - 1, -1, -1):
        i = r + 1
        if i <= wmax and alive.any():
            act = alive & (i <= rmax)
            row = cube[:, i - 1]
            upto = (((jj >= 0) & (jj < W))[:, None, None]
                    & (j[None] <= jj[:, None, None]))
            z = (((row >> 3) & 1) == 0) & upto
            cand = np.where(z.any(2), j[None, :, 0] + highest(z), -1)
            src = highest(z.any(2))
            jc = np.where(src >= 0, cand[lanes, np.maximum(src, 0)], -1)
            t2 = (((row >> 6) & 1) == 1) & upto & (
                j[None] >= np.maximum(jc, 1)[:, None, None])
            t2_any = t2.any(axis=(1, 2))

            is2 = act & (kk == 2)
            is1 = act & (kk == 1)
            run_dead = is2 & (jc <= 1)
            run_len = np.where(is2, np.where(run_dead, jj, jj - jc + 1), 0)
            cstep = np.where(is2, jc - 1, jj)
            cc = np.clip(cstep, 0, W - 1)
            bits = row[lanes, cc // C, cc % C]
            consume = act & ~run_dead
            diag = consume & ~is1
            kcol = np.clip(cc - 1, 0, M)
            attach = (diag & (run_len > 0)) | run_dead
            g = r % G
            rec[0][:, g] = np.where(consume, np.where(
                ~diag, EV_DEL, np.where(kcol < M, 16 + kcol, EV_NONE)),
                rec[0][:, g])
            rec[1][:, g] = np.where(attach, np.where(run_dead, 0, cstep),
                                    rec[1][:, g])
            rec[2][:, g] = np.where(attach, run_len, rec[2][:, g])
            nk = np.where(is1, (bits >> 2) & 1, bits & 3)
            nj = np.where(is1, jj, cstep - 1)
            nalive = consume & (nj > 0) & (i - 1 > 0)
            tie |= ((diag & (((bits >> 4) & 1) == 1) & nalive)
                    | (is1 & (((bits >> 5) & 1) == 1) & nalive)
                    | (is2 & t2_any))
            jj = np.where(act, nj, jj)
            kk = np.where(act, nk, kk)
            alive = np.where(act, nalive, alive)
        if r % G == 0:
            for g in range(G):
                if r + g < n_rows:
                    ev = rec[0][:, g]
                    code = reads[lanes, np.clip(ev - 16, 0, M - 1)]
                    ev_kind[:, r + g] = np.where(
                        ev >= 16, np.where(code == XN, EV_NONE, code), ev)
                    ins_j[:, r + g] = rec[1][:, g]
                    ins_len[:, r + g] = rec[2][:, g]
            rec = [np.full((B, G), EV_NONE), np.full((B, G), -1),
                   np.zeros((B, G), np.int64)]
    return (ev_kind, ins_j, ins_len, tie), cube, rmax


def k2_inputs(seed, width, bisulfite):
    """k2_edge_lanes after every edge lane of k1_edge_lanes and 41 lanes
    of the random mix, the starts not forced taken from the plain
    sw_align_x."""
    M, N, n_rows = WIDTHS[width]
    cols = sorted({k2_cols(M, g) for g in (8, 16, 32)} - {0})
    rx, bl, dx, rl, fk, fi, forced = chip_smoke.k2_edge_lanes(
        np.random.default_rng(seed), None, N, M, cols, n_rows)
    _, bk, bi, _ = sw2.sw_align_x(*(torch.from_numpy(x)
                                    for x in (rx, bl, dx, rl)),
                                  bisulfite=bisulfite, n_rows=n_rows)
    bk = np.where(forced, fk, bk.numpy()).astype(np.int32)
    bi = np.where(forced, fi, bi.numpy()).astype(np.int32)
    return (rx, bl, dx, rl, bk, bi), n_rows


def plain(lanes, bisulfite, n_rows):
    return [x.numpy() for x in sw2.sw_traceback_rows(
        *(torch.from_numpy(np.asarray(x)) for x in lanes),
        bisulfite=bisulfite, n_rows=n_rows)]


@pytest.mark.parametrize("bis", [False, True])
@pytest.mark.parametrize("width,G", CASES)
def test_group_traceback_matches_plain(width, G, bis):
    lanes, n_rows = k2_inputs(80 + G + bis, width, bis)
    rx, bl, dx, rl, bk, bi = lanes
    M = dx.shape[1]
    C = k2_cols(M, G)
    assert C, f"no K2 instance with {G} threads a lane at {width}"
    want = plain(lanes, bis, n_rows)
    got, cube, rmax = group_traceback(rx, bl, dx, rl, bk, bi, G, C, bis,
                                      n_rows)
    for x, y in zip(got, want):
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64))
    # phase 1's bytes are the plain decision bytes of the rows walked
    dec = sw2.decision_rows(torch.from_numpy(rx), torch.from_numpy(bl),
                            torch.from_numpy(dx), bis, n_rows).numpy()
    flat = cube.reshape(len(rx), n_rows, G * C)[:, :, :M + 1]
    stored = np.arange(1, n_rows + 1)[None, :] <= rmax[:, None]
    assert np.array_equal(flat[stored],
                          dec[1:].transpose(1, 0, 2)[stored])
    # the cases the inputs were made for occur
    ev, ij, il, tie = want
    assert tie.any() and not tie.all()
    assert (il > 0).any() and (ij == 0).any()       # runs, dead in a run
    assert (bi > n_rows).any() and (bi > bl).any() and (bi <= 0).any()
    assert (rl > M).any() and (rl == 0).any() and (rl == M).any()
    assert (il >= C + 1).any()                      # a run crosses threads


@pytest.mark.parametrize("bis", [False, True])
def test_plain_traceback_matches_jax_on_edges(bis):
    lanes, n_rows = k2_inputs(95 + bis, "100bp", bis)
    port = plain(lanes, bis, n_rows)
    ref = jsw2.sw_traceback_rows(*(jnp.asarray(x) for x in lanes),
                                 bisulfite=bis, n_rows=n_rows)
    for x, y in zip(port, ref):
        assert np.array_equal(x, np.asarray(y))


@pytest.mark.cuda
def test_tb_cols_table_matches_kernel(cuda_device):
    """k2_cols and k2_slot, the model's copies of the kernel's instance
    table and slot bytes, against the kernels' shared sw_lane_cols and
    K2's sw_tb_rows_row_bytes."""
    lib = sw_cuda.load_kernels()
    for M in range(-1, 600):
        for G in (0, 8, 16, 32):
            C = k2_cols(M, G or lib.sw_lane_group(M)) if M >= 0 else 0
            assert lib.sw_lane_cols(M, G) == C, (M, G)
            assert lib.sw_tb_rows_row_bytes(M, G) == (
                (G or lib.sw_lane_group(M)) * k2_slot(C) if C else 0)
