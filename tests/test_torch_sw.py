"""Plain PyTorch SW ops of the port (pecaller_tpu_torch/ops/sw2.py)
against the JAX package's sw2 and its Pallas kernels in interpret mode,
and the CUDA kernels against the plain ops where a card exists.

Tolerance: bitwise everywhere (all of the DP is integer arithmetic)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from pecaller_tpu.ops import sw2 as jsw2
from pecaller_tpu.ops.sw_pallas2 import sw_align_x_pallas, sw_tb_rows_pallas
from pecaller_tpu_torch.ops import sw2, sw_cuda
from test_sw2 import CODE, _mk
from torch_util import cuda_device  # noqa: F401  (fixture)


def _inputs(seed, B, N, M, lo, hi):
    """The adversarial _mk mix (substitutions, indels, N wildcards in
    reads and windows) plus padding lanes (blens 0, rlens 1)."""
    refs, blens, reads, rlens = _mk(np.random.default_rng(seed), B, N, M,
                                    lo, hi)
    blens[:6] = 0
    rlens[6:12] = 1
    return CODE[refs], blens, CODE[reads], rlens


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def bit_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("bis", [False, True])
def test_align_matches_jax(bis):
    rx, bl, dx, rl = _inputs(21 + bis, 256, 96, 80, 30, 73)
    n_rows = 90                                   # n_rows < N
    port = [x.numpy() for x in sw2.sw_align_x(*_t(rx, bl, dx, rl),
                                              bisulfite=bis, n_rows=n_rows)]
    ref = jsw2.sw_align_x(*_j(rx, bl, dx, rl), bisulfite=bis, n_rows=n_rows)
    pal = sw_align_x_pallas(*_j(rx, bl, dx, rl), bisulfite=bis,
                            n_rows=n_rows, interpret=True)
    assert bit_equal(port, ref)
    assert bit_equal(port, pal)
    assert port[3].any()                          # ties occur here


@pytest.mark.parametrize("bis", [False, True])
def test_traceback_matches_jax(bis):
    rx, bl, dx, rl = _inputs(31 + bis, 256, 64, 48, 17, 41)
    n_rows = 60
    _, bk, bi, _ = jsw2.sw_align_x(*_j(rx, bl, dx, rl), bisulfite=bis,
                                   n_rows=n_rows)
    bk, bi = np.asarray(bk), np.asarray(bi)
    port = [x.numpy() for x in sw2.sw_traceback_rows(
        *_t(rx, bl, dx, rl, bk, bi), bisulfite=bis, n_rows=n_rows)]
    ref = jsw2.sw_traceback_rows(*_j(rx, bl, dx, rl, bk, bi),
                                 bisulfite=bis, n_rows=n_rows)
    pal = sw_tb_rows_pallas(*_j(rx, bl, dx, rl, bk, bi), bisulfite=bis,
                            n_rows=n_rows, interpret=True)
    assert bit_equal(port, ref)
    assert bit_equal(port, pal)
    assert (port[1] >= 0).any() and port[3].any()  # insertions and ties


def test_wrappers_take_plain_path_on_cpu():
    rx, bl, dx, rl = _inputs(41, 64, 64, 48, 17, 41)
    before = dict(sw_cuda.LAUNCHES)
    a = sw_cuda.sw_align_x(*_t(rx, bl, dx, rl), n_rows=64)
    b = sw2.sw_align_x(*_t(rx, bl, dx, rl), n_rows=64)
    assert bit_equal(a, b)
    t = sw_cuda.sw_traceback_rows(*_t(rx, bl, dx, rl), a[1], a[2],
                                  n_rows=64)
    u = sw2.sw_traceback_rows(*_t(rx, bl, dx, rl), b[1], b[2], n_rows=64)
    assert bit_equal(t, u)
    assert sw_cuda.LAUNCHES == before           # no kernel launched


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["mixed", "edges-100bp", "edges-250bp"])
@pytest.mark.parametrize("bis", [False, True])
def test_kernels_match_plain_on_card(cuda_device, bis, mix):
    """K1 and K2 with each group size that takes the width against the
    plain versions: on the adversarial mix, and on the edge lanes of
    chip_smoke.k1_edge_lanes (K1: rlen at 0, M, past M and at every
    segment boundary, homopolymer ties) and chip_smoke.k2_edge_lanes
    (K2: those lanes plus forced starts: plane 2 at segment boundaries,
    runs across segments, walks dying in a run, bt_i past n_rows, past
    blen and <= 0), with B = 1001 and B = 1; K2 also with n_rows = 0."""
    lib = sw_cuda.load_kernels()
    if mix == "mixed":
        rx, bl, dx, rl = _inputs(51 + bis, 2048, 144, 112, 80, 101)
        M, n_rows = 112, 125
    else:
        M, N, n_rows = {"edges-100bp": (112, 144, 125),
                        "edges-250bp": (256, 288, 270)}[mix]
        cols = [c for c in (lib.sw_lane_cols(M, g) for g in (8, 16, 32))
                if c]
        rx, bl, dx, rl, fk, fi, forced = chip_smoke.k2_edge_lanes(
            np.random.default_rng(53 + bis), 1001, N, M, cols, n_rows)
    args = [x.to(cuda_device) for x in _t(rx, bl, dx, rl)]
    for sub in (args, [x[-1:] for x in args], [x[1:2] for x in args]):
        p = sw2.sw_align_x(*sub, bisulfite=bis, n_rows=n_rows)
        for group in (0, 8, 16, 32):
            if not lib.sw_lane_cols(M, group):
                continue
            k = sw_cuda.sw_align_x(*sub, bisulfite=bis, n_rows=n_rows,
                                   group=group)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(p, k)), group
    p = sw2.sw_align_x(*args, bisulfite=bis, n_rows=n_rows)
    bk, bi = p[1], p[2]
    if mix != "mixed":
        f = torch.from_numpy(forced).to(cuda_device)
        bk = torch.where(f, torch.from_numpy(fk).to(cuda_device), bk)
        bi = torch.where(f, torch.from_numpy(fi).to(cuda_device), bi)
    tb = args + [bk.contiguous(), bi.contiguous()]
    # the last case has no rows: every walk is empty
    for sub, nr in ((tb, n_rows), ([x[-1:] for x in tb], n_rows),
                    ([x[1:2] for x in tb], n_rows), (tb, 0)):
        pt = sw2.sw_traceback_rows(*sub, bisulfite=bis, n_rows=nr)
        for group in (0, 8, 16, 32):
            if not lib.sw_lane_cols(M, group):
                continue
            kt = sw_cuda.sw_traceback_rows(*sub, bisulfite=bis,
                                           n_rows=nr, group=group)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(pt, kt)), group


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card(cuda_device):
    rx, bl, dx, rl = _t(*_inputs(61, 64, 64, 48, 17, 41))
    args = [x.to(cuda_device) for x in (rx, bl, dx, rl)]
    with pytest.raises(TypeError):
        sw_cuda.sw_align_x(args[0], args[1].long(), args[2], args[3])
    with pytest.raises(ValueError):
        sw_cuda.sw_align_x(args[0][:, ::2], args[1], args[2], args[3])
    with pytest.raises(ValueError):
        sw_cuda.sw_align_x(args[0], args[1], args[2], args[3],
                           n_rows=65)
    with pytest.raises(ValueError):                  # no such group size
        sw_cuda.sw_align_x(*args, group=7)
    wide = torch.zeros((64, 576), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):                  # past the widest K1
        sw_cuda.sw_align_x(args[0], args[1], wide, args[3])
    with pytest.raises(ValueError):                  # past the widest K2
        sw_cuda.sw_traceback_rows(args[0], args[1], wide, args[3],
                                  args[1], args[1])
    with pytest.raises(ValueError):                  # no such group size
        sw_cuda.sw_traceback_rows(*args, args[1], args[1], group=7)
    with pytest.raises(ValueError):                  # past the widest K3
        sw_cuda.sw_align(args[0], args[1], wide, args[3])
    with pytest.raises(ValueError):                  # no such group size
        sw_cuda.sw_align(*args, group=7)
