"""Plain PyTorch SW ops of the v1 engine (pecaller_tpu_torch/ops/sw.py)
against the JAX package's ops/sw.py and its Pallas kernel K3
(sw_align_pallas) in interpret mode, and kernel K3 against the plain
version where a card exists, with each group size.

Inputs are raw bytes: A/C/G/T/N, lowercase a/c/g/t/n and IUPAC letters
in reads and windows, padding lanes (blen 0, rlen 1), n_rows < N.
Tolerance: bitwise everywhere (the DP is integer arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pecaller_tpu.ops import sw as jsw
from pecaller_tpu.ops.sw_pallas import sw_align_pallas
from pecaller_tpu_torch.ops import sw, sw_cuda
from test_sw2 import _mk
from torch_util import cuda_device  # noqa: F401  (fixture)

IUPAC = np.frombuffer(b"RYKMSWBDHVrykmswbdhv", np.uint8)


def raw_lanes(seed, B, N, M, lo, hi):
    """The adversarial _mk mix on raw bytes, with lowercase and IUPAC
    letters sprinkled into reads and windows, and padding lanes."""
    rng = np.random.default_rng(seed)
    refs, blens, reads, rlens = _mk(rng, B, N, M, lo, hi)

    def spice(x):
        x = np.where(rng.random(x.shape) < 0.05, x | 0x20, x)   # lowercase
        x = np.where(rng.random(x.shape) < 0.01,
                     IUPAC[rng.integers(0, len(IUPAC), x.shape)], x)
        return np.where(rng.random(x.shape) < 0.005, ord("n"),
                        x).astype(np.uint8)
    refs, reads = spice(refs), spice(reads)
    blens[:6] = 0                          # padding lanes
    rlens[:9] = 1
    return refs, blens, reads, rlens


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def bit_equal(a, b):
    return all(np.asarray(x).shape == np.asarray(y).shape and
               np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("bis,n_rows", [(False, 64), (True, 64),
                                        (False, 50), (True, 50)])
def test_align_matches_jax_and_pallas(bis, n_rows):
    refs, bl, reads, rl = raw_lanes(21 + bis + n_rows, 256, 64, 48, 17, 41)
    port = [x.numpy() for x in sw.sw_align_device(
        *_t(refs, bl, reads, rl), bisulfite=bis, n_rows=n_rows)]
    ref = jsw.sw_align_device(*_j(refs, bl, reads, rl), bisulfite=bis,
                              n_rows=n_rows)
    assert bit_equal(port, ref)
    if n_rows == refs.shape[1]:     # the Pallas kernel takes n_rows >= N
        pal = sw_align_pallas(*_j(refs, bl, reads, rl), bisulfite=bis,
                              n_rows=n_rows, interpret=True)
        assert bit_equal(port, pal)
    assert len(np.unique(port[2])) > 10 and (port[0] > 0).any()


@pytest.mark.parametrize("bis", [False, True])
def test_traceback_matches_jax(bis):
    refs, bl, reads, rl = raw_lanes(31 + bis, 192, 64, 48, 17, 41)
    n_rows = 60
    _, bk, bi = jsw.sw_align_device(*_j(refs, bl, reads, rl),
                                    bisulfite=bis, n_rows=n_rows)
    bk, bi = np.asarray(bk), np.asarray(bi)
    port = [x.numpy() for x in sw.sw_traceback_device(
        *_t(refs, bl, reads, rl, bk, bi), bisulfite=bis, n_rows=n_rows)]
    ref = jsw.sw_traceback_device(*_j(refs, bl, reads, rl, bk, bi),
                                  bisulfite=bis, n_rows=n_rows)
    assert bit_equal(port, ref)
    assert (port[2] >= 0).any() and (port[1] == sw.EV_DEL).any()


def test_wrapper_takes_plain_path_on_cpu():
    refs, bl, reads, rl = raw_lanes(41, 64, 64, 48, 17, 41)
    before = dict(sw_cuda.LAUNCHES)
    a = sw_cuda.sw_align(*_t(refs, bl, reads, rl), n_rows=64)
    b = sw.sw_align_device(*_t(refs, bl, reads, rl), n_rows=64)
    assert bit_equal(a, b)
    assert sw_cuda.LAUNCHES == before           # no kernel launched


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["mixed", "edges-100bp", "edges-250bp"])
@pytest.mark.parametrize("bis", [False, True])
def test_k3_matches_plain_on_card(cuda_device, bis, mix):
    """K3 with each group size that takes the width (0: the main path's)
    against the plain version: on the raw mix (2048 lanes x 160 x 112)
    and on chip_smoke.k3_edge_lanes at 100 bp (M 112, N 160) and 250 bp
    (M 256, N 288) widths with B = 1001; each also on two B = 1 slices,
    with all rows, n_rows < N and n_rows 0."""
    lib = sw_cuda.load_kernels()
    if mix == "mixed":
        M, N = 112, 160
        lanes = raw_lanes(51 + bis, 2048, N, M, 80, 101)
    else:
        M, N = {"edges-100bp": (112, 160), "edges-250bp": (256, 288)}[mix]
        cols = [c for c in (lib.sw_lane_cols(M, g) for g in (8, 16, 32))
                if c]
        lanes = chip_smoke.k3_edge_lanes(np.random.default_rng(53 + bis),
                                         1001, N, M, cols)
    args = [x.to(cuda_device) for x in _t(*lanes)]
    for sub in (args, [x[-1:] for x in args], [x[1:2] for x in args]):
        for n_rows in (N, N - 39, 0):
            p = sw.sw_align_device(*sub, bisulfite=bis, n_rows=n_rows)
            for group in (0, 8, 16, 32):
                if not lib.sw_lane_cols(M, group):
                    continue
                k = sw_cuda.sw_align(*sub, bisulfite=bis, n_rows=n_rows,
                                     group=group)
                torch.cuda.synchronize()
                assert all(torch.equal(x, y) for x, y in zip(p, k)), \
                    (group, n_rows, len(sub[0]))
