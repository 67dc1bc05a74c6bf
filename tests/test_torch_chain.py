"""The seed stage's chain kernels (csrc/chain.cu through ops/chain.py)
against their plain PyTorch versions, on adversarial units.

On the CPU the wrappers take the plain versions and launch nothing; on
the card (``-m cuda``) the kernels are held to the plain versions run on
the same card.  The plain versions are the step's own code, held to the
JAX package by tests/test_torch_step_parts.py::test_seed_matches_jax
and the step and engine tests.

Tolerance: bitwise (integer arithmetic throughout)."""

import numpy as np
import pytest
import torch

from pecaller_tpu_torch.ops import chain, sw_cuda
from torch_util import cuda_device  # noqa: F401  (fixture)

SEG_CAP = chain.KERNEL_SEG_CAP
PAD = chain.POS_PAD
KINDS = 8


def chain_inputs(rng, U, S):
    """Units of eight kinds (u % 8): padding; a sparse true chain with
    noise; dense probes (all 16 slots valid) on few diagonals, so ties
    in T and equal diagonals; 16 distinct chains an orientation, so more
    than HIT_CAP kept; the min_spots wipe of one or both orientations;
    skip; valid slots scattered among the pads with diagonals below 0;
    one diagonal repeated in every probe of both orientations.  n_segs
    runs over 0..S (mostly below S) and min_match0 over 1..4."""
    pos = np.full((U, 2, S, SEG_CAP), PAD, np.int64)
    offs = np.zeros((U, S), np.int64)
    n_segs = rng.integers(1, S + 1, U)
    n_segs[rng.random(U) < 0.03] = 0
    skip = np.zeros(U, np.int64)
    mm0 = np.minimum(np.maximum(1, n_segs - 1), 4)
    redraw = rng.random(U) < 0.3
    mm0[redraw] = rng.integers(1, 5, redraw.sum())
    extra = np.zeros((U, 2, S), np.int64)
    ar = np.arange(S)
    for u in range(U):
        ns, kind = int(n_segs[u]), u % KINDS
        if kind == 0:                                  # a padding unit
            n_segs[u], mm0[u] = 1, 1
            continue
        last = max(ns - 1, 0)
        offs[u, :last] = ar[:last] * 16
        offs[u, last] = max(16 * last - int(rng.integers(0, 16)), 0)
        offs[u, ar > last] = 0
        g = int(rng.integers(0, 4000))
        if kind in (1, 4, 5):                          # sparse chain
            o = int(rng.integers(0, 2))
            for li in range(S):
                if rng.random() < 0.85:
                    k = int(rng.integers(0, SEG_CAP))
                    pos[u, o, li, k] = (g + offs[u, li]
                                        + int(rng.integers(-13, 14))
                                        * (rng.random() < 0.3))
            noise = rng.random((2, S, SEG_CAP)) < 0.08
            pos[u][noise] = rng.integers(0, 5000, noise.sum())
            if kind == 4:
                extra[u, int(rng.integers(0, 2))] = 201
                if rng.random() < 0.3:
                    extra[u] = 250
            if kind == 5:
                skip[u] = 1
        elif kind == 2:                                # dense, few diagonals
            d = g + 13 * rng.integers(0, 6, (2, S, SEG_CAP))
            pos[u] = d + offs[u][None, :, None]
        elif kind == 3:                                # > HIT_CAP chains
            d = g + 40 * np.arange(SEG_CAP)
            pos[u, 0] = d[None, :] + offs[u][:, None]
            pos[u, 1] = d[None, :] + 7 * (np.arange(SEG_CAP) % 2) \
                + offs[u][:, None]
        elif kind == 6:                                # scattered, diag < 0
            v = rng.random((2, S, SEG_CAP)) < 0.25
            pos[u][v] = rng.integers(0, 60, v.sum())
        else:                                          # one diagonal
            k = rng.integers(0, SEG_CAP, (2, S, 3))
            for o in range(2):
                for li in range(S):
                    pos[u, o, li, k[o, li]] = g + offs[u, li]
    valid = pos < PAD
    seg_tot = valid.sum(-1) + extra + rng.integers(0, 3, (U, 2, S)) * (
        rng.random((U, 2, S)) < 0.2)
    return dict(pos=pos.astype(np.int32), offsets=offs.astype(np.int32),
                n_segs=n_segs.astype(np.int32), mm0=mm0.astype(np.int32),
                skip=skip.astype(np.int32), seg_tot=seg_tot.astype(np.int64))


SHARDS = {"none": None, "shard0": (-2 ** 30, 1500), "mid": (800, 2600)}


def _run(fns, x, shard, raise_tmax=None):
    """votes, then (the mesh's pmax stood in by raise_tmax) selection."""
    votes, select = fns
    T, Tmax = votes(x["pos"], x["offsets"], x["n_segs"])
    if raise_tmax is not None:
        Tmax = Tmax + raise_tmax
    sh = None if shard is None else tuple(
        torch.tensor(b, dtype=torch.int64, device=x["pos"].device)
        for b in shard)
    return (T, Tmax), select(x["pos"], T, Tmax, x["seg_tot"], x["offsets"],
                             x["n_segs"], x["mm0"], x["skip"], shard=sh)


def _tensors(x, device):
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def _raise(rng, U, S, device):
    bump = rng.integers(0, 3, (U, 2, S)) * (rng.random((U, 2, S)) < 0.2)
    return torch.from_numpy(bump.astype(np.int32)).to(device)


PLAIN = (chain.chain_votes_plain, chain.chain_select_plain)
WRAPPED = (chain.chain_votes, chain.chain_select)


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a, b))


@pytest.mark.parametrize("S", [6, 8, 12, 20])
def test_wrappers_take_plain_path_on_cpu(S):
    """On CPU tensors the wrappers are the plain versions and count no
    launch; the inputs reach every branch the kernels must match."""
    rng = np.random.default_rng(100 + S)
    x = _tensors(chain_inputs(rng, 96, S), "cpu")
    before = dict(sw_cuda.LAUNCHES)
    for shard in SHARDS.values():
        votes_p, sel_p = _run(PLAIN, x, shard)
        votes_w, sel_w = _run(WRAPPED, x, shard)
        assert _equal(votes_p, votes_w) and _equal(sel_p, sel_w)
    assert sw_cuda.LAUNCHES == before           # no kernel launched
    (T, Tmax), (hits, hits_off, orient, tot, n_keep) = _run(PLAIN, x, None)
    assert (n_keep > chain.HIT_CAP).any() and (n_keep == 0).any()
    assert (tot > 0).sum() > len(tot) // 3
    assert (T[2::KINDS] == T[2::KINDS].amax((1, 2, 3))[:, None, None, None]
            ).sum() > 16                         # ties in dense units
    assert (orient == 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("S", [6, 8, 12, 20])
def test_kernels_match_plain_on_card(cuda_device, S, shard):
    """Both kernels against the plain versions on the card, bitwise: on
    all units (1,027, a partial last block), on one unit, with Tmax
    raised as the genome mesh's pmax may raise it, and with pos a slice
    of wider rows (as the quartered and octile probes pass it); one
    launch each a call."""
    rng = np.random.default_rng(200 + S)
    x = _tensors(chain_inputs(rng, 1027, S), cuda_device)
    bump = _raise(rng, 1027, S, cuda_device)
    wide = torch.cat([x["pos"], torch.full_like(x["pos"][..., :8], PAD)],
                     dim=-1)
    for sub, tm in ((x, None), (x, bump),
                    ({k: v[-1:] for k, v in x.items()}, None),
                    (dict(x, pos=wide[..., :SEG_CAP]), None)):
        before = dict(sw_cuda.LAUNCHES)
        got = _run(WRAPPED, sub, SHARDS[shard],
                   None if tm is None else tm[:len(sub["pos"])])
        torch.cuda.synchronize(cuda_device)
        assert sw_cuda.LAUNCHES["chain_votes"] == before["chain_votes"] + 1
        assert sw_cuda.LAUNCHES["chain_select"] == before["chain_select"] + 1
        want = _run(PLAIN, sub, SHARDS[shard],
                    None if tm is None else tm[:len(sub["pos"])])
        assert _equal(got[0], want[0])
        assert _equal(got[1], want[1])


def _wrap32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def kernel_model(x, shard, raise_tmax=None):
    """The kernels' algorithm a unit at a time, in Python (numpy
    arrays in, as chain.cu reads them): the valid-anchor list and probe
    masks, the votes over later probes' valid slots, the ratchet over
    (o, li), the compacted accepted list, the dedup against earlier
    accepted anchors and the rank-ordered writes."""
    pos, offs, n_segs = x["pos"], x["offsets"], x["n_segs"]
    U, _, S, _ = pos.shape
    P, F, CAP = 2 * S, 2 * S * SEG_CAP, chain.HIT_CAP
    T = np.zeros((U, F), np.int32)
    Tmax = np.zeros((U, P), np.int32)
    out = [np.zeros((U, CAP), np.int32), np.zeros((U, CAP), np.int32),
           np.zeros((U, CAP), np.int8), np.zeros(U, np.int32),
           np.zeros(U, np.int64)]
    for u in range(U):
        pu = pos[u].reshape(F)
        dg = [_wrap32(int(pu[f]) - int(offs[u, (f >> 4) % S]))
              for f in range(F)]
        valid = [f for f in range(F) if pu[f] < PAD]
        mask = [[j for j in range(SEG_CAP) if pu[p * SEG_CAP + j] < PAD]
                for p in range(P)]
        last = min(S - 1, _wrap32(int(n_segs[u]) - 1))
        for f in valid:
            p = f >> 4
            o, li = divmod(p, S)
            votes = 1
            for l2 in range(li + 1, last + 1):
                q = o * S + l2
                if any(_wrap32(abs(_wrap32(dg[f] - dg[q * SEG_CAP + j])))
                       < chain.MAX_OFF for j in mask[q]):
                    votes += 1
            T[u, f] = votes
        Tmax[u] = T[u].reshape(P, SEG_CAP).max(1)
        tm = Tmax[u] + (0 if raise_tmax is None else raise_tmax[u].reshape(P))
        ms = [1 << 30, 1 << 30]
        for p in range(P):
            o, li = divmod(p, S)
            if li < n_segs[u]:
                ms[o] = min(ms[o], int(x["seg_tot"][u].reshape(P)[p]))
        wipe = [m > chain.WIPE_SPOTS for m in ms]
        bound1 = _wrap32(1 + _wrap32(int(n_segs[u]) - 1))
        cur, proc = int(x["mm0"][u]), set()
        for p in range(P):
            o, li = divmod(p, S)
            active = (x["skip"][u] == 0 and not wipe[o]
                      and li <= _wrap32(bound1 - cur))
            if active:
                proc.add(p)
            cur = max(cur, int(tm[p]) if active else 0)
        acc = [f for f in range(F)
               if (f >> 4) in proc and T[u, f] == cur and pu[f] < PAD
               and not wipe[1]
               and (shard is None or shard[0] <= dg[f] < shard[1])]
        nk = 0
        for i, f in enumerate(acc):
            if any(dg[acc[j]] == dg[f] for j in range(i)):
                continue
            if nk < CAP:
                o, li = divmod(f >> 4, S)
                out[0][u, nk] = _wrap32(dg[f] + int(offs[u, li]))
                out[1][u, nk] = offs[u, li]
                out[2][u, nk] = o
            nk += 1
        out[3][u], out[4][u] = min(nk, CAP), nk
    return (T.reshape(pos.shape), Tmax.reshape(U, 2, S)), out


@pytest.mark.parametrize("S", [6, 20])
def test_kernel_model_matches_plain(S):
    """The kernels' algorithm (kernel_model) against the plain versions
    on the CPU, each shard mode and a raised Tmax: a rehearsal of the
    card test without the card."""
    rng = np.random.default_rng(300 + S)
    x = chain_inputs(rng, 64, S)
    bump = _raise(rng, 64, S, "cpu")
    xt = _tensors(x, "cpu")
    for name, shard in SHARDS.items():
        for tm in (None, bump):
            (T, Tmax), sel = kernel_model(
                x, shard, None if tm is None else tm.numpy())
            want = _run(PLAIN, xt, shard, tm)
            assert np.array_equal(T, want[0][0].numpy())
            assert np.array_equal(Tmax, want[0][1].numpy() - (
                0 if tm is None else tm.numpy()))
            for a, b in zip(sel, want[1]):
                assert a.dtype == b.numpy().dtype
                assert np.array_equal(a, b.numpy()), name
