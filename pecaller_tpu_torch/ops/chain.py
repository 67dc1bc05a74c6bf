"""Chaining votes and candidate selection of the v2 step's seed stage
(``FusedStep2.chain_dedup_select``): the CUDA kernels of
``csrc/chain.cu`` and their plain PyTorch versions, in two halves that
meet the genome mesh's collectives between them (the ``pmax`` of the
chain maxima, then the ``psum`` of the kept counts).

The JAX package has no Pallas kernel here: its ``chain_dedup_select``
(``pecaller_tpu/mapper/device_map2.py:485``) is XLA code, and so is the
plain version below, which builds (U, 2, S-dd, 16, 16) difference
tensors for the votes, (U, F, 64) comparison chunks for the dedup and
(U, F, 16) selection tensors: gigabytes of broadcast temporaries a
batch for a few thousand live anchors.  The kernels keep a unit's
anchors in shared memory and touch only the valid ones; see the source.

A CPU tensor takes the plain version, a CUDA tensor the kernel (or the
wrapper raises: no fallback).  Each launch is counted in
``sw_cuda.LAUNCHES`` under the kernel's name.

Layout: ``pos`` (U, 2, S, SEG_CAP) int32 candidate positions of each
unit, orientation and probe, ``POS_PAD`` where none; flattened a unit
in (orientation, probe, slot) order, the "F order" of the dedup and the
selection.  ``offsets`` (U, S) are the probes' read offsets.
"""

from __future__ import annotations

import torch

from . import sw_cuda
from .encode import IDEPTH

POS_PAD = 2 ** 30
HIT_CAP = 16            # candidates kept a unit
MAX_OFF = max(2, IDEPTH - 4)   # diagonal slack of a chain vote
WIPE_SPOTS = 200        # min_spots wipe: an orientation whose rarest probe
#                         has more candidates than this keeps none
KERNEL_SEG_CAP = 16     # the kernels take 16 candidates a probe ...
KERNEL_MAX_S = 20       # ... and at most 20 probes (F <= 640)
I32 = torch.int32
I64 = torch.int64


def chain_votes_plain(pos, offsets, n_segs):
    """Co-linear chaining votes (pemapper.c:2188-2250 semantics): an
    anchor counts 1, plus one for each later probe li+dd <= n_segs-1 of
    its orientation holding a valid anchor whose diagonal lies within
    MAX_OFF of its own; invalid anchors 0.  -> T (U, 2, S, SEG_CAP)
    int32 and its maximum a probe, Tmax (U, 2, S)."""
    S = pos.shape[2]
    ar = torch.arange(S, device=pos.device)
    diag = pos - offsets[:, None, :, None]
    anchor_valid = pos < POS_PAD
    T = torch.ones(pos.shape, dtype=I32, device=pos.device)
    seg_in_read = ar[None, :] <= (n_segs - 1)[:, None]
    for dd in range(1, S):
        a = diag[:, :, :S - dd, :]
        bseg = diag[:, :, dd:, :]
        near = (a[..., :, None] - bseg[..., None, :]).abs() < MAX_OFF
        near = near & anchor_valid[:, :, dd:][..., None, :]
        found = near.any(-1) & seg_in_read[:, None, dd:, None]
        T[:, :, :S - dd, :] += found.to(I32)
    T = torch.where(anchor_valid, T, 0)
    return T, T.amax(-1)


def chain_select_plain(pos, T, Tmax, seg_tot, offsets, n_segs, min_match0,
                       skip, shard=None):
    """The min_spots wipe and min_match ratchet (pemapper.c:2251-2254),
    the accepted anchors, first-occurrence diagonal dedup in F order and
    the selection of the first HIT_CAP kept (pemapper.c:2255-2289).

    ``Tmax``: the chain maxima (the genome mesh's pmax of them);
    ``seg_tot`` (U, 2, S): candidates a probe (the mesh's global count);
    ``shard``: a genome shard's (own_lo, own_hi), whose diagonals alone
    it keeps.  -> hits, hits_off (U, HIT_CAP) int32, orient (U, HIT_CAP)
    int8, tot (U,) int32 and the unclamped kept count n_keep (U,)
    int64."""
    U, _, S, seg_cap = pos.shape
    F, CAP = 2 * S * seg_cap, HIT_CAP
    dev = pos.device
    ar = torch.arange(S, device=dev)
    seg_valid = ar[None, :] < n_segs[:, None]
    diag = pos - offsets[:, None, :, None]
    anchor_valid = pos < POS_PAD

    max_depth = n_segs - 1
    min_spots = torch.where(seg_valid[:, None, :], seg_tot,
                            1 << 30).amin(-1)                 # (U, 2)
    wipe = min_spots > WIPE_SPOTS
    cur = min_match0.to(I32)
    processed = torch.zeros(pos.shape[:3], dtype=torch.bool, device=dev)
    for o in range(2):
        o_ok = ~wipe[:, o] & (skip == 0)
        for li in range(S):
            active = o_ok & (li <= 1 + max_depth - cur)
            processed[:, o, li] = active
            cur = torch.maximum(cur, torch.where(active, Tmax[:, o, li], 0))
    accepted = (processed[..., None] & (T == cur[:, None, None, None])
                & anchor_valid)
    accepted = accepted & ~wipe[:, 1][:, None, None, None]
    if shard is not None:
        # shard 0's own_lo is -2^30: the reference's genome-start
        # clamp (diag < 0 -> spot 0) stays owned there
        accepted = accepted & (diag >= shard[0]) & (diag < shard[1])

    # per-unit first-occurrence diagonal dedup, chunked over q
    arF = torch.arange(F, device=dev)
    acc = accepted.reshape(U, F)
    dg = diag.reshape(U, F)
    posf = pos.reshape(U, F)
    QC = 64
    dup_parts = []
    for q0 in range(0, F, QC):
        q1 = min(q0 + QC, F)
        tri = arF[:, None] < arF[None, :q1 - q0] + q0
        dup_parts.append(((dg[:, :, None] == dg[:, None, q0:q1])
                          & acc[:, :, None] & tri[None]).any(dim=1))
    keep = acc & ~torch.cat(dup_parts, dim=1)
    n_keep = keep.sum(dim=1)

    rank = torch.cumsum(keep.to(I64), 1) - 1
    sel = keep[:, :, None] & (rank[:, :, None] ==
                              torch.arange(CAP, device=dev)[None, None, :])
    orient_f = torch.div(arF, S * seg_cap,
                         rounding_mode="floor")[None, :, None]
    off_f = offsets.repeat_interleave(seg_cap, dim=1).repeat(1, 2)
    hits = torch.where(sel, posf[:, :, None], 0).sum(1).to(I32)
    hits_off = torch.where(sel, off_f[:, :, None], 0).sum(1).to(I32)
    orient = torch.where(sel, orient_f, 0).sum(1).to(torch.int8)
    tot = n_keep.clamp(max=CAP).to(I32)
    return hits, hits_off, orient, tot, n_keep


def _kernel_args(pos, offsets, n_segs):
    """Checks of the kernels' common inputs -> (lib, U, S, and pos,
    offsets and n_segs contiguous, the last two as int32; the quartered
    and octile probes' pos is a slice of their sorted candidates)."""
    if pos.dim() != 4 or pos.shape[1] != 2:
        raise ValueError(f"pos must be (U, 2, S, SEG_CAP), got "
                         f"{tuple(pos.shape)}")
    U, _, S, seg_cap = pos.shape
    if seg_cap != KERNEL_SEG_CAP or not 1 <= S <= KERNEL_MAX_S:
        raise ValueError(f"the chain kernels take {KERNEL_SEG_CAP} "
                         f"candidates a probe and 1..{KERNEL_MAX_S} "
                         f"probes, got {seg_cap} and {S}")
    dev = pos.device
    pos = pos.contiguous()
    offsets = offsets.to(I32).contiguous()
    n_segs = n_segs.to(I32).contiguous()
    sw_cuda._check("pos", pos, I32, pos.shape, dev)
    sw_cuda._check("offsets", offsets, I32, (U, S), dev)
    sw_cuda._check("n_segs", n_segs, I32, (U,), dev)
    return sw_cuda.load_kernels(), U, S, pos, offsets, n_segs


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    sw_cuda.LAUNCHES[name] += 1


def chain_votes(pos, offsets, n_segs):
    """``chain_votes_plain`` on the CPU, the kernel on a card."""
    if pos.device.type == "cpu":
        return chain_votes_plain(pos, offsets, n_segs)
    lib, U, S, pos, offsets, n_segs = _kernel_args(pos, offsets, n_segs)
    dev = pos.device
    T = torch.empty(pos.shape, dtype=I32, device=dev)
    Tmax = torch.empty((U, 2, S), dtype=I32, device=dev)
    p = sw_cuda._p
    with torch.cuda.device(dev):
        rc = lib.chain_votes_launch(p(pos), p(offsets), p(n_segs), p(T),
                                    p(Tmax), U, S, sw_cuda._stream(dev))
    _launched("chain_votes", rc)
    return T, Tmax


def chain_select(pos, T, Tmax, seg_tot, offsets, n_segs, min_match0, skip,
                 shard=None):
    """``chain_select_plain`` on the CPU, the kernel on a card."""
    if pos.device.type == "cpu":
        return chain_select_plain(pos, T, Tmax, seg_tot, offsets, n_segs,
                                  min_match0, skip, shard=shard)
    lib, U, S, pos, offsets, n_segs = _kernel_args(pos, offsets, n_segs)
    dev = pos.device
    Tmax = Tmax.to(I32).contiguous()
    seg_tot = seg_tot.to(I64).contiguous()
    min_match0 = min_match0.to(I32).contiguous()
    skip = skip.to(I32).contiguous()
    sw_cuda._check("T", T, I32, pos.shape, dev)
    sw_cuda._check("Tmax", Tmax, I32, (U, 2, S), dev)
    sw_cuda._check("seg_tot", seg_tot, I64, (U, 2, S), dev)
    sw_cuda._check("min_match0", min_match0, I32, (U,), dev)
    sw_cuda._check("skip", skip, I32, (U,), dev)
    if shard is not None:
        own = [b.to(I64).reshape(1) for b in shard]
        for name, b in zip(("own_lo", "own_hi"), own):
            sw_cuda._check(name, b, I64, (1,), dev)
    hits = torch.empty((U, HIT_CAP), dtype=I32, device=dev)
    hits_off = torch.empty((U, HIT_CAP), dtype=I32, device=dev)
    orient = torch.empty((U, HIT_CAP), dtype=torch.int8, device=dev)
    tot = torch.empty(U, dtype=I32, device=dev)
    n_keep = torch.empty(U, dtype=I64, device=dev)
    p = sw_cuda._p
    lo, hi = ((p(own[0]), p(own[1])) if shard is not None
              else (None, None))
    with torch.cuda.device(dev):
        rc = lib.chain_select_launch(
            p(pos), p(T), p(Tmax), p(seg_tot), p(offsets), p(n_segs),
            p(min_match0), p(skip), lo, hi, p(hits), p(hits_off),
            p(orient), p(tot), p(n_keep), U, S, sw_cuda._stream(dev))
    _launched("chain_select", rc)
    return hits, hits_off, orient, tot, n_keep
