"""Seed extraction and chaining of the fused v1 engine, PyTorch.

Counterpart of ``pecaller_tpu/mapper/device_seeds.py``: the same
integer program on tensors of an explicit device.

  1. one gather per neighborhood key into a 2-bit-per-key presence table
     over the 4^16 key space (bit0 = key present, bit1 = abundant, the
     too_many_spots >= 100 gate, pemapper.c:1599-1615);
  2. a two-level rank table (high-22-bit prefix counts + a short
     fixed-step lower_bound);
  3. fixed-cap padded gathers (8 positions/key, 64/segment, 16 hits/read)
     with per-read overflow flags that route repetitive reads to the
     exact host engine;
  4. co-linear chaining, the reference's min_match ratchet and min_spots
     wipe (pemapper.c:2188-2289), and diagonal dedup in enumeration
     order.

Unsigned 32-bit keys are carried as int64 values in [0, 2^32); the
index arrays stay int32 on the device (keys as their uint32 bit
patterns, widened on gather).  Every gather index is clamped as the JAX
program's gathers clamp; a dropped scatter goes to a dump row.  Where
the reference scatters several values to one cell (only past a cap,
where the batch or read falls back), the last one in flat order wins.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.index_files import SeedIndex
from ..ops.encode import BASE_BITS, IDEPTH, _RC
from .device_map2 import MASK32, _as_i32, _u32, fetch_async, fetched
from .program import StepProgram

S_MAX = 20              # max segments (reads <= 299bp)
KEY_CAP = 8             # positions gathered per neighborhood key
SEG_CAP = 64            # positions kept per segment
HIT_CAP = 16            # candidate loci per read (fast path)
TOO_MANY = 100
HI_BITS = 22
POS_PAD = 2 ** 30       # padding sentinel (> any position)
I32 = torch.int32
I64 = torch.int64


class DeviceSeedIndex:
    """Device-resident companion structures of a SeedIndex: the 2^28-word
    presence table ``ptab`` (1 GiB), the sorted keys, their CSR starts,
    the high-22-bit rank table and the positions."""

    def __init__(self, index: SeedIndex, device):
        keys = np.asarray(index.keys, dtype=np.int64)
        starts = np.asarray(index.starts, dtype=np.int64)
        counts = np.diff(starts)
        # 2 bits per key in uint32 words: bit0 present, bit1 abundant
        ptab = np.zeros(1 << 28, dtype=np.uint32)
        w = (keys >> 4).astype(np.int64)
        sh = ((keys & 15) << 1).astype(np.uint32)
        np.bitwise_or.at(ptab, w, np.uint32(1) << sh)
        ab = counts >= TOO_MANY
        if ab.any():
            np.bitwise_or.at(ptab, w[ab],
                             np.uint32(2) << sh[ab].astype(np.uint32))
        hi = (keys >> (32 - HI_BITS)).astype(np.int64)
        hi_table = np.searchsorted(hi, np.arange((1 << HI_BITS) + 1))
        self._set(ptab, keys, starts, hi_table,
                  np.asarray(index.positions, dtype=np.int64), device)

    @classmethod
    def from_arrays(cls, ptab, keys, starts, hi_table, positions, device):
        """The structures from their arrays (e.g. those the JAX package's
        DeviceSeedIndex holds), without rebuilding them."""
        self = cls.__new__(cls)
        self._set(np.asarray(ptab), np.asarray(keys), np.asarray(starts),
                  np.asarray(hi_table), np.asarray(positions), device)
        return self

    def _set(self, ptab, keys, starts, hi_table, positions, device):
        self.device = torch.device(device)
        self.n_keys = len(keys)
        self.density = len(keys) / float(2 ** 32)
        self.max_subrange = (int(np.diff(hi_table).max()) if len(keys)
                             else 1)
        # int32 tensors of the arrays' low 32 bits (keys: uint32 patterns)
        self.ptab = _as_i32(ptab).to(self.device)
        self.keys = _as_i32(keys.astype(np.uint32)).to(self.device)
        self.starts = _as_i32(starts).to(self.device)
        self.hi_table = _as_i32(hi_table).to(self.device)
        self.positions = _as_i32(positions).to(self.device)

    def compact_cap(self, nflat: int) -> int:
        """Static capacity for batch-compacted present keys: the exact
        keys (1/49 of probes, nearly always present) plus 3x expected
        present 1-mismatch variants (~key-space density each)."""
        frac = 1.0 / 49.0 + 3.0 * (48.0 / 49.0) * self.density
        k = int(nflat * min(1.0, frac)) + 4096
        return (k + 1023) // 1024 * 1024


def host_bits_rev(seqs: np.ndarray, lens: np.ndarray,
                  bisulfite: bool = False):
    """Host-side prep of the seed step: reverse-complement chars and
    2-bit codes for both orientations."""
    B, M = seqs.shape
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(M)[None, :]
    rev = np.where(idx >= 0, _RC[seqs[
        np.arange(B)[:, None], np.clip(idx, 0, M - 1)]], 0).astype(np.uint8)
    conv_f, conv_r = seqs, rev
    if bisulfite:
        # uppercase-only C->T, matching convert_ct (pemapper.c:2292-2300)
        conv_f = np.where(seqs == ord("C"), np.uint8(ord("T")), seqs)
        conv_r = np.where(rev == ord("C"), np.uint8(ord("T")), rev)
    bits_f = BASE_BITS[conv_f].astype(np.uint8)
    bits_r = BASE_BITS[conv_r].astype(np.uint8)
    return rev, bits_f, bits_r


def _probe_pair(ptab, keys):
    """keys (...,) uint32 values -> (present, abundant) via one gather."""
    w = _u32(ptab[keys >> 4])
    pair = (w >> ((keys & 15) << 1)) & 3
    return (pair & 1) == 1, pair >= 2


def _rank_lookup(keys, starts, hi_table, n_keys, nbi, n_steps: int):
    """uint32 keys -> (start, count); absent keys get count 0."""
    kmax = max(n_keys - 1, 0)
    hi = nbi >> (32 - HI_BITS)
    lo = hi_table[hi].to(I64)
    hi_end = hi_table[hi + 1].to(I64)
    for _ in range(n_steps):
        cont = lo < hi_end
        mid = (lo + hi_end) >> 1
        pred = _u32(keys[mid.clamp(0, kmax)]) < nbi
        lo = torch.where(cont & pred, mid + 1, lo)
        hi_end = torch.where(cont & ~pred, mid, hi_end)
    idx = lo.clamp(0, kmax)
    present = _u32(keys[idx]) == nbi
    s0 = starts[idx]
    start = torch.where(present, s0, 0)
    cnt = torch.where(present, starts[idx + 1] - s0, 0)
    return start, cnt


def _rolling_keys(bits, offsets):
    """bits (B, M) uint8 2-bit codes; offsets (B, S) -> (B, S) uint32
    values of the 16-mer keys at the segment offsets."""
    B, M = bits.shape
    L = max(M - IDEPTH + 1, 1)
    key_all = torch.zeros((B, L), dtype=I64, device=bits.device)
    for j in range(IDEPTH):
        key_all = ((key_all << 2) + bits[:, j:j + L].to(I64)) & MASK32
    return torch.gather(key_all, 1, offsets.to(I64).clamp(0, L - 1))


def _neighborhood_dev(keys):
    """(B, 2, S) uint32 values -> (B, 2, S, 49) keys in fill_mers order
    (pemapper.c:546-565): the exact key, then per 2-bit field low->high
    the 3 substitutions in ascending code order."""
    outs = [keys[..., None]]
    for f in range(IDEPTH):
        cur = (keys >> (2 * f)) & 3
        base = keys - (cur << (2 * f))
        for j in range(3):
            c = j + (j >= cur).to(I64)
            outs.append((base + (c << (2 * f)))[..., None])
    return torch.cat(outs, dim=-1)


def _compact_src(mask, cap):
    """Compaction of the masked flat elements, in order, into ``cap``
    rows, the elements past the cap all written to the last row (the
    last of them wins, as the reference's scatter leaves it): the flat
    index of the element in each row, -1 for an empty row.  A search on
    the running count, not a scatter, so no row is hit by millions of
    colliding writes."""
    csum = torch.cumsum(mask.to(I64), 0)
    n = csum[-1]
    r = torch.arange(cap, dtype=I64, device=mask.device)
    target = torch.where(r == cap - 1, torch.clamp(n, min=cap), r + 1)
    return torch.where(target <= n, torch.searchsorted(csum, target), -1)


def seed_chain_core(ptab, ikeys, istarts, hi_table, positions,
                    bits_f, bits_r, offsets, n_segs, min_match0, skip, *,
                    s_max: int, n_steps: int, n_keys: int, k_cap: int):
    """Seed probe and chaining of one batch end.

    bits_f/bits_r (B, M) uint8, offsets (B, s_max), n_segs, min_match0,
    skip (B,) int32.  Returns (hits (B, 16) int32, hits_off (B, 16)
    int32, orient (B, 16) int8, tot (B,) int32, fallback (B,) bool)."""
    S = s_max
    B = bits_f.shape[0]
    dev = bits_f.device

    def ar(n):
        return torch.arange(n, dtype=I64, device=dev)

    offsets = offsets.to(I32)
    n_segs = n_segs.to(I64)
    kf = _rolling_keys(bits_f, offsets)
    kr = _rolling_keys(bits_r, offsets)
    keys2 = torch.stack([kf, kr], dim=1)            # (B, 2, S)
    nb = _neighborhood_dev(keys2)                   # (B, 2, S, 49)

    present, abundant = _probe_pair(ptab, nb)
    seg_valid = ar(S)[None, :] < n_segs[:, None]
    seg_bad = abundant.any(-1) | ~seg_valid[:, None, :]

    # compact the present keys before the rank lookup and position
    # gather
    active = present & ~seg_bad[..., None]          # (B, 2, S, 49)
    flat_active = active.reshape(-1)
    K = k_cap
    slot = torch.cumsum(flat_active.to(I64), 0) - 1
    compact_over = slot[-1] + 1 > K                 # whole-batch fallback
    src = _compact_src(flat_active, K)
    comp_keys = torch.where(src >= 0, nb.reshape(-1)[src.clamp(min=0)], 0)
    start_s, cnt_s = _rank_lookup(ikeys, istarts, hi_table, n_keys,
                                  comp_keys, n_steps)
    g_s = start_s[:, None].to(I64) + ar(KEY_CAP)
    pmax = max(positions.shape[0] - 1, 0)
    gval_s = ar(KEY_CAP) < cnt_s.clamp(max=KEY_CAP)[:, None]
    pos_s = torch.where(gval_s, positions[g_s.clamp(0, pmax)], POS_PAD)
    slot_c = slot.clamp(0, K - 1)
    cnt = torch.where(flat_active, cnt_s[slot_c], 0).reshape(active.shape)
    seg_tot_true = cnt.sum(-1)                      # (B, 2, S)

    key_over = (cnt > KEY_CAP).any(-1)
    pos = torch.where(flat_active[:, None], pos_s[slot_c], POS_PAD)
    pos = pos.reshape(B, 2, S, 49 * KEY_CAP).to(I32)
    # the SEG_CAP smallest positions, ascending
    pos = torch.topk(pos, SEG_CAP, dim=-1, largest=False, sorted=True).values
    seg_over = (seg_tot_true > SEG_CAP) | key_over

    # --- chaining: support counts per anchor -----------------------
    max_off = max(2, IDEPTH - 4)
    diag = pos - offsets[:, None, :, None]
    anchor_valid = pos < POS_PAD
    T = torch.ones(pos.shape, dtype=I32, device=dev)
    seg_in_read = ar(S)[None, :] <= (n_segs - 1)[:, None]
    for dd in range(1, S):
        a = diag[:, :, :S - dd, :]                  # anchors seg l
        bseg = diag[:, :, dd:, :]                   # partner seg l+dd
        near = (a[..., :, None] - bseg[..., None, :]).abs() < max_off
        near = near & anchor_valid[:, :, dd:][..., None, :]
        found = near.any(-1) & seg_in_read[:, None, dd:, None]
        T[:, :, :S - dd, :] += found.to(I32)
    T = torch.where(anchor_valid, T, 0)

    # --- min_match ratchet over (orient, loop) in order -------------
    max_depth = n_segs - 1
    min_spots = torch.where(seg_valid[:, None, :], seg_tot_true,
                            1 << 30).amin(-1)       # (B, 2)
    wipe = min_spots > 200
    Tmax = T.amax(-1)                               # (B, 2, S)
    cur = min_match0.to(I64)
    processed = torch.zeros((B, 2, S), dtype=torch.bool, device=dev)
    for o in range(2):
        o_ok = ~wipe[:, o] & (skip == 0)
        for li in range(S):
            act = o_ok & (li <= 1 + max_depth - cur)
            processed[:, o, li] = act
            cur = torch.maximum(cur, torch.where(act, Tmax[:, o, li], 0))
    accepted = (processed[..., None] & (T == cur[:, None, None, None])
                & anchor_valid)
    # a reverse-orientation min_spots wipe clears forward survivors too
    # (find_matches zeroes *tot_hits, pemapper.c:2204-2207)
    accepted = accepted & ~wipe[:, 1][:, None, None, None]

    # --- dedup by diagonal, keep enumeration order ------------------
    flat_acc = accepted.reshape(-1)
    per = 2 * S * SEG_CAP
    A_CAP = 4 * B
    a_idx = _compact_src(flat_acc, A_CAP).clamp(min=0)
    n_anch = flat_acc.sum().clamp(max=A_CAP)
    a_valid = ar(A_CAP) < n_anch
    # reads whose anchors spill past A_CAP (rid-major compaction)
    a_over = torch.cumsum(accepted.reshape(B, -1).sum(1), 0) > A_CAP

    a_rid = torch.div(a_idx, per, rounding_mode="floor")
    rem = a_idx % per
    a_or = torch.div(rem, S * SEG_CAP, rounding_mode="floor")
    a_seg = torch.div(rem, SEG_CAP, rounding_mode="floor") % S
    a_diag = diag.reshape(-1)[a_idx]
    a_pos = pos.reshape(-1)[a_idx]
    a_off = offsets[a_rid, a_seg]

    BIGK = 2 ** 30
    # sort by (rid, diag), stable => enumeration order within groups
    p1 = torch.argsort(torch.where(a_valid, a_diag, BIGK), stable=True)
    p2 = torch.argsort(torch.where(a_valid[p1], a_rid[p1], BIGK),
                       stable=True)
    perm = p1[p2]
    s_rid = a_rid[perm]
    s_diag = a_diag[perm]
    s_valid = a_valid[perm]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    firstg = torch.cat([one, (s_rid[1:] != s_rid[:-1])
                        | (s_diag[1:] != s_diag[:-1])])
    keep = firstg & s_valid

    # kept anchors in per-read enumeration order, ranked within read
    k_ord = torch.where(keep, rem[perm], BIGK)
    k_rid = torch.where(keep, s_rid, BIGK)
    q1 = torch.argsort(k_ord, stable=True)
    q2 = torch.argsort(k_rid[q1], stable=True)
    qperm = q1[q2]
    rk = k_rid[qperm]
    permk = perm[qperm]
    idxa = ar(A_CAP)
    newg = torch.cat([one, rk[1:] != rk[:-1]])
    gstart = torch.cummax(torch.where(newg, idxa, 0), 0).values
    rank = idxa - gstart
    in_cap = (rk < BIGK) & (rank < HIT_CAP)
    trg = torch.where(in_cap, rk * HIT_CAP + rank, B * HIT_CAP)

    def place(vals, dtype):
        out = torch.zeros(B * HIT_CAP + 1, dtype=dtype, device=dev)
        out[trg] = vals.to(dtype)                   # row B * CAP: dump
        return out[:-1].reshape(B, HIT_CAP)

    hits = place(a_pos[permk], I32)
    hits_off = place(a_off[permk], I32)
    orient = place(a_or[permk], torch.int8)
    n_keep = torch.zeros(B + 1, dtype=I64, device=dev)
    n_keep.index_add_(0, torch.where(keep, s_rid, B),
                      torch.ones_like(s_rid))
    n_keep = n_keep[:B]
    tot = n_keep.clamp(max=HIT_CAP).to(I32)
    fallback = ((seg_over.any(2).any(1) | (n_keep > HIT_CAP) |
                 compact_over | a_over) & (skip == 0))
    return hits, hits_off, orient, tot, fallback


def build_seed_chain_fn(dindex: DeviceSeedIndex, bisulfite: bool = False,
                        s_max: int = 8, graph: bool = True, pool=None):
    """The seed step of one batch end on ``dindex``'s device, for the
    split engine.  ``s_max``: static segment-count bucket (8 covers
    reads <= 127 bp).  Returns seed_chain(seqs, lens, offsets, n_segs,
    min_match0, skip) -> (hits, hits_off, orient, tot, fallback) numpy
    arrays, with ``.dispatch`` (host prep, then the step and the start
    of one copy back) and ``.fetch`` (wait for that copy and split it)
    as its two halves.

    The step of each batch size runs as one ``StepProgram`` (the
    counterpart of the reference's ``@jax.jit seed_chain_impl``): on a
    card a CUDA graph captured at the size's second call (``graph``;
    ``pool``: the graph pool it shares).  A replay overwrites the last
    call's output, so ``dispatch`` starts its copy to the host at once
    and a caller may dispatch several ends before the first fetch.
    ``seed_chain.programs`` maps each batch size to its program."""
    n_steps = max(1, int(np.ceil(np.log2(max(dindex.max_subrange, 2)))) + 1)
    programs = {}

    def program(B: int) -> StepProgram:
        if B not in programs:
            k_cap = dindex.compact_cap(B * 2 * s_max * 49)

            def step(*t):
                hits, hits_off, orient, tot, fallback = seed_chain_core(
                    dindex.ptab, dindex.keys, dindex.starts,
                    dindex.hi_table, dindex.positions, *t, s_max=s_max,
                    n_steps=n_steps, n_keys=dindex.n_keys, k_cap=k_cap)
                # one int32 matrix: a single copy to the host per call
                return torch.cat([hits, hits_off, orient.to(I32),
                                  tot[:, None], fallback.to(I32)[:, None]],
                                 dim=1)
            programs[B] = StepProgram(step, dindex.device, graph=graph,
                                      pool=pool)
        return programs[B]

    def dispatch(seqs, lens, offsets, n_segs, min_match0, skip):
        _, bits_f, bits_r = host_bits_rev(seqs, lens, bisulfite=bisulfite)
        out = program(bits_f.shape[0])([(bits_f, bits_r, offsets, n_segs,
                                         min_match0, skip)])
        return fetch_async(out[0], dindex.device)

    def fetch(pending):
        packed = fetched(pending)
        h = HIT_CAP
        return (packed[:, :h], packed[:, h:2 * h],
                packed[:, 2 * h:3 * h].astype(np.int8), packed[:, 3 * h],
                packed[:, 3 * h + 1].astype(bool))

    def seed_chain(seqs, lens, offsets, n_segs, min_match0, skip):
        return fetch(dispatch(seqs, lens, offsets, n_segs, min_match0,
                              skip))

    seed_chain.dispatch = dispatch
    seed_chain.fetch = fetch
    seed_chain.programs = programs
    return seed_chain
