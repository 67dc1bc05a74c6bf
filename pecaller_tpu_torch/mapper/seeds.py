"""Seed extraction: segment cuts, 49-key neighborhoods, index gathers.

Produces, for a read batch, the per-(read, orientation, segment) sorted
candidate-position lists consumed by the exact chaining engine.  Mirrors
initial_map/fill_mers (pemapper.c:1539-1690, 1969-2003):

* total_cuts = len//16, minus one when len divisible by 16; segment
  offsets 0,16,...,16*(tc-1) and a final segment re-anchored at len-16;
* each segment expands to 49 keys (exact + 48 single-substitution);
  if ANY key's bucket has >= 100 positions the whole segment is cleared;
* surviving positions are merged and sorted ascending per segment.
"""

from __future__ import annotations

import numpy as np

from ..formats.index_files import SeedIndex
from ..ops.encode import (BASE_BITS, mismatch_neighborhood_keys, revcomp_bytes,
                          IDEPTH)

MAX_SEGS = 20          # len<=299 -> total_cuts<=18 -> <=19 segments
TOO_MANY_SPOTS = 100


def revcomp_batch(seqs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-row reverse complement of an (B, L) ASCII batch."""
    B, L = seqs.shape
    idx = lens[:, None] - 1 - np.arange(L)[None, :]
    valid = idx >= 0
    out = np.zeros_like(seqs)
    from ..ops.encode import _RC
    g = seqs[np.arange(B)[:, None], np.clip(idx, 0, L - 1)]
    out[valid] = _RC[g[valid]]
    return out


def segment_offsets(lens: np.ndarray):
    """(B,) lens -> (n_segs (B,), offsets (B, MAX_SEGS))."""
    tc = lens // IDEPTH - (lens % IDEPTH == 0).astype(np.int64)
    tc = np.maximum(tc, 0)
    n_segs = tc + 1
    offs = np.minimum(np.arange(MAX_SEGS)[None, :] * IDEPTH, 10**9)
    offs = np.broadcast_to(offs, (lens.shape[0], MAX_SEGS)).copy()
    last = np.maximum(lens - IDEPTH, 0)
    offs[np.arange(lens.shape[0]), tc] = last
    offs[np.arange(MAX_SEGS)[None, :] > tc[:, None]] = 0
    return n_segs, offs.astype(np.int32)


def pack_keys(seqs: np.ndarray, offs: np.ndarray, n_segs: np.ndarray):
    """Pack the 16-mer key at each (read, segment) offset.

    seqs are the (possibly bisulfite-converted) oriented reads.
    Returns keys (B, MAX_SEGS) uint32 and a validity mask.
    """
    B, L = seqs.shape
    bits = BASE_BITS[seqs]                       # (B, L) uint32
    gather = offs[:, :, None] + np.arange(IDEPTH)[None, None, :]
    gather = np.clip(gather, 0, L - 1)
    k = np.zeros((B, offs.shape[1]), dtype=np.uint32)
    rows = np.arange(B)[:, None, None]
    sel = bits[rows, gather]                     # (B, S, 16)
    for j in range(IDEPTH):
        k <<= np.uint32(2)
        k += sel[:, :, j].astype(np.uint32)
    seg_valid = np.arange(offs.shape[1])[None, :] < n_segs[:, None]
    return k, seg_valid


def gather_segment_lists(index: SeedIndex, keys: np.ndarray,
                         seg_valid: np.ndarray):
    """Expand keys to 49-neighborhoods, apply the abundance gate, gather
    and sort positions per segment.

    keys: (G, ) flattened (read*orient, seg) keys for valid segments.
    Returns flat sorted positions + per-segment (start, count).
    """
    G = keys.shape[0]
    nb = mismatch_neighborhood_keys(keys)            # (G, 49)
    start, cnt = index.lookup(nb.ravel())
    cnt = cnt.reshape(G, 49)
    start = start.reshape(G, 49)
    bad = (cnt >= TOO_MANY_SPOTS).any(axis=1) | ~seg_valid
    cnt[bad] = 0
    seg_tot = cnt.sum(axis=1)
    # flat gather: for each (segment, key) run of cnt positions
    flat_cnt = cnt.ravel()
    nz = flat_cnt > 0
    runs_start = start.ravel()[nz]
    runs_len = flat_cnt[nz]
    seg_of_run = np.repeat(np.arange(G), 49)[nz]
    total = int(runs_len.sum())
    if total == 0:
        return (np.zeros(0, np.uint32), np.zeros(G, np.int64),
                np.zeros(G, np.int32))
    run_ids = np.repeat(np.arange(len(runs_len)), runs_len)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(runs_len)[:-1]]), runs_len)
    pos = np.asarray(index.positions)[runs_start[run_ids] + within]
    seg_ids = seg_of_run[run_ids]
    order = np.lexsort((pos, seg_ids))
    pos_sorted = pos[order].astype(np.uint32)
    seg_sorted = seg_ids[order]
    seg_starts = np.searchsorted(seg_sorted, np.arange(G))
    return pos_sorted, seg_starts.astype(np.int64), seg_tot.astype(np.int32)
