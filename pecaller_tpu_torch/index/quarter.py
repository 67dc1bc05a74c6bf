"""Quartered-key inverted seed index ("v2.5"): the mid-genome device
seed path.

Counterpart of ``pecaller_tpu/index/quarter.py``: the 4-projection
index, and below it the octile (drop-one-of-8) variant that the
genome-sharded engine (mapper/gshard.py) seeds mammalian genomes with.
The nbr index (``index/nbr.py``) closes every key under one mismatch
and so holds 49 entries a position, which caps it at ~30 Mb of genome.
This index holds exactly 4: the pigeonhole split of the 16-mer into
four 4-base quarters.  A single substitution lies in exactly one quarter, so
probing the four "drop one quarter" projections enumerates precisely
the reference's Hamming<=1 candidate set (fill_mers,
pemapper.c:1969-2003): each candidate lands in exactly one projection
(the one that dropped its mismatching quarter; exact matches are
claimed by projection 0 only).

Layout (device-resident, gathered by the fused step's quarter probe):

  starts  uint32 (4*2^24 + 1)  entry offset of sub-run (q<<24 | sub24)
  cnts    uint8  (4*2^24)      run length saturated at 255
  pos     int32  (E,)          genome positions, runs sorted ascending;
                               abundant-key MARKER rows (pos = 2^30)
                               sort to the front of their run
  qw      uint32 (ceil(E/4),)  the dropped quarter's byte per entry,
                               packed 4 per word

A probe keeps a gathered entry where the dropped-quarter byte is at
base-level Hamming distance 1, or 0 on projection 0.  The reference's
too_many_spots gate (any constituent exact key with >= 100 positions
poisons the probing segment, pemapper.c:1599-1615) is kept by the
MARKER rows: an abundant key's positions are left out of the runs and
replaced by one marker per (quarter, abundant key) carrying the key's
quarter byte; a marker passing the Hamming filter poisons the probe.

Storage for P indexed positions: ~4P x 5 bytes + 335 MB of tables.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats.index_files import SeedIndex
from ..utils.hugemem import hp_empty
from .nbr import build_cuckoo, cuckoo_place

TOO_MANY = 100            # pemapper.c:162 too_many_spots
MARKER = np.int32(1 << 30)
SUB_BITS = 24
N_SUB = 1 << SUB_BITS


def _drop_quarter(keys: np.ndarray, q: int):
    """(sub24, qbyte) of each 16-mer with quarter q removed.  Quarter 0
    is the first 4 bases (bits 24..31 of the MSB-first packed key)."""
    k = keys.astype(np.uint64)
    s = np.uint64((3 - q) * 8)
    qb = (k >> s) & np.uint64(0xFF)
    low = k & ((np.uint64(1) << s) - np.uint64(1))
    sub = ((k >> (s + np.uint64(8))) << s) | low
    return sub.astype(np.uint32), qb.astype(np.uint32)


class QuarterIndex:
    """Host-side container; arrays in device layout (see module doc)."""

    def __init__(self, starts, cnts, pos, qw):
        self.starts = starts
        self.cnts = cnts
        self.pos = pos
        self.qw = qw


def build_quarter_index(index: SeedIndex,
                        max_positions: int = 6_000_000_000) -> QuarterIndex:
    """Build the 4-projection index from the exact-key CSR.  Raises
    ValueError where the genome is past the index's reach: a position at
    or past 2^30, or 4 x (positions of non-abundant keys + abundant keys)
    past ``max_positions`` or at or past 2^31 (int32 device offsets)."""
    keys = np.asarray(index.keys, dtype=np.uint32)
    starts = np.asarray(index.starts, dtype=np.int64)
    positions = np.asarray(index.positions, dtype=np.uint32)
    counts = np.diff(starts)
    ne = len(keys)
    if ne and int(positions.max(initial=0)) >= (1 << 30):
        raise ValueError("quarter index requires positions < 2^30")

    ab_key = counts >= TOO_MANY
    n_ab = int(ab_key.sum())
    # positions of non-abundant keys only (any probe that could use an
    # abundant key's positions is poisoned by construction)
    e_of_p = np.repeat(np.arange(ne, dtype=np.int64), counts)
    keep_p = ~ab_key[e_of_p]
    pos_n = positions[keep_p]
    e_n = e_of_p[keep_p]
    del e_of_p, keep_p
    Pn = len(pos_n)
    per_q = Pn + n_ab
    if 4 * per_q > max_positions:
        raise ValueError(f"quarter index would hold {4 * per_q} entries "
                         f"> cap {max_positions}")
    if 4 * per_q >= 2 ** 31:
        raise ValueError(
            f"quarter index would hold {4 * per_q} entries >= 2^31; "
            "int32 device offsets would overflow")

    E = 4 * per_q
    out_pos = hp_empty(E, np.int32)
    out_qb = hp_empty(((E + 3) // 4) * 4, np.uint8)
    out_qb[E:] = 0
    cnt_all = np.zeros(4 * N_SUB, np.int64)
    ab_idx = np.nonzero(ab_key)[0]

    for q in range(4):
        sub_k, qb_k = _drop_quarter(keys, q)
        # pack = sub(24) << 40 | norm(1) << 39 | pos(30) << 9 | qb(8) << 1
        big = hp_empty(per_q, np.uint64)
        big[:n_ab] = ((sub_k[ab_idx].astype(np.uint64) << np.uint64(40))
                      | (qb_k[ab_idx].astype(np.uint64) << np.uint64(1)))
        big[n_ab:] = ((sub_k[e_n].astype(np.uint64) << np.uint64(40))
                      | np.uint64(1 << 39)
                      | (pos_n.astype(np.uint64) << np.uint64(9))
                      | (qb_k[e_n].astype(np.uint64) << np.uint64(1)))
        big.sort()
        lo = q * per_q
        norm = (big >> np.uint64(39)) & np.uint64(1)
        out_pos[lo:lo + per_q] = np.where(
            norm == 1,
            ((big >> np.uint64(9)) & np.uint64((1 << 30) - 1)).astype(
                np.int64),
            np.int64(MARKER)).astype(np.int32)
        out_qb[lo:lo + per_q] = (
            (big >> np.uint64(1)) & np.uint64(0xFF)).astype(np.uint8)
        sub_of_e = (big >> np.uint64(40)).astype(np.int64)
        cnt_all[q * N_SUB:(q + 1) * N_SUB] = np.bincount(
            sub_of_e, minlength=N_SUB)
        del big, sub_of_e

    starts_all = hp_empty(4 * N_SUB + 1, np.uint32)
    starts_all[0] = 0
    starts_all[1:] = np.cumsum(cnt_all).astype(np.uint32)
    cnts_sat = np.minimum(cnt_all, 255).astype(np.uint8)
    return QuarterIndex(starts_all, cnts_sat, out_pos,
                        out_qb.view(np.uint32))


_PARTS = ("starts", "cnts", "pos", "qw")


def _cache_paths(basename: str):
    return {k: f"{basename}.q4x.{k}.npy" for k in _PARTS}


def load_quarter_index(basename: str, index: SeedIndex,
                       max_positions: int = 6_000_000_000,
                       cache: bool = True) -> QuarterIndex:
    """Load (or build + disk-cache) the quartered index for ``basename``.
    Cached parts are raw .npy opened with mmap_mode='r' (straight from
    the page cache into the device transfer)."""
    ps = _cache_paths(basename)
    mdx = basename + ".mdx"
    fresh = cache and all(os.path.exists(p) for p in ps.values())
    if fresh and os.path.exists(mdx):
        fresh = all(os.path.getmtime(p) >= os.path.getmtime(mdx)
                    for p in ps.values())
    if fresh:
        a = {k: np.load(p, mmap_mode="r") for k, p in ps.items()}
        return QuarterIndex(a["starts"], a["cnts"], a["pos"], a["qw"])
    qi = build_quarter_index(index, max_positions=max_positions)
    if cache:
        try:
            for k in _PARTS:
                np.save(ps[k], getattr(qi, k))
        except OSError:
            pass
    return qi


# --------------------------------------------------------------------------
# Octile ("drop-one-of-8") variant: the mm10/hg38-scale index.
#
# The 4-projection quarter index stops at ~700 Mb because its 24-bit
# subkey space yields mean run length P/2^24 (docs/SCALING.md).  The
# octile split drops one 2-base GROUP of the 16-mer instead of a 4-base
# quarter: 8 projections of 28-bit subkeys + a 4-bit group nibble.  A
# Hamming-1 mismatch lies in exactly one group, so probing the 8
# projections enumerates exactly the reference's fill_mers candidate
# set (pemapper.c:1969-2003) — identical pigeonhole argument, 16x more
# subkey space (runs shrink 16x).  Because 8*2^28 direct-addressed
# starts would cost 8.6 GB, the octile lookup uses the content-
# proportional cuckoo rank table from index/nbr.py over present
# (q<<28 | sub28) keys (31 bits, fits uint32).
#
# Built per genome SHARD in local coordinates (positions - base), with
# local positions < 2^28 so one u64 sort key packs
#     key31(31) | norm(1) | pos(28) | nibble(4).
# Markers (norm=0) carry abundant exact keys' nibbles and sort to the
# front of their run, exactly like the quarter MARKER scheme; abundance
# is decided on GLOBAL key counts, so every shard poisons consistently.
# --------------------------------------------------------------------------

OCT_SUB_BITS = 28
OCT_LOCAL_MAX = 1 << 28


def _drop_octant(keys: np.ndarray, q: int):
    """(sub28, nibble) of each 16-mer with 2-base group q removed."""
    k = keys.astype(np.uint64)
    s = np.uint64((7 - q) * 4)
    qn = (k >> s) & np.uint64(0xF)
    low = k & ((np.uint64(1) << s) - np.uint64(1))
    sub = ((k >> (s + np.uint64(4))) << s) | low
    return sub.astype(np.uint32), qn.astype(np.uint32)


class OctileIndex:
    """Host container: cuckoo rank (tagt, valt, tb) over 31-bit
    projection keys + entry arrays (pos int32 local, qw packed
    nibbles-in-bytes like the quarter index)."""

    def __init__(self, tagt, valt, tb, pos, qw, base, owned_len,
                 cover_len):
        self.tagt = tagt
        self.valt = valt
        self.tb = tb
        self.pos = pos
        self.qw = qw
        self.base = base              # global coord of local 0
        self.owned_len = owned_len    # candidates starting here are ours
        self.cover_len = cover_len    # indexed span incl. overlap


def build_octile_index(index: SeedIndex, base: int = 0,
                       cover_len: int | None = None,
                       owned_len: int | None = None,
                       min_tb: int | None = None) -> OctileIndex:
    """Build the 8-projection index over the CSR entries whose position
    lies in [base, base + cover_len); positions stored base-relative.
    Abundance (TOO_MANY) uses the CSR's global per-key counts.  Raises
    ValueError for a span of 2^28 or more (use more shards) or past 2^31
    entries."""
    keys = np.asarray(index.keys, dtype=np.uint32)
    starts = np.asarray(index.starts, dtype=np.int64)
    positions = np.asarray(index.positions, dtype=np.uint32)
    counts = np.diff(starts)
    ne = len(keys)
    if cover_len is None:
        cover_len = int(positions.max(initial=0)) + 1 - base
    if owned_len is None:
        owned_len = cover_len
    if cover_len > OCT_LOCAL_MAX:
        raise ValueError("octile shard span must be < 2^28 "
                         f"(got {cover_len}); use more shards")

    ab_key = counts >= TOO_MANY                  # GLOBAL abundance
    e_of_p = np.repeat(np.arange(ne, dtype=np.int64), counts)
    keep_p = (~ab_key[e_of_p] & (positions >= base)
              & (positions < base + cover_len))
    pos_n = (positions[keep_p] - base).astype(np.uint64)
    e_n = e_of_p[keep_p]
    del e_of_p, keep_p
    Pn = len(pos_n)
    ab_idx = np.nonzero(ab_key)[0]
    n_ab = len(ab_idx)
    per_q = Pn + n_ab
    if 8 * per_q >= 2 ** 31:
        raise ValueError("octile shard would exceed 2^31 entries")

    E = 8 * per_q
    out_pos = hp_empty(E, np.int32)
    out_qb = hp_empty(((E + 3) // 4) * 4, np.uint8)
    out_qb[E:] = 0
    big = hp_empty(per_q, np.uint64)
    all_keys, all_vs = [], []
    lo = 0
    for q in range(8):
        sub_k, qn_k = _drop_octant(keys, q)
        key31 = ((np.uint64(q) << np.uint64(28))
                 | sub_k.astype(np.uint64))
        # pack = key31(31) << 33 | norm(1) << 32 | pos(28) << 4 | qn(4)
        big[:n_ab] = ((key31[ab_idx] << np.uint64(33))
                      | qn_k[ab_idx].astype(np.uint64))
        big[n_ab:] = ((key31[e_n] << np.uint64(33))
                      | np.uint64(1 << 32)
                      | (pos_n << np.uint64(4))
                      | qn_k[e_n].astype(np.uint64))
        big.sort()
        norm = (big >> np.uint64(32)) & np.uint64(1)
        out_pos[lo:lo + per_q] = np.where(
            norm == 1,
            ((big >> np.uint64(4)) & np.uint64((1 << 28) - 1)).astype(
                np.int64),
            np.int64(MARKER)).astype(np.int32)
        out_qb[lo:lo + per_q] = (big & np.uint64(0xF)).astype(np.uint8)
        kq = (big >> np.uint64(33)).astype(np.uint32)
        uk, first = np.unique(kq, return_index=True)
        all_keys.append(uk)
        all_vs.append(first.astype(np.int64) + lo)
        lo += per_q
    if sum(len(x) for x in all_keys):
        nkeys = np.concatenate(all_keys)
        vstarts = np.concatenate(all_vs)
        # per-projection blocks are contiguous: each key's run ends at
        # the next key's start, the last key's at its block end
        vnext = np.empty(len(vstarts), np.int64)
        vnext[:-1] = vstarts[1:]
        vnext[-1] = E
        bends = np.repeat(
            (np.arange(8, dtype=np.int64) + 1) * per_q,
            [len(x) for x in all_keys])
        cnts = np.minimum(vnext, bends) - vstarts
        built = _cuckoo_pairs(nkeys, vstarts, cnts, min_tb)
        if built is None:
            raise RuntimeError("octile cuckoo build failed")
    else:
        built = build_cuckoo(np.zeros(0, np.uint32), np.zeros(1, np.int64),
                             min_tb=min_tb)
    tagt, valt, tb = built
    return OctileIndex(tagt, valt, tb, out_pos, out_qb.view(np.uint32),
                       base, owned_len, cover_len)


def _cuckoo_pairs(nkeys, starts, cnts, min_tb=None):
    """The cuckoo rank table of keys with explicit per-key (start, cnt),
    as the reference's synthetic-cumsum build followed by its rewrite of
    each key's value slot with the true start (placement depends on the
    keys alone)."""
    return cuckoo_place(nkeys, starts, np.minimum(cnts, 255).astype(
        np.uint32) << np.uint32(22), min_tb)
