"""1-mismatch-closed inverted seed index ("nbr index").

TPU-first replacement for the per-probe neighborhood expansion: instead
of probing all 49 variant keys of a read segment against the exact-key
CSR (the reference's fill_mers loop, pemapper.c:1969-2003), we invert
the relation offline.  For every key v in the Hamming-1 closure of the
genome's 16-mer set, the index stores the union of the position lists of
all exact keys within distance 1 of v, merged ascending.  A segment
probe then costs ONE rank lookup + one short contiguous position gather,
instead of 49 presence probes + a 392-wide merge/sort (which profiling
showed dominates the TPU seed stage: scatter-based compaction ~150 ms +
top_k ~21 ms per batch-end).

Semantics are exactly the reference's: position p (with exact 16-mer
k_p) is a candidate for probe v iff Hamming(v, k_p) <= 1, and candidates
are consumed in ascending-position order — identical to sorting the
union of the 49 per-variant lists.  The reference's too_many_spots
abundance gate applies per VARIANT key (any constituent exact key with
>= 100 positions poisons the probing segment, pemapper.c:1599-1615), so
each nbr record carries an "abundant constituent" flag.

Build strategy: every (variant_key, position) pair becomes one u64
  variant(32) << 31 | position(30) << 1 | abundant(1)
and ONE in-place sort orders the whole index (variant-major, position
ascending within variant; the abundant low bit can't reorder positions).
Positions are < 2^30 by the fused-engine gate, so this fits 63 bits.
Large buffers are hugepage-backed (utils/hugemem.py) because this VM
faults 4K pages at ~40 MB/s.

Storage blows up ~49x on positions, so this index is gated to small
genomes (build_nbr_index refuses above ``max_positions``); larger
genomes keep the direct CSR path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..formats.index_files import SeedIndex
from ..ops.encode import mismatch_neighborhood_keys
from ..utils.hugemem import hp_empty

TOO_MANY = 100          # pemapper.c:162 too_many_spots
NBR_MAGIC = 0x4E425232  # "NBR2"
_CH = 1 << 23           # elements per streaming chunk


NBR_HI_BITS = 28


# --------------------------------------------------------------------------
# cuckoo rank table: key -> (start, cnt_sat, abundant) in 3 device
# gathers (2 tag probes + 1 value), replacing the ~10-gather two-level
# binary search.  Two logical tables of 2^tb slots live concatenated in
# one array; a slot's tag word is
#     [31]=valid  [30]=abundant  [29:22]=min(count,255)  [21:0]=mix>>tb
# (tag+slot reconstruct the full 32-bit invertible mix, so a tag match
# identifies the key exactly; tb >= 10 keeps the tag <= 22 bits).  The
# value word is the key's start offset into ``positions``.  Saturating
# the count at 255 is lossless for the consumers: it only feeds
# min(.,seg_cap), the >seg_cap spill test, and the >200 min_spots wipe.

def _mix1(x):
    x = np.asarray(x, np.uint32).copy()
    x ^= x >> np.uint32(16); x *= np.uint32(0x85EBCA6B)   # noqa: E702
    x ^= x >> np.uint32(13); x *= np.uint32(0xC2B2AE35)   # noqa: E702
    x ^= x >> np.uint32(16)
    return x


def _mix2(x):
    x = np.asarray(x, np.uint32).copy()
    x ^= x >> np.uint32(17); x *= np.uint32(0xED5AD4BB)   # noqa: E702
    x ^= x >> np.uint32(11); x *= np.uint32(0xAC4C1B51)   # noqa: E702
    x ^= x >> np.uint32(15); x *= np.uint32(0x31848BAB)   # noqa: E702
    x ^= x >> np.uint32(14)
    return x


def cuckoo_place(keys: np.ndarray, starts: np.ndarray, tagbits: np.ndarray,
                 min_tb: int | None = None, max_rounds: int = 400):
    """Place unique uint32 ``keys`` with their value words ``starts`` and
    tag bits (abundant << 30 | count << 22) into the 2-table cuckoo rank
    table.  Returns (tagt, valt, tb), or None if placement fails (the
    caller keeps the binary-search path).

    The placement is native (native/cuckoo.c): the reference's
    vectorized rounds, each writing all pending keys first-come-wins and
    re-pending the losers and the displaced occupants on the other
    table, run one key at a time with the same outcome.  At <=45%% load
    this converges in a few dozen geometric rounds."""
    from ..native.build import load_swexact, ptr
    nn = len(keys)
    tb = 10 if min_tb is None else max(10, min_tb)
    while (1 << tb) * 10 < nn * 11:          # per-table load <= ~0.55/2
        tb += 1
    if tb > 31:
        raise ValueError(f"cuckoo table of {nn} keys needs tb {tb} > 31")
    T = 1 << tb
    tagt = hp_empty(2 * T, np.uint32)
    valt = hp_empty(2 * T, np.uint32)
    k = np.ascontiguousarray(keys, np.uint32)
    st = np.ascontiguousarray(starts, np.uint32)
    bits = np.ascontiguousarray(tagbits, np.uint32)
    u32 = ctypes.c_uint32
    rc = load_swexact().cuckoo_place(
        ptr(k, u32), ptr(st, u32), ptr(bits, u32), nn, tb, max_rounds,
        ptr(tagt, u32), ptr(valt, u32))
    if rc < 0:
        raise MemoryError("cuckoo placement ran out of memory")
    return (tagt, valt, tb) if rc == 0 else None


def build_cuckoo(nkeys: np.ndarray, val_start: np.ndarray,
                 max_rounds: int = 400, min_tb: int | None = None):
    """The cuckoo rank table of an nbr index's sorted keys: each key's
    start, saturated count and abundant flag from ``val_start``
    (``cuckoo_place``)."""
    mask31 = np.uint32((1 << 31) - 1)
    v0 = np.asarray(val_start[:-1])
    v1 = np.asarray(val_start[1:])
    start = (v0 & mask31).astype(np.uint32)
    cnt = np.minimum((v1 & mask31).astype(np.int64) - start.astype(np.int64),
                     255).astype(np.uint32)
    ab = (v0 >> np.uint32(31)).astype(np.uint32)
    return cuckoo_place(nkeys, start, (ab << np.uint32(30))
                        | (cnt << np.uint32(22)), min_tb, max_rounds)


class NbrIndex:
    """Host-side container for the inverted neighborhood index.

    Arrays are stored exactly as the device wants them (the packed-u64
    form needs jax x64 and the split costs ~60 s of slow page faults at
    load time on this host):
      nkeys     uint32 sorted closure keys
      val_start uint32 offset of each key's position run, with the
                "abundant constituent" flag in bit 31; counts come from
                the NEXT key's start (runs are contiguous), so there is
                no separate count array
      positions int32  merged ascending per key
      hi_table  int32  (2^NBR_HI_BITS + 1) prefix counts over key>>6
    """

    def __init__(self, nkeys, val_start, positions, hi_table,
                 hash_tag=None, hash_val=None):
        self.nkeys = nkeys
        self.val_start = val_start
        self.positions = positions
        self.hi_table = hi_table
        # optional cuckoo rank table (see build_cuckoo); when present
        # the device uses it instead of nkeys/val_start/hi_table
        self.hash_tag = hash_tag
        self.hash_val = hash_val

    def with_cuckoo(self):
        if self.hash_tag is None:
            built = build_cuckoo(np.asarray(self.nkeys),
                                 np.asarray(self.val_start))
            if built is not None:
                self.hash_tag, self.hash_val, _ = built
        return self


def build_nbr_index(index: SeedIndex,
                    max_positions: int = 1_500_000_000) -> NbrIndex:
    """Build the Hamming-1 inverted index from an exact-key CSR.

    Raises ValueError when the expanded index would exceed
    ``max_positions`` entries (the caller should then keep the direct
    path).
    """
    keys = np.asarray(index.keys, dtype=np.uint32)
    starts = np.asarray(index.starts, dtype=np.int64)
    positions = np.asarray(index.positions, dtype=np.uint32)
    counts = np.diff(starts)
    ne = len(keys)
    if ne == 0:
        z = np.zeros(0, np.uint32)
        return NbrIndex(z, np.zeros(1, np.uint32), z.view(np.int32).copy(),
                        np.zeros((1 << NBR_HI_BITS) + 1, np.int32))
    P = int(counts.sum())
    total = 49 * P
    if total > max_positions:
        raise ValueError(
            f"nbr index would hold {total} positions > cap "
            f"{max_positions}")
    if int(positions.max(initial=0)) >= (1 << 30):
        raise ValueError("nbr index requires positions < 2^30")

    # per-position exact-key fields (small: P entries)
    e_of_p = np.repeat(np.arange(ne, dtype=np.int64), counts)
    ab_of_p = (counts >= TOO_MANY)[e_of_p].astype(np.uint64)
    pos_ab = (positions.astype(np.uint64) << np.uint64(1)) | ab_of_p
    del ab_of_p

    # expand all 49 variant columns into one u64 array, then one sort
    big = hp_empty(total, np.uint64)
    KCH = 1 << 19
    for klo in range(0, ne, KCH):
        khi = min(klo + KCH, ne)
        nb = mismatch_neighborhood_keys(keys[klo:khi])  # (k, 49) u32
        plo, phi = int(starts[klo]), int(starts[khi])
        eo = e_of_p[plo:phi] - klo
        pa = pos_ab[plo:phi]
        for col in range(49):
            vcol = nb[:, col].astype(np.uint64) << np.uint64(31)
            big[col * P + plo:col * P + phi] = vcol[eo] | pa
    del e_of_p, pos_ab
    big.sort()

    # group boundaries (variant-key runs) + per-group stats, streamed
    # into hugepage buffers (nn ~ total for sparse genomes)
    g_start = hp_empty(total, np.int64)
    nn = 0
    prev_hi = None
    for lo in range(0, total, _CH):
        hi = min(lo + _CH, total)
        vk = big[lo:hi] >> np.uint64(31)
        nb = np.empty(hi - lo, bool)
        nb[0] = (prev_hi is None) or (vk[0] != prev_hi)
        np.not_equal(vk[1:], vk[:-1], out=nb[1:])
        idxs = np.flatnonzero(nb)
        g_start[nn:nn + len(idxs)] = idxs + lo
        nn += len(idxs)
        prev_hi = vk[-1]
    g_start = g_start[:nn]

    # abundance prefix sums over the stolen low bit
    ab_cum = hp_empty(total + 1, np.int64)
    ab_cum[0] = 0
    carry = 0
    for lo in range(0, total, _CH):
        hi = min(lo + _CH, total)
        np.cumsum((big[lo:hi] & np.uint64(1)).astype(np.int64),
                  out=ab_cum[lo + 1:hi + 1])
        ab_cum[lo + 1:hi + 1] += carry
        carry = int(ab_cum[hi])

    nkeys = hp_empty(nn, np.uint32)
    # val_start has nn+1 entries: entry i+1's start delimits run i, so
    # counts need no array of their own (abundance flag rides bit 31)
    val_start = hp_empty(nn + 1, np.uint32)
    val_start[nn] = total
    hi_counts = np.zeros(1 << NBR_HI_BITS, np.int64)
    for lo in range(0, nn, _CH):
        hi = min(lo + _CH, nn)
        gs = g_start[lo:hi]
        ge = np.empty(hi - lo, np.int64)
        ge[:-1] = g_start[lo + 1:hi]
        ge[-1] = g_start[hi] if hi < nn else total
        nk = (big[gs] >> np.uint64(31)).astype(np.uint32)
        nkeys[lo:hi] = nk
        g_ab = ((ab_cum[ge] - ab_cum[gs]) > 0).astype(np.uint32)
        val_start[lo:hi] = gs.astype(np.uint32) | (g_ab << np.uint32(31))
        hi_counts += np.bincount(nk >> np.uint32(32 - NBR_HI_BITS),
                                 minlength=1 << NBR_HI_BITS)
    del ab_cum, g_start
    hi_table = np.zeros((1 << NBR_HI_BITS) + 1, np.int64)
    np.cumsum(hi_counts, out=hi_table[1:])

    out_pos = hp_empty(total, np.int32)
    for lo in range(0, total, _CH):
        hi = min(lo + _CH, total)
        out_pos[lo:hi] = ((big[lo:hi] >> np.uint64(1))
                          & np.uint64((1 << 30) - 1)).astype(np.int32)
    del big
    return NbrIndex(nkeys, val_start, out_pos,
                    hi_table.astype(np.int32))


def _cuckoo_spotcheck(nbr: NbrIndex, n_check: int = 64) -> bool:
    """Verify a deterministic sample of keys resolves through the cuckoo
    tables to the same (start, count-sat, abundant) triple as the core
    arrays — guards against a stale ctag/cval pairing with rebuilt core
    files, which would silently map reads to wrong genome positions."""
    nn = len(nbr.nkeys)
    if nn == 0:
        return True
    tagt = np.asarray(nbr.hash_tag)
    valt = np.asarray(nbr.hash_val)
    T = len(tagt) // 2
    tb = int(T).bit_length() - 1
    if (1 << tb) != T:
        return False
    idx = np.linspace(0, nn - 1, min(n_check, nn)).astype(np.int64)
    k = np.asarray(nbr.nkeys)[idx].astype(np.uint32)
    mask31 = np.uint32((1 << 31) - 1)
    v0 = np.asarray(nbr.val_start[:-1])[idx]
    v1 = np.asarray(nbr.val_start[1:])[idx]
    want_start = (v0 & mask31).astype(np.int64)
    want_cnt = np.minimum((v1 & mask31).astype(np.int64) - want_start, 255)
    want_ab = (v0 >> np.uint32(31)).astype(np.int64)
    m1 = _mix1(k)
    m2 = _mix2(k)
    tfm = np.uint32((1 << 22) - 1)
    e1 = tagt[(m1 & np.uint32(T - 1)).astype(np.int64)]
    e2 = tagt[T + (m2 & np.uint32(T - 1)).astype(np.int64)]
    hit1 = ((e1 >> np.uint32(31)) != 0) & ((e1 & tfm) == (m1 >> np.uint32(tb)))
    hit2 = ((e2 >> np.uint32(31)) != 0) & ((e2 & tfm) == (m2 >> np.uint32(tb)))
    if not (hit1 | hit2).all():
        return False
    e = np.where(hit1, e1, e2)
    slot = np.where(hit1, (m1 & np.uint32(T - 1)).astype(np.int64),
                    T + (m2 & np.uint32(T - 1)).astype(np.int64))
    got_start = valt[slot].astype(np.int64)
    got_cnt = ((e >> np.uint32(22)) & np.uint32(0xFF)).astype(np.int64)
    got_ab = ((e >> np.uint32(30)) & np.uint32(1)).astype(np.int64)
    return bool((got_start == want_start).all()
                and (got_cnt == want_cnt).all()
                and (got_ab == want_ab).all())


_PARTS = ("nkeys", "vstart", "pos", "hi", "ctag", "cval")


def _cache_paths(basename: str):
    return {k: f"{basename}.nbx.{k}.npy" for k in _PARTS}


def load_nbr_index(basename: str, index: SeedIndex,
                   max_positions: int = 1_500_000_000,
                   cache: bool = True) -> NbrIndex:
    """Load (or build + disk-cache) the nbr index for ``basename``.

    Cached parts are raw .npy files opened with mmap_mode="r": no
    anonymous-page zeroing, no zipfile streaming — the arrays go
    straight from the page cache into the device transfer."""
    ps = _cache_paths(basename)
    mdx = basename + ".mdx"
    core = [ps[k] for k in ("nkeys", "vstart", "pos", "hi")]
    fresh = cache and all(os.path.exists(p) for p in core)
    if fresh and os.path.exists(mdx):
        fresh = all(os.path.getmtime(p) >= os.path.getmtime(mdx)
                    for p in core)
    if fresh:
        a = {k: np.load(p, mmap_mode="r") for k, p in ps.items()
             if os.path.exists(p)}
        # the cuckoo table is derived from nkeys/vstart: a stale pair
        # (e.g. a crashed rebuild that rewrote the core arrays but not
        # ctag/cval) would silently map reads to wrong positions, so it
        # must be at least as new as every core file AND spot-verify
        # against the loaded arrays before being trusted
        core_mtime = max(os.path.getmtime(p) for p in core)
        cuckoo_ok = (all(os.path.exists(ps[k]) for k in ("ctag", "cval"))
                     and all(os.path.getmtime(ps[k]) >= core_mtime
                             for k in ("ctag", "cval")))
        nbr = NbrIndex(a["nkeys"], a["vstart"], a["pos"], a["hi"],
                       hash_tag=a.get("ctag") if cuckoo_ok else None,
                       hash_val=a.get("cval") if cuckoo_ok else None)
        if nbr.hash_tag is not None and not _cuckoo_spotcheck(nbr):
            nbr.hash_tag = nbr.hash_val = None
        if nbr.hash_tag is None:
            nbr.with_cuckoo()
            if cache and nbr.hash_tag is not None:
                try:
                    np.save(ps["ctag"], nbr.hash_tag)
                    np.save(ps["cval"], nbr.hash_val)
                except OSError:
                    pass
        return nbr
    nbr = build_nbr_index(index, max_positions=max_positions)
    nbr.with_cuckoo()
    if cache:
        try:
            np.save(ps["nkeys"], nbr.nkeys)
            np.save(ps["vstart"], nbr.val_start)
            np.save(ps["pos"], nbr.positions)
            np.save(ps["hi"], nbr.hi_table)
            if nbr.hash_tag is not None:
                np.save(ps["ctag"], nbr.hash_tag)
                np.save(ps["cval"], nbr.hash_val)
        except OSError:
            pass
    return nbr
