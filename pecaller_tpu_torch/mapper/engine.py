"""Batched mapping engine: seeds -> exact chain -> SW -> decisions ->
backtrack/pileup.  The oracle (parity) path; device kernels plug in at the
SW stage (ops/sw.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from ..formats.index_files import SeedIndex
from ..formats.sdx import SdxInfo, find_chrom_mapper
from ..native.build import load_swexact, ptr
from ..ops.encode import IDEPTH
from .seeds import (MAX_SEGS, revcomp_batch, segment_offsets, pack_keys,
                    gather_segment_lists)

MAX_HITS = 200
MISALIGN_SLOP = 10

# mapping classes (pemapper.c:37-45)
UNIQUE_MATE, UNIQUE_SLIP, UNIQUE_SINGLE, UNIQUE_MIS = 0, 1, 2, 3
NON_MATE, NON_MIS, FRAG_MIS, NON_NO, NEITHER_MAP = 4, 5, 6, 7, 8


@dataclass
class MapStats:
    mate_counts: np.ndarray = field(
        default_factory=lambda: np.zeros(9, dtype=np.int64))
    total_reads: int = 0
    total_bases: int = 0
    total_dist: int = 0
    no_dists: int = 0


class MapperEngine:
    def __init__(self, sdx: SdxInfo, genome: np.ndarray, index: SeedIndex,
                 bisulfite: bool = False, min_align: float = 0.9,
                 min_dist: int = 0, max_dist: int = 0, paired: bool = False,
                 nthreads: int = 2):
        self.sdx = sdx
        self.genome = genome
        self.index = index
        self.bisulfite = bisulfite
        self.min_align = float(min_align)
        self.min_dist, self.max_dist = min_dist, max_dist
        self.paired = paired
        self.nthreads = nthreads
        self.lib = load_swexact()
        gs = sdx.genome_size
        self.pileup = np.zeros((nthreads, gs, 6), dtype=np.uint16)
        self.ins_records = []     # (order_key, gpos, string)
        self.stats = MapStats()
        self._istarts = sdx.istarts
        self._order_counter = 0

    # -- seed + chain ------------------------------------------------------
    def _initial_map(self, seqs, lens):
        """Runs initial_map for a batch of one end.

        Returns hits (B,200) uint32 (kmer positions), hits_off, orient,
        tot (B,), plus the oriented read matrix pair (fwd, rev).
        """
        B = seqs.shape[0]
        rev = revcomp_batch(seqs, lens)
        n_count = (seqs == ord("N")).sum(axis=1)
        skip = (n_count >= 1 + lens // 10).astype(np.uint8)

        fwd_c = seqs
        rev_c = rev
        if self.bisulfite:
            fwd_c = seqs.copy()
            fwd_c[fwd_c == ord("C")] = ord("T")
            rev_c = rev.copy()
            rev_c[rev_c == ord("C")] = ord("T")

        n_segs, offs = segment_offsets(lens)
        kf, vf = pack_keys(fwd_c, offs, n_segs)
        kr, vr = pack_keys(rev_c, offs, n_segs)

        # gather lists for both orientations in one call
        keys = np.concatenate([kf.ravel(), kr.ravel()])
        valid = np.concatenate([vf.ravel(), vr.ravel()])
        pos_flat, seg_starts, seg_cnt = gather_segment_lists(
            self.index, keys, valid)
        # reorder into [read][orient][seg] layout
        segs_f = seg_starts[:B * MAX_SEGS].reshape(B, MAX_SEGS)
        segs_r = seg_starts[B * MAX_SEGS:].reshape(B, MAX_SEGS)
        cnt_f = seg_cnt[:B * MAX_SEGS].reshape(B, MAX_SEGS)
        cnt_r = seg_cnt[B * MAX_SEGS:].reshape(B, MAX_SEGS)
        seg_start = np.stack([segs_f, segs_r], axis=1).reshape(-1)
        seg_count = np.stack([cnt_f, cnt_r], axis=1).reshape(-1)

        tc = n_segs - 1
        min_match0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        min_match0[over4] = np.minimum((4 * tc[over4]) // 5, 4)

        hits = np.zeros((B, MAX_HITS), dtype=np.uint32)
        hits_off = np.zeros((B, MAX_HITS), dtype=np.int32)
        orient = np.zeros((B, MAX_HITS), dtype=np.int8)
        tot = np.zeros(B, dtype=np.int32)
        pos_flat = np.ascontiguousarray(pos_flat)
        seg_start = np.ascontiguousarray(seg_start.astype(np.int64))
        seg_count = np.ascontiguousarray(seg_count.astype(np.int32))
        offs_c = np.ascontiguousarray(offs.astype(np.int32))
        n_segs_c = np.ascontiguousarray(n_segs.astype(np.int32))
        mm0 = np.ascontiguousarray(min_match0.astype(np.int32))
        self.lib.find_matches_batch(
            ptr(pos_flat, ctypes.c_uint32), ptr(seg_start, ctypes.c_int64),
            ptr(seg_count, ctypes.c_int32), ptr(offs_c, ctypes.c_int32),
            ptr(n_segs_c, ctypes.c_int32), ptr(mm0, ctypes.c_int32),
            ptr(skip, ctypes.c_uint8), B, MAX_HITS, IDEPTH, self.nthreads,
            ptr(hits, ctypes.c_uint32), ptr(hits_off, ctypes.c_int32),
            ptr(orient, ctypes.c_int8), ptr(tot, ctypes.c_int32))
        return hits, hits_off, orient, tot, rev

    # -- candidate windows + SW -------------------------------------------
    def _windows(self, spots, lens_b):
        """spots (H,) index-coord candidate loci -> seq-coord windows."""
        n = self.sdx.n_contigs
        chrom = find_chrom_mapper(self._istarts, n, spots)
        chrom = np.clip(chrom, 0, n - 1)
        extra = 15 * chrom
        ist = self._istarts
        start = np.maximum(ist[chrom] + extra,
                           np.maximum(0, extra + spots - MISALIGN_SLOP))
        end = np.minimum(ist[chrom + 1] + extra,
                         extra + spots + lens_b + MISALIGN_SLOP)
        blen = (1 + end - start).astype(np.int32)
        return start.astype(np.int64), blen

    def _gather_refs(self, starts, blens, width):
        H = starts.shape[0]
        gs = self.genome.shape[0]
        idx = starts[:, None] + np.arange(width)[None, :]
        np.clip(idx, 0, gs - 1, out=idx)
        refs = self.genome[idx]
        mask = np.arange(width)[None, :] >= blens[:, None]
        refs[mask] = 0
        return np.ascontiguousarray(refs)

    def _sw_scores(self, refs, blens, reads, rlens):
        H = refs.shape[0]
        scores = np.zeros(H, dtype=np.float64)
        out_k = np.zeros(H, dtype=np.int32)
        out_i = np.zeros(H, dtype=np.int32)
        if H == 0:
            return scores, out_k, out_i
        self.lib.sw_align_batch(
            ptr(refs, ctypes.c_uint8), ptr(blens, ctypes.c_int32),
            refs.shape[1], ptr(reads, ctypes.c_uint8),
            ptr(rlens, ctypes.c_int32), reads.shape[1], H,
            1 if self.bisulfite else 0, self.nthreads,
            ptr(scores, ctypes.c_double), ptr(out_k, ctypes.c_int32),
            ptr(out_i, ctypes.c_int32))
        return scores, out_k, out_i

    def _score_end(self, seqs, lens, rev, hits, hits_off, orient, tot):
        """SW-score every hit of one end.  Returns padded per-read arrays
        plus flattened per-hit window data."""
        B = seqs.shape[0]
        hit_mask = np.arange(MAX_HITS)[None, :] < tot[:, None]
        rid, hid = np.nonzero(hit_mask)
        spots = np.maximum(
            0, hits[rid, hid].astype(np.int64) -
            hits_off[rid, hid].astype(np.int64))
        lens_b = lens[rid].astype(np.int64)
        starts, blens = self._windows(spots, lens_b)
        width = int(blens.max()) if len(blens) else 1
        refs = self._gather_refs(starts, blens, width)
        oriented = np.where(orient[rid, hid, None] == 1, rev[rid], seqs[rid])
        oriented = np.ascontiguousarray(oriented)
        rlens = np.ascontiguousarray(lens[rid].astype(np.int32))
        scores, out_k, out_i = self._sw_scores(refs, blens, oriented, rlens)

        smax = np.full((B, MAX_HITS), -1.0, dtype=np.float64)
        smax[rid, hid] = scores
        flat = dict(rid=rid, hid=hid, spots=spots, starts=starts,
                    blens=blens, out_k=out_k, out_i=out_i,
                    scores=scores)
        return smax, flat

    # -- top-level batch ---------------------------------------------------
    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        """Map one batch.  Returns (m1, m2, codes) per read (uint32)."""
        B = seqs1.shape[0]
        lens1 = lens1.astype(np.int64)
        h1, ho1, or1, tot1, rev1 = self._initial_map(seqs1, lens1)
        smax1, flat1 = self._score_end(seqs1, lens1, rev1, h1, ho1, or1, tot1)
        spots1_pad = np.zeros((B, MAX_HITS), dtype=np.uint32)
        spots1_pad[flat1["rid"], flat1["hid"]] = flat1["spots"].astype(np.uint32)

        code = np.zeros(B, dtype=np.int32)
        best1 = np.zeros(B, dtype=np.int32)
        best2 = np.zeros(B, dtype=np.int32)
        use1 = np.zeros(B, dtype=np.int32)
        use2 = np.zeros(B, dtype=np.int32)

        if not self.paired:
            nh = np.ascontiguousarray(tot1)
            l32 = np.ascontiguousarray(lens1.astype(np.int32))
            self.lib.decide_single_batch(
                ptr(smax1, ctypes.c_double), ptr(nh, ctypes.c_int32),
                ptr(l32, ctypes.c_int32), self.min_align, MAX_HITS, B,
                ptr(code, ctypes.c_int32), ptr(best1, ctypes.c_int32),
                ptr(use1, ctypes.c_int32))
            m1 = self._backtrack_end(seqs1, lens1, rev1, or1, flat1,
                                     best1, use1, end=0,
                                     read_nos=read_nos)
            m2 = np.zeros(B, dtype=np.uint32)
        else:
            lens2 = lens2.astype(np.int64)
            h2, ho2, or2, tot2, rev2 = self._initial_map(seqs2, lens2)
            smax2, flat2 = self._score_end(seqs2, lens2, rev2, h2, ho2, or2,
                                           tot2)
            spots2_pad = np.zeros((B, MAX_HITS), dtype=np.uint32)
            spots2_pad[flat2["rid"], flat2["hid"]] = \
                flat2["spots"].astype(np.uint32)
            l1_32 = np.ascontiguousarray(lens1.astype(np.int32))
            l2_32 = np.ascontiguousarray(lens2.astype(np.int32))
            self.lib.decide_pair_batch(
                ptr(smax1, ctypes.c_double), ptr(spots1_pad, ctypes.c_uint32),
                ptr(or1, ctypes.c_int8), ptr(tot1, ctypes.c_int32),
                ptr(l1_32, ctypes.c_int32),
                ptr(smax2, ctypes.c_double), ptr(spots2_pad, ctypes.c_uint32),
                ptr(or2, ctypes.c_int8), ptr(tot2, ctypes.c_int32),
                ptr(l2_32, ctypes.c_int32),
                self.min_align, self.max_dist, self.min_dist, MAX_HITS, B,
                ptr(code, ctypes.c_int32), ptr(best1, ctypes.c_int32),
                ptr(best2, ctypes.c_int32), ptr(use1, ctypes.c_int32),
                ptr(use2, ctypes.c_int32))
            m1 = self._backtrack_end(seqs1, lens1, rev1, or1, flat1,
                                     best1, use1, end=0, read_nos=read_nos)
            m2 = self._backtrack_end(seqs2, lens2, rev2, or2, flat2,
                                     best2, use2, end=1, read_nos=read_nos)

        self._accumulate_stats(code, m1, m2, lens1,
                               lens2 if self.paired else None)
        return m1, m2, code

    def _backtrack_end(self, seqs, lens, rev, orient, flat, best, use, end,
                       read_nos):
        """Backtrack winners of one end; returns m (mfile values)."""
        B = seqs.shape[0]
        m = np.zeros(B, dtype=np.uint32)
        winners = np.nonzero(use == 1)[0]
        if len(winners) == 0:
            return m
        # map (read, chosen hit) -> flat hit index
        flat_idx = np.full((B, MAX_HITS), -1, dtype=np.int64)
        flat_idx[flat["rid"], flat["hid"]] = np.arange(len(flat["rid"]))
        sel = flat_idx[winners, best[winners]]
        assert (sel >= 0).all()
        starts = flat["starts"][sel]
        blens = np.ascontiguousarray(flat["blens"][sel])
        out_k = np.ascontiguousarray(flat["out_k"][sel])
        out_i = np.ascontiguousarray(flat["out_i"][sel])
        ors = orient[winners, best[winners]]
        oriented = np.where(ors[:, None] == 1, rev[winners], seqs[winners])
        oriented = np.ascontiguousarray(oriented)
        rlens = np.ascontiguousarray(lens[winners].astype(np.int32))
        width = int(blens.max()) if len(blens) else 1
        refs = self._gather_refs(starts, blens, width)

        m[winners] = (starts + out_i + 1).astype(np.uint32)

        H = len(winners)
        ins_cap = H * 64 + 1024
        ins_buf = np.zeros((ins_cap, 4), dtype=np.int32)
        ins_count = np.zeros(1, dtype=np.int64)
        pos0 = np.ascontiguousarray(starts.astype(np.int64))
        self.lib.sw_backtrack_batch(
            ptr(refs, ctypes.c_uint8), ptr(blens, ctypes.c_int32),
            refs.shape[1], ptr(oriented, ctypes.c_uint8),
            ptr(rlens, ctypes.c_int32), oriented.shape[1], H,
            1 if self.bisulfite else 0, self.nthreads,
            ptr(out_k, ctypes.c_int32), ptr(out_i, ctypes.c_int32),
            ptr(pos0, ctypes.c_int64),
            self.pileup.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.sdx.genome_size, ptr(ins_buf, ctypes.c_int32),
            ins_cap, ptr(ins_count, ctypes.c_int64))
        nrec = int(ins_count[0])
        if nrec:
            rec = ins_buf[:nrec]
            order = np.argsort(rec[:, 0], kind="stable")
            rec = rec[order]
            for align_idx, gpos, jstart, ilen in rec:
                w = winners[align_idx]
                rn = int(read_nos[w]) if read_nos is not None else int(w)
                s = oriented[align_idx, jstart:jstart + ilen].tobytes()
                # canonical arrival order: (file-global read number, end);
                # matches the reference run with a single worker thread
                self.ins_records.append(
                    ((self._order_counter + rn, end),
                     int(np.uint32(gpos)), s.decode()))
        return m

    def _accumulate_stats(self, code, m1, m2, lens1, lens2):
        st = self.stats
        st.mate_counts += np.bincount(code, minlength=9)[:9]
        has1 = m1 != 0
        has2 = m2 != 0
        st.total_reads += int(has1.sum() + has2.sum())
        st.total_bases += int(lens1[has1].sum())
        if lens2 is not None:
            st.total_bases += int(lens2[has2].sum())
        both = has1 & has2
        if both.any():
            # reference computes labs(m1 - m2) on unsigned ints
            # (pemapper.c:1250): m2 > m1 wraps to a huge positive value and
            # is excluded by the < max_dist*4 gate — reproduce that
            test = (m1[both].astype(np.int64) -
                    m2[both].astype(np.int64)) % (1 << 32)
            ok = test < self.max_dist * 4
            st.total_dist += int(test[ok].sum())
            st.no_dists += int(ok.sum())

    def final_pileup(self) -> np.ndarray:
        """Sum per-thread slabs with uint16 wraparound (reference unsigned
        short semantics)."""
        return self.pileup.sum(axis=0, dtype=np.uint16)

    def reset_group(self) -> None:
        """Flush-and-zero between tsw output groups
        (pemapper_tsw.c dump_output: counters, insertions, stats)."""
        self.pileup[:] = 0
        self.ins_records = []
        self.stats = MapStats()
