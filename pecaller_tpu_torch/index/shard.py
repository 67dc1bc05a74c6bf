"""Genome-axis sharding of the octile seed index (docs/SCALING.md).

Counterpart of ``pecaller_tpu/index/shard.py`` (numpy, copied).
Mammalian genomes (mm10 ~2.7 Gb, hg38 ~3.1 Gb) overflow one card's
memory and the fused engine's 28-bit local positions, so the octile
index (index/quarter.py build_octile_index) is built per contiguous
genome interval in LOCAL coordinates and sharded over a mesh ``genome``
axis:

  * shard g OWNS index-coordinate interval [b_g, b_{g+1}) and INDEXES
    [b_g - LM, b_{g+1} + OV): the left margin LM covers window slop for
    candidates starting at the owned boundary, the right overlap OV
    covers a full read + slop so every candidate starting in the owned
    interval chains/aligns entirely shard-locally (the reference's
    whole-genome structures: pemapper.c:2129-2165, 497-522);
  * candidates are owned by their window START; the boundary-overlap
    duplicates are dropped by the non-owner (chain_dedup_select);
  * the per-shard gctx vector [base_idx, base_seq, own_lo, own_hi,
    c_lo] carries the local-coordinate frame into the device step.

Abundance and the chain min-match ratchet stay globally exact via the
GLOBAL CSR key counts at build time and the pmax/psum collectives at
probe time (mapper/device_map2.py seed_octile / chain_dedup_select).

``ShardPlan.gctx`` is int64 here: the reference casts it to int32, which
wraps past 2^31 (hg38's last ~1 Gb), and its step then writes negative
global insertion positions there.
"""

from __future__ import annotations

import numpy as np

from ..formats.index_files import SeedIndex
from ..formats.sdx import SdxInfo
from .quarter import OctileIndex, build_octile_index

LM = 32          # left margin: MISALIGN_SLOP + idepth + slack
OV = 512         # right overlap: max read length + slop + chain slack


class ShardPlan:
    def __init__(self, bounds, bases_idx, bases_seq, own_lo, own_hi,
                 c_lo, cover_idx, cover_seq):
        self.bounds = bounds            # (G+1,) owned idx boundaries
        self.bases_idx = bases_idx
        self.bases_seq = bases_seq
        self.own_lo = own_lo            # local idx coords
        self.own_hi = own_hi
        self.c_lo = c_lo
        self.cover_idx = cover_idx
        self.cover_seq = cover_seq

    @property
    def n_shards(self):
        return len(self.bases_idx)

    def gctx(self) -> np.ndarray:
        """(G, 5) int64 device context rows."""
        g = np.stack([self.bases_idx, self.bases_seq, self.own_lo,
                      self.own_hi, self.c_lo], axis=1)
        return g.astype(np.int64)


def plan_shards(sdx: SdxInfo, n_shards: int) -> ShardPlan:
    ist = sdx.istarts
    gs_idx = int(ist[-1])
    per = (gs_idx + n_shards - 1) // n_shards
    bounds = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * per,
                        gs_idx)
    bases_idx, bases_seq, own_lo, own_hi = [], [], [], []
    c_lo, cover_idx, cover_seq = [], [], []
    for g in range(n_shards):
        b0, b1 = int(bounds[g]), int(bounds[g + 1])
        base = max(0, b0 - LM)
        end = min(gs_idx, b1 + OV)
        c0 = int(np.searchsorted(ist, base, side="right")) - 1
        c0 = max(0, min(c0, sdx.n_contigs - 1))
        c_end = int(np.searchsorted(ist, max(end - 1, 0),
                                    side="right")) - 1
        c_end = max(0, min(c_end, sdx.n_contigs - 1))
        bases_idx.append(base)
        bases_seq.append(base + 15 * c0)
        # shard 0's own_lo is -2^30: the reference clamps window starts
        # below genome start to 0 and keeps the candidate
        own_lo.append((b0 - base) if b0 > 0 else -(1 << 30))
        own_hi.append(b1 - base)
        c_lo.append(c0)
        cover_idx.append(end - base)
        cover_seq.append((end + 15 * c_end) - (base + 15 * c0) + 15)
    return ShardPlan(bounds, np.asarray(bases_idx), np.asarray(bases_seq),
                     np.asarray(own_lo), np.asarray(own_hi),
                     np.asarray(c_lo), np.asarray(cover_idx),
                     np.asarray(cover_seq))


def build_octile_shards(index: SeedIndex, plan: ShardPlan,
                        min_tb: int | None = None) -> list[OctileIndex]:
    """One octile index per shard, local coords, common cuckoo tb (the
    probe's table geometry is the same on every shard)."""
    shards = []
    tb = min_tb
    for g in range(plan.n_shards):
        oi = build_octile_index(
            index, base=int(plan.bases_idx[g]),
            cover_len=int(plan.cover_idx[g]),
            owned_len=int(plan.own_hi[g]), min_tb=tb)
        if tb is None:
            tb = oi.tb
        shards.append(oi)
    if any(s.tb != tb for s in shards):
        # a later shard needed a bigger table: rebuild all at max tb
        tb = max(s.tb for s in shards)
        shards = [build_octile_index(
            index, base=int(plan.bases_idx[g]),
            cover_len=int(plan.cover_idx[g]),
            owned_len=int(plan.own_hi[g]), min_tb=tb)
            for g in range(plan.n_shards)]
    return shards
