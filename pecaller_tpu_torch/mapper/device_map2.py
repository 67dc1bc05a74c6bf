"""Fused on-device mapping step (v2: nbr or quartered-key index), PyTorch.

Counterpart of ``pecaller_tpu/mapper/device_map2.py``: the same integer
program, computed bit for bit on the same state, as plain functions on
tensors of an explicit device.  One call of the step maps one batch:

  read prep and 4-bit packing -> seed probe (nbr index: cuckoo rank
  lookup or binary search, then position gathers; quartered-key index,
  "v2.5": four projection lookups, a Hamming filter of the dropped
  quarter and a spill tier for long runs) -> chaining, diagonal dedup and
  CAP selection -> slot compaction -> window fetch -> SW align (K1) ->
  exact-tie / threshold routing and pair decision -> winner compaction
  -> traceback (K2) -> pileup add, insertion and walk-tie records.

Unsigned 32-bit arithmetic of the reference (hash mixes, packed words,
modular distances) is carried in int64 tensors holding values in
[0, 2^32), masked after every multiply and add.  Index arrays stay
int32 on the device; a gathered uint32 word is widened and masked.
Every gather index is clamped into range, as the JAX program's gathers
clamp implicitly; a dropped scatter row goes to one extra dump row.

The pileup ``dev_counts`` is a flat int32 tensor of (genome + 512) x 6
counters that the step updates in place (``index_add_``); its bits are
those of the reference's wrapping uint32 counters.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..index.nbr import NBR_HI_BITS, NbrIndex
from ..index.quarter import MARKER, OCT_SUB_BITS, SUB_BITS, QuarterIndex
from ..native.build import ptr as _ptr
from ..ops import sw2
from ..ops.chain import HIT_CAP, POS_PAD, chain_select, chain_votes
from ..ops.encode import IDEPTH
from ..ops.sw_cuda import sw_align_x, sw_traceback_rows
from ..utils.log import span, stage
from .engine import (
    MISALIGN_SLOP, NEITHER_MAP, NON_MATE, NON_MIS, NON_NO, UNIQUE_MATE,
    UNIQUE_MIS, UNIQUE_SINGLE, UNIQUE_SLIP, MapperEngine)
from .host_prep import (_bucket_b, _pad_to, contig_pad,
                        exact_score_threshold_amb, pack_genome, segments_of)
from .program import StepProgram
from .seeds import revcomp_batch, segment_offsets

PAD_SCORE = -36
SEG_CAP = 16            # candidate positions per probe before spill/fallback
INS_CAP = 2048
TIE_CAP = 2048          # walk-tie record rows per batch (overflow -> fb)
SCATTER_PAD = 512       # pileup rows past the genome end (> R_ROWS)
MASK32 = 0xFFFFFFFF
I32 = torch.int32
I64 = torch.int64


def mul32(x, c):
    """(x * c) mod 2^32 for int64 tensors of uint32 values (c a python
    int or a tensor), split in 16-bit halves so no product overflows."""
    return (x * (c & 0xFFFF)
            + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix32(x):
    """murmur3 finalizer on uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix2(x):
    x = x ^ (x >> 17)
    x = mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def _u32(x):
    """Gathered int32 words (uint32 bit patterns) -> int64 values."""
    return x.to(I64) & MASK32


def _as_i32(a: np.ndarray) -> torch.Tensor:
    """Host integer array -> int32 tensor of its low 32 bits (a
    zero-copy view of a uint32/int32 array's memory)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    with warnings.catch_warnings():
        # read-only (memory-mapped) index arrays: never written
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a.astype(np.int32, copy=False))


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (on a card: a pinned,
    asynchronous copy)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch_async(out: torch.Tensor, device: torch.device) -> dict:
    """Start the copy of a batch's result to the host: on a card one
    pinned copy and an event, waited on by ``fetched``; on the CPU a
    copy.  Either way the copy is taken now, so the next call of a
    ``StepProgram`` may overwrite ``out``."""
    if device.type != "cuda":
        return {"host": out.clone()}
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return {"host": host, "event": event}


def fetched(h: dict) -> np.ndarray:
    """The host copy that ``fetch_async`` started, once it has landed."""
    if "event" in h:
        h["event"].synchronize()
    return h.pop("host").numpy()


# --------------------------------------------------------------------------
# device-resident state

class NbrDeviceIndex:
    """Device tensors of an NbrIndex.

    Rank lookup modes: "hash" when the NbrIndex carries a cuckoo table
    (2 tag probes + 1 value gather), "binsearch" otherwise (two-level
    hi_table + log-step search).  ``args`` lists the tensors in the
    order of the reference step's index arguments."""

    def __init__(self, nbr: NbrIndex, device):
        self.device = torch.device(device)
        self.n_keys = len(nbr.nkeys)
        if nbr.hash_tag is not None:
            self.mode = "hash"
            self.tb = int(np.log2(len(nbr.hash_tag) // 2))
            self.positions = _as_i32(nbr.positions).to(self.device)
            self.args = (_as_i32(nbr.hash_tag).to(self.device),
                         _as_i32(nbr.hash_val).to(self.device),
                         self.positions)
        else:
            self.mode = "binsearch"
            ht = np.asarray(nbr.hi_table)
            sub = np.diff(ht)
            self.max_subrange = int(sub.max()) if self.n_keys else 1
            self.n_steps = max(1, int(np.ceil(np.log2(
                max(self.max_subrange, 2)))) + 1)
            nkeys = np.asarray(nbr.nkeys)
            if not len(nkeys):             # keep every gather in range
                nkeys = np.zeros(1, np.uint32)
            self.nkeys = _as_i32(nkeys).to(self.device)
            self.hi_table = _as_i32(ht).to(self.device)
            self.val_start = _as_i32(nbr.val_start).to(self.device)
            self.positions = _as_i32(nbr.positions).to(self.device)
            self.args = (self.nkeys, self.val_start, self.hi_table,
                         self.positions)


class QuarterDeviceIndex:
    """Device tensors of a QuarterIndex and the quarter probe's
    parameters.

    ``t1`` is the inline run-prefix width per projection, ``rcap`` the
    longest run the probe enumerates (a unit with a longer unpoisoned
    run falls back to the exact host engine), ``hv`` the spill tier's
    lookups per batch (0: ``max(2048, (NF4 // 4 + 255) & ~255)`` for the
    step's NF4 = U x 2 x S x 4 lookups).  ``args`` lists (starts as
    int32, cnts as uint8, pos int32, qw as int32 bit patterns), the
    reference step's index arguments; pos and qw carry ``rcap + 8``
    slack entries so that a run's contiguous gathers never leave the
    table (their values are marker-coded and always masked)."""

    mode = "quarter"

    def __init__(self, qi: QuarterIndex, device, t1: int = 4,
                 rcap: int = 12, hv: int = 0):
        self.device = torch.device(device)
        self.t1, self.rcap, self.hv = t1, rcap, hv
        self.n_keys = 0
        pad = rcap + 8
        pos = np.concatenate([np.asarray(qi.pos),
                              np.full(pad, MARKER, np.int32)])
        qw = np.concatenate([np.asarray(qi.qw),
                             np.zeros(pad // 4 + 2, np.uint32)])
        cnts = torch.from_numpy(np.array(qi.cnts, np.uint8))
        self.args = (_as_i32(qi.starts).to(self.device),
                     cnts.to(self.device), _as_i32(pos).to(self.device),
                     _as_i32(qw).to(self.device))


class OctileDeviceIndex:
    """Device tensors of one genome shard's OctileIndex (index/quarter.py)
    and the octile probe's parameters ``t1`` and ``rcap``, as for
    ``QuarterDeviceIndex``; the spill tier takes ``max(2048, (NF8 // 4
    + 255) & ~255)`` lookups of the step's NF8 = U x 2 x S x 8.  ``args``
    lists (tagt, valt, pos, qw) as int32 bit patterns.  ``pad_entries``
    pads pos and qw to the longest shard's entry count (plus ``rcap + 8``
    slack rows), as the reference stacks its shards: the probe's gather
    clamps read that length; ``pad_tb`` is the shards' common table
    size, checked."""

    mode = "octile"
    hv = 0

    def __init__(self, oi, device, t1: int = 4, rcap: int = 12,
                 pad_entries: int | None = None, pad_tb: int | None = None):
        self.device = torch.device(device)
        self.t1, self.rcap = t1, rcap
        self.n_keys = 0
        if pad_tb is not None and pad_tb != oi.tb:
            raise ValueError("shards must be built with a common tb")
        self.tb = oi.tb
        self.base = int(oi.base)
        self.owned_len = int(oi.owned_len)
        self.cover_len = int(oi.cover_len)
        pad = rcap + 8
        E = len(oi.pos)
        tgt = (E if pad_entries is None else pad_entries) + pad
        pos = np.full(tgt, MARKER, np.int32)
        pos[:E] = np.asarray(oi.pos)
        qw8 = np.zeros(((tgt + 3) // 4 + 2) * 4, np.uint8)
        qw8[:E] = np.asarray(oi.qw).view(np.uint8)[:E]
        self.args = tuple(_as_i32(a).to(self.device) for a in (
            oi.tagt, oi.valt, pos, qw8.view(np.uint32)))


@dataclass
class DeviceState:
    """Everything the step reads besides the batch: index tensors, the
    packed genome (2-bit code and N/exotic mask words as uint32 values
    in int64), contig starts, and the flat pileup counters.  A genome
    shard's state (mapper/gshard.py) also holds its local-coordinate
    frame ``gctx`` (int64 [base_idx, base_seq, own_lo, own_hi, c_lo],
    index/shard.py)."""
    dnbr: NbrDeviceIndex | QuarterDeviceIndex | OctileDeviceIndex
    gcode: torch.Tensor
    gmask: torch.Tensor
    ist: torch.Tensor
    st_pad: torch.Tensor
    dev_counts: torch.Tensor
    gctx: torch.Tensor | None = None


def carry_state(index: NbrIndex | QuarterIndex, cw: np.ndarray,
                mw: np.ndarray, istarts: np.ndarray, n_contigs: int,
                dev_counts: np.ndarray, device, **quarter_kw) -> DeviceState:
    """Turn the reference package's mapping state into the port's
    tensors on ``device``: the NbrIndex or QuarterIndex arrays (a
    QuarterIndex with ``quarter_kw``, the probe parameters of
    ``QuarterDeviceIndex``), ``pack_genome`` words, the contig starts
    (``MapperEngine._istarts``) and a snapshot of the flat uint32 pileup
    counters.  Both packages then compute on identical state."""
    device = torch.device(device)
    ist = np.asarray(istarts).astype(np.int32)
    st_pad = contig_pad(ist, n_contigs)
    return DeviceState(
        QuarterDeviceIndex(index, device, **quarter_kw)
        if isinstance(index, QuarterIndex) else NbrDeviceIndex(index, device),
        torch.from_numpy(np.asarray(cw, np.uint32).astype(np.int64)).to(
            device),
        torch.from_numpy(np.asarray(mw, np.uint32).astype(np.int64)).to(
            device),
        torch.from_numpy(ist).to(device),
        torch.from_numpy(st_pad).to(device),
        _as_i32(np.asarray(dev_counts, np.uint32)).clone().to(device))


# --------------------------------------------------------------------------
# step helpers

def unpack_codes(words, n_out):
    """(..., W) uint32 words -> (..., n_out) uint8 2-bit fields."""
    sh = torch.arange(16, dtype=I64, device=words.device) * 2
    b = (words[..., :, None] >> sh) & 3
    return b.reshape(*words.shape[:-1],
                     words.shape[-1] * 16)[..., :n_out].to(torch.uint8)


def vsearch_ge(csum, targets, steps):
    """Smallest idx with csum[idx] >= target (csum ascending); targets
    beyond csum[-1] return len(csum).  ``steps`` halvings."""
    n = csum.shape[0]
    lo = torch.zeros(targets.shape, dtype=I64, device=csum.device)
    hi = torch.full(targets.shape, n, dtype=I64, device=csum.device)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        pred = csum[mid.clamp(0, n - 1)] < targets
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(~pred, mid, hi)
    return lo


def find_chrom(st_pad, pos, n_contigs, chrom_steps):
    """The reference's probe-at-7 contig search (pemapper.c:2168-2186),
    log-bounded."""
    ns = st_pad.shape[0]
    sbig = 2 ** 31 - 1
    first = torch.zeros_like(pos)
    last = torch.full_like(pos, n_contigs - 1)
    trie = torch.full_like(pos, 7)
    result = torch.full_like(pos, -1)
    done = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    for _ in range(chrom_steps):
        eq = (first == last) & ~done
        result = torch.where(eq, first, result)
        done = done | eq
        ci = trie.clamp(0, ns - 2)
        ok_t = (trie >= 0) & (trie <= ns - 2)
        v_try = torch.where(ok_t, st_pad[ci].to(pos.dtype), sbig)
        v_try1 = torch.where((trie >= -1) & (trie <= ns - 2),
                             st_pad[ci + 1].to(pos.dtype), sbig)
        hit = (~done) & (v_try <= pos) & (v_try1 >= pos)
        result = torch.where(hit, trie, result)
        done = done | hit
        go_low = (~done) & (v_try > pos)
        go_high = (~done) & ~go_low
        last = torch.where(go_low, trie - 1, last)
        first = torch.where(go_high, trie + 1, first)
        trie = torch.where(~done, torch.div(last + first, 2,
                                            rounding_mode="floor"), trie)
    return result


def windows(st_pad, ist, spots, lens_u, n_contigs, chrom_steps, c_shift=0):
    """Candidate locus -> clamped seq-coordinate window (start, blen)
    (engine._windows, pemapper.c:1047-1081).  ``c_shift``: a genome
    shard's first contig, whose accumulated +15/contig padding local
    seq coordinates leave out."""
    chrom = find_chrom(st_pad, spots, n_contigs, chrom_steps).clamp(
        0, n_contigs - 1)
    extra = 15 * (chrom - c_shift)
    start = torch.maximum(ist[chrom] + extra,
                          torch.clamp(extra + spots - MISALIGN_SLOP, min=0))
    end = torch.minimum(ist[chrom + 1] + extra,
                        extra + spots + lens_u + MISALIGN_SLOP)
    return start, 1 + end - start


def fetch_windows(gcode, gmask, start, blen, N):
    """Packed window fetch: word gathers, unpack, per-slot shift.
    Returns (xcodes (n, N) uint8 with N wildcards applied, exotic (n,)
    bool)."""
    dev = start.device
    NW = N // 16 + 2
    widx = (start >> 4)[:, None] + torch.arange(NW, dtype=start.dtype,
                                                device=dev)[None, :]
    widx = widx.clamp(0, gcode.shape[0] - 1)
    ext = NW * 16
    codes = unpack_codes(gcode[widx], ext)
    m2 = unpack_codes(gmask[widx], ext)
    sh = (start & 15)[:, None]
    width = ext
    for bit in (8, 4, 2, 1):
        nw_ = width - bit
        on = (sh & bit) != 0
        codes = torch.where(on, codes[:, bit:bit + nw_], codes[:, :nw_])
        m2 = torch.where(on, m2[:, bit:bit + nw_], m2[:, :nw_])
        width = nw_
    codes = codes[:, :N]
    m2 = m2[:, :N]
    inwin = torch.arange(N, device=dev)[None, :] < blen[:, None]
    xc = torch.where((m2 & 1) == 1, sw2.XN, codes).to(torch.uint8)
    xc = torch.where(inwin, xc, 0).to(torch.uint8)
    exotic = (((m2 & 2) != 0) & inwin).any(dim=1)
    return xc, exotic


def rolling_keys(kcodes, offsets):
    """16-mer keys (uint32 values) at each segment offset."""
    L = max(kcodes.shape[-1] - IDEPTH + 1, 1)
    key_all = torch.zeros(kcodes.shape[:-1] + (L,), dtype=I64,
                          device=kcodes.device)
    for j in range(IDEPTH):
        key_all = (key_all << 2) + kcodes[..., j:j + L].to(I64)
    return torch.gather(key_all, -1, offsets.to(I64).clamp(0, L - 1))


def pack4_dev(x):
    """(U, M) xcodes (0-4) -> (U, PW4) uint32 words, 4 bits a base."""
    U, M = x.shape
    PW4 = (M + 7) // 8
    c = torch.zeros((U, PW4 * 8), dtype=I64, device=x.device)
    c[:, :M] = x.to(I64)
    sh = torch.arange(8, dtype=I64, device=x.device) * 4
    return (c.reshape(U, PW4, 8) << sh).sum(dim=2)


def unpack4(words, n_out):
    sh = torch.arange(8, dtype=I64, device=words.device) * 4
    b = (words[..., :, None] >> sh) & 15
    return b.reshape(*words.shape[:-1],
                     words.shape[-1] * 8)[..., :n_out].to(torch.uint8)


def prep_reads_dev(seqs, lens):
    """Raw ASCII reads (U, M) -> xcodes of both orientations, the N-heavy
    skip flag and the exotic-character flag."""
    U, M = seqs.shape
    dev = seqs.device
    isC = seqs == ord("C")
    isG = seqs == ord("G")
    isT = seqs == ord("T")
    isA = seqs == ord("A")
    isn = seqs == ord("N")
    inlen = torch.arange(M, device=dev)[None, :] < lens[:, None]
    code = (isC.to(torch.uint8) + isG.to(torch.uint8) * 2
            + isT.to(torch.uint8) * 3)
    xf = torch.where(isn & inlen, sw2.XN, code).to(torch.uint8)
    exotic = ((~(isA | isC | isG | isT | isn)) & inlen &
              (seqs != 0)).any(dim=1)
    n_count = (isn & inlen).sum(dim=1)
    skip = (n_count >= 1 + torch.div(lens, 10, rounding_mode="floor")).to(
        I32)
    # reverse complement: flip, complement, roll the pad out front with
    # log-composed per-lane shifts
    flip = xf.flip(1)
    xr = torch.where(flip == sw2.XN, sw2.XN, 3 - flip.to(I32)).to(
        torch.uint8)
    sh_amt = (M - lens).to(I64)
    k = 1
    while k < M:
        xr = torch.where(((sh_amt & k) != 0)[:, None],
                         torch.roll(xr, -k, dims=1), xr)
        k *= 2
    xr = torch.where(inlen, xr, 0).to(torch.uint8)
    return xf, xr, skip, exotic


def run_alone(gen):
    """Run a step generator (``FusedStep2.run``) that meets no collective
    to its end and return its value.  A step with a ``comm`` yields at
    every collective and runs under ``mapper.program.MeshProgram`` or
    ``parallel.mesh.lockstep``."""
    try:
        req = next(gen)
    except StopIteration as stop:
        return stop.value
    gen.close()
    raise RuntimeError(f"collective {req[0]!r} outside a genome mesh")


def first_argmax(mask):
    """Index of the first True along dim 1 (0 when none)."""
    return torch.argmax(mask.to(torch.int8), dim=1).to(I32)


# --------------------------------------------------------------------------
# the step

def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(n))))


class DecideLayer:
    """The pair and single-end decision of a fused step
    (pemapper.c:1313-1536, :1084-1174), for a step with attributes
    ``B``, ``dev``, ``min_dist`` and ``max_dist``.  Both fused steps
    share it; the v1 step passes no DP-input hash and ignores the tie
    flags."""

    def _ar(self, n, dtype=I64):
        return torch.arange(n, dtype=dtype, device=self.dev)

    @staticmethod
    def _top_tie(is_top, cnt, h):
        """>= 2 candidates at the exact top score with different DP
        inputs (hash inequality): the reference's strict f64 `>` scan is
        rounding-dependent there, so the unit goes to the host."""
        hmin = torch.where(is_top, h, MASK32).amin(dim=1)
        hmax = torch.where(is_top, h, 0).amax(dim=1)
        return (cnt >= 2) & (hmin != hmax)

    def decide_single(self, smax, valid, thr, h):
        elig = valid & (smax >= thr[:, None])
        top = torch.where(elig, smax, -(1 << 30)).amax(dim=1)
        is_top = elig & (smax == top[:, None])
        cnt = is_top.sum(1)
        bsm = first_argmax(is_top)
        code = torch.where(cnt == 0, NEITHER_MAP,
                           torch.where(cnt == 1, UNIQUE_SINGLE, NON_NO))
        use = (cnt == 1).to(I32)
        best = torch.where(cnt == 1, bsm, 0)
        return code.to(I32), best, use, self._top_tie(is_top, cnt, h)

    def decide_pair(self, e1, e2, thr1, thr2):
        B = self.B
        smax1, pos1, v1 = e1["smax"], e1["pos"], e1["valid"]
        smax2, pos2, v2 = e2["smax"], e2["pos"], e2["valid"]
        or1, or2 = e1["orient"], e2["orient"]
        h1, h2 = e1["hash"], e2["hash"]
        K = smax1.shape[1]
        NEGBIG = -(1 << 30)
        idx = self._ar(K, I32)[None, :]
        el1 = v1 & (smax1 >= thr1[:, None])
        el2 = v2 & (smax2 >= thr2[:, None])

        # uint32 modular |distance|
        du = (pos1.to(I64)[:, :, None] - pos2.to(I64)[:, None, :]) & MASK32
        dist = torch.minimum(du, (-du) & MASK32)
        pm = (el1[:, :, None] & el2[:, None, :] & (dist >= self.min_dist)
              & (dist <= self.max_dist) & (or1[:, :, None] != or2[:, None, :]))
        ssum = smax1[:, :, None] + smax2[:, None, :]
        tot_best = torch.where(pm, ssum, NEGBIG).amax(dim=(1, 2))
        maxm = pm & (ssum == tot_best[:, None, None])
        perfect = maxm.sum((1, 2))
        first_lin = first_argmax(maxm.reshape(B, -1))
        sm1 = torch.div(first_lin, K, rounding_mode="floor")
        sm2 = first_lin % K
        lin = self._ar(K * K, I32).reshape(K, K)
        share = (maxm & (lin[None] != first_lin[:, None, None]) &
                 ((self._ar(K, I32)[None, :, None] == sm1[:, None, None]) |
                  (self._ar(K, I32)[None, None, :] == sm2[:, None, None])))
        slip = 1 + share.sum((1, 2))

        max1 = torch.where(v1, smax1, NEGBIG).amax(1)
        best1 = first_argmax(v1 & (smax1 == max1[:, None]))
        m1_c = ((best1 != 0).to(I64) +
                (v1 & (idx > best1[:, None]) &
                 (smax1 == max1[:, None])).sum(1))
        max2 = torch.where(v2, smax2, NEGBIG).amax(1)
        best2 = first_argmax(v2 & (smax2 == max2[:, None]))
        s2ref = torch.gather(smax2, 1, best1.to(I64)[:, None])[:, 0]
        m2_c = ((best2 != 0).to(I64) +
                (v2 & (idx > best2[:, None]) &
                 (smax2 >= s2ref[:, None])).sum(1))
        elig_b1 = max1 >= thr1
        elig_b2 = max2 >= thr2
        u1 = elig_b1 & (m1_c < 2)
        u2 = elig_b2 & (m2_c < 2)
        code_np = torch.where(u1 & u2, UNIQUE_MIS,
                              torch.where(u1 | u2, UNIQUE_SINGLE, NON_MIS))

        has_perf = perfect > 0
        use_both = (perfect == 1) | (slip == perfect)
        code = torch.where(has_perf,
                           torch.where(perfect == 1, UNIQUE_MATE,
                                       torch.where(slip == perfect,
                                                   UNIQUE_SLIP, NON_MATE)),
                           code_np)
        b1 = torch.where(has_perf, sm1, best1)
        b2 = torch.where(has_perf, sm2, best2)
        use1 = torch.where(has_perf, use_both, u1).to(I32)
        use2 = torch.where(has_perf, use_both, u2).to(I32)

        # decide-level tie flags on the no-perfect best1/best2 scans
        top1 = v1 & (smax1 == max1[:, None])
        top2 = v2 & (smax2 == max2[:, None])
        t_np1 = self._top_tie(top1, top1.sum(1), h1)
        t_np2 = self._top_tie(top2, top2.sum(1), h2)
        tie_np = (~has_perf) & ((t_np1 & elig_b1) | (t_np2 & elig_b2))

        c_s1, b_s1, u_s1, t_s1 = self.decide_single(smax1, v1, thr1, h1)
        c_s2, b_s2, u_s2, t_s2 = self.decide_single(smax2, v2, thr2, h2)
        n1z = ~v1.any(1)
        n2z = ~v2.any(1)
        both = (~n1z) & (~n2z)
        only1 = (~n1z) & n2z
        only2 = n1z & (~n2z)
        code = torch.where(both, code,
                           torch.where(only1, c_s1,
                                       torch.where(only2, c_s2,
                                                   NEITHER_MAP)))
        best1 = torch.where(both, b1, torch.where(only1, b_s1, 0))
        best2 = torch.where(both, b2, torch.where(only2, b_s2, 0))
        use1 = torch.where(both, use1, torch.where(only1, u_s1, 0))
        use2 = torch.where(both, use2, torch.where(only2, u_s2, 0))
        tie_fb = torch.where(both, tie_np,
                             torch.where(only1, t_s1, only2 & t_s2))
        return (code.to(I32), best1.to(I32), best2.to(I32), use1.to(I32),
                use2.to(I32), tie_fb)


class FusedStep2(DecideLayer):
    """One batch of the fused mapping program for fixed shapes.

    ``step(state, seqs_u, lens, offsets, n_segs, mm0, thr, fb_pad)``
    takes (U, ...) unit-major batch tensors (end-major: end-1 rows then
    end-2) and returns the packed (B + ins_cap + 1 + tie_cap + 1, 6)
    int32 block: rows [:B] = [m1, m2, code, orb1, orb2, fb]; then the
    insertion records [unit, gpos, jstart, len, 0, 0] with the record
    count in the tail row; then the walk-tie records [unit, gstart,
    blen, orient, bt_k, bt_i] with their count in the tail row.
    ``state.dev_counts`` is updated in place.

    ``comm`` (genome-sharded mode, mapper/gshard.py; None elsewhere): the
    collectives of one genome shard (``parallel.mesh.ShardComm``).  The
    step then runs on the shard's octile index and genome slice in local
    coordinates (``state.gctx``) and meets its shards at the reference's
    collectives (pemapper's global index and decide): the chain
    ratchet's pmax, the global per-probe and kept-candidate psums, the
    fallback pmax and the all_gather of every shard's top list into the
    decide, the tie-routing pmax, the psum of the global .mfile
    positions, and the tie-cap overflow pmax.  ``run`` is the step as a
    generator that yields at each of them; ``__call__`` runs it where
    nothing is sharded."""

    def __init__(self, dnbr, *, paired: bool, bisulfite: bool,
                 min_dist: int, max_dist: int, n_contigs: int, B: int,
                 M: int, N: int, s_max: int, ins_cap: int = INS_CAP,
                 tie_cap: int = TIE_CAP, max_rlen: int | None = None,
                 comm=None):
        self.dnbr = dnbr
        self.comm = comm
        self.dev = dnbr.device
        self.paired = paired
        self.bisulfite = bisulfite
        self.min_dist, self.max_dist = min_dist, max_dist
        self.n_contigs = n_contigs
        self.B, self.M, self.N = B, M, N
        self.U = 2 * B if paired else B
        self.S = s_max
        self.ins_cap, self.tie_cap = ins_cap, tie_cap
        # SW slots per batch: 1.5 per unit; units past it fall back
        self.H_CAP = ((int(1.5 * self.U) + 255) // 256) * 256
        # units the quarter probe's caps (spill budget, rcap) sent to the
        # host, summed on the device over the step's calls
        self.n_cap_fb = torch.zeros((), dtype=I64, device=self.dev)
        if dnbr.mode in ("quarter", "octile"):
            # expected heavy fraction ~ P(run > T1), ~15% at 47 Mb on the
            # quarter index, and reads cluster within a batch, so the
            # spill budget needs real margin (a tight one sends batch
            # tails to the host): a quarter of the batch's lookups
            nf = self.U * 2 * s_max * (4 if dnbr.mode == "quarter" else 8)
            self.HV = dnbr.hv or max(2048, (nf // 4 + 255) & ~255)
        self.R_ROWS = min(N, (max_rlen or M) + 2 * MISALIGN_SLOP + 1)
        self.chrom_steps = max(3, int(np.ceil(np.log2(
            max(n_contigs, 2)))) + 3)
        pw = np.empty((2, N), np.int64)
        for t, mlt in enumerate((2654435761, 2246822519)):
            p = 1
            for c in range(N):
                pw[t, c] = p
                p = (p * mlt) & MASK32
        self.pw = torch.from_numpy(pw).to(self.dev)

    def pairize(self, fb_u):
        """A fallback on either end routes the whole pair to the host."""
        if self.paired:
            B = self.B
            fbp = fb_u[:B] | fb_u[B:]
            return torch.cat([fbp, fbp])
        return fb_u

    # ---- seed probe ------------------------------------------------------

    def make_keys2(self, xcode_f, xcode_r, offsets):
        """Probe keys on converted codes for both orientations:
        (U, 2, S) uint32 values."""
        if self.bisulfite:
            def conv(x):
                return torch.where(x == 1, 3, x & 3).to(torch.uint8)
        else:
            def conv(x):
                return x & 3
        return torch.stack([rolling_keys(conv(xcode_f), offsets),
                            rolling_keys(conv(xcode_r), offsets)], dim=1)

    def rank_lookup(self, keys2):
        """-> (start, cnt_sat, abund), each (U, 2, S) int64."""
        dnbr = self.dnbr
        if dnbr.mode == "hash":
            tagt, valt = dnbr.args[0], dnbr.args[1]
            tb = dnbr.tb
            m1 = _mix32(keys2)
            m2 = _mix2(keys2)
            h1 = m1 & ((1 << tb) - 1)
            h2 = (1 << tb) + (m2 & ((1 << tb) - 1))
            e1 = _u32(tagt[h1])
            e2 = _u32(tagt[h2])
            tfm = (1 << 22) - 1
            hit1 = ((e1 >> 31) != 0) & ((e1 & tfm) == (m1 >> tb))
            hit2 = ((e2 >> 31) != 0) & ((e2 & tfm) == (m2 >> tb))
            present = hit1 | hit2
            e = torch.where(hit1, e1, e2)
            hsel = torch.where(hit1, h1, h2)
            start = torch.where(present, _u32(valt[hsel]), 0)
            cnt_sat = torch.where(present, (e >> 22) & 0xFF, 0)
            abund = torch.where(present, (e >> 30) & 1, 0)
            return start, cnt_sat, abund
        nkeys, val_start, hi_table = dnbr.args[0], dnbr.args[1], dnbr.args[2]
        n_keys = dnbr.n_keys
        kmax = max(n_keys - 1, 0)
        hi = keys2 >> (32 - NBR_HI_BITS)
        lo = hi_table[hi].to(I64)
        hi_end = hi_table[hi + 1].to(I64)
        for _ in range(dnbr.n_steps):
            cont = lo < hi_end
            mid = (lo + hi_end) >> 1
            pred = _u32(nkeys[mid.clamp(0, kmax)]) < keys2
            lo = torch.where(cont & pred, mid + 1, lo)
            hi_end = torch.where(cont & ~pred, mid, hi_end)
        idx = lo.clamp(0, kmax)
        present = (_u32(nkeys[idx]) == keys2) & (n_keys > 0)
        v0 = _u32(val_start[idx])
        v1 = _u32(val_start[idx + 1])
        mask31 = (1 << 31) - 1
        start = torch.where(present, v0 & mask31, 0)
        cnt_exact = torch.where(present, (v1 & mask31) - start, 0)
        return start, cnt_exact.clamp(max=255), torch.where(present,
                                                            v0 >> 31, 0)

    def seed_nbr(self, xcode_f, xcode_r, offsets, n_segs, min_match0, skip):
        """Seed probing and chaining, (U, ...) unit-major."""
        U, S, seg_cap = self.U, self.S, SEG_CAP
        positions = self.dnbr.args[-1]
        keys2 = self.make_keys2(xcode_f, xcode_r, offsets)
        start, cnt_sat, abund = self.rank_lookup(keys2)

        seg_valid = self._ar(S)[None, :] < n_segs[:, None]
        seg_bad = (abund == 1) | ~seg_valid[:, None, :]
        seg_tot = torch.where(seg_bad, 0, cnt_sat)              # (U, 2, S)
        seg_over = (seg_tot > seg_cap) & ~seg_bad

        # two-tier contiguous position gather: T1 positions for every
        # probe, the rare heavier probes through a compacted spill tier
        take = seg_tot.clamp(max=seg_cap)
        pmax = max(positions.shape[0] - 1, 0)
        T1 = min(2, seg_cap)
        g1 = start[..., None] + self._ar(T1)
        gval1 = self._ar(T1) < take[..., None]
        pos = torch.where(gval1, positions[g1.clamp(0, pmax)], POS_PAD)
        heavy_over = torch.zeros(U, dtype=torch.bool, device=self.dev)
        if seg_cap > T1:
            T2 = seg_cap - T1
            NF = U * 2 * S
            HV = max(1024, NF // 64)
            heavy = (take > T1).reshape(-1)
            hc = torch.cumsum(heavy.to(I64), 0)
            n_heavy = hc[-1]
            heavy_over = (hc.reshape(U, 2 * S) > HV).any(dim=1)
            hsrc = vsearch_ge(hc, self._ar(HV) + 1,
                              _ceil_log2(NF + 1)).clamp(0, NF - 1)
            h_ok = self._ar(HV) < n_heavy
            hstart = start.reshape(-1)[hsrc]
            htake = take.reshape(-1)[hsrc]
            g2 = hstart[:, None] + T1 + self._ar(T2)
            hval = h_ok[:, None] & (T1 + self._ar(T2) < htake[:, None])
            hpos = torch.where(hval, positions[g2.clamp(0, pmax)], POS_PAD)
            tail = torch.full((NF + 1, T2), POS_PAD, dtype=I32,
                              device=self.dev)
            tail[torch.where(h_ok, hsrc, NF)] = hpos      # row NF: dump
            pos = torch.cat([pos, tail[:NF].reshape(U, 2, S, T2)], dim=-1)
        return run_alone(self.chain_dedup_select(
            pos, seg_tot, seg_over, heavy_over, offsets, n_segs, min_match0,
            skip))

    @staticmethod
    def _ham_filter(pe_raw, qb_e, qb_probe, qsel, valid, bits):
        """Base-level Hamming filter of an entry's dropped part (a
        quarter's byte, ``bits`` 8, or an octile's nibble, 4) and the
        abundance-marker poisoning: (position or POS_PAD, poison)."""
        x = (qb_e ^ qb_probe) & ((1 << bits) - 1)
        f = x | (x >> 1)
        nm = sum((f >> b) & 1 for b in range(0, bits, 2))
        is_mark = valid & (pe_raw >= MARKER)
        ok = (nm == 1) | ((nm == 0) & (qsel == 0))
        cand = valid & ~is_mark & ok
        return torch.where(cand, pe_raw, POS_PAD), is_mark & (nm <= 1)

    def _probe_runs(self, start, cnt, qb_p, n_segs, skip):
        """The candidates of each probe's P projection runs, on the
        quartered-key index (P 4, a byte a dropped quarter) or a genome
        shard's octile index (P 8, a nibble a dropped group): ``start``,
        ``cnt`` (saturated at 255) and the probe's dropped part ``qb_p``
        are (U, 2, S, P).  An inline tier gathers the first t1 entries of
        every run, a spill tier the rest of the runs longer than t1 (up
        to rcap), compacted over the batch; the dropped parts ride in
        ``qw``, a byte an entry.  Returns (candidate positions (U, 2, S,
        P x rcap), POS_PAD where none, the candidates a probe, and the
        units the caps send to the host: a spill budget overrun or an
        unpoisoned run past rcap)."""
        U, S = self.U, self.S
        P = start.shape[-1]
        bits = 32 // P
        dq = self.dnbr
        _, _, epos, eqw = dq.args
        T1, T2E = dq.t1, dq.rcap - dq.t1
        emax = max(epos.shape[0] - 1, 0)
        wmax = max(eqw.shape[0] - 1, 0)

        # inline tier: the first T1 entries of every run
        jt1 = self._ar(T1)
        v1 = jt1 < cnt[..., None]                    # (U, 2, S, P, T1)
        pe1 = epos[(start[..., None] + jt1).clamp(0, emax)]
        w0i = start >> 2
        w0 = _u32(eqw[w0i.clamp(0, wmax)])
        w1 = _u32(eqw[(w0i + 1).clamp(0, wmax)])
        b1 = (start & 3)[..., None] + jt1            # byte 0..T1+2
        qb1 = torch.where(b1 < 4, (w0[..., None] >> (b1.clamp(0, 3) * 8)),
                          (w1[..., None] >> ((b1 - 4).clamp(0, 3) * 8))
                          ) & 0xFF
        qsel = self._ar(P)[None, None, None, :, None]
        pos1, poison1 = self._ham_filter(pe1, qb1, qb_p[..., None], qsel,
                                         v1, bits)

        # spill tier: the runs longer than T1, compacted over the batch
        heavy = (cnt > T1).reshape(-1)
        NF = U * 2 * S * P
        HV = self.HV
        hc = torch.cumsum(heavy.to(I64), 0)
        n_heavy = hc[-1]
        heavy_over = (hc.reshape(U, 2 * S * P) > HV).any(dim=1)
        hsrc = vsearch_ge(hc, self._ar(HV) + 1,
                          _ceil_log2(NF + 1)).clamp(0, NF - 1)
        h_ok = self._ar(HV) < n_heavy
        hstart = start.reshape(-1)[hsrc]
        hcnt = cnt.reshape(-1)[hsrc]
        hqb_p = qb_p.reshape(-1)[hsrc]
        jt2 = self._ar(T2E)
        v2 = h_ok[:, None] & ((T1 + jt2) < hcnt[:, None])
        pe2 = epos[(hstart[:, None] + T1 + jt2).clamp(0, emax)]
        w2i = (hstart + T1) >> 2
        b2 = ((hstart + T1) & 3)[:, None] + jt2
        wsel = b2 >> 2
        bsh = (b2 & 3) * 8
        qb2 = torch.zeros(pe2.shape, dtype=I64, device=self.dev)
        for j in range((T1 % 4 + T2E + 3) // 4 + 1):
            w = _u32(eqw[(w2i + j).clamp(0, wmax)])
            qb2 = torch.where(wsel == j, (w[:, None] >> bsh) & 0xFF, qb2)
        pos2, poison2 = self._ham_filter(pe2, qb2, hqb_p[:, None],
                                         (hsrc % P)[:, None], v2, bits)
        tgt = torch.where(h_ok, hsrc, NF)                 # row NF: dump
        tail = torch.full((NF + 1, T2E), POS_PAD, dtype=I32,
                          device=self.dev)
        tail[tgt] = pos2
        poison_sp = torch.zeros(NF + 1, dtype=torch.bool, device=self.dev)
        poison_sp[tgt] = poison2.any(dim=1)

        # runs longer than rcap cannot be enumerated: the unit falls back
        # to the exact host engine unless the probe is poisoned anyway
        poison_q = poison1.any(-1) | poison_sp[:NF].reshape(U, 2, S, P)
        poison_probe = poison_q.any(-1)                    # (U, 2, S)
        seg_in = (self._ar(S)[None, :] < n_segs[:, None])[:, None, :]
        enum_probe = (cnt > (T1 + T2E)).any(-1)
        enum_fb = (enum_probe & ~poison_probe & seg_in).any(dim=2).any(dim=1)
        cap_fb = heavy_over | enum_fb
        self.n_cap_fb += (cap_fb & (skip == 0)).sum()

        allpos = torch.cat([pos1, tail[:NF].reshape(U, 2, S, P, T2E)],
                           dim=-1).reshape(U, 2, S, P * (T1 + T2E))
        allpos = torch.where((seg_in & ~poison_probe)[..., None], allpos,
                             POS_PAD)
        return allpos, (allpos < POS_PAD).sum(-1), cap_fb

    def _head(self, allpos):
        """The SEG_CAP smallest candidates a probe, ascending.  The
        reference sorts with a bitonic network (bitonic_sort_last) after
        padding to a power of two with POS_PAD: values without a payload,
        so every ascending sort of a row gives the same row."""
        pos = torch.sort(allpos, dim=-1).values[..., :SEG_CAP]
        short = SEG_CAP - pos.shape[-1]
        if short > 0:
            pos = torch.cat([pos, torch.full(pos.shape[:-1] + (short,),
                                             POS_PAD, dtype=I32,
                                             device=self.dev)], dim=-1)
        return pos

    def seed_quarter(self, xcode_f, xcode_r, offsets, n_segs, min_match0,
                     skip):
        """Seed probing on the quartered-key index ("v2.5"), (U, ...)
        unit-major: 4 projection lookups per probe enumerate the
        Hamming<=1 candidate set of pemapper's fill_mers
        (pemapper.c:1969-2003); index/quarter.py has the layout."""
        starts_t, cnt_t = self.dnbr.args[:2]
        keys2 = self.make_keys2(xcode_f, xcode_r, offsets)

        # per-quarter projection lookup: (U, 2, S, 4)
        sh_q = (3 - self._ar(4)) * 8
        k4 = keys2[..., None]
        qb_p = (k4 >> sh_q) & 0xFF
        # two sub-width shifts, as the reference's uint32 program shifts
        # (k >> 24) >> 8 where k >> 32 is undefined
        sub = (((k4 >> sh_q) >> 8) << sh_q) | (k4 & ((1 << sh_q) - 1))
        base = (self._ar(4) << SUB_BITS) | sub
        allpos, cnt_cand, cap_fb = self._probe_runs(
            starts_t[base].to(I64), cnt_t[base].to(I64), qb_p, n_segs, skip)
        return run_alone(self.chain_dedup_select(
            self._head(allpos), cnt_cand, cnt_cand > SEG_CAP, cap_fb,
            offsets, n_segs, min_match0, skip))

    def seed_octile(self, xcode_f, xcode_r, offsets, n_segs, min_match0,
                    skip, gctx):
        """Seed probing on a genome shard's octile index (a generator:
        its genome-sharded tail meets the other shards).  8 projection
        lookups of 28-bit subkeys through the content-proportional cuckoo
        rank table enumerate the Hamming<=1 candidate set of pemapper's
        fill_mers (pemapper.c:1969-2003); the dropped 2-base group's
        nibble is the Hamming filter.  Positions are shard-local; with a
        ``comm`` the probe counts only owned candidates and sums them
        over the shards."""
        tagt, valt = self.dnbr.args[:2]
        tb = self.dnbr.tb
        TT = 1 << tb
        keys2 = self.make_keys2(xcode_f, xcode_r, offsets)

        # 8 projections -> cuckoo rank lookup: (U, 2, S, 8)
        sh_q = (7 - self._ar(8)) * 4
        k8 = keys2[..., None]
        qn_p = (k8 >> sh_q) & 0xF
        sub = (((k8 >> sh_q) >> 4) << sh_q) | (k8 & ((1 << sh_q) - 1))
        key31 = (self._ar(8) << OCT_SUB_BITS) | sub
        m1 = _mix32(key31)
        m2 = _mix2(key31)
        h1 = m1 & (TT - 1)
        h2 = TT + (m2 & (TT - 1))
        e1 = _u32(tagt[h1])
        e2 = _u32(tagt[h2])
        tfm = (1 << 22) - 1
        hit1 = ((e1 >> 31) != 0) & ((e1 & tfm) == (m1 >> tb))
        hit2 = ((e2 >> 31) != 0) & ((e2 & tfm) == (m2 >> tb))
        found = hit1 | hit2
        # valt words as the reference's int32 cast of its uint32 values
        start = torch.where(found, valt[torch.where(hit1, h1, h2)].to(I64),
                            0)
        cnt = torch.where(found, (torch.where(hit1, e1, e2) >> 22) & 0xFF, 0)
        allpos, cnt_cand, cap_fb = self._probe_runs(start, cnt, qn_p, n_segs,
                                                    skip)
        shard = None
        seg_tot = cnt_cand
        if self.comm is not None:
            # global per-probe candidate count: owned anchors only (the
            # overlap copies would count twice), summed over the shards
            own_lo, own_hi = gctx[2], gctx[3]
            cnt_owned = ((allpos >= own_lo) & (allpos < own_hi)).sum(-1)
            seg_tot = yield from self.comm.psum(cnt_owned)
            shard = (own_lo, own_hi)
        return (yield from self.chain_dedup_select(
            self._head(allpos), seg_tot, cnt_cand > SEG_CAP, cap_fb, offsets,
            n_segs, min_match0, skip, shard=shard))

    def chain_dedup_select(self, pos, seg_tot, seg_over, heavy_over,
                           offsets, n_segs, min_match0, skip, shard=None):
        """Co-linear chaining, min_match ratchet, per-unit diagonal dedup
        and CAP selection (pemapper.c:2188-2289 semantics); a generator
        (``run_alone`` runs it unsharded).  Two kernels on a card
        (``ops/chain.py``), their plain versions on the CPU.

        ``shard`` (genome-sharded mode): the shard's (own_lo, own_hi) in
        local index coordinates.  ``seg_tot`` is then the global
        per-probe count; the chain votes stay local (a candidate's chain
        mates lie in its owner's covered span), the ratchet maxes over
        the shards so that every shard ratchets on the globally best
        chain, and only owned candidates (window start in this shard's
        interval) survive selection."""
        T, Tmax = chain_votes(pos, offsets, n_segs)
        if shard is not None:
            Tmax = yield from self.comm.pmax(Tmax)
        hits, hits_off, orient, tot, n_keep = chain_select(
            pos, T, Tmax, seg_tot, offsets, n_segs, min_match0, skip,
            shard=shard)
        if shard is not None:
            n_keep = yield from self.comm.psum(n_keep)
        fallback = ((seg_over.any(dim=2).any(dim=1) | heavy_over
                     | (n_keep > HIT_CAP)) & (skip == 0))
        return hits, hits_off, orient, tot, fallback

    # ---- the step --------------------------------------------------------

    def __call__(self, state: DeviceState, seqs_u, lens, offsets, n_segs,
                 mm0, thr, fb_pad):
        return run_alone(self.run(state, seqs_u, lens, offsets, n_segs, mm0,
                                  thr, fb_pad))

    def run(self, state: DeviceState, seqs_u, lens, offsets, n_segs, mm0,
            thr, fb_pad):
        """The step as a generator: it yields at each collective of its
        ``comm`` and returns the packed output block."""
        B, U, M, N = self.B, self.U, self.M, self.N
        CAP, H_CAP, R_ROWS = HIT_CAP, self.H_CAP, self.R_ROWS
        ins_cap, tie_cap = self.ins_cap, self.tie_cap
        pairize = self.pairize
        comm = self.comm
        gcode, gmask, ist, st_pad = (state.gcode, state.gmask, state.ist,
                                     state.st_pad)
        dev_counts = state.dev_counts
        gctx = state.gctx
        octile = self.dnbr.mode == "octile"
        c_shift = gctx[4] if octile else 0
        with stage("step.seed"):
            lens = lens.to(I32)
            # bit 30 of thr marks a boundary-ambiguous threshold
            thr_amb = (thr & (1 << 30)) != 0
            thr = thr & ((1 << 30) - 1)
            xf, xr, skip, exotic = prep_reads_dev(seqs_u, lens)
            x4f_w = pack4_dev(xf)
            x4r_w = pack4_dev(xr)

            if octile:
                hits, hits_off, orient, tot, fb = yield from self.seed_octile(
                    xf, xr, offsets, n_segs, mm0, skip, gctx)
            else:
                seed = (self.seed_quarter if self.dnbr.mode == "quarter"
                        else self.seed_nbr)
                hits, hits_off, orient, tot, fb = seed(xf, xr, offsets, n_segs,
                                                       mm0, skip)
            fb = pairize(fb | fb_pad | exotic)
            tot = torch.where(fb, 0, tot)
            # units whose hits spill past H_CAP fall back (cap semantics)
            fb = pairize(fb | (torch.cumsum(tot.to(I64), 0) > H_CAP))
            tot = torch.where(fb, 0, tot)

        with stage("step.windows"):
            # --- scatter-free slot compaction -----------------------------
            idxc = self._ar(CAP, I32)[None, :]
            validh = idxc < tot[:, None]
            cu = torch.cumsum(tot.to(I64), 0)                 # inclusive
            n_slots = cu[-1]
            cu_excl = cu - tot
            slot_tab = torch.where(validh, cu_excl[:, None] + idxc, H_CAP)
            steps_u = _ceil_log2(U + 1)
            sarange = self._ar(H_CAP)
            rid_s = vsearch_ge(cu, sarange + 1, steps_u).clamp(0, U - 1)
            slot_ok = sarange < n_slots
            rid_c = torch.where(slot_ok, rid_s, 0)
            hid_s = torch.where(slot_ok, sarange - cu_excl[rid_c], 0)

            spots_s = torch.clamp(hits[rid_c, hid_s] - hits_off[rid_c, hid_s],
                                  min=0).to(I64)
            lens_s = lens[rid_c]
            start_s, blen_s = windows(st_pad, ist, spots_s, lens_s,
                                      self.n_contigs, self.chrom_steps,
                                      c_shift)
            blen_m = torch.where(slot_ok, blen_s, 0).to(I32)
            refs_x, exo = fetch_windows(gcode, gmask, start_s.to(I64),
                                        blen_m, N)
            ors_s = orient[rid_c, hid_s]
            rw = torch.where((ors_s == 1)[:, None], x4r_w[rid_c], x4f_w[rid_c])
            reads_s = unpack4(rw, M)
            rlens_s = torch.where(slot_ok, lens_s, 1).to(I32)

        with stage("step.align"):
            score, bk, bi, tie_a = sw_align_x(refs_x, blen_m, reads_s, rlens_s,
                                              bisulfite=self.bisulfite,
                                              n_rows=R_ROWS)

            pad1 = torch.full((1,), PAD_SCORE, dtype=I32, device=self.dev)
            score_pad = torch.cat(
                [torch.where(slot_ok, score, PAD_SCORE).to(I32), pad1])
            smax = score_pad[slot_tab]                        # (U, CAP)
            pos_tab = torch.cat([spots_s, torch.zeros(
                1, dtype=spots_s.dtype, device=self.dev)])[slot_tab]

            # per-slot DP-input hash for decide-level tie disambiguation
            colm = self._ar(N, I32)[None, :] < blen_m[:, None]
            hv = torch.where(colm, refs_x.to(I64) + 1, 0)
            ha = (hv * self.pw[0][None, :]).sum(dim=1) & MASK32
            hb = (hv * self.pw[1][None, :]).sum(dim=1) & MASK32
            hs = _mix32(ha ^ mul32(blen_m.to(I64) & MASK32, 0x9E3779B9)
                        ^ ((ors_s.to(I64) << 31) & MASK32))
            hs = hs ^ _mix32((hb + 0x85EBCA6B) & MASK32)
            htab = torch.cat([torch.where(slot_ok, hs, 0),
                              torch.zeros(1, dtype=I64,
                                          device=self.dev)])[slot_tab]

            # windows touching exotic genome chars -> host fallback
            exo_pad = torch.cat([exo & slot_ok, torch.zeros(
                1, dtype=torch.bool, device=self.dev)])
            fb = pairize(fb | (exo_pad[slot_tab] & validh).any(dim=1))
            tot = torch.where(fb, 0, tot)
            smax = torch.where(fb[:, None], PAD_SCORE, smax).to(I32)

        with stage("step.decide"):
            # --- decide ---------------------------------------------------
            valid_h = self._ar(CAP, I32)[None, :] < tot[:, None]
            if comm is not None:
                # a unit's candidates spread over the genome shards: globalize
                # the fallback verdict, gather every shard's top list (global
                # index coordinates, uint32 as the reference) shard-major, and
                # decide identically on every shard
                fb = (yield from comm.pmax(fb.to(I32))) > 0
                tot = torch.where(fb, 0, tot)
                smax = torch.where(fb[:, None], PAD_SCORE, smax).to(I32)
                valid_h = self._ar(CAP, I32)[None, :] < tot[:, None]
                pos_glob = torch.where(valid_h,
                                       (pos_tab + gctx[0]) & MASK32, 0)
                smax_d = yield from comm.all_gather(
                    torch.where(valid_h, smax, PAD_SCORE), 1)
                pos_d = yield from comm.all_gather(pos_glob, 1)
                orient_d = yield from comm.all_gather(
                    torch.where(valid_h, orient, 0).to(torch.int8), 1)
                valid_d = yield from comm.all_gather(valid_h, 1)
                hash_d = yield from comm.all_gather(
                    torch.where(valid_h, htab, 0), 1)
            else:
                smax_d, pos_d, orient_d, valid_d, hash_d = (
                    smax, pos_tab, orient, valid_h, htab)
            if self.paired:
                e1 = dict(smax=smax_d[:B], pos=pos_d[:B], valid=valid_d[:B],
                          orient=orient_d[:B], hash=hash_d[:B])
                e2 = dict(smax=smax_d[B:], pos=pos_d[B:], valid=valid_d[B:],
                          orient=orient_d[B:], hash=hash_d[B:])
                code_out, b1, b2, u1, u2, tie_p = self.decide_pair(
                    e1, e2, thr[:B], thr[B:])
                best_u = torch.cat([b1, b2])
                use_u = torch.cat([u1, u2])
                tie_dec = torch.cat([tie_p, tie_p])
            else:
                code_out, best_u, use_u, tie_dec = self.decide_single(
                    smax_d, valid_d, thr, hash_d)

            if comm is not None:
                # only the winner's owner shard walks back and adds its pileup
                own_u = (torch.div(best_u, CAP, rounding_mode="floor")
                         == comm.index)
                best_loc = torch.where(own_u, best_u % CAP, 0)
                use_loc = torch.where(own_u, use_u, 0)
            else:
                best_loc, use_loc = best_u, use_u
            slot_b = torch.gather(slot_tab, 1, best_loc.to(I64)[:, None])[:, 0]
            slot_b = slot_b.clamp(0, H_CAP - 1)
            # pre-walk tie routing: decide-level ambiguity, an exact argmax-
            # cell tie of the winner, or a threshold-boundary candidate
            tie_al_u = (use_loc == 1) & tie_a[slot_b]
            thr_hit = ((valid_d & ((smax_d == thr[:, None]) |
                                   (smax_d == (thr - 1)[:, None]))).any(dim=1)
                       & thr_amb)
            tie_pre = pairize(tie_dec | tie_al_u | thr_hit)
            if comm is not None:
                tie_pre = (yield from comm.pmax(tie_pre.to(I32))) > 0
            use_loc = torch.where(tie_pre, 0, use_loc)
            m_u = torch.where(use_loc == 1,
                              start_s[slot_b] + bi[slot_b] + 1, 0)
            if comm is not None:
                # .mfile positions are global seq coordinates (+15/contig)
                m_u = yield from comm.psum(
                    torch.where(use_loc == 1, m_u + gctx[1], 0))
            orb_u = torch.gather(orient_d, 1,
                                 best_u.to(I64)[:, None])[:, 0].to(I32)

        with stage("step.walk"):
            # --- winner compaction + traceback ----------------------------
            wmask = use_loc == 1
            wc = torch.cumsum(wmask.to(I64), 0)
            n_win = wc[-1]
            wsrc = vsearch_ge(wc, self._ar(U) + 1, steps_u).clamp(0, U - 1)
            w_ok = self._ar(U) < n_win
            uw = torch.where(w_ok, wsrc, 0)
            slot_w = slot_b[uw]
            start_w = start_s[slot_w]
            blen_w = torch.where(w_ok, blen_s[slot_w], 0).to(I32)
            k_w = torch.where(w_ok, bk[slot_w], 0).to(I32)
            i_w = torch.where(w_ok, bi[slot_w], 0).to(I32)
            orw = orb_u[uw]
            rww = torch.where((orw == 1)[:, None], x4r_w[uw], x4f_w[uw])
            reads_w = unpack4(rww, M)
            rlens_w = torch.where(w_ok, lens[uw], 1).to(I32)
            refs_w, _ = fetch_windows(gcode, gmask, start_w.to(I64), blen_w, N)

            ev_kind, ins_j, ins_len, tie_w = sw_traceback_rows(
                refs_w, blen_w, reads_w, rlens_w, k_w, i_w,
                bisulfite=self.bisulfite, n_rows=R_ROWS)

            # walk-tie routing: tied lanes get their pileup/insertion events
            # suppressed and a record for the host f64 re-walk; records past
            # tie_cap demote their unit to the full host remap
            tied = w_ok & tie_w
            trank = torch.cumsum(tied.to(I64), 0)
            if comm is not None:
                # ranks over the shards' merged record block, so that its
                # overflow demotes units to the host remap (the reference
                # raises there instead, pecaller_tpu/mapper/gshard.py:208-210)
                n_tied = yield from comm.all_gather(trank[-1:], 0)
                trank = trank + n_tied[:comm.index].sum()
            t_over = tied & (trank > tie_cap)
            fb_over = torch.zeros(U + 1, dtype=torch.bool, device=self.dev)
            fb_over.index_fill_(0, torch.where(t_over, uw, U), True)  # U: dump
            fb_over = pairize(fb_over[:U])
            if comm is not None:
                fb_over = (yield from comm.pmax(fb_over.to(I32))) > 0
            lane_keep = ~tied & ~fb_over[uw]

        with stage("step.pileup"):
            # --- pileup add (flat counters, in place) ---------------------
            n_cnt = dev_counts.shape[0]
            rowv = self._ar(R_ROWS)[None, :]
            pos_abs = start_w.to(I64)[:, None] + rowv
            okev = ((ev_kind != sw2.EV_NONE) & w_ok[:, None]
                    & lane_keep[:, None])
            flat_idx = torch.where(okev, pos_abs * 6 + ev_kind.to(I64),
                                   0).reshape(-1)
            inb = (flat_idx >= 0) & (flat_idx < n_cnt)
            dev_counts.index_add_(
                0, torch.where(inb, flat_idx, 0),
                (okev.reshape(-1) & inb).to(I32))
            insm = (ins_j >= 0) & w_ok[:, None] & lane_keep[:, None]
            ci = torch.cumsum(insm.reshape(-1).to(I64), 0)
            n_ins = ci[-1]
            isrc = vsearch_ge(ci, self._ar(ins_cap) + 1,
                              _ceil_log2(U * R_ROWS + 1)).clamp(
                                  0, U * R_ROWS - 1)
            i_ok = self._ar(ins_cap) < n_ins
            iu = torch.div(isrc, R_ROWS, rounding_mode="floor")
            ir = isrc % R_ROWS
            ipos = start_w[iu].to(I64) + ir
            # records carry global seq coordinates; the pileup stays local
            ipos_rec = ipos + gctx[1] if comm is not None else ipos
            iidx = torch.where(i_ok, ipos * 6 + 5, 0)
            inb = (iidx >= 0) & (iidx < n_cnt)
            dev_counts.index_add_(0, torch.where(inb, iidx, 0),
                                  (i_ok & inb).to(I32))

            zero1 = torch.zeros(1, dtype=I32, device=self.dev)

            def col(ok, x, fill):
                """Record column: x where ok else fill, plus the tail row."""
                return torch.cat([torch.where(ok, x, fill).to(I32), zero1])

            zc = torch.zeros(ins_cap + 1, dtype=I32, device=self.dev)
            rec = torch.stack([
                col(i_ok, uw[iu], -1),
                col(i_ok, ipos_rec, -1),
                col(i_ok, ins_j.reshape(-1)[isrc], -1),
                col(i_ok, ins_len.reshape(-1)[isrc], 0),
                zc, zc], dim=1)
            rec[ins_cap, 0] = n_ins.to(I32)

            # walk-tie record block (overflow-demoted units excluded)
            rsel = tied & ~fb_over[uw]
            crt = torch.cumsum(rsel.to(I64), 0)
            n_trec = crt[-1]
            tsrc = vsearch_ge(crt, self._ar(tie_cap) + 1, steps_u).clamp(
                0, U - 1)
            t_ok = self._ar(tie_cap) < n_trec
            tstart = (start_w[tsrc] + gctx[1] if comm is not None
                      else start_w[tsrc])
            trec = torch.stack([
                col(t_ok, uw[tsrc], -1),
                col(t_ok, tstart, 0),
                col(t_ok, blen_w[tsrc], 0),
                col(t_ok, orw[tsrc], 0),
                col(t_ok, k_w[tsrc], 0),
                col(t_ok, i_w[tsrc], 0)], dim=1)
            trec[tie_cap, 0] = n_trec.to(I32)

            fb_all = fb | tie_pre | fb_over
            zB = torch.zeros(B, dtype=I32, device=self.dev)
            m_u = m_u.to(I32)
            if self.paired:
                packed = torch.stack(
                    [m_u[:B], m_u[B:], code_out, orb_u[:B], orb_u[B:],
                     (fb_all[:B] | fb_all[B:]).to(I32)], dim=1)
            else:
                packed = torch.stack([m_u, zB, code_out, orb_u, zB,
                                      fb_all.to(I32)], dim=1)
            return torch.cat([packed, rec, trec], dim=0)


# --------------------------------------------------------------------------
# engine

class FusedMapperEngine2(MapperEngine):
    """Fused mapping engine v2 on one torch device or a reads-axis mesh,
    seeded by the nbr index or by the quartered-key index ("v2.5").

    With neither ``nbr`` nor ``quarter`` given it builds the nbr index
    (fastest probe), and the quartered-key index where the nbr index
    refuses the genome (past its ~49x blow-up cap) or where
    ``force_quarter`` asks for it.  ``t1``, ``rcap`` and ``hv`` are the
    quarter probe's parameters (``QuarterDeviceIndex``).  The exact host
    engine ``MapperEngine`` supplies the oracle pieces: the remap of
    fallback pairs, the native f64 re-walk of tied windows and the
    output statistics.  ``device`` defaults to the first CUDA device; a
    CPU device, named by the caller, runs the plain versions of the
    kernels.

    ``mesh`` (``parallel.mesh.make_mesh``, more than one shard): the
    reads axis shards over every mesh device; each batch's pairs split
    into one part a shard (``shard_units``), each shard runs the step on
    its part and adds into its own pileup partial (``states[s]``); the
    partials are summed at ``final_pileup``.  Shards on one device share
    that device's index tensors.

    The host's work is timed in ``utils.log`` spans: ``engine.enqueue``
    (its parts ``.prep``, ``.fill`` and ``.launch``, on a mesh
    ``.dispatch``: staging and enqueuing the shards), ``engine.resolve``
    (``.wait`` for the device's output, ``.ins`` the insertion strings,
    ``.tiefix`` the f64 re-walk of tied windows, ``.stats``, ``.remap``
    the host engine on fallback pairs) and ``engine.upload`` (packing
    the genome and moving the index to the device).

    Each shape key's step runs as a ``StepProgram`` (a shard's step as
    one a shard): on a card a CUDA graph captured at the key's second
    batch and replayed from then on; ``graph=False`` runs the eager step
    instead (the counterpart of ``build_fused_step2(..., jit=False)``).
    ``group_k`` (default: ``PECALLER_GROUP_K``, else 1) batches of one
    key run as one program with one fetch to the host, as the reference's
    ``build_fused_multi``; a partial group (a key change, or ``resolve``
    of a batch still staged) runs as single-batch programs.  The mesh
    path does not group, as in the reference."""

    def __init__(self, *args, nbr: NbrIndex | None = None,
                 quarter: QuarterIndex | None = None,
                 force_quarter: bool = False, t1: int = 4, rcap: int = 12,
                 hv: int = 0, device="cuda", ins_cap: int = INS_CAP,
                 tie_cap: int = TIE_CAP, mesh=None, group_k: int | None = None,
                 graph: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if group_k is None:
            group_k = int(os.environ.get("PECALLER_GROUP_K", "1"))
        self._group_k = max(1, group_k)
        self._graph = graph
        self._staged = []
        self._programs = {}
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._n_sh = mesh.size if self._mesh is not None else 1
        self.device = (mesh.flat[0] if self._mesh is not None
                       else resolve_device(device))
        gs = self.sdx.genome_size
        if gs >= 2 ** 30:
            raise ValueError("fused device engine requires genome < 2^30 "
                             "bases")
        if quarter is None and nbr is None:
            from ..index.quarter import build_quarter_index
            if force_quarter:
                quarter = build_quarter_index(self.index)
            else:
                from ..index.nbr import build_nbr_index
                try:
                    nbr = build_nbr_index(self.index)
                except ValueError:
                    quarter = build_quarter_index(self.index)
        with span("engine.upload"):
            if quarter is None and nbr.hash_tag is None:
                nbr.with_cuckoo()
            self.ins_cap, self.tie_cap = ins_cap, tie_cap
            cw, mw = pack_genome(self.genome)
            qkw = dict(t1=t1, rcap=rcap, hv=hv) if quarter is not None else {}
            n_counts = (gs + SCATTER_PAD) * 6
            if self._mesh is None:
                self.states = [carry_state(
                    nbr if quarter is None else quarter, cw, mw, self._istarts,
                    self.sdx.n_contigs, np.zeros(n_counts, np.uint32),
                    self.device, **qkw)]
            else:
                from ..parallel.mesh import shard_states
                base = {d: carry_state(
                    nbr if quarter is None else quarter, cw, mw, self._istarts,
                    self.sdx.n_contigs, np.zeros(0, np.uint32), d, **qkw)
                    for d in dict.fromkeys(self._mesh.flat)}
                self.states = shard_states(self._mesh, base, n_counts)
        self.state = self.states[0]
        self._steps = {}
        self.n_fallback = 0
        self.n_tiefix = 0       # walk-tie windows re-walked on host

    @property
    def n_cap_fallback(self) -> int:
        """Units the quarter probe sent to the host because a run was
        past rcap or the batch's spill budget ran out (0 on the nbr
        index)."""
        return sum(int(s.n_cap_fb) for st in self._steps.values()
                   for s in getattr(st, "steps", [st]))

    def _step_kw(self, B, M, N, s_max, mr):
        return dict(paired=self.paired, bisulfite=self.bisulfite,
                    min_dist=self.min_dist, max_dist=self.max_dist,
                    n_contigs=self.sdx.n_contigs, B=B, M=M, N=N,
                    s_max=s_max, ins_cap=self.ins_cap, tie_cap=self.tie_cap,
                    max_rlen=mr)

    def _step_for(self, B, M, N, s_max, mr):
        key = (B, M, N, s_max, mr)
        if key not in self._steps:
            kw = self._step_kw(B, M, N, s_max, mr)
            if self._mesh is None:
                self._steps[key] = FusedStep2(self.state.dnbr, **kw)
            else:
                from ..parallel.mesh import sharded_fused_step2
                self._steps[key] = sharded_fused_step2(
                    self._mesh, self.states, graph=self._graph, **kw)[0]
        return self._steps[key]

    def _program_for(self, K, key):
        """The program of ``K`` batches of shape ``key`` on one device."""
        if (K, key) not in self._programs:
            step, state = self._step_for(*key), self.state
            self._programs[K, key] = StepProgram(
                lambda *ins: step(state, *ins), self.device, group=K,
                graph=self._graph)
        return self._programs[K, key]

    @property
    def programs(self) -> list:
        """Every program the engine has built (on a reads mesh, each
        shard's StepProgram; on a genome mesh, a MeshProgram a key)."""
        return ([p for st in self._steps.values()
                 for p in getattr(st, "programs", ())]
                + list(self._programs.values()))

    def _prep_end2(self, seqs, lens, B, M, s_max):
        """Pad the raw reads and compute the per-read scalars (encoding,
        reverse complement and packing happen on the device)."""
        n = seqs.shape[0]
        seqs_p = np.zeros((B, M), dtype=np.uint8)
        seqs_p[:n, :min(M, seqs.shape[1])] = seqs[:, :M]
        lens_p = np.full(B, 16, np.int32)
        lens_p[:n] = lens
        fb_pad = np.zeros(B, bool)
        fb_pad[n:] = True
        n_segs, offs = segment_offsets(lens_p.astype(np.int64))
        tc = n_segs - 1
        mm0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        mm0[over4] = np.minimum((4 * tc[over4]) // 5, 4)
        thr = exact_score_threshold_amb(lens_p, self.min_align)
        return (seqs_p, lens_p, offs[:, :s_max].astype(np.int32),
                n_segs.astype(np.int32), mm0.astype(np.int32), thr,
                fb_pad)

    @staticmethod
    def _seg_bucket(s_needed):
        for b in (6, 8, 12, 20):
            if s_needed <= b:
                return b
        return 20

    @span("engine.enqueue")
    def map_batch_async(self, seqs1, lens1, seqs2=None, lens2=None,
                        read_nos=None):
        lens1 = np.asarray(lens1, np.int64)
        B = _bucket_b(seqs1.shape[0])
        maxlen = int(lens1.max()) if len(lens1) else 32
        if self.paired:
            lens2 = np.asarray(lens2, np.int64)
            maxlen = max(maxlen, int(lens2.max()) if len(lens2) else 32)
        M = _pad_to(max(maxlen, 32), 16)
        N = _pad_to(M + 2 * MISALIGN_SLOP + 1, 16)
        mr = _pad_to(max(maxlen, 32), 8)
        s_max = self._seg_bucket(segments_of(maxlen))
        key = (B, M, N, s_max, mr)
        with span("engine.enqueue.prep"):
            ins = self._prep_end2(seqs1, lens1, B, M, s_max)
            if self.paired:
                a2 = self._prep_end2(seqs2, lens2, B, M, s_max)
                ins = [np.concatenate([x, y], axis=0)
                       for x, y in zip(ins, a2)]
        h = dict(seqs1=seqs1, lens1=lens1, seqs2=seqs2, lens2=lens2,
                 read_nos=read_nos, n=seqs1.shape[0], B=B, key=key)
        if self._mesh is None:
            h["ins"] = ins
            self._stage(h)
        else:
            self._step_for(*key)
            with span("engine.enqueue.dispatch"):
                outs = self._mesh_outputs(h, ins)
            h["shards"] = [fetch_async(o, o.device) for o in outs]
        return h

    def _mesh_outputs(self, h, ins):
        """Run a mesh batch's step: the output blocks to fetch, each on
        its device (here one a reads shard)."""
        return self._step_for(*h["key"])(self._shard_inputs(ins, h["B"]))

    def _stage(self, h):
        """Stage a batch; ``group_k`` staged batches of one key run as
        one program.  A batch of another key first flushes the partial
        group."""
        if self._staged and self._staged[0]["key"] != h["key"]:
            self._flush_staged()
        self._staged.append(h)
        if len(self._staged) >= self._group_k:
            self._flush_staged()

    def _flush_staged(self):
        """Run the staged batches: a full group as one program, a
        partial group as single-batch programs (so that a key has one
        grouped program, as in the reference)."""
        staged, self._staged = self._staged, []
        if len(staged) == self._group_k:
            self._dispatch(staged)
        else:
            for h in staged:
                self._dispatch([h])

    def _dispatch(self, hs):
        """Run the batches ``hs`` as one program and start the one copy
        of their outputs to the host."""
        prog = self._program_for(len(hs), hs[0]["key"])
        with span("engine.enqueue.fill"):
            prog.load([h.pop("ins") for h in hs])
        with span("engine.enqueue.launch"):
            g = fetch_async(prog.launch(), self.device)
        for i, h in enumerate(hs):
            h["group"], h["gi"] = g, i

    def _shard_inputs(self, ins, B):
        from ..parallel.mesh import shard_units
        return [shard_units(x, self._n_sh, B, self.paired) for x in ins]

    def _fetch_shards(self, h) -> list:
        """The shards' output blocks of a mesh batch, on the host."""
        with span("engine.resolve.wait"):
            return [fetched(f) for f in h.pop("shards")]

    def _records(self, out, n_unit):
        """The insertion and walk-tie record rows of one output block of
        ``n_unit`` packed rows (the reference's tail-marker layout)."""
        rec = out[n_unit:n_unit + self.ins_cap + 1, :4]
        n_ins = int(rec[-1, 0])
        if n_ins > rec.shape[0] - 1:
            raise RuntimeError("insertion record cap exceeded; raise the "
                               "engine's ins_cap")
        trec = out[n_unit + self.ins_cap + 1:, :6]
        return rec[:n_ins], trec[:int(trec[-1, 0])]

    def _blocks(self, h):
        """(packed rows (B, 6), insertion records, walk-tie records) of a
        batch.  On the reads axis shard s holds pairs [s*bl, (s+1)*bl)
        with unit rows [end1 bl | end2 bl]; its records' units are
        renumbered to the single step's end-major units."""
        B = h["B"]
        if "shards" not in h:
            if "ins" in h:
                self._flush_staged()            # h is still staged
            g = h.pop("group")
            if "out" not in g:
                with span("engine.resolve.wait"):
                    g["out"] = fetched(g)       # one fetch a group
            out = g["out"][h["gi"]]
            return (out[:B], *self._records(out, B))
        outs = self._fetch_shards(h)
        bl = B // len(outs)
        packed, recs, trecs = [], [], []
        for sh, out in enumerate(outs):
            packed.append(out[:bl])
            r, tr = (x.copy() for x in self._records(out, bl))
            for arr in (r, tr):
                if self.paired:
                    end2 = arr[:, 0] >= bl
                    arr[:, 0] = np.where(end2, B + sh * bl + (arr[:, 0] - bl),
                                         sh * bl + arr[:, 0])
                else:
                    arr[:, 0] = sh * bl + arr[:, 0]
            recs.append(r)
            trecs.append(tr)
        return (np.concatenate(packed), np.concatenate(recs),
                np.concatenate(trecs))

    @span("engine.resolve")
    def resolve(self, h):
        n = h["n"]
        B = h["B"]
        packed, rr, trec = self._blocks(h)
        m1 = packed[:n, 0].astype(np.uint32)
        m2 = packed[:n, 1].astype(np.uint32)
        code = packed[:n, 2].astype(np.int32)
        orb1 = packed[:n, 3]
        orb2 = packed[:n, 4]
        fb = packed[:n, 5].astype(bool)
        read_nos = h["read_nos"]
        seqs1, lens1 = h["seqs1"], h["lens1"]
        seqs2, lens2 = h["seqs2"], h["lens2"]

        with span("engine.resolve.ins"):
            # reverse-complement only the rows carrying reverse-strand
            # insertion records
            rev_rows = {0: {}, 1: {}}
            if len(rr):
                # per-unit descending gpos: the reference walk attaches
                # insertion strings high-to-low (pemapper.c:1875-1905)
                g_u = rr[:, 1].astype(np.int64) & 0xFFFFFFFF
                rr = rr[np.lexsort((-g_u, rr[:, 0].astype(np.int64)))]
                unit_a = rr[:, 0].astype(np.int64)
                end_a = ((unit_a >= B) & self.paired).astype(np.int8)
                rid_a = unit_a - np.where(end_a == 1, B, 0)
                ok_a = (rid_a >= 0) & (rid_a < n)
                for end in (0, 1):
                    seqs, lens, orb = (seqs1, lens1, orb1) if end == 0 \
                        else (seqs2, lens2, orb2)
                    if seqs is None:
                        continue
                    sel = ok_a & (end_a == end)
                    rids = rid_a[sel]
                    rids = rids[~fb[rids] & (orb[rids] == 1)]
                    uniq = np.unique(rids)
                    if len(uniq):
                        sub = revcomp_batch(
                            np.ascontiguousarray(seqs[uniq]), lens[uniq])
                        rev_rows[end] = {int(r): sub[k]
                                         for k, r in enumerate(uniq)}
            for unit, gpos, js, ln in rr:
                end = 1 if (self.paired and unit >= B) else 0
                rid = int(unit) - (B if end else 0)
                if rid < 0 or rid >= n or fb[rid]:
                    continue
                seqs, orb = (seqs1, orb1) if end == 0 else (seqs2, orb2)
                src = rev_rows[end][rid] if orb[rid] == 1 else seqs[rid]
                sstr = src[js:js + ln].tobytes().decode()
                rn = int(read_nos[rid]) if read_nos is not None else int(rid)
                # positions as uint32 (a genome shard's global records pass
                # 2^31 on hg38)
                self.ins_records.append(
                    ((self._order_counter + rn, end), int(gpos) & MASK32,
                     sstr))

        if len(trec):
            self._rewalk_tied(trec, B, n, read_nos, seqs1, lens1, seqs2,
                              lens2)

        with span("engine.resolve.stats"):
            keep = ~fb
            self._accumulate_stats(
                code[keep], m1[keep], m2[keep], lens1[keep],
                lens2[keep] if self.paired else None)

        if fb.any():
            with span("engine.resolve.remap"):
                idx = np.nonzero(fb)[0]
                self.n_fallback += len(idx)
                nos = (read_nos[idx] if read_nos is not None
                       else idx.astype(np.int64))
                fm1, fm2, fcode = MapperEngine.map_batch(
                    self, np.ascontiguousarray(seqs1[idx]), lens1[idx],
                    np.ascontiguousarray(seqs2[idx]) if self.paired
                    else None,
                    lens2[idx] if self.paired else None, read_nos=nos)
                m1[idx] = fm1
                m2[idx] = fm2
                code[idx] = fcode
        return m1, m2, code

    @span("engine.resolve.tiefix")
    def _rewalk_tied(self, tr, B, n, read_nos, seqs1, lens1, seqs2, lens2):
        """Walk-tie records: the device suppressed these lanes' pileup
        and insertion events; redo just those windows' f64 DP and walk
        with the native engine (bit-exact vs pemapper.c:1752-1965).
        Class, locus and .mfile stay device-decided."""
        unit_t = tr[:, 0].astype(np.int64)
        end_t = ((unit_t >= B) & self.paired).astype(np.int8)
        rid_t = unit_t - np.where(end_t == 1, B, 0)
        ok_t = (rid_t >= 0) & (rid_t < n)
        if not ok_t.all():
            tr, end_t, rid_t = tr[ok_t], end_t[ok_t], rid_t[ok_t]
        self.n_tiefix += len(tr)
        starts = tr[:, 1].astype(np.int64) & 0xFFFFFFFF
        blens_t = np.ascontiguousarray(tr[:, 2].astype(np.int32))
        ors_t = tr[:, 3]
        ks_t = np.ascontiguousarray(tr[:, 4].astype(np.int32))
        is_t = np.ascontiguousarray(tr[:, 5].astype(np.int32))
        H = len(tr)
        W_r = seqs1.shape[1]
        if self.paired and seqs2 is not None:
            W_r = max(W_r, seqs2.shape[1])
        reads_t = np.zeros((H, W_r), np.uint8)
        rlens_t = np.zeros(H, np.int32)
        for end in (0, 1):
            seqs, lens = (seqs1, lens1) if end == 0 else (seqs2, lens2)
            if seqs is None:
                continue
            sel = np.nonzero(end_t == end)[0]
            if not len(sel):
                continue
            rids = rid_t[sel]
            reads_t[sel, :seqs.shape[1]] = seqs[rids]
            rlens_t[sel] = lens[rids]
            bwd = sel[ors_t[sel] == 1]
            if len(bwd):
                reads_t[bwd, :seqs.shape[1]] = revcomp_batch(
                    np.ascontiguousarray(seqs[rid_t[bwd]]),
                    lens[rid_t[bwd]])
        width = int(blens_t.max()) if H else 1
        refs_t = self._gather_refs(starts, blens_t, width)
        reads_t = np.ascontiguousarray(reads_t)
        ins_cap_t = H * 64 + 1024
        ins_buf = np.zeros((ins_cap_t, 4), dtype=np.int32)
        ins_count = np.zeros(1, dtype=np.int64)
        pos0 = np.ascontiguousarray(starts)
        self.lib.sw_backtrack_batch(
            _ptr(refs_t, ctypes.c_uint8), _ptr(blens_t, ctypes.c_int32),
            refs_t.shape[1], _ptr(reads_t, ctypes.c_uint8),
            _ptr(rlens_t, ctypes.c_int32), reads_t.shape[1], H,
            1 if self.bisulfite else 0, self.nthreads,
            _ptr(ks_t, ctypes.c_int32), _ptr(is_t, ctypes.c_int32),
            _ptr(pos0, ctypes.c_int64),
            self.pileup.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.sdx.genome_size, _ptr(ins_buf, ctypes.c_int32),
            ins_cap_t, _ptr(ins_count, ctypes.c_int64))
        nrec = int(ins_count[0])
        if nrec:
            recs = ins_buf[:nrec]
            order = np.argsort(recs[:, 0], kind="stable")
            for ti, gpos, jstart, ilen in recs[order]:
                rid = int(rid_t[ti])
                s = reads_t[ti, jstart:jstart + ilen].tobytes()
                rn = (int(read_nos[rid]) if read_nos is not None else rid)
                self.ins_records.append(
                    ((self._order_counter + rn, int(end_t[ti])),
                     int(np.uint32(gpos)), s.decode()))

    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        return self.resolve(self.map_batch_async(
            seqs1, lens1, seqs2, lens2, read_nos=read_nos))

    def final_pileup(self) -> np.ndarray:
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        dc = np.zeros(self.state.dev_counts.shape[0], np.uint32)
        for st in self.states:          # the shards' partials, mod 2^32
            dc += st.dev_counts.cpu().numpy().view(np.uint32)
        dev = (dc.reshape(-1, 6) & 0xFFFF).astype(np.uint16)
        return (host + dev[:self.sdx.genome_size]).astype(np.uint16)

    def reset_group(self) -> None:
        super().reset_group()
        for st in self.states:
            st.dev_counts.zero_()
