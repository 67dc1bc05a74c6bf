"""Caller site screen on a torch device: the fast path of `run_caller`.

Counterpart of ``pecaller_tpu/caller/device_screen.py``.  The reference
caller (pecaller.c:1149-1749) runs an exact float64 joint-configuration
beam per site.  On real cohorts the overwhelming majority of sites are
*provably boring*: either the bad-base gates fire (pecaller.c:1261-1304
— pure integer logic), or every active sample is homozygous-reference
by such a margin that the beam never keeps a second configuration, in
which case every output value is fully determined (call = ref genotype,
posterior = exactly 1.0, site type = REF, no .snp row).  This module
classifies sites on the device so only the residual "interesting" sites
reach the exact native float64 engine (native/pecall.c) — the screen is
*conservative*, never mis-claiming a site, so byte parity with the C
reference is preserved by construction.

Why the margin criterion is exact
---------------------------------
With the pass-1 alpha prior, `fill_config_probs` (pecaller.c:2511-2788)
expands an alternate genotype j for sample s only when
``like_s[dom] - like_s[j] < thres (=2.3)`` (the allocation check
``templ + thres > best_post`` with the all-ref config's prior == 0 and
all priors <= 0; the secondary check ``templ + 0.01 > best_like`` is
strictly tighter).  If every active sample's margin over *every*
alternate genotype exceeds 2.3, the beam holds exactly one configuration
through all passes, its normalized posterior is exactly 1.0 (float64
1.0/1.0), every final call equals the initial call, and the EM loop
terminates after pass 1 (`calls_changed == 0`).  The screen therefore
requires ``margin > 2.3 + BAND`` where BAND conservatively covers the
float32 likelihood-evaluation error (see below), and additionally routes
any site whose depth could push the f32 lgamma error past BAND/2 to the
exact engine.

The pass-1 likelihood is evaluated in the same algebra as
``fill_sample_like`` (pecaller.c:2448-2507) minus the per-sample
multinomial coefficient (constant across genotypes, cancels in margins):

    like'[j] = A1[scale,ref,j]
             + sum_ii lgamma(TA[scale,ref,j,ii] + reads[ii])
             - lgamma(TOTA[scale,ref,j] + tot + reads[5])

where TA = ceil(scale * d_mean) is precomputed on the host with the
*identical float64 operation sequence* as the C code (so ceil boundary
cases match bit-for-bit), and A1 folds the read-independent factln terms.
`factln(n) == lgamma(n+1)`: the C factbl uses the NR gammln / exact
products whose difference from true lgamma (<1e-9) is inside BAND.

Two phases: phase 0 (integer, one table byte a sample) resolves the
sites whose every active sample has a simple count pattern, against
pass tables built on the host in float64; phase 1 (the f32 lgamma
margins above) decides the rest.  Phase-0 codes are exact integers and
equal the native phase 0 (native/screen.c) bitwise.  Phase-1 codes
depend on the f32 ``lgamma`` of the device and the order of its sums:
they never mark EASY a site whose float64 margins fail the exact
criterion, and differ between implementations only at sites whose
margin lies within the f32 error (< 0.15) of a threshold.

Counts arrive as the pileup's uint16 and travel as int16 bits (torch
has no uint16 arithmetic); the device widens them with ``& 0xFFFF``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..mapper.program import StepProgram, capture_stats
from .device_model import MAX_GEN, NO_ALLELES, fill_alpha_prior_np

# site codes (UNRES is phase-0-internal: "phase 1 must decide")
HARD, EASY, BAD, UNRES = 0, 1, 2, 3

# conservative slack over the exact 2.3 beam threshold: covers f32
# summation error (<=14 terms of magnitude <= ~7e4 at the depth gate ->
# <0.15) plus lgamma-vs-NR-gammln approximation error (<1e-6 rel).
BAND = 1.0
# route any sample whose lgamma arguments could exceed ~8.8e3 (f32 abs
# error ~0.01/term, sum ~0.15) to the exact engine instead.
DEPTH_GATE = 8192

_SCALES = np.arange(10, 101, dtype=np.int64)        # pass-1 scale domain

CHRY = 2
# the thresholds as the f32 values the device compares against
_BEAM_T = float(np.float32(2.3 + BAND))
_ANY_T = float(np.float32(BAND))


def _factln_table(n: int) -> np.ndarray:
    """math.lgamma(k+1) for k in [0, n): within 1e-9 of the C factbl."""
    import math
    return np.array([math.lgamma(k + 1.0) for k in range(n)])


@functools.lru_cache(maxsize=4)
def _tables(haploid: bool):
    """Pass-1 alpha tables over (scale 10..100, ref 0..3, genotype).

    TA replicates pecaller.c:2466-2470 in identical float64 ops:
    d_mean = alpha/rowsum (f64 divide), ta = ceil(scale * d_mean),
    clamped >= 1.
    """
    max_gen = NO_ALLELES if haploid else MAX_GEN
    n_sc = len(_SCALES)
    ta = np.zeros((n_sc, 4, max_gen, NO_ALLELES), dtype=np.int32)
    for ref in range(4):
        alpha = fill_alpha_prior_np(300, 150, ref)[:max_gen].astype(
            np.float64)
        d_mean = alpha / alpha.sum(axis=1, keepdims=True)
        for k, sc in enumerate(_SCALES):
            t = np.ceil(float(sc) * d_mean)
            ta[k, ref] = np.maximum(t, 1.0).astype(np.int32)
    tota = ta.sum(axis=3, dtype=np.int32)
    fact = _factln_table(int(tota.max()) + 1)
    a1 = (fact[tota - 1] - fact[ta - 1].sum(axis=3)).astype(np.float32)
    return ta, tota, a1


# --- phase-0: exact-f64 pass/fail tables for simple count patterns -------
#
# The overwhelming majority of samples at real sites carry a SIMPLE
# pattern: every read is the reference base except at most CMAX reads of
# ONE alternate kind, no Ins reads.  For such a pattern the pass-1
# margin is a pure function of (ref, alt kind, depth, alt count), so it
# is precomputed HOST-SIDE IN FLOAT64 with the identical algebra — no
# f32 error band needed, just P0_EPS for the lgamma-vs-NR-gammln
# difference (<1e-9).  The device then resolves those samples with one
# byte gather, and only sites with a non-simple sample reach the f32
# lgamma screen (phase 1).

TMAX = 512      # phase-0 depth ceiling (deeper sites -> phase 1)
CMAX = 3        # phase-0 alt-read ceiling
P0_EPS = 1e-6


@functools.lru_cache(maxsize=4)
def _phase0_tables(haploid: bool):
    """uint8 pass tables, flat-indexed ((ref*5 + alt)*(TMAX+1) + tot)
    *(CMAX+1) + c: bit 0 = beam margin > 2.3 + eps (single-config
    survival), bit 1 = ungated-argmax margin > eps (the indiv >= 4 EM
    condition)."""
    from scipy.special import gammaln
    max_gen = NO_ALLELES if haploid else MAX_GEN
    ta, tota, _ = _tables(haploid)          # (91, 4, G, 6) int32
    t_ax = np.arange(TMAX + 1)
    sc_idx = np.clip(np.minimum(t_ax, 100), 10, 100) - 10     # (T,)
    g_ax = np.arange(max_gen)

    out = np.zeros((4, 5, TMAX + 1, CMAX + 1), np.uint8)
    for ref in range(4):
        ta_r = ta[sc_idx, ref].astype(np.float64)     # (T, G, 6)
        tota_r = tota[sc_idx, ref].astype(np.float64)  # (T, G)
        # a1 in f64 (read-independent factln terms); like uses the C
        # convention factln(x-1) = lgamma(x) throughout
        a1 = (gammaln(tota_r) - gammaln(ta_r).sum(-1))
        base = gammaln(ta_r).sum(-1)                   # all-zero reads
        for alt in range(5):
            for c in range(CMAX + 1):
                rr = np.maximum(t_ax - c, 0)           # ref reads
                like = (a1 + base
                        - gammaln(ta_r[:, :, ref])
                        + gammaln(ta_r[:, :, ref] + rr[:, None])
                        - gammaln(tota_r + t_ax[:, None]))
                if alt != ref and c > 0:
                    like = (like - gammaln(ta_r[:, :, alt])
                            + gammaln(ta_r[:, :, alt] + c))
                is_ref = g_ax == ref
                # beam gating: Del genotypes need >= 3 Del reads, Ins
                # genotypes >= 3 Ins reads (pecaller.c:2621-2625);
                # phase-0 patterns have Ins = 0 and Del = c iff alt == 4
                blocked = np.zeros(max_gen, bool)
                dead_del = not (alt == 4 and c >= 3)
                blocked[4] = dead_del
                blocked[5] = True
                if max_gen > 12:        # diploid het indel genotypes
                    blocked[12] = dead_del
                    blocked[13] = True
                like_ref = np.where(is_ref, like, -np.inf).max(-1)
                like_beam = np.where(is_ref | blocked, -np.inf,
                                     like).max(-1)
                like_any = np.where(is_ref, -np.inf, like).max(-1)
                pb = (like_ref - like_beam) > (2.3 + P0_EPS)
                pa = (like_ref - like_any) > P0_EPS
                valid = t_ax >= c
                out[ref, alt, :, c] = np.where(
                    valid, pb.astype(np.uint8) | (pa.astype(np.uint8)
                                                  << 1), 0)
    return out.reshape(-1)


def _counts(reads):
    """(S, I, 6) int16 bits of uint16 counts -> int32 counts."""
    return reads.to(torch.int32) & 0xFFFF


def _bad_gate(tot, ctype, indiv):
    """The bad-base gates (pecaller.c:1261-1304), exact integer logic:
    under 8x mean depth, or (off chrY) under half the samples at 8x."""
    sum_tot = tot.sum(-1, dtype=torch.int32)         # (S,) < 2**31 safe
    cnt8 = (tot >= 8).sum(-1, dtype=torch.int32)
    return (sum_tot < 8 * indiv) | ((2 * cnt8 < indiv) & (ctype != CHRY))


def _phase0_chunk(reads, ref_int, ctype, *, haploid: bool, indiv: int,
                  ptab):
    """Cheap integer screen: resolves BAD sites, ref>=4 sites (HARD),
    and EASY sites whose every active sample has a simple pattern.
    reads (S, I, 6) int16 bits, ref_int / ctype (S,) uint8, ptab the
    flat uint8 pass table on the same device.  Returns (S,) uint8 codes
    with UNRES for sites phase 1 must decide."""
    min_depth = 1 if haploid else 2
    r = _counts(reads)                                # (S, I, 6)
    tot = r[..., :5].sum(-1, dtype=torch.int32)       # (S, I)
    active = tot > min_depth
    bad = _bad_gate(tot, ctype, indiv)

    ref_raw = ref_int.to(torch.int64)                 # (S,)
    ref_b = ref_raw.clamp(max=3)[:, None]             # (S, 1)
    rref = torch.gather(r, 2, ref_b[:, :, None].expand(
        r.shape[0], r.shape[1], 1))[..., 0]
    nonref = tot - rref
    col = torch.arange(5, device=r.device)
    masked = torch.where(col == ref_b[..., None], -1, r[..., :5])
    c = masked.amax(-1)
    # the first maximal column, as jnp.argmax gives it (c == 0 and equal
    # alternate counts are ties)
    altk = torch.where(masked == c[..., None], col, 5).amin(-1)
    simple = (nonref == c.clamp(min=0)) & (r[..., 5] == 0) \
        & (tot <= TMAX) & (c <= CMAX)
    flat = (((ref_b * 5 + altk) * (TMAX + 1) + tot.clamp(max=TMAX))
            * (CMAX + 1) + c.clamp(0, CMAX))
    bits = ptab[flat]
    pass_beam = (bits & 1) == 1
    if indiv >= 4:
        pass_beam = pass_beam & (((bits >> 1) & 1) == 1)
    easy = ((~active) | (simple & pass_beam)).all(-1)

    codes = torch.where(bad, BAD, torch.where(easy, EASY, UNRES))
    codes = torch.where(ref_raw >= 4, HARD, codes)
    return codes.to(torch.uint8)


def _screen_chunk(reads, ref_int, ctype, *, haploid: bool, ta, tota, a1):
    """Phase 1: (S,) uint8 EASY/BAD/HARD codes for one (S, I, 6) chunk
    of int16 count bits.  ta (91*4, G, 6) int32, tota (91*4, G) int32 and
    a1 (91*4, G) f32: ``_tables`` with (scale, ref) flattened, on the
    chunk's device."""
    max_gen = NO_ALLELES if haploid else MAX_GEN
    min_depth = 1 if haploid else 2
    indiv = reads.shape[1]

    r = _counts(reads)                                # (S, I, 6)
    tot = r[..., :5].sum(-1, dtype=torch.int32)       # (S, I) excl. Ins
    active = tot > min_depth
    bad = _bad_gate(tot, ctype, indiv)

    # ---- pass-1 likelihood margins (f32) ----
    sc_idx = tot.clamp(10, 100) - 10                  # (S, I)
    ref_raw = ref_int.to(torch.int64)                 # (S,)
    # tables only cover ref in {A,C,G,T}; ambiguity-code references
    # (ref_int >= 4) are forced HARD below so the exact engine decides
    ref_b = ref_raw.clamp(max=3)[:, None]             # (S, 1)
    flat = sc_idx.to(torch.int64) * 4 + ref_b         # (S, I)
    ta_si = ta[flat]                                  # (S, I, G, 6)
    tota_si = tota[flat]                              # (S, I, G)
    a1_si = a1[flat]                                  # (S, I, G)

    # factln(n) = lgamma(n+1): C sums factln(ta+r-1) = lgamma(ta+r)
    # and subtracts factln(tot_tot-1) = lgamma(tota+tot+r5)
    # (pecaller.c:2448-2507)
    args = (ta_si + r[:, :, None, :]).to(torch.float32)
    tail = (tota_si + (tot + r[..., 5])[..., None]).to(torch.float32)
    like = a1_si + torch.lgamma(args).sum(-1) - torch.lgamma(tail)

    g = torch.arange(max_gen, device=r.device)
    is_ref = g == ref_b[..., None]                    # (S, 1, G)
    neg = float("-inf")
    like_ref = torch.where(is_ref, like, neg).amax(-1)
    # fill_config_probs never expands indel genotypes without >=3
    # supporting reads (pecaller.c:2621-2625: templ -= 1e10 for j in
    # {4,12} when reads[Del]<3, {5,13} when reads[Ins]<3), so they are
    # excluded from the beam-survival margin.
    is_del_g = (g == 4) | (g == 12)
    is_ins_g = (g == 5) | (g == 13)
    blocked = ((is_del_g & (r[..., 4:5] < 3)) |
               (is_ins_g & (r[..., 5:6] < 3)))        # (S, I, G)
    like_alt = torch.where(is_ref | blocked, neg, like).amax(-1)
    samp_easy = (like_ref - like_alt) > _BEAM_T

    if indiv >= 4:
        # with >=4 samples the EM loop continues whenever any sample's
        # pass-1 argmax (over ALL genotypes, ungated:
        # pecaller.c:2484-2486) differs from the final call, so EASY
        # additionally requires the ungated argmax to be the ref
        # genotype by more than the f32 error band.
        like_any = torch.where(is_ref, neg, like).amax(-1)
        samp_easy &= (like_ref - like_any) > _ANY_T

    samp_easy = (~active) | samp_easy
    depth_ok = ((tot + r[..., 5]) <= DEPTH_GATE).all(-1)
    easy = samp_easy.all(-1) & depth_ok

    codes = torch.where(bad, BAD, torch.where(easy, EASY, HARD))
    # non-ACGT reference: the screened likelihoods used a clamped ref
    # row and the EASY/BAD shortcuts assume call==ref semantics — route
    # unconditionally to the exact native engine
    codes = torch.where(ref_raw >= 4, HARD, codes)
    return codes.to(torch.uint8)


class _Stage:
    """One chunk's pinned staging set: its counts, references and
    chromosome types going up, its codes coming back, and the events
    recorded behind its fetch."""

    def __init__(self, chunk: int, indiv: int, pin: bool):
        self.rd = torch.empty((chunk, indiv, 6), dtype=torch.int16,
                              pin_memory=pin)
        self.ri = torch.empty(chunk, dtype=torch.uint8, pin_memory=pin)
        self.ct = torch.empty(chunk, dtype=torch.uint8, pin_memory=pin)
        self.out = torch.empty(chunk, dtype=torch.uint8, pin_memory=pin)
        self.events = []
        self.span = None                # (lo, m) of the chunk in flight

    def fill(self, reads16, ref_int, ctype, lo: int, m: int, ck: int):
        """Sites [lo, lo + m) into the first ``m`` rows, zero counts
        (and reference 0, ctype 0) in the rest of the ``ck``-site
        bucket."""
        for buf, src in ((self.rd, reads16), (self.ri, ref_int),
                         (self.ct, ctype)):
            h = buf.numpy()
            h[:m] = src[lo:lo + m]
            h[m:ck] = 0

    def drain(self, out: np.ndarray) -> None:
        """Wait for the chunk's codes and copy its first ``m`` to
        ``out``."""
        for ev in self.events:
            ev.synchronize()
        lo, m = self.span
        out[lo:lo + m] = self.out.numpy()[:m]
        self.events, self.span = [], None


class CallerScreen:
    """Chunked site screen on one torch device, or over a device mesh.
    Call with host numpy arrays; codes come back as numpy.

    The counterpart of the JAX package's jitted screen.  The tables go
    to each device once.  A chunk (2^21 / indiv sites, a power of two in
    [2^13, 2^18], bounding the (S, I, 14, 6) f32 working set) is padded
    with zero counts into its shape bucket (a power of two from
    ``MIN_CHUNK`` = 2^10 up to the chunk), and each (phase, bucket) runs
    as a ``mapper.program.StepProgram`` (``self.programs``): on a card a
    CUDA graph captured at the key's second call, so that the windows'
    ``phase1`` calls of varying sizes reuse at most ``log2(chunk) - 9``
    programs a phase.  Its inputs are the three staged tensors, its
    output the bucket's uint8 codes.  Up to ``MAX_PEND`` = 3 chunks are
    in flight, each from a pinned staging set of its own (counts up,
    codes back); a set is refilled only once the events recorded behind
    its chunk's fetch have completed.

    All of a screen's programs on one device share one graph pool: they
    replay one at a time on the device's current stream, and each
    replay's codes are copied out (a non-blocking copy into the stage's
    pinned row) before the next replay is enqueued.

    With ``mesh`` (``parallel.mesh.make_mesh``) a bucket's sites split
    into contiguous parts, one a mesh device, and the parts' codes are
    concatenated: the screen is independent per site.  Where every mesh
    device is the same one, one program a key holds every part;
    otherwise each part is a program of its own on its device and the
    codes meet in the stage's row.  ``graph=False`` runs the programs'
    steps eagerly on the same buckets.  ``sites`` counts the sites
    each phase took on the devices.
    """

    MIN_CHUNK = 1 << 10
    MAX_PEND = 3

    def __init__(self, indiv: int, haploid: bool, chunk: int | None = None,
                 mesh=None, device=None, graph: bool = True):
        self.devices = (mesh.flat if mesh is not None
                        else [resolve_device(device)])
        self.indiv = indiv
        self.haploid = haploid
        self.graph = graph
        if chunk is None or chunk <= 8192:
            # ~ (1<<21) site*samples per chunk, pow2, within [2^13,2^18]
            c = (1 << 21) // max(indiv, 1)
            c = 1 << (c.bit_length() - 1)
            chunk = max(1 << 13, min(1 << 18, c))
        self.chunk = chunk
        ta, tota, a1 = _tables(haploid)
        n_sc, _, G, _ = ta.shape
        host = dict(ta=torch.from_numpy(ta.reshape(n_sc * 4, G, 6)),
                    tota=torch.from_numpy(tota.reshape(n_sc * 4, G)),
                    a1=torch.from_numpy(a1.reshape(n_sc * 4, G)),
                    ptab=torch.from_numpy(_phase0_tables(haploid)))
        uniq = list(dict.fromkeys(self.devices))
        self._tabs = {d: {k: v.to(d) for k, v in host.items()}
                      for d in uniq}
        self._pools = {d: torch.cuda.graph_pool_handle() for d in uniq
                       if d.type == "cuda"}
        self._pin = bool(self._pools)
        self._ring = None
        self.programs = {}
        self.sites = {"phase0": 0, "phase1": 0}

    def _fn(self, phase: str, dev):
        """The chunk function of ``phase`` with ``dev``'s tables."""
        t = self._tabs[dev]
        if phase == "phase0":
            return functools.partial(_phase0_chunk, haploid=self.haploid,
                                     indiv=self.indiv, ptab=t["ptab"])
        return functools.partial(_screen_chunk, haploid=self.haploid,
                                 ta=t["ta"], tota=t["tota"], a1=t["a1"])

    def _bucket(self, m: int) -> int:
        b = self.MIN_CHUNK
        while b < m:
            b <<= 1
        return min(b, self.chunk)

    def _programs_for(self, phase: str, ck: int) -> list:
        """(program, lo, hi) of each part of a ``ck``-site bucket."""
        key = (phase, ck)
        if key not in self.programs:
            P = len(self.devices)
            cuts = [ck * p // P for p in range(P + 1)]
            if len(set(self.devices)) == 1:
                dev = self.devices[0]
                fn = self._fn(phase, dev)

                def step(rd, ri, ct):
                    return torch.cat([fn(rd[a:b], ri[a:b], ct[a:b])
                                      for a, b in zip(cuts, cuts[1:])])
                self.programs[key] = [(StepProgram(
                    step, dev, graph=self.graph,
                    pool=self._pools.get(dev)), 0, ck)]
            else:
                self.programs[key] = [
                    (StepProgram(self._fn(phase, d), d, graph=self.graph,
                                 pool=self._pools.get(d)), a, b)
                    for d, a, b in zip(self.devices, cuts, cuts[1:])]
        return self.programs[key]

    def program_stats(self) -> dict:
        """``mapper.program.capture_stats`` over every program."""
        return capture_stats([p for parts in self.programs.values()
                              for p, _, _ in parts])

    def _run(self, phase, reads, ref_int, ctype) -> np.ndarray:
        """``phase`` over the chunks of host arrays: uint16 counts up as
        int16 bits from the staging sets, each chunk in its bucket's
        programs, uint8 codes back, ``MAX_PEND`` chunks in flight."""
        n = len(ref_int)
        out = np.empty(n, dtype=np.uint8)
        if self._ring is None:
            self._ring = [_Stage(self.chunk, self.indiv, self._pin)
                          for _ in range(self.MAX_PEND)]
        reads16 = reads.view(np.int16)
        for k, lo in enumerate(range(0, n, self.chunk)):
            st = self._ring[k % self.MAX_PEND]
            if st.span is not None:
                st.drain(out)
            m = min(n - lo, self.chunk)
            ck = self._bucket(m)
            st.fill(reads16, ref_int, ctype, lo, m, ck)
            for prog, a, b in self._programs_for(phase, ck):
                codes = prog([(st.rd[a:b], st.ri[a:b], st.ct[a:b])])[0]
                st.out[a:b].copy_(codes, non_blocking=True)
                if prog.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(prog.device))
                    st.events.append(ev)
            st.span = (lo, m)
        for st in self._ring:
            if st.span is not None:
                st.drain(out)
        return out

    def __call__(self, reads: np.ndarray, ref_int: np.ndarray,
                 ctype: np.ndarray) -> np.ndarray:
        """reads (S,I,6) u16, ref_int (S,) u8, ctype (S,) u8 -> codes.

        Two passes: the integer/table phase 0 resolves simple sites (one
        byte gather per sample, exact-f64 tables); only UNRES sites
        reach the f32 lgamma screen (phase 1)."""
        out = self.phase0(reads, ref_int, ctype)
        un = np.flatnonzero(out == UNRES)
        if len(un):
            out[un] = self.phase1(reads[un], ref_int[un], ctype[un])
        return out

    def phase0(self, reads: np.ndarray, ref_int: np.ndarray,
               ctype: np.ndarray) -> np.ndarray:
        """The integer phase 0 alone: EASY/BAD/HARD codes, UNRES for the
        sites phase 1 must decide."""
        out = self._run("phase0", reads, ref_int, ctype)
        self.sites["phase0"] += len(out)
        return out

    def phase1(self, reads: np.ndarray, ref_int: np.ndarray,
               ctype: np.ndarray) -> np.ndarray:
        """The f32 lgamma screen alone, for sites phase 0 (on the device
        or the host native phase 0 in native/screen.c) left UNRES.
        Returns EASY/BAD/HARD codes."""
        out = self._run("phase1", reads, ref_int, ctype)
        self.sites["phase1"] += len(out)
        return out
