"""The joint-configuration beam on a torch device with its exact float64
finisher: the caller's hard sites (pecaller.c fill_config_probs /
clean_config_probs, :2511-2788 and :2248-2344) vectorized over sites.

Counterpart of ``pecaller_tpu/caller/device_beam.py``.  Division of
labor (byte parity preserved by construction):

  * The DEVICE BEAM (f32, ``_beam_chunk``, torch on the tensors'
    device, one device program a chunk in ``DeviceBeam``) runs the
    exact pass-1 search semantics vectorized over sites: per-sample
    likelihoods, confidence ordering, config expansion x genotypes with
    the indel-support gates, dedup of configs identical outside the
    current sample, the 2.3 log-unit prune, and the
    forced-homozygote reinjection.  Its product is the per-site
    SURVIVING CONFIG SET (a (C_CAP, indiv) genotype matrix in sorted
    order): structure only, no float that reaches an artifact.
  * The F64 FINISHER (``finish_f64``, numpy on the host) recomputes
    likes / priors / posts for that set with the native engine's
    float64 operation sequence (NR gammln tables, sequential summation
    order, config-order softmax), then types the site, so printed
    posteriors are bit-identical to the native engine whenever the
    config set is right.
  * FLAGS route every site where f32 cannot prove the set to the exact
    native engine: decisions within BAND of the 2.3 / 0.01 survival
    thresholds, near-ties in sample ordering or the top config,
    beam-width overflow, the exp(-40) softmax cutoff, depths past the
    screen's f32 lgamma gate, and (indiv >= 4) any site where the EM
    loop would run a second pass (calls_changed, pecaller.c:1505-1509).
    Pedigree mode and mixed-haploid sites always take the native engine.

The beam's f32 ``lgamma`` and the order of its f32 sums are torch's, not
XLA's: flags absorb exactly that difference, so the contract is stated
on the sites a beam leaves unflagged (their finished outputs equal the
native engine's bitwise), not as equal flags.

The beam search collapses to set semantics because every sequential
running-best gate in fill_config_probs is implied by the final prune:
a candidate with post >= final_best - 2.3 always passed the running
``templ + thres > best_post`` and post-keep gates (prior <= 0, running
best <= final best), so the surviving set equals {candidates: post >=
final_best - 2.3} capped to MAX_CONFIGS in (post desc, allocation
order), which is what the vectorized prune computes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from ..mapper.program import StepProgram
from .device_model import fill_alpha_prior_np
from .device_screen import DEPTH_GATE, _tables

NO_ALLELES = 6
MAX_GEN = 14
THRES = 2.3
BAND = 0.05          # f32 slack around every beam threshold
ORDER_BAND = 1e-3    # f32 slack for sample-confidence ordering ties

# flag bits
F_BOUNDARY = 1       # a survival decision within BAND of a threshold
F_OVERFLOW = 2       # beam width exceeded C_CAP
F_ORDER = 4          # sample-order near-tie
F_EM = 8             # indiv >= 4 and the EM would run another pass
F_EXP = 16           # a post within BAND of the exp(-40) cutoff
F_REF = 32           # non-ACGT reference
F_TIE = 64           # near-tied genotype likes within one sample
F_DEEP = 128         # depth past the f32 lgamma error gate


def _get_het(i, ref):
    ha = [0, 0, 0, 1, 1, 2]
    hb = [1, 2, 3, 2, 3, 3]
    if i < NO_ALLELES:
        return i, i
    if i < 12:
        return ha[i - 6], hb[i - 6]
    if i == 12:
        return ref, 4
    return ref, 5


def allele_counts_tab(haploid: bool) -> np.ndarray:
    """(4, MAX_GEN+1, 6) int32: per-(ref, genotype) allele contributions
    (native/pecall.c model init; row MAX_GEN = NCALL = zero)."""
    t = np.zeros((4, MAX_GEN + 1, NO_ALLELES), np.int32)
    for r in range(4):
        for g in range(MAX_GEN):
            a, b = _get_het(g, r)
            t[r, g, a] += 1
            if not haploid:
                t[r, g, b] += 1
    return t


_DIP_ORDER = np.array([
    [0, 7, 6, 8, 12, 13, 1, 2, 3, 4, 5, 9, 10, 11],
    [1, 10, 6, 9, 12, 13, 0, 2, 3, 4, 5, 7, 8, 11],
    [2, 7, 9, 11, 12, 13, 0, 1, 3, 4, 5, 6, 8, 10],
    [3, 10, 8, 11, 12, 13, 1, 0, 2, 4, 5, 6, 7, 9]], np.int32)
_HAP_ORDER = np.array([
    [0, 2, 1, 3, 4, 5], [1, 3, 0, 2, 4, 5],
    [2, 0, 1, 3, 4, 5], [3, 1, 0, 2, 4, 5]], np.int32)


@functools.lru_cache(maxsize=8)
def fill_hardy_weinberg_np(n: int):
    """Exact replication of fill_hardy_weinberg (pecaller.c:2791-2866 /
    native/pecall.c:103-141) in python-float (= C double) arithmetic.
    Returns (2n+1, n+1) float64 log-probabilities."""
    asize = 2 * n
    marg = [[0.0] * (n + 1) for _ in range(asize + 1)]
    for i in range(1, asize + 1):
        Na = 2 * n - i
        Nb = i
        p = float(i) / float(Na + Nb)
        expect = int(math.ceil(i * (1.0 - p)))
        if i % 2 == 0:
            start = expect - 1 if expect % 2 == 1 else expect
        else:
            start = expect if expect % 2 == 1 else expect - 1
        marg[i][start] = 1.0
        s = 1.0
        nbb = (Nb - start) // 2
        naa = (Na - start) // 2
        nab = start + 2
        while naa > 0 and nbb > 0:
            marg[i][nab] = (marg[i][nab - 2] * 4.0 *
                            (float(naa) * float(nbb)) /
                            (float(nab) * (nab - 1.0)))
            s += marg[i][nab]
            nab += 2
            naa -= 1
            nbb -= 1
        nbb = (Nb - start) // 2
        naa = (Na - start) // 2
        nab = start - 2
        while nab >= 0:
            marg[i][nab] = (marg[i][nab + 2] *
                            ((nab + 2.0) * (nab + 1.0)) /
                            (4.0 * ((naa + 1.0) * (nbb + 1.0))))
            s += marg[i][nab]
            nab -= 2
            naa += 1
            nbb += 1
        for j in range(n + 1):
            marg[i][j] /= s
    out = np.full((asize + 1, n + 1), -5000.0)
    for i in range(asize + 1):
        for j in range(n + 1):
            if marg[i][j] > 1e-50:
                out[i][j] = math.log(marg[i][j])
    return out


@functools.lru_cache(maxsize=8)
def hw_flat(indiv: int):
    """Flattened ln_HW for n = 1..indiv + per-n offsets.
    Index: off[n] + minor * (n + 1) + hets."""
    parts, off = [], np.zeros(indiv + 2, np.int64)
    for n in range(1, indiv + 1):
        t = fill_hardy_weinberg_np(n)
        off[n + 1] = off[n] + t.size
        parts.append(t.reshape(-1))
    if not parts:
        return np.zeros(1), off
    return np.concatenate(parts), off


# --- exact NR gammln / factln (native/pecall.c:62-90) --------------------

_COF = (76.18009173, -86.50532033, 24.01409822, -1.231739516,
        0.120858003e-2, -0.536382e-5)


def _gammln_scalar(xx: float) -> float:
    x = xx - 1.0
    tmp = x + 5.5
    tmp -= (x + 0.5) * math.log(tmp)
    ser = 1.0
    for c in _COF:
        x += 1.0
        ser += c / x
    return -tmp + math.log(2.50662827465 * ser)


@functools.lru_cache(maxsize=1)
def factln_tbl():
    t = np.zeros(10001)
    x = 1.0
    for n in range(2, 41):
        x *= float(n)
        t[n] = math.log(x)
    for n in range(41, 10001):
        t[n] = _gammln_scalar(n + 1.0)
    return t


_gammln_u = np.frompyfunc(_gammln_scalar, 1, 1)


def factln_np(n: np.ndarray) -> np.ndarray:
    """Vectorized m_factln: table below 10001, NR gammln above."""
    t = factln_tbl()
    n = np.asarray(n)
    out = t[np.minimum(n, 10000)]
    big = n > 10000
    if big.any():
        out = out.copy()
        out[big] = _gammln_u(n[big] + 1.0).astype(np.float64)
    return out


# --- the device beam -----------------------------------------------------

def _prior_of(ac, hets, *, haploid, ln_theta, hw, hw_off):
    """theta + exact-HW prior (f32) from integer allele counts ``ac``
    (..., 6) and het counts ``hets`` (...)."""
    na = (ac > 0).sum(-1)
    pr = torch.where(na > 1, (na - 1).to(torch.float32) * ln_theta,
                     0.0)
    if not haploid:
        major = ac.gather(-1, ac.argmax(-1, keepdim=True))[..., 0]
        minor = ac.sum(-1) - major
        swap = minor > major
        mj = torch.where(swap, minor, major)
        mn = torch.where(swap, major, minor)
        h = torch.minimum(mn, hets)
        tot_n = torch.div(mn + mj, 2, rounding_mode="floor")
        mn = torch.where((mn - h) % 2 == 1, mn + 1, mn)
        idx = (hw_off[tot_n.clamp(0, hw_off.shape[0] - 2).long()]
               + mn * (tot_n + 1) + h)
        hwv = hw[idx.clamp(0, hw.shape[0] - 1)]
        pr = pr + torch.where(na > 1, hwv, 0.0)
    return pr


def _beam_chunk(reads, ref_int, *, haploid, indiv, c_cap, tabs, threshold):
    """One chunk on the tensors' device: reads (S, I, 6) int16 bits of
    uint16 counts, ref_int (S,) uint8.  ``tabs``: ``DeviceBeam``'s tables
    on that device.  Returns (n_cfg (S,) int32, cfgs (S, C, I) int8,
    flags (S,) int32, call32 (S, I) int8, p32 (S, I) f32, hrank (S, C)
    int16, hval (S, C) int8).  See the module doc."""
    G = NO_ALLELES if haploid else MAX_GEN
    NCALL = G
    min_depth = 1 if haploid else 2
    S = reads.shape[0]
    I = indiv
    C = c_cap
    dev = reads.device
    f32, i32 = torch.float32, torch.int32
    ninf = float("-inf")
    ar_c = torch.arange(C, device=dev)
    ar_i = torch.arange(I, device=dev)
    ar_s = torch.arange(S, device=dev)
    ln_theta = tabs["ln_theta"]
    prior_of = functools.partial(_prior_of, haploid=haploid,
                                 ln_theta=ln_theta, hw=tabs["hw"],
                                 hw_off=tabs["hw_off"])

    r = reads.to(i32) & 0xFFFF                      # (S, I, 6)
    tot = r[..., :5].sum(-1)                        # (S, I)
    active = tot > min_depth
    ref_raw = ref_int.to(torch.int64)
    ref_b = ref_raw.clamp(max=3)

    # pass-1 likelihoods sans multinomial coef (cancels in every
    # comparison; the f64 finisher restores it)
    sc_idx = tot.clamp(10, 100) - 10
    flat = (sc_idx * 4 + ref_b[:, None]).to(torch.int64)      # (S, I)
    args = (tabs["ta"][flat] + r[:, :, None, :]).to(f32)
    tail = (tabs["tota"][flat] + (tot + r[..., 5])[..., None]).to(f32)
    like = (tabs["a1"][flat] + torch.lgamma(args).sum(-1)
            - torch.lgamma(tail))                   # (S, I, G)

    # confidence order (fill_sample_like tail): initial_p = margin of
    # the argmax over its closest competitor; stable sort desc
    best_g = like.argmax(-1)
    like_best = like.gather(-1, best_g[..., None])[..., 0]
    g_ar = torch.arange(G, device=dev)
    margin = torch.where(g_ar == best_g[..., None], float("inf"),
                         like_best[..., None] - like).amin(-1)
    initial_p = torch.where(active, margin, 0.0)
    order = torch.argsort(-initial_p, dim=-1, stable=True)    # (S, I)
    # order near-ties between samples with distinct read vectors (equal
    # vectors give bit-identical f64 margins, so stable order matches)
    same_reads = (r[:, :, None, :] == r[:, None, :, :]).all(-1)
    diff_p = (initial_p[:, :, None] - initial_p[:, None, :]).abs()
    eye = torch.eye(I, dtype=torch.bool, device=dev)
    pair_bad = (diff_p < ORDER_BAND) & ~same_reads & ~eye
    flags = torch.where(pair_bad.any(2).any(1), F_ORDER, 0)
    flags = flags | torch.where(ref_raw >= 4, F_REF, 0)
    # the screen routes tot+Ins > DEPTH_GATE sites HARD because f32
    # lgamma error there exceeds the fixed BAND: just as unsafe for the
    # f32 beam, so they go to the native engine
    flags = flags | torch.where(
        ((tot + r[..., 5]) > DEPTH_GATE).any(-1), F_DEEP, 0)

    ac_d = tabs["ac"]                               # (4, MAX_GEN+1, 6)
    like_pad = torch.cat([like, like.new_zeros((S, I, 1))], -1)  # NCALL=0

    # beam state: configs (S, C, I) int8 (sorted), n_cfg, plus each
    # config's fresh-sum origin: the C engine builds config likes
    # INCREMENTALLY (old.like - like[j_old] + like[j]) from either the
    # initial all-dom config or a reinjected homozygote, and float64
    # addition is not associative, so the exact finisher must replay
    # the same sequence: hrank = rank at which the config's ancestor
    # was fresh-summed (-1 = initial), hval = that ancestor's genotype
    calls = torch.where(active, ref_b[:, None], NCALL).to(torch.int8)
    calls = calls[:, None, :].expand(S, C, I).contiguous()
    n_cfg = torch.ones(S, dtype=i32, device=dev)
    # int16: cohorts past 127 samples would wrap an int8 rank
    hrank = torch.full((S, C), -1, dtype=torch.int16, device=dev)
    hval = ref_b.to(torch.int8)[:, None].expand(S, C).contiguous()
    like_cfg_src = like_pad[:, None].expand(S, C, I, G + 1)

    def cfg_like_of(calls_m):
        """Sum of active samples' like at each config's calls:
        fill_config_like (native/pecall.c:363-371)."""
        lk = like_cfg_src.gather(3, calls_m.long()[..., None])[..., 0]
        return torch.where(active[:, None, :], lk, 0.0).sum(-1)

    def counts_of(calls_m):
        """Integer allele counts (S, C, 6) and het counts (S, C) of the
        active samples' calls."""
        m = active[:, None, :] & (calls_m < NCALL)
        rows = ac_d[ref_b[:, None, None], calls_m.long()]   # (S, C, I, 6)
        ac = torch.where(m[..., None], rows, 0).sum(2, dtype=i32)
        hets = (m & (calls_m >= NO_ALLELES)).sum(-1, dtype=i32)
        return ac, hets

    boundary = torch.zeros(S, dtype=torch.bool, device=dev)
    overflow = torch.zeros(S, dtype=torch.bool, device=dev)
    jv = tabs["gorder"][ref_b]                      # (S, G) genotype vals
    jv_l = jv.long()
    is_del_g = (jv == 4) | (jv == 12)
    is_ins_g = (jv == 5) | (jv == 13)
    ac_j = ac_d[ref_b[:, None], jv_l]               # (S, G, 6)
    tri = ar_c[:, None] > ar_c[None, :]             # (C, C)

    for rank in range(I):
        s_idx = order[:, rank]                      # (S,)
        act_s = active[ar_s, s_idx]
        like_s = like_pad[ar_s, s_idx]              # (S, G+1)
        reads_s = r[ar_s, s_idx]                    # (S, 6)
        valid_c = ar_c[None, :] < n_cfg[:, None]
        sel_slot = ar_i[None, None, :] == s_idx[:, None, None]

        # dedup: config i skipped if an earlier ii matches outside s
        eq = (calls[:, :, None, :] == calls[:, None, :, :]) \
            | sel_slot[:, None]
        eq_all = eq.all(-1) & valid_c[:, :, None] & valid_c[:, None, :]
        dup = (eq_all & tri).any(-1)                # (S, C)
        kept = valid_c & ~dup

        # candidate posts over genotype_order
        old_call = calls.gather(
            2, s_idx[:, None, None].expand(S, C, 1))[..., 0].long()
        base_like = cfg_like_of(calls) \
            - like_s.gather(1, old_call) * act_s[:, None].to(f32)
        like_j = like_s.gather(1, jv_l)             # (S, G)
        templ = base_like[:, :, None] + like_j[:, None, :]   # (S, C, G)
        gate = (torch.where(is_del_g & (reads_s[:, 4:5] < 3), -1e10, 0.0)
                + torch.where(is_ins_g & (reads_s[:, 5:6] < 3), -1e10,
                              0.0))                 # (S, G)
        templ = templ + gate[:, None, :]

        # candidate integer metadata: the config's counts without
        # sample s, plus genotype j's
        act_not_s = active & (ar_i[None, :] != s_idx[:, None])
        m_ns = act_not_s[:, None, :] & (calls < NCALL)
        base_ac = torch.where(m_ns[..., None],
                              ac_d[ref_b[:, None, None], calls.long()],
                              0).sum(2, dtype=i32)  # (S, C, 6)
        base_hets = (m_ns & (calls >= NO_ALLELES)).sum(-1, dtype=i32)
        cand_ac = base_ac[:, :, None, :] + ac_j[:, None, :, :]
        cand_hets = base_hets[:, :, None] \
            + (jv >= NO_ALLELES)[:, None, :].to(i32)
        post = templ + prior_of(cand_ac, cand_hets)         # (S, C, G)
        cand_ok = kept[:, :, None] & act_s[:, None, None]

        best = torch.where(cand_ok, post, ninf).amax((1, 2))
        cut = (best - THRES)[:, None, None]
        surv = cand_ok & (post >= cut)
        boundary = boundary | (cand_ok & ((post - cut).abs() < BAND)) \
            .any(2).any(1)

        # sort survivors by (post desc, enum asc), take C
        post_f = torch.where(surv, post, ninf).reshape(S, C * G)
        sort_ix = torch.argsort(-post_f, dim=1, stable=True)[:, :C]
        n_new = surv.sum((1, 2), dtype=i32)
        overflow = overflow | (n_new > C)
        ci = torch.div(sort_ix, G, rounding_mode="floor")
        ji = sort_ix % G
        new_calls = calls.gather(1, ci[:, :, None].expand(S, C, I))
        new_hrank = hrank.gather(1, ci)
        new_hval = hval.gather(1, ci)
        jval = jv.gather(1, ji).to(torch.int8)
        new_calls = torch.where(sel_slot, jval[:, :, None], new_calls)
        new_n = n_new.clamp(max=C)

        # inactive sample: no expansion, calls[s] = NCALL everywhere
        calls_na = torch.where(sel_slot, NCALL, calls).to(torch.int8)
        a2 = act_s[:, None]
        calls = torch.where(a2[..., None], new_calls, calls_na)
        hrank = torch.where(a2, new_hrank, hrank)
        hval = torch.where(a2, new_hval, hval)
        n_cfg = torch.where(act_s, new_n, n_cfg)

        # hom reinjection (clean_config_probs tail)
        valid_c = ar_c[None, :] < n_cfg[:, None]
        ac_all, _ = counts_of(calls)
        na_all = (ac_all > 0).sum(-1)
        has_hom = ((na_all == 1) & valid_c).any(1)
        best_hom = ac_all[:, 0, :].argmax(-1)
        best_hom = torch.where(best_hom > 3, ref_b, best_hom) \
            .to(torch.int8)
        hom_calls = torch.where(active, best_hom[:, None],
                                NCALL).to(torch.int8)       # (S, I)
        inject = act_s & ~has_hom
        slot = n_cfg.clamp(max=C - 1)
        overflow = overflow | (inject & (n_cfg >= C))
        inj_slot = inject[:, None] & (ar_c[None, :] == slot[:, None])
        calls = torch.where(inj_slot[:, :, None], hom_calls[:, None, :],
                            calls)
        hrank = torch.where(inj_slot, rank, hrank).to(torch.int16)
        hval = torch.where(inj_slot, best_hom[:, None], hval)
        n_cfg = torch.where(inject, (n_cfg + 1).clamp(max=C), n_cfg)
        # stable resort including the injected config (enum = last)
        valid_c = ar_c[None, :] < n_cfg[:, None]
        ac_all, hets_all = counts_of(calls)
        pr_all = torch.where(inj_slot, 0.0, prior_of(ac_all, hets_all))
        post_all = torch.where(valid_c, cfg_like_of(calls) + pr_all, ninf)
        res_ix = torch.argsort(-post_all, dim=1, stable=True)
        calls = calls.gather(1, res_ix[:, :, None].expand(S, C, I))
        hrank = hrank.gather(1, res_ix)
        hval = hval.gather(1, res_ix)
        top2 = post_all.topk(2, dim=1).values
        boundary = boundary | ((n_cfg > 1) &
                               ((top2[:, 0] - top2[:, 1]).abs() < BAND))

    # final posts + f32 posteriors (diagnostics + EM-continuation flag)
    valid_c = ar_c[None, :] < n_cfg[:, None]
    ac_all, hets_all = counts_of(calls)
    post_all = torch.where(valid_c,
                           cfg_like_of(calls) + prior_of(ac_all, hets_all),
                           ninf)
    mx = post_all.amax(1)
    d = post_all - mx[:, None]
    expd = torch.where(d > -40.0, d.exp(), 0.0)
    flags = flags | torch.where(
        (valid_c & ((d + 40.0).abs() < BAND)).any(1), F_EXP, 0)
    p_cfg = expd / expd.sum(1, keepdim=True)
    # a sum over configs in config order (no atomics: deterministic)
    onehot = calls.long()[..., None] == torch.arange(G + 1, device=dev)
    post_prob = (onehot * p_cfg[:, :, None, None]).sum(1)   # (S, I, G+1)
    final_call = post_prob[..., :G].argmax(-1)
    final_p = post_prob.gather(2, final_call[..., None])[..., 0]
    final_call = torch.where(active, final_call, NCALL)
    final_p = torch.where(active, final_p, 1.0)

    if indiv >= 4:
        # fill_sample_like overwrites initial_call with the per-sample
        # UNGATED ML genotype each pass (native/pecall.c:478-481), so
        # the EM-continuation test compares against that argmax, plus
        # a band for near-tied argmaxes and near-threshold posteriors
        init_call = torch.where(active, best_g, NCALL)
        changed = (active & ((final_call != init_call) |
                             (final_p < threshold - 0.01))).any(-1)
        near = (active & ((final_p - threshold).abs() < 0.01)).any(-1)
        near_arg = (active & (initial_p < ORDER_BAND)).any(-1)
        flags = flags | torch.where(changed | near | near_arg, F_EM, 0)

    # a genotype near-tied (in f32, e.g. exactly symmetric counts whose
    # f64 likes differ only by summation-order ulps) with a SURVIVING
    # call could swap into/out of the f64 set on a tie-break the beam
    # cannot see: flag any site where a survivor's call has a tied
    # partner genotype within its sample.  Pairs separated by more than
    # the f32 evaluation error follow f64's order.
    lk_call = like_cfg_src.gather(3, calls.long()[..., None])  # (S,C,I,1)
    d_t = (like[:, None, :, :] - lk_call).abs()                # (S,C,I,G)
    tie_band = 4e-7 * lk_call.abs() + 1e-5
    n_near = (d_t <= tie_band).sum(-1)
    tied = ((n_near > 1) & valid_c[:, :, None] & active[:, None, :]
            & (calls < NCALL)).any(2).any(1)
    flags = flags | torch.where(tied, F_TIE, 0)

    flags = flags | torch.where(boundary, F_BOUNDARY, 0)
    flags = flags | torch.where(overflow, F_OVERFLOW, 0)
    return (n_cfg, calls, flags.to(i32), final_call.to(torch.int8),
            final_p.to(f32), hrank, hval)


def _packed_chunk(reads, ref_int, **kw):
    """``_beam_chunk``'s seven results packed into one (S, width) uint8
    row a site, in ``_fields`` order: the one output of the beam's
    device program."""
    S = reads.shape[0]
    return torch.cat([x.reshape(S, -1).contiguous().view(torch.uint8)
                      for x in _beam_chunk(reads, ref_int, **kw)], dim=1)


# the packed result of a chunk: (name, numpy dtype, columns a site)
def _fields(C, I):
    return (("n_cfg", np.int32, 1), ("cfgs", np.int8, C * I),
            ("flags", np.int32, 1), ("call32", np.int8, I),
            ("p32", np.float32, I), ("hrank", np.int16, C),
            ("hval", np.int8, C))


class DeviceBeam:
    """The chunked beam on one torch device (None: ``cuda:0``; raises
    where there is no card unless the CPU is named).  Call with host
    numpy arrays; returns (n_cfg, cfgs, flags, call32, p32, hrank, hval)
    as numpy, as the JAX ``DeviceBeam`` does.

    A chunk (``chunk`` sites, the last padded with zero counts) runs as
    one ``mapper.program.StepProgram`` (``self.program``, the counterpart
    of the JAX package's jitted chunk): on a card a CUDA graph captured
    at the second chunk and replayed after.  Its one output is the
    chunk's seven results packed into one byte row a site
    (``chunk_fn``).  Every chunk is enqueued before any is fetched: each
    replay's row is copied into pinned memory before the next replay
    overwrites it.  ``graph=False`` runs the chunk eagerly."""

    def __init__(self, indiv: int, haploid: bool, theta: float,
                 threshold: float, c_cap: int = 64, chunk: int = 1024,
                 device=None, graph: bool = True):
        self.device = resolve_device(device)
        self.indiv = indiv
        self.haploid = haploid
        self.threshold = threshold
        self.c_cap = c_cap
        self.chunk = chunk
        ta, tota, a1 = _tables(haploid)
        n_sc, _, G, _ = ta.shape
        hw_t, hw_off = (hw_flat(indiv) if not haploid
                        else (np.zeros(1), np.zeros(indiv + 2, np.int64)))
        host = dict(ta=ta.reshape(n_sc * 4, G, 6),
                    tota=tota.reshape(n_sc * 4, G),
                    a1=a1.reshape(n_sc * 4, G).astype(np.float32),
                    ac=allele_counts_tab(haploid),
                    gorder=_HAP_ORDER if haploid else _DIP_ORDER,
                    hw=hw_t.astype(np.float32), hw_off=hw_off,
                    ln_theta=np.float32(math.log(theta)))
        self.tabs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in host.items()}
        self.fields = _fields(c_cap, indiv)
        # the step holds the tables, not the beam: no reference cycle
        # keeps a dropped beam's graph alive until a collection
        self.chunk_fn = functools.partial(
            _packed_chunk, haploid=haploid, indiv=indiv, c_cap=c_cap,
            tabs=self.tabs, threshold=threshold)
        self.program = StepProgram(self.chunk_fn, self.device, graph=graph)

    def __call__(self, reads: np.ndarray, ref_int: np.ndarray):
        n = len(ref_int)
        I, C, K = self.indiv, self.c_cap, self.chunk
        n_pad = -(-n // K) * K
        pin = self.device.type == "cuda"
        rd = torch.zeros((n_pad, I, 6), dtype=torch.int16, pin_memory=pin)
        ri = torch.zeros(n_pad, dtype=torch.uint8, pin_memory=pin)
        rd[:n] = torch.from_numpy(np.ascontiguousarray(reads).view(np.int16))
        ri[:n] = torch.from_numpy(np.ascontiguousarray(ref_int,
                                                       dtype=np.uint8))
        width = sum(np.dtype(t).itemsize * k for _, t, k in self.fields)
        packed = torch.empty((n_pad, width), dtype=torch.uint8,
                             pin_memory=pin)
        for lo in range(0, n_pad, K):
            row = self.program([(rd[lo:lo + K], ri[lo:lo + K])])[0]
            packed[lo:lo + K].copy_(row, non_blocking=True)
        if pin:
            torch.cuda.synchronize(self.device)
        host = packed.numpy()[:n]
        res, col = [], 0
        for _, t, k in self.fields:
            w = np.dtype(t).itemsize * k
            a = np.ascontiguousarray(host[:, col:col + w]).view(t)
            col += w
            res.append(a.reshape(n) if k == 1 else a)
        n_cfg, cfgs, flags, call32, p32, hrank, hval = res
        return (n_cfg, cfgs.reshape(n, C, I), flags, call32, p32, hrank,
                hval)


# --- the exact float64 finisher ------------------------------------------

T_REF, T_SNP, T_DEL, T_INS, T_LOW, T_MULTI, T_MESS = range(7)


def finish_f64(reads, ref_int, n_cfg, cfgs, hrank, hval, *, indiv,
               haploid, theta, threshold, ctype=None):
    """Given the beam's config sets, recompute every output with the
    native engine's float64 operation sequence (call_one_site,
    native/pecall.c:783-1070, itself pecaller.c:1149-1749): identical
    factln tables, sequential sums, config-order softmax, site typing.
    Returns (calls, probs, types, acnt, active) matching
    pecall_sites_batch's per-site outputs (no-pedigree mode)."""
    S = len(ref_int)
    I = indiv
    G = NO_ALLELES if haploid else MAX_GEN
    NCALL = G
    min_depth = 1 if haploid else 2
    C = cfgs.shape[1]
    r = reads.astype(np.int64)                       # (S, I, 6)
    ref = np.minimum(ref_int.astype(np.int64), 3)
    tot = r[..., :5].sum(-1)                         # (S, I)
    active = tot > min_depth

    # bad-base gates (call_one_site, native/pecall.c:820-834): in
    # production the screen resolves these, but the finisher stays
    # self-contained: a bad site zeroes every sample
    avg = np.zeros(S)
    for i in range(I):
        avg = avg + tot[:, i]
    avg = avg / float(I)
    cnt8 = (tot >= 8).sum(1)
    CHRY = 2
    ct = np.zeros(S, np.int64) if ctype is None \
        else ctype.astype(np.int64)
    bad = (avg < 8) | ((cnt8 < 0.5 * I) & (ct != CHRY))
    active = active & ~bad[:, None]

    # per-sample multinomial coefficient, C op order
    coef = factln_np(tot)
    for ii in range(6):
        coef = coef - factln_np(r[..., ii])

    dm_all = np.stack([
        fill_alpha_prior_np(300, 150, rr)[:G].astype(np.float64)
        for rr in range(4)])
    dm_all = dm_all / dm_all.sum(axis=2, keepdims=True)   # (4, G, 6)
    t100 = np.minimum(tot, 100)
    scale = t100 * 1.0
    scale = np.where(scale < 10, 10.0, scale)
    scale = np.where(scale > 1000, 1000.0, scale)

    like = np.zeros((S, I, G + 1))
    dm = dm_all[ref]                                 # (S, G, 6)
    for j in range(G):
        lj = np.zeros((S, I))
        cj = coef.copy()
        tot_a = np.zeros((S, I), np.int64)
        tot_tot = np.zeros((S, I), np.int64)
        for ii in range(6):
            ta = np.ceil(scale * dm[:, None, j, ii]).astype(np.int64)
            ta = np.maximum(ta, 1)
            tot_a = tot_a + ta
            tot_tot = tot_tot + ta + r[..., ii]
            cj = cj - factln_np(ta - 1)
            lj = lj + factln_np(ta + r[..., ii] - 1)
        cj = cj + factln_np(tot_a - 1)
        lj = lj + cj
        lj = lj - factln_np(tot_tot - 1)
        like[:, :, j] = lj

    ac_tab = allele_counts_tab(haploid)              # (4, G..+1, 6)
    valid_c = np.arange(C)[None, :] < n_cfg[:, None]
    cf = np.where(valid_c[:, :, None], cfgs, NCALL).astype(np.int64)

    # sample confidence order (fill_sample_like tail) in exact f64: on
    # unflagged sites the f32 device order provably matches
    like_g = like[:, :, :G]
    best_g = np.argmax(like_g, -1)
    lbest = np.take_along_axis(like_g, best_g[..., None], -1)[..., 0]
    marg = np.where(np.arange(G)[None, None, :] == best_g[..., None],
                    np.inf, lbest[..., None] - like_g).min(-1)
    initial_p = np.where(active, marg, 0.0)
    order = np.argsort(-initial_p, axis=1, kind="stable")

    # replay the C engine's INCREMENTAL like construction: fresh sum at
    # the config's origin (initial all-dom or reinjected hom), then
    # (like - like[s_r][origin]) + like[s_r][call] per later rank
    bval = np.minimum(hval.astype(np.int64), G)      # (S, C)
    srange = np.arange(S)
    like_cfg = np.zeros((S, C))
    for i in range(I):
        li = like[srange[:, None], i, bval]
        like_cfg = like_cfg + np.where(active[:, i, None], li, 0.0)
    for rk in range(I):
        s_r = order[:, rk]
        act_r = active[srange, s_r]
        applies = act_r[:, None] & (rk > hrank)
        lt_old = like[srange[:, None], s_r[:, None], bval]
        c_r = np.take_along_axis(cf, s_r[:, None, None], 2)[:, :, 0]
        lt_new = like[srange[:, None], s_r[:, None], np.minimum(c_r, G)]
        like_cfg = np.where(applies, (like_cfg - lt_old) + lt_new,
                            like_cfg)

    ac = np.zeros((S, C, 6), np.int64)
    hets = np.zeros((S, C), np.int64)
    for i in range(I):
        m = active[:, i, None, None]
        ac += np.where(m, ac_tab[ref[:, None], np.minimum(cf[:, :, i],
                                                          MAX_GEN)], 0)
        hets += (active[:, i, None] & (cf[:, :, i] >= NO_ALLELES)
                 & (cf[:, :, i] < NCALL))
    na = (ac > 0).sum(-1)
    prior = np.where(na > 1, (na - 1) * math.log(theta), 0.0)
    if not haploid:
        major_k = np.argmax(ac, -1)
        major = np.take_along_axis(ac, major_k[..., None], -1)[..., 0]
        minor = ac.sum(-1) - major
        swap = minor > major
        mj = np.where(swap, minor, major)
        mn = np.where(swap, major, minor)
        h = np.minimum(mn, hets)
        tot_n = (mn + mj) // 2
        mn = np.where((mn - h) % 2 == 1, mn + 1, mn)
        hwv = np.zeros((S, C))
        need = (na > 1) & valid_c
        for n_ in np.unique(tot_n[need]):
            t = fill_hardy_weinberg_np(int(n_))
            sel = need & (tot_n == n_)
            hwv[sel] = t[mn[sel], h[sel]]
        prior = prior + np.where(need, hwv, 0.0)
    # beam-injected pure-hom configs carry prior == 0 naturally (one
    # allele -> no theta/HW term), matching clean_config_probs

    post = np.where(valid_c, prior + like_cfg, -np.inf)
    # stable re-sort by f64 post desc (device order = allocation order
    # breaks exact ties, reproducing sort_cfgs)
    res = np.argsort(-post, axis=1, kind="stable")
    post = np.take_along_axis(post, res, 1)
    cf = np.take_along_axis(cf, res[:, :, None], 1)
    valid_c = np.take_along_axis(valid_c, res, 1)

    mx = post[:, 0].copy()
    d = post - mx[:, None]
    p = np.zeros_like(d)
    vm = valid_c & (d > -40)
    p[vm] = _exp_u(d[vm]).astype(np.float64)
    tot_post = np.zeros(S)
    for c in range(C):
        tot_post = tot_post + np.where(valid_c[:, c], p[:, c], 0.0)
    p = p / tot_post[:, None]

    post_prob = np.zeros((S, I, G + 1))
    for i in range(I):
        for c in range(C):
            g = np.minimum(cf[:, c, i], G)
            np.add.at(post_prob[:, i, :], (np.arange(S), g),
                      np.where(valid_c[:, c] & active[:, i],
                               p[:, c], 0.0))
    final_call = np.argmax(post_prob[:, :, :G], -1)
    final_p = np.take_along_axis(post_prob, final_call[..., None],
                                 -1)[..., 0]
    # the artifact N code is always 14 (INT_TO_GEN), even in haploid
    # mode where the internal NCALL slot is 6
    final_call = np.where(active, final_call, 14).astype(np.int8)
    final_p = np.where(active, final_p, 1.0)

    # --- site typing (native/pecall.c:997-1050) ---
    low_base = 0.4 * avg
    low_base = np.where(low_base < 8, 8.0, low_base)
    this_ac = np.zeros((S, 6), np.int64)
    on_t = np.zeros(S, np.int64)
    off_t = np.zeros(S, np.int64)
    not_low = np.zeros(S, np.int64)
    for i in range(I):
        counted = active[:, i] & (final_p[:, i] >= threshold)
        fc = np.where(counted, final_call[:, i], MAX_GEN).astype(np.int64)
        contrib = ac_tab[ref, np.minimum(fc, MAX_GEN)]      # (S, 6)
        for k in range(6):
            hit = counted & (ref < 4) & (contrib[:, k] > 0)
            this_ac[:, k] += np.where(hit, contrib[:, k], 0)
            on_t += np.where(hit, r[:, i, k], 0)
            off_hit = counted & ~hit & \
                ((k != ref) | (fc != NO_ALLELES - 1))
            off_t += np.where(off_hit, r[:, i, k], 0)
        not_low += (counted & (tot[:, i] > low_base)
                    & (final_call[:, i] != ref))
    na_s = (this_ac > 0).sum(-1)
    isdel = this_ac[:, 4] > 0
    isins = this_ac[:, 5] > 0
    issnp_base = np.zeros(S, np.int64)
    for k in range(4):
        issnp_base |= (this_ac[:, k] > 0) & (k != ref)
    types = np.where(issnp_base, T_SNP, T_REF)
    ref_ac = np.take_along_axis(this_ac, ref[:, None], 1)[:, 0]
    multi = (na_s > 1) | ((na_s > 0) & (ref_ac < 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        mess = multi & (off_t / np.maximum(on_t + off_t, 1) > 0.15)
    t2 = np.where(na_s > 2, T_MULTI,
                  np.where(not_low > 0,
                           np.where(isdel, T_DEL,
                                    np.where(isins, T_INS, T_SNP)),
                           T_LOW))
    types = np.where(multi, np.where(mess, T_MESS, t2), types)
    return (final_call, final_p, types.astype(np.uint8),
            this_ac.astype(np.int32), active.astype(np.uint8))


_exp_u = np.frompyfunc(math.exp, 1, 1)
