"""ctypes wrapper for the native exact caller engine (native/pecall.c),
the row formatters (native/rowfmt.c) and the window merge and host
phase-0 screen (native/screen.c), built into build/native/.

Counterpart of ``pecaller_tpu/caller/native.py``."""

from __future__ import annotations

import ctypes

import numpy as np

from ..native.build import build_library, ptr

_SRCS = ["pecall.c", "rowfmt.c", "screen.c"]
_LIB = None
_KEEPALIVE = []


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library("pecall", _SRCS))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pecall_model_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, i32p, i32p, i32p]
    lib.pecall_model_create.restype = ctypes.c_void_p
    lib.pecall_model_destroy.argtypes = [ctypes.c_void_p]
    lib.pecall_sites_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), i32p, i32p,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.pecall_sites_batch.restype = None
    lib.format_base_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64]
    lib.format_base_rows.restype = ctypes.c_int64
    lib.format_base_runs.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.format_base_runs.restype = ctypes.c_int64
    lib.format_slow_rows.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.format_slow_rows.restype = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.merge_window.argtypes = [
        i64p, u16p, i64p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_int32), i64p, u16p,
        u8p]
    lib.merge_window.restype = ctypes.c_int64
    lib.screen_stats_window.argtypes = [
        u16p, u8p, u8p, u8p, u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, u8p, ctypes.POINTER(ctypes.c_int8), u8p, i64p,
        i64p, i64p, i64p]
    lib.screen_stats_window.restype = None
    _LIB = lib
    return lib


def host_screen_stats(reads, present, ref_int, ctype, ptab, indiv,
                      haploid, nthreads, hist, mean_sum, max_cov,
                      base_count, codes=None, out_calls=None,
                      out_active=None):
    """Fused host phase-0 screen + coverage stats (native/screen.c).
    reads (S,I,6) u16 C-contig, present (S,I) u8/bool, ref_int/ctype
    (S,) u8.  Accumulates stats in place (int64 arrays); returns
    (codes, out_calls, out_active) — EASY rows carry call/active, all
    other rows the 'N 1'/inactive defaults.  Pass preallocated outputs
    to reuse window buffers."""
    from .device_screen import TMAX, CMAX
    lib = _lib()
    S = len(ref_int)
    if codes is None:
        codes = np.empty(S, np.uint8)
        out_calls = np.empty((S, indiv), np.int8)
        out_active = np.empty((S, indiv), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.screen_stats_window(
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        present.ctypes.data_as(u8p), ref_int.ctypes.data_as(u8p),
        ctype.ctypes.data_as(u8p), ptab.ctypes.data_as(u8p),
        S, indiv, 1 if haploid else 0, TMAX, CMAX,
        1 if indiv >= 4 else 0, nthreads, codes.ctypes.data_as(u8p),
        out_calls.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        out_active.ctypes.data_as(u8p), hist.ctypes.data_as(i64p),
        mean_sum.ctypes.data_as(i64p), max_cov.ctypes.data_as(i64p),
        base_count.ctypes.data_as(i64p))
    return codes, out_calls, out_active


def format_base_rows(frag: bytes, pos, refc, calls, active) -> bytes:
    """C-speed bulk formatting of .base rows whose posteriors are all
    exactly 1 (screen-resolved sites).  pos i64, refc u8, calls (n,I)
    i8, active (n,I) u8 -> row bytes (each row starts with '\\n')."""
    lib = _lib()
    n, indiv = calls.shape
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    refc = np.ascontiguousarray(refc, dtype=np.uint8)
    calls = np.ascontiguousarray(calls, dtype=np.int8)
    active = np.ascontiguousarray(active, dtype=np.uint8)
    cap = int(n * (24 + len(frag) + 4 * indiv) + 16)
    buf = ctypes.create_string_buffer(cap)
    i64p = ctypes.POINTER(ctypes.c_int64)
    wrote = lib.format_base_rows(
        frag, len(frag),
        pos.ctypes.data_as(i64p),
        refc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        calls.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, indiv, buf, cap)
    if wrote < 0:
        raise RuntimeError("format_base_rows buffer overflow")
    return buf.raw[:wrote]


def frag_table(sdx, cache):
    """Concatenated fragment-name table, cached on ``cache``."""
    ft = getattr(cache, "_frag_tab", None)
    if ft is None or cache._frag_sdx is not sdx:
        names = [nm.encode() for nm in sdx.names]
        cat = b"".join(names)
        off = np.zeros(len(names) + 1, np.int64)
        off[1:] = np.cumsum([len(n) for n in names])
        cache._frag_tab = (cat, off,
                           max((len(n) for n in names), default=1))
        cache._frag_sdx = sdx
        ft = cache._frag_tab
    return ft


def format_runs(sdx, run_a, run_b, run_frag, gpos, gref, gcalls, gact,
                indiv, cache):
    """One-call bulk formatting of every fast run in a window
    (format_base_runs in native/rowfmt.c).  ``cache`` holds the frag
    name table and the grown hugepage output buffer across windows.
    Returns (byte buffer, per-run offsets)."""
    from ..utils.hugemem import hp_empty
    lib = _lib()
    cat, foff, maxfrag = frag_table(sdx, cache)
    ra = np.asarray(run_a, np.int64)
    rb = np.asarray(run_b, np.int64)
    rf = np.asarray(run_frag, np.int32)
    nrows = int((rb - ra).sum())
    cap = nrows * (26 + maxfrag + 4 * indiv) + 16
    buf = getattr(cache, "_fmt_buf", None)
    if buf is None or len(buf) < cap:
        buf = hp_empty(int(cap * 1.2), np.uint8)
        cache._fmt_buf = buf
    offs = np.zeros(len(ra) + 1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    wrote = lib.format_base_runs(
        cat, foff.ctypes.data_as(i64p),
        rf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ra.ctypes.data_as(i64p), rb.ctypes.data_as(i64p), len(ra),
        gpos.ctypes.data_as(i64p), gref.ctypes.data_as(u8p),
        gcalls.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        gact.ctypes.data_as(u8p), indiv,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), len(buf),
        offs.ctypes.data_as(i64p))
    if wrote < 0:
        raise RuntimeError("format_base_runs buffer overflow")
    return buf, offs


def format_slow(cat, foff, maxfrag, slow, indiv, use_ped):
    """C formatting of a window's slow rows (format_slow_rows in
    native/rowfmt.c).  Returns (base buffer u8, per-row base offsets,
    snp bytes, piles bytes)."""
    lib = _lib()
    n = len(slow["pos"])
    base_cap = n * (26 + maxfrag + 16 * indiv) + 16
    snp_cap = n * (176 + maxfrag + 16 * indiv) + 16
    pile_cap = n * (26 + maxfrag + 40 * indiv) + 16
    base_out = np.empty(base_cap, np.uint8)
    snp_out = np.empty(snp_cap, np.uint8)
    pile_out = np.empty(pile_cap, np.uint8)
    base_off = np.zeros(n + 1, np.int64)
    sizes = np.zeros(2, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cp = ctypes.POINTER(ctypes.c_char)
    rc = lib.format_slow_rows(
        cat, foff.ctypes.data_as(i64p),
        slow["which"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        slow["pos"].ctypes.data_as(i64p),
        slow["refc"].ctypes.data_as(u8p),
        slow["data"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        slow["calls"].ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        slow["probs"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        slow["types"].ctypes.data_as(u8p),
        slow["denovo"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        slow["acnt"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        slow["active"].ctypes.data_as(u8p),
        n, indiv, 1 if use_ped else 0,
        base_out.ctypes.data_as(cp), base_cap,
        base_off.ctypes.data_as(i64p),
        snp_out.ctypes.data_as(cp), snp_cap,
        pile_out.ctypes.data_as(cp), pile_cap,
        sizes.ctypes.data_as(i64p))
    if rc < 0:
        raise RuntimeError("format_slow_rows buffer overflow")
    return (base_out, base_off, snp_out[:sizes[0]].tobytes(),
            pile_out[:sizes[1]].tobytes())


def load_pecall(indiv, haploid, theta, denovo_rate, threshold, use_ped,
                dad, mom, sex):
    lib = _lib()
    dad = np.ascontiguousarray(dad, dtype=np.int32)
    mom = np.ascontiguousarray(mom, dtype=np.int32)
    sex = np.ascontiguousarray(sex, dtype=np.int32)
    _KEEPALIVE.extend([dad, mom, sex])
    i32p = ctypes.POINTER(ctypes.c_int32)
    model = lib.pecall_model_create(
        indiv, 1 if haploid else 0, theta, denovo_rate, threshold,
        1 if use_ped else 0,
        dad.ctypes.data_as(i32p), mom.ctypes.data_as(i32p),
        sex.ctypes.data_as(i32p))
    return lib, model


def pecall_sites(lib, model, reads, ref_int, ctype, site_haploid,
                 nthreads):
    """The exact engine (pecall_sites_batch) on a batch of sites: reads
    (n, I, 6) uint16, ref_int / ctype / site_haploid (n,) uint8.
    Returns (calls int8 (n, I), probs f64 (n, I), types uint8 (n,),
    denovo int32 (n,), acnt int32 (n, 6), active uint8 (n, I))."""
    reads = np.ascontiguousarray(reads, dtype=np.uint16)
    ri, ct, hp = (np.ascontiguousarray(x, dtype=np.uint8)
                  for x in (ref_int, ctype, site_haploid))
    nb, indiv = reads.shape[:2]
    calls = np.zeros((nb, indiv), dtype=np.int8)
    probs = np.zeros((nb, indiv), dtype=np.float64)
    types = np.zeros(nb, dtype=np.uint8)
    dn = np.zeros(nb, dtype=np.int32)
    ac = np.zeros((nb, 6), dtype=np.int32)
    act = np.zeros((nb, indiv), dtype=np.uint8)
    lib.pecall_sites_batch(
        model, ptr(reads, ctypes.c_uint16), ptr(ri, ctypes.c_uint8),
        ptr(ct, ctypes.c_uint8), ptr(hp, ctypes.c_uint8), nb, nthreads,
        ptr(calls, ctypes.c_int8), ptr(probs, ctypes.c_double),
        ptr(types, ctypes.c_uint8), ptr(dn, ctypes.c_int32),
        ptr(ac, ctypes.c_int32), ptr(act, ctypes.c_uint8))
    return calls, probs, types, dn, ac, act
