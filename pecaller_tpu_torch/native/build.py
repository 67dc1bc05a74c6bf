"""Build + ctypes-load the native components (gcc, cached .so)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
# build/native/ at the root of the checkout (gitignored)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_SOURCES = ["swexact.c", "chain.c", "mate.c", "cuckoo.c"]
_LIB = None


def build_library(name: str, sources) -> str:
    """Compile ``sources`` (files of this directory) into
    build/native/lib<name>_<hash>.so with gcc -O3, once per content
    hash; returns the library's path."""
    h = hashlib.sha256()
    srcs = [os.path.join(_HERE, s) for s in sources]
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    cache = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(cache):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = cache + f".build{os.getpid()}"
        subprocess.run(
            ["gcc", "-O3", "-Wall", "-shared", "-fPIC", "-o", tmp, *srcs,
             "-lpthread", "-lm"],
            check=True, capture_output=True)
        os.replace(tmp, cache)
    return cache


def load_swexact() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library("native", _SOURCES))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f64p = ctypes.POINTER(ctypes.c_double)
    u16p = ctypes.POINTER(ctypes.c_uint16)

    lib.sw_align_batch.argtypes = [
        u8p, i32p, ctypes.c_int32, u8p, i32p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, f64p, i32p, i32p]
    lib.sw_align_batch.restype = None
    lib.sw_backtrack_batch.argtypes = [
        u8p, i32p, ctypes.c_int32, u8p, i32p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, i32p, i32p, i64p,
        u16p, ctypes.c_int64, i32p, ctypes.c_int64, i64p]
    lib.sw_backtrack_batch.restype = None
    lib.find_matches_batch.argtypes = [
        u32p, i64p, i32p, i32p, i32p, i32p, u8p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int,
        u32p, i32p, i8p, i32p]
    lib.find_matches_batch.restype = None
    lib.decide_single_batch.argtypes = [
        f64p, i32p, i32p, ctypes.c_double, ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p]
    lib.decide_single_batch.restype = None
    lib.decide_pair_batch.argtypes = [
        f64p, u32p, i8p, i32p, i32p,
        f64p, u32p, i8p, i32p, i32p,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p]
    lib.decide_pair_batch.restype = None
    lib.cuckoo_place.argtypes = [
        u32p, u32p, u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, u32p,
        u32p]
    lib.cuckoo_place.restype = ctypes.c_int
    _LIB = lib
    return lib


def ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
