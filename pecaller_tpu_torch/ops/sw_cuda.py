"""Wrappers of the hand-written CUDA kernels K1 (sw_align_x), K2
(sw_tb_rows) and K3 (sw_align); counterparts of
``pecaller_tpu/ops/sw_pallas2.py`` (K1, K2) and
``pecaller_tpu/ops/sw_pallas.py`` (K3).  The same build and launch count
serve the seed stage's chain kernels (``csrc/chain.cu``, wrapped by
``ops/chain.py``).

A CPU tensor goes to the plain PyTorch version (``ops/sw2.py`` for K1
and K2, ``ops/sw.py`` for K3).  A CUDA tensor goes to the kernel, or
the wrapper raises: there is no fallback.  The kernels are compiled
with ``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` at
the root of the checkout (one ``nvcc -c`` per source, all started
together, then one link; rebuilt when a source changes) and loaded with
ctypes.  Each wrapper counts its launches in ``LAUNCHES``.  A CUDA
graph's capture runs no kernel, so the program that captures takes the
capture's counts back out (``launches_since``) and adds them again on
each replay (``count_replay``, ``mapper/program.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import sw, sw2

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("sw_align_x.cu", "sw_tb_rows.cu", "sw_align.cu", "chain.cu")
_HEADERS = ("sw_kernels.h", "sw_group.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build",
                         "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"sw_align_x": 0, "sw_tb_rows": 0, "sw_align": 0,
            "chain_votes": 0, "chain_select": 0}
BUILD_INFO = {}          # nvcc seconds and ptxas report of the last build
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches_since(before: dict) -> dict:
    """The launches counted since ``before`` (a copy of ``LAUNCHES``),
    taken back out of ``LAUNCHES``: the wrappers counted them while a
    graph was captured, and a capture launches nothing."""
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    LAUNCHES.update(before)
    return moved


def count_replay(launches: dict) -> None:
    """Count the kernel launches of one replay of a captured graph."""
    for k, v in launches.items():
        LAUNCHES[k] += v


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc")


def build_kernels() -> str:
    """Compile the kernels (once per source hash); returns the .so path.
    Each source compiles in its own nvcc process, all at once."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*_HEADERS, *_SOURCES):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libsw_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{lib}.build{os.getpid()}"
    t0 = time.time()
    nvcc = _nvcc()
    objs = [f"{tag}.{i}.o" for i in range(len(_SOURCES))]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", o,
         os.path.join(_CSRC, src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src, o in zip(_SOURCES, objs)]
    report = []
    for src, p in zip(_SOURCES, procs):
        out = p.communicate()[0]
        report.append(out)
        if p.returncode != 0:
            for q in procs:
                q.kill()
                q.wait()
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    res = subprocess.run([nvcc, "-shared", "-o", tag, *objs],
                         capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    os.replace(tag, lib)
    BUILD_INFO.update(seconds=time.time() - t0, ptxas="".join(report))
    return lib


def load_kernels() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_kernels())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sw_lane_group.argtypes = [ci]
    lib.sw_lane_group.restype = ci
    lib.sw_lane_cols.argtypes = [ci, ci]
    lib.sw_lane_cols.restype = ci
    lib.sw_align_x_launch.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.sw_align_x_launch.restype = ci
    lib.sw_tb_rows_row_bytes.argtypes = [ci, ci]
    lib.sw_tb_rows_row_bytes.restype = ci
    lib.sw_tb_rows_launch.argtypes = [vp] * 11 + [ci] * 6 + [vp]
    lib.sw_tb_rows_launch.restype = ci
    lib.sw_align_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.sw_align_launch.restype = ci
    lib.chain_votes_launch.argtypes = [vp] * 5 + [ci] * 2 + [vp]
    lib.chain_votes_launch.restype = ci
    lib.chain_select_launch.argtypes = [vp] * 15 + [ci] * 2 + [vp]
    lib.chain_select_launch.restype = ci
    _LIB = lib
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(refs, blens, reads, rlens, n_rows, extra=()):
    """Device, dtypes, shapes and contiguity."""
    dev = refs.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if refs.dim() != 2 or reads.dim() != 2:
        raise ValueError("refs and reads must be 2-D (lanes, width)")
    B, N = refs.shape
    M = reads.shape[1]
    _check("refs", refs, torch.uint8, (B, N), dev)
    _check("reads", reads, torch.uint8, (B, M), dev)
    for name, x in (("blens", blens), ("rlens", rlens), *extra):
        _check(name, x, torch.int32, (B,), dev)
    if not 0 <= n_rows <= N:
        raise ValueError(f"n_rows {n_rows} outside [0, {N}]")
    return load_kernels(), B, N, M


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _p(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def sw_align_x(refs, blens, reads, rlens, bisulfite: bool = False,
               n_rows: int | None = None, group: int = 0):
    """K1.  Same contract as sw2.sw_align_x: (score, k, i) int32 and
    tie bool, each (B,).  ``group``: threads per lane on the card, 0 =
    the kernel's choice for the read width (the main path); 8, 16 or 32
    force a group size, for the tests and chip_smoke.py's per-group
    times."""
    n_rows = refs.shape[1] if n_rows is None else n_rows
    if refs.device.type == "cpu":
        return sw2.sw_align_x(refs, blens, reads, rlens,
                              bisulfite=bisulfite, n_rows=n_rows)
    lib, B, N, M = _check_inputs(refs, blens, reads, rlens, n_rows)
    if lib.sw_lane_cols(M, group) == 0:
        raise ValueError(f"no sw_align_x instance with {group} threads "
                         f"per lane takes read width {M}")
    dev = refs.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    bk = torch.empty(B, dtype=torch.int32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    tie = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sw_align_x_launch(
            _p(refs), _p(blens), _p(reads), _p(rlens), _p(score), _p(bk),
            _p(bi), _p(tie), B, N, M, n_rows, int(bool(bisulfite)), group,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sw_align_x launch failed: cudaError {rc}")
    LAUNCHES["sw_align_x"] += 1
    return score, bk, bi, tie


def sw_traceback_rows(refs, blens, reads, rlens, bt_k, bt_i,
                      bisulfite: bool = False, n_rows: int | None = None,
                      group: int = 0):
    """K2.  Same contract as sw2.sw_traceback_rows: ev_kind int8,
    ins_j int32, ins_len int32, each (B, n_rows), and tie (B,) bool.
    ``group``: threads per lane on the card, as for sw_align_x."""
    n_rows = refs.shape[1] if n_rows is None else n_rows
    if refs.device.type == "cpu":
        return sw2.sw_traceback_rows(refs, blens, reads, rlens, bt_k, bt_i,
                                     bisulfite=bisulfite, n_rows=n_rows)
    lib, B, N, M = _check_inputs(refs, blens, reads, rlens, n_rows,
                                 extra=(("bt_k", bt_k), ("bt_i", bt_i)))
    row_bytes = lib.sw_tb_rows_row_bytes(M, group)
    if row_bytes == 0:
        raise ValueError(f"no sw_tb_rows instance with {group} threads "
                         f"per lane takes read width {M}")
    dev = refs.device
    cube = torch.empty((B, n_rows, row_bytes), dtype=torch.uint8,
                       device=dev)
    ev_kind = torch.empty((B, n_rows), dtype=torch.int8, device=dev)
    ins_j = torch.empty((B, n_rows), dtype=torch.int32, device=dev)
    ins_len = torch.empty((B, n_rows), dtype=torch.int32, device=dev)
    tie = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sw_tb_rows_launch(
            _p(refs), _p(blens), _p(reads), _p(rlens), _p(bt_k), _p(bt_i),
            _p(cube), _p(ev_kind), _p(ins_j), _p(ins_len), _p(tie),
            B, N, M, n_rows, int(bool(bisulfite)), group, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sw_tb_rows launch failed: cudaError {rc}")
    LAUNCHES["sw_tb_rows"] += 1
    return ev_kind, ins_j, ins_len, tie


def sw_align(refs, blens, reads, rlens, bisulfite: bool = False,
             n_rows: int | None = None, group: int = 0):
    """K3.  Same contract as sw.sw_align_device: raw bytes in, (score,
    k, i) int32, each (B,).  ``group``: threads per lane on the card, as
    for sw_align_x."""
    n_rows = refs.shape[1] if n_rows is None else n_rows
    if refs.device.type == "cpu":
        return sw.sw_align_device(refs, blens, reads, rlens,
                                  bisulfite=bisulfite, n_rows=n_rows)
    lib, B, N, M = _check_inputs(refs, blens, reads, rlens, n_rows)
    if lib.sw_lane_cols(M, group) == 0:
        raise ValueError(f"no sw_align instance with {group} threads "
                         f"per lane takes read width {M}")
    dev = refs.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    bk = torch.empty(B, dtype=torch.int32, device=dev)
    bi = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sw_align_launch(
            _p(refs), _p(blens), _p(reads), _p(rlens), _p(score), _p(bk),
            _p(bi), B, N, M, n_rows, int(bool(bisulfite)), group,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sw_align launch failed: cudaError {rc}")
    LAUNCHES["sw_align"] += 1
    return score, bk, bi
