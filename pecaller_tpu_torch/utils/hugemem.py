"""Hugepage-backed numpy allocation.

This VM zeroes fresh 4 KiB pages at ~30-50 MB/s, so first-touch of large
numpy arrays dominates any host-side pipeline that streams GBs (measured:
`np.empty(1<<30)` + touch = 34 s; the same buffer mmap'ed with
MADV_HUGEPAGE = 0.8 s).  THP is in `madvise` mode and glibc doesn't
advise, so big allocations must come from here.

Use for any array over ~100 MB that is written once front-to-back; small
arrays recycle malloc arenas and don't need it.
"""

from __future__ import annotations

import ctypes
import mmap

import numpy as np

_MADV_HUGEPAGE = 14
_libc = None


def _madvise(addr: int, length: int) -> None:
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(length),
                  _MADV_HUGEPAGE)


def hp_empty(shape, dtype) -> np.ndarray:
    """np.empty equivalent backed by an anonymous MADV_HUGEPAGE mmap."""
    dtype = np.dtype(dtype)
    if np.isscalar(shape) or isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes == 0:
        return np.empty(shape, dtype)
    aligned = (nbytes + (1 << 21) - 1) & ~((1 << 21) - 1)
    mm = mmap.mmap(-1, aligned)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
    _madvise(addr, aligned)
    return np.frombuffer(mm, dtype=dtype,
                         count=int(np.prod(shape))).reshape(shape)
