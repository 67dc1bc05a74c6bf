"""The binary pileup record stream (.pileup.gz).

Record = uint32 seq-coord position + 6 x uint16 counts [A,C,G,T,Del,Ins],
written for every position with any nonzero counter
(pemapper.c:825-842, read back at pecaller.c:841-843).
"""

from __future__ import annotations

import gzip

import numpy as np

_REC = np.dtype([("pos", "<u4"), ("counts", "<u2", (6,))])


def write_pileup(path: str, pos: np.ndarray, counts: np.ndarray,
                 compresslevel: int = 6) -> None:
    """pos: (N,) seq-coord positions; counts: (N, 6) uint16."""
    rec = np.empty(pos.shape[0], dtype=_REC)
    rec["pos"] = pos.astype(np.uint32)
    rec["counts"] = counts.astype(np.uint16)
    with gzip.open(path, "wb", compresslevel=compresslevel) as f:
        f.write(rec.tobytes())


def read_pileup(path: str):
    """-> (pos uint32 (N,), counts uint16 (N, 6))."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    usable = len(data) - (len(data) % _REC.itemsize)
    rec = np.frombuffer(data[:usable], dtype=_REC)
    return rec["pos"].copy(), rec["counts"].copy()
