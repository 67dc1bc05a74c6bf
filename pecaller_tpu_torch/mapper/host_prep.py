"""Host-side helpers of the fused mapping step, numpy only.

JAX-free homes of helpers that live in JAX-importing modules of the
reference package: ``_pad_to``, ``_bucket_b`` and
``exact_score_threshold[_amb]`` (``pecaller_tpu/mapper/device_pipeline.py``)
and ``pack_genome`` with its tables (``pecaller_tpu/mapper/device_map2.py``),
and the padded contig starts both fused engines search.
"""

from __future__ import annotations

import numpy as np

from ..ops.sw2 import XN

THR_AMB_BIT = 1 << 30


def _pad_to(x: int, step: int) -> int:
    return ((x + step - 1) // step) * step


def _bucket_b(n: int, lo: int = 512) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def segments_of(length: int) -> int:
    """Seed segments of a read of ``length`` bases, as
    ``seeds.segment_offsets`` cuts it (one every 16 bases, the last one
    ending at the read's end): ceil(length / 16), at least 1.  The fused
    engines size their segment axis by it.  The reference engines size
    it by length // 16, one short for every length that is not a
    multiple of 16: the step then never sees the read's last segment,
    and a read whose chain needs it goes unmapped where the host oracle
    maps it (ROADMAP queue 3)."""
    return max(1, -(-length // 16))


def contig_pad(istarts: np.ndarray, n_contigs: int) -> np.ndarray:
    """Contig starts padded with INT32_MAX to the length the device
    contig search probes (it starts at index 7)."""
    st_pad = np.full(max(n_contigs + 1, 70) + 1, 2 ** 31 - 1, np.int32)
    st_pad[:len(istarts)] = istarts
    return st_pad


def exact_score_threshold(lens: np.ndarray, min_align: float) -> np.ndarray:
    """Smallest int k such that (k/36.0 as float64) >= len*min_align, so
    that `score_int >= thr` agrees with the reference's f64
    `smax >= good_score` (pemapper.c:1086,1371-1377)."""
    good = lens.astype(np.float64) * float(min_align) * 1.0
    k = np.ceil(good * 36.0).astype(np.int64)
    k = np.where(k.astype(np.float64) / 36.0 < good, k + 1, k)
    k = np.where((k - 1).astype(np.float64) / 36.0 >= good, k - 1, k)
    return k.astype(np.int32)


def exact_score_threshold_amb(lens: np.ndarray,
                              min_align: float) -> np.ndarray:
    """exact_score_threshold with bit 30 set when good_score lands within
    summation noise of an exact k/36 rational: a candidate scoring
    exactly there passes the f64 gate or not depending on rounding, so
    the step routes such units to the host engine."""
    thr = exact_score_threshold(lens, min_align).astype(np.int64)
    good = lens.astype(np.float64) * float(min_align) * 1.0
    k_near = np.rint(good * 36.0).astype(np.int64)
    amb = np.abs(k_near.astype(np.float64) / 36.0 - good) < 1e-9
    return (thr | np.where(amb, THR_AMB_BIT, 0)).astype(np.int32)


_CODE_TAB = np.zeros(256, dtype=np.uint8)        # char -> xcode
for _c, _v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
    _CODE_TAB[_c[0]] = _v
_CODE_TAB[ord("N")] = XN
_EXOTIC = np.ones(256, dtype=bool)
for _c in b"ACGTN":
    _EXOTIC[_c] = False


def pack_genome(genome: np.ndarray):
    """ASCII genome -> (code words, N|exotic 2-bit mask words), both
    uint32, 16 bases a word, padded with 16 guard words."""
    codes = _CODE_TAB[genome]
    n = (codes == XN) | (genome == ord("n"))
    exotic = _EXOTIC[genome] & ~(genome == ord("n"))
    gs = len(genome)
    PW = (gs + 15) // 16 + 16
    cw = np.zeros(PW, dtype=np.uint32)
    mw = np.zeros(PW, dtype=np.uint32)
    idx = np.arange(gs)
    np.bitwise_or.at(cw, idx >> 4,
                     (codes & 3).astype(np.uint32) << ((idx & 15) * 2))
    np.bitwise_or.at(mw, idx >> 4,
                     (n.astype(np.uint32)
                      | (exotic.astype(np.uint32) << 1)) << ((idx & 15) * 2))
    return cw, mw
