"""The reference's per-ref alpha prior (pecaller.c:3043-3139) in numpy:
the input of the caller screen's tables (caller/device_screen.py).

Counterpart of the numpy half of ``pecaller_tpu/caller/device_model.py``
(its vectorized f32 likelihoods are not part of the port)."""

from __future__ import annotations

import numpy as np

NO_ALLELES = 6
MAX_GEN = 14


def _get_het_alleles(i, ref):
    pairs = {6: (0, 1), 7: (0, 2), 8: (0, 3), 9: (1, 2), 10: (1, 3),
             11: (2, 3), 12: (ref, 4), 13: (ref, 5)}
    return (i, i) if i < 6 else pairs[i]


def fill_alpha_prior_np(hom: int, het: int, ref: int) -> np.ndarray:
    """Numpy port of the reference's per-ref alpha prior
    (pecaller.c:3043-3139)."""
    a = np.zeros((MAX_GEN, NO_ALLELES), dtype=np.int64)
    hom_err = max(1, hom // 300)
    err = max(1, (2 * het) // 300)
    for i in range(4):
        a[i] = hom_err
        a[i, i] = hom
    a[4, :4] = err
    a[4, ref] = hom // 5
    a[4, 4] = (4 * hom) // 5
    a[4, 5] = err
    a[5, :4] = err
    a[5, ref] = hom
    a[5, 4] = err
    a[5, 5] = (4 * hom) // 5
    for j in range(6, 12):
        x, y = _get_het_alleles(j, ref)
        if x == ref or y == ref:
            r, o = (x, y) if x == ref else (y, x)
            a[j] = err
            a[j, r] = (51 * het) // 50
            a[j, o] = (49 * het) // 50
            a[j, 4] = max(1, het // 20)
            a[j, 5] = err
        else:
            a[j] = err
            a[j, x] = het
            a[j, y] = het
    a[12] = err
    a[12, 4] = (4 * het) // 5
    a[12, ref] = (6 * het) // 5
    a[12, 5] = err
    a[13] = err
    a[13, 5] = (2 * het) // 5
    a[13, ref] = (8 * het) // 5
    return a
