"""Size checks of the quartered-key seed index.

The port has no quartered-key index yet (ROADMAP queue 1, item 6).  The
runner still needs to know whether ``pecaller_tpu/index/quarter.py``
``build_quarter_index`` would take a genome: where it would, the JAX
runner maps with the v2 engine on that index; where it refuses, with the
fused v1 engine.  ``quarter_refuses`` answers that from the exact-key
index alone, without building anything.
"""

from __future__ import annotations

import numpy as np

from ..formats.index_files import SeedIndex

TOO_MANY = 100            # pemapper.c:162 too_many_spots


def quarter_refuses(index: SeedIndex,
                    max_positions: int = 6_000_000_000) -> bool:
    """True where ``build_quarter_index(index, max_positions)`` raises
    for size: a position at or past 2^30, or 4 x (positions of the
    non-abundant keys + abundant keys) past ``max_positions`` or at or
    past 2^31 (``pecaller_tpu/index/quarter.py:91-115``)."""
    starts = np.asarray(index.starts, dtype=np.int64)
    positions = np.asarray(index.positions)
    counts = np.diff(starts)
    if len(counts) and int(positions.max(initial=0)) >= (1 << 30):
        return True
    ab_key = counts >= TOO_MANY
    per_q = int(counts[~ab_key].sum()) + int(ab_key.sum())
    return 4 * per_q > max_positions or 4 * per_q >= 2 ** 31
