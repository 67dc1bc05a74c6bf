"""The roofline's DP cells and bytes on a hand-worked batch."""

import torch

from pebench.metrics import roofline


def test_k1_and_k2_work_by_hand():
    blens = torch.tensor([121, 130, 0], dtype=torch.int32)
    rlens = torch.tensor([100, 98, 1], dtype=torch.int32)
    k1 = roofline.work("k1", dict(blens=blens, rlens=rlens, n_rows=125))
    # lane 0: 121 rows x 100; lane 1: 125 rows (n_rows) x 98; lane 2: none
    assert k1["cells"] == 121 * 100 + 125 * 98
    assert k1["lanes"] == 2
    assert k1["bytes"] == (121 + 100) + (125 + 98) + 2 * 8 + 2 * 13
    bt_i = torch.tensor([110, 140, 0], dtype=torch.int32)
    k2 = roofline.work("k2", dict(blens=blens, rlens=rlens, n_rows=125,
                                  bt_i=bt_i))
    # rows up to the walk's start row, within the window and n_rows
    assert k2["cells"] == 110 * 100 + 125 * 98
    assert k2["bytes"] == (121 + 100) + (125 + 98) + 2 * 16 \
        + 2 * (125 * 9 + 1)
    pct, bound = roofline.share(k1, 1.0)
    assert bound == "operations"
    peak = 2 * 132 * 4 * 32 * 1.98e9           # operations/s
    assert abs(pct - 100 * k1["cells"] * 13 / peak / 1e-3) < 1e-9
