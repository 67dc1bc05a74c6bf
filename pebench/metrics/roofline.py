"""The least time the card needs for a kernel's inputs, and its share of
the measured time.  Not a metric: the roofline readers share it.

Work: the operations of the plain reference's cell update for the
alignment recurrence (``reference/mapper.py``, ``dp_planes``), counted
once for each DP cell that the inputs need, however a kernel computes
it:

    horizontal  c2 = max(c0[j-1] - open, c2[j-1] - extend)     3
    vertical    c1 = max(s0[j] - open, s1[j] - extend)          3
    match       bump = read == ref ? 1 : -1/3                   2
    diagonal    c0 = max(s0, s1, s2)[j-1] + bump                5
                                                               --
                                                               13

A cell is one (row, read column) of a lane: K1 fills the window's rows
(``blen``, at most ``n_rows``) for each read column; K2 the rows up to
the walk's start row (``bt_i``).  Lanes with no window (``blen`` 0) need
none.

Peaks (NVIDIA H100 SXM data sheet, 700 W; the card's power limit is
printed beside every run): 33.4 T thread-instructions/s of integer issue
(132 SMs x 4 schedulers x 32 lanes x 1.98 GHz) and 3.35 TB/s of HBM.
One Hopper DPX instruction carries at most two of the recurrence's
operations (VIADDMNMX: an add and a max; VIMNMX3: two maxes), so the
card does at most 2 x 33.4 T of them a second; no kernel can read above
100%.

Bytes: each input byte read once and each output byte written once,
for the lanes with a window: the window's rows and the read's bases,
the int32 lane scalars, and the outputs (K1: score, plane, row, tie;
K2: per row the event byte and two int32, and the tie).
"""

OPS_PER_CELL = 13
INSTR_PER_S = 132 * 4 * 32 * 1.98e9
OPS_PER_S = 2 * INSTR_PER_S
HBM_BPS = 3.35e12


def work(kernel: str, lanes: dict) -> dict:
    """DP cells and bytes of one launch on ``lanes`` (each lane's window
    rows ``blens`` and read length ``rlens``, ``n_rows``, and K2's walk
    start row ``bt_i``)."""
    n_rows = lanes["n_rows"]
    blens, rl = lanes["blens"].long(), lanes["rlens"].long()
    live = blens > 0
    rows = blens.clamp(max=n_rows)
    if kernel == "k2":
        rows = rows.clamp(max=lanes["bt_i"].long().clamp(min=0))
    cells = int((rows * rl)[live].sum())
    n = int(live.sum())
    in_b = int((blens.clamp(max=n_rows) + rl)[live].sum())
    if kernel == "k1":
        in_b += 8 * n
        out_b = 13 * n
    else:
        in_b += 16 * n
        out_b = n * (n_rows * 9 + 1)
    return {"cells": cells, "bytes": in_b + out_b, "lanes": n}


def share(w: dict, ms: float):
    """(percent of the roofline, which bound holds)."""
    t_ops = w["cells"] * OPS_PER_CELL / OPS_PER_S
    t_bytes = w["bytes"] / HBM_BPS
    least = max(t_ops, t_bytes)
    return 100.0 * least / (ms * 1e-3), ("operations" if t_ops >= t_bytes
                                         else "bytes")
