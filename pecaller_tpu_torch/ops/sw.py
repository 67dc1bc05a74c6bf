"""Plain integer Smith-Waterman on raw reference and read bytes (PyTorch).

Counterpart of ``pecaller_tpu/ops/sw.py``: the batched affine-gap glocal
DP of the v1 fused engine, on ASCII characters.  Scores are exact
rationals x36 (match +36, mismatch -12, open 72, extend 1) in int32, so
every result is an integer and the port equals the reference bit for
bit.  Equal bytes match; ``N``/``n`` on either side match anything; with
bisulfite, reference ``C``/``c`` also matches read ``T``/``t``; every
other byte (IUPAC letters, other lowercase) compares by equality.

``sw_align_device`` is the plain version of kernel K3 (``csrc/sw_align.cu``,
wrapper ``ops/sw_cuda.py::sw_align``).  ``sw_traceback_device`` replays
the DP of the winners into per-cell decision bits and walks the path
back, one step per loop iteration (an XLA program in the reference, not
a Pallas kernel).  ``sw_traceback_scatter`` adds the walk's events to a
resident (genome, 6) pileup through ``pileup_scatter`` and compacts the
insertion records: the split engine's traceback
(``mapper/device_engine.py``).

Reference recurrences: pemapper.c:1694-1748 (score), :1752-1965 (walk).
"""

from __future__ import annotations

import torch

MATCH, MISMATCH, OPEN, EXT = 36, -12, 72, 1
NEG = -(1 << 30)

# event kinds emitted by the walk
EV_NONE = 5          # no event this step
EV_DEL = 4           # kinds 0..3 = base A,C,G,T counted

I32 = torch.int32
_N, _n = ord("N"), ord("n")


def _read_flags(read_chars, bisulfite: bool):
    """Per read column: wildcard (N/n), and read T/t for bisulfite."""
    wild = (read_chars == _N) | (read_chars == _n)
    is_t = ((read_chars == ord("T")) | (read_chars == ord("t"))
            if bisulfite else None)
    return wild, is_t


def _bump_row(rb, read_chars, flags, bisulfite: bool):
    """(B,) ref chars x (B, M) read chars -> (B, M) int32 bump."""
    wild, is_t = flags
    rb = rb[:, None]
    m = (rb == read_chars) | (rb == _N) | (rb == _n) | wild
    if bisulfite:
        m = m | (((rb == ord("C")) | (rb == ord("c"))) & is_t)
    return torch.where(m, MATCH, MISMATCH).to(I32)


def _row0(B, W, device):
    j = torch.arange(W, dtype=I32, device=device)
    b = -(OPEN + (j - 1) * EXT)
    s0 = torch.where(j == 0, 0, b).to(I32)[None, :].repeat(B, 1)
    s2 = torch.where(j == 0, -OPEN, b).to(I32)[None, :].repeat(B, 1)
    return s0, s0.clone(), s2


def _step_core(s0, s1, s2, bump, jw):
    """One DP row from the previous row's planes.  bump: (B, W-1);
    jw: arange(W) int32."""
    B = s0.shape[0]
    zero = torch.zeros((B, 1), dtype=I32, device=s0.device)
    prev3 = torch.maximum(torch.maximum(s0, s1), s2)
    c0 = torch.cat([zero, prev3[:, :-1] + bump], dim=1)
    c1 = torch.cat([zero, torch.maximum(s0[:, 1:] - OPEN, s1[:, 1:] - EXT)],
                   dim=1)
    a = torch.cat([torch.full((B, 1), -OPEN, dtype=I32, device=s0.device),
                   c0[:, :-1] - OPEN + jw[1:]], dim=1)
    c2 = torch.cummax(a, dim=1).values - jw
    return c0, c1, c2


def sw_align_device(refs, blens, reads, rlens, bisulfite: bool = False,
                    n_rows: int | None = None):
    """Batched glocal SW scores (the plain version of K3).

    refs (B, N) uint8 window chars, blens (B,) int32 valid rows, reads
    (B, M) uint8, rlens (B,) int32.  Returns (score x36, plane k, ref row
    i) of the first strict-`>` argmax over (row, plane 0, 1, 2) in the
    read's last column (column rlen), all int32 (B,)."""
    B, N = refs.shape
    M = reads.shape[1]
    W = M + 1
    dev = refs.device
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W, dev)
    jw = torch.arange(W, dtype=I32, device=dev)
    read_chars = reads.to(I32)
    flags = _read_flags(read_chars, bisulfite)
    rl = rlens.to(torch.int64)
    has_col = (rl >= 0) & (rl <= M)            # else no column == rlen
    col = rl.clamp(0, M)[:, None]

    def at_col(x):
        return torch.where(has_col, x.gather(1, col)[:, 0], NEG)

    best = at_col(s0)
    bk = torch.zeros(B, dtype=I32, device=dev)
    bi = torch.zeros(B, dtype=I32, device=dev)
    refs_t = refs[:, :n_rows].t().to(I32)     # (n_rows, B)
    for i in range(1, n_rows + 1):
        bump = _bump_row(refs_t[i - 1], read_chars, flags, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump, jw)
        active = i <= blens
        for k, c in enumerate((c0, c1, c2)):
            v = at_col(c)
            upd = active & (v > best)
            best = torch.where(upd, v, best)
            bk = torch.where(upd, k, bk)
            bi = torch.where(upd, i, bi)
        a2 = active[:, None]
        s0 = torch.where(a2, c0, s0)
        s1 = torch.where(a2, c1, s1)
        s2 = torch.where(a2, c2, s2)
    return best.to(I32), bk.to(I32), bi.to(I32)


def _parts_of(c0, c1, c2):
    a0 = torch.where(c1 > c0, 1, 0)
    a0 = torch.where(c2 > torch.maximum(c0, c1), 2, a0).to(torch.uint8)
    b1 = (c1 - EXT > c0 - OPEN).to(torch.uint8)
    b2 = (c2 - EXT > c0 - OPEN).to(torch.uint8)
    return a0, b1, b2


def _shift_r(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def sw_traceback_device(refs, blens, reads, rlens, bt_k, bt_i,
                        bisulfite: bool = False, n_rows: int | None = None):
    """Recompute the DP emitting decision bits, then walk the path back
    from (bt_i, rlen, bt_k).

    The walk at state (i, j, k) needs three cells' bits: a0 of
    (i-1, j-1), b1 of (i-1, j), b2 of (i, j-1); the replay stores them
    pre-shifted in ONE byte at (i, j), so each walk step gathers once.

    Returns (ev_pos (B, T) int32 ref-window row of each consuming step or
    -1, ev_kind (B, T) int8, ins_j (B, T) int16 read-slice start of an
    insertion attachment or -1, ins_len (B, T) int16), T = n_rows + M + 2.
    """
    B, N = refs.shape
    M = reads.shape[1]
    W = M + 1
    dev = refs.device
    n_rows = N if n_rows is None else n_rows
    s0, s1, s2 = _row0(B, W, dev)
    jw = torch.arange(W, dtype=I32, device=dev)
    read_chars = reads.to(I32)
    flags = _read_flags(read_chars, bisulfite)
    refs_t = refs[:, :n_rows].t().to(I32)

    # decision bytes, (n_rows + 1, B, W): row 0 stays zero
    tbc = torch.zeros((n_rows + 1, B, W), dtype=torch.uint8, device=dev)
    a0p, b1p, _ = _parts_of(s0, s1, s2)
    for i in range(1, n_rows + 1):
        bump = _bump_row(refs_t[i - 1], read_chars, flags, bisulfite)
        c0, c1, c2 = _step_core(s0, s1, s2, bump, jw)
        a2 = (i <= blens)[:, None]
        s0 = torch.where(a2, c0, s0)
        s1 = torch.where(a2, c1, s1)
        s2 = torch.where(a2, c2, s2)
        a0n, b1n, b2n = _parts_of(s0, s1, s2)
        tbc[i] = _shift_r(a0p) | (b1p << 2) | (_shift_r(b2n) << 3)
        a0p, b1p = a0n, b1n

    T = n_rows + M + 2
    # per walk step: rec_i, rec_dj (>=0 diag step at read column j1, -2
    # deletion, -1 no event), ins_j, ins_len; stacked after the walk
    cols = ([], [], [], [])
    tflat = tbc.reshape(-1)
    lane_off = torch.arange(B, dtype=torch.int64, device=dev) * W

    ii = bt_i.to(I32)
    jj = rlens.to(I32)
    kk = bt_k.to(I32)
    ilen = torch.zeros(B, dtype=I32, device=dev)
    for _ in range(T - 1):
        aliveb = (ii > 0) & (jj > 0)
        i1 = torch.clamp(ii - 1, min=0)
        j1 = torch.clamp(jj - 1, min=0)
        # the reference gather clamps (i, j) into the cube
        gi = ii.clamp(0, n_rows).to(torch.int64)
        gj = jj.clamp(0, W - 1).to(torch.int64)
        bits = tflat[gi * (B * W) + lane_off + gj].to(I32)
        a0 = bits & 3
        b1 = (bits >> 2) & 1
        b2 = (bits >> 3) & 1
        ni = torch.where(kk == 2, ii, i1)
        nj = torch.where(kk == 1, jj, j1)
        nk = torch.where(kk == 0, a0,
                         torch.where(kk == 2, torch.where(b2 == 1, 2, 0),
                                     torch.where(b1 == 1, 1, 0)))
        consume_ref = aliveb & (kk != 2)
        diag = aliveb & (kk == 0)
        cols[0].append(torch.where(consume_ref, i1, -1))
        cols[1].append(torch.where(diag, j1,
                                   torch.where(consume_ref, -2, -1)))
        # insertion attachment: a pending run ends at a consuming step
        attach = consume_ref & (ilen > 0)
        cols[2].append(torch.where(attach, jj, -1))
        cols[3].append(torch.where(attach, ilen, 0))
        ilen = torch.where(aliveb, torch.where(kk == 2, ilen + 1, 0), ilen)
        ii = torch.where(aliveb, ni, ii)
        jj = torch.where(aliveb, nj, jj)
        kk = torch.where(aliveb, nk, kk).to(I32)
    # final attachment when the walk exits with a pending run and i >= 1
    fin = (ilen > 0) & (ii >= 1)
    for c, v in zip(cols, (torch.where(fin, ii - 1, -1),
                           torch.full_like(ii, -1), torch.where(fin, jj, -1),
                           torch.where(fin, ilen, 0))):
        c.append(v)
    i16 = torch.int16
    rec_i, rec_dj, ins_j, ins_len = (torch.stack(c, dim=1).to(i16)
                                     for c in cols)

    # resolve event kinds in one pass: the read base's code (A, C, G, T:
    # 0-3; any other byte -1), from comparisons, as a table built on the
    # device would take host-to-device copies (not capturable in a graph)
    rbj = torch.gather(reads, 1, rec_dj.clamp(0, M - 1).to(torch.int64))
    kind = torch.full(rbj.shape, -1, dtype=I32, device=dev)
    for code, ch in enumerate(b"ACGT"):
        kind = torch.where(rbj == ch, code, kind)
    ev_kind = torch.where(rec_dj >= 0,
                          torch.where(kind >= 0, kind, EV_NONE),
                          torch.where(rec_dj == -2, EV_DEL, EV_NONE))
    return rec_i.to(I32), ev_kind.to(torch.int8), ins_j, ins_len


def pileup_scatter(ev_pos_abs, ev_kind, ins_mask, counts):
    """Add walk events to the (genome_size, 6) pileup ``counts`` in place
    and return it.  ``counts`` is int16 carrying the bits of the
    reference's wrapping uint16 counters; the adds wrap mod 2^16.

    ev_pos_abs (E,) int64 absolute positions (or -1), ev_kind (E,) int8
    (kinds 0..4 count in their column, EV_NONE nothing), ins_mask (E,)
    bool marking insertion attachments (column 5).  Events past the
    genome are dropped.  The reference builds a fresh uint16 array per
    call and adds it to its counts; adding in place gives the same bits
    mod 2^16 without a second genome-sized array."""
    gs = counts.shape[0]
    flat = counts.view(-1)
    inb = (ev_pos_abs >= 0) & (ev_pos_abs < gs)
    valid = inb & (ev_kind != EV_NONE)
    flat.index_add_(0, torch.where(valid, ev_pos_abs * 6 + ev_kind.long(),
                                   0), valid.to(counts.dtype))
    ivalid = inb & ins_mask
    flat.index_add_(0, torch.where(ivalid, ev_pos_abs * 6 + 5, 0),
                    ivalid.to(counts.dtype))
    return counts


def sw_align_device_packed(refs, blens, reads, rlens,
                           bisulfite: bool = False,
                           n_rows: int | None = None):
    """sw_align_device with its outputs stacked into one (3, B) int32
    tensor (one copy to the host)."""
    return torch.stack(sw_align_device(refs, blens, reads, rlens,
                                       bisulfite=bisulfite, n_rows=n_rows))


def sw_traceback_scatter(refs, blens, reads, rlens, bt_k, bt_i, pos0,
                         counts, bisulfite: bool = False,
                         n_rows: int | None = None, ins_cap: int = 2048):
    """Traceback, pileup add and insertion-record compaction.

    pos0 (B,) int64: each lane's window start in the genome.  The walk's
    events are added to ``counts`` (pileup_scatter) in place.  Returns
    (counts, rec): rec (min(ins_cap, B x T) + 1, 4) int32 rows [lane,
    window row, read-slice start, length] of the insertion attachments
    in (lane, step) order, the last row [total, 0, 0, 0]."""
    ev_pos, ev_kind, ins_j, ins_len = sw_traceback_device(
        refs, blens, reads, rlens, bt_k, bt_i, bisulfite=bisulfite,
        n_rows=n_rows)
    ev_abs = torch.where(ev_pos >= 0, ev_pos.long() + pos0.long()[:, None],
                         -1)
    valid = (ins_j >= 0).reshape(-1)
    pileup_scatter(ev_abs.reshape(-1), ev_kind.reshape(-1), valid, counts)
    T = ev_pos.shape[1]
    # stable: the records keep their (lane, step) order
    order = torch.argsort((~valid).to(torch.uint8), stable=True)[:ins_cap]
    bb = torch.div(order, T, rounding_mode="floor")
    tt = order % T
    sel = valid[order]
    rec = torch.stack([
        torch.where(sel, bb, -1),
        torch.where(sel, ev_pos[bb, tt].long(), -1),
        torch.where(sel, ins_j[bb, tt].long(), -1),
        torch.where(sel, ins_len[bb, tt].long(), 0)], dim=1).to(I32)
    tail = torch.zeros((1, 4), dtype=I32, device=refs.device)
    tail[0, 0] = valid.sum()
    return counts, torch.cat([rec, tail])
