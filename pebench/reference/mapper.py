"""Plain reference of the paired-end mapper's answers, in NumPy and plain
PyTorch, from the genome's bases and the reads alone.

It follows the reference C ``pemapper`` (the algorithm the program under
test reproduces) step by step, written from its description and sharing
no code, index or table with the program:

* seeds: each read end, forward and reverse-complemented, is cut into
  16-base segments (one every 16 bases, the last ending at the read's
  end); each segment's 16-mer and its 48 single-substitution variants are
  looked up in a sorted table of the genome's 16-mers; a segment any of
  whose 49 keys occurs 100 times or more is dropped;
* chaining: the reference's ``find_matches`` state machine over the
  segments' sorted position lists (anchor segment by anchor segment, a
  candidate counts the later segments that lie on its diagonal within 12
  bases; the best count wins, ties append, 200 candidates at most);
* alignment: glocal Smith-Waterman in float64 (the read whole, the
  genome window local; match +1, mismatch -1/3, 'N' matches all, gap
  open 2, extend 1/36; three planes: diagonal, vertical, horizontal), on
  the window [spot - 10, spot + length + 10] of each candidate, the best
  cell taken over the read's last column;
* the pair decision: ``find_mate_pairs``'s rules, quirks included;
* the walk back from each winner's best cell, which adds its bases,
  deletions and insertions to the pileup and names each insertion.

Only single-contig genomes of A, C, G and T are handled (the benchmark's
configurations): then index and sequence coordinates agree.

``dtype`` sets the precision of the alignment's arithmetic: float64 is
the reference; float32 is the control that the comparison must fail.
"""

from __future__ import annotations

import numpy as np
import torch

IDEPTH = 16                 # seed length
MAX_HITS = 200              # candidates a read end keeps
TOO_MANY = 100              # a key this frequent drops its segment
MAX_OFF = IDEPTH - 4        # diagonal slack of the chaining
SLOP = 10                   # window margin around a candidate
OPEN = 2.0
EXT = 1.0 / 36.0
MISMATCH = -1.0 / 3.0
MAXN = 1024                 # longest window / read the DP takes

# exit codes (pemapper.c:37-45)
UNIQUE_MATE, UNIQUE_SLIP, UNIQUE_SINGLE, UNIQUE_MIS = 0, 1, 2, 3
NON_MATE, NON_MIS, NON_NO, NEITHER_MAP = 4, 5, 7, 8

_CODE = np.zeros(256, np.int64)          # 2-bit base codes, others 0
for _c, _v in zip(b"CGTcgt", (1, 2, 3, 1, 2, 3)):
    _CODE[_c] = _v
_COMP = np.full(256, ord("N"), np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
               ("W", "W"), ("S", "S"), ("K", "M"), ("M", "K"),
               ("Y", "R"), ("R", "Y")):
    _COMP[ord(_a)] = ord(_b)
_PILE_COL = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}


def revcomp(reads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse complements of the rows of ``reads`` (each ``lens`` long)."""
    j = np.arange(reads.shape[1])[None, :]
    src = np.clip(lens[:, None] - 1 - j, 0, reads.shape[1] - 1)
    out = _COMP[np.take_along_axis(reads, src, 1)]
    out[j >= lens[:, None]] = 0
    return out


class KmerTable:
    """Every 16-mer of the genome with its start, sorted by (key, start),
    on ``device``."""

    def __init__(self, genome: np.ndarray, device="cpu"):
        g = torch.as_tensor(_CODE[genome], device=device)
        isn = torch.as_tensor(genome == ord("N"), device=device)
        n = g.shape[0] - IDEPTH + 1
        key = torch.zeros(max(n, 0), dtype=torch.int64, device=device)
        bad = torch.zeros(max(n, 0), dtype=torch.bool, device=device)
        for j in range(IDEPTH):
            key = key * 4 + g[j:j + n]
            bad |= isn[j:j + n]
        pos = torch.nonzero(~bad)[:, 0]
        self.keys, order = torch.sort(key[pos], stable=True)
        self.pos = pos[order]

def _segments(length: int):
    tc = max(length // IDEPTH - (length % IDEPTH == 0), 0)
    offs = [IDEPTH * s for s in range(tc)] + [max(length - IDEPTH, 0)]
    return offs


def _seg_lists(table: KmerTable, reads: np.ndarray, lens: np.ndarray):
    """The sorted candidate positions of every segment of every oriented
    read (empty where the abundance gate drops the segment), all keys
    looked up at once on the table's device: flat positions and, for
    segment s of read n, ``pos[bounds[n * S + s]:bounds[n * S + s + 1]]``."""
    R, W = reads.shape
    offs = [_segments(int(n)) for n in lens]
    S = max(len(o) for o in offs)
    off = np.zeros((R, S), np.int64)
    live = np.zeros((R, S), bool)
    for n, o in enumerate(offs):
        off[n, :len(o)] = o
        live[n, :len(o)] = True
    dev = table.keys.device
    codes = torch.as_tensor(_CODE[reads], device=dev)
    at = torch.as_tensor(np.minimum(off[:, :, None] + np.arange(IDEPTH),
                                    W - 1), device=dev).reshape(R, -1)
    sel = torch.gather(codes, 1, at).reshape(R, S, IDEPTH)
    key = torch.zeros((R, S), dtype=torch.int64, device=dev)
    for j in range(IDEPTH):
        key = key * 4 + sel[:, :, j]
    # the 16-mer and its 48 single-substitution neighbours
    sh = 2 * torch.arange(IDEPTH, device=dev)
    cur = (key[:, :, None] >> sh) & 3                       # (R, S, 16)
    alt = (cur[..., None] + torch.arange(1, 4, device=dev)) % 4
    var = (key[:, :, None, None] - (cur[..., None] << sh[:, None])
           + (alt << sh[:, None]))
    keys = torch.cat([key[:, :, None], var.reshape(R, S, 48)], 2).ravel()
    lo = torch.searchsorted(table.keys, keys, side="left")
    cnt = torch.searchsorted(table.keys, keys, side="right") - lo
    lo, cnt = lo.reshape(R, S, 49), cnt.reshape(R, S, 49)
    drop = (cnt >= TOO_MANY).any(2) | ~torch.as_tensor(live, device=dev)
    cnt = torch.where(drop[:, :, None], 0, cnt).ravel()
    flat = cnt > 0
    seg = torch.arange(R * S, device=dev).repeat_interleave(49)[flat]
    run_lo, run_n = lo.ravel()[flat], cnt[flat]
    first = torch.repeat_interleave(torch.cumsum(run_n, 0) - run_n, run_n)
    rows = (torch.repeat_interleave(run_lo, run_n)
            + torch.arange(int(run_n.sum()), device=dev) - first)
    pos = table.pos[rows]
    seg = torch.repeat_interleave(seg, run_n)
    order = torch.argsort(seg * (1 << 32) + pos)
    bounds = torch.searchsorted(seg[order],
                                torch.arange(R * S + 1, device=dev))
    return pos[order].tolist(), bounds.tolist(), S, offs


def _find_matches(pos, bounds, base, offs, orient, state, hits):
    """The reference's find_matches over one orientation's segment lists
    (segment s: ``pos[bounds[base + s]:bounds[base + s + 1]]``);
    ``state["mm"]`` is the running min_match, shared by both
    orientations.  Returns False where a full candidate list aborted the
    call."""
    depth = len(offs) - 1
    lists = [pos[bounds[base + s]:bounds[base + s + 1]]
             for s in range(depth + 1)]
    if min(len(x) for x in lists) > MAX_HITS:
        hits.clear()
        return True
    loop = 0
    while loop <= 1 + depth - state["mm"]:
        start = -(offs[loop] + MAX_OFF)
        end = max([MAX_OFF] + [MAX_OFF + offs[j] - offs[loop]
                               for j in range(loop + 1, depth + 1)])
        mer = [0] * (depth + 1)
        for a in lists[loop]:
            lo_a = max(a + start, 0)
            hi_a = max(a + end, 0)
            found = 1
            for j in range(loop + 1, depth + 1):
                jl = lists[j]
                while mer[j] < len(jl) - 1 and jl[mer[j]] < lo_a:
                    mer[j] += 1
                k = mer[j]
                while k < len(jl) and jl[k] <= hi_a:
                    if abs((a - jl[k]) - (offs[loop] - offs[j])) < MAX_OFF:
                        found += 1
                        break
                    k += 1
            if found > state["mm"]:
                state["mm"] = found
                hits.clear()
                hits.append((a, offs[loop], orient))
            elif found == state["mm"]:
                if len(hits) >= MAX_HITS:
                    return False
                diag = a - offs[loop]
                if all(h - o != diag for h, o, _ in hits):
                    hits.append((a, offs[loop], orient))
        loop += 1
    return True


def candidates(table: KmerTable, reads: np.ndarray, lens: np.ndarray,
               rc: np.ndarray) -> list:
    """Candidates (position, segment offset, orientation) of each read
    end (``reads`` forward, ``rc`` their reverse complements), as the
    reference's initial_map finds them."""
    R = len(lens)
    pos, bounds, S, offs = _seg_lists(table, np.concatenate([reads, rc]),
                                      np.concatenate([lens, lens]))
    n_ns = (reads == ord("N")).sum(1)
    out = []
    for n in range(R):
        hits = []
        out.append(hits)
        if n_ns[n] >= 1 + lens[n] // 10:
            continue
        o = offs[n]
        tc = len(o) - 1
        mm0 = min(max(1, tc), 4) if tc <= 4 else min((4 * tc) // 5, 4)
        state = {"mm": mm0}
        if _find_matches(pos, bounds, n * S, o, 0, state, hits) \
                and len(hits) < MAX_HITS:
            _find_matches(pos, bounds, (R + n) * S, o, 1, state, hits)
    return out


# --- alignment -----------------------------------------------------------

def _is(x, letters):
    out = torch.zeros_like(x, dtype=torch.bool)
    for c in letters:
        out |= x == c
    return out


def dp_planes(refs, blens, reads, rlens, dtype, bisulfite=False):
    """The three DP planes of each lane, filled one anti-diagonal at a
    time; each cell's operations are the reference's, in its order, so
    float64 gives its values bit for bit.  Stored skewed: cell (i, j) of
    a lane at ``[lane, i + j, i]`` (``cell``), so that a diagonal and its
    two predecessors are plain slices."""
    H, N = refs.shape
    M = reads.shape[1]
    dev = refs.device
    op = torch.tensor(OPEN, dtype=dtype, device=dev)
    ex = torch.tensor(EXT, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    mis = torch.tensor(MISMATCH, dtype=dtype, device=dev)
    S0, S1, S2 = (torch.empty((H, N + M + 1, N + 1), dtype=dtype, device=dev)
                  for _ in range(3))
    first = -(op + torch.arange(M, dtype=dtype, device=dev) * ex)
    for p in (S0, S1, S2):
        p[:, 1:M + 1, 0] = first                 # row 0, j = 1..M
    d0 = torch.arange(N + 1, device=dev)
    S0[:, d0, d0] = 0                            # column 0, i = 0..N
    S1[:, d0, d0] = 0
    S2[:, d0, d0] = -op
    flip = reads.flip(1)                         # read[j-1] = flip[M-j]
    eq_n = _is(flip, b"Nn")
    is_t = _is(flip, b"Tt")
    ref_n = _is(refs, b"Nn")
    ref_c = _is(refs, b"Cc")
    for d in range(2, N + M + 1):
        lo, hi = max(1, d - M), min(N, d - 1)
        if lo > hi:
            continue
        r = slice(lo - 1, hi)                    # i - 1
        q = slice(M - d + lo, M - d + hi + 1)    # M - j
        eq = (refs[:, r] == flip[:, q]) | ref_n[:, r] | eq_n[:, q]
        if bisulfite:
            eq |= ref_c[:, r] & is_t[:, q]
        bump = torch.where(eq, one, mis)
        c0 = torch.maximum(torch.maximum(S0[:, d - 2, r] + bump,
                                         S1[:, d - 2, r] + bump),
                           S2[:, d - 2, r] + bump)
        c1 = torch.maximum(S0[:, d - 1, r] - op, S1[:, d - 1, r] - ex)
        c2 = torch.maximum(S0[:, d - 1, lo:hi + 1] - op,
                           S2[:, d - 1, lo:hi + 1] - ex)
        S0[:, d, lo:hi + 1] = c0
        S1[:, d, lo:hi + 1] = c1
        S2[:, d, lo:hi + 1] = c2
    return [S0, S1, S2]


def cell(S, lane, i, j):
    return S[lane, i + j, i]


def best_cells(S, blens, rlens):
    """(score, plane, row) of each lane: the best cell of the read's last
    column, the first row and plane that reach it (strict >)."""
    H, _, N1 = S[0].shape
    dev = S[0].device
    rows = torch.arange(N1, device=dev)[None, :]
    lane = torch.arange(H, device=dev)[:, None]
    v = [cell(p, lane, rows, rlens.long()[:, None]) for p in S]
    best = v[0][:, 0].clone()
    k = torch.zeros(H, dtype=torch.int64, device=dev)
    row = torch.zeros(H, dtype=torch.int64, device=dev)
    nn = blens.long().clamp(min=0)
    for i in range(1, N1):
        live = i <= nn
        for plane in range(3):
            up = live & (v[plane][:, i] > best)
            best = torch.where(up, v[plane][:, i], best)
            k = torch.where(up, plane, k)
            row = torch.where(up, i, row)
    return best, k, row


def _windows(genome, starts, blens):
    width = max(int(blens.max()), 1)
    idx = np.clip(starts[:, None] + np.arange(width)[None, :], 0,
                  len(genome) - 1)
    refs = genome[idx]
    refs[np.arange(width)[None, :] >= blens[:, None]] = 0
    return refs


def _block(device):
    return 16384 if torch.device(device).type == "cuda" else 2048


def align(genome, starts, blens, reads, rlens, dtype, device,
          bisulfite=False):
    """Scores, best planes and rows of windows ``starts``/``blens`` against
    the oriented ``reads`` (rows, ``rlens`` long)."""
    H = len(starts)
    score = np.zeros(H, np.float64)
    bk = np.zeros(H, np.int64)
    bi = np.zeros(H, np.int64)
    step = _block(device)
    for a in range(0, H, step):
        sl = slice(a, min(a + step, H))
        bl, rl = blens[sl], rlens[sl]
        dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        S = dp_planes(dev(_windows(genome, starts[sl], bl)), dev(bl),
                      dev(reads[sl, :int(rl.max())]), dev(rl), dtype,
                      bisulfite)
        s, k, i = best_cells(S, dev(np.maximum(bl, 0)), dev(rl))
        del S
        s = s.double().cpu().numpy()
        out = (bl > MAXN - 1) | (rl > MAXN - 1) | (rl < 1)
        score[sl] = np.where(out, -1e300, s)
        bk[sl] = k.cpu().numpy()
        bi[sl] = i.cpu().numpy()
    return score, bk, bi


def walk(genome, starts, blens, reads, rlens, ks, rows, dtype, device,
         bisulfite=False):
    """The walk back from each lane's (plane, row, last column): pileup
    events (lane, position, column 0-5) and insertions (lane, position,
    read offset, length), as the reference records them."""
    gs = len(genome)
    ev, ins = [], []
    H = len(starts)
    step = _block(device)
    for a in range(0, H, step):
        sl = slice(a, min(a + step, H))
        bl, rl = blens[sl], rlens[sl]
        dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        rd = dev(reads[sl, :int(rl.max())])
        S = dp_planes(dev(_windows(genome, starts[sl], bl)), dev(bl), rd,
                      dev(rl), dtype, bisulfite)
        e, n = _walk_block(S, rd, dev(starts[sl]), dev(ks[sl]),
                           dev(rows[sl]), dev(rl), gs, a)
        del S
        ev.append(e)
        ins.append(n)
    cat = (lambda xs, w: np.concatenate(xs) if xs
           else np.zeros((0, w), np.int64))
    return cat(ev, 3), cat(ins, 4)


def _walk_block(S, reads, p0, k, i, j, gs, base):
    H = reads.shape[0]
    dev = reads.device
    op = torch.tensor(OPEN, dtype=S[0].dtype, device=dev)
    ex = torch.tensor(EXT, dtype=S[0].dtype, device=dev)
    lane = torch.arange(H, device=dev)
    k, i, j = k.clone(), i.clone(), j.clone()
    ins_len = torch.zeros(H, dtype=torch.int64, device=dev)
    i1 = i - 1
    col_of = torch.full((256,), -1, dtype=torch.int64, device=dev)
    for c, v in _PILE_COL.items():
        col_of[c] = v
    ev, ins = [], []

    def at(plane, r, c):
        return cell(S[plane], lane, r.clamp(min=0), c.clamp(min=0))

    def note(m, g, col):
        ok = m & (g >= 0) & (g < gs)
        ev.append(torch.stack([lane[ok] + base, g[ok], col[ok]], 1))

    def note_ins(m, g):
        ok = m & (g >= 0) & (g < gs)
        ins.append(torch.stack([lane[ok] + base, g[ok], j[ok],
                                ins_len[ok]], 1))
        note(m, g, torch.full_like(g, 5))

    while True:
        act = (i > 0) & (j > 0)
        if not bool(act.any()):
            break
        i1 = torch.where(act, i - 1, i1)
        j1 = j - 1
        # diagonal predecessor: plane of the largest, first on ties
        a0, a1, a2 = at(0, i - 1, j1), at(1, i - 1, j1), at(2, i - 1, j1)
        kd = torch.where(a1 > a0, 1, 0)
        sd = torch.where(a1 > a0, a1, a0)
        kd = torch.where(a2 > sd, 2, kd)
        kh = torch.where(at(2, i, j1) - ex > at(0, i, j1) - op, 2, 0)
        kv = torch.where(at(1, i - 1, j) - ex > at(0, i - 1, j) - op, 1, 0)
        nk = torch.where(k == 0, kd, torch.where(k == 2, kh, kv))
        ni = torch.where(k == 2, i, i - 1)
        nj = torch.where(k == 1, j, j1)
        row_move = act & (ni != i)
        g = p0 + i1
        base_col = col_of[reads[lane, j1.clamp(min=0)].long()]
        diag = row_move & (nj != j) & (base_col >= 0)
        note(diag, g, base_col)
        note(row_move & (nj == j), g, torch.full_like(g, 4))
        note_ins(row_move & (ins_len > 0), g)
        ins_len = torch.where(row_move, 0,
                              torch.where(act, ins_len + 1, ins_len))
        i = torch.where(act, ni, i)
        j = torch.where(act, nj, j)
        k = torch.where(act, nk, k)
    note_ins((ins_len > 0) & (i >= 1), p0 + i1)
    return (torch.cat(ev).cpu().numpy() if ev else np.zeros((0, 3), np.int64),
            torch.cat(ins).cpu().numpy() if ins
            else np.zeros((0, 4), np.int64))


# --- the pair decision ---------------------------------------------------

def _single(smax, good, length):
    top, count, bsm = -2.0 * length, 0, 0
    for h, s in enumerate(smax):
        if s > top and s >= good:
            top, count, bsm = s, 1, h
        elif abs(s - top) < 0.0001 and count > 0:
            count += 1
    if count == 0:
        return NEITHER_MAP, 0, 0
    if count == 1:
        return UNIQUE_SINGLE, bsm, 1
    return NON_NO, 0, 0


def decide_pair(s1, p1, o1, len1, s2, p2, o2, len2, st):
    """(code, best1, best2, use1, use2) of one pair from its ends'
    candidate scores, positions and orientations, the ends' lengths and
    the settings ``st``."""
    n1, n2 = len(s1), len(s2)
    good1 = len1 * st.min_align * 1.0
    good2 = len2 * st.min_align * 1.0
    max_dist, min_dist = st.max_dist, st.min_dist
    if n1 and not n2:
        c, b, u = _single(s1, good1, float(len1))
        return c, b, 0, u, 0
    if n2 and not n1:
        c, b, u = _single(s2, good2, float(len2))
        return c, 0, b, 0, u
    if not n1:
        return NEITHER_MAP, 0, 0, 0, 0
    if n1 > 12000 or n2 > 12000:
        return NON_MIS, 0, 0, 0, 0
    perfect, slip, best, sm1, sm2 = 0, 0, -1e5, 0, 0
    for w1 in range(n1):
        if s1[w1] < good1:
            continue
        for w2 in range(n2):
            if s2[w2] < good2:
                continue
            d = abs(int(p1[w1]) - int(p2[w2]))
            if not (min_dist <= d <= max_dist and o1[w1] != o2[w2]):
                continue
            inc = s1[w1] + s2[w2] - best
            if inc > 0.001:
                perfect, sm1, sm2 = 1, w1, w2
                best = s1[w1] + s2[w2]
                slip = 1
            elif inc > -0.001:
                if sm1 == w1 or sm2 == w2:
                    slip += 1
                perfect += 1
    if perfect:
        if perfect == 1:
            return UNIQUE_MATE, sm1, sm2, 1, 1
        if slip == perfect:
            return UNIQUE_SLIP, sm1, sm2, 1, 1
        return NON_MATE, sm1, sm2, 0, 0
    pad1 = list(s1) + [-1.0] * (MAX_HITS - n1)
    pad2 = list(s2) + [-1.0] * (MAX_HITS - n2)
    b1 = b2 = c1 = c2 = 0
    for h in range(1, n1):
        if pad1[h] > pad1[b1]:
            b1, c1 = h, 1
        elif pad1[h] - pad1[b1] > -0.0001:
            c1 += 1
    for h in range(1, n2):
        if pad2[h] > pad2[b2]:
            b2, c2 = h, 1
        elif pad2[h] - pad2[b1] > -0.0001:   # the reference's own index
            c2 += 1
    ok2 = pad2[b2] >= good2 and c2 < 2
    if pad1[b1] >= good1:
        if c1 < 2:
            return (UNIQUE_MIS, b1, b2, 1, 1) if ok2 else \
                (UNIQUE_SINGLE, b1, b2, 1, 0)
        return (UNIQUE_SINGLE, b1, b2, 0, 1) if ok2 else \
            (NON_MIS, b1, b2, 0, 0)
    return (UNIQUE_SINGLE, b1, b2, 0, 1) if ok2 else (NON_MIS, b1, b2, 0, 0)


class Settings:
    """The mapping settings of a configuration."""

    def __init__(self, min_align, max_dist, min_dist, bisulfite=False):
        self.min_align = float(min_align)
        self.max_dist, self.min_dist = int(max_dist), int(min_dist)
        self.bisulfite = bool(bisulfite)


def map_pairs(genome, table, r1, l1, r2, l2, settings,
              dtype=torch.float64, device="cpu"):
    """Map read pairs (``r1``/``r2`` rows of bytes, ``l1``/``l2`` their
    lengths).  Returns ``codes``, ``m1``, ``m2`` (one a pair: the class
    and each end's .mfile value), ``events`` (pair, position, column) of
    the pileup and ``insertions`` as (pair, end, position, bases)."""
    P = len(l1)
    W = max(r1.shape[1], r2.shape[1])
    fwd = np.zeros((2 * P, W), np.uint8)
    fwd[:P, :r1.shape[1]] = r1
    fwd[P:, :r2.shape[1]] = r2
    lens = np.concatenate([l1, l2]).astype(np.int64)
    rc = revcomp(fwd, lens)
    hits = candidates(table, fwd, lens, rc)
    orient_rows = np.concatenate([fwd, rc])
    ist_end = len(genome) - (IDEPTH - 1)
    lane_of = {}
    lanes, starts, blens = [], [], []
    for n, hs in enumerate(hits):                 # n = end * P + pair
        for h, (a, off, o) in enumerate(hs):
            spot = max(0, a - off)
            st = max(0, spot - SLOP)
            en = min(ist_end, spot + int(lens[n]) + SLOP)
            lane_of[(n, h)] = len(lanes)
            lanes.append(n + (2 * P if o else 0))
            starts.append(st)
            blens.append(1 + en - st)
    lanes = np.asarray(lanes, np.int64)
    starts = np.asarray(starts, np.int64)
    blens = np.asarray(blens, np.int64)
    rlens = lens[lanes % (2 * P)]
    score, bk, bi = align(genome, starts, blens, orient_rows[lanes], rlens,
                          dtype, device, settings.bisulfite)
    codes = np.zeros(P, np.int64)
    m = np.zeros((2, P), np.int64)
    win = []                                      # lane, end, pair
    for p in range(P):
        ends = [(p, hits[p]), (P + p, hits[P + p])]
        sc = [[score[lane_of[(n, h)]] for h in range(len(hs))]
              for n, hs in ends]
        pos = [[max(0, a - off) for a, off, _ in hs] for _, hs in ends]
        ori = [[o for _, _, o in hs] for _, hs in ends]
        c, b1, b2, u1, u2 = decide_pair(
            sc[0], pos[0], ori[0], int(lens[p]), sc[1], pos[1], ori[1],
            int(lens[P + p]), settings)
        codes[p] = c
        for e, b, u in ((0, b1, u1), (1, b2, u2)):
            if u:
                ln = lane_of[(e * P + p, b)]
                m[e, p] = starts[ln] + bi[ln] + 1
                win.append((ln, e, p))
    wl = np.asarray([w[0] for w in win], np.int64)
    ev, ins = walk(genome, starts[wl], blens[wl], orient_rows[lanes[wl]],
                   rlens[wl], bk[wl], bi[wl], dtype, device,
                   settings.bisulfite)
    pair_of = np.asarray([w[2] for w in win], np.int64)
    end_of = np.asarray([w[1] for w in win], np.int64)
    events = np.stack([pair_of[ev[:, 0]], ev[:, 1], ev[:, 2]], 1) \
        if len(ev) else np.zeros((0, 3), np.int64)
    insertions = []
    for w, g, js, ln in ins:
        seq = orient_rows[lanes[wl[w]], js:js + ln].tobytes().decode()
        insertions.append((int(pair_of[w]), int(end_of[w]), int(g), seq))
    return dict(codes=codes, m1=m[0] & 0xFFFFFFFF, m2=m[1] & 0xFFFFFFFF,
                events=events, insertions=insertions)
