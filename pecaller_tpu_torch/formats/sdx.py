"""The .sdx contig-table format and the two genome coordinate systems.

Format (text), as written by the reference indexer
(/root/reference/src/index_genome_whole.c:347-351):

    line 0:            n_contigs
    lines 1..n:        <stored_len>\t<name>
    line n+1:          idepth   (always 16)

``stored_len`` is NOT the contig length: the indexer starts each contig's
position counter at ``1 - idepth`` (index_genome_whole.c:215), so the stored
value is ``true_len - 15``.  This creates two coordinate systems:

* **index coords**: cumsum of stored lengths.  K-mer positions in .mdx live
  here.  Contig ``c`` nominally begins at ``istarts[c]``.
* **seq coords**: offsets into the concatenated .seq genome, i.e. cumsum of
  true lengths = ``istarts[c] + 15*c``.  Pileup positions live here
  (pemapper.c:821-822 adds the +15/contig before emitting output).

Readers must reproduce this arithmetic exactly for byte parity.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from ..utils.log import span

_BIG = np.int64(2**62)


@dataclass
class SdxInfo:
    names: list                # contig names
    stored_lens: np.ndarray    # uint32, as stored in the file (true_len - 15)
    idepth: int

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    @property
    def istarts(self) -> np.ndarray:
        """Index-coordinate contig starts: cumsum of stored lengths.

        Matches pemapper.c:434-448 (contig_starts before the +15 fixup).
        Length n_contigs+1; istarts[n] == total index-space length.
        """
        out = np.zeros(self.n_contigs + 1, dtype=np.int64)
        np.cumsum(self.stored_lens.astype(np.int64), out=out[1:])
        return out

    @property
    def sstarts(self) -> np.ndarray:
        """Seq-coordinate contig starts: istarts[c] + 15*c.

        Matches the fixup loop at pemapper.c:821-822 / pecaller.c:466-468.
        sstarts[n] == genome_size (total bases in .seq).
        """
        ist = self.istarts
        return ist + 15 * np.arange(self.n_contigs + 1, dtype=np.int64)

    @property
    def genome_size(self) -> int:
        return int(self.sstarts[self.n_contigs])

    @property
    def true_lens(self) -> np.ndarray:
        return self.stored_lens.astype(np.int64) + 15


@span("index.files.sdx")
def read_sdx(path: str) -> SdxInfo:
    names, lens = [], []
    with open(path, "r") as f:
        n = int(f.readline().split()[0])
        for _ in range(n):
            tok = f.readline().split("\t")
            lens.append(int(tok[0]))
            names.append(tok[1].strip())
        idepth = int(f.readline().split()[0])
    return SdxInfo(names=names, stored_lens=np.asarray(lens, dtype=np.uint32),
                   idepth=idepth)


def write_sdx(path: str, info: SdxInfo) -> None:
    with open(path, "w") as f:
        f.write(f"{info.n_contigs}\n")
        for ln, name in zip(info.stored_lens, info.names):
            f.write(f"{int(np.int32(np.uint32(ln)))}\t{name}\n")
        f.write(f"{info.idepth}\n")


@span("index.files.seq")
def read_seq(path: str, genome_size: int | None = None) -> np.ndarray:
    """Read the gzip .seq genome into a uint8 byte array (ASCII codes)."""
    with gzip.open(path, "rb") as f:
        data = f.read() if genome_size is None else f.read(genome_size)
    return np.frombuffer(data, dtype=np.uint8)


def _padded(starts: np.ndarray, upto: int) -> np.ndarray:
    """Pad a starts array with +inf sentinels out to index ``upto``.

    The reference's find_chrom (pemapper.c:2168) always starts probing at
    index 7, reading past the array for genomes with < 8 contigs.  A +inf
    sentinel reproduces the benign "garbage is big" behaviour.
    """
    starts = starts.astype(np.int64)
    if starts.shape[0] >= upto + 1:
        return starts
    pad = np.full(upto + 1 - starts.shape[0], _BIG, dtype=np.int64)
    return np.concatenate([starts, pad])


def find_chrom_mapper(starts: np.ndarray, n_contigs: int, pos) -> np.ndarray:
    """Exact vectorized emulation of pemapper.c:2168-2186 find_chrom.

    Recursive search for ``t`` with starts[t] <= pos <= starts[t+1],
    always beginning the probe at index 7 (a reference quirk).  Out-of-range
    probes read a +inf sentinel.
    """
    pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
    st = _padded(starts, max(n_contigs + 1, 70))
    ns = st.shape[0]

    first = np.zeros_like(pos)
    last = np.full_like(pos, n_contigs - 1)
    trie = np.full_like(pos, 7)
    result = np.full_like(pos, -1)
    done = np.zeros(pos.shape, dtype=bool)
    for _ in range(80):
        eq = (first == last) & ~done
        result = np.where(eq, first, result)
        done |= eq
        ci = np.clip(trie, 0, ns - 2)
        v_try = np.where((trie >= 0) & (trie <= ns - 2), st[ci], _BIG)
        v_try1 = np.where((trie >= -1) & (trie <= ns - 2), st[ci + 1], _BIG)
        hit = (~done) & (v_try <= pos) & (v_try1 >= pos)
        result = np.where(hit, trie, result)
        done |= hit
        go_low = (~done) & (v_try > pos)
        go_high = (~done) & ~go_low
        last = np.where(go_low, trie - 1, last)
        first = np.where(go_high, trie + 1, first)
        trie = np.where(~done, (last + first) // 2, trie)
        if done.all():
            break
    return result


def _find_chrom_caller_one(fp: np.ndarray, nmax: int, start_try: int,
                           p: int) -> int:
    """The pecaller.c:1793-1816 find_chrom recursion for ONE position —
    scalar transliteration used by the sorted fast path below."""
    first, last, trie = 0, nmax, start_try
    for _ in range(80):
        if first == last:
            return first
        vfirst = int(fp[min(max(first, 0), nmax)])
        if first >= trie:
            return first + 1 if p > vfirst else first
        if last <= trie:
            return last
        v = int(fp[min(max(trie, 0), nmax)])
        if v < p:
            first, trie = trie, (last + trie) // 2
        elif v > p:
            last, trie = trie, (trie + first) // 2
        else:
            return trie + 1
    return -1


def find_chrom_caller(frag_pos: np.ndarray, n_contigs: int, start_try: int,
                      pos) -> np.ndarray:
    """Exact vectorized emulation of pecaller.c:1793-1816 find_chrom.

    ``frag_pos`` is the caller's cumsum-of-true-lens array indexed 0..n-1.
    Returns the contig index c such that site ``pos`` lies in
    [frag_pos[c-1], frag_pos[c]) (boundary cases follow the exact recursion).
    """
    pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
    if len(pos) >= 1024 and bool((pos[1:] >= pos[:-1]).all()):
        # sorted fast path: the recursion's result as a function of p
        # is constant between breakpoints {fp[c], fp[c]+1} (every
        # comparison against every fp value is constant there), so one
        # scalar evaluation per run replaces the vectorized search —
        # whose ~40 full-size temporaries per iteration page-fault this
        # VM at ~40 MB/s
        fp = frag_pos.astype(np.int64)
        nmax = n_contigs - 1
        cand = np.unique(np.concatenate([fp, fp + 1]))
        cuts = np.searchsorted(pos, cand, side="left")
        bounds = np.unique(np.concatenate(
            [[0], cuts[(cuts > 0) & (cuts < len(pos))], [len(pos)]]))
        out = np.empty(len(pos), dtype=np.int64)
        for a, b in zip(bounds[:-1], bounds[1:]):
            out[a:b] = _find_chrom_caller_one(fp, nmax, start_try,
                                              int(pos[a]))
        return out
    fp = frag_pos.astype(np.int64)
    nmax = n_contigs - 1
    first = np.zeros_like(pos)
    last = np.full_like(pos, nmax)
    trie = np.full_like(pos, start_try)
    result = np.full_like(pos, -1)
    done = np.zeros(pos.shape, dtype=bool)
    for _ in range(80):
        c1 = (first == last) & ~done
        result = np.where(c1, first, result)
        done |= c1
        vfirst = fp[np.clip(first, 0, nmax)]
        c2 = (first >= trie) & ~done
        result = np.where(c2, np.where(pos > vfirst, first + 1, first), result)
        done |= c2
        c3 = (last <= trie) & ~done
        result = np.where(c3, last, result)
        done |= c3
        v = fp[np.clip(trie, 0, nmax)]
        lt = (~done) & (v < pos)
        gt = (~done) & (v > pos)
        eqc = (~done) & (v == pos)
        result = np.where(eqc, trie + 1, result)
        done |= eqc
        nfirst = np.where(lt, trie, first)
        nlast = np.where(gt, trie, last)
        ntrie = np.where(lt, (last + trie) // 2,
                         np.where(gt, (trie + first) // 2, trie))
        first, last, trie = nfirst, nlast, ntrie
        if done.all():
            break
    return result


def find_chrom_dump(frag_pos: np.ndarray, n_contigs: int, pos) -> np.ndarray:
    """Exact emulation of dump_pileups.c:1577-1597 find_chrom, as invoked
    at :856 with (first=0, last=n_contigs, try=7).

    This variant lacks pecaller's first==last guard; for genomes with
    <= 7 contigs the `last <= try` branch returns ``n_contigs`` — one past
    the last contig — so rows get an empty fragment name and a negative
    position.  Reproduced for dump-mode byte parity.
    """
    pos = np.atleast_1d(np.asarray(pos, dtype=np.int64))
    fp = frag_pos.astype(np.int64)
    nmax = len(fp) - 1
    first = np.zeros_like(pos)
    last = np.full_like(pos, n_contigs)
    trie = np.full_like(pos, 7)
    result = np.full_like(pos, -1)
    done = np.zeros(pos.shape, dtype=bool)
    for _ in range(80):
        vfirst = fp[np.clip(first, 0, nmax)]
        c1 = (first >= trie) & ~done
        result = np.where(c1, np.where(pos > vfirst, first + 1, first),
                          result)
        done |= c1
        c2 = (last <= trie) & ~done
        result = np.where(c2, last, result)
        done |= c2
        v = fp[np.clip(trie, 0, nmax)]
        lt = (~done) & (v < pos)
        gt = (~done) & (v > pos)
        eqc = (~done) & (v == pos)
        result = np.where(eqc, trie + 1, result)
        done |= eqc
        nfirst = np.where(lt, trie, first)
        nlast = np.where(gt, trie, last)
        ntrie = np.where(lt, (last + trie) // 2,
                         np.where(gt, (trie + first) // 2, trie))
        first, last, trie = nfirst, nlast, ntrie
        if done.all():
            break
    return result
