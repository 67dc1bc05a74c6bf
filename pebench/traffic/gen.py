"""The general generator: a configuration's genome and a traffic mix's
read pairs, drawn in bulk with NumPy, and their FASTQ files.

The read model is wgsim's (https://github.com/lh3/wgsim, ``wgsim.c``),
with the numbers in the mix's file:

* the sample's genome is diploid: at each base a mutation with
  probability ``mut_rate``; a share ``indel_frac`` of them indels (half
  deletions, extended base by base with probability ``indel_extend``;
  half insertions after the base of 1 to ``max_ins`` drawn bases, each
  further base with probability ``indel_extend``), the rest substitutions
  to another base; each mutation on both haplotypes with probability
  ``hom_frac``, else on one drawn at random;
* a pair: a haplotype drawn at random, the fragment's outer length from
  a normal of ``outer_mean`` and ``outer_sd`` (at least the read
  length), its start uniform on the genome; read 1 the fragment's first
  ``read_len`` bases, read 2 the reverse complement of its last; the two
  ends swapped with probability 1/2;
* each read base replaced by another base with probability
  ``err_rate``; every quality the one wgsim writes for that rate.
"""

from __future__ import annotations

import gzip

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b
_CODE = np.zeros(256, np.uint8)
_CODE[BASES] = np.arange(4, dtype=np.uint8)


def genome(config: dict) -> np.ndarray:
    """The configuration's genome: random A/C/G/T from its own seed."""
    rng = np.random.default_rng(config["genome_seed"])
    return BASES[rng.integers(0, 4, size=config["genome_length"])]


def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 70):
    n = len(seq)
    rows = -(-n // width)
    buf = np.full(rows * (width + 1), ord("\n"), np.uint8)
    body = buf.reshape(rows, width + 1)
    flat = np.zeros(rows * width, np.uint8)
    flat[:n] = seq
    body[:, :width] = flat.reshape(rows, width)
    out = body.ravel()
    if n % width:
        out = out[:len(out) - (width - n % width) - 1]
        out = np.concatenate([out, np.frombuffer(b"\n", np.uint8)])
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(out.tobytes())


def _other(rng, bases: np.ndarray) -> np.ndarray:
    """Each base replaced by one of the three others, drawn uniformly."""
    c = _CODE[bases] + rng.integers(1, 4, size=bases.shape)
    return BASES[c % 4]


def _geometric_len(rng, n: int, extend: float, cap: int | None) -> np.ndarray:
    """1 plus the number of further bases, each with probability
    ``extend``; at most ``cap``."""
    k = rng.geometric(1.0 - extend, size=n)
    return np.minimum(k, cap) if cap else k


def mutations(rng, seq: np.ndarray, t: dict) -> list:
    """The two haplotypes' mutations: for each, (substitutions: sites and
    bases; deletions: sites and lengths; insertions: sites and bases)."""
    G = len(seq)
    sites = np.unique(rng.integers(0, G, size=rng.binomial(G, t["mut_rate"])))
    n = len(sites)
    kind = np.where(rng.random(n) >= t["indel_frac"], 0,
                    np.where(rng.random(n) < 0.5, 1, 2))
    hom = rng.random(n) < t["hom_frac"]
    one = rng.integers(0, 2, size=n)
    sub = _other(rng, seq[sites])
    dlen = _geometric_len(rng, n, t["indel_extend"], None)
    ilen = _geometric_len(rng, n, t["indel_extend"], t["max_ins"])
    ibases = BASES[rng.integers(0, 4, size=(n, t["max_ins"]))]
    haps = []
    for h in (0, 1):
        on = hom | (one == h)
        s, d, i = on & (kind == 0), on & (kind == 1), on & (kind == 2)
        haps.append(dict(sub=(sites[s], sub[s]), dele=(sites[d], dlen[d]),
                         ins=(sites[i], ilen[i], ibases[i])))
    return haps


def haplotype(seq: np.ndarray, m: dict):
    """The haplotype's bases and, for each genome base, the index of its
    first base in the haplotype (``first``) and one past its last
    (``ends``): a deleted base has none, an insertion follows its base."""
    G = len(seq)
    base = seq.copy()
    base[m["sub"][0]] = m["sub"][1]
    d0, dl = m["dele"]
    cover = np.zeros(G + 1, np.int64)      # deletions over each base
    np.add.at(cover, d0, 1)
    np.add.at(cover, np.minimum(d0 + dl, G), -1)
    keep = (np.cumsum(cover)[:G] == 0).astype(np.int64)
    i0, il, ib = m["ins"]
    rep = keep.copy()
    live = keep[i0] > 0
    i0, il, ib = i0[live], il[live], ib[live]
    rep[i0] += il
    ends = np.cumsum(rep)
    first = ends - rep
    hap = np.empty(int(ends[-1]) if G else 0, np.uint8)
    kept = np.nonzero(keep)[0]
    hap[first[kept]] = base[kept]
    if len(i0):
        at = first[i0][:, None] + 1 + np.arange(ib.shape[1])[None, :]
        ok = np.arange(ib.shape[1])[None, :] < il[:, None]
        hap[at[ok]] = ib[ok]
    return hap, first, ends


def pairs(seq: np.ndarray, n_pairs: int, traffic: dict) -> dict:
    """The mix's ``n_pairs`` read pairs from ``seq``, drawn from its own
    ``draw_seed``: ``r1``, ``r2`` (n, read_len) bytes, ``l1``, ``l2``
    their lengths, and the truth on the genome: the fragment's ``start``
    and outer length ``insert``, its haplotype ``hap``, ``swapped``."""
    t = traffic
    rng = np.random.default_rng(t["draw_seed"])
    L = t["read_len"]
    G = len(seq)
    haps = [haplotype(seq, m) for m in mutations(rng, seq, t)]
    ins = np.rint(rng.normal(t["outer_mean"], t["outer_sd"], size=n_pairs))
    ins = np.clip(ins, L, G).astype(np.int64)
    start = (rng.random(n_pairs) * (G - ins + 1)).astype(np.int64)
    which = rng.integers(0, 2, size=n_pairs)
    r1 = np.empty((n_pairs, L), np.uint8)
    r2 = np.empty((n_pairs, L), np.uint8)
    j = np.arange(L)[None, :]
    for h, (hap, first, ends) in enumerate(haps):
        sel = np.nonzero(which == h)[0]
        top = len(hap) - L
        a = np.clip(first[start[sel]], 0, top)
        b = np.clip(ends[start[sel] + ins[sel] - 1] - L, 0, top)
        r1[sel] = hap[a[:, None] + j]
        r2[sel] = _COMP[hap[b[:, None] + j][:, ::-1]]
    for r in (r1, r2):
        err = np.nonzero(rng.random(r.shape, dtype=np.float32)
                         < t["err_rate"])
        r[err] = _other(rng, r[err])
    swap = rng.random(n_pairs) < 0.5
    a1, a2 = r1.copy(), r2.copy()
    a1[swap], a2[swap] = r2[swap], r1[swap]
    lens = np.full(n_pairs, L, np.int64)
    return dict(r1=a1, r2=a2, l1=lens, l2=lens.copy(), start=start,
                insert=ins, hap=which, swapped=swap)


def quality(err_rate: float) -> int:
    """The quality character wgsim writes for every base."""
    return int(-10.0 * np.log10(err_rate) + 0.499) + 33


def fastq_bytes(reads: np.ndarray, lens: np.ndarray, qual: int) -> bytes:
    """FASTQ records ``@r<9-digit number>``, the read, ``+``, quality
    ``qual`` a base, built in one piece: each record laid out on a row
    of the longest record's width, then the rows' live bytes taken in
    order."""
    n, W = reads.shape
    rows = np.empty((n, 16 + 2 * W), np.uint8)
    rows[:, 0] = ord("@")
    rows[:, 1] = ord("r")
    rows[:, 2:11] = (np.arange(n)[:, None]
                     // 10 ** np.arange(8, -1, -1)[None, :]) % 10 + ord("0")
    rows[:, 11] = ord("\n")
    rows[:, 12:12 + W] = reads
    rows[:, 12 + W:15 + W] = np.frombuffer(b"\n+\n", np.uint8)
    rows[:, 15 + W:15 + 2 * W] = qual
    rows[:, 15 + 2 * W] = ord("\n")
    j = np.arange(W)[None, :]
    keep = np.ones((n, 16 + 2 * W), bool)
    keep[:, 12:12 + W] = j < lens[:, None]
    keep[:, 15 + W:15 + 2 * W] = j < lens[:, None]
    return rows[keep].tobytes()


def write_fastq_gz(paths, reads, lens, qual: int):
    """Each end's reads as a gzip FASTQ (level 1), as sequencers hand
    them over; the files are built and compressed side by side."""
    from concurrent.futures import ThreadPoolExecutor

    def one(path, r, n):
        with open(path, "wb") as f:
            f.write(gzip.compress(fastq_bytes(r, n, qual), compresslevel=1))
    with ThreadPoolExecutor(len(paths)) as ex:
        for fut in [ex.submit(one, *a) for a in zip(paths, reads, lens)]:
            fut.result()
