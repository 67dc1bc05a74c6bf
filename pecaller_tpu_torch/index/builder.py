"""Whole-genome 16-mer index builder.

Produces the four index artifacts (.seq/.sdx/.mdx/.idx) byte-identically
(after decompression) to the reference indexer
(/root/reference/src/index_genome_whole.c:93-354), but as a streamed
vectorized sort instead of a 48 GB direct-addressed table:

  fasta -> uppercase bytes -> 2-bit codes (chunked scan) -> rolling
  16-mer keys -> N-run validity mask -> (key<<32 | pos) uint64 pairs
  -> one in-place np.sort  == bucket lists

Sorting the packed (key, pos) pairs orders primarily by key and secondarily
by genome position — genome-scan order within each bucket, which is exactly
the append order of the reference's per-bucket growable arrays — with no
index arrays and no stable-argsort temporaries.  Memory envelope for
human-scale genomes: ~8 bytes/base for the pair buffer (hg38 ~25 GB),
versus the reference's >=48 GB direct-addressed table
(index_genome_whole.c:181-202); contigs are scanned in bounded chunks
(the reference streams base-at-a-time, :209-313).
"""

from __future__ import annotations

import gzip
import sys

import numpy as np

from ..formats.sdx import SdxInfo, write_sdx
from ..formats.index_files import SeedIndex, write_index_files
from ..ops.encode import BASE_BITS, BISULFITE_BASE_BITS, IDEPTH
from ..utils.hugemem import hp_empty

# only alphabetic characters survive, uppercased
# (index_genome_whole.c:248-253)
_ALPHA_UP = np.zeros(256, dtype=np.uint8)
for _c in range(128):                    # C-locale isalpha/toupper
    if chr(_c).isalpha():
        _ALPHA_UP[_c] = ord(chr(_c).upper())


def _iter_fasta(data: np.ndarray):
    """Yield (name, seq uint8 array) per contig from a fasta byte array.

    Mirrors the reference's header handling (index_genome_whole.c:228-240):
    name = header[1:] with trailing non-alphanumerics stripped and internal
    whitespace replaced by '_'.  Vectorized: no per-byte Python.
    """
    n = len(data)
    nl = np.nonzero(data == ord("\n"))[0]
    starts = np.concatenate([[0], nl + 1])
    starts = starts[starts < n]
    is_hdr = data[starts] == ord(">")
    hdr_starts = starts[is_hdr]
    for hi, hs in enumerate(hdr_starts):
        # header line ends at the next newline
        k = np.searchsorted(nl, hs)
        nxt = int(nl[k]) if k < len(nl) else n
        h = bytes(data[hs + 1:nxt])
        while h and not chr(h[-1]).isalnum():
            h = h[:-1]
        name = bytes((ord("_") if chr(c).isspace() else c)
                     for c in h).decode()
        seq_end = int(hdr_starts[hi + 1]) if hi + 1 < len(hdr_starts) \
            else n
        raw = data[nxt + 1 if nxt < n else n:seq_end]
        seq = _ALPHA_UP[raw]
        yield name, seq[seq != 0]


def _contig_pairs(seq: np.ndarray, gpos: int, bits_tab,
                  chunk: int = 1 << 26):
    """(key<<32 | local_pos + gpos) uint64 pairs for one contig, scanned
    in bounded chunks with IDEPTH-1 overlap."""
    L = seq.shape[0]
    if L < IDEPTH:
        return
    for lo in range(0, L - IDEPTH + 1, chunk):
        hi = min(lo + chunk + IDEPTH - 1, L)
        sub = seq[lo:hi]
        m = sub.shape[0] - IDEPTH + 1
        bits = bits_tab[sub]
        k = np.zeros(m, dtype=np.uint32)
        for j in range(IDEPTH):
            k <<= np.uint32(2)
            k += bits[j:j + m]
        isn = (sub == ord("N")).astype(np.int64)
        cn = np.concatenate([[0], np.cumsum(isn)])
        valid = (cn[IDEPTH:] - cn[:-IDEPTH]) == 0
        pos = np.nonzero(valid)[0].astype(np.uint64) + np.uint64(gpos + lo)
        pairs = (k[valid].astype(np.uint64) << np.uint64(32)) | pos
        if len(pairs):
            yield pairs


def build_index(fasta_path: str, basename: str, bisulfite: bool = False,
                gzip_level: int = 1, write_idx: bool = True,
                chunk: int = 1 << 26) -> SdxInfo:
    with open(fasta_path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)

    bits_tab = BISULFITE_BASE_BITS if bisulfite else BASE_BITS

    names = []
    stored_lens = []
    pair_chunks = []
    total_pairs = 0
    gpos = 0
    seqfile = gzip.open(basename + ".seq", "wb", compresslevel=gzip_level)
    try:
        for name, seq in _iter_fasta(data):
            names.append(name)
            seqfile.write(seq.tobytes())
            L = seq.shape[0]
            stored_lens.append(np.uint32((L - (IDEPTH - 1)) & 0xFFFFFFFF))
            for pairs in _contig_pairs(seq, gpos, bits_tab, chunk):
                pair_chunks.append(pairs)
                total_pairs += len(pairs)
            gpos += L - (IDEPTH - 1)
    finally:
        seqfile.close()
    if not names:
        raise ValueError(f"no contigs found in {fasta_path}")

    # single flat pair buffer (hugepage-backed), sorted in place: primary
    # key = 16-mer, secondary = global position == scan/append order
    pairs = hp_empty(total_pairs, np.uint64)
    off = 0
    while pair_chunks:
        c = pair_chunks.pop(0)
        pairs[off:off + len(c)] = c
        off += len(c)
    pairs.sort()

    kmers_sorted = (pairs >> np.uint64(32)).astype(np.uint32)
    positions_sorted = pairs.astype(np.uint32)      # low 32 bits
    keys, first = np.unique(kmers_sorted, return_index=True)
    starts = np.concatenate([first, [total_pairs]]).astype(np.int64)
    index = SeedIndex(keys=keys, starts=starts, positions=positions_sorted)
    if write_idx:
        write_index_files(basename, index, gzip_level=gzip_level)
    else:
        # skip the 16 GB dense .idx stream; persist the sparse form only
        positions_sorted.astype("<u4").tofile(basename + ".mdx")
        np.savez(basename + ".sidx.npz", keys=keys, starts0=starts[:-1])

    info = SdxInfo(names=names,
                   stored_lens=np.asarray(stored_lens, dtype=np.uint32),
                   idepth=IDEPTH)
    write_sdx(basename + ".sdx", info)
    return info


def index_genome_cli(argv=None) -> int:
    """Answer-file-compatible CLI: reads the same stdin prompt protocol as
    the reference (`index_genome < answers`, see README.md:20-34):

        line 1: S or D (output to screen/disk)
        [line: output filename, only if D]
        line:   max number of contig fasta files (ignored; we autoscan)
        line:   fasta path
        line:   basename
        line:   bisulfite? y/n
    """
    lines = sys.stdin.read().splitlines()
    it = iter(lines)
    first = next(it).strip()
    if "D" in first.upper():
        next(it)  # output file name; prompts echo ignored
    next(it)      # max fasta count
    fasta = next(it).strip()
    basename = next(it).strip()
    bis = next(it).strip().upper().startswith("Y")
    build_index(fasta, basename, bisulfite=bis)
    return 0
