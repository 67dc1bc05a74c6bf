"""Base encodings and k-mer machinery (host-side, vectorized numpy).

Conventions shared with the reference:
* 2-bit codes A=0 C=1 G=2 T=3; every other letter (incl. IUPAC) is 0,
  matching the indexer's bit table (index_genome_whole.c:169-177) and the
  mapper's convert tables (pemapper.c:2376-2383).  Only the letter 'N'
  resets the k-mer run in the indexer.
* Bisulfite mode maps C->3 (== T) at index time; the mapper instead
  rewrites read C->T before key extraction (pemapper.c:2292-2300).
* A 16-mer key packs base codes MSB-first into a uint32
  (pemapper.c:2408-2423).
"""

from __future__ import annotations

import numpy as np

IDEPTH = 16

# char-code -> 2-bit tables (256 entries, ASCII indexed)
BASE_BITS = np.zeros(256, dtype=np.uint32)
for _c, _v in (("C", 1), ("G", 2), ("T", 3), ("c", 1), ("g", 2), ("t", 3)):
    BASE_BITS[ord(_c)] = _v

BISULFITE_BASE_BITS = BASE_BITS.copy()
BISULFITE_BASE_BITS[ord("C")] = 3
BISULFITE_BASE_BITS[ord("c")] = 3

_RC = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
               ("W", "W"), ("S", "S"), ("K", "M"), ("M", "K"),
               ("Y", "R"), ("R", "Y")):
    _RC[ord(_a)] = ord(_b)


def encode_bases(ascii_codes: np.ndarray, bisulfite: bool = False) -> np.ndarray:
    """ASCII byte array -> 2-bit codes (uint32), non-ACGT -> 0."""
    table = BISULFITE_BASE_BITS if bisulfite else BASE_BITS
    return table[ascii_codes]


def revcomp_bytes(seq: np.ndarray) -> np.ndarray:
    """Reverse-complement of an ASCII byte array.

    Exactly mirrors reverse_transcribe (pemapper.c:2303-2337): IUPAC
    W/S/K/M/Y/R map to their complements, everything else to 'N'.
    """
    return _RC[seq[::-1]]


def rolling_kmers(bits: np.ndarray, k: int = IDEPTH) -> np.ndarray:
    """All k-mer keys of a 2-bit code vector; kmers[i] covers bits[i:i+k].

    MSB-first packing: key = sum bits[i+j] << 2*(k-1-j).
    """
    n = bits.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint32)
    out = np.zeros(n - k + 1, dtype=np.uint32)
    for j in range(k):
        out <<= np.uint32(2)
        out += bits[j:j + n - k + 1].astype(np.uint32)
    return out


# --- 1-mismatch neighborhood ------------------------------------------------
# The mapper expands each 16-mer into its 48 single-substitution variants by
# substituting each 2-bit field of each of the 4 key bytes through a 256x12
# byte table (pemapper.c:546-565, fill_mers :1969-2003).  Enumeration order
# matters (it fixes candidate ordering downstream), so we reproduce it:
# for byte b in [low, mid-low, mid-high, high]: for field j in 0..3 (low
# field first): for code k in 0..3, k != current: variant.

def _build_byte_mismatch_table() -> np.ndarray:
    tab = np.zeros((256, 12), dtype=np.int64)
    for i in range(256):
        a = [(i >> (2 * j)) & 3 for j in range(4)]
        which = 0
        for j in range(4):
            start = i - (a[j] << (2 * j))
            for k in range(4):
                if k != a[j]:
                    tab[i][which] = start + (k << (2 * j))
                    which += 1
    return tab

_BYTE_MM = _build_byte_mismatch_table()


def mismatch_neighborhood_keys(keys: np.ndarray) -> np.ndarray:
    """(N,) uint32 keys -> (N, 49) uint32: [exact, 48 variants] per key,
    in the reference's fill_mers enumeration order."""
    keys = keys.astype(np.uint32)
    n = keys.shape[0]
    out = np.empty((n, 49), dtype=np.uint32)
    out[:, 0] = keys
    col = 1
    k64 = keys.astype(np.int64)
    for bshift in (0, 8, 16, 24):
        byte = (k64 >> bshift) & 0xFF
        base = k64 - (byte << bshift)
        var = _BYTE_MM[byte]                      # (N, 12)
        out[:, col:col + 12] = ((base[:, None] + (var << bshift))
                                .astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        col += 12
    return out
