"""The .idx/.mdx seed-index pair (CSR layout over the 4^16 k-mer space).

Reference format (index_genome_whole.c:320-344):

* ``.mdx``  raw little-endian uint32 genome positions (index coords),
            concatenated bucket-by-bucket in ascending k-mer order;
            within a bucket, positions appear in genome-scan order
            (i.e. ascending).
* ``.idx``  gzip stream of 2^32 + 1 uint32 prefix sums: entry k is the
            .mdx offset of bucket k's first position; the final entry is
            the total position count.

The dense 2^32-entry table is a *file* format, not our in-memory layout:
we keep a sparse CSR (sorted unique keys, per-key offsets) which is
equivalent and ~1000x smaller for real genomes.  The dense prefix stream
is generated on the fly from the sparse form when writing, and sparsified
when reading.
"""

from __future__ import annotations

import gzip
import os
import zlib
from dataclasses import dataclass

import numpy as np

from ..utils.log import span

KMER_SPACE = 1 << 32
_CHUNK = 1 << 24          # buckets per streaming chunk when (de)serializing


@dataclass
class SeedIndex:
    """Sparse CSR view of the seed index.

    ``keys``    sorted unique uint32 k-mers present in the genome
    ``starts``  int64 offsets into ``positions`` (len == len(keys)+1)
    ``positions`` uint32 genome positions (index coords), bucket-major
    """
    keys: np.ndarray
    starts: np.ndarray
    positions: np.ndarray

    def counts_of(self, query: np.ndarray) -> np.ndarray:
        """Bucket sizes for an array of k-mer keys (0 for absent keys)."""
        idx = np.searchsorted(self.keys, query)
        idx_c = np.minimum(idx, len(self.keys) - 1) if len(self.keys) else idx * 0
        present = np.zeros(query.shape, dtype=bool)
        if len(self.keys):
            present = self.keys[idx_c] == query
        cnt = np.zeros(query.shape, dtype=np.int64)
        if len(self.keys):
            cnt[present] = (self.starts[idx_c + 1] - self.starts[idx_c])[present]
        return cnt

    def lookup(self, query: np.ndarray):
        """(start, count) pairs into ``positions`` for each query key."""
        if len(self.keys) == 0:
            z = np.zeros(query.shape, dtype=np.int64)
            return z, z
        idx = np.searchsorted(self.keys, query)
        idx_c = np.minimum(idx, len(self.keys) - 1)
        present = self.keys[idx_c] == query
        start = np.where(present, self.starts[idx_c], 0)
        cnt = np.where(present, self.starts[idx_c + 1] - self.starts[idx_c], 0)
        return start, cnt


def write_index_files(basename: str, index: SeedIndex,
                      gzip_level: int = 1) -> None:
    """Write ``basename.mdx`` (raw) and ``basename.idx`` (gzip prefix sums).

    The .idx stream is produced chunk-by-chunk: prefix[k] = number of
    positions in buckets < k = starts[searchsorted(keys, k)] — no dense
    2^32 array is ever materialized.
    """
    index.positions.astype("<u4").tofile(basename + ".mdx")

    total = np.uint32(index.starts[-1])
    # The dense prefix stream is a step function: constant starts[j] on
    # [keys[j], keys[j+1]).  Emit it as run-length repeats, compressed with
    # Z_RLE (runs dominate), instead of per-bucket lookups.
    keys64 = index.keys.astype(np.int64)
    bounds = np.concatenate([[0], keys64 + 1, [KMER_SPACE]])
    values = np.concatenate([[0], index.starts[1:]]).astype("<u4")
    lengths = np.diff(bounds)
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    # split runs longer than _CHUNK so each np.repeat batch stays bounded
    n_sub = ((lengths - 1) // _CHUNK + 1).astype(np.int64)
    if (n_sub > 1).any():
        values = np.repeat(values, n_sub)
        sub_l = np.repeat(lengths, n_sub)
        sub_i = np.arange(len(sub_l)) - np.repeat(
            np.concatenate([[0], np.cumsum(n_sub)[:-1]]), n_sub)
        lengths = np.minimum(sub_l - sub_i * _CHUNK, _CHUNK)

    gz = zlib.compressobj(gzip_level, zlib.DEFLATED, 16 + zlib.MAX_WBITS, 9)
    fillbuf = np.empty(_CHUNK, dtype="<u4")
    with open(basename + ".idx", "wb") as f:
        cum = np.cumsum(lengths)
        lo = 0
        while lo < len(values):
            hi = int(np.searchsorted(cum, (cum[lo - 1] if lo else 0) + _CHUNK,
                                     side="left")) + 1
            hi = min(max(hi, lo + 1), len(values))
            if hi == lo + 1:          # one constant run: memset, not repeat
                n = int(lengths[lo])
                fillbuf[:n].fill(values[lo])
                payload = fillbuf[:n].tobytes()
            else:
                payload = np.repeat(values[lo:hi], lengths[lo:hi]).tobytes()
            f.write(gz.compress(payload))
            lo = hi
        f.write(gz.compress(np.asarray([total], dtype="<u4").tobytes()))
        f.write(gz.flush())


def read_mdx(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u4")


def read_idx(path: str) -> np.ndarray:
    """Read the full dense prefix array (2^32+1 uint32).  Test use only —
    allocates 16 GB for a real genome; prefer ``load_index``."""
    with gzip.open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype="<u4")


def _sparsify_idx_stream(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Stream the .idx gz and return (keys, starts) for non-empty buckets.

    Bucket k is non-empty iff prefix[k+1] > prefix[k]; its .mdx offset is
    prefix[k].  Works on bounded ~256 MB decompressed windows.
    """
    keys_parts, starts_parts = [], []
    dec = zlib.decompressobj(16 + zlib.MAX_WBITS)
    carry = b""
    bucket_base = 0          # index of the first prefix entry in `chunk`
    prev_tail = None         # last prefix value of the previous chunk
    max_out = 1 << 28

    def process(chunk):
        nonlocal bucket_base, prev_tail
        if chunk.size == 0:
            return
        d0 = chunk[1:] - chunk[:-1]          # exact in uint32 (monotone)
        nz0 = np.nonzero(d0)[0]
        if prev_tail is not None and chunk[0] != prev_tail:
            keys_parts.append(np.asarray([bucket_base - 1], dtype=np.int64))
            starts_parts.append(np.asarray([prev_tail], dtype=np.int64))
        keys_parts.append(bucket_base + nz0)
        starts_parts.append(chunk[nz0].astype(np.int64))
        bucket_base += chunk.size
        prev_tail = chunk[-1]

    with open(path, "rb") as f:
        raw = b""
        while True:
            if not dec.unconsumed_tail:
                raw = f.read(1 << 22)
                if not raw:
                    break
                data = dec.decompress(raw, max_out)
            else:
                data = dec.decompress(dec.unconsumed_tail, max_out)
            data = carry + data
            usable = len(data) - (len(data) % 4)
            process(np.frombuffer(data[:usable], dtype="<u4"))
            carry = data[usable:]
        data = carry + dec.flush()
        usable = len(data) - (len(data) % 4)
        process(np.frombuffer(data[:usable], dtype="<u4"))
    keys = (np.concatenate(keys_parts) if keys_parts
            else np.zeros(0, np.int64))
    starts0 = (np.concatenate(starts_parts) if starts_parts
               else np.zeros(0, np.int64))
    return keys.astype(np.uint32), starts0


@span("index.files.idx")
def load_index(basename: str, cache: bool = True) -> SeedIndex:
    """Load a seed index into the sparse CSR form.

    The sparsified (keys, starts) pair is cached in ``basename.sidx.npz``
    so repeated loads skip the 16 GB .idx decompression.
    """
    cache_path = basename + ".sidx.npz"
    idx_path = basename + ".idx"
    mdx_path = basename + ".mdx"
    positions = np.memmap(mdx_path, dtype="<u4", mode="r") \
        if os.path.getsize(mdx_path) else np.zeros(0, dtype=np.uint32)
    if os.path.exists(cache_path) and (
            not os.path.exists(idx_path) or
            (cache and
             os.path.getmtime(cache_path) >= os.path.getmtime(idx_path))):
        z = np.load(cache_path)
        keys, starts0 = z["keys"], z["starts0"]
    else:
        keys, starts0 = _sparsify_idx_stream(idx_path)
        if cache:
            np.savez(cache_path, keys=keys, starts0=starts0)
    total = positions.shape[0]
    starts = np.concatenate([starts0, [total]]).astype(np.int64)
    return SeedIndex(keys=keys, starts=starts, positions=positions)
