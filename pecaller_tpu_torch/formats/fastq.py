"""Fastq streaming with the reference reader's exact record semantics.

The reference (pemapper.c:653-750, my_gzgets :2447-2483) reads records as:
header line, sequence line, then skips lines until the next line starting
with '@' (taken as the next header).  Mapping STOPS entirely at the first
sequence of length <= 12 (the `seq_len > 12` loop condition), and at
``max_reads``.  Lines are hard-capped below MAX_READ_LENGTH=300 chars.
"""

from __future__ import annotations

import gzip

import numpy as np

MAX_READ_LENGTH = 300


def _open(path: str):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


def iter_fastq_seqs(path: str):
    """Yield sequence lines (bytes) following the reference's record walk."""
    with _open(path) as f:
        line = f.readline()
        if not line:
            return
        seq = f.readline().rstrip(b"\n")
        while True:
            if len(seq) > MAX_READ_LENGTH - 1:
                seq = seq[:MAX_READ_LENGTH - 1]
            yield seq
            # skip '+' and quality, then scan for the next '@' header
            f.readline()
            f.readline()
            line = f.readline()
            found = False
            while line:
                if line.startswith(b"@"):
                    found = True
                    break
                line = f.readline()
            if not found:
                return
            seq = f.readline().rstrip(b"\n")
            if not seq:
                return


class FastqBatcher:
    """Batch a fastq (pair) into fixed-size numpy read batches.

    Emulates the reference batching: 20 000 reads per batch
    (pemapper.c:158), stop at the first read of length <= 12 or at
    ``max_reads``.  Returns (seqs uint8 (B, 300), lens (B,), read_nos (B,))
    per file, plus the per-file total read count for the .mfile.
    """

    def __init__(self, path1: str, path2: str | None = None,
                 batch_size: int = 20000, max_reads: int = 2 * 10**9,
                 trim_start: int = 0, trim_end: int = 0):
        self.path1, self.path2 = path1, path2
        self.batch_size = batch_size
        self.max_reads = max_reads
        self.trim_start, self.trim_end = trim_start, trim_end
        self.total_records = 0   # == reference current_read at loop exit

    def batches(self):
        it1 = iter_fastq_seqs(self.path1)
        it2 = iter_fastq_seqs(self.path2) if self.path2 else None
        bs = self.batch_size
        seqs1 = np.zeros((bs, MAX_READ_LENGTH), dtype=np.uint8)
        lens1 = np.zeros(bs, dtype=np.int32)
        seqs2 = np.zeros((bs, MAX_READ_LENGTH), dtype=np.uint8)
        lens2 = np.zeros(bs, dtype=np.int32)
        nos = np.zeros(bs, dtype=np.int64)
        fill = 0
        current = 0
        while current < self.max_reads:
            try:
                s1 = next(it1)
            except StopIteration:
                break
            s2 = None
            if it2 is not None:
                try:
                    s2 = next(it2)
                except StopIteration:
                    # reference stops the whole loop when either file of a
                    # pair runs out (pemapper.c:727-741)
                    break
            if self.trim_start or self.trim_end:
                # pemapper_tsw trimming: applied before the length gate
                s1 = s1[self.trim_start:]
                s1 = s1[:max(0, len(s1) - self.trim_end)]
                if s2 is not None:
                    s2 = s2[self.trim_start:]
                    s2 = s2[:max(0, len(s2) - self.trim_end)]
            if len(s1) <= 12:
                break
            a1 = np.frombuffer(s1, dtype=np.uint8)
            seqs1[fill, :len(a1)] = a1
            seqs1[fill, len(a1):] = 0
            lens1[fill] = len(a1)
            if s2 is not None:
                a2 = np.frombuffer(s2, dtype=np.uint8)
                seqs2[fill, :len(a2)] = a2
                seqs2[fill, len(a2):] = 0
                lens2[fill] = len(a2)
            nos[fill] = current
            fill += 1
            current += 1
            self.total_records = current
            if fill == bs:
                yield self._emit(seqs1, lens1, seqs2, lens2, nos, fill)
                seqs1 = np.zeros((bs, MAX_READ_LENGTH), dtype=np.uint8)
                seqs2 = np.zeros((bs, MAX_READ_LENGTH), dtype=np.uint8)
                fill = 0
        if fill:
            yield self._emit(seqs1, lens1, seqs2, lens2, nos, fill)

    def _emit(self, s1, l1, s2, l2, nos, fill):
        if self.path2 is None:
            return (s1[:fill].copy(), l1[:fill].copy(), None, None,
                    nos[:fill].copy())
        return (s1[:fill].copy(), l1[:fill].copy(), s2[:fill].copy(),
                l2[:fill].copy(), nos[:fill].copy())
