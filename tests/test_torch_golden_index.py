"""The port's `index_genome` stage against the C reference's own index
of .golden/index_small, with the stdin answers tests/test_indexer.py
gave the C indexer, on a copy of its genome.fa.

Tolerance: .seq (decompressed), .sdx and .mdx byte-equal; the .idx (a
16 GB dense stream of prefix sums once decompressed) through its sparse
form, equal to the committed ref.sidx.npz, which load_index made from
the reference's ref.idx."""

import gzip
import io
import os
import shutil
import sys

import numpy as np

from pecaller_tpu_torch.cli import main as cli_main
from pecaller_tpu_torch.formats.index_files import _sparsify_idx_stream
from util import GOLDEN


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def test_index_genome_matches_the_c_golden(tmp_path, monkeypatch):
    src = os.path.join(GOLDEN, "index_small")
    shutil.copy(os.path.join(src, "genome.fa"), tmp_path / "genome.fa")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin",
                        io.StringIO("S\n200\ngenome.fa\nours\nn\n"))
    assert cli_main(["index_genome"]) == 0
    for ext in (".seq", ".sdx", ".mdx"):
        assert _read(tmp_path / ("ours" + ext)) == \
            _read(os.path.join(src, "ref" + ext)), ext
    keys, starts0 = _sparsify_idx_stream(str(tmp_path / "ours.idx"))
    ref = np.load(os.path.join(src, "ref.sidx.npz"))
    assert np.array_equal(keys, ref["keys"])
    assert np.array_equal(starts0, ref["starts0"])
