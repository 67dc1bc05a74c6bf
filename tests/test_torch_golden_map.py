"""The port's mapping and indexing stages against the C reference's own
outputs, committed under .golden/: `pemapper` on map_single, map_paired
and map_array, and `pemapper_tsw` on map_tsw, each with the argv
tests/test_mapper.py and tests/test_misc.py gave the C binaries and one
of the port's two routes: `--host` (the exact host engine) and
`--device=cpu` (the device route, here the v2 engine on the nbr index,
on the CPU; without a flag the port maps on the card).
(index_genome: tests/test_torch_golden_index.py.)

Every input is copied to a fresh directory first (the mapper writes each
.mfile beside its fastq; the goldens are read, never written), and the
copied .mfile dumps are deleted before the run.

Tolerance: byte equality of every artifact (.pileup.gz and
.indel.txt.gz decompressed)."""

import gzip
import os
import shutil

import pytest

import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu_torch.cli import main as cli_main
from util import GOLDEN


def _copy(name, dst):
    """The inputs of a golden directory (not its outputs: the .mfile
    dumps and the ref, ours, grp and unused artifacts) into dst."""
    src = os.path.join(GOLDEN, name)
    for f in os.listdir(src):
        if f.endswith(".mfile") or f.startswith(("ref", "ours", "grp",
                                                   "unused")):
            continue
        shutil.copy(os.path.join(src, f), dst / f)
    return src


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def _same_mapping(work, ref_dir, ours, ref, fastqs):
    for ext in (".pileup.gz", ".indel.txt.gz", ".summary.txt"):
        assert _read(work / (ours + ext)) == \
            _read(os.path.join(ref_dir, ref + ext)), ext
    for fq in fastqs:
        assert _read(work / (fq + ".mfile")) == \
            _read(os.path.join(ref_dir, fq + ".mfile")), fq


_SINGLE = ["ours", "g.sdx", "s", "reads.fastq", "n", "0.9", "2", "100000"]
_PAIRED = ["ours", "g.sdx", "p", "r1.fastq", "r2.fastq", "500", "0", "n",
           "0.9", "2", "100000"]
_ARRAY = ["ours", "g.sdx", "pa", "list1.txt", "list2.txt", "500", "0", "n",
          "0.9", "2", "100000"]
_ARRAY_FQ = ["p1_1.fastq", "p2_1.fastq", "p1_2.fastq", "p2_2.fastq"]


@pytest.mark.parametrize("name,argv,fastqs", [
    ("map_single", _SINGLE + ["--host"], ["reads.fastq"]),
    ("map_paired", _PAIRED + ["--host"], ["r1.fastq", "r2.fastq"]),
    ("map_paired", _PAIRED + ["--device=cpu"], ["r1.fastq", "r2.fastq"]),
    ("map_array", _ARRAY + ["--host"], _ARRAY_FQ),
    ("map_single", _SINGLE + ["--device=cpu"], ["reads.fastq"]),
    ("map_array", _ARRAY + ["--device=cpu"], _ARRAY_FQ),
], ids=["single", "paired", "paired-device-cpu", "array",
        "single-device-cpu", "array-device-cpu"])
def test_pemapper_matches_the_c_goldens(tmp_path, monkeypatch, name, argv,
                                        fastqs):
    src = _copy(name, tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["pemapper", *argv]) == 0
    _same_mapping(tmp_path, src, "ours", "ref", fastqs)


@pytest.mark.parametrize("route", ["--host", "--device=cpu"],
                         ids=["host", "device-cpu"])
def test_pemapper_tsw_matches_the_c_goldens(tmp_path, monkeypatch, route):
    src = _copy("map_tsw", tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["pemapper_tsw", "unused", "g.sdx", "pa", "l1.txt",
                     "l2.txt", "500", "0", "n", "0.9", "2", "100000", "3",
                     "4", route]) == 0
    for grp in ("grp1", "grp2"):
        _same_mapping(tmp_path, src, grp, f"ref_{grp}", [])
    assert not os.path.exists(tmp_path / "unused.pileup.gz")
    for fq in ("a_1.fastq", "a_2.fastq", "b_1.fastq", "b_2.fastq"):
        assert _read(tmp_path / (fq + ".mfile")) == \
            _read(os.path.join(src, fq + ".mfile")), fq
