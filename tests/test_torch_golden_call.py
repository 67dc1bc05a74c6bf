"""The port's caller and cohort-tail stages against the C reference's own
outputs, committed under .golden/, through the port's command line with
the argv tests/test_caller.py and tests/test_cohort.py gave the C tools:

- call_3samp: `pecaller` (refcall; haploid, refhap; the guide bed
  regions.bed, refbed), also with both screen phases on the device
  (host_screen False) and run_caller with and without the device beam,
  and `dump_pileups` (refdump);
- call_denovo: `pecaller` with the trio pedigree (refdn);
- cohort_tail: `make_snplist`, `pecall_merger`, `merge_indel_snp`,
  `snp_to_vcf` and `snp_tran_counter`.

The screen runs on the CPU (`--device=cpu`).  Inputs are copied to a
fresh directory first.  The reference names its samples in readdir
order; the copies are called in the golden's order (its .snp header),
whatever order the copy's directory lists them in.

Tolerance: byte equality (.base.gz and .piles.gz decompressed; the VCF
without its ##fileDate line)."""

import gzip
import os
import shutil

import pytest

import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu_torch.caller import CallerConfig, run_caller
from pecaller_tpu_torch.caller import runner
from pecaller_tpu_torch.cli import main as cli_main
from util import GOLDEN


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def _copy(name, dst, files):
    src = os.path.join(GOLDEN, name)
    os.makedirs(dst, exist_ok=True)
    for f in files:
        shutil.copy(os.path.join(src, f), os.path.join(dst, f))
    return src


def _in_golden_order(monkeypatch, snp_path):
    """Discover the pileups in the sample order of a golden .snp header
    (the reference's readdir order)."""
    with open(snp_path) as f:
        order = f.readline().rstrip("\n").split("\t")[6::2]
    discover = runner._discover_pileups

    def ordered(directory, ext):
        names, files = discover(directory, ext)
        k = sorted(range(len(names)), key=lambda i: order.index(names[i]))
        return [names[i] for i in k], [files[i] for i in k]
    monkeypatch.setattr(runner, "_discover_pileups", ordered)


def _same(ours, ref, exts=(".snp", ".dist", ".base.gz", ".piles.gz")):
    for ext in exts:
        assert _read(ours + ext) == _read(ref + ext), ext


@pytest.fixture
def call_3samp(tmp_path, monkeypatch):
    src = _copy("call_3samp", tmp_path, [
        "g.sdx", "g.seq", "regions.bed",
        *(f"sample{i}.pileup.gz" for i in range(3))])
    _in_golden_order(monkeypatch, os.path.join(src, "refcall.snp"))
    monkeypatch.chdir(tmp_path)
    return src


@pytest.mark.parametrize("ref,args", [
    ("refcall", ["n", "2", "n"]),
    ("refhap", ["y", "2", "n"]),
    ("refbed", ["n", "2", "n", "regions.bed"]),
])
def test_pecaller_matches_the_c_golden(call_3samp, ref, args):
    assert cli_main(["pecaller", "pileup", "g.sdx", "5", "ours", "0.95",
                     "0.001", *args, "--device=cpu"]) == 0
    _same("ours", os.path.join(call_3samp, ref))


def test_caller_both_phases_on_the_device_match_the_c_golden(call_3samp):
    run_caller(CallerConfig(pileup_ext="pileup", sdx_path="g.sdx",
                            out_base="ours", nthreads=2, host_screen=False,
                            device="cpu"))
    _same("ours", os.path.join(call_3samp, "refcall"))


@pytest.mark.parametrize("beam", [False, True])
def test_caller_beam_matches_the_c_golden(call_3samp, beam):
    """tests/test_caller.py:108-117 in the port: run_caller with and
    without the device beam (on the CPU) against refcall."""
    run_caller(CallerConfig(pileup_ext="pileup", sdx_path="g.sdx",
                            out_base="ours", prob_to_call=0.95, theta=0.001,
                            haploid=False, nthreads=2, device_beam=beam,
                            device="cpu"))
    _same("ours", os.path.join(call_3samp, "refcall"))


def test_dump_pileups_matches_the_c_golden(call_3samp):
    assert cli_main(["dump_pileups", "pileup", "g.sdx", "5", "ours", "0.95",
                     "0.001", "n", "2", "n"]) == 0
    _same("ours", os.path.join(call_3samp, "refdump"),
          (".dist", ".base.gz", ".piles.gz"))


def test_pecaller_pedigree_matches_the_c_golden(tmp_path, monkeypatch):
    src = _copy("call_denovo", tmp_path, [
        "g.sdx", "g.seq", "trio.ped",
        *(f"{m}.pileup.gz" for m in ("dad", "mom", "kid"))])
    _in_golden_order(monkeypatch, os.path.join(src, "refdn.snp"))
    monkeypatch.chdir(tmp_path)
    assert cli_main(["pecaller", "pileup", "g.sdx", "5", "ours", "0.95",
                     "0.001", "n", "2", "y", "trio.ped", "1e-8",
                     "--device=cpu"]) == 0
    assert b"DENOVO_" in _read(os.path.join(src, "refdn.snp"))
    _same("ours", os.path.join(src, "refdn"))


def _strip_date(text: str) -> str:
    return "\n".join(ln for ln in text.split("\n")
                     if not ln.startswith("##fileDate="))


def test_cohort_tail_matches_the_c_goldens(tmp_path, monkeypatch, capsys):
    """Each stage on the golden inputs of its reference run, in its own
    directory (make_snplist reads every .snp, pecall_merger every
    base.gz of its directory)."""
    def golden(f):
        return os.path.join(GOLDEN, "cohort_tail", f)

    snpl = tmp_path / "snplist"
    _copy("cohort_tail", snpl, ["g.sdx", "refcall.snp"])
    monkeypatch.chdir(snpl)
    assert cli_main(["make_snplist", "g.sdx", "ourgood"]) == 0
    for suf in (".good.bed", ".bad.bed"):
        assert _read("ourgood" + suf) == _read(golden("refgood" + suf))

    merge = tmp_path / "merge"
    _copy("cohort_tail", merge, ["g.sdx", "run1.base.gz",
                                 "refgood.good.bed"])
    monkeypatch.chdir(merge)
    assert cli_main(["pecall_merger", "100000", "10", "refgood.good.bed",
                     "ourmerged.snp", "g.sdx", "n"]) == 0
    assert _read("ourmerged.snp") == _read(golden("refmerged.snp"))

    indel = tmp_path / "indel"
    _copy("cohort_tail", indel, [
        "g.sdx", "refmerged.snp",
        *(f"sample{i}.indel.txt.gz" for i in range(3))])
    monkeypatch.chdir(indel)
    assert cli_main(["merge_indel_snp", "g.sdx", "refmerged.snp", ".",
                     "oursub.snp"]) == 0
    assert _read("oursub.snp") == _read(golden("refsub.snp"))

    tail = tmp_path / "tail"
    _copy("cohort_tail", tail, ["g.sdx", "g.seq", "refsub.snp"])
    monkeypatch.chdir(tail)
    capsys.readouterr()
    assert cli_main(["snp_to_vcf", "g.sdx", "refsub.snp", "0.3"]) == 0
    vcf = capsys.readouterr().out
    assert _strip_date(vcf) == _strip_date(_read(golden("ref.vcf")).decode())
    assert cli_main(["snp_tran_counter", "refsub.snp"]) == 0
    assert capsys.readouterr().out == _read(golden("ref_tran.txt")).decode()
