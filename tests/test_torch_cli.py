"""The port's command line (pecaller_tpu_torch/cli.py) against the JAX
package's (pecaller_tpu/cli.py): every stage parses its argv into the
same configuration (field by field; the port's extra field names the
torch device, and the mappers' ``device`` is the port's own default:
the device route unless ``--host``, where the JAX command line maps on
the host unless ``--device``), and the stages' outputs on tiny inputs
are equal:
the cohort tail on .golden/cohort_tail's files, `map_directory` and
`call_directory` on a small directory, `merge_dir_fa` modulo the date
in its output's name.  (`index_genome`, `pemapper`, `pemapper_tsw`,
`pecaller` and `dump_pileups` are held to the C reference's own outputs,
which the JAX package reproduces, in tests/test_torch_golden_*.py.)

Tolerance: equal configurations and byte-equal outputs (gzip files
decompressed)."""

import dataclasses
import glob
import gzip
import os
import shutil

import numpy as np
import pytest

import torch_util  # noqa: F401  (one torch thread a worker)
import pecaller_tpu.caller
import pecaller_tpu.mapper
import pecaller_tpu_torch.caller
import pecaller_tpu_torch.mapper.runner
from pecaller_tpu.cli import main as jax_main
from pecaller_tpu_torch.cli import main as port_main
from util import GOLDEN

PORT_ONLY = {"torch_device": None, "device": None, "graph": True}


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def _configs(monkeypatch, argv):
    """The configurations the JAX and the port's command lines hand their
    runners for ``argv`` (the runners not run; the JAX command line
    without the port's own flags, --host and --device=DEV)."""
    got = {}
    jax_argv = [a for a in argv
                if a != "--host" and not a.startswith("--device=")]
    for key, mods, main, args in (
            ("jax", (pecaller_tpu.mapper, pecaller_tpu.caller), jax_main,
             jax_argv),
            ("port", (pecaller_tpu_torch.mapper.runner,
                      pecaller_tpu_torch.caller), port_main, argv)):
        for mod, fn in zip(mods, ("run_mapper", "run_caller")):
            monkeypatch.setattr(mod, fn, lambda cfg, k=key: got.update(
                {k: cfg}))
        assert main(args) == 0
    return got["jax"], got["port"]


def _same_config(jcfg, pcfg, argv):
    """Every field of the JAX configuration equal in the port's, but a
    mapper's ``device``: the port maps on the device route unless
    --host (the JAX package on the host unless --device)."""
    mapper = isinstance(pcfg, pecaller_tpu_torch.mapper.runner.MapperConfig)
    for f in dataclasses.fields(jcfg):
        if mapper and f.name == "device":
            assert pcfg.device == ("--host" not in argv)
            continue
        assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name


def _lists(d):
    with open(d / "l1.txt", "w") as f:
        f.write("a_1.fastq\tgrp1\nb_1.fastq\tgrp2\n")
    with open(d / "l2.txt", "w") as f:
        f.write("a_2.fastq\nb_2.fastq\n")


PEMAPPER = ["out", "g.sdx", "p", "r1.fastq", "r2.fastq", "500", "0", "n",
            "0.9", "4", "1000"]


@pytest.mark.parametrize("argv", [
    ["pemapper", *PEMAPPER],
    ["pemapper", *PEMAPPER, "--device"],
    ["pemapper", "out", "g.sdx", "s", "r.fq", "y", "0.85", "3", "77"],
    ["pemapper", "out", "g.sdx", "pa", "l1.txt", "l2.txt", "400", "20", "n",
     "0.9", "2", "100"],
    ["pemapper_tsw", "unused", "g.sdx", "pa", "l1.txt", "l2.txt", "500",
     "0", "n", "0.9", "2", "100000", "3", "4"],
    ["pemapper_tsw", "o", "g.sdx", "s", "r.fq", "n", "0.9", "2", "50", "1",
     "2"],
    ["pecaller", "pileup", "g.sdx", "3", "ours", "0.95", "0.001", "n", "2",
     "n"],
    ["pecaller", "pileup", "g.sdx", "3", "ours", "0.9", "0.01", "y", "8",
     "n", "regions.bed"],
    ["pecaller", "pileup", "g.sdx", "3", "ours", "0.95", "0.001", "n", "2",
     "y", "trio.ped", "1e-7", "regions.bed"],
    ["pecaller", "pileup", "g.sdx", "3", "ours", "0.95", "0.001", "n", "2",
     "y", "trio.ped", "0"],
    ["dump_pileups", "pileup", "g.sdx", "3", "ours", "0.95", "0.001", "n",
     "2", "n"],
    ["call_directory", "calls/", "g.sdx"],
    ["call_directory", "calls", "g.sdx", "regions.bed", "trio.ped"],
    pytest.param(["pemapper", *PEMAPPER, "--device=cpu"],
                 id="pemapper-p-device-cpu"),
    pytest.param(["pemapper", *PEMAPPER, "--host"], id="pemapper-p-host"),
    pytest.param(["pemapper_tsw", "o", "g.sdx", "s", "r.fq", "n", "0.9", "2",
                  "50", "1", "2", "--host"], id="pemapper_tsw-s-host"),
], ids=lambda a: "-".join(a[:1] + a[3:4]))
def test_configs_equal_jax(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    _lists(tmp_path)
    jcfg, pcfg = _configs(monkeypatch, argv)
    _same_config(jcfg, pcfg, argv)
    extra = {f.name for f in dataclasses.fields(pcfg)} - \
        {f.name for f in dataclasses.fields(jcfg)}
    want = {k: PORT_ONLY[k] for k in extra}
    if "--device=cpu" in argv:
        want["torch_device"] = "cpu"
    assert {k: getattr(pcfg, k) for k in extra} == want


@pytest.mark.parametrize("flags", [[], ["--host"], ["--device=cpu"],
                                   ["--device"]],
                         ids=["default", "host", "device-cpu", "device"])
def test_map_directory_config_equals_jax(tmp_path, monkeypatch, flags):
    d = tmp_path / "fq"
    os.makedirs(d)
    for f in ("x_1_a.fastq", "x_2_a.fastq", "y_R1_b.fastq.gz",
              "y_R2_b.fastq.gz", "solo.fastq", "solo.fastq.mfile",
              "notes.txt"):
        (d / f).touch()
    argv = ["map_directory", str(d) + "/", "g.sdx", *flags]
    jcfg, pcfg = _configs(monkeypatch, argv)
    _same_config(jcfg, pcfg, argv)
    assert pcfg.paired and len(pcfg.files1) == 3
    assert pcfg.torch_device == ("cpu" if "--device=cpu" in flags else None)


@pytest.mark.parametrize("argv", [
    ["pemapper", *PEMAPPER, "--host", "--device"],
    ["pemapper", *PEMAPPER, "--device=cpu", "--host"],
    ["pemapper_tsw", "o", "g.sdx", "s", "r.fq", "n", "0.9", "2", "50", "1",
     "2", "--host", "--device=cpu"],
    ["map_directory", "fq/", "g.sdx", "--device", "--host"],
], ids=["pemapper", "pemapper-cpu", "pemapper_tsw", "map_directory"])
def test_host_with_device_is_a_usage_error(tmp_path, monkeypatch, capsys,
                                           argv):
    """--host and --device[=DEV] together: exit code 2 and a message,
    before any file is read."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pecaller_tpu_torch.mapper.runner, "run_mapper",
                        lambda cfg: pytest.fail("the mapper ran"))
    assert port_main(argv) == 2
    assert "--host" in capsys.readouterr().err


def test_device_flags(tmp_path, monkeypatch):
    """--device=cpu names the torch device of pemapper, pecaller and
    call_directory; without it the caller's screen takes cuda:0."""
    monkeypatch.chdir(tmp_path)
    _, pcfg = _configs(monkeypatch, ["pemapper", *PEMAPPER, "--device=cpu"])
    assert pcfg.device and pcfg.torch_device == "cpu"
    _, pcfg = _configs(monkeypatch, [
        "pecaller", "pileup", "g.sdx", "3", "o", "0.95", "0.001", "n", "2",
        "n", "--device=cpu"])
    assert pcfg.device == "cpu" and pcfg.guide_path is None
    _, pcfg = _configs(monkeypatch, ["call_directory", "calls", "g.sdx",
                                     "--device=cpu"])
    assert pcfg.device == "cpu" and pcfg.guide_path is None


def test_no_card_no_cpu_asked_raises(tmp_path, monkeypatch):
    import torch
    src = os.path.join(GOLDEN, "call_3samp")
    for f in ("g.sdx", "g.seq", "sample0.pileup.gz"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["pecaller", "pileup", "g.sdx", "1", "o", "0.95", "0.001",
                  "n", "2", "n"], ["call_directory", ".", "g.sdx"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(argv)
    assert port_main(["bogus"]) == 2 and port_main([]) == 2


def _both(tmp_path, monkeypatch, capsys, files, argv, outs=()):
    """Run ``argv`` through both command lines, each in its own copy of
    ``files`` from .golden/cohort_tail; returns (jax, port) as (stdout,
    {out: bytes})."""
    res = []
    for key, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / key
        os.makedirs(d, exist_ok=True)
        for f in files:
            if isinstance(f, tuple):
                with open(d / f[0], "w") as fh:
                    fh.write(f[1])
            else:
                shutil.copy(os.path.join(GOLDEN, "cohort_tail", f), d / f)
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(argv) in (0, None)
        res.append((capsys.readouterr().out,
                    {o: _read(d / o) for o in outs}))
    return res


def _annotation(rng):
    with open(os.path.join(GOLDEN, "cohort_tail", "refsub.snp")) as f:
        f.readline()
        rows = [ln.split("\t")[:2] for ln in f if ln.strip()]
    classes = ["Silent", "Replacement", "Intronic", "UTR"]
    out = ["Fragment\tPosition\tannotation_type\tsnp_id\n"]
    for c, p in rows:
        rs = f"rs{int(rng.integers(1, 10**6))}" if rng.random() < 0.5 \
            else "."
        out.append(f"{c}\t{p}\t{classes[int(rng.integers(0, 4))]}\t{rs}\n")
    return "".join(out)


@pytest.mark.parametrize("argv,files,outs", [
    (["make_snplist", "g.sdx", "good"], ["g.sdx", "refcall.snp"],
     ["good.good.bed", "good.bad.bed"]),
    (["make_snplist_restricted", "g.sdx", "res"],
     ["g.sdx", "refcall.snp", ("cov1.bed", "chr1\t1\t20000\n"),
      ("cov2.bed", "chr1\t1000\t29000\n")], ["res.good.bed", "res.bad.bed"]),
    (["pecall_merger", "100000", "10", "refgood.good.bed", "merged.snp",
      "g.sdx", "n"], ["g.sdx", "run1.base.gz", "refgood.good.bed"],
     ["merged.snp"]),
    (["merge_indel_snp", "g.sdx", "refmerged.snp", ".", "sub.snp"],
     ["g.sdx", "refmerged.snp", "sample0.indel.txt.gz",
      "sample1.indel.txt.gz", "sample2.indel.txt.gz"], ["sub.snp"]),
    (["snp_to_vcf", "g.sdx", "refsub.snp", "0.3"],
     ["g.sdx", "g.seq", "refsub.snp"], []),
    (["snp_tran_counter", "refsub.snp"], ["refsub.snp"], []),
    (["snp_tran_silent_rep", "refsub.snp", "annot.txt", "SNP"],
     ["refsub.snp", ("annot.txt", _annotation(np.random.default_rng(3)))],
     []),
], ids=["make_snplist", "make_snplist_restricted", "pecall_merger",
        "merge_indel_snp", "snp_to_vcf", "snp_tran_counter",
        "snp_tran_silent_rep"])
def test_cohort_stages_equal_jax(tmp_path, monkeypatch, capsys, argv,
                                 files, outs):
    (jout, jfiles), (pout, pfiles) = _both(tmp_path, monkeypatch, capsys,
                                           files, argv, outs)
    if argv[0] == "snp_to_vcf":        # the run's date
        jout, pout = ("\n".join(ln for ln in o.split("\n")
                                if not ln.startswith("##fileDate="))
                      for o in (jout, pout))
    assert pout == jout and pfiles == jfiles
    assert pout or any(pfiles.values())


def test_map_and_call_directory_equal_jax(tmp_path, monkeypatch):
    """map_directory on two read pairs of .golden/map_paired (the port's
    device route on the CPU, the JAX package's host engine), then
    call_directory on three pileups of .golden/call_3samp (the port's
    screen on the CPU): the JAX and the port's artifacts, each run in
    the same directory."""
    src = os.path.join(GOLDEN, "map_paired")
    fq = tmp_path / "fq"
    os.makedirs(fq)
    for e in (1, 2):
        shutil.copy(os.path.join(src, f"r{e}.fastq"), fq / f"s_{e}_a.fastq")
    for f in ("g.sdx", "g.seq", "g.mdx", "g.sidx.npz"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    calls = tmp_path / "calls"
    os.makedirs(calls)
    for i in range(3):
        shutil.copy(os.path.join(GOLDEN, "call_3samp",
                                 f"sample{i}.pileup.gz"), calls)
    for f in ("g.sdx", "g.seq"):
        shutil.copy(os.path.join(GOLDEN, "call_3samp", f), tmp_path / f"c{f}")
    monkeypatch.chdir(tmp_path)
    got = {}
    for key, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device=cpu"])):
        assert main(["map_directory", "fq/", "g.sdx", *extra]) == 0
        assert main(["call_directory", "calls/", "cg.sdx", *extra]) == 0
        got[key] = {}
        for out in sorted(glob.glob("fq.*") + glob.glob("calls.*")):
            got[key][out] = _read(out)
            os.remove(out)
        for m in glob.glob("fq/*.mfile"):
            got[key][m] = _read(m)
            os.remove(m)
    assert set(got["jax"]) == set(got["port"])
    assert len(got["port"]) == 9
    for k in got["jax"]:
        assert got["port"][k] == got["jax"][k], k


def test_merge_dir_fa_equals_jax(tmp_path, monkeypatch, capsys):
    d = tmp_path / "fa"
    os.makedirs(d)
    rng = np.random.default_rng(1)
    for c in ("chr1", "chr2", "chr3", "chrX", "chrM", "chrUn_x"):
        seq = "".join(rng.choice(list("ACGT"), 130))
        with gzip.open(d / f"{c}.fa.gz", "wt") as f:
            f.write(f">{c}\n{seq[:70]}\n{seq[70:]}\n")
    monkeypatch.chdir(tmp_path)
    args = ["-d", "fa", "-c", "1-3,X,M"]
    assert jax_main(["merge_dir_fa", *args, "-o", "jax"]) == 0
    assert port_main(["merge_dir_fa", *args, "-o", "port"]) == 0
    (j,), (p,) = glob.glob("jax.*.fa"), glob.glob("port.*.fa")
    assert p[len("port"):] == j[len("jax"):]
    assert _read(p) == _read(j) and _read(p).count(b">") == 6
    with pytest.raises(SystemExit):
        port_main(["merge_dir_fa", "-d", "fa", "-c", "1-4", "-o", "x"])
