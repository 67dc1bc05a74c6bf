"""The port's multi-process scale-out (parallel/distributed.py): two
processes joined by init_distributed (torch.distributed, gloo, on
localhost) run run_mapper_distributed and run_caller_distributed, as
tests/test_distributed.py and tests/test_distributed_caller.py run the
JAX package's; their parts merge to the single-process run.  The
partition functions equal the JAX package's on a sweep.

Tolerance: the merged partial pileups equal the single run's counts and
each .mfile is byte-equal to the single run's; the caller's .snp, .dist
and decompressed .base.gz and .piles.gz byte-equal."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu.parallel import distributed as jdist
from pecaller_tpu_torch.caller import CallerConfig, run_caller
from pecaller_tpu_torch.formats.pileup import read_pileup
from pecaller_tpu_torch.mapper.runner import MapperConfig, run_mapper
from pecaller_tpu_torch.parallel import distributed as tdist
from test_distributed_caller import _make_cohort
from util import REPO, make_genome, sample_reads, write_fasta, write_fastq

_PRELUDE = """
import os, sys
d, pid, coord = sys.argv[2], int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from pecaller_tpu_torch.parallel.distributed import init_distributed
init_distributed(coord, 2, pid)
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
"""

_MAP = _PRELUDE + """
from pecaller_tpu_torch.mapper.runner import MapperConfig
from pecaller_tpu_torch.parallel.distributed import run_mapper_distributed
cfg = MapperConfig(out_base=os.path.join(d, "dist"),
                   sdx_path=os.path.join(d, "g.sdx"), paired=True,
                   files1=[os.path.join(d, f"a{i}_1.fastq") for i in range(2)],
                   files2=[os.path.join(d, f"a{i}_2.fastq") for i in range(2)],
                   max_dist=500, min_dist=0, min_align=0.9, batch_size=400,
                   nthreads=1, device=True, torch_device="cpu")
run_mapper_distributed(cfg, coordinator=coord, num_processes=2,
                       process_id=pid)
assert not any(m == "jax" or m.startswith(("jax.", "pecaller_tpu."))
               for m in sys.modules)
print("proc", pid, "done")
"""

_CALL = _PRELUDE + """
from pecaller_tpu_torch.caller import CallerConfig
from pecaller_tpu_torch.parallel.distributed import run_caller_distributed
cfg = CallerConfig(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                   out_base=os.path.join(d, "dist"), prob_to_call=0.95,
                   theta=0.001, haploid=False, directory=d, nthreads=1,
                   window_positions=1 << 14, device="cpu")
run_caller_distributed(cfg, coordinator=coord, num_processes=2,
                       process_id=pid)
print("proc", pid, "done")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(d, script_src):
    coord = f"localhost:{_free_port()}"
    script = os.path.join(d, "part.py")
    with open(script, "w") as f:
        f.write(script_src)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, script, REPO, d, str(p),
                               coord], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for p in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            assert p.returncode == 0, out.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_two_process_mapper_merges_to_single(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(31)
    names, seqs = make_genome(rng, [25000])
    write_fasta(os.path.join(d, "genome.fa"), names, seqs)
    from pecaller_tpu_torch.index import build_index
    build_index(os.path.join(d, "genome.fa"), os.path.join(d, "g"),
                write_idx=False)
    for i in range(2):
        reads = sample_reads(rng, names, seqs, 400, read_len=100,
                             err_rate=0.01, paired=True, insert_lo=150,
                             insert_hi=400, indel_rate=0.1, max_indel=3)
        write_fastq(os.path.join(d, f"a{i}_1.fastq"), reads, which=0)
        write_fastq(os.path.join(d, f"a{i}_2.fastq"), reads, which=1)
    _two_processes(d, _MAP)
    mfiles = {}
    for i in range(2):
        for e in (1, 2):
            mf = os.path.join(d, f"a{i}_{e}.fastq.mfile")
            mfiles[mf] = open(mf, "rb").read()

    cfg = MapperConfig(out_base=os.path.join(d, "single"),
                       sdx_path=os.path.join(d, "g.sdx"), paired=True,
                       files1=[os.path.join(d, f"a{i}_1.fastq")
                               for i in range(2)],
                       files2=[os.path.join(d, f"a{i}_2.fastq")
                               for i in range(2)],
                       max_dist=500, min_dist=0, min_align=0.9,
                       batch_size=400, nthreads=1, device=True)
    run_mapper(cfg, device="cpu")

    gs = 25000 + 64
    merged = np.zeros((gs, 6), np.int64)
    for p in range(2):
        path = os.path.join(d, f"dist.part{p}.pileup.gz")
        assert os.path.exists(path), "partial pileup missing"
        pos, cnt = read_pileup(path)
        merged[pos] += cnt
    spos, scnt = read_pileup(os.path.join(d, "single.pileup.gz"))
    single = np.zeros((gs, 6), np.int64)
    single[spos] += scnt
    assert single.sum() > 0 and np.array_equal(merged, single)
    for mf, got in mfiles.items():
        assert len(got) > 0 and got == open(mf, "rb").read(), mf


def test_two_process_caller_merges_to_single(tmp_path):
    d = str(tmp_path)
    _make_cohort(d, np.random.default_rng(55))
    _two_processes(d, _CALL)
    args = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, haploid=False, directory=d,
                nthreads=1, window_positions=1 << 14, device="cpu")
    tdist.merge_caller_parts(CallerConfig(
        out_base=os.path.join(d, "dist"), **args), 2)
    run_caller(CallerConfig(out_base=os.path.join(d, "single"), **args))
    for ext in (".base.gz", ".piles.gz", ".snp", ".dist"):
        with open(os.path.join(d, "dist" + ext), "rb") as f:
            a = f.read()
        with open(os.path.join(d, "single" + ext), "rb") as f:
            b = f.read()
        if ext.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b and len(b) > 0, ext
    assert os.path.exists(os.path.join(d, "dist.part1.dstat.npz"))


def test_partitions_match_jax():
    """partition_files, partition_intervals and partition_genome on a
    sweep of process counts, ids and inputs."""
    rng = np.random.default_rng(9)
    files = [f"f{i}" for i in range(7)]
    bed = [(f"c{i % 3}", int(s), int(s + ln)) for i, (s, ln) in enumerate(
        zip(rng.integers(0, 10 ** 6, 40), rng.integers(1, 50000, 40)))]
    for n in (1, 2, 3, 4, 8):
        for pid in range(n):
            for f2 in (files, []):
                assert (tdist.partition_files(files, f2, pid, n)
                        == jdist.partition_files(files, f2, pid, n))
            assert (tdist.partition_intervals(bed, pid, n)
                    == jdist.partition_intervals(bed, pid, n))
            for gs, align in ((4_600_000, 1 << 20), (60_000, 1 << 14),
                              (3_100_000_000, 1 << 20), (5, 1 << 20)):
                assert (tdist.partition_genome(gs, pid, n, align)
                        == jdist.partition_genome(gs, pid, n, align))
    assert tdist.init_distributed() == (0, 1)


@pytest.mark.parametrize("cards", [1, 3, 4])
def test_process_takes_its_card(monkeypatch, cards):
    """run_mapper_distributed's devices, resolved without mapping
    (torch.cuda.device_count patched to ``cards``): with several
    processes and no device named, process p maps on cuda:{p % cards};
    one process takes every card; a named torch_device wins; the host
    engine (device=False) takes none.  Without CUDA, the device route
    raises "no CUDA device"."""
    from dataclasses import replace
    from pecaller_tpu_torch.mapper.runner import mapping_devices
    cfg = MapperConfig(out_base="o", sdx_path="g.sdx", paired=True,
                       files1=["a"], files2=["b"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for n in (2, 3, 4, 8):
        for pid in range(n):
            dev = tdist.process_device(cfg, pid, n)
            assert dev == f"cuda:{pid % cards}"
            assert mapping_devices(replace(cfg, torch_device=dev)) == \
                [torch.device("cuda", pid % cards)]
            assert tdist.process_device(
                replace(cfg, torch_device="cpu"), pid, n) == "cpu"
            assert tdist.process_device(
                replace(cfg, device=False), pid, n) is None
    assert tdist.process_device(cfg, 0, 1) is None
    assert mapping_devices(cfg) == [torch.device("cuda", i)
                                    for i in range(cards)]
    # run_mapper_distributed as process 1 of 2, the runner not run: its
    # card, or the devices the caller names
    import pecaller_tpu_torch.mapper.runner as runner
    got = []
    monkeypatch.setattr(tdist, "init_distributed", lambda *a: (1, 2))
    monkeypatch.setattr(runner, "run_mapper",
                        lambda local, device=None: got.append(
                            (local.torch_device, device, local.out_base)))
    two = [torch.device("cpu")] * 2
    tdist.run_mapper_distributed(replace(cfg, files1=["a", "c"],
                                         files2=["b", "d"]))
    tdist.run_mapper_distributed(replace(cfg, files1=["a", "c"],
                                         files2=["b", "d"]), device=two)
    assert got == [(f"cuda:{1 % cards}", None, "o.part1"),
                   (None, two, "o.part1")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.process_device(cfg, 1, 2)
