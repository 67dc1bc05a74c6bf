"""One run of a mapping cell: set-up as the users' ``pemapper`` does it,
the measured window over the batch stream, the traced stretch, and the
outputs that ``check`` judges.

Set-up: on a checkout's first run of a cell, the configuration's genome
(its own seed), its FASTA, the port's index and its seed-index caches
under ``.cache/<config>/`` (built in a child process) and the mix's read
pairs under ``.cache/<config>/<mix>/``, drawn from the mix's own seed:
every later run loads them, and the first run's ``setup_s`` leaves these
builds and the kernels' out (they are printed apart as ``builds``).  Then
the pairs' gzip FASTQ parsed by the port's ``FastqBatcher``; the engine
from the reference's argv through the port's own ``cli`` and ``runner``
(``device_route`` picks the index); one batch of each shape in the
sample, then three calls of every shape key's program.  The window then
streams the parsed batches, round and round in the order that ``--seed``
draws, through ``map_batch_async`` / ``resolve`` with the runner's
batches in flight, until ``seconds`` have passed, and drains.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import check
from .traffic import gen, loop
from .reference.mapper import Settings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def prepare(config: dict, traffic: dict, cache: str) -> dict:
    """What a checkout's first run of a cell makes and every later run
    loads: the genome's FASTA, the port's index and its seed-index caches
    under ``cache``, and the mix's read pairs under ``cache/<mix>/`` (the
    gzip FASTQ the mapper parses, and the reads and their truth as
    ``.npy`` for the check).  They are built in a process of their own,
    so that the run then starts from the caches as every later run does.
    Returns the seconds each build took (none on later runs)."""
    builds = {}
    for what, ready in (("index", os.path.join(cache, "ready")),
                        ("reads", os.path.join(cache, traffic["name"],
                                               "ready"))):
        if os.path.exists(ready):
            continue
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import json, sys; from pebench import harness; "
                        f"harness.build_{what}(*map(json.loads, "
                        "sys.argv[1:]))", json.dumps(config),
                        json.dumps(traffic), json.dumps(cache)],
                       check=True, cwd=ROOT)
        open(ready, "w").close()
        builds[what + "_s"] = time.perf_counter() - t
    return builds


def build_index(config: dict, traffic: dict, cache: str):
    """``index_genome``'s index of the configuration's genome under
    ``cache`` and the seed-index caches that ``device_route`` loads,
    written through to the disk."""
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx
    from pecaller_tpu_torch.index import build_index as build
    from pecaller_tpu_torch.index.nbr import load_nbr_index
    from pecaller_tpu_torch.index.quarter import load_quarter_index
    from pecaller_tpu_torch.mapper.runner import device_route
    os.makedirs(cache, exist_ok=True)
    fa = os.path.join(cache, "g.fa")
    gen.write_fasta(fa, config["name"], gen.genome(config))
    base = os.path.join(cache, "g")
    build(fa, base, write_idx=False)
    index = load_index(base)
    device_route(read_sdx(base + ".sdx").genome_size,
                 lambda: load_nbr_index(base, index),
                 lambda: load_quarter_index(base, index))
    _fsync(cache)


def build_reads(config: dict, traffic: dict, cache: str):
    """The mix's read pairs on the configuration's genome under
    ``cache/<mix>/``: both ends' gzip FASTQ and, as ``.npy``, the reads
    and their truth, written through to the disk."""
    d = os.path.join(cache, traffic["name"])
    os.makedirs(d, exist_ok=True)
    p = gen.pairs(gen.genome(config), config["sample_pairs"], traffic)
    gen.write_fastq_gz([os.path.join(d, f"r{e}.fastq.gz") for e in (1, 2)],
                       (p["r1"], p["r2"]), (p["l1"], p["l2"]),
                       gen.quality(traffic["err_rate"]))
    for k in TRUTH:
        np.save(os.path.join(d, k + ".npy"), p[k])
    _fsync(d)


def _fsync(top: str):
    for root, _, files in os.walk(top):
        for f in files:
            fd = os.open(os.path.join(root, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


TRUTH = ("r1", "r2", "l1", "l2", "start", "insert")


def load_pairs(cache: str, traffic: dict) -> dict:
    """The mix's drawn pairs and their truth, mapped from the cache."""
    d = os.path.join(cache, traffic["name"])
    return {k: np.load(os.path.join(d, k + ".npy"), mmap_mode="r")
            for k in TRUTH}


def argv(config: dict, traffic: dict, sdx: str, fq1: str, fq2: str,
         out: str) -> list:
    """The reference's own ``pemapper`` command line for the cell (the
    port's --batch-size only where the mix's batch differs from the
    reference's 20,000)."""
    from pecaller_tpu_torch.mapper.runner import MapperConfig
    a = [out, sdx, "p", fq1, fq2, str(config["max_dist"]),
         str(config["min_dist"]), "y" if config["bisulfite"] else "n",
         str(config["min_align"]), str(config["threads"]),
         str(config["max_reads"])]
    if traffic["batch_pairs"] != MapperConfig.batch_size:
        a += ["--batch-size", str(traffic["batch_pairs"])]
    return a


class _Lanes:
    """The lanes that the step's eager first call hands K1 and K2 (each
    lane's window rows and read length, K2's walk start row), kept for
    the roofline: the fused step's kernel wrappers are wrapped for that
    one call."""

    def __init__(self):
        from pecaller_tpu_torch.mapper import device_map2
        self.mod = device_map2
        self.calls = {}

    def __enter__(self):
        self.orig = (self.mod.sw_align_x, self.mod.sw_traceback_rows)
        k1, k2 = self.orig

        def rec1(refs, blens, reads, rlens, **kw):
            self.calls["k1"] = dict(blens=blens.cpu(), rlens=rlens.cpu(),
                                    n_rows=kw["n_rows"])
            return k1(refs, blens, reads, rlens, **kw)

        def rec2(refs, blens, reads, rlens, bt_k, bt_i, **kw):
            self.calls["k2"] = dict(blens=blens.cpu(), rlens=rlens.cpu(),
                                    n_rows=kw["n_rows"], bt_i=bt_i.cpu())
            return k2(refs, blens, reads, rlens, bt_k, bt_i, **kw)
        self.mod.sw_align_x, self.mod.sw_traceback_rows = rec1, rec2
        return self

    def __exit__(self, *exc):
        self.mod.sw_align_x, self.mod.sw_traceback_rows = self.orig


def run(cfg: dict, seed: int, seconds: float, trace: bool, t_start: float,
        devices=None, cache: str | None = None, engine_hook=None,
        min_batches: int = 0) -> dict:
    """Set up, measure, judge.  ``cfg`` is ``cells.load``'s cell;
    ``devices`` None maps on every visible card as the runner does (a
    test passes CPU devices); ``engine_hook(eng, sample)`` may break the
    engine or put the control in its place (the harness's tests and
    ``control``), which may ask the window for ``min_batches`` batches
    whatever its length.  Returns the record the metric readers
    read, with ``correct`` and the numbers compared."""
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.fastq import FastqBatcher
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.mapper import runner

    config, traffic = cfg["config"], cfg["traffic"]
    cache = cache or os.path.join(CACHE, config["name"])
    rec = {"builds": prepare(config, traffic, cache)}

    # the sample: the mix's gzip FASTQ, parsed by the port's reader
    parts = rec["setup_parts"] = {}
    reads = os.path.join(cache, traffic["name"])
    mc = cli.parse_pemapper(argv(
        config, traffic, os.path.join(cache, "g.sdx"),
        os.path.join(reads, "r1.fastq.gz"), os.path.join(reads, "r2.fastq.gz"),
        os.path.join(cache, "run", "out")))
    os.makedirs(os.path.join(cache, "run"), exist_ok=True)
    t = time.perf_counter()
    batches = list(FastqBatcher(mc.files1[0], mc.files2[0],
                                batch_size=mc.batch_size,
                                max_reads=mc.max_reads).batches())
    rec["fastq_s"] = time.perf_counter() - t
    rec["n_batches"] = len(batches)
    truth = load_pairs(cache, traffic)
    order = np.random.default_rng(seed).permutation(len(batches))

    # the engine, as run_mapper builds it
    if devices is None:
        devices = runner.mapping_devices(mc)
        from pecaller_tpu_torch.ops import sw_cuda
        t = time.perf_counter()
        sw_cuda.build_kernels()
        if sw_cuda.BUILD_INFO:              # set where this call built
            rec["builds"]["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sdx = read_sdx(mc.sdx_path)
    base = mc.sdx_path[:-len(".sdx")]
    genome = read_seq(base + ".seq", sdx.genome_size)
    index = load_index(base)
    eng = runner.build_device_engine(mc, sdx, genome, index, base, devices)
    _sync(devices)
    rec["index_load_s"] = time.perf_counter() - t
    mode = {"hash": "nbr", "binsearch": "nbr"}.get(eng.state.dnbr.mode,
                                                    eng.state.dnbr.mode)
    if mode != config["route"]:
        raise RuntimeError(f"the runner took the {mode} index, the "
                           f"configuration states {config['route']}")
    smp = check.sample(truth, config["genome_length"], traffic["check"],
                       seed)
    if engine_hook is not None:
        engine_hook(eng, smp)
    answers = check.Answers(smp, mc.batch_size, len(batches), mc.max_dist)

    def resolved(b, m1, m2, code):
        s1, l1, s2, l2, _ = batches[b]
        answers.add(b, m1, m2, code, l1, l2)

    # warm: one batch of each shape (pairs, longest read), then every
    # shape key's program to three calls (eager, capture, first replay)
    t = time.perf_counter()
    warm = loop.Stream(eng, batches, resolved)
    shapes = {}
    for b, (s1, l1, s2, l2, _) in enumerate(batches):
        shapes.setdefault((len(l1), int(max(l1.max(), l2.max()))), b)
    calls_of = {}
    for b in shapes.values():
        before = {id(p): p.calls for p in eng.programs}
        if b == 0 and trace:
            with _Lanes() as lanes:
                warm.push(b)
            rec["lanes"] = lanes.calls
        else:
            warm.push(b)
        for p in eng.programs:
            if p.calls != before.get(id(p), 0):
                calls_of.setdefault(id(p), (p, b))
    warm.drain()
    for p, b in calls_of.values():
        while p.calls < 3:
            warm.push(b)
            warm.drain()
    _sync(devices)
    parts["warm_s"] = time.perf_counter() - t
    if trace:
        _profiler_warm(devices)
    rec["setup_s"] = time.time() - t_start - sum(rec["builds"].values())

    # the window
    prof = None
    annotate = None
    if trace:
        annotate = torch.profiler.record_function
    s = loop.Stream(eng, batches, resolved, annotate)
    t0 = time.perf_counter()
    traced = (0.3 * seconds, 0.3 * seconds + min(2.0, 0.4 * seconds))
    pushed = 0
    while time.perf_counter() - t0 < seconds or pushed < min_batches:
        now = time.perf_counter() - t0
        if trace and prof is None and now >= traced[0]:
            prof = _profiler(devices)
            prof.start()
        elif prof is not None and not rec.get("traced") \
                and now >= traced[1]:
            prof.stop()
            rec["traced"] = True
        s.push(int(order[pushed % len(order)]))
        pushed += 1
    s.drain()
    _sync(devices)
    rec["window_s"] = time.perf_counter() - t0
    if prof is not None and not rec.get("traced"):
        prof.stop()
    rec["reads"] = s.reads
    rec["spans"] = s.spans
    rec["peak_bytes"] = max(
        (torch.cuda.max_memory_allocated(d) for d in devices
         if d.type == "cuda"), default=0)

    got = check.program_outputs(eng, smp["regions"])
    rec["engine"] = {"n_fallback": int(eng.n_fallback),
                     "n_cap_fallback": int(eng.n_cap_fallback),
                     "n_tiefix": int(eng.n_tiefix),
                     "programs": [dict(calls=p.calls, capture_s=p.capture_s,
                                       pool_bytes=p.pool_bytes)
                                  for p in eng.programs]}
    if trace:
        from .metrics import trace as tr
        if prof is not None:
            rec["trace"] = tr.summarise(prof)
        rec["replay_ms"] = tr.replay_ms(eng, devices)
        rec["kernels"] = tr.kernel_times(rec.get("trace"))
    del eng, batches, warm, s, index, genome
    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()

    # the reference, once the program is gone
    t = time.perf_counter()
    want = check.reference(gen.genome(config), truth, smp, Settings(
        mc.min_align, mc.max_dist, mc.min_dist, mc.bisulfite), devices[0])
    rec["reference_s"] = time.perf_counter() - t
    rec["compared"] = check.compare(want, answers, got, smp)
    rec["correct"] = check.verdict(rec["compared"])
    rec["sample_pairs"] = int(len(smp["pairs"]))
    rec["answers_compared"] = int(sum(2 * x[4] for x in answers.seen))
    return rec


def _profiler(devices):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _profiler_warm(devices):
    """Start and stop the profiler once in set-up, so that the traced
    stretch does not pay the tracer's first start."""
    p = _profiler(devices)
    p.start()
    torch.zeros(1, device=devices[0]).add_(1)
    _sync(devices)
    p.stop()
