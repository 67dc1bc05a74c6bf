"""The port's timing module (``pecaller_tpu_torch/utils/log.py``): spans
and their totals, nesting and records, the profiler ranges they open
only while tracing, the device-step stages, and the readers of the
spans in the mapper's runner and the caller's ``phases``.

Tolerance: exact counts and names; seconds only as ordered sums."""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu_torch.formats.index_files import load_index
from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
from pecaller_tpu_torch.mapper import runner
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from pecaller_tpu_torch.mapper.program import StepProgram
from pecaller_tpu_torch.utils import log
from pecaller_tpu_torch.utils.log import (enable_trace, reset_spans,
                                          span, span_records, spans,
                                          spans_since, stage)
from torch_util import (CPU, PAIRED, batches, cuda_device, make_fused2_data,
                        shared_nbr)

__all__ = ["cuda_device"]           # the fixture, imported for the tests

ENQUEUE = ("engine.enqueue", "engine.enqueue.prep", "engine.enqueue.fill",
           "engine.enqueue.launch")
RESOLVE = ("engine.resolve", "engine.resolve.wait", "engine.resolve.ins",
           "engine.resolve.stats")
STEP = ("step.seed", "step.windows", "step.align", "step.decide",
        "step.walk", "step.pileup")


@pytest.fixture
def tracing():
    """Tracing on for the test, off after it."""
    enable_trace()
    yield
    enable_trace(False)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused2_data(tmp_path_factory.mktemp("torch_spans"))


def _engine(d, device=CPU, **kw):
    base = str(d / "g")
    sdx = read_sdx(base + ".sdx")
    index = load_index(base)
    nbr = shared_nbr(d, "g", index, binsearch=False)
    return FusedMapperEngine2(sdx, read_seq(base + ".seq", sdx.genome_size),
                              index, nbr=nbr, device=device, **PAIRED, **kw)


def _profiled(fn):
    """The names of the host events a CPU profile of ``fn()`` holds."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_span_counts_totals_and_nesting(tracing):
    """Each name's count and seconds; a parent's seconds cover its
    children's; a record's parent is the innermost open span, also
    through the decorator form."""
    reset_spans("t")

    @span("t.deco")
    def deco():
        time.sleep(0.001)
    with span("t.outer"):
        for _ in range(3):
            with span("t.outer.inner"):
                time.sleep(0.002)
        deco()
    got = spans()
    assert got["t.outer"][0] == 1 and got["t.outer.inner"][0] == 3
    assert got["t.deco"][0] == 1
    assert got["t.outer.inner"][1] >= 0.006
    assert got["t.outer"][1] >= got["t.outer.inner"][1] + got["t.deco"][1]
    recs = [r for r in span_records() if r[0].startswith("t.")]
    assert [(n, p) for n, p, _, _ in recs] == (
        [("t.outer.inner", "t.outer")] * 3 + [("t.deco", "t.outer"),
                                              ("t.outer", None)])
    assert all(a <= b for _, _, a, b in recs)
    outer = recs[-1]
    assert all(outer[2] <= a and b <= outer[3] for _, _, a, b in recs)


def test_spans_since_and_reset_by_prefix():
    """``spans_since`` gives what ran after a snapshot; ``reset_spans``
    with a prefix forgets that layer alone."""
    reset_spans("u", "v")
    with span("u.a"):
        pass
    before = spans()
    with span("u.a"):
        pass
    with span("v.b"):
        pass
    done = spans_since(before)
    assert done["u.a"][0] == 1 and done["v.b"][0] == 1
    reset_spans("u")
    assert "u.a" not in spans() and spans()["v.b"][0] == 1
    reset_spans("v")
    assert not [k for k in spans() if k.startswith(("u.", "v."))]


def test_spans_from_many_threads_lose_no_update():
    """Totals are a read-modify-write under a lock: threads that each
    open many spans, with the interpreter switching threads as often as
    it can, leave the exact count."""
    reset_spans("mt")
    n_threads, n_spans = 8, 2000

    def work():
        for _ in range(n_spans):
            with span("mt.a"):
                pass
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert spans()["mt.a"][0] == n_threads * n_spans


def test_tracing_off_keeps_totals_only():
    """With tracing off a span adds to its totals and nothing else: no
    record and no profiler range."""
    enable_trace(False)
    reset_spans("off")
    n_rec = len(span_records())

    def work():
        with span("off.a"):
            torch.ones(8).sum()
    names = _profiled(work)
    assert spans()["off.a"][0] == 1
    assert len(span_records()) == n_rec
    assert "off.a" not in names


def test_tracing_on_opens_profiler_ranges(tracing):
    reset_spans("on")

    def work():
        with span("on.a"):
            with span("on.a.b"):
                torch.ones(8).sum()
    names = _profiled(work)
    assert {"on.a", "on.a.b"} <= names
    assert [(n, p) for n, p, _, _ in span_records()
            if n.startswith("on.")] == [("on.a.b", "on.a"), ("on.a", None)]


def test_engine_spans_in_a_cpu_profile(data, tracing):
    """A CPU engine's map_batch_async and resolve under the profiler:
    the engine's spans by name, each part inside its call, and the
    step's stages as ranges (an eager call)."""
    eng = _engine(data)
    bl = batches(data, "r1.fastq", "r2.fastq", 300)[:2]
    reset_spans("engine")

    def work():
        hs = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
              for s1, l1, s2, l2, nos in bl]
        for h in hs:
            eng.resolve(h)
    names = _profiled(work)
    assert set(ENQUEUE + RESOLVE + STEP) <= names
    got = spans()
    for k in ENQUEUE + RESOLVE:
        assert got[k][0] == len(bl), k
    parents = {n: p for n, p, _, _ in span_records()
               if n.startswith("engine.")}
    for k in ENQUEUE[1:]:
        assert parents[k] == "engine.enqueue"
    for k in RESOLVE[1:]:
        assert parents[k] == "engine.resolve"
    assert parents["engine.enqueue"] is None
    # the parts lie within their call
    assert got["engine.enqueue"][1] >= sum(got[k][1] for k in ENQUEUE[1:])
    assert got["engine.resolve"][1] >= sum(
        got[k][1] for k in got if k.startswith("engine.resolve."))


def test_stage_does_nothing_while_tracing_is_off():
    """Off: no range and no event; a program captures no stage."""
    enable_trace(False)
    prog = StepProgram(_staged_step, CPU)

    def work():
        with stage("st.off"):
            prog([(torch.arange(4),)])
    names = _profiled(work)
    assert not {"st.off", "st.x"} & names
    assert prog.stages == [] and prog.stage_ms() == {}


def test_stage_on_the_cpu_is_a_range(tracing):
    """On the CPU a program never captures, so its stages are profiler
    ranges of the eager step and nothing is left to time on a device."""
    prog = StepProgram(_staged_step, CPU)
    names = _profiled(lambda: [prog([(torch.arange(4),)]) for _ in range(3)])
    assert "st.x" in names
    assert prog.stages == [] and prog.stage_ms() == {}
    with log.collect_stages() as sink:
        pass
    assert sink == []


def _staged_step(x):
    with stage("st.x"):
        return x * 2


def test_index_and_upload_spans(data):
    """The index files' readers, the seed index's loaders in
    ``device_route`` and the engine's upload each add a span."""
    before = spans()
    _engine(data)
    sdx = read_sdx(str(data / "g.sdx"))
    runner.device_route(sdx.genome_size, lambda: 1, lambda: 2)
    done = spans_since(before)
    for k in ("index.files.sdx", "index.files.seq", "index.files.idx",
              "engine.upload", "engine.seed_index"):
        assert done[k][0] >= 1, k


def test_map_files_logs_the_spans_event(data, tmp_path, monkeypatch):
    """run_mapper's last event: the batches and each engine span's count
    and ms a batch of this run, and the writers' seconds."""
    events = []
    monkeypatch.setattr(runner, "event",
                        lambda lg, kind, **kw: events.append((kind, kw)))
    for r in ("r1.fastq", "r2.fastq"):
        shutil.copy(data / r, tmp_path / r)
    cfg = runner.MapperConfig(
        out_base=str(tmp_path / "out"), sdx_path=str(data / "g.sdx"),
        paired=True, files1=[str(tmp_path / "r1.fastq")],
        files2=[str(tmp_path / "r2.fastq")], max_dist=500, min_dist=0,
        batch_size=600, device=True, nthreads=2)
    runner.run_mapper(cfg, device=CPU)
    kind, kw = events[-1]
    assert kind == "spans" and kw["batches"] == 2 and kw["n_shards"] == 1
    assert kw["write_outputs_s"] > 0
    for k in ENQUEUE + RESOLVE:
        n, ms = kw[k]
        assert n == 2 and ms >= 0, k
    assert kw["engine.enqueue"][1] >= kw["engine.enqueue.prep"][1]
    assert "engine.upload" not in kw        # set-up, before the batches


def test_spans_event_counts_the_batches_of_any_engine(data, tmp_path,
                                                      monkeypatch):
    """The host engine opens no engine span: the event still counts the
    run's batches, and gives no figures a batch."""
    events = []
    monkeypatch.setattr(runner, "event",
                        lambda lg, kind, **kw: events.append((kind, kw)))
    for r in ("r1.fastq", "r2.fastq"):
        shutil.copy(data / r, tmp_path / r)
    cfg = runner.MapperConfig(
        out_base=str(tmp_path / "out"), sdx_path=str(data / "g.sdx"),
        paired=True, files1=[str(tmp_path / "r1.fastq")],
        files2=[str(tmp_path / "r2.fastq")], max_dist=500, min_dist=0,
        batch_size=600, device=False, nthreads=2)
    runner.run_mapper(cfg)
    kind, kw = events[-1]
    assert kind == "spans" and kw["batches"] == 2
    assert not [k for k in kw if k.startswith("engine.")]


@pytest.mark.parametrize("mode,keys", [
    (dict(host_screen=True),
     {"dist", "merge", "native", "read", "screen", "write"}),
    (dict(host_screen=False),
     {"dist", "easy", "merge", "native", "read", "screen", "stats",
      "write"}),
    (dict(device_screen=False),
     {"dist", "merge", "native", "read", "screen", "write"}),
    (dict(device_beam=True),
     {"beam", "beam_finish", "dist", "merge", "native", "read", "screen",
      "write"})], ids=["host_screen", "device_screen", "exact", "beam"])
def test_run_caller_phases_keep_their_keys(tmp_path, mode, keys):
    """``phases`` has the keys it had before it was read from the
    ``caller.*`` spans, each once, in seconds."""
    from pecaller_tpu.formats.pileup import write_pileup
    from pecaller_tpu_torch.caller import CallerConfig, run_caller
    from test_screen import _fuzz_counts, _mk_sdx
    d = str(tmp_path)
    rng = np.random.default_rng(45)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, 3, 600)
    for i in range(3):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    res = run_caller(CallerConfig(
        out_base=os.path.join(d, "o"), device="cpu", pileup_ext="pileup",
        sdx_path=os.path.join(d, "g.sdx"), prob_to_call=0.95, theta=0.001,
        directory=d, nthreads=2, **mode))
    assert set(res["phases"]) == keys
    assert all(v >= 0 for v in res["phases"].values())


@pytest.mark.cuda
def test_stage_ms_sum_to_the_replay(data, cuda_device, tracing):
    """Captured with tracing on, a small v2 program's six stages (event
    nodes in its graph) sum to within 3% of the same replay timed by
    events around it."""
    eng = _engine(data, device=cuda_device)
    bl = batches(data, "r1.fastq", "r2.fastq", 300)[:1] * 3
    for s1, l1, s2, l2, nos in bl:          # eager, capture, replay
        eng.map_batch(s1, l1, s2, l2, read_nos=nos)
    prog, = [p for p in eng.programs if p.calls == 3]
    assert [n for n, _, _ in prog.stages] == list(STEP)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    totals, stage_sums = [], []
    for _ in range(5):
        a.record()
        prog.replay()
        b.record()
        torch.cuda.synchronize(cuda_device)
        totals.append(a.elapsed_time(b))
        got = prog.stage_ms()
        assert set(got) == set(STEP) and min(got.values()) > 0
        stage_sums.append(sum(got.values()))
    total, parts = float(np.median(totals)), float(np.median(stage_sums))
    assert abs(parts - total) <= 0.03 * total, (parts, total)
