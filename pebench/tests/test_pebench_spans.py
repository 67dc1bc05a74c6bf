"""The readers of the program's set-up spans and graph captures, the
window's span breakdown
and the idle gaps named by span (``pebench/spans.py``,
``metrics/span_gaps.py``), on hand-built spans and events and on a CPU
run of the harness with the program tracing."""

import time

import pytest
import torch

from pebench import cells, harness, spans as tool
from pebench.metrics import span_gaps
from pebench.tests.test_pebench_check import CFG
from pecaller_tpu_torch.utils import log

READERS = {"seed_index_load_s": "engine.seed_index",
           "index_upload_s": "engine.upload"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_setup_reader_reads_its_span(metric):
    name = READERS[metric]
    read = cells.reader(metric)
    log.reset_spans(name)
    assert read({}) is None                 # the span has not run
    with log.span(name):
        time.sleep(0.01)
    got = read({})
    assert got == pytest.approx(log.spans()[name][1]) and got >= 0.01
    log.reset_spans(name)


def test_graph_build_reads_the_programs_captures():
    read = cells.reader("graph_build_s")
    progs = [dict(calls=5, capture_s=0.25, pool_bytes=1),
             dict(calls=1, capture_s=None, pool_bytes=None),
             dict(calls=3, capture_s=0.5, instantiate_s=0.125,
                  pool_bytes=1)]
    assert read({"engine": {"programs": progs}}) == pytest.approx(0.875)
    assert read({"engine": {"programs": progs[1:2]}}) is None
    assert read({"engine": {}}) is None and read({}) is None


def test_window_spans_take_the_last_batches():
    recs = [("engine.enqueue", None, 0.0, 1.0),       # set-up
            ("engine.resolve.wait", "engine.resolve", 1.0, 1.5),
            ("engine.resolve", None, 1.0, 2.0),
            ("engine.enqueue", None, 10.0, 10.010),   # the window
            ("engine.enqueue.prep", "engine.enqueue", 10.0, 10.004),
            ("engine.enqueue", None, 10.1, 10.120),
            ("engine.resolve", None, 10.2, 10.230),
            ("engine.resolve", None, 10.3, 10.310),
            ("index.files.sdx", None, 10.4, 10.5)]
    got = tool.window_spans(recs, 2)
    assert got["engine.enqueue"]["n"] == 2
    assert got["engine.enqueue"]["ms_per_batch"] == pytest.approx(15.0)
    assert got["engine.enqueue.prep"]["ms_per_batch"] == pytest.approx(2.0)
    assert got["engine.resolve"]["ms_per_batch"] == pytest.approx(20.0)
    assert "engine.resolve.wait" not in got and "index.files.sdx" not in got
    assert tool.window_spans(recs, 5) == {}


class _Ev:
    def __init__(self, name, s, e, cuda):
        self._n, self._s, self._d, self._c = name, s, e - s, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": res})()


def test_gaps_named_by_the_innermost_span():
    ms = 1_000_000
    prof = _Prof([
        _Ev("kernel", 0, 10 * ms, True),
        _Ev("kernel", 30 * ms, 40 * ms, True),
        _Ev("kernel", 45 * ms, 50 * ms, True),
        _Ev("engine.resolve", 5 * ms, 35 * ms, False),
        _Ev("engine.resolve.tiefix", 8 * ms, 20 * ms, False),
        _Ev("engine.resolve", 41 * ms, 42 * ms, False)])
    got = span_gaps.gaps_by_span(prof)
    assert got["top"][0] == ["engine.resolve.tiefix", pytest.approx(0.020)]
    assert got["top"][1] == ["loop", pytest.approx(0.005)]
    assert got["by_span"] == {"engine.resolve.tiefix": pytest.approx(0.020),
                              "loop": pytest.approx(0.005)}
    assert got["window_s"] == pytest.approx(0.050)
    assert span_gaps.gaps_by_span(_Prof([])) == {}


def test_a_traced_cpu_run_reads_the_program(tiny_index):
    """The harness's run on the CPU with the program tracing: the window's
    engine spans and the set-up readers find their spans."""
    d, _ = tiny_index
    log.reset_spans(*READERS.values())
    log.enable_trace()
    try:
        rec = harness.run(CFG, 20260101, 0.5, False, time.time(),
                          devices=[torch.device("cpu")], cache=d)
    finally:
        log.enable_trace(False)
    assert rec["correct"], rec["compared"]
    n = len(rec["spans"]["enqueue"])
    got = tool.window_spans(log.span_records(), n)
    assert got["engine.enqueue"]["n"] == n
    assert got["engine.resolve"]["n"] == n
    for k in ("engine.enqueue.prep", "engine.enqueue.fill",
              "engine.resolve.wait", "engine.resolve.stats"):
        assert got[k]["n"] == n, k
    outside = 1e3 * sum(rec["spans"]["resolve"]) / n
    assert got["engine.resolve"]["ms_per_batch"] <= outside
    totals = log.spans()
    for metric, name in READERS.items():
        got = cells.reader(metric)(rec)
        assert got > 0 and got == totals[name][1], metric
    assert cells.reader("graph_build_s")(rec) is None   # no graph here
