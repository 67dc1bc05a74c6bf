"""Structured logging and the port's timing (SURVEY §5.1: the reference
has only progress printfs; the new build gets structured timing from day
one).

Usage:
    from pecaller_tpu_torch.utils.log import event, get_logger, span
    log = get_logger("mapper")
    with span("engine.resolve.wait"):
        ...
    event(log, "file_done", records=n)

``span(name)`` (a context manager, or a decorator) always keeps a count
and the total seconds of each name: two ``perf_counter_ns`` reads and an
add.  After ``enable_trace()`` each span is also kept as a record (name,
innermost enclosing span, start, end) and opens a
``torch.profiler.record_function`` range of its name, so that in a
profiled stretch the spans lie on the profiler's clock beside the card's
operations.  ``stage(name)`` marks a part of a device step: with tracing
on, a pair of timed CUDA events inside a graph being captured by a
``StepProgram`` (read back by its ``stage_ms()``), else the profiler
range; with tracing off it does nothing.  Nothing is written to disk.

Set PECALLER_TPU_LOG=json for machine-readable lines, =0 to silence.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
from time import perf_counter_ns

_FMT = os.environ.get("PECALLER_TPU_LOG", "text")


def get_logger(name: str) -> logging.Logger:
    log = logging.getLogger(f"pecaller_tpu_torch.{name}")
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(h)
        log.setLevel(logging.WARNING if _FMT == "0" else logging.INFO)
        log.propagate = False
    return log


def event(log: logging.Logger, kind: str, **fields) -> None:
    if _FMT == "json":
        log.info(json.dumps({"event": kind, **fields}))
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        log.info("%s %s", kind, kv)


# --------------------------------------------------------------------------
# spans

_totals: dict = {}          # name -> [count, nanoseconds]
_lock = threading.Lock()
_trace = False
_records: list = []         # (name, parent, start_ns, end_ns), traced only
_open = threading.local()   # .names: the spans open in this thread, traced
_stage_sink = None          # the capturing program's stage events


class span(contextlib.ContextDecorator):
    """Time the enclosed block under ``name`` (dotted: one prefix a
    layer, ``engine.resolve.wait``).  As a decorator, each call is one
    span."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        if _trace:
            import torch
            names = getattr(_open, "names", None)
            if names is None:
                names = _open.names = []
            self.parent = names[-1] if names else None
            names.append(self.name)
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        with _lock:
            c = _totals.get(self.name)
            if c is None:
                c = _totals[self.name] = [0, 0]
            c[0] += 1
            c[1] += t1 - self.t0
            if self.range is not None:
                _records.append((self.name, self.parent, self.t0, t1))
        if self.range is not None:
            self.range.__exit__(*exc)
            _open.names.pop()
        return False


def enable_trace(on: bool = True) -> None:
    """Keep each span as a record and open a profiler range for it, and
    time the stages of the device programs captured from now on."""
    global _trace
    _trace = on


def spans() -> dict:
    """Each span name's (count, total seconds) since the last reset."""
    with _lock:
        return {k: (n, ns * 1e-9) for k, (n, ns) in _totals.items()}


def spans_since(before: dict) -> dict:
    """The (count, seconds) each name added since ``before`` (an earlier
    ``spans()``), for the names that ran since."""
    out = {}
    for k, (n, s) in spans().items():
        n0, s0 = before.get(k, (0, 0.0))
        if n > n0:
            out[k] = (n - n0, s - s0)
    return out


def span_records() -> list:
    """The spans recorded while tracing: (name, innermost enclosing span
    or None, start, end), in ``time.perf_counter`` seconds, in the order
    they ended."""
    with _lock:
        return [(n, p, a * 1e-9, b * 1e-9) for n, p, a, b in _records]


def reset_spans(*prefixes: str) -> None:
    """Forget the totals and records of every span, or only of the names
    under ``prefixes`` (a name itself or a dotted parent of it)."""
    def hit(name):
        return not prefixes or any(name == p or name.startswith(p + ".")
                                   for p in prefixes)
    with _lock:
        for k in [k for k in _totals if hit(k)]:
            del _totals[k]
        _records[:] = [r for r in _records if not hit(r[0])]


# --------------------------------------------------------------------------
# stages of a device step

class stage:
    """A part of a device step.  With tracing off: nothing.  With
    tracing on, inside a ``collect_stages()`` (a ``StepProgram``'s graph
    capture): a timed CUDA event recorded on the current stream at each
    end, which the capture turns into event nodes of the graph; anywhere
    else: a profiler range of its name."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.cm = self.sink = None
        if not _trace:
            return self
        import torch
        if _stage_sink is not None:
            self.sink = _stage_sink
            self.ends = (torch.cuda.Event(enable_timing=True, external=True),
                         torch.cuda.Event(enable_timing=True, external=True))
            self.ends[0].record()
        else:
            self.cm = torch.profiler.record_function(self.name)
            self.cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cm is not None:
            self.cm.__exit__(*exc)
        elif self.sink is not None:
            self.ends[1].record()
            self.sink.append((self.name, *self.ends))
        return False


@contextlib.contextmanager
def collect_stages():
    """Gather the events of the stages run inside (name, start, end);
    only while tracing, else the list stays empty."""
    global _stage_sink
    sink = []
    if not _trace:
        yield sink
        return
    outer, _stage_sink = _stage_sink, sink
    try:
        yield sink
    finally:
        _stage_sink = outer
