"""The card's idle gaps in a profiled stretch, each named by the innermost
of the program's spans (``engine.*``, opened as profiler ranges once the
program traces, ``utils.log.enable_trace``) open at the gap's start.
Not a metric: read by ``pebench/spans.py``."""

from __future__ import annotations

import torch

from .trace import SPANS, _union


def gaps_by_span(prof, prefix: str = "engine.", top: int = 10) -> dict:
    """The ``top`` longest idle gaps of the traced stretch (from its first
    to its last device operation) as [name, seconds], and the idle
    seconds summed by name; a gap that no span covers is "loop"."""
    dev, span = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or e.name() in SPANS
                    or e.name().startswith(prefix)):
                dev.append((s, s + d))
        elif e.name().startswith(prefix):
            span.append((s, s + d, e.name()))
    if not dev:
        return {}
    gaps = []
    busy = _union(dev)
    edge = busy[0][0]
    for s, e in busy:
        if s > edge:
            open_ = [(a, n) for a, b, n in span if a <= edge < b]
            gaps.append((max(open_)[1] if open_ else "loop",
                         (s - edge) * 1e-9))
        edge = max(edge, e)
    by = {}
    for n, g in gaps:
        by[n] = by.get(n, 0.0) + g
    return {"top": [[n, g] for n, g in sorted(gaps, key=lambda x: -x[1])
                    [:top]],
            "by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "window_s": (busy[-1][1] - busy[0][0]) * 1e-9}
