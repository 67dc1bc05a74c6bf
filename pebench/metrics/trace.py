"""Readings of a traced run: the device's busy time, its operations and
idle gaps from the profiler's trace, a replay's device time, and the
kernels' times.  Shared by the harness and the readers; not a metric."""

from __future__ import annotations

import torch

K1_NAME, K2_NAME = "SwXMatch", "tb_rows"     # in K1's / K2's kernel name
SPANS = ("pebench.enqueue", "pebench.resolve")


def _union(iv):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(prof) -> dict:
    """The traced stretch, from the first to the last device operation:
    device-busy seconds (the union of every kernel, copy and set on the
    card), the stretch's seconds, seconds and counts by device operation,
    and the idle gaps each named by the host span (enqueue, resolve, or
    the loop itself) that was open at its start."""
    ev = prof.profiler.kineto_results.events()
    dev, span = [], []
    for e in ev:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors the host's annotations on the device's
            # timeline; they are no work of the card's
            if not (e.is_user_annotation() or e.name() in SPANS):
                dev.append((e.name(), s, s + d))
        elif e.name() in SPANS:
            span.append((s, s + d, e.name().split(".")[1]))
    if not dev:
        return {}
    # from the first to the last operation the trace saw on the card: the
    # replay running when the tracer started, and the one it stopped in,
    # are cut off, and would read as idle
    t0 = min(s for _, s, _ in dev)
    t1 = max(e for _, _, e in dev)
    ops = {}
    for n, s, e in dev:
        c = ops.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) * 1e-9
    busy = _union([(s, e) for _, s, e in dev])
    gaps = []
    edge = t0
    for s, e in busy:
        if s > edge:
            what = next((n for a, b, n in span if a <= edge < b), "loop")
            gaps.append((what, (s - edge) * 1e-9))
        edge = max(edge, e)
    return {"busy_s": sum(e - s for s, e in busy) * 1e-9,
            "window_s": (t1 - t0) * 1e-9, "ops": ops,
            "gaps": sorted(gaps, key=lambda g: -g[1]),
            "n_device_events": len(dev)}


def replay_ms(eng, devices):
    """Device ms of one bare replay of the main shape key's program(s)
    (the most called), by CUDA events over five replays, as the smoke's
    ``_replay_ms``.  A replay adds into the pileup: take it after the
    outputs that the check judges."""
    if devices[0].type != "cuda":
        return None
    progs = [p for p in eng.programs if p.capture_s is not None]
    if not progs:
        return None
    most = max(p.calls for p in progs)
    progs = [p for p in progs if p.calls == most]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for d in devices:
        torch.cuda.synchronize(d)
    reps = 5
    with torch.cuda.device(devices[0]):
        a.record()
        for _ in range(reps):
            for p in progs:
                p.replay()
        b.record()
    for d in devices:
        torch.cuda.synchronize(d)
    return a.elapsed_time(b) / reps


def kernel_times(summary: dict | None) -> dict:
    """Each kernel's ms a launch in the traced stretch (the profiler names
    K1 and K2 inside the graphs' replays)."""
    out = {}
    ops = (summary or {}).get("ops", {})
    for k, tag in (("k1", K1_NAME), ("k2", K2_NAME)):
        hit = [v for n, v in ops.items() if tag in n]
        if hit:
            n = sum(c for c, _ in hit)
            out[k] = {"ms": 1e3 * sum(s for _, s in hit) / n, "launches": n}
    return out
