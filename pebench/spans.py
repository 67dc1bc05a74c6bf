"""The program's own view of one run of a cell: the harness's run with the
port's timing module reading inside the engine.

    python3 -m pebench.spans --workload <cell> --seed <n> --seconds <s> \\
        [--profile 0|1]

The program traces (``utils.log.enable_trace``) from before the engine
is built, so that its step programs capture their stage events; the
untraced program's cost is ``pebench.run --trace 0``'s.  Prints, as the
last line of standard output, one JSON object: the cell's end-to-end
readings and the benchmark's outside views (host spans around
``map_batch_async`` and ``resolve``, the replay by events); the
program's ``engine.*`` spans a batch over the window's batches; the
engine's counters a batch; the main shape key's replay by stage
(medians of 5 synced bare replays, beside the same replays timed from
outside); the set-up spans and the graphs' capture (``capture_stats``);
and with ``--profile 1`` the harness's profiled stretch, its idle gaps
named by the innermost ``engine.*`` span.  Not a cell of the benchmark:
nothing here is compared, and a run's numbers come from the same harness
as ``pebench.run``'s.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

SETUP = ("engine.seed_index", "engine.upload")


def window_spans(records, n_batches: int) -> dict:
    """ms a batch of each ``engine.*`` span over the last ``n_batches``
    calls of ``engine.enqueue`` and what started after the first of
    them (the window: nothing after it opens an engine span), with each
    name's count."""
    starts = [a for name, _, a, _ in records if name == "engine.enqueue"]
    if len(starts) < n_batches or not n_batches:
        return {}
    t0 = starts[-n_batches]
    out = {}
    for name, _, a, b in records:
        if a >= t0 and name.startswith("engine."):
            c = out.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += 1e3 * (b - a) / n_batches
    return {k: {"n": c, "ms_per_batch": ms} for k, (c, ms) in
            sorted(out.items())}


def stage_replays(eng, reps: int = 5) -> dict:
    """The most-called program's stages in ``reps`` synced bare replays
    (``StepProgram.stage_ms``), medians, beside the same replays timed by
    events around them."""
    import torch
    progs = [p for p in eng.programs if getattr(p, "stages", None)]
    if not progs:
        return {}
    prog = max(progs, key=lambda p: p.calls)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    outside, parts = [], {}
    with torch.cuda.device(prog.device):
        for _ in range(reps):
            a.record()
            prog.replay()
            b.record()
            torch.cuda.synchronize(prog.device)
            outside.append(a.elapsed_time(b))
            for k, v in prog.stage_ms().items():
                parts.setdefault(k, []).append(v)
    ms = {k: statistics.median(v) for k, v in parts.items()}
    return {"stage_ms": ms, "stage_sum_ms": sum(ms.values()),
            "replay_ms_outside": statistics.median(outside),
            "group": prog.group}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pebench import cells, harness, run
    from pebench.metrics import span_gaps
    import torch
    from pecaller_tpu_torch.mapper.program import capture_stats
    from pecaller_tpu_torch.utils import log

    cfg = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cfg["chips"]:
        print(f"pebench.spans: the cell needs {cfg['chips']} CUDA card(s)",
              file=sys.stderr)
        return 2
    log.enable_trace()
    kept = {"after_resolve": []}

    def hook(eng, smp):
        # the engine outlives the harness's run for the stage replays;
        # its host counters are read after each resolve
        kept["eng"] = eng
        resolve = eng.resolve

        def counted(h):
            out = resolve(h)
            kept["after_resolve"].append((eng.n_fallback, eng.n_tiefix))
            return out
        eng.resolve = counted
    profs = []
    make = harness._profiler

    def keep(devices):
        profs.append(make(devices))
        return profs[-1]
    harness._profiler = keep
    try:
        rec = harness.run(cfg, args.seed, args.seconds, bool(args.profile),
                          T_START, engine_hook=hook)
    finally:
        harness._profiler = make
    eng = kept["eng"]
    del eng.resolve                         # the class's own again
    n = len(rec["spans"]["enqueue"])
    seen = kept["after_resolve"]
    n_all = len(seen)
    w0 = seen[-n - 1] if n_all > n else (0, 0)
    out = {
        "card": run._power_limit(), "workload": args.workload,
        "seed": args.seed, "profile": args.profile, "correct": rec["correct"],
        "reads_per_s": rec["reads"] / rec["window_s"],
        "setup_s": rec["setup_s"],
        "peak_device_gib": rec["peak_bytes"] / 2 ** 30,
        "window_batches": n,
        "outside": {k: 1e3 * sum(v) / max(len(v), 1)
                    for k, v in rec["spans"].items()},
        "index_load_s": rec["index_load_s"],
        "replay_ms": rec.get("replay_ms"),
        "window_spans": window_spans(log.span_records(), n),
        "counters_per_batch": {
            "n_fallback": (seen[-1][0] - w0[0]) / n if n else None,
            "n_tiefix": (seen[-1][1] - w0[1]) / n if n else None,
            # a device read: the total over every resolve, set-up's too
            "n_cap_fallback": eng.n_cap_fallback / n_all if n_all else None},
        "setup_spans": {k: s for k, (_, s) in log.spans().items()
                        if k in SETUP or k.startswith("index.")},
        "graphs": capture_stats(eng.programs),
        "stages": stage_replays(eng)}
    if profs:
        t = rec.get("trace") or {}
        out["device_idle_pct"] = (100.0 * (1 - t["busy_s"] / t["window_s"])
                                  if t.get("window_s") else None)
        out["gaps"] = span_gaps.gaps_by_span(profs[-1])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
