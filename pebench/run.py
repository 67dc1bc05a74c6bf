"""One run of one cell of the benchmark of ``pecaller_tpu_torch``.

    python3 -m pebench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the window's answers matched the plain reference (``correct``), the
reads attempted and the compared read answers that failed, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``,
with the device's busy and traced seconds and a breakdown), the device,
and last the numbers compared, each beside its limit; the same numbers
are the last lines of standard error.  Exits non-zero, printing no
result, without the CUDA cards the cell asks for, or where JAX or the
JAX package entered the process.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pecaller_tpu")


def foreign_modules() -> list:
    """Modules in this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's (compared whole: ``pecaller_tpu_torch``
    is not ``pecaller_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pebench import cells, harness
    import torch

    cfg = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cfg["chips"]:
        print(f"pebench: the cell needs {cfg['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rec = harness.run(cfg, args.seed, args.seconds, bool(args.trace),
                      T_START)
    bad = foreign_modules()
    if bad:
        print(f"pebench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3

    metrics = cells.report(cfg["per_layer"] if args.trace
                           else cfg["end_to_end"], rec)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cfg["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["reads"],
           "failed": rec["compared"]["answers_wrong"]["value"],
           "metrics": metrics, "device": device}
    if args.trace:
        t = rec.get("trace") or {}
        device["busy_s"] = t.get("busy_s", 0.0)
        device["window_s"] = t.get("window_s", 0.0)
        ops = sorted(t.get("ops", {}).items(), key=lambda kv: -kv[1][1])
        out["breakdown"] = {
            "device_ops": [[n[:120], s] for n, (_, s) in ops[:10]],
            "idle_gaps": [[n, s] for n, s in t.get("gaps", [])[:10]]}
    out["compared"] = rec["compared"]
    info = {"card": _power_limit(), "builds": rec["builds"],
            "engine": rec["engine"], "reference_s": rec["reference_s"],
            "sample_pairs": rec["sample_pairs"],
            "answers_compared": rec["answers_compared"],
            "kernels": rec.get("kernels"), "window_s": rec["window_s"],
            "setup_s": rec["setup_s"], "setup_parts": rec["setup_parts"],
            "fastq_s": rec["fastq_s"], "index_load_s": rec["index_load_s"],
            "reads_per_s": rec["reads"] / rec["window_s"],
            "host_ms_per_batch": {k: 1e3 * sum(v) / max(len(v), 1)
                                  for k, v in rec["spans"].items()},
            "replay_ms": rec.get("replay_ms")}
    print("pebench: " + json.dumps(info, default=str), file=sys.stderr)
    for k, v in rec["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
