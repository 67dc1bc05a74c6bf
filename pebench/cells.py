"""The benchmark's data: a cell of ``BENCHMARK.json`` with its
configuration, traffic mix and metrics, each found by its name.

A configuration is the file that ``BENCHMARK.json`` names, a traffic mix
is ``traffic/<name>.json`` and a metric is ``metrics/<name>.py`` with a
``read(record)`` that returns the metric's value, or None where the run
recorded nothing for it.  A later cell or metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(name: str, path: str | None = None) -> dict:
    """The cell ``name``: its entry, ``config``, ``traffic``, ``chips`` and
    the end-to-end and per-layer metrics it reports."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, traffic=traffic,
                chips=cell["chips"], run_seconds=bench["run_seconds"],
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pebench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def report(metrics: list, record: dict) -> dict:
    """Each metric's value from the run's record, with its unit; a metric
    whose reader finds nothing is left out."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
