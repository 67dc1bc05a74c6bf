"""Nothing that a run imports has the top-level name jax, jaxlib, flax or
pecaller_tpu (compared whole: pecaller_tpu_torch is the port), shown by
driving a run's set-up, window, trace, check and readers on the CPU in a
fresh interpreter; the run itself refuses to print a result without a
card, and the benchmark's files name every configuration, traffic mix
and metric reader they use."""

import json
import os
import subprocess
import sys

from pebench import cells

ROOT = cells.ROOT

DRIVE = r"""
import json, sys, time, torch
sys.path.insert(0, {root!r})
from pebench import cells, harness, run
from pebench.tests.test_pebench_check import CFG
rec = harness.run(CFG, 7, 0.5, True, time.time(),
                  devices=[torch.device("cpu")], cache={cache!r})
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for m in bench["end_to_end"] + bench["per_layer"]:
    cells.reader(m["name"])(rec)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(run.foreign_modules()))
"""


def test_a_run_imports_no_jax(tiny_index):
    d, _ = tiny_index
    out = subprocess.run([sys.executable, "-c",
                          DRIVE.format(root=ROOT, cache=d)],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, foreign = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert "pecaller_tpu_torch" in tops and "torch" in tops
    for bad in ("jax", "jaxlib", "flax", "pecaller_tpu"):
        assert bad not in tops
    assert foreign == []


def test_run_needs_a_card():
    out = subprocess.run([sys.executable, "-m", "pebench.run", "--workload",
                          "synth5m.wgsim100.b20k", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_finds_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        c = cells.load(w["name"])
        assert c["config"]["name"] == w["config"]
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(cells.reader(m["name"]))
    assert bench["paths"] == ["pebench"]
