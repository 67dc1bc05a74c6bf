"""The check's control: the plain reference computed in float32 (the
precision below the float64 that the mapper's alignment states) put in
the program's place by ``reference_in_place``, driven through the
harness's own run of a cell at the cell's size, with a window that
resolves every batch of the sample once.  It must come out not correct
on every seed.

    python3 -m pebench.control --workload <cell> --seeds <n>[,<n>...]

Prints one JSON line a seed with the numbers compared and the seconds
the run and its reference took.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pebench import cells, harness
from pebench.reference import mapper as ref
from pebench.traffic import gen


def reference_in_place(dtype, seq: np.ndarray, device="cpu",
                       only_sample: bool = False):
    """An ``engine_hook`` that replaces the engine's ``map_batch_async`` /
    ``resolve`` by the plain reference at ``dtype`` on ``seq``, adding to
    the engine's pileup, insertion records and summary as the program
    does.  With ``only_sample`` it maps the check's sample pairs alone
    and returns the others unmapped: the numbers compared read no
    other pair, and the summary is held to the answers returned."""
    def hook(eng, smp):
        table = ref.KmerTable(seq, device)
        st = ref.Settings(eng.min_align, eng.max_dist, eng.min_dist)

        def map_batch_async(s1, l1, s2, l2, read_nos=None):
            return (s1, l1, s2, l2, read_nos)

        def resolve(h):
            s1, l1, s2, l2, nos = h
            n = len(l1)
            pick = np.isin(nos, smp["pairs"]) if only_sample \
                else np.ones(n, bool)
            idx = np.nonzero(pick)[0]
            m1 = np.zeros(n, np.uint32)
            m2 = np.zeros(n, np.uint32)
            code = np.full(n, ref.NEITHER_MAP, np.int32)
            if len(idx):
                w = int(max(l1.max(), l2.max()))
                out = ref.map_pairs(seq, table, s1[idx, :w], l1[idx],
                                    s2[idx, :w], l2[idx], st, dtype, device)
                ev = out["events"]
                np.add.at(eng.pileup[0], (ev[:, 1], ev[:, 2]), 1)
                for p, end, g, s in out["insertions"]:
                    eng.ins_records.append(((int(nos[idx[p]]), end), g, s))
                m1[idx] = out["m1"]
                m2[idx] = out["m2"]
                code[idx] = out["codes"]
            eng._accumulate_stats(code, m1, m2, l1.astype(np.int64),
                                  l2.astype(np.int64))
            return m1, m2, code
        eng.map_batch_async = map_batch_async
        eng.resolve = resolve
    return hook


def control(cfg: dict, seed: int, device) -> dict:
    config, traffic = cfg["config"], cfg["traffic"]
    hook = reference_in_place(torch.float32, gen.genome(config), device,
                              only_sample=True)
    n_batches = -(-config["sample_pairs"] // traffic["batch_pairs"])
    t = time.perf_counter()
    rec = harness.run(cfg, seed, 0.0, False, time.time(), engine_hook=hook,
                      min_batches=n_batches)
    return dict(seed=seed, correct=rec["correct"],
                compared={k: v["value"] for k, v in rec["compared"].items()},
                sample_pairs=rec["sample_pairs"],
                answers_compared=rec["answers_compared"],
                run_s=time.perf_counter() - t,
                reference_s=rec["reference_s"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pebench.control: no CUDA card", file=sys.stderr)
        return 2
    cfg = cells.load(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control(cfg, int(s), torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
