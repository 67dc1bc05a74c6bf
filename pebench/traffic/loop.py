"""The batch stream as the port's runner drives it, and its rate.

``Stream`` keeps ``2 * group_k + 1`` batches in flight between the
engine's ``map_batch_async`` and ``resolve``, the loop shape of
``mapper/runner.py:map_files`` (copied here so that the yardstick does
not move with the program).  Each call's host seconds are kept as spans;
``annotate`` (a context-manager factory, ``torch.profiler
.record_function`` in a traced run) names them in the profiler's trace.
"""

from __future__ import annotations

import contextlib
import time


class Stream:
    def __init__(self, eng, batches, on_resolved, annotate=None):
        self.eng = eng
        self.batches = batches
        self.on_resolved = on_resolved
        self.depth = 2 * getattr(eng, "_group_k", 1) + 1
        self.pending = []
        self.annotate = annotate or (lambda name: contextlib.nullcontext())
        self.spans = {"enqueue": [], "resolve": []}
        self.reads = 0

    def push(self, b: int):
        s1, l1, s2, l2, nos = self.batches[b]
        t = time.perf_counter()
        with self.annotate("pebench.enqueue"):
            h = self.eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
        self.spans["enqueue"].append(time.perf_counter() - t)
        self.pending.append((b, h))
        if len(self.pending) >= self.depth:
            self.pop()

    def pop(self):
        b, h = self.pending.pop(0)
        t = time.perf_counter()
        with self.annotate("pebench.resolve"):
            m1, m2, code = self.eng.resolve(h)
        self.spans["resolve"].append(time.perf_counter() - t)
        s1, l1, s2, l2, _ = self.batches[b]
        self.reads += len(l1) + (len(l2) if l2 is not None else 0)
        self.on_resolved(b, m1, m2, code)

    def drain(self):
        while self.pending:
            self.pop()


def rate(reads: int, seconds: float) -> float:
    """Reads a second: every read resolved in the window over the whole
    window, the drain of the batches in flight at its end included."""
    return reads / seconds
