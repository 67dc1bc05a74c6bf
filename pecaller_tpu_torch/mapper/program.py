"""One shape key's mapping step as one device program.

Counterpart of the JAX package's compiled step,
``jax.jit(step, donate_argnums=(0,))``
(``pecaller_tpu/mapper/device_map2.py:1533-1535``, and
``device_pipeline.py:417``, ``:451`` for v1), and of
``build_fused_multi`` (``device_map2.py:1538-1569``), which scans K
batches in one program.  On the card the program is a CUDA graph,
captured once a shape key and replayed each batch: the step's ~2,200
(v2) or ~40,000 (v1) kernels then cost one launch instead of their
Python enqueue.  The step's persistent tensors (the index, the genome,
the pileup counters ``dev_counts`` and the probe's ``n_cap_fb``) are
captured by address: they are updated in place and never reassigned.

Every mapping step of the port runs as one: the v2, v2.5 and v1 steps,
each reads-mesh shard's, the genome mesh's (all shards and their
collectives, ``mapper/gshard.py``), the split engine's seed step and
traceback (``mapper/device_engine.py``) and ``sharded_map_step``
(``parallel/mesh.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..ops import sw_cuda


class StepProgram:
    """``step(*inputs) -> tensor`` for one shape key on static input
    slots, ``group`` batches a call.

    ``program(batches)`` takes ``group`` batches, each a sequence of the
    step's inputs (host arrays or tensors), copies them into the slots
    (one set a batch) and returns the ``(group, ...)`` stack of the
    step's outputs.  On a card the first call runs the steps eagerly (the
    warm-up, whose result is that call's result), the second captures
    them into one CUDA graph and replays it, and every later call
    replays it.  A replay's output lives in the graph's memory, and the
    next call overwrites it: start its copy to the host
    (``device_map2.fetch_async``) before calling again.  The pinned input
    copies, the replay and the fetch all go on the device's current
    stream, in call order.  On the CPU the steps run on the slots at each
    call and their result is copied into one static output tensor, which
    the next call overwrites as a replay would.  ``graph=False`` runs the
    steps eagerly at every call and returns a fresh tensor.  A capture
    that fails raises; nothing falls back to the eager steps.

    ``pool`` (``torch.cuda.graph_pool_handle()``): a memory pool that the
    graphs of several programs share instead of one pool each.  One
    program's replay may then overwrite another's output: share a pool
    only between programs that replay one at a time on one stream, each
    output copied out (``fetch_async``) before the next replay.

    The kernel wrappers count their launches while the graph is
    captured, though a capture launches nothing: the program takes those
    counts back out and adds them on every replay (``launches``)."""

    def __init__(self, step, device, group: int = 1, graph: bool = True,
                 pool=None):
        if group < 1:
            raise ValueError(f"group must be at least 1, got {group}")
        self.step = step
        self.device = torch.device(device)
        self.group = group
        self.graph = graph
        self.pool = pool
        self.slots = None
        self.out = None
        self.calls = 0
        self.launches = None         # kernel launches of one replay
        self.capture_s = None        # the captured enqueue of the steps
        self.instantiate_s = None    # end of capture: graph instantiation
        self.pool_bytes = None       # device memory the graph's pool holds
        self._graph = None

    def __call__(self, batches) -> torch.Tensor:
        if len(batches) != self.group:
            raise ValueError(f"the program runs {self.group} batches a "
                             f"call, got {len(batches)}")
        self.calls += 1
        if self.device.type != "cuda":
            self._fill(batches)
            out = self._run()
            if not self.graph:
                return out
            if self.out is None:
                self.out = torch.empty_like(out)
            return self.out.copy_(out)
        with torch.cuda.device(self.device):
            self._fill(batches)
            if not self.graph or self.calls == 1:
                return self._run()
            if self._graph is None:
                self._capture()
            self._graph.replay()
            sw_cuda.count_replay(self.launches)
            return self.out

    def _fill(self, batches) -> None:
        hosts = [[x if isinstance(x, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(x)) for x in b]
                 for b in batches]
        if self.slots is None:
            self.slots = [[torch.empty(h.shape, dtype=h.dtype,
                                       device=self.device) for h in b]
                          for b in hosts]
        for slots, b in zip(self.slots, hosts):
            if len(b) != len(slots):
                raise ValueError(f"the step takes {len(slots)} inputs, "
                                 f"got {len(b)}")
            for slot, h in zip(slots, b):
                if h.shape != slot.shape or h.dtype != slot.dtype:
                    raise ValueError(
                        f"input {tuple(h.shape)} {h.dtype} does not fit "
                        f"the program's slot {tuple(slot.shape)} "
                        f"{slot.dtype}")
                if self.device.type == "cuda" and h.device.type == "cpu":
                    slot.copy_(h.pin_memory(), non_blocking=True)
                else:
                    slot.copy_(h)

    def _run(self) -> torch.Tensor:
        return torch.stack([self.step(*slots) for slots in self.slots])

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = dict(sw_cuda.LAUNCHES)
        # a collection during the capture could free another program's
        # graph or pinned buffers (objects in reference cycles): calls
        # that invalidate the capture.  None runs within it.
        gc_on = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=torch.cuda.Stream(self.device)):
                reserved = torch.cuda.memory_reserved(self.device)
                out = self._run()
                t1 = time.perf_counter()
        finally:
            if gc_on:
                gc.enable()
            self.launches = sw_cuda.launches_since(before)
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph, self.out = graph, out


def capture_stats(programs) -> dict:
    """How many of ``programs`` captured a graph, the seconds their
    captures and instantiations took, and the bytes their pools hold."""
    caps = [p for p in programs if p.capture_s is not None]
    return dict(programs=len(programs), graphs=len(caps),
                capture_s=sum(p.capture_s for p in caps),
                instantiate_s=sum(p.instantiate_s for p in caps),
                pool_bytes=sum(p.pool_bytes for p in caps))
