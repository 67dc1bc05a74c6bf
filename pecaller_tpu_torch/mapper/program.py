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
each reads-mesh shard's, the split engine's seed step and traceback
(``mapper/device_engine.py``).  The steps whose shards meet at
collectives, the genome mesh's (``mapper/gshard.py``) and
``sharded_map_step`` (``parallel/mesh.py``), run as a ``MeshProgram``
over any set of devices: the counterpart of ``jax.jit(shard_map(...))``
(``pecaller_tpu/mapper/gshard.py:48-84``,
``pecaller_tpu/parallel/mesh.py:49-81``), one CUDA graph a shard a
segment between collectives and the reductions on the cards.
"""

from __future__ import annotations

import gc
import time
import warnings
from functools import partial

import numpy as np
import torch

from ..ops import sw_cuda
from ..parallel.mesh import collective_operand, reduce_collective
from ..utils.log import collect_stages


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
    counts back out and adds them on every replay (``launches``).

    ``load(batches)`` and ``launch()`` are a call's two halves, the
    copies in and the steps, for a caller that times them apart.  A
    capture made while ``utils.log`` traces turns each ``log.stage`` of
    the step into a pair of timed event nodes of the graph, read after
    a replay by ``stage_ms()``; untraced, the graph has none."""

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
        self.stages = []             # (name, start, end) events, traced
        self._graph = None

    def __call__(self, batches) -> torch.Tensor:
        self.load(batches)
        return self.launch()

    def load(self, batches) -> None:
        """Copy ``group`` batches' inputs into the slots (on a card from
        pinned host copies, on the device's current stream)."""
        if len(batches) != self.group:
            raise ValueError(f"the program runs {self.group} batches a "
                             f"call, got {len(batches)}")
        if self.device.type != "cuda":
            self._fill(batches)
            return
        with torch.cuda.device(self.device):
            self._fill(batches)

    def launch(self) -> torch.Tensor:
        """Run the steps on the loaded slots: ``__call__`` less the
        copies in."""
        self.calls += 1
        if self.device.type != "cuda":
            out = self._run()
            if not self.graph:
                return out
            if self.out is None:
                self.out = torch.empty_like(out)
            return self.out.copy_(out)
        with torch.cuda.device(self.device):
            if not self.graph or self.calls == 1:
                return self._run()
            if self._graph is None:
                self._capture()
            self.replay()
            sw_cuda.count_replay(self.launches)
            return self.out

    def replay(self) -> None:
        """Enqueue one replay of the captured graph."""
        self._graph.replay()

    def stage_ms(self) -> dict:
        """Device ms of each ``log.stage`` of the step in the last replay,
        for one batch (a group's batches summed, over ``group``); waits
        for the device.  Empty unless tracing was on at the capture."""
        if not self.stages:
            return {}
        torch.cuda.synchronize(self.device)
        out = {}
        for name, a, b in self.stages:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / self.group
        return out

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
            with collect_stages() as stages:
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
        self.stages = stages
        self.capture_s = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph, self.out = graph, out


def _advance(gen, value):
    """Run a shard's step generator to its next collective: ("req",
    request), or ("done", return value) at its end."""
    try:
        return "req", gen.send(value)
    except StopIteration as stop:
        return "done", stop.value


class MeshProgram:
    """The steps of a mesh's shards for one shape key, cut at their
    collectives into segments, on static input slots: the counterpart
    of ``jax.jit(shard_map(local))`` over any set of devices.

    ``steps[g](*inputs)`` starts shard g's step on its device
    ``devices[g]`` (a device may hold several shards) as a generator
    that yields a request at each collective (``parallel.mesh.
    ShardComm``) and returns ``(first, local)``.  ``program(inputs)``
    copies the inputs (host arrays or tensors) once into each device's
    slots, runs the shards and returns ``(gather(firsts), locals)``:
    ``gather`` of every shard's ``first`` on ``devices[0]``, and every
    shard's ``local`` on its own device.

    The shards advance together: every shard's segment k, then
    collective k reduced on each device the shards use.  Each device
    reduces the same operands in shard order (``parallel.mesh.
    reduce_collective``), so it holds the result for its own shards and
    nothing is sent back; a peer's operand reaches it by a copy into a
    receive slot (torch's cross-device copy: on the peer's current
    stream, ordered both ways by events).  On a card the first call
    runs eagerly (the warm-up, whose result is that call's result).
    The second captures each shard's segments, each device's
    reductions and the gather as CUDA graphs on their devices, one
    graph pool a device shared by all of its graphs, then replays them;
    later calls replay.  A replay enqueues the graphs and copies in
    capture order and waits on nothing: each device runs its graphs in
    that order on its current stream, and a copy runs on its source's
    stream, so no graph overwrites a tensor before every device has read
    it, with any number of batches in flight.  The outputs live in the
    graphs' memory and the next call overwrites them: start their copy
    to the host (``device_map2.fetch_async``) before calling again.  On
    the CPU the segments and reductions run in the same order at each
    call and the outputs are copied into static tensors, which the next
    call overwrites.  ``graph=False`` runs eagerly at each call and
    returns fresh tensors.  A capture that fails raises; nothing falls
    back to the eager run.

    ``collectives`` lists the kinds of the collectives a run met, in
    order; ``segments`` is their count + 1, the segments a shard.  The
    capture's launch counts are taken back out and added on each replay
    (``launches``), as ``StepProgram`` does."""

    def __init__(self, steps, devices, gather, graph: bool = True):
        if len(steps) != len(devices):
            raise ValueError(f"{len(steps)} shards on {len(devices)} "
                             "devices: one device a shard")
        self.steps = steps
        self.devices = [torch.device(d) for d in devices]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("a mesh program's devices are of one type")
        self.by_device = {}              # device -> its shards, in order
        for g, d in enumerate(self.devices):
            self.by_device.setdefault(d, []).append(g)
        self.gather = gather
        self.graph = graph
        self.slots = None
        self.out = None
        self.calls = 0
        self.collectives = None
        self.launches = None         # kernel launches of one replay
        self.capture_s = None        # the captured enqueue, every graph
        self.instantiate_s = None    # the graphs' instantiation
        self.pool_bytes = None       # device memory the pools hold
        self.pool_bytes_by_device = None
        self.pools = None            # one graph pool a device
        self._stages = None          # one replay: graphs and copies

    @property
    def segments(self):
        """Segments a shard (after a run)."""
        return None if self.collectives is None else len(self.collectives) + 1

    @property
    def n_graphs(self) -> int:
        """Graphs one replay enqueues (segments, reductions, gather)."""
        return sum(not isinstance(s, tuple) for s in self._stages or ())

    @property
    def n_copies(self) -> int:
        """Cross-device copies one replay enqueues."""
        return sum(isinstance(s, tuple) for s in self._stages or ())

    def __call__(self, inputs):
        self.calls += 1
        cuda = self.devices[0].type == "cuda"
        self._fill(inputs)
        if cuda and self.graph and self.calls > 1:
            if self._stages is None:
                self._capture()
            self.replay()
            sw_cuda.count_replay(self.launches)
            return self.out
        first, local = self._drive(self._run_eager, lambda d, x: x.to(d))
        if cuda or not self.graph:
            return first, local
        if self.out is None:
            self.out = (torch.empty_like(first),
                        [None if x is None else torch.empty_like(x)
                         for x in local])
        self.out[0].copy_(first)
        for o, x in zip(self.out[1], local):
            if x is not None:
                o.copy_(x)
        return self.out

    def replay(self) -> None:
        """Enqueue one replay: every graph and copy in capture order."""
        for st in self._stages:
            if isinstance(st, tuple):
                st[0].copy_(st[1], non_blocking=True)
            else:
                st.replay()

    def _fill(self, inputs) -> None:
        hosts = [x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(x))
                 for x in inputs]
        if self.devices[0].type == "cuda":
            hosts = [h.pin_memory() if h.device.type == "cpu" else h
                     for h in hosts]
        if self.slots is None:
            self.slots = {d: [torch.empty(h.shape, dtype=h.dtype, device=d)
                              for h in hosts] for d in self.by_device}
        for slots in self.slots.values():
            if len(hosts) != len(slots):
                raise ValueError(f"the step takes {len(slots)} inputs, "
                                 f"got {len(hosts)}")
            for slot, h in zip(slots, hosts):
                if h.shape != slot.shape or h.dtype != slot.dtype:
                    raise ValueError(
                        f"input {tuple(h.shape)} {h.dtype} does not fit "
                        f"the program's slot {tuple(slot.shape)} "
                        f"{slot.dtype}")
                slot.copy_(h, non_blocking=True)

    @staticmethod
    def _run_eager(d, fn):
        if d.type != "cuda":
            return fn()
        with torch.cuda.device(d):
            return fn()

    def _drive(self, run, move):
        """Advance the shards segment by segment: ``run(d, fn)`` runs
        ``fn`` (a shard's next segment, a device's reduction, the
        gather) on device ``d``; ``move(d, x)`` brings a peer's tensor
        ``x`` to ``d``.  Returns ``(gather(firsts), locals)``.  Raises
        where the shards disagree on the collective they are at."""
        G = len(self.steps)
        gens = [step(*self.slots[d])
                for step, d in zip(self.steps, self.devices)]
        sends = [None] * G
        kinds = []
        while True:
            got = [run(d, partial(_advance, gen, v))
                   for gen, v, d in zip(gens, sends, self.devices)]
            n_done = sum(kind == "done" for kind, _ in got)
            if n_done:
                if n_done < G:
                    raise RuntimeError("mesh shards left the step at "
                                       "different collectives")
                break
            reqs = [r for _, r in got]
            req = reqs[0]
            if any(r[0] != req[0] or r[2:] != req[2:] for r in reqs):
                raise RuntimeError(f"mesh shards at different collectives: "
                                   f"{[r[0] for r in reqs]}")
            kinds.append(req[0])
            for d, mine in self.by_device.items():
                # a reduce-scatter's result differs a shard; the others'
                # is one a device
                owners = ([[s] for s in mine] if req[0] == "psum_scatter"
                          else [mine])
                for own in owners:
                    xs = [collective_operand(r, own[0], G) for r in reqs]
                    xs = [x if self.devices[h] == d else move(d, x)
                          for h, x in enumerate(xs)]
                    red = run(d, partial(reduce_collective, req, xs))
                    for s in own:
                        sends[s] = red
        self.collectives = kinds
        d0 = self.devices[0]
        firsts = [v[0] if d == d0 else move(d0, v[0])
                  for (_, v), d in zip(got, self.devices)]
        return run(d0, partial(self.gather, firsts)), [v[1] for _, v in got]

    def _capture(self) -> None:
        """Capture every segment, reduction and the gather as graphs on
        their devices, the copies between them in order (``_stages``)."""
        devs = list(self.by_device)
        self.pools = {}
        streams = {}
        for d in devs:
            with torch.cuda.device(d):
                self.pools[d] = torch.cuda.graph_pool_handle()
                streams[d] = torch.cuda.Stream(d)
        grown = dict.fromkeys(devs, 0)
        stages = []
        times = [0.0, 0.0]

        def run(d, fn):
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                # a segment between two collectives with nothing to
                # compute between them (the genome step's consecutive
                # all_gathers) captures an empty graph: replayed, it
                # does nothing
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                with torch.cuda.device(d), torch.cuda.graph(
                        graph, pool=self.pools[d], stream=streams[d]):
                    # entering the capture emptied the allocator's cache:
                    # what is reserved from here on is the pool's growth
                    reserved = torch.cuda.memory_reserved(d)
                    out = fn()
                    t1 = time.perf_counter()
            times[0] += t1 - t0
            times[1] += time.perf_counter() - t1
            grown[d] += torch.cuda.memory_reserved(d) - reserved
            stages.append(graph)
            return out

        def move(d, x):
            slot = torch.empty(x.shape, dtype=x.dtype, device=d)
            stages.append((slot, x))
            return slot
        before = dict(sw_cuda.LAUNCHES)
        # as StepProgram._capture: no collection during the captures
        gc_on = gc.isenabled()
        gc.disable()
        try:
            out = self._drive(run, move)
        finally:
            if gc_on:
                gc.enable()
            self.launches = sw_cuda.launches_since(before)
        self.capture_s, self.instantiate_s = times
        self.pool_bytes_by_device = {str(d): grown[d] for d in devs}
        self.pool_bytes = sum(grown.values())
        self._stages, self.out = stages, out


def capture_stats(programs) -> dict:
    """How many of ``programs`` captured a graph, the seconds their
    captures and instantiations took, and the bytes their pools hold."""
    caps = [p for p in programs if p.capture_s is not None]
    return dict(programs=len(programs), graphs=len(caps),
                capture_s=sum(p.capture_s for p in caps),
                instantiate_s=sum(p.instantiate_s for p in caps),
                pool_bytes=sum(p.pool_bytes for p in caps))
