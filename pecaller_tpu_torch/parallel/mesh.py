"""Mesh scale-out of the fused mapping step, single controller.

Counterpart of ``pecaller_tpu/parallel/mesh.py``.  The reference's only
scale-out is one process per directory via SGE qsub
(map_directory_array.pl:101); the JAX package drives a device mesh from
one process through ``shard_map``.  So does the port, with explicit
devices:

* ``make_mesh`` is a (reads, genome) grid of torch devices.  A device
  may appear more than once: shards on one device share its index
  tensors and differ only in their pileup partials.
* reads axis (``sharded_fused_step2``): each shard runs the whole v2
  step on its B / n pairs (``shard_units`` keeps both ends of a pair on
  one shard) and adds into its own pileup partial; the partials are
  summed once, at pileup download.  No collective inside the step.
* genome axis (mapper/gshard.py): each shard's step is a generator that
  yields at its collectives (``ShardComm``).  ``mapper.program.
  MeshProgram`` runs the shards segment by segment over any set of
  devices, each collective reduced on every device the shards use
  (``reduce_collective``, in shard order), the segments and reductions
  CUDA graphs on a card; ``lockstep`` (``graph=False``) advances them
  eagerly and reduces on the first shard's device.  Deterministic, no
  threads, no process group.
* ``sharded_map_step``: the SW batch (K3 on the card) and its
  traceback on each shard's lanes, the partial pileups reduce-scattered
  (each device sums its shards' row blocks of every partial in shard
  order), one row block a shard.
* ``sharded_call_step``: sites split into one contiguous block a shard,
  ``site_likelihoods`` on each, no collective beyond the final gather.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """A (reads, genome) grid of torch devices (``devices[r][g]``)."""

    def __init__(self, devices, n_reads: int, n_genome: int):
        self.devices = [list(devices[r * n_genome:(r + 1) * n_genome])
                        for r in range(n_reads)]
        self.shape = {"reads": n_reads, "genome": n_genome}

    @property
    def size(self) -> int:
        return self.shape["reads"] * self.shape["genome"]

    @property
    def flat(self) -> list:
        """Every shard's device, reads-major (the shard order)."""
        return [d for row in self.devices for d in row]


def make_mesh(n_reads_shards: int, n_genome_shards: int = 1,
              devices=None) -> Mesh:
    """The mesh of ``n_reads_shards x n_genome_shards`` shards on the
    first devices of ``devices`` (default: every visible CUDA device;
    a list may repeat a device).  Raises where there are too few."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = n_reads_shards * n_genome_shards
    if n < 1 or len(devices) < n:
        raise ValueError(f"a {n_reads_shards} x {n_genome_shards} mesh "
                         f"needs {n} devices, got {len(devices)}")
    return Mesh([resolve_device(d) for d in devices[:n]], n_reads_shards,
                n_genome_shards)


def sharded_map_step(mesh: Mesh, genome_size: int, bisulfite: bool = False,
                     graph: bool = True):
    """The mapping compute step over every shard of ``mesh``.

    Step signature: (refs (B, N) uint8, blens (B,) int32, reads (B, M)
    uint8, rlens (B,) int32), numpy or tensors -> (score x36, bk, bi:
    (B,) int32 each in shard order on the first shard's device, blocks:
    ``mesh.size`` (gs_pad / n, 6) int16 tensors, block s on shard s's
    device).  Each shard scores its B / n lanes with
    ``ops.sw_cuda.sw_align`` (K3 on the card, the plain version on the
    CPU), walks them back with ``sw_traceback_device`` and adds the
    events, at their window rows, into a (gs_pad, 6) partial pileup of
    uint16 bits (``pileup_scatter``).  The partials are reduce-scattered
    (``ShardComm.psum_scatter``, the counterpart of the reference's
    ``psum_scatter``): each device sums row block s of every partial in
    shard order (wrapping mod 2^16) for each shard s it holds, so no
    device holds more than its shards' partials and blocks.  B not
    divisible by the number of shards raises ValueError.

    Each input shape runs as one ``mapper.program.MeshProgram`` (the
    counterpart of the reference's ``jax.jit(shard_map(local_step))``):
    with ``graph`` on a card each shard's segment before and after the
    reduce-scatter, each device's reduction and the gather of score, bk
    and bi are CUDA graphs, captured at the shape's second call; the
    outputs are then the program's, which the next call overwrites.
    ``graph=False`` runs the same segments and reductions eagerly.
    ``step.programs`` maps each input shape to its program."""
    from ..mapper.program import MeshProgram
    from ..ops import sw as psw
    from ..ops import sw_cuda
    devs = mesh.flat
    n = len(devs)
    gs_pad = -(-genome_size // n) * n

    def shard(s):
        comm = ShardComm(s, n)

        def run(refs, blens, reads, rlens):
            bl = refs.shape[0] // n
            r, bln, rd, rl = (x[s * bl:(s + 1) * bl]
                              for x in (refs, blens, reads, rlens))
            score, bk, bi = sw_cuda.sw_align(r, bln, rd, rl,
                                             bisulfite=bisulfite)
            ev_pos, ev_kind, ins_j, _ = psw.sw_traceback_device(
                r, bln, rd, rl, bk, bi, bisulfite=bisulfite)
            part = psw.pileup_scatter(
                ev_pos.reshape(-1).long(), ev_kind.reshape(-1),
                (ins_j >= 0).reshape(-1),
                torch.zeros((gs_pad, 6), dtype=torch.int16,
                            device=r.device))
            block = yield from comm.psum_scatter(part)
            return torch.stack([score, bk, bi]), block
        return run

    def gather(firsts):
        """(3, B / n) a shard -> score, bk, bi rows of (3, B)."""
        return torch.cat(firsts, dim=1)
    programs = {}

    def step(refs, blens, reads, rlens):
        ins = [x if isinstance(x, torch.Tensor) else np.asarray(x)
               for x in (refs, blens, reads, rlens)]
        B = ins[0].shape[0]
        if B % n:
            raise ValueError(f"B={B} must divide by n_shards={n}")
        key = tuple((tuple(x.shape), str(x.dtype)) for x in ins)
        if key not in programs:
            programs[key] = MeshProgram([shard(s) for s in range(n)], devs,
                                        gather, graph=graph)
        (score, bk, bi), blocks = programs[key](ins)
        return score, bk, bi, list(blocks)
    step.programs = programs
    return step


def sharded_call_step(mesh: Mesh, indiv: int, graph: bool = True):
    """The per-site genotype-likelihood step over every shard of
    ``mesh`` (sites are the data axis): step(reads (S, indiv, 6),
    ref_int (S,)) splits the sites into one contiguous block a shard,
    runs ``caller.device_model.site_likelihoods`` on each block's device
    and returns the (S, indiv, 14) f32 likelihoods concatenated on the
    first shard's device.

    With ``graph`` each input shape runs as device programs (the
    counterpart of the reference's ``jax.jit(shard_map(local_step))``;
    ``caller.device_model.site_program``): where every shard is on one
    device, one program holds every block and the concatenation, and
    the result is its output, which the next call of that shape
    overwrites; over several devices, one program a shard and shape,
    the blocks gathered outside the graphs.  ``step.programs`` maps
    each input shape (with several devices: each (shard, shape)) to its
    program.  ``graph=False`` runs the blocks eagerly."""
    from ..caller.device_model import site_likelihoods, site_program
    devs = mesh.flat
    P = len(devs)

    def check(reads):
        if reads.shape[1] != indiv:
            raise ValueError(f"reads carry {reads.shape[1]} samples, the "
                             f"step {indiv}")
        S = reads.shape[0]
        return [S * p // P for p in range(P + 1)]

    def eager(reads, ref_int):
        reads, ref_int = torch.as_tensor(reads), torch.as_tensor(ref_int)
        cuts = check(reads)
        return torch.cat([
            site_likelihoods(reads[a:b].to(d), ref_int[a:b].to(d)).to(
                devs[0]) for d, a, b in zip(devs, cuts, cuts[1:])])
    if not graph:
        return eager
    if len(set(devs)) == 1:
        return site_program(eager, devs[0])
    shards = [site_program(site_likelihoods, d) for d in devs]

    def step(reads, ref_int):
        cuts = check(reads)
        out = torch.cat([fn(reads[a:b], ref_int[a:b]).to(devs[0])
                         for fn, a, b in zip(shards, cuts, cuts[1:])])
        step.programs.update({(s, k): p for s, fn in enumerate(shards)
                              for k, p in fn.programs.items()})
        return out
    step.programs = {}
    return step


def shard_units(arr, n_shards: int, B: int, paired: bool):
    """Split a (U, ...) end-major batch into (n_shards, U_local, ...)
    keeping both ends of each pair on the same shard (decide_pair needs
    them together).  For paired input U = 2B rows [end1 | end2]."""
    if not paired:
        return np.ascontiguousarray(
            arr.reshape(n_shards, B // n_shards, *arr.shape[1:]))
    bl = B // n_shards
    a = arr.reshape(2, n_shards, bl, *arr.shape[1:])
    return np.ascontiguousarray(
        a.transpose(1, 0, *range(2, a.ndim)).reshape(
            n_shards, 2 * bl, *arr.shape[1:]))


def shard_states(mesh: Mesh, base_states: dict, n_counts: int) -> list:
    """One DeviceState a shard: its device's index and genome tensors
    (``base_states[device]``, shared by the shards on that device) and a
    pileup partial of ``n_counts`` int32 counters of its own."""
    return [replace(base_states[d], dev_counts=torch.zeros(
        n_counts, dtype=torch.int32, device=d)) for d in mesh.flat]


def sharded_fused_step2(mesh: Mesh, states: list, *, paired: bool,
                        bisulfite: bool, min_dist: int, max_dist: int,
                        n_contigs: int, B: int, M: int, N: int, s_max: int,
                        max_rlen: int | None = None, graph: bool = True,
                        **caps):
    """The v2 fused step over every shard of ``mesh`` on the reads axis.

    ``states`` holds each shard's DeviceState (``shard_states``).
    Returns (step, n_shards): ``step(ins)`` takes the batch arrays of
    the single step, each split by ``shard_units`` to (n_shards, ...),
    runs one FusedStep2 of B / n_shards pairs a shard on its device, as
    one ``StepProgram`` a shard (``graph``: a CUDA graph on a card; the
    shards on one device replay in shard order on its current stream),
    adds into that shard's ``dev_counts`` and returns the shards' packed
    output blocks (tensors on their devices, overwritten by the next
    call).  ``step.steps`` and ``step.programs`` list the shards'
    FusedStep2 and programs.  ``caps``: ins_cap, tie_cap."""
    from ..mapper.device_map2 import FusedStep2
    from ..mapper.program import StepProgram
    n_shards = mesh.size
    if B % n_shards:
        raise ValueError(f"B={B} must divide by n_shards={n_shards}")
    steps = [FusedStep2(st.dnbr, paired=paired, bisulfite=bisulfite,
                        min_dist=min_dist, max_dist=max_dist,
                        n_contigs=n_contigs, B=B // n_shards, M=M, N=N,
                        s_max=s_max, max_rlen=max_rlen, **caps)
             for st in states]
    programs = [StepProgram(partial(fn, st), st.dev_counts.device,
                            graph=graph) for fn, st in zip(steps, states)]

    def step(ins):
        return [prog([[x[s] for x in ins]])[0]
                for s, prog in enumerate(programs)]
    step.steps = steps
    step.programs = programs
    return step, n_shards


class ShardComm:
    """The collectives of shard ``index`` of ``size``: each is a
    generator that yields its request to the runner (``lockstep``, or
    ``mapper.program.MeshProgram``) and returns the reduced tensor on
    the shard's device."""

    def __init__(self, index: int, size: int):
        self.index = index
        self.size = size

    def pmax(self, x):
        return (yield ("pmax", x))

    def psum(self, x):
        return (yield ("psum", x))

    def all_gather(self, x, dim: int):
        """Concatenation along ``dim`` in shard order (tiled)."""
        return (yield ("all_gather", x, dim))

    def psum_scatter(self, x):
        """Row block ``index`` of the shard-order sum (x's rows split
        into ``size`` blocks).  ``mapper.program.MeshProgram`` runs it;
        ``lockstep`` does not."""
        return (yield ("psum_scatter", x))


def collective_operand(req, s: int, n: int):
    """What shard ``s``'s result of the collective ``req`` (kind,
    operand[, dim]) needs of one of the ``n`` shards' operand: all of
    it, or for a reduce-scatter its row block ``s``."""
    x = req[1]
    if req[0] == "psum_scatter":
        return x.view(n, x.shape[0] // n, *x.shape[1:])[s]
    return x


def reduce_collective(req, xs):
    """The collective ``req`` over ``xs``, the shards' operands (or
    their ``collective_operand``) in shard order on one device: pmax
    and psum elementwise (psum in the operands' dtype, as the
    reference's int32 psum), all_gather a shard-major concatenation."""
    kind = req[0]
    if kind == "pmax":
        return torch.stack(xs).amax(0)
    if kind in ("psum", "psum_scatter"):
        return torch.stack(xs).sum(0, dtype=xs[0].dtype)
    if kind == "all_gather":
        return torch.cat(xs, dim=req[2])
    raise ValueError(f"unknown collective {kind!r}")


def lockstep(gens) -> list:
    """Advance the genome shards' step generators together: at each
    collective reduce their tensors in shard order on the first shard's
    device and send each shard the result on its own device.  Returns
    every shard's return value.  Raises where the shards disagree on
    the collective they are at."""
    sends = [None] * len(gens)
    while True:
        reqs, done = [], []
        for g, v in zip(gens, sends):
            try:
                reqs.append(g.send(v))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if reqs:
                raise RuntimeError("genome shards left the step at "
                                   "different collectives")
            return done
        kind = reqs[0][0]
        if any(r[0] != kind or r[2:] != reqs[0][2:] for r in reqs):
            raise RuntimeError(f"genome shards at different collectives: "
                               f"{[r[0] for r in reqs]}")
        if kind == "psum_scatter":
            raise ValueError("lockstep runs no reduce-scatter")
        dev0 = reqs[0][1].device
        red = reduce_collective(reqs[0], [r[1].to(dev0) for r in reqs])
        sends = [red.to(r[1].device) for r in reqs]
