"""Genome-sharded octile mapping engine (docs/SCALING.md): mm10/hg38-
scale device seeding over a mesh ``genome`` axis.

Counterpart of ``pecaller_tpu/mapper/gshard.py``.  Each shard holds an
octile index and a genome slice in LOCAL coordinates (index/shard.py)
on its device; each shard runs the full fused step, and the shards meet
at the collectives that stand where the reference consults its global
structures (pemapper.c:2129-2165 index, :497-522 genome, :2188-2289
chaining):

  * chain min-match ratchet / per-probe candidate totals: pmax / psum
  * candidate ownership by window start; overlap duplicates dropped
  * decide over the all_gather'ed per-shard top lists (global coords)
  * winner traceback + pileup add stay OWNER-LOCAL; the pileup stays
    genome-sharded until artifact download

The shards' steps run together in this process, one generator a shard
that yields at each collective.  Reads are replicated over the genome
axis (a batch is ~4 MB; the index is the heavy operand).  The public
engine API (map_batch_async / resolve / final_pileup) is that of
FusedMapperEngine2.  A batch's step, every shard's and the collectives
between them, is one ``MeshProgram`` a shape key
(``mapper/program.py``; the counterpart of the reference's
``jax.jit(shard_map(local))``) over any set of devices: each shard's
step cut at its 13 collectives into 14 segments, each segment a CUDA
graph on its shard's device, each collective reduced on every device
the shards use (a graph of its own), the stacked output gathered on the
first device.  ``graph=False`` runs the shards eagerly under
``parallel.mesh.lockstep``.

One divergence from the reference: where the shards' merged walk-tie
records would pass ``tie_cap`` the reference raises; here the step
ranks the tied lanes over all shards and demotes the units past the cap
to the host remap, as the single-device step does with its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.index_files import SeedIndex
from ..formats.sdx import SdxInfo
from ..index.shard import ShardPlan, build_octile_shards, plan_shards
from ..parallel.mesh import ShardComm, lockstep
from ..utils.log import span
from .device_map2 import (INS_CAP, SCATTER_PAD, TIE_CAP, DeviceState,
                          FusedMapperEngine2, FusedStep2, OctileDeviceIndex)
from .engine import MapperEngine
from .host_prep import pack_genome
from .program import MeshProgram, StepProgram


def sharded_genome_step(states: list, **step_kw):
    """The fused step over the genome shards of ``states`` (one
    DeviceState a shard, its ``gctx`` set).  Returns ``step(*ins)``: the
    batch tensors of the single step on the first shard's device, copied
    once to each other device the shards use (reads are replicated over
    the genome axis), the shards run in lockstep; returns their output
    blocks stacked, (G, rows, 6) on the first shard's device.
    ``step.steps`` lists the shards' FusedStep2, ``step.shards`` their
    steps as a ``MeshProgram`` takes them (``(output block, None)``
    returned)."""
    G = len(states)
    steps = [FusedStep2(st.dnbr, comm=ShardComm(g, G), **step_kw)
             for g, st in enumerate(states)]

    def shard(fn, st):
        def run(*ins):
            return (yield from fn.run(st, *ins)), None
        return run

    def step(*ins):
        ups, gens = {ins[0].device: ins}, []
        for fn, st in zip(steps, states):
            d = st.dev_counts.device
            if d not in ups:
                ups[d] = [x.to(d) for x in ins]
            gens.append(fn.run(st, *ups[d]))
        outs = lockstep(gens)
        return torch.stack([o.to(outs[0].device) for o in outs])
    step.steps = steps
    step.shards = [shard(fn, st) for fn, st in zip(steps, states)]
    return step


def _words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 words as int64 values on ``device``."""
    return torch.from_numpy(a.astype(np.int64)).to(device)


class OctileShardedEngine(FusedMapperEngine2):
    """FusedMapperEngine2 API over genome-sharded octile shards.

    ``mesh``: ``parallel.mesh.make_mesh(1, G, devices)``, one shard a
    mesh device (a device may hold several).  ``plan`` and ``shards``
    default to ``plan_shards(sdx, G)`` and ``build_octile_shards``;
    ``t1`` and ``rcap`` are the octile probe's parameters
    (``OctileDeviceIndex``).

    Each shape key's step, all shards and their collectives, runs as one
    ``MeshProgram`` over the mesh's devices with one fetch of the
    stacked blocks from the first: on a card a CUDA graph a shard a
    segment and a graph a device a collective, captured at the key's
    second batch (``graph``).  ``graph=False`` runs the shards' steps
    eagerly under ``lockstep`` (a ``StepProgram`` that captures
    nothing).  The host's spans are the v2 engine's: the input copies
    and the replays (or the eager step's enqueue) in
    ``engine.enqueue.dispatch``, the wait for the one copy back in
    ``engine.resolve.wait``.  No batches are grouped."""

    def __init__(self, sdx: SdxInfo, genome: np.ndarray, index: SeedIndex,
                 mesh, plan: ShardPlan | None = None, shards=None,
                 t1: int = 4, rcap: int = 12, ins_cap: int = INS_CAP,
                 tie_cap: int = TIE_CAP, graph: bool = True, **kwargs):
        if mesh.shape["reads"] != 1:
            raise ValueError("the genome-sharded engine takes a mesh of one "
                             "reads row")
        MapperEngine.__init__(self, sdx, genome, index, **kwargs)
        self._mesh = mesh
        self._n_sh = 1                  # reads axis unsharded here
        self._graph = graph
        self.device = mesh.flat[0]
        self.ins_cap, self.tie_cap = ins_cap, tie_cap
        self._steps = {}
        self._programs = {}
        self.n_fallback = 0
        self.n_tiefix = 0
        G = mesh.shape["genome"]
        if plan is None:
            plan = plan_shards(sdx, G)
        if shards is None:
            shards = build_octile_shards(index, plan)
        if len(shards) != G:
            raise ValueError("shard count != mesh genome axis size")
        self._plan = plan
        emax = max(len(np.asarray(s.pos)) for s in shards)
        # per-shard genome slices (seq coords) of one padded length
        # (+SCATTER_PAD: a window's pileup rows may overhang the covered
        # span with EV_NONE zero rows)
        cs_max = int(plan.cover_seq.max()) + SCATTER_PAD
        cs_max = ((cs_max + 31) // 32) * 32
        self._local_seq = cs_max
        ist = sdx.istarts.astype(np.int64)
        n_pad = max(sdx.n_contigs + 1, 70) + 1
        gctx = plan.gctx()
        with span("engine.upload"):
            self.states = []
            for g, dev in enumerate(mesh.flat):
                b = int(plan.bases_seq[g])
                sl = np.full(cs_max, ord("N"), np.uint8)
                src = genome[b:b + cs_max]
                sl[:len(src)] = src
                cw, mw = pack_genome(sl)
                bi = int(plan.bases_idx[g])
                stp = np.full(n_pad, 2 ** 31 - 1, np.int64)
                stp[:len(ist)] = ist - bi
                clip = (-(2 ** 31) + 1, 2 ** 31 - 1)
                self.states.append(DeviceState(
                    OctileDeviceIndex(shards[g], dev, t1=t1, rcap=rcap,
                                      pad_entries=emax, pad_tb=shards[0].tb),
                    _words(cw, dev), _words(mw, dev),
                    torch.from_numpy(np.clip(ist - bi, *clip).astype(
                        np.int32)).to(dev),
                    torch.from_numpy(np.clip(stp, *clip).astype(np.int32)).to(
                        dev),
                    torch.zeros(cs_max * 6, dtype=torch.int32, device=dev),
                    torch.from_numpy(gctx[g]).to(dev)))
        self.state = self.states[0]

    def _step_for(self, B, M, N, s_max, mr):
        key = (B, M, N, s_max, mr)
        if key not in self._steps:
            self._steps[key] = sharded_genome_step(
                self.states, **self._step_kw(B, M, N, s_max, mr))
        return self._steps[key]

    def _program_for(self, K, key):
        if (K, key) not in self._programs:
            step = self._step_for(*key)
            self._programs[K, key] = (
                MeshProgram(step.shards, self._mesh.flat, torch.stack)
                if self._graph else
                StepProgram(step, self.device, group=K, graph=False))
        return self._programs[K, key]

    def _mesh_outputs(self, h, ins):
        """The batch's step over every shard as one program: its stacked
        blocks on the first device, fetched in one copy."""
        prog = self._program_for(1, h["key"])
        return [prog(ins)[0] if self._graph else prog([ins])[0]]

    def _blocks(self, h):
        """Packed rows are replicated (m_u was summed over the shards);
        the insertion and walk-tie records are each shard's, with global
        positions: concatenate them in shard order."""
        B = h["B"]
        outs, = self._fetch_shards(h)
        recs, trecs = zip(*(self._records(out, B) for out in outs))
        return outs[0][:B], np.concatenate(recs), np.concatenate(trecs)

    def final_pileup(self) -> np.ndarray:
        """Each shard's local rows added at its ``bases_seq``."""
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        gs = self.sdx.genome_size
        dev = np.zeros((gs, 6), np.uint32)
        for g, st in enumerate(self.states):
            b = int(self._plan.bases_seq[g])
            span = min(self._local_seq, gs - b)
            dc = st.dev_counts.cpu().numpy().view(np.uint32).reshape(-1, 6)
            dev[b:b + span] += dc[:span]
        dev = (dev & 0xFFFF).astype(np.uint16)
        return (host + dev).astype(np.uint16)
