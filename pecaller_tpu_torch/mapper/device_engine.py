"""Split mapping engine: the host seed, chain and decision scaffolding of
``MapperEngine`` with the Smith-Waterman scores (kernel K3), the
traceback and the pileup on a torch device.

Counterpart of ``pecaller_tpu/mapper/device_engine.py``.  The runner
takes it for genomes of 2^30 bases and more, where the fused engines'
int32 device coordinates end (``mapper/runner.py``).  Scores are exact
rationals x36 (int32); the decision layer consumes score / 36.0, whose
comparisons are tie-exact, so the results differ from the f64 host
oracle only where the DP has exact-score ties.

Device state: the (genome, 6) pileup counters as int16 carrying the
reference's wrapping uint16 bits (2 bytes a cell: 37 GB for a 3.1 Gb
genome), added to in place.  Window starts are int64 on the device, so
positions past 2^31 stay exact.  ``device_seeds`` moves the seed step
onto the device too (``device_seeds.build_seed_chain_fn``); past 2^30
bases it is off, as the device seed tables hold int32 positions.

A batch end is three device calls with host work between them: the seed
step (device seeds), K3's scores and the traceback.  The seed step and
the traceback (with its pileup add and insertion records) each run as
one ``StepProgram`` a shape key, the counterparts of the reference's
``@jax.jit seed_chain_impl`` and ``@jax.jit sw_traceback_scatter``; K3
is one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sw, sw_cuda
from .device_map2 import INS_CAP, fetch_async, fetched, to_device
from .engine import MAX_HITS, MapperEngine
from .host_prep import _bucket_b, _pad_to
from .program import StepProgram


class DeviceMapperEngine(MapperEngine):
    """``device`` defaults to the first CUDA device; a CPU device, named
    by the caller, runs the plain version of K3.

    ``graph``: the seed step of each (batch, segment) bucket and the
    traceback of each (lanes, N, M) bucket run as ``StepProgram``s, on a
    card CUDA graphs captured at the key's second call that share one
    graph pool (they replay one at a time on one stream, and each
    output is copied to the host before the next replay);
    ``graph=False`` runs them eagerly.  ``seed_index``: a
    ``DeviceSeedIndex`` of this index on ``device`` to use instead of
    building one (engines on one device may share it)."""

    def __init__(self, *args, device_seeds: bool = True, device="cuda",
                 graph: bool = True, seed_index=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self.dev_counts = torch.zeros((self.sdx.genome_size, 6),
                                      dtype=torch.int16, device=self.device)
        self.n_fallback = 0
        self._graph = graph
        self._pool = (torch.cuda.graph_pool_handle()
                      if graph and self.device.type == "cuda" else None)
        self._tb_programs = {}
        self._seed_fns = None
        self._pending_maps = None
        if self.sdx.genome_size >= 2 ** 30:
            # the device seed tables hold int32 positions, and past 2^30
            # the POS_PAD sentinel ordering breaks: exact host seeds
            device_seeds = False
        if device_seeds:
            from .device_seeds import DeviceSeedIndex, HIT_CAP
            self._dindex = (seed_index if seed_index is not None
                            else DeviceSeedIndex(self.index, self.device))
            self._seed_fns = {}
            self._hit_cap = HIT_CAP

    @property
    def programs(self) -> list:
        """Every StepProgram the engine has built: the seed steps', then
        the tracebacks'."""
        return ([p for fn in (self._seed_fns or {}).values()
                 for p in fn.programs.values()]
                + list(self._tb_programs.values()))

    # -- seeds on the device -----------------------------------------------
    def _seed_bucket_fn(self, s_needed: int):
        from .device_seeds import build_seed_chain_fn
        for b in (8, 12, 20):
            if s_needed <= b:
                break
        if b not in self._seed_fns:
            self._seed_fns[b] = build_seed_chain_fn(
                self._dindex, bisulfite=self.bisulfite, s_max=b,
                graph=self._graph, pool=self._pool)
        return self._seed_fns[b], b

    def _initial_map_dispatch(self, seqs, lens):
        from .seeds import segment_offsets
        B = seqs.shape[0]
        n_count = (seqs == ord("N")).sum(axis=1)
        skip = (n_count >= 1 + lens // 10).astype(np.int32)
        n_segs, offs = segment_offsets(lens)
        tc = n_segs - 1
        min_match0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        min_match0[over4] = np.minimum((4 * tc[over4]) // 5, 4)

        fn, b = self._seed_bucket_fn(int(n_segs.max()))
        Bp = _bucket_b(B)
        seqs_p = np.zeros((Bp, 304), dtype=np.uint8)
        seqs_p[:B, :seqs.shape[1]] = seqs

        def pad(a, fill=0):
            return np.concatenate(
                [a, np.full((Bp - B,) + a.shape[1:], fill, a.dtype)])
        pending = fn.dispatch(
            seqs_p, pad(lens.astype(np.int32), 13),
            pad(offs[:, :b].astype(np.int32)),
            pad(n_segs.astype(np.int32), 1),
            pad(min_match0.astype(np.int32), 1), pad(skip, 1))
        return fn, pending, seqs, lens, B

    def _initial_map_resolve(self, handle):
        from .seeds import revcomp_batch
        fn, pending, seqs, lens, B = handle
        h16, o16, or16, tot16, fb = fn.fetch(pending)
        tot = tot16[:B].copy()
        fb = fb[:B]
        hits = np.zeros((B, MAX_HITS), dtype=np.uint32)
        hits_off = np.zeros((B, MAX_HITS), dtype=np.int32)
        orient = np.zeros((B, MAX_HITS), dtype=np.int8)
        hits[:, :self._hit_cap] = h16[:B].astype(np.int64).astype(np.uint32)
        hits_off[:, :self._hit_cap] = o16[:B]
        orient[:, :self._hit_cap] = or16[:B]

        rev = revcomp_batch(seqs, lens)
        nfb = int(fb.sum())
        if nfb:
            self.n_fallback += nfb
            sel = np.nonzero(fb)[0]
            hh, ho, oo, tt, _ = MapperEngine._initial_map(
                self, np.ascontiguousarray(seqs[sel]), lens[sel])
            hits[sel] = hh
            hits_off[sel] = ho
            orient[sel] = oo
            tot[sel] = tt
        return hits, hits_off, orient, tot, rev

    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        # both ends' seed steps are enqueued before the first wait
        if self.paired and self._seed_fns is not None and seqs2 is not None:
            lens1 = lens1.astype(np.int64)
            lens2 = lens2.astype(np.int64)
            h1 = self._initial_map_dispatch(seqs1, lens1)
            h2 = self._initial_map_dispatch(seqs2, lens2)
            self._pending_maps = [self._initial_map_resolve(h1),
                                  self._initial_map_resolve(h2)]
        else:
            self._pending_maps = None
        return super().map_batch(seqs1, lens1, seqs2, lens2,
                                 read_nos=read_nos)

    def _initial_map(self, seqs, lens):
        if self._pending_maps:
            return self._pending_maps.pop(0)
        if self._seed_fns is None:
            return MapperEngine._initial_map(self, seqs, lens)
        return self._initial_map_resolve(self._initial_map_dispatch(
            seqs, lens))

    # -- SW and traceback on the device ------------------------------------
    @staticmethod
    def _bucket(n, m):
        """Widths padded to multiples of 64 (the reference's compile
        buckets; the port keeps them so that both see the same lanes)."""
        return _pad_to(max(n, 8), 64), _pad_to(max(m, 8), 64)

    @staticmethod
    def _lanes(refs, blens, reads, rlens, N, M, *extra):
        """Host arrays padded to Hp = _bucket_b(H) lanes of widths (N, M)
        (reads padded with 1, which no reference pad byte matches)."""
        H = len(blens)
        Hp = _bucket_b(H)
        refs_p = np.zeros((Hp, N), dtype=np.uint8)
        refs_p[:H, :refs.shape[1]] = refs
        reads_p = np.ones((Hp, M), dtype=np.uint8)
        reads_p[:H, :min(M, reads.shape[1])] = reads[:, :M]
        cols = [refs_p, reads_p]
        for a, fill, dt in ((blens, 0, np.int32), (rlens, 1, np.int32),
                            *extra):
            p = np.full(Hp, fill, dt)
            p[:H] = a
            cols.append(p)
        return cols

    def _sw_scores(self, refs, blens, reads, rlens):
        H = refs.shape[0]
        if H == 0:
            return (np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        N, M = self._bucket(refs.shape[1], int(rlens.max()))
        refs_d, reads_d, blens_d, rlens_d = (
            to_device(x, self.device)
            for x in self._lanes(refs, blens, reads, rlens, N, M))
        packed = torch.stack(sw_cuda.sw_align(
            refs_d, blens_d, reads_d, rlens_d, bisulfite=self.bisulfite,
            n_rows=N)).cpu().numpy()
        return (packed[0, :H].astype(np.float64) / 36.0,
                packed[1, :H].astype(np.int32),
                packed[2, :H].astype(np.int32))

    def _backtrack_end(self, seqs, lens, rev, orient, flat, best, use, end,
                       read_nos):
        B = seqs.shape[0]
        m = np.zeros(B, dtype=np.uint32)
        winners = np.nonzero(use == 1)[0]
        if len(winners) == 0:
            return m
        flat_idx = np.full((B, MAX_HITS), -1, dtype=np.int64)
        flat_idx[flat["rid"], flat["hid"]] = np.arange(len(flat["rid"]))
        sel = flat_idx[winners, best[winners]]
        starts = flat["starts"][sel]
        blens = flat["blens"][sel].astype(np.int32)
        out_k = np.asarray(flat["out_k"][sel], dtype=np.int32)
        out_i = np.asarray(flat["out_i"][sel], dtype=np.int32)
        ors = orient[winners, best[winners]]
        oriented = np.where(ors[:, None] == 1, rev[winners], seqs[winners])
        rlens = lens[winners].astype(np.int32)
        width = int(blens.max())
        refs = self._gather_refs(starts, blens, width)
        m[winners] = (starts + out_i + 1).astype(np.uint32)

        N, M = self._bucket(width, int(rlens.max()))
        # padded lanes walk zero steps (bt_i 0)
        lanes = self._lanes(refs, blens, oriented, rlens, N, M,
                            (out_k, 0, np.int32), (out_i, 0, np.int32),
                            (starts, 0, np.int64))
        rec = self._traceback(lanes)
        n_ins = int(rec[-1, 0])
        if n_ins > rec.shape[0] - 1:
            raise RuntimeError("insertion record cap exceeded; raise "
                               "device_map2.INS_CAP")
        for b, evp, js, ln in rec[:n_ins]:
            if b < 0 or b >= len(winners):
                continue
            w = winners[b]
            rn = int(read_nos[w]) if read_nos is not None else int(w)
            self.ins_records.append((
                (self._order_counter + rn, end), int(starts[b] + evp),
                oriented[b, js:js + ln].tobytes().decode()))
        return m

    def _traceback(self, lanes) -> np.ndarray:
        """The traceback of one end's padded winner lanes (refs, reads,
        blens, rlens, bt_k, bt_i, window starts: host arrays), its events
        added to ``dev_counts`` in place, as the program of its (Hp, N,
        M) key; returns the insertion records, on the host."""
        key = (len(lanes[2]), lanes[0].shape[1], lanes[1].shape[1])
        if key not in self._tb_programs:
            counts, n_rows = self.dev_counts, key[1]

            def step(refs, reads, blens, rlens, bt_k, bt_i, pos0):
                return sw.sw_traceback_scatter(
                    refs, blens, reads, rlens, bt_k, bt_i, pos0, counts,
                    bisulfite=self.bisulfite, n_rows=n_rows,
                    ins_cap=INS_CAP)[1]
            self._tb_programs[key] = StepProgram(
                step, self.device, graph=self._graph, pool=self._pool)
        return fetched(fetch_async(self._tb_programs[key]([lanes])[0],
                                   self.device))

    def final_pileup(self) -> np.ndarray:
        """Host slabs plus the device counters, mod 2^16."""
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        return host + self.dev_counts.cpu().numpy().view(np.uint16)

    def reset_group(self) -> None:
        super().reset_group()
        self.dev_counts.zero_()
