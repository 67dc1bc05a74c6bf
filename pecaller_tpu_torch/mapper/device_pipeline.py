"""Fused on-device mapping step (v1, exact-key seed tables), PyTorch.

Counterpart of ``pecaller_tpu/mapper/device_pipeline.py``: the same
integer program, computed bit for bit on the same state, on tensors of
an explicit device.  One call of the step maps one batch:

  seeds + chaining (``device_seeds.seed_chain_core``) -> slot compaction
  -> window fetch -> SW align on raw bytes (K3) -> pair / single-end
  decision -> winner compaction -> traceback (plain torch,
  ``ops/sw.py``) -> pileup add and insertion records.

The runner takes this engine where the nbr index and the quartered-key
index both refuse a genome under 2^30 bases (``mapper/runner.py``).

The JAX program's gathers clamp their indices and its ``mode="drop"``
scatters drop out-of-range rows; here every gather is clamped and every
dropped write goes to a dump row.  The pileup ``dev_counts`` is a flat
int32 tensor of genome x 6 counters updated in place (``index_add_``);
its low 16 bits are the reference's wrapping uint16 counters.  The
contig search runs a log-bounded number of steps, as the v2 step does:
it has converged by then, and the 80-step loop of the reference changes
nothing after convergence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import sw
from ..ops.sw_cuda import sw_align
from ..utils.log import stage
from .device_map2 import DecideLayer, fetch_async, fetched, windows
from .device_seeds import (HIT_CAP, DeviceSeedIndex, host_bits_rev,
                           seed_chain_core)
from .engine import MISALIGN_SLOP, MapperEngine
from .host_prep import (_bucket_b, _pad_to, contig_pad,
                        exact_score_threshold, segments_of)
from .program import StepProgram
from .seeds import revcomp_batch, segment_offsets

PAD_SCORE = -36          # -1.0 x36: the reference's dvector padding
INS_CAP = 2048
I32 = torch.int32
I64 = torch.int64


@dataclass
class DeviceStateV1:
    """Everything the v1 step reads besides the batch: the seed tables,
    the ASCII genome, contig starts and the flat pileup counters."""
    dindex: DeviceSeedIndex
    genome: torch.Tensor
    ist: torch.Tensor
    st_pad: torch.Tensor
    dev_counts: torch.Tensor


def carry_state_v1(ptab, keys, starts, hi_table, positions, genome, ist,
                   st_pad, dev_counts, device) -> DeviceStateV1:
    """Turn the reference package's v1 state (numpy arrays: its
    DeviceSeedIndex arrays, the genome, contig starts, the padded starts
    and the (genome, 6) uint16 pileup) into the port's tensors on
    ``device``.  Both packages then compute on identical state."""
    device = torch.device(device)
    dc = np.asarray(dev_counts).astype(np.int32).reshape(-1)
    return DeviceStateV1(
        DeviceSeedIndex.from_arrays(ptab, keys, starts, hi_table,
                                    positions, device),
        torch.from_numpy(np.array(genome, np.uint8)).to(device),
        torch.from_numpy(np.array(ist, np.int32)).to(device),
        torch.from_numpy(np.array(st_pad, np.int32)).to(device),
        torch.from_numpy(dc).to(device))


class FusedStep(DecideLayer):
    """One batch of the fused v1 mapping program for fixed shapes
    (``build_fused_step``, ``pecaller_tpu/mapper/device_pipeline.py``).

    ``step(state, *end1, *end2)`` takes per end the ten host-prepared
    arrays of ``FusedMapperEngine._prep_end`` as tensors (seqs, rev,
    bits_f, bits_r, lens, offsets, n_segs, min_match0, skip, thr; end 2
    only when paired) and returns (packed (B, 6) int32 = [m1, m2, code,
    orb1, orb2, fb], rec1, rec2 (ins_cap + 1, 4) int32 insertion records
    [read, gpos, jstart, len] with the count in the tail row; rec2 is
    rec1 single-end).  ``state.dev_counts`` is updated in place."""

    def __init__(self, dindex: DeviceSeedIndex, *, paired: bool,
                 bisulfite: bool, min_dist: int, max_dist: int,
                 n_contigs: int, genome_size: int, B: int, M: int, N: int,
                 s_max: int, ins_cap: int = INS_CAP):
        self.dindex = dindex
        self.dev = dindex.device
        self.paired = paired
        self.bisulfite = bisulfite
        self.min_dist, self.max_dist = min_dist, max_dist
        self.n_contigs = n_contigs
        self.genome_size = genome_size
        self.B, self.M, self.N, self.s_max = B, M, N, s_max
        self.ins_cap = ins_cap
        self.H_CAP = 2 * B
        self.n_steps = max(1, int(np.ceil(np.log2(
            max(dindex.max_subrange, 2)))) + 1)
        self.k_cap = dindex.compact_cap(B * 2 * s_max * 49)
        self.chrom_steps = max(3, int(np.ceil(np.log2(
            max(n_contigs, 2)))) + 3)

    def seed_end(self, bits_f, bits_r, offs, nsegs, mm0, skip):
        with stage("v1.seed_end"):
            d = self.dindex
            return seed_chain_core(
                d.ptab, d.keys, d.starts, d.hi_table, d.positions, bits_f,
                bits_r, offs, nsegs, mm0, skip, s_max=self.s_max,
                n_steps=self.n_steps, n_keys=d.n_keys, k_cap=self.k_cap)

    def hit_overflow(self, tot):
        """Reads whose hits spill past H_CAP in rid-major compaction."""
        return torch.cumsum(tot.to(I64), 0) > self.H_CAP

    def fetch_refs(self, genome, start, blen):
        """Window bytes (n, N) from seq-coordinate starts; 0 past blen."""
        col = self._ar(self.N)[None, :]
        gidx = (start.to(I64)[:, None] + col).clamp(0, self.genome_size - 1)
        return torch.where(col < blen[:, None], genome[gidx], 0).to(
            torch.uint8)

    def compact_and_score(self, state, seqs, rev, lens, hits, hits_off,
                          orient, tot):
        """Compact valid hits across the batch and SW-score them (K3).
        Returns per-slot arrays and the (B, CAP) score matrix padded with
        PAD_SCORE (the reference pads its dvectors with -1.0)."""
        with stage("v1.compact_and_score"):
            B, M, H_CAP, CAP = self.B, self.M, self.H_CAP, HIT_CAP
            idx = self._ar(CAP)[None, :]
            flat_valid = (idx < tot[:, None]).reshape(-1)
            slot = torch.cumsum(flat_valid.to(I64), 0) - 1
            tgt = torch.where(flat_valid, slot.clamp(max=H_CAP - 1), H_CAP)
            flat = self._ar(B * CAP)
            # the step drops reads past H_CAP first: the valid slots are
            # distinct, row H_CAP is the dump
            rid_s = torch.zeros(H_CAP + 1, dtype=I64, device=self.dev)
            rid_s[tgt] = torch.div(flat, CAP, rounding_mode="floor")
            hid_s = torch.zeros(H_CAP + 1, dtype=I64, device=self.dev)
            hid_s[tgt] = flat % CAP
            rid_s, hid_s = rid_s[:H_CAP], hid_s[:H_CAP]
            n_slots = flat_valid.sum().clamp(max=H_CAP)
            slot_ok = self._ar(H_CAP) < n_slots

            spots_s = torch.clamp(hits[rid_s, hid_s] - hits_off[rid_s, hid_s],
                                  min=0).to(I64)
            lens_s = lens[rid_s].to(I64)
            start_s, blen_s = windows(state.st_pad, state.ist, spots_s, lens_s,
                                      self.n_contigs, self.chrom_steps)
            blen_m = torch.where(slot_ok, blen_s, 0).to(I32)
            refs = self.fetch_refs(state.genome, start_s, blen_m)
            ors_s = orient[rid_s, hid_s]
            reads_s = torch.where((ors_s == 1)[:, None], rev[rid_s],
                                  seqs[rid_s])[:, :M].contiguous()
            rlens_m = torch.where(slot_ok, lens_s, 1).to(I32)

            score, bk, bi = sw_align(refs, blen_m, reads_s, rlens_m,
                                     bisulfite=self.bisulfite, n_rows=self.N)

            # (B, CAP) table: hit -> slot; sentinel H_CAP for absent
            rid_store = torch.where(slot_ok, rid_s, B)
            slot_tab = torch.full((B + 1, CAP), H_CAP, dtype=I64,
                                  device=self.dev)
            slot_tab[rid_store, hid_s] = self._ar(H_CAP)      # row B: dump
            slot_tab = slot_tab[:B]
            pad = torch.full((1,), PAD_SCORE, dtype=I32, device=self.dev)
            smax = torch.cat([score, pad])[slot_tab]
            zero = torch.zeros(1, dtype=I64, device=self.dev)
            pos_tab = torch.cat([spots_s, zero])[slot_tab]
            return dict(slot_tab=slot_tab, smax=smax, pos=pos_tab,
                        start_s=start_s, blen_s=blen_m, bk=bk, bi=bi)

    def backtrack(self, state, seqs, rev, lens, info, orient, best, use):
        """Winner traceback, pileup add and insertion compaction.
        Returns (m (B,), rec (ins_cap + 1, 4))."""
        with stage("v1.backtrack"):
            B, M, N, H_CAP = self.B, self.M, self.N, self.H_CAP
            wmask = use == 1
            wslot = torch.cumsum(wmask.to(I64), 0) - 1
            n_win = wmask.sum()
            rid_w = torch.zeros(B + 1, dtype=I64, device=self.dev)
            rid_w[torch.where(wmask, wslot, B)] = self._ar(B)  # row B: dump
            valid_w = self._ar(B) < n_win
            ridc = torch.where(valid_w, rid_w[:B], 0)
            best_c = best.to(I64)[ridc]
            hsel = info["slot_tab"][ridc, best_c].clamp(0, H_CAP - 1)
            start_w = info["start_s"][hsel]
            blen_w = torch.where(valid_w, info["blen_s"][hsel], 0).to(I32)
            # invalid slots must not walk: bt_i = 0 kills the traceback loop
            k_w = torch.where(valid_w, info["bk"][hsel], 0).to(I32)
            i_w = torch.where(valid_w, info["bi"][hsel], 0).to(I32)
            ors_w = orient[ridc, best_c]
            reads_w = torch.where((ors_w == 1)[:, None], rev[ridc],
                                  seqs[ridc])[:, :M].contiguous()
            rlens_w = torch.where(valid_w, lens[ridc].to(I32), 1).to(I32)
            refs_w = self.fetch_refs(state.genome, start_w, blen_w)
            with stage("v1.traceback"):
                ev_pos, ev_kind, ins_j, ins_len = sw.sw_traceback_device(
                    refs_w, blen_w, reads_w, rlens_w, k_w, i_w,
                    bisulfite=self.bisulfite, n_rows=N)
            ev_abs = torch.where(ev_pos >= 0,
                                 ev_pos.to(I64) + start_w.to(I64)[:, None], -1)

            # pileup add; rows past the genome are dropped
            gs = self.genome_size
            flat_pos = ev_abs.reshape(-1)
            flat_kind = ev_kind.reshape(-1).to(I64)
            ok = (flat_pos >= 0) & (flat_pos < gs) & (flat_kind != sw.EV_NONE)
            dc = state.dev_counts
            dc.index_add_(0, torch.where(ok, flat_pos * 6 + flat_kind, 0),
                          ok.to(I32))
            vrec = (ins_j >= 0).reshape(-1)
            iok = (flat_pos >= 0) & (flat_pos < gs) & vrec
            dc.index_add_(0, torch.where(iok, flat_pos * 6 + 5, 0),
                          iok.to(I32))

            # compact insertion records: [read, gpos, jstart, len]
            T = ev_pos.shape[1]
            order = torch.argsort((~vrec).to(torch.uint8),
                                  stable=True)[:self.ins_cap]
            bb = torch.div(order, T, rounding_mode="floor")
            tt = order % T
            sel = vrec[order]
            rec = torch.stack([
                torch.where(sel, ridc[bb], -1),
                torch.where(sel, ev_abs[bb, tt], -1),
                torch.where(sel, ins_j[bb, tt].to(I64), -1),
                torch.where(sel, ins_len[bb, tt].to(I64), 0)], dim=1).to(I32)
            tail = torch.zeros((1, 4), dtype=I32, device=self.dev)
            tail[0, 0] = vrec.sum().to(I32)
            rec = torch.cat([rec, tail])
            m_w = torch.where(valid_w, start_w + i_w + 1, 0).to(I32)
            m = torch.zeros(B + 1, dtype=I32, device=self.dev)
            m[torch.where(valid_w, ridc, B)] = m_w            # row B: dump
            return m[:B], rec

    def __call__(self, state: DeviceStateV1, *ends):
        B = self.B
        e1 = ends[:10]
        seqs1, rev1, bits1f, bits1r, lens1, offs1, nsegs1, mm01, skip1, \
            thr1 = e1
        h1, ho1, or1, tot1, fb1 = self.seed_end(bits1f, bits1r, offs1,
                                                nsegs1, mm01, skip1)
        zB = torch.zeros(B, dtype=I32, device=self.dev)
        if not self.paired:
            fb = fb1 | self.hit_overflow(tot1)
            tot1 = torch.where(fb, 0, tot1)
            i1 = self.compact_and_score(state, seqs1, rev1, lens1, h1, ho1,
                                        or1, tot1)
            valid = self._ar(HIT_CAP)[None, :] < tot1[:, None]
            code, b1, u1, _ = self.decide_single(i1["smax"], valid, thr1,
                                                 torch.zeros_like(i1["pos"]))
            m1, rec1 = self.backtrack(state, seqs1, rev1, lens1, i1, or1,
                                      b1, u1)
            orb1 = torch.gather(or1, 1, b1.to(I64)[:, None])[:, 0]
            packed = torch.stack([m1, zB, code.to(I32), orb1.to(I32), zB,
                                  fb.to(I32)], dim=1)
            return packed, rec1, rec1
        seqs2, rev2, bits2f, bits2r, lens2, offs2, nsegs2, mm02, skip2, \
            thr2 = ends[10:20]
        h2, ho2, or2, tot2, fb2 = self.seed_end(bits2f, bits2r, offs2,
                                                nsegs2, mm02, skip2)
        fb = (fb1 | fb2 | self.hit_overflow(tot1)
              | self.hit_overflow(tot2))
        tot1 = torch.where(fb, 0, tot1)
        tot2 = torch.where(fb, 0, tot2)
        i1 = self.compact_and_score(state, seqs1, rev1, lens1, h1, ho1, or1,
                                    tot1)
        i2 = self.compact_and_score(state, seqs2, rev2, lens2, h2, ho2, or2,
                                    tot2)
        idx = self._ar(HIT_CAP)[None, :]
        nohash = torch.zeros_like(i1["pos"])
        code, b1, b2, u1, u2, _ = self.decide_pair(
            dict(smax=i1["smax"], pos=i1["pos"], valid=idx < tot1[:, None],
                 orient=or1, hash=nohash),
            dict(smax=i2["smax"], pos=i2["pos"], valid=idx < tot2[:, None],
                 orient=or2, hash=nohash), thr1, thr2)
        m1, rec1 = self.backtrack(state, seqs1, rev1, lens1, i1, or1, b1, u1)
        m2, rec2 = self.backtrack(state, seqs2, rev2, lens2, i2, or2, b2, u2)
        orb1 = torch.gather(or1, 1, b1.to(I64)[:, None])[:, 0]
        orb2 = torch.gather(or2, 1, b2.to(I64)[:, None])[:, 0]
        packed = torch.stack([m1, m2, code, orb1.to(I32), orb2.to(I32),
                              fb.to(I32)], dim=1)
        return packed, rec1, rec2


class FusedMapperEngine(MapperEngine):
    """Fused mapping engine v1 on one torch device.

    Host work per batch: pad and prepare the read arrays, launch the
    fused step, and (after the pipelining delay of the runner) fetch the
    packed result and the insertion records in one copy.  Reads the step
    flags as fallbacks are re-mapped by the exact host engine
    (``MapperEngine``).  ``device`` defaults to the first CUDA device; a
    CPU device, named by the caller, runs the plain version of K3.

    Each shape key's step, with the concatenation of its outputs into
    the one block fetched, runs as a ``StepProgram``: on a card a CUDA
    graph captured at the key's second batch; ``graph=False`` runs the
    eager step.  The step's stages (``v1.seed_end``,
    ``v1.compact_and_score``, ``v1.backtrack`` and within it
    ``v1.traceback``) are ``utils.log.stage`` ranges."""

    def __init__(self, *args, device="cuda", ins_cap: int = INS_CAP,
                 graph: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._graph = graph
        gs = self.sdx.genome_size
        if gs >= 2 ** 30:
            raise ValueError("fused device engine requires genome < 2^30 "
                             "bases (int32 device coordinates)")
        self.ins_cap = ins_cap
        ist = self._istarts.astype(np.int32)
        self.state = DeviceStateV1(
            DeviceSeedIndex(self.index, self.device),
            torch.from_numpy(np.array(self.genome, np.uint8)).to(
                self.device),
            torch.from_numpy(ist).to(self.device),
            torch.from_numpy(contig_pad(ist, self.sdx.n_contigs)).to(
                self.device),
            torch.zeros(gs * 6, dtype=I32, device=self.device))
        self._programs = {}
        self.n_fallback = 0

    def _program_for(self, B, M, N, s_max):
        """The program of shape (B, M, N, s_max): the step, then its
        packed rows and each end's records (padded to 6 columns) as one
        block, so that a batch takes one copy to the host."""
        key = (B, M, N, s_max)
        if key not in self._programs:
            step = FusedStep(
                self.state.dindex, paired=self.paired,
                bisulfite=self.bisulfite, min_dist=self.min_dist,
                max_dist=self.max_dist, n_contigs=self.sdx.n_contigs,
                genome_size=self.sdx.genome_size, B=B, M=M, N=N,
                s_max=s_max, ins_cap=self.ins_cap)
            state = self.state

            def block(*ins):
                packed, rec1, rec2 = step(state, *ins)
                return torch.cat([packed, F.pad(rec1, (0, 2)),
                                  F.pad(rec2, (0, 2))])
            self._programs[key] = StepProgram(block, self.device,
                                              graph=self._graph)
        return self._programs[key]

    @property
    def programs(self) -> list:
        """Every StepProgram the engine has built."""
        return list(self._programs.values())

    def _prep_end(self, seqs, lens, B, M, s_max):
        n = seqs.shape[0]
        seqs_p = np.zeros((B, M), dtype=np.uint8)
        seqs_p[:n, :min(M, seqs.shape[1])] = seqs[:, :M]
        lens_p = np.full(B, 16, np.int32)
        lens_p[:n] = lens
        rev, bits_f, bits_r = host_bits_rev(seqs_p, lens_p,
                                            bisulfite=self.bisulfite)
        n_count = (seqs == ord("N")).sum(axis=1)
        skip = np.ones(B, np.int32)
        skip[:n] = (n_count >= 1 + lens // 10).astype(np.int32)
        n_segs, offs = segment_offsets(lens_p.astype(np.int64))
        tc = n_segs - 1
        mm0 = np.minimum(np.maximum(1, tc), 4)
        over4 = tc > 4
        mm0[over4] = np.minimum((4 * tc[over4]) // 5, 4)
        thr = exact_score_threshold(lens_p, self.min_align)
        return (seqs_p, rev, bits_f, bits_r, lens_p,
                offs[:, :s_max].astype(np.int32),
                n_segs.astype(np.int32), mm0.astype(np.int32), skip, thr)

    @staticmethod
    def _seg_bucket(s_needed):
        for b in (8, 12, 20):
            if s_needed <= b:
                return b
        return 20

    def map_batch_async(self, seqs1, lens1, seqs2=None, lens2=None,
                        read_nos=None):
        lens1 = np.asarray(lens1, np.int64)
        B = _bucket_b(seqs1.shape[0])
        maxlen = int(lens1.max()) if len(lens1) else 32
        if self.paired:
            lens2 = np.asarray(lens2, np.int64)
            maxlen = max(maxlen, int(lens2.max()) if len(lens2) else 32)
        M = _pad_to(max(maxlen, 32), 16)
        N = _pad_to(M + 2 * MISALIGN_SLOP + 1, 32)
        s_max = self._seg_bucket(segments_of(maxlen))
        program = self._program_for(B, M, N, s_max)
        ins = list(self._prep_end(seqs1, lens1, B, M, s_max))
        if self.paired:
            ins += self._prep_end(seqs2, lens2, B, M, s_max)
        return dict(seqs1=seqs1, lens1=lens1, seqs2=seqs2, lens2=lens2,
                    read_nos=read_nos, n=seqs1.shape[0], B=B,
                    **fetch_async(program([ins])[0], self.device))

    def resolve(self, h):
        out = fetched(h)
        n, B = h["n"], h["B"]
        nr = self.ins_cap + 1
        m1 = out[:n, 0].astype(np.uint32)
        m2 = out[:n, 1].astype(np.uint32)
        code = out[:n, 2].astype(np.int32)
        orb1 = out[:n, 3]
        orb2 = out[:n, 4]
        fb = out[:n, 5].astype(bool)
        read_nos = h["read_nos"]
        seqs1, lens1 = h["seqs1"], h["lens1"]
        seqs2, lens2 = h["seqs2"], h["lens2"]

        # insertion records (device winners)
        for end, rec, seqs, lens, orb in (
                (0, out[B:B + nr, :4], seqs1, lens1, orb1),
                (1, out[B + nr:, :4], seqs2, lens2, orb2)):
            if end == 1 and not self.paired:
                break
            n_ins = int(rec[-1, 0])
            if n_ins > rec.shape[0] - 1:
                raise RuntimeError("insertion record cap exceeded; raise "
                                   "the engine's ins_cap")
            if n_ins == 0:
                continue
            rev = revcomp_batch(seqs, lens)
            for rid, gpos, js, ln in rec[:n_ins]:
                if rid < 0 or rid >= n or fb[rid]:
                    continue
                src = rev[rid] if orb[rid] == 1 else seqs[rid]
                sstr = src[js:js + ln].tobytes().decode()
                rn = int(read_nos[rid]) if read_nos is not None else int(rid)
                self.ins_records.append(
                    ((self._order_counter + rn, end), int(gpos), sstr))

        # stats for device-handled reads
        keep = ~fb
        self._accumulate_stats(
            code[keep], m1[keep], m2[keep], lens1[keep],
            lens2[keep] if self.paired else None)

        # fallback reads: exact host re-map (stats/pileup/ins included)
        if fb.any():
            idx = np.nonzero(fb)[0]
            self.n_fallback += len(idx)
            nos = (read_nos[idx] if read_nos is not None
                   else idx.astype(np.int64))
            fm1, fm2, fcode = MapperEngine.map_batch(
                self, np.ascontiguousarray(seqs1[idx]), lens1[idx],
                np.ascontiguousarray(seqs2[idx]) if self.paired else None,
                lens2[idx] if self.paired else None, read_nos=nos)
            m1[idx] = fm1
            m2[idx] = fm2
            code[idx] = fcode
        return m1, m2, code

    def map_batch(self, seqs1, lens1, seqs2=None, lens2=None,
                  read_nos=None):
        return self.resolve(self.map_batch_async(
            seqs1, lens1, seqs2, lens2, read_nos=read_nos))

    def final_pileup(self) -> np.ndarray:
        host = self.pileup.sum(axis=0, dtype=np.uint16)
        dc = self.state.dev_counts.cpu().numpy().reshape(-1, 6)
        return (host + (dc & 0xFFFF).astype(np.uint16)).astype(np.uint16)

    def reset_group(self) -> None:
        super().reset_group()
        self.state.dev_counts.zero_()
