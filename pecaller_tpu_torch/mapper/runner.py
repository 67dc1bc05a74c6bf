"""File-level mapper orchestration and output writers.

Reproduces the reference pemapper's artifact set byte-for-byte (after
decompression): <out>.pileup.gz, <out>.indel.txt.gz, <out>.summary.txt and
per-fastq .mfile position dumps (pemapper.c:374-393, 775-781, 788-898).

Counterpart of ``pecaller_tpu/mapper/runner.py``.  ``run_mapper`` picks
the engine: by default the one ``device_route`` names for the genome,
on the card (the JAX runner maps on the host unless asked for its
device path); the exact host engine only with ``device=False``.
``map_files`` runs the batch loop and the writers for a given engine.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..formats.fastq import FastqBatcher
from ..formats.index_files import load_index
from ..formats.sdx import read_sdx, read_seq, find_chrom_mapper
from ..index.nbr import load_nbr_index
from ..index.quarter import load_quarter_index
from ..utils.log import event, get_logger, span, spans, spans_since
from .device_engine import DeviceMapperEngine
from .device_map2 import FusedMapperEngine2
from .device_pipeline import FusedMapperEngine
from .engine import MapperEngine
from .host_prep import _bucket_b

_log = get_logger("mapper")

MATE_NAMES_PAIRED = [
    "Unique Mate-Paired", "Unique Mate-Paired with slip", "Unique Single End",
    "Unique Mis-size", "Non-Unique Mate-Paired", "Non-Unique Mis-size",
    "Fragment Mismatch", "Non-unique with no map", "Neither Map"]
MATE_NAMES_SINGLE = [
    "Not Used", "Not Used", "Unique Mapping", "Not Used", "Not Used",
    "Not Used", "Not Used", "Non-Unique Mapping, discarded",
    "No mapping reaches threshold"]


@dataclass
class MapperConfig:
    out_base: str
    sdx_path: str
    paired: bool
    files1: list
    files2: list = field(default_factory=list)
    max_dist: int = 0
    min_dist: int = 0
    bisulfite: bool = False
    min_align: float = 0.9
    max_reads: int = 2 * 10**9
    nthreads: int = 2
    batch_size: int = 20000
    # True: the device route (``device_route``) on ``mapping_devices``;
    # False: the exact host engine (f64 oracle) on the CPU
    device: bool = True
    # pemapper_tsw extensions (pemapper_tsw.c): fixed trimming applied to
    # every read, and optional per-file output-group basenames that flush
    # and reset the pileup between groups (dump_output :848-962)
    trim_start: int = 0
    trim_end: int = 0
    out_names: list = field(default_factory=list)
    # batch-granular resumability (SURVEY §5.4): snapshot accumulated
    # pileup + stats after each completed fastq (pair); restart skips them
    checkpoint: bool = False
    # device-mesh scale-out for the v2 fused engine: None = one shard a
    # device of ``mapping_devices``, as many as divide every padded batch
    # (``default_shards``; 1 leaves the single-device step); reads shard
    # over the mesh, each shard accumulating a pileup partial (the
    # reference's per-directory SGE fan-out, map_directory_array.pl:101)
    mesh_shards: int | None = None
    # torch device of the device route; None: every visible CUDA device
    torch_device: str | None = None


def _strip_sdx(path: str) -> str:
    if ".sdx" in path:
        return path[:path.rfind(".")]
    return path


SPLIT_GENOME = 2 ** 30     # int32 device coordinates end here


def device_route(genome_size: int, nbr_index=None, quarter_index=None):
    """The device engine the JAX runner picks
    (``pecaller_tpu/mapper/runner.py:80-117``) for a genome of
    ``genome_size`` bases, given the two seed-index loaders (each
    returns its index or raises ValueError where it refuses the genome;
    neither is called past ``SPLIT_GENOME``).  Returns (route, index):
    ("split", None) for the split engine (host seeds, SW and traceback
    on the device) at 2^30 bases and more; ("nbr", NbrIndex) and
    ("quarter", QuarterIndex) for the fused v2 engine on that index;
    ("v1", None) for the fused v1 engine where both indexes refuse.
    The loaders' time is the span ``engine.seed_index``."""
    if genome_size >= SPLIT_GENOME:
        return "split", None
    with span("engine.seed_index"):
        try:
            return "nbr", nbr_index()
        except ValueError:
            pass
        try:
            return "quarter", quarter_index()
        except ValueError:
            return "v1", None


def default_shards(n_devices: int) -> int:
    """Shards of the default reads mesh over ``n_devices`` devices: the
    most, up to one a device, that divide every batch.  The v2 engine
    pads a batch of any size to a power of two of at least
    ``_bucket_b(1)`` pairs (512), so a count that divides that divides
    every batch the CLI's ``--batch-size`` can give, a tail included."""
    n = max(1, n_devices)
    while _bucket_b(1) % n:
        n -= 1
    return n


def device_mesh(cfg: MapperConfig, devices: list):
    """The reads-axis mesh of ``cfg.mesh_shards`` shards on ``devices``
    (None: ``default_shards``, one shard a device where they divide
    every batch), or None for one shard."""
    n_sh = cfg.mesh_shards
    if n_sh is None:
        n_sh = default_shards(len(devices))
        if n_sh < len(devices):
            event(_log, "engine", mesh_shards=n_sh, devices=len(devices),
                  reason=f"{len(devices)} shards do not divide a batch "
                         f"of {_bucket_b(1)} pairs")
    if n_sh <= 1:
        return None
    from ..parallel.mesh import make_mesh
    return make_mesh(n_sh, 1, devices)


def build_device_engine(cfg: MapperConfig, sdx, genome, index, base,
                        devices):
    """The engine of ``device_route`` for this genome on ``devices`` (a
    device or a list): the v2 engine (nbr or quarter) over the reads-axis
    mesh of ``device_mesh``; the v1 and split engines on the first
    device, as the reference's runner gives them no mesh."""
    devices = list(devices) if isinstance(devices, (list, tuple)) \
        else [devices]
    kw = dict(bisulfite=cfg.bisulfite, min_align=cfg.min_align,
              min_dist=cfg.min_dist, max_dist=cfg.max_dist,
              paired=cfg.paired, nthreads=cfg.nthreads, device=devices[0])
    route, idx = device_route(
        sdx.genome_size, lambda: load_nbr_index(base, index),
        lambda: load_quarter_index(base, index))
    event(_log, "engine", route=route)
    if route == "split":
        return DeviceMapperEngine(sdx, genome, index, **kw)
    if route == "v1":
        return FusedMapperEngine(sdx, genome, index, **kw)
    return FusedMapperEngine2(sdx, genome, index, **{route: idx},
                              mesh=device_mesh(cfg, devices), **kw)


def mapping_devices(cfg: MapperConfig, device=None) -> list:
    """The torch devices of the device route: ``device`` (a device or a
    list), else ``cfg.torch_device``, else every visible CUDA device.
    Raises where none exists (pass ``device="cpu"`` for the CPU); never
    falls back to the CPU."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(cfg.torch_device if device is None else device)
    if device is None and cfg.torch_device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def run_mapper(cfg: MapperConfig, device=None) -> MapperEngine:
    """Map every fastq (pair) of ``cfg`` and write the artifacts.  With
    ``cfg.device`` (the default) the engine of ``device_route`` runs on
    ``mapping_devices``: the v2 engine over a reads-axis mesh of
    ``cfg.mesh_shards`` shards (None: ``default_shards``) where there is
    more than one device; without a CUDA device (and no CPU asked for)
    it raises.  The exact host engine maps only with ``cfg.device``
    False."""
    devices = mapping_devices(cfg, device) if cfg.device else None
    sdx = read_sdx(cfg.sdx_path)
    base = _strip_sdx(cfg.sdx_path)
    genome = read_seq(base + ".seq", sdx.genome_size)
    index = load_index(base)
    if cfg.device:
        eng = build_device_engine(cfg, sdx, genome, index, base, devices)
    else:
        eng = MapperEngine(sdx, genome, index, bisulfite=cfg.bisulfite,
                           min_align=cfg.min_align, min_dist=cfg.min_dist,
                           max_dist=cfg.max_dist, paired=cfg.paired,
                           nthreads=cfg.nthreads)
    return map_files(cfg, eng, sdx, genome)


def map_files(cfg: MapperConfig, eng: MapperEngine, sdx, genome):
    """The batch loop over ``cfg``'s fastq files with ``eng``, the .mfile
    dumps, the checkpoints and the output writers.  Ends with one
    ``spans`` event: the batches, and the count and ms a batch of each
    ``engine.*`` span of this call, with the writers' seconds."""
    before = spans()
    n_batches = 0
    tot_pairs = 0
    order_base = 0
    cur_base = cfg.out_base
    start_iter = 0
    ckpt_path = cfg.out_base + ".ckpt.npz"
    if cfg.checkpoint and os.path.exists(ckpt_path):
        start_iter, tot_pairs, order_base = _load_ckpt(ckpt_path, eng)
        event(_log, "resume", from_file=start_iter)
    for it in range(start_iter, len(cfg.files1)):
        new_name = cfg.out_names[it] if it < len(cfg.out_names) and \
            cfg.out_names[it] else None
        if new_name is not None and new_name != cur_base and it > 0:
            write_outputs(cfg, eng, sdx, genome, tot_pairs,
                          out_base=cur_base)
            eng.reset_group()
            tot_pairs = 0
        if new_name is not None:
            cur_base = new_name
        f1 = cfg.files1[it]
        f2 = cfg.files2[it] if cfg.paired else None
        batcher = FastqBatcher(f1, f2, batch_size=cfg.batch_size,
                               max_reads=cfg.max_reads,
                               trim_start=cfg.trim_start,
                               trim_end=cfg.trim_end)
        eng._order_counter = order_base
        maps1_parts, maps2_parts = [], []
        if hasattr(eng, "map_batch_async"):
            # batches in flight: the device maps the next (possibly
            # grouped) program while the host resolves the oldest batch
            depth = 2 * getattr(eng, "_group_k", 1) + 1
            pend = []
            for s1, l1, s2, l2, nos in batcher.batches():
                n_batches += 1
                pend.append(eng.map_batch_async(s1, l1, s2, l2,
                                                read_nos=nos))
                if len(pend) >= depth:
                    m1, m2, _ = eng.resolve(pend.pop(0))
                    maps1_parts.append(m1)
                    maps2_parts.append(m2)
            while pend:
                m1, m2, _ = eng.resolve(pend.pop(0))
                maps1_parts.append(m1)
                maps2_parts.append(m2)
        else:
            for s1, l1, s2, l2, nos in batcher.batches():
                n_batches += 1
                m1, m2, _ = eng.map_batch(s1, l1, s2, l2, read_nos=nos)
                maps1_parts.append(m1)
                maps2_parts.append(m2)
        n_rec = batcher.total_records
        maps1 = (np.concatenate(maps1_parts) if maps1_parts
                 else np.zeros(0, np.uint32))
        maps1.astype("<u4").tofile(f1 + ".mfile")
        if cfg.paired:
            maps2 = (np.concatenate(maps2_parts) if maps2_parts
                     else np.zeros(0, np.uint32))
            maps2.astype("<u4").tofile(f2 + ".mfile")
        tot_pairs += n_rec
        order_base += n_rec
        event(_log, "file_done", file=f1, records=n_rec)
        if cfg.checkpoint:
            _save_ckpt(ckpt_path, eng, it + 1, tot_pairs, order_base)
    with span("run.write_outputs"):
        write_outputs(cfg, eng, sdx, genome, tot_pairs, out_base=cur_base)
    _spans_event(eng, n_batches, spans_since(before))
    if cfg.checkpoint and os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    return eng


def _spans_event(eng, n: int, done: dict) -> None:
    """The host's cost a batch over the ``n`` batches by ``engine.*``
    span (on a mesh ``engine.enqueue.dispatch``: staging and enqueuing
    the shards; ``engine.resolve.wait``: waiting for their results), as
    ``name=[count, ms a batch]``.  Only the v2 engine and the genome
    mesh open these spans; the other engines log the batches alone."""
    per = {k: [c, round(1e3 * s / n, 3)] for k, (c, s) in done.items()
           if n and k.startswith("engine.")}
    event(_log, "spans", batches=n, n_shards=getattr(eng, "_n_sh", 1),
          write_outputs_s=round(done.get("run.write_outputs",
                                         (0, 0.0))[1], 4), **per)


def _save_ckpt(path, eng, next_iter, tot_pairs, order_base):
    import pickle
    counts = eng.final_pileup()
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp, counts=counts,
        mate_counts=eng.stats.mate_counts,
        scalars=np.asarray([next_iter, tot_pairs, order_base,
                            eng.stats.total_reads, eng.stats.total_bases,
                            eng.stats.total_dist, eng.stats.no_dists],
                           dtype=np.int64),
        ins=np.frombuffer(pickle.dumps(eng.ins_records), dtype=np.uint8))
    os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""), path)


def _load_ckpt(path, eng):
    import pickle
    z = np.load(path, allow_pickle=False)
    sc = z["scalars"]
    eng.pileup[:] = 0
    eng.pileup[0] = z["counts"]
    for st in getattr(eng, "states", None) or (
            [eng.state] if hasattr(eng, "state") else []):
        st.dev_counts.zero_()
    eng.stats.mate_counts = z["mate_counts"].copy()
    eng.stats.total_reads = int(sc[3])
    eng.stats.total_bases = int(sc[4])
    eng.stats.total_dist = int(sc[5])
    eng.stats.no_dists = int(sc[6])
    eng.ins_records = pickle.loads(z["ins"].tobytes())
    return int(sc[0]), int(sc[1]), int(sc[2])


def write_outputs(cfg: MapperConfig, eng: MapperEngine, sdx, genome,
                  tot_pairs: int, out_base: str | None = None) -> None:
    if out_base is None:
        out_base = cfg.out_base
    st = eng.stats
    names = MATE_NAMES_PAIRED if cfg.paired else MATE_NAMES_SINGLE

    if st.total_bases <= 0:
        # reference exits early: empty (unclosed) gz outputs + zero summary
        open(out_base + ".pileup.gz", "wb").close()
        open(out_base + ".indel.txt.gz", "wb").close()
        with open(out_base + ".summary.txt", "w") as f:
            f.write("\n" + "=" * 64)
            f.write("\n================= Summary " + "=" * 38)
            f.write("\n" + "=" * 64)
            f.write("\n" + "=" * 64)
            f.write("\n\nTotal Number of Mapping reads of Any Kind\t0"
                    "\tWith average Length\t0\tAverage Depth\t0"
                    "\tAverage Insert Size\t0")
            f.write("\n\nMapping Type\tCount\tFraction")
            f.write("\nAll\t%ld\t1".replace("%ld", str(tot_pairs)))
            for i in range(9):
                if "Not Used" not in names[i]:
                    frac = (st.mate_counts[i] / tot_pairs if tot_pairs
                            else float("nan"))
                    f.write("\n%s\t%d\t%g" % (names[i], st.mate_counts[i],
                                              frac))
            f.write("\n")
        return

    counts = eng.final_pileup()                     # (gs, 6) uint16
    tot_c = counts.astype(np.int64).sum(axis=1)
    nz = np.nonzero(tot_c > 0)[0]

    from ..formats.pileup import write_pileup
    write_pileup(out_base + ".pileup.gz", nz, counts[nz])

    # group insertion strings per position in canonical arrival order
    ins_by_pos = {}
    for key, gpos, s in sorted(eng.ins_records, key=lambda t: t[0]):
        ins_by_pos.setdefault(gpos, []).append(s)

    sstarts = sdx.sstarts
    with gzip.open(out_base + ".indel.txt.gz", "wt") as f:
        f.write("Fragment\tPositions\tReference Base\tTotal Coverage"
                "\tReference Reads\tNo Deletions\tNo Insertions"
                "\tInsertion Sequence")
        ins_pos = nz[counts[nz, 5] > 0]
        if len(ins_pos):
            chroms = find_chrom_mapper(sstarts, sdx.n_contigs, ins_pos)
            for pos, which in zip(ins_pos, chroms):
                ref = chr(genome[pos])
                row = counts[pos]
                if ref == "A":
                    ref_reads = row[0]
                elif ref == "C":
                    ref_reads = row[1]
                elif ref == "G":
                    ref_reads = row[2]
                else:
                    ref_reads = row[3]
                contig_pos = 1 + pos - sstarts[which]
                f.write("\n%s\t%d\t%c\t%d\t%d\t%d\t%d" % (
                    sdx.names[which], contig_pos, ref, tot_c[pos],
                    ref_reads, row[4], row[5]))
                for s in ins_by_pos.get(int(pos), []):
                    f.write("\t%s" % s)

    avg_readlen = float(st.total_bases)
    if st.total_reads > 0:
        avg_readlen /= float(st.total_reads)
    avg_dist = float(st.total_dist)
    if st.no_dists > 0:
        avg_dist /= float(st.no_dists)
    avg_reads = float(st.total_bases) / float(sdx.genome_size)

    with open(out_base + ".summary.txt", "w") as f:
        f.write("\n" + "=" * 64)
        f.write("\n================= Summary " + "=" * 38)
        f.write("\n" + "=" * 64)
        f.write("\n" + "=" * 64)
        f.write("\n\nTotal Number of Mapping reads of Any Kind\t%d"
                "\tWith average Length\t%g\tAverage Depth\t%g"
                "\tAverage Insert Size\t%g" % (
                    st.total_reads, avg_readlen, avg_reads, avg_dist))
        f.write("\n\nMapping Type\tCount\tFraction")
        f.write("\nAll\t%d\t1" % tot_pairs)
        for i in range(9):
            if "Not Used" not in names[i]:
                f.write("\n%s\t%d\t%g" % (
                    names[i], st.mate_counts[i],
                    st.mate_counts[i] / tot_pairs))
        f.write("\n")
