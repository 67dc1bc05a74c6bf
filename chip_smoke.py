#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--pairs N]
    python3 chip_smoke.py --kernels     # phases 1-3 only, about a minute
    python3 chip_smoke.py --caller      # phases 1, 8, 8b and 12 only
    python3 chip_smoke.py --scaleout    # phases 1-3, 9-11 and 13

Phases (each prints one line; any failure raises and exits non-zero):

  1. card: name and power limit (nvidia-smi), torch / CUDA / nvcc versions
  2. build: compile the SW kernels K1, K2, K3 from pecaller_tpu_torch/csrc
     (one nvcc per source, all at once); ptxas registers and spills of
     each instance, and with --kernels the SASS counts of K1, K2 and K3
     (sass_rows)
  3. kernel check: each kernel against its plain PyTorch version on the
     card, bitwise, on adversarial mixes and at the main-path shapes
     (K1 24576 lanes x 144 x 112 with 125 rows, K2 16384 lanes of the
     same; K3 on raw bytes with lowercase and IUPAC letters, padding
     lanes, n_rows < N, and 16384 lanes x 160 x 112), with kernel and
     plain times and each kernel's bound; each kernel also with each
     group size (threads per lane) that takes the width, timed per group
     size at the main-path shape, and on its edge lanes (k1_edge_lanes,
     k2_edge_lanes, k3_edge_lanes) at 100 bp and 250 bp widths (M 112
     and 256), B 1 and 1001; the seed stage's chain kernels
     (chain_check) against their plain versions at the v2 main key,
     timed, on a repeat-free and a dense mix
  4. main path (v2): an E. coli-scale genome (4.6 Mb, seed 2024) and 100k
     100 bp pairs, made once under .smoke/; `pemapper` with the
     reference's own argv (no device flag: the device route on cuda:0,
     asserted to be the v2 engine there) in 8192-pair batches through
     the port's command line, each shape key's step a CUDA graph
     (mapper/program.py), against the host oracle (the same command
     line with --host, the exact host engine, run beside the nbr index
     build): .summary.txt,
     .pileup.gz, .indel.txt.gz and both .mfile dumps byte-equal; K1 and
     K2 counted once a batch on that run, replays included; again with
     PECALLER_GROUP_K=3 (three batches a graph), the same five
     artifacts byte-equal; then graph_vs_eager against the engine with
     graph=False: raw outputs of three batches bitwise, and for each
     engine reads/s over the batches (graphed: median of 3 passes after
     a warm pass; eager: one pass after a warm pass), host enqueue and resolve ms a batch, peak memory above the
     resident engines and memory reserved; capture and instantiate
     seconds, graph pool bytes, one batch's replay in device ms;
     group_k=3's reads/s; fallbacks, re-walked ties
  5. v1 path: the fused v1 engine (exact-key seed tables, K3, the eager
     traceback), its step and output concatenation one graph a key, on
     the same genome and reads through the runner's map_files:
     .summary.txt and both .mfile dumps byte-equal to the host oracle's,
     the pileup equal up to tie-local placement (tie_local_pileup), the
     same (read, length) multiset of insertion records, K3 counted twice
     a batch; graph_vs_eager over the first 4 batches (the graph's
     capture and instantiate seconds for its ~40,000 nodes among them),
     fallbacks, peak device memory
  6. v2.5 path: bench.py's mid-size data (one 47 Mb contig "chr21x",
     seed 2025, 50k 100 bp pairs), made once under .smoke/mid/; the
     exact-key index build, the quartered-key index build (cached as
     .q4x parts) and its upload, each timed; `pemapper` (no device
     flag) in 8192-pair batches through the port's command line, where the
     runner must pick the quartered-key index (the nbr index refuses
     the genome up front), graphed, against the host oracle (run
     beside the quartered-key build): all five
     artifacts byte-equal, K1 and K2 counted once a batch;
     graph_vs_eager; fallbacks, re-walked ties, units the probe's caps
     sent to the host, peak device memory
  7. split path: the split engine (DeviceMapperEngine: SW scores by K3,
     the traceback and 2-byte pileup counters on the card, the seed step
     and the traceback each one graph a shape key) on phase 6's data
     with device seeds: phase 5's gate against phase 6's host oracle, K3
     launched twice per batch; then as the runner builds it at 2^30
     bases and more (host seeds) over the first SPLIT_HOST_BATCHES (2)
     batches, each batch's codes, m1, m2 and traceback records bitwise
     to the device-seed run's, K3 launched twice per batch; K3 at the
     engine's shape (kernel, plain and bound), host seconds per batch of
     the seed step, the traceback and the batch, reads/s over each run's
     batches, the graphs' capture seconds and pool bytes, peak device
     memory; then the device-seed engine against one built with
     graph=False on the same seed index (split_graph_vs_eager): every
     seed step's and traceback's output, the pileup and the insertion
     records bitwise over one pass of every batch each, with each one's
     reads/s and host seconds
  7b. human-scale counters: the split engine's (3.1e9, 6) int16 pileup
     (37.2 GB) on the card, pileup_scatter with sw_traceback_scatter's
     event layout at positions on both sides of 2^30 and 2^31 and in the
     genome's last window, one cell pushed past 65,535, as a program
     called three times (eager, captured, replayed); the touched rows
     after each call equal np.add.at on uint16; the graph's pool bytes
     and phase 7's beside the counters
  8. caller: bench.py's caller cohort (3 samples, Poisson depth 30, seed
     77, SNPs 1/1500, deletions and insertions 1/8000 each) over phase
     4's genome, made once under .smoke/callbench/; the exact native
     engine on every callable site (no screen) is the oracle;
     (a) the port's command line `pecaller pileup g.sdx 3 ours 0.95
     0.001 n <threads> n` (host phase 0, phase 1 on the card where a
     window's UNRES sites exceed the small-set rule) and (b) both screen
     phases on the card (host_screen False): .snp, .dist and the
     decompressed .base.gz and .piles.gz byte-equal to the oracle's;
     (b)'s phase 1 must take sites on the card; the screen's (phase,
     bucket) steps run as device programs (CUDA graphs); for each route
     sites/s (median of 3 passes after a warm pass), each stage's
     seconds, the sites each screen phase took on the card, the EASY /
     BAD / HARD counts, the sites sent to the native engine, the
     programs' capture and instantiate seconds and pool bytes, peak
     device memory; route (b) again with graph=False (the same gate, one
     pass after a warm pass); the oracle's seconds.  No kernel of K1-K3
     lies on this path.
  8b. the screen's contract on the card: CallerScreen at one full chunk
     of 3 samples (2^18 sites) and one of 64 (2^15) on screen_fuzz's
     counts; phase-0 codes bitwise equal to the CPU's and to the native
     phase 0, phase-1 codes held to screen_contract against the CPU's
     (no site EASY whose float64 margins fail the exact criterion; equal
     but for sites within 0.15 of a threshold, counted); both phases'
     programs (graphs) bitwise to graph=False at the full chunk and at
     tails of 1,500 and 5,000 sites (buckets 2^11 and 2^13); each
     phase's ms per chunk eager and as one graph replay (CUDA events),
     the programs' capture and instantiate seconds and pool bytes, and
     the screen's sites/s graphed and eager

  9. reads-axis mesh: phase 4's data through `pemapper` (no flag) with
     mesh_shards 2 on [cuda:0, cuda:0] (run_mapper with a device list),
     each shard's step a graph: all five artifacts byte-equal to the
     host oracle, K1 and K2 counted once a batch a shard;
     graph_vs_eager against the eager 2-shard engine, with
     the spans' dispatch and fetch ms a batch (phase 4 has one
     device's reads/s); phase 8's cohort with CallerConfig(mesh=2
     shards on cuda:0, host_screen=False) byte-equal to the exact
     engine, sites/s
  10. genome-sharded octile: phase 6's data; plan_shards(sdx, 2) and
     build_octile_shards timed (the build runs beside phase 6's oracle
     in the full smoke), each shard's table bytes; the
     OctileShardedEngine with both shards on cuda:0, built directly as
     phase 5 builds v1, each batch's step a MeshProgram (each shard's
     step cut at its 13 collectives into 14 segments, a CUDA graph a
     shard a segment, a graph a card a reduction, the output gathered
     on the first card), through map_files: all five artifacts
     byte-equal to phase 6's host oracle, K1 and K2 launched, the
     program's layout (segments a shard, graphs and copies a batch,
     pool bytes a card); graph_vs_eager against the engine on the same
     shards with graph=False (lockstep; the mesh's dispatch and fetch
     ms a batch among its figures); fallbacks, re-walked ties, peak
     device memory; what hg38 would need (at least 12 shards).  Where
     the machine has two cards, the same shards on cuda:0 and cuda:1:
     the same gate, the first 3 batches' raw outputs bitwise to the
     one-card program's, reads/s, host and replay ms, each card's peak
     memory; with one card the genome_mesh_cards line says the
     two-card run did not happen
  11. multi-process: two processes joined by init_distributed (gloo on
     localhost), both on cuda:0; run_mapper_distributed with its
     default devices (process p on cuda:{p % cards}, asserted) on phase
     4's reads split into two fastq pairs (the parts' pileups merge to the
     host oracle's, their .mfile dumps concatenate to its bytes), then
     run_caller_distributed and merge_caller_parts on phase 8's cohort
     (.snp, .dist, .base.gz and .piles.gz byte-equal to the exact
     engine's single run); the wall time of each
  12. the joint-configuration beam: phase 8's cohort through
     run_caller(device_beam=True), the four artifacts byte-equal to the
     exact engine's, with the beam's and the finisher's seconds and the
     sites the beam took and flagged; tests/test_beam.py's 40,000-site
     fuzz (beam_fuzz) at (3, diploid), (5, diploid) and (2, haploid) on
     cuda:0, every unflagged site finished bitwise to the native engine
     (beam_contract), the flag rates; the sweep at 3, 8, 16 and 32
     samples on 8,192 fuzz sites the screen leaves HARD: beam, beam +
     finisher, beam + finisher + native on the flagged sites and the
     native engine alone (host cores as threads) in sites/s, the beam
     path's outputs equal to the native run's; one 1024-site chunk of
     the graphed beam bitwise to the eager chunk, the ms of each (CUDA
     events); peak memory.  The beam's chunk is a device program (a
     CUDA graph) throughout, the cohort's too
  13. the sharded steps: sharded_map_step on two shards of cuda:0 at
     8,192 lanes of the v1 shape (K3 on each shard), a MeshProgram (a
     graph a shard before and after the reduce-scatter, a graph a
     shard's block sum, the gather), called eagerly, captured and
     replayed: score, bk, bi and the reduce-scattered pileup blocks
     bitwise against the one-device plain path and against the step
     with graph=False, bisulfite off and on; where the machine has two
     cards, the same on cuda:0 and cuda:1, graphed and with
     graph=False, bitwise to one card;
     sharded_call_step with graph=False and graphed (one program a
     shape holding both shards: called eagerly, captured, replayed),
     each bitwise to site_likelihoods on one device, with the step
     seconds and the program's capture seconds and pool bytes

Depth cuts that keep the full run inside its time limit: phase 5 rates
v1 over its first 4 batches (V1_RATE_BATCHES); graph_vs_eager (phases
4-6, 9, 10) takes one eager pass after a warm pass beside the graphed
engine's median of 3; phase 7's host-seed run maps its first 2 batches
(SPLIT_HOST_BATCHES), held bitwise to the gated device-seed run's
outputs on those batches.

Then the run's total seconds on a line of its own, a JSON line of the
kernels (launches summed over the gate runs of
phases 4-7, 9, 10 and 13, a graph's replays counted as its captured
launches), and last the result line {"ok": true, "device": {...}}.  With
--kernels: phases 1-3, the kernels line with launches null, and no result
line.  With --caller: phases 1, 8, 8b and 12, and neither line.  With
--scaleout: phases 1-3, 9-11 and 13, making only the data and the oracles
those need, then the kernels line (launches of phases 9, 10 and 13) and
no result line.  Needs no network and starts no process that outlives it.
The script and the port import nothing of jax nor of the JAX package
pecaller_tpu; the run fails if either entered sys.modules.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, ".smoke")
GENOME_LEN = 4_600_000
MID = os.path.join(DATA, "mid")
MID_LEN = 47_000_000                 # bench.py bench_mid: human chr21 scale
MID_PAIRS = 50_000
HUMAN_LEN = 3_100_000_000            # hg38 scale, for phase 7b
BATCH = 8192
V1_RATE_BATCHES = 4                # phase 5's reads/s passes (of 13 batches)
SPLIT_HOST_BATCHES = 2             # phase 7's host-seed run (of 7 batches)
N_ROWS = 125                       # R_ROWS of 100 bp reads: 104 + 2*10 + 1
# H100 SXM rates used for the bounds (NVIDIA data sheet; 700 W): HBM
# bytes/s, and integer operations/s at the card's issue rate, 132 SMs x
# 4 schedulers x one 32-thread instruction a clock x 1.98 GHz.  Integer
# work issues on the FMA pipes (IMAD, IADD3) as well as on an SM's 64
# INT32 lanes, so the INT32 lanes alone (half this rate) are no ceiling.
HBM_BPS = 3.35e12
INT_OPS = 132 * 4 * 32 * 1.98e9
# integer operations per DP cell, in issue slots: what the SASS row loop
# of each kernel's main instance (8 threads x 15 columns; `--kernels`
# prints its length as `row_loop` and writes its listing to
# chiprun_out/sass_row_loops.txt) issues for its 15 cells, less the
# instructions it issues once a row, over 15, rounded down.  Once a row:
# the shuffles (7: the reference byte, two shfl_up, three scan steps,
# the exclusive shift; K2 8, its byte's left part), the scan's compare
# and select (3 a step, 9), the column-0, first-`a` and exclusive-shift
# selects (5), the loop's count, test and branch (3), and
#   K1: the owner's update of best / k / i / tie (BSSY, BSYNC, the
#       branch and the 99 instructions it skips, 102), the owner and row
#       tests (4), the reference's N test (1): 131 of 309, (309 - 131) /
#       15 = 11.9;
#   K3: the owner's update without the tie count (72 skipped, 75), the
#       owner and row tests (4): 103 of 297 (both modes), (297 - 103) /
#       15 = 12.9;
#   K2: the step test and its ballot (14 with the mask moves and
#       divergence branches), BSSY / BSYNC, WARPSYNC and NOP (4), the
#       byte's left part (2), the store of the row's 16-byte words (6),
#       the reference's N test (1): 52 of 589, (589 - 52) / 15 = 35.8.
# A cell's own work is then the max3, the match test and bump, the two
# viaddmax, the running max, the scan's max, the offsets and the row
# copies; K3's byte test issues one more instruction than K1's (two
# LOP3 and a PLOP3 against two ISETP) and K2 adds its decision byte.
# A count of source operations is no floor: the compiler fuses them.
OPS_PER_CELL = {"sw_align_x": 11, "sw_tb_rows": 35, "sw_align": 12}


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_info():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from pecaller_tpu_torch.ops import sw_cuda
    nvcc = subprocess.run([sw_cuda._nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(smi, flush=True)
    say("card", name=torch.cuda.get_device_name(0), power=smi,
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        triton=triton_version, python=sys.version.split()[0],
        cutlass=os.path.isdir("/usr/local/cutlass/include/cutlass"))
    return smi


def build(sass=False):
    from pecaller_tpu_torch.ops import sw_cuda
    t0 = time.time()
    lib = sw_cuda.build_kernels()
    sw_cuda.load_kernels()
    # ptxas -v: registers and spills of each kernel instance
    ptxas, name = {}, None
    for ln in sw_cuda.BUILD_INFO.get("ptxas", "").splitlines():
        m = re.search(r"entry function '(_Z\w+)'", ln)
        if m:
            name = _instance(m.group(1))
        elif name and ("spill" in ln or "registers" in ln):
            ptxas.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    say("build", seconds=round(time.time() - t0, 3),
        library=os.path.relpath(lib, ROOT), ptxas=ptxas,
        **({"sass": sass_rows(lib)} if sass else {}))


def _instance(mangled):
    """Kernel instance from its mangled name, named by its wrapper:
    sw_align_x<bisulfite,group,columns> for K1 and sw_align<...> for K3
    (sw_group_align_kernel under SwXMatch and SwByteMatch), and
    sw_tb_rows<...> for K2."""
    m = re.match(r"_Z\d+(\w+?)I(?:\d+(Sw\w+?)I(Lb\dE)E(Lb\dE))?"
                 r"((?:L[bi]\d+E)+)E", mangled)
    if not m:
        return mangled
    name, rule, bis, _tie, args = m.groups()
    if rule:
        name, args = {"SwXMatch": "sw_align_x",
                      "SwByteMatch": "sw_align"}[rule], bis + args
    return "{}<{}>".format(name.removesuffix("_kernel"), ",".join(
        re.findall(r"L[bi](\d+)E", args)))


def sass_rows(lib):
    """From the SASS of each K1, K2 and K3 instance (the toolkit's
    cuobjdump; None without it): its Hopper DPX instructions (VIMNMX3,
    VIADDMNMX), and the instructions of its (phase-1) row loop, from the
    loop's head to the branch back to it after the row's reference-byte
    shuffle (the first SHFL.IDX); None where the SASS has no such loop.
    The row loops of the main-path instances (<bisulfite,8,15>) go to
    chiprun_out/sass_row_loops.txt.  A diagnostic of --kernels."""
    from pecaller_tpu_torch.ops import sw_cuda
    exe = os.path.join(os.path.dirname(sw_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, loops = {}, []
    for part in sass.split("Function : ")[1:]:
        name = _instance(part.split(None, 1)[0])
        if not name.startswith(("sw_align", "sw_tb_rows")):
            continue
        ins = [(int(a, 16), t) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        shfl = [a for a, t in ins if "SHFL.IDX" in t][:1]
        back = [(a, int(m.group(1), 16)) for a, t in ins
                if shfl and a > shfl[0]
                for m in [re.search(r"BRA 0x([0-9a-f]+)", t)]
                if m and int(m.group(1), 16) <= shfl[0]]
        out[name] = dict(
            {op: len(re.findall(rf"\b{op}\b", part))
             for op in ("VIMNMX3", "VIADDMNMX")},
            row_loop=(back[0][0] - back[0][1]) // 16 + 1 if back else None)
        if back and name.endswith(",8,15>"):     # the main-path instances
            loops.append(f"== {name}\n" + "\n".join(
                f"{a:05x} {t.strip()}" for a, t in ins
                if back[0][1] <= a <= back[0][0]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sass_row_loops.txt"),
              "w") as f:
        f.write("\n".join(loops) + "\n")
    return out


# ---------------------------------------------------------------------------
# kernel check

def mk_lanes(rng, B, N, M, lo, hi, raw=False):
    """Adversarial SW lanes: windows around mutated reads (substitutions,
    small indels), N wildcards in reads and windows, padding lanes.
    xcodes, or with ``raw`` bytes that add lowercase and IUPAC
    letters."""
    import numpy as np
    code = np.zeros(256, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    code[ord("N")] = 4
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (B, M))]
    rlens = rng.integers(lo, hi, B).astype(np.int32)
    refs = np.zeros((B, N), np.uint8)
    blens = np.zeros(B, np.int32)
    for b in range(B):
        r = list(reads[b, :rlens[b]])
        for _ in range(rng.integers(0, 5)):
            r[rng.integers(0, len(r))] = bases[rng.integers(0, 4)]
        for _ in range(rng.integers(0, 3)):
            p = rng.integers(1, len(r))
            if rng.random() < 0.5:
                r.insert(p, bases[rng.integers(0, 4)])
            else:
                del r[p]
        win = np.concatenate([bases[rng.integers(0, 4, rng.integers(0, 11))],
                              np.array(r, np.uint8),
                              bases[rng.integers(0, 4,
                                                 rng.integers(0, 11))]])
        blens[b] = min(len(win), N)
        refs[b, :blens[b]] = win[:blens[b]]
    reads = np.where(rng.random((B, M)) < 0.01, ord("N"), reads)
    refs = np.where(rng.random((B, N)) < 0.005, ord("N"), refs)
    blens[:7] = 0                          # padding lanes
    rlens[7:14] = 1
    if not raw:
        return code[refs], blens, code[reads], rlens
    rlens[:7] = 1
    return spice(rng, refs.astype(np.uint8)), blens, \
        spice(rng, reads.astype(np.uint8)), rlens


def spice(rng, x):
    """Raw bytes with 5% made lowercase, 1% IUPAC letters and 0.5% n."""
    import numpy as np
    iupac = np.frombuffer(b"RYKMSWBDHVrykmswbdhv", np.uint8)
    x = np.where(rng.random(x.shape) < 0.05, x | 0x20, x)
    x = np.where(rng.random(x.shape) < 0.01,
                 iupac[rng.integers(0, len(iupac), x.shape)], x)
    return np.where(rng.random(x.shape) < 0.005, ord("n"),
                    x).astype(np.uint8)


def edge_marks(M, cols):
    """The rlen values of k1_edge_lanes: 0, M, k*C - 1, k*C and k*C + 1
    for each C in ``cols`` within [0, M], then M + 1, M + 7 and -1."""
    marks = {0, M}
    for C in cols:
        for k in range(1, M // C + 2):
            marks |= {k * C - 1, k * C, k * C + 1}
    return sorted(m for m in marks if 0 <= m <= M) + [M + 1, M + 7, -1]


def k1_edge_lanes(rng, B, N, M, cols):
    """K1's edge cases on xcodes, then the mk_lanes mix up to B lanes.
    rlen at 0, at M, past M (M + 1, M + 7, -1) and at k*C - 1, k*C and
    k*C + 1 for each C in ``cols`` (the segment boundaries of a thread
    group), each three ways: a window around the read (flanks of 0-10
    bases), the read equal to its window, and a homopolymer read in a
    homopolymer window (exact ties everywhere).  Then a lane with blen
    past N (so n_rows < blen for any n_rows) and one with blen < 0."""
    import numpy as np
    marks = edge_marks(M, cols)
    refs, blens, reads, rlens = mk_lanes(rng, B, N, M, max(2, M - 30),
                                         M + 1)
    n = 0
    for how in ("window", "equal", "homopolymer"):
        for r in marks:
            if n == B:
                break
            L = min(max(r, 0), M)
            if how == "homopolymer":
                base = rng.integers(0, 4)
                reads[n, :L] = base
                win = np.full(max(0, L + int(rng.integers(-3, 12))), base)
            elif how == "equal":
                win = reads[n, :L]
            else:
                win = np.concatenate([rng.integers(0, 4, rng.integers(0, 11)),
                                      reads[n, :L],
                                      rng.integers(0, 4, rng.integers(0, 11))])
            refs[n] = 0
            blens[n] = min(len(win), N)
            refs[n, :blens[n]] = win[:blens[n]]
            rlens[n] = r
            n += 1
    if n + 2 <= B:
        blens[n], blens[n + 1] = N + 5, -3
    return refs, blens, reads, rlens


# (reference byte, read byte) pairs k3_edge_lanes places at segment
# boundaries: bisulfite C/T pairs (and T/C, which never matches), N and
# n on either side, lowercase against upper case, IUPAC letters; None
# keeps the lane's base
RAW_PAIRS = ((b"C", b"T"), (b"c", b"t"), (b"C", b"t"), (b"c", b"T"),
             (b"T", b"C"), (b"N", None), (b"n", None), (None, b"N"),
             (None, b"n"), (b"a", b"a"), (b"A", b"a"), (b"R", b"R"),
             (b"R", b"A"), (b"y", b"Y"))


def k3_edge_lanes(rng, B, N, M, cols):
    """K3's edge cases on raw bytes: the lanes of k1_edge_lanes in
    letters (xcode 4 as N), each edge lane with pairs of RAW_PAIRS at
    about half of the read columns k*C - 1, k*C and k*C + 1 of each C in
    ``cols`` (the segment boundaries of a thread group), the reference
    byte at the window row of the same index (on the diagonal of the
    lanes whose read equals its window); the random mix after them
    spiced as mk_lanes(raw=True) spices it; blen past N, below 0 and 0
    on the three lanes after the edge lanes."""
    import numpy as np
    refs, blens, reads, rlens = k1_edge_lanes(rng, B, N, M, cols)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    refs, reads = letters[refs], letters[reads]
    n_edge = min(B, 3 * len(edge_marks(M, cols)))
    bounds = sorted({j for C in cols for k in range(1, M // C + 2)
                     for j in (k * C - 1, k * C, k * C + 1) if 1 <= j <= M})
    for n in range(n_edge):
        for j in bounds:
            if rng.random() < 0.5:
                continue
            ref_b, read_b = RAW_PAIRS[rng.integers(0, len(RAW_PAIRS))]
            if read_b is not None:
                reads[n, j - 1] = read_b[0]
            if ref_b is not None and j <= N:
                refs[n, j - 1] = ref_b[0]
    refs[n_edge:] = spice(rng, refs[n_edge:])
    reads[n_edge:] = spice(rng, reads[n_edge:])
    if n_edge + 3 <= B:         # k1_edge_lanes set the first two
        blens[n_edge + 2] = 0
    return refs, blens, reads, rlens


def k2_edge_lanes(rng, B, N, M, cols, n_rows, n_mix=41):
    """K2's edge cases: the lanes of k1_edge_lanes, whose starts the
    caller takes from the plain sw_align_x (the starts the main path
    gives K2), with forced starts written over the last lanes (B None:
    just enough lanes for every one, with n_mix of the random mix).  Returns
    (refs, blens, reads, rlens, bt_k, bt_i, forced): bt_k and bt_i hold
    the forced starts where ``forced``.  The forced starts:
    plane 2 with jj = rlen at k*C - 1, k*C and k*C + 1 for each C in
    ``cols``; reads with an insertion of 5 to 50 bases (crossing thread
    segments) walked from its end in plane 2, and from their natural
    start; insertions at the read's start walked in plane 2, so the walk
    dies inside the run; bt_i past n_rows, past blen, 0 and below 0;
    rlen 0, M, M + 1, M + 7 and -1; then random starts in every plane."""
    import numpy as np
    lanes = []                  # (window, read, rlen, bt_k, bt_i, forced)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def rows_of(win):
        return max(1, min(len(win), N, n_rows))
    for C in cols:
        for k in range(1, M // C + 2):
            for r in (k * C - 1, k * C, k * C + 1):
                if 1 <= r <= M:
                    rd = rand(r)
                    win = np.concatenate([rand(rng.integers(0, 6)), rd,
                                          rand(rng.integers(0, 6))])
                    lanes.append((win, rd, r, 2,
                                  int(rng.integers(1, rows_of(win) + 1)),
                                  True))
    for L in (5, 9, 17, 33, 50):
        if L + 20 > M:
            continue
        win = rand(min(M - L, N - 4))
        p = int(rng.integers(2, len(win) - 2))
        rd = np.concatenate([win[:p], rand(L), win[p:]])[:M]
        lanes.append((win, rd, len(rd), 0, 0, False))
        lanes.append((win, rd, p + L, 2, min(p, n_rows), True))
        rd0 = np.concatenate([rand(L), win])[:M]       # run from column 1
        lanes.append((win, rd0, L, 2, int(rng.integers(1, 4)), True))
        lanes.append((win, rd0, len(rd0), 2, rows_of(win), True))
    for bi in (n_rows + 1, N + 3, 0, -2):
        for bk in (0, 1, 2):
            rd = rand(M - 10)
            lanes.append((rd, rd, M - 10, bk, bi, True))
    for r in (0, M, M + 1, M + 7, -1):
        for bk in (0, 1, 2):
            rd = rand(M)
            lanes.append((rd, rd, r, bk, rows_of(rd), True))
    for bk in (0, 1, 2):                # bt_i past blen: rows that hold
        rd = rand(M - 20)
        lanes.append((rd[:10], rd, M - 20, bk, min(40, n_rows), True))
    for _ in range(40):
        rd = rand(M)
        win = np.concatenate([rand(rng.integers(0, 11)), rd,
                              rand(rng.integers(0, 11))])
        lanes.append((win, rd, int(rng.integers(-1, M + 3)),
                      int(rng.integers(0, 3)),
                      int(rng.integers(-1, n_rows + 3)), True))
    if B is None:               # every edge lane, forced start and n_mix
        B = 3 * len(edge_marks(M, cols)) + n_mix + len(lanes)
    refs, blens, reads, rlens = k1_edge_lanes(rng, B, N, M, cols)
    bt_k = np.zeros(B, np.int32)
    bt_i = np.zeros(B, np.int32)
    forced = np.zeros(B, bool)
    lanes = lanes[-B:]
    for n, (win, rd, r, bk, bi, f) in zip(range(B - len(lanes), B), lanes):
        reads[n] = 0
        reads[n, :len(rd)] = rd
        refs[n] = 0
        blens[n] = min(len(win), N)
        refs[n, :blens[n]] = win[:blens[n]]
        rlens[n], bt_k[n], bt_i[n], forced[n] = r, bk, bi, f
    return refs, blens, reads, rlens, bt_k, bt_i, forced


def _timed(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _max_abs_err(xs, ys):
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def bound_ms(name, cells, in_bytes, out_bytes):
    """The least time the card could take: the larger of the bytes the
    call must move over HBM and its integer operations over the issue
    rate.  Returns (ms, "bytes" or "operations")."""
    t_bytes = (in_bytes + out_bytes) / HBM_BPS
    t_ops = cells * OPS_PER_CELL[name] / INT_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def kernel_check():
    import numpy as np
    import torch
    from pecaller_tpu_torch.ops import sw, sw2, sw_cuda
    dev = torch.device("cuda", 0)
    res = {}

    def lane_bytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    # K1 and K2 on xcodes
    cases = [(2048, 64, 48, 17, 41, 60), (2048, 96, 80, 30, 73, 90),
             (24576, 144, 112, 90, 101, N_ROWS)]
    for ci, (B, N, M, lo, hi, nr) in enumerate(cases):
        for bis in (False, True):
            rx, bl, dx, rl = (torch.from_numpy(x).to(dev) for x in mk_lanes(
                np.random.default_rng(100 * ci + bis), B, N, M, lo, hi))
            ka = sw_cuda.sw_align_x(rx, bl, dx, rl, bisulfite=bis,
                                    n_rows=nr)
            pa = sw2.sw_align_x(rx, bl, dx, rl, bisulfite=bis, n_rows=nr)
            torch.cuda.synchronize()
            e1 = _max_abs_err(ka, pa)
            # K2 on the main path gets the winners: U = 16384 lanes
            U = min(B, 16384)
            tb_in = [x[:U].contiguous() for x in (rx, bl, dx, rl, pa[1],
                                                   pa[2])]
            kt = sw_cuda.sw_traceback_rows(*tb_in, bisulfite=bis,
                                           n_rows=nr)
            pt = sw2.sw_traceback_rows(*tb_in, bisulfite=bis, n_rows=nr)
            torch.cuda.synchronize()
            e2 = _max_abs_err(kt, pt)
            if e1 or e2:
                raise AssertionError(f"kernel != plain at B={B} N={N} "
                                     f"M={M} bisulfite={bis}: K1 {e1}, "
                                     f"K2 {e2}")
            if ci == len(cases) - 1 and not bis:
                main_x = (rx, bl, dx, rl, nr, pa)
                cells1 = int((torch.clamp(bl, 0, nr).long()
                              * rl.clamp(0, M).long()).sum())
                res["sw_align_x"] = dict(
                    max_abs_err=e1,
                    ms=_timed(lambda: sw_cuda.sw_align_x(
                        rx, bl, dx, rl, n_rows=nr), 5),
                    plain_ms=_timed(lambda: sw2.sw_align_x(
                        rx, bl, dx, rl, n_rows=nr), 2),
                    shape=[B, N, M, nr], cells=cells1,
                    bound=bound_ms("sw_align_x", cells1,
                                   lane_bytes(rx, bl, dx, rl),
                                   lane_bytes(*ka)))
                main_tb = (tb_in, nr, pt)
                alive = (tb_in[5] > 0) & (tb_in[3] > 0)
                cells2 = int((torch.clamp(tb_in[5], 0, nr).long()
                              * alive.long()).sum()) * M
                res["sw_tb_rows"] = dict(
                    max_abs_err=e2,
                    ms=_timed(lambda: sw_cuda.sw_traceback_rows(
                        *tb_in, n_rows=nr), 5),
                    plain_ms=_timed(lambda: sw2.sw_traceback_rows(
                        *tb_in, n_rows=nr), 2),
                    shape=[U, N, M, nr], cells=cells2,
                    bound=bound_ms("sw_tb_rows", cells2, lane_bytes(*tb_in),
                                   lane_bytes(*kt)))

    res["sw_align_x"].update(k1_groups(main_x))
    res["sw_tb_rows"].update(k2_groups(main_tb))

    # K3 on raw bytes, with the main path's group size and each forced
    # one that takes the width; the last case is the v1 main-path shape
    # (both ends' slots: H_CAP = 2 x 8192 lanes, N = 160, M = 112, all
    # rows)
    lib = sw_cuda.load_kernels()
    cases3 = [(2048, 64, 48, 17, 41, 64), (2048, 64, 48, 17, 41, 50),
              (2048, 96, 80, 30, 73, 96), (16384, 160, 112, 90, 101, 160)]
    for ci, (B, N, M, lo, hi, nr) in enumerate(cases3):
        for bis in (False, True):
            refs, bl, reads, rl = (torch.from_numpy(x).to(dev)
                                   for x in mk_lanes(
                np.random.default_rng(500 + 10 * ci + bis), B, N, M, lo,
                hi, raw=True))
            k3 = sw_cuda.sw_align(refs, bl, reads, rl, bisulfite=bis,
                                  n_rows=nr)
            p3 = sw.sw_align_device(refs, bl, reads, rl, bisulfite=bis,
                                    n_rows=nr)
            torch.cuda.synchronize()
            e3 = _max_abs_err(k3, p3)
            for g in (8, 16, 32):
                if lib.sw_lane_cols(M, g):
                    e3 = max(e3, _max_abs_err(sw_cuda.sw_align(
                        refs, bl, reads, rl, bisulfite=bis, n_rows=nr,
                        group=g), p3))
            if e3:
                raise AssertionError(f"K3 != plain at B={B} N={N} M={M} "
                                     f"n_rows={nr} bisulfite={bis}: {e3}")
            if ci == len(cases3) - 1 and not bis:
                main3 = (refs, bl, reads, rl, nr)
                cells3 = int((torch.clamp(bl, 0, nr).long()
                              * rl.clamp(0, M).long()).sum())
                res["sw_align"] = dict(
                    max_abs_err=e3,
                    ms=_timed(lambda: sw_cuda.sw_align(
                        refs, bl, reads, rl, n_rows=nr), 5),
                    plain_ms=_timed(lambda: sw.sw_align_device(
                        refs, bl, reads, rl, n_rows=nr), 2),
                    shape=[B, N, M, nr], cells=cells3,
                    bound=bound_ms("sw_align", cells3,
                                   lane_bytes(refs, bl, reads, rl),
                                   lane_bytes(*k3)))
                # the v1 traceback (plain torch, no kernel) on one end's
                # winners: 8192 lanes
                W = B // 2
                tb = [x[:W].contiguous() for x in (refs, bl, reads, rl,
                                                   k3[1], k3[2])]
                res["sw_align"]["eager_traceback_ms"] = _timed(
                    lambda: sw.sw_traceback_device(*tb, n_rows=nr), 2)
    res["sw_align"].update(k3_groups(main3))
    n_cases = 2 * (len(cases) + len(cases3))
    say("kernel_check", bitwise=True,
        cases=n_cases + sum(res[k]["edge_cases"] for k in res),
        **{k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
               for kk, vv in v.items()} for k, v in res.items()})
    return res


def chain_inputs_main(rng, U=65536, S=8, dense=False):
    """The seed stage's chain inputs at the v2 main key (32,768 pairs:
    65,536 ends, S 8 for 100 bp reads) on a repeat-free genome: 39% of
    the units padding (no candidate), the rest one read each whose true
    chain gives one anchor in each of its 7 probes of one orientation,
    with a stray anchor in half the probes (about one slot in 16 valid);
    ``dense`` fills every slot (16 candidates a probe) on a few
    diagonals, the worst case."""
    import numpy as np
    SEG = 16
    n_segs = np.full(U, 7, np.int32)
    offs = np.zeros((U, S), np.int32)
    offs[:, :7] = np.array([0, 16, 32, 48, 64, 80, 84], np.int32)
    pos = np.full((U, 2, S, SEG), 2 ** 30, np.int32)
    live = rng.random(U) >= 0.39
    g = rng.integers(0, 4_600_000, U)
    o = rng.integers(0, 2, U)
    if dense:
        d = g[:, None, None, None] + 13 * rng.integers(0, 8, (U, 2, S, SEG))
        pos[live] = (d + offs[:, None, :, None])[live]
    else:
        u = np.nonzero(live)[0]
        for li in range(7):
            pos[u, o[u], li, 0] = g[u] + offs[u, li]
        stray = (rng.random((U, 2, S)) < 0.5) & live[:, None, None]
        pos[..., 1][stray] = rng.integers(0, 4_600_000, stray.sum())
    seg_tot = (pos < 2 ** 30).sum(-1).astype(np.int64)
    mm0 = np.full(U, 4, np.int32)
    skip = np.zeros(U, np.int32)
    return dict(pos=pos, offsets=offs, n_segs=n_segs, seg_tot=seg_tot,
                mm0=mm0, skip=skip)


def chain_check():
    """The seed stage's chain kernels (csrc/chain.cu) against their plain
    versions at the v2 main key, bitwise, on the repeat-free mix and the
    dense one: each kernel's time alone (CUDA events), its byte bound
    and the plain version's time."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.ops import chain
    dev = torch.device("cuda", 0)
    out = {}
    for mix in ("sparse", "dense"):
        x = {k: torch.from_numpy(v).to(dev) for k, v in chain_inputs_main(
            np.random.default_rng(7), dense=mix == "dense").items()}
        a = (x["pos"], x["offsets"], x["n_segs"])
        kv = chain.chain_votes(*a)
        pv = chain.chain_votes_plain(*a)
        b = (x["pos"], kv[0], kv[1], x["seg_tot"], x["offsets"],
             x["n_segs"], x["mm0"], x["skip"])
        ks = chain.chain_select(*b)
        ps = chain.chain_select_plain(*b)
        torch.cuda.synchronize()
        err = max(_max_abs_err(kv, pv), _max_abs_err(ks, ps))
        if err:
            raise AssertionError(f"chain kernels != plain on the {mix} "
                                 f"mix: {err}")

        def nbytes(*xs):
            return sum(t.numel() * t.element_size() for t in xs)
        U = x["pos"].shape[0]
        for name, fn, plain, ins, outs in (
                ("chain_votes", lambda: chain.chain_votes(*a),
                 lambda: chain.chain_votes_plain(*a), a, kv),
                ("chain_select", lambda: chain.chain_select(*b),
                 lambda: chain.chain_select_plain(*b), b, ks)):
            out[f"{name}.{mix}"] = dict(
                ms=_timed(fn, 20), plain_ms=_timed(plain, 3),
                bound_ms=1e3 * (nbytes(*ins) + nbytes(*outs)) / HBM_BPS,
                units=U, live_anchors=int((x["pos"] < 2 ** 30).sum()))
    say("chain_check", bitwise=True,
        **{k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
               for kk, vv in v.items()} for k, v in out.items()})
    return out


def k1_groups(main_x):
    """K1 with each group size that takes the width, against the plain
    version: on the main-path mix (timed per group size) and on the edge
    lanes of k1_edge_lanes at 100 bp (M 112) and 250 bp (M 256) widths,
    with B = 1 and B = 1001 (a multiple of no block's lanes)."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.ops import sw2, sw_cuda
    dev = torch.device("cuda", 0)
    lib = sw_cuda.load_kernels()
    rx, bl, dx, rl, nr, pa = main_x
    M = dx.shape[1]
    out = dict(group=lib.sw_lane_group(M), group_cols={}, group_ms={})
    for g in (8, 16, 32):
        if not lib.sw_lane_cols(M, g):
            continue
        e = _max_abs_err(sw_cuda.sw_align_x(rx, bl, dx, rl, n_rows=nr,
                                            group=g), pa)
        if e:
            raise AssertionError(f"K1 group {g} != plain on the main mix")
        out["group_cols"][g] = lib.sw_lane_cols(M, g)
        out["group_ms"][g] = _timed(lambda: sw_cuda.sw_align_x(
            rx, bl, dx, rl, n_rows=nr, group=g), 5)
    n = 0
    for M, N, nr in ((112, 144, N_ROWS), (256, 288, 270)):
        groups = [g for g in (8, 16, 32) if lib.sw_lane_cols(M, g)]
        cols = [lib.sw_lane_cols(M, g) for g in groups]
        for bis in (False, True):
            lanes = [torch.from_numpy(x).to(dev) for x in k1_edge_lanes(
                np.random.default_rng(700 + M + bis), 1001, N, M, cols)]
            for sub in (lanes, [x[-1:] for x in lanes],
                        [x[1:2] for x in lanes]):
                p = sw2.sw_align_x(*sub, bisulfite=bis, n_rows=nr)
                for g in groups:
                    k = sw_cuda.sw_align_x(*sub, bisulfite=bis, n_rows=nr,
                                           group=g)
                    torch.cuda.synchronize()
                    e = _max_abs_err(k, p)
                    if e:
                        raise AssertionError(
                            f"K1 group {g} != plain on edge lanes: M={M} "
                            f"B={len(sub[0])} bisulfite={bis}: {e}")
                    n += 1
    return dict(out, edge_cases=n)


def k2_groups(main_tb):
    """K2 with each group size that takes the width, against the plain
    version: on the main-path winners (timed per group size, with the
    cube's bytes per launch; and with n_rows = 0) and on the edge lanes
    of k2_edge_lanes at 100 bp (M 112) and 250 bp (M 256) widths, with
    B = 1001 and two B = 1 slices (a forced start and an edge lane)."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.ops import sw2, sw_cuda
    dev = torch.device("cuda", 0)
    lib = sw_cuda.load_kernels()
    tb_in, nr, pt = main_tb
    U, M = tb_in[2].shape
    out = dict(group=lib.sw_lane_group(M), group_cols={}, group_ms={},
               cube_bytes={g: U * nr * lib.sw_tb_rows_row_bytes(M, g)
                           for g in (0, 8, 16, 32)
                           if lib.sw_lane_cols(M, g)})
    pt0 = sw2.sw_traceback_rows(*tb_in, n_rows=0)   # no rows to walk
    for g in (8, 16, 32):
        if not lib.sw_lane_cols(M, g):
            continue
        e = _max_abs_err(sw_cuda.sw_traceback_rows(*tb_in, n_rows=nr,
                                                   group=g), pt)
        e0 = _max_abs_err(sw_cuda.sw_traceback_rows(*tb_in, n_rows=0,
                                                    group=g), pt0)
        if e or e0:
            raise AssertionError(f"K2 group {g} != plain on the main mix "
                                 f"({e}; with n_rows 0: {e0})")
        out["group_cols"][g] = lib.sw_lane_cols(M, g)
        out["group_ms"][g] = _timed(lambda: sw_cuda.sw_traceback_rows(
            *tb_in, n_rows=nr, group=g), 5)
    n = 0
    for M, N, nr in ((112, 144, N_ROWS), (256, 288, 270)):
        groups = [g for g in (8, 16, 32) if lib.sw_lane_cols(M, g)]
        cols = [lib.sw_lane_cols(M, g) for g in groups]
        for bis in (False, True):
            rx, bl, dx, rl, fk, fi, forced = (
                torch.from_numpy(x).to(dev) for x in k2_edge_lanes(
                    np.random.default_rng(900 + M + bis), 1001, N, M,
                    cols, nr))
            p = sw2.sw_align_x(rx, bl, dx, rl, bisulfite=bis, n_rows=nr)
            tb = [rx, bl, dx, rl, torch.where(forced, fk, p[1]),
                  torch.where(forced, fi, p[2])]
            for sub in (tb, [x[-1:] for x in tb], [x[1:2] for x in tb]):
                want = sw2.sw_traceback_rows(*sub, bisulfite=bis,
                                             n_rows=nr)
                for g in groups:
                    got = sw_cuda.sw_traceback_rows(*sub, bisulfite=bis,
                                                    n_rows=nr, group=g)
                    torch.cuda.synchronize()
                    e = _max_abs_err(got, want)
                    if e:
                        raise AssertionError(
                            f"K2 group {g} != plain on edge lanes: M={M} "
                            f"B={len(sub[0])} bisulfite={bis}: {e}")
                    n += 1
    return dict(out, edge_cases=n)


def k3_groups(main3):
    """K3 with each group size that takes the width (checked on the
    main-path mix by kernel_check), against the plain version: on that
    mix with n_rows = 0, timed per group size there, and on the edge
    lanes of k3_edge_lanes at 100 bp (M 112, N 160) and 250 bp (M 256,
    N 288) widths, with all rows and with n_rows < N, with B = 1001 and
    two B = 1 slices, both modes."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.ops import sw, sw_cuda
    dev = torch.device("cuda", 0)
    lib = sw_cuda.load_kernels()
    refs, bl, reads, rl, nr = main3
    M = reads.shape[1]
    out = dict(group=lib.sw_lane_group(M), group_cols={}, group_ms={})
    p0 = sw.sw_align_device(refs, bl, reads, rl, n_rows=0)  # no rows
    for g in (8, 16, 32):
        if not lib.sw_lane_cols(M, g):
            continue
        e0 = _max_abs_err(sw_cuda.sw_align(refs, bl, reads, rl, n_rows=0,
                                           group=g), p0)
        if e0:
            raise AssertionError(f"K3 group {g} != plain on the main mix "
                                 f"with n_rows 0: {e0}")
        out["group_cols"][g] = lib.sw_lane_cols(M, g)
        out["group_ms"][g] = _timed(lambda: sw_cuda.sw_align(
            refs, bl, reads, rl, n_rows=nr, group=g), 5)
    n = 0
    for M, N, rows in ((112, 160, (160, 121)), (256, 288, (288, 270))):
        groups = [g for g in (8, 16, 32) if lib.sw_lane_cols(M, g)]
        cols = [lib.sw_lane_cols(M, g) for g in groups]
        for bis in (False, True):
            lanes = [torch.from_numpy(x).to(dev) for x in k3_edge_lanes(
                np.random.default_rng(1100 + M + bis), 1001, N, M, cols)]
            subs = (lanes, [x[-1:] for x in lanes], [x[1:2] for x in lanes])
            for sub, nr in ((sub, nr) for sub in subs for nr in rows):
                p = sw.sw_align_device(*sub, bisulfite=bis, n_rows=nr)
                for g in groups:
                    k = sw_cuda.sw_align(*sub, bisulfite=bis, n_rows=nr,
                                         group=g)
                    torch.cuda.synchronize()
                    e = _max_abs_err(k, p)
                    if e:
                        raise AssertionError(
                            f"K3 group {g} != plain on edge lanes: M={M} "
                            f"B={len(sub[0])} n_rows={nr} bisulfite={bis}: "
                            f"{e}")
                    n += 1
    return dict(out, edge_cases=n)


# ---------------------------------------------------------------------------
# data: copies of tests/util.py's generators (the same RNG calls, so the
# same bytes)

BASES = b"ACGT"


def make_genome(rng, contig_lens, names=None, n_blocks=()):
    """Random ACGT contigs; n_blocks = [(contig, start, len), ...] N runs."""
    import numpy as np
    bases = np.frombuffer(BASES, dtype=np.uint8)
    names = names or [f"chr{i+1}" for i in range(len(contig_lens))]
    seqs = []
    for ci, L in enumerate(contig_lens):
        s = bases[rng.integers(0, 4, size=L)].copy()
        for (c, st, ln) in n_blocks:
            if c == ci:
                s[st:st + ln] = ord("N")
        seqs.append(s)
    return names, seqs


def write_fasta(path, names, seqs, width=70):
    with open(path, "w") as f:
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n")
            b = seq.tobytes().decode()
            for i in range(0, len(b), width):
                f.write(b[i:i + width] + "\n")


def sample_reads(rng, names, seqs, n_reads, read_len=100, err_rate=0.0,
                 paired=False, insert_lo=150, insert_hi=400,
                 indel_rate=0.0, max_indel=4):
    """Reads (and mates) sampled uniformly from the contigs, FR
    orientation flipped at random: (seq, mate or None, truth)."""
    import numpy as np
    from pecaller_tpu_torch.ops.encode import revcomp_bytes
    bases = np.frombuffer(BASES, dtype=np.uint8)
    total = np.array([len(s) for s in seqs], dtype=np.int64)
    out = []
    for _ in range(n_reads):
        ci = int(rng.integers(0, len(seqs)))
        L = total[ci]
        ins = int(rng.integers(insert_lo, insert_hi)) if paired else read_len
        ins = min(ins, L)
        start = int(rng.integers(0, max(1, L - ins + 1)))
        frag = seqs[ci][start:start + ins]

        def mutate(s):
            s = s.copy()
            if err_rate > 0:
                mask = rng.random(len(s)) < err_rate
                idx = np.nonzero(mask)[0]
                s[idx] = bases[rng.integers(0, 4, size=len(idx))]
            if indel_rate > 0 and rng.random() < indel_rate and len(s) > 20:
                p = int(rng.integers(10, len(s) - 10))
                k = int(rng.integers(1, max_indel + 1))
                if rng.random() < 0.5:
                    s = np.concatenate([s[:p], s[p + k:]])
                else:
                    insseq = bases[rng.integers(0, 4, size=k)]
                    s = np.concatenate([s[:p], insseq, s[p:]])
            return s

        r1 = mutate(frag[:read_len])
        if paired:
            r2 = mutate(revcomp_bytes(frag)[:read_len])
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            out.append((r1, r2, (ci, start, ins)))
        else:
            if rng.random() < 0.5:
                r1 = revcomp_bytes(r1)
            out.append((r1, None, (ci, start, ins)))
    return out


def write_fastq(path, reads, which=0):
    with open(path, "w") as f:
        for i, tup in enumerate(reads):
            s = tup[which].tobytes().decode()
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def make_data(n_pairs, data=DATA, length=GENOME_LEN, name="ecoli",
              seed=2024):
    """Genome, index and reads under ``data`` (made once; bench.py's
    E. coli configuration, or with phase 6's arguments its mid-size
    one).  Returns the seconds of the data and of the index build, or
    None where they were already made."""
    import numpy as np
    from pecaller_tpu_torch.index import build_index
    tag = os.path.join(data, f"ready_{n_pairs}")
    if os.path.exists(tag):
        return None
    os.makedirs(data, exist_ok=True)
    for f in os.listdir(data):
        if f.startswith("ready_"):
            os.remove(os.path.join(data, f))
    t0 = time.time()
    rng = np.random.default_rng(seed)
    names, seqs = make_genome(rng, [length], names=[name])
    fa = os.path.join(data, "genome.fa")
    write_fasta(fa, names, seqs)
    reads = sample_reads(rng, names, seqs, n_pairs, read_len=100,
                         err_rate=0.005, paired=True, insert_lo=150,
                         insert_hi=450, indel_rate=0.02, max_indel=4)
    write_fastq(os.path.join(data, "r1.fastq"), reads, which=0)
    write_fastq(os.path.join(data, "r2.fastq"), reads, which=1)
    t1 = time.time()
    build_index(fa, os.path.join(data, "g"), write_idx=False)
    open(tag, "w").close()
    return t1 - t0, time.time() - t1


def _run_dir(name, data=DATA):
    """A directory of links to the reads: each run writes
    <fastq>.mfile beside its inputs."""
    d = os.path.join(data, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for r in ("r1.fastq", "r2.fastq"):
        os.symlink(os.path.join(data, r), os.path.join(d, r))
    return d


def _background(fn):
    """Start ``fn()`` in a thread; the returned ``join()`` gives (its
    result, its seconds) or raises what it raised.  The host oracles run
    so beside the host index builds: a build holds one core, the
    oracle's native threads the rest; each is joined before anything is
    timed on the card."""
    import threading
    box = {}

    def run():
        t0 = time.time()
        try:
            box["out"] = fn()
        except BaseException as e:          # re-raised by join()
            box["err"] = e
        box["s"] = time.time() - t0
    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"], box["s"]
    return join


def _artifacts(d):
    out = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(os.path.join(d, "out" + ext), "rb") as f:
            out[ext] = f.read()
    for name in ("out.summary.txt", "r1.fastq.mfile", "r2.fastq.mfile"):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _argv(d, n_pairs, device, data=DATA):
    """The `pemapper` argv of a run under ``d``: the reference's own
    (the port's default, the device route) where ``device``, else with
    --host (the exact host engine, the oracle)."""
    threads = str(os.cpu_count() or 2)
    argv = [os.path.join(d, "out"), os.path.join(data, "g.sdx"), "p",
            os.path.join(d, "r1.fastq"), os.path.join(d, "r2.fastq"),
            "500", "0", "n", "0.9", threads, str(n_pairs),
            "--batch-size", str(BATCH)]
    return argv + ([] if device else ["--host"])


def _batches(n_pairs, data=DATA):
    from pecaller_tpu_torch.formats.fastq import FastqBatcher
    return list(FastqBatcher(os.path.join(data, "r1.fastq"),
                             os.path.join(data, "r2.fastq"),
                             batch_size=BATCH, max_reads=n_pairs).batches())


def _sync():
    """Wait for every card (a mesh's shards may sit on several)."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _rates(eng, batches, passes=3):
    """Reads/s of passes over the batches (the runner's 2 * group_k + 1
    in flight): the median of ``passes`` after a warm pass, or the warm
    pass alone when it takes over 30 s."""
    import torch

    host_s = {"enqueue": 0.0, "resolve": 0.0}
    depth = 2 * getattr(eng, "_group_k", 1) + 1

    def one_pass():
        t = time.time()
        pend, reads = [], 0
        host_s.update(enqueue=0.0, resolve=0.0)

        def resolve():
            t1 = time.time()
            eng.resolve(pend.pop(0))
            host_s["resolve"] += time.time() - t1
        for s1, l1, s2, l2, nos in batches:
            t1 = time.time()
            pend.append(eng.map_batch_async(s1, l1, s2, l2, read_nos=nos))
            host_s["enqueue"] += time.time() - t1
            reads += 2 * len(l1)
            if len(pend) >= depth:
                resolve()
        while pend:
            resolve()
        _sync()
        return reads / (time.time() - t), time.time() - t

    warm, secs = one_pass()
    if secs > 30:
        rates, how = [warm], "one pass (over 30 s)"
    else:
        rates = sorted(one_pass()[0] for _ in range(passes))
        how = (f"median of {passes} after a warm pass" if passes > 1
               else "one pass after a warm pass")
    # host seconds per batch of the last pass: enqueue (map_batch_async:
    # the input copies and the replay, or the eager step) and resolve
    # (waiting on the copy included)
    per_batch = {k: v / len(batches) for k, v in host_s.items()}
    return rates, how, per_batch


def _raw_outputs(eng, batches):
    """The raw outputs of ``batches``, all enqueued before the first is
    fetched: the v2 engines' (packed rows, insertion records, walk-tie
    records) a batch, v1's one block."""
    import numpy as np
    from pecaller_tpu_torch.mapper.device_map2 import (FusedMapperEngine2,
                                                       fetched)
    pend = [eng.map_batch_async(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in batches]
    if isinstance(eng, FusedMapperEngine2):
        return [[np.array(x) for x in eng._blocks(h)] for h in pend]
    return [[fetched(h)] for h in pend]


def _mesh_ms(done):
    """A mesh engine's host ms a batch from the spans of a stretch
    (``utils.log.spans_since``): staging and enqueuing the shards
    (dispatch), waiting for their results (fetch); empty off a mesh."""
    n = done.get("engine.enqueue.dispatch", (0, 0.0))[0]
    if not n:
        return {}
    return dict(
        mesh_dispatch_ms_per_batch=1e3 * done["engine.enqueue.dispatch"][1]
        / n,
        mesh_fetch_ms_per_batch=1e3 * done.get("engine.resolve.wait",
                                               (0, 0.0))[1] / n)


def _replay_ms(eng, dev, reps=5):
    """Device ms of one batch's graph (a reads mesh: every shard's, in
    shard order; a genome mesh: its program's graphs and copies on every
    card, timed on the first, which gathers the output last) by CUDA
    events over ``reps`` bare replays: the programs with the most calls,
    that is the main shape key's.  The replays add into the pileup
    counters and count no launch: run after the gates."""
    import torch
    progs = [p for p in eng.programs if p.capture_s is not None]
    most = max(p.calls for p in progs)
    progs = [p for p in progs if p.calls == most]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _sync()
    with torch.cuda.device(dev):
        start.record()
        for _ in range(reps):
            for p in progs:
                p.replay()
        end.record()
    _sync()
    return start.elapsed_time(end) / reps


def graph_vs_eager(graphed, eager, batches, dev, n_check=3):
    """The graphed engine of a gate run against the same engine built
    with graph=False: the raw outputs of the first ``n_check`` batches
    (one shape key: replays of the captured graph) bitwise; then, eager
    first, each engine's reads/s (``_rates``: the graphed engine's median
    of 3 after a warm pass, the eager one's one pass after a warm pass),
    host ms a batch, the peak
    device memory its passes allocated above what was allocated before
    them (other engines stay resident) and the memory reserved after
    them, the mesh's dispatch and fetch ms a batch; the graphs' capture
    and instantiate seconds, the bytes their pools hold, and one batch's
    replay in device ms."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.mapper.program import capture_stats
    from pecaller_tpu_torch.utils.log import spans, spans_since
    got = _raw_outputs(graphed, batches[:n_check])
    want = _raw_outputs(eager, batches[:n_check])
    for i, (a, b) in enumerate(zip(got, want)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"batch {i}: the graphed step's output "
                                 "differs from the eager step's")
    if capture_stats(eager.programs)["graphs"]:
        raise AssertionError("graph=False captured a graph")
    out = {"bitwise_batches": n_check}
    for name, eng in (("eager", eager), ("graph", graphed)):
        before = spans()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rates, how, per_batch = _rates(eng, batches,
                                       1 if name == "eager" else 3)
        r = dict(reads_per_s=rates[len(rates) // 2],
                 reads_per_s_passes=rates, spread=_spread(rates),
                 passes=how,
                 host_ms_per_batch={k: 1e3 * v for k, v in per_batch.items()},
                 peak_above_resident=torch.cuda.max_memory_allocated(dev)
                 - resident,
                 memory_reserved=torch.cuda.memory_reserved(dev))
        r.update(_mesh_ms(spans_since(before)))
        out[name] = r
    out["graph"].update(capture_stats(graphed.programs),
                        replay_ms_per_batch=_replay_ms(graphed, dev))
    out["graph_over_eager"] = (out["graph"]["reads_per_s"]
                               / out["eager"]["reads_per_s"])
    return out


def main_path(n_pairs):
    """Phase 4: the v2 path, graphed, and again with group_k=3, each
    against the host oracle; then graphed against eager.  Returns K1/K2
    launches of the gate run and the host oracle's engine (its pileup
    and insertion records serve phase 5)."""
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.index.nbr import load_nbr_index
    from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
    from pecaller_tpu_torch.mapper.runner import run_mapper
    from pecaller_tpu_torch.ops import sw_cuda

    t0 = time.time()
    make_data(n_pairs)
    t_data = time.time() - t0
    t0 = time.time()
    base = os.path.join(DATA, "g")
    index = load_index(base)
    # the host oracle: the same command line with --host (the exact host
    # engine), beside the nbr index build
    host_dir = _run_dir("host")
    oracle = _background(lambda: run_mapper(cli.parse_pemapper(
        _argv(host_dir, n_pairs, False))))
    nbr = load_nbr_index(base, index)          # build + cache .nbx parts
    t_nbr = time.time() - t0
    host, t_host = oracle()
    if type(host).__name__ != "MapperEngine":
        raise AssertionError(f"--host built {type(host).__name__}")
    batches = _batches(n_pairs)

    # the port's default route: `python -m pecaller_tpu_torch pemapper
    # ...` with no device flag (cli.parse_pemapper), in this process so
    # the kernel launch counters are readable; each shape key's step a
    # CUDA graph
    dev_dir = _run_dir("device")
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    sw_cuda.reset_launches()
    t0 = time.time()
    eng = run_mapper(cli.parse_pemapper(_argv(dev_dir, n_pairs, True)))
    torch.cuda.synchronize(dev)
    t_dev = time.time() - t0
    launches = dict(sw_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if not isinstance(eng, FusedMapperEngine2) or eng.device != dev:
        raise AssertionError(f"the flagless command line built "
                             f"{type(eng).__name__} on {eng.device}, not "
                             f"the v2 engine on {dev}")
    _check_launches("v2", launches, len(batches), ("sw_align_x",
                                                   "sw_tb_rows"))
    n_fallback, n_tiefix = eng.n_fallback, eng.n_tiefix

    want = _artifacts(host_dir)
    _gate("v2 graphed", _artifacts(dev_dir), want)
    if want["out.summary.txt"].count(b"\n") < 5 or not want[".pileup.gz"]:
        raise AssertionError("host oracle wrote empty artifacts")

    # group_k=3 (PECALLER_GROUP_K, as the reference reads it): three
    # batches of a key as one graph with one fetch, 7 batches in flight
    g3_dir = _run_dir("device_g3")
    os.environ["PECALLER_GROUP_K"] = "3"
    sw_cuda.reset_launches()
    try:
        t0 = time.time()
        eng3 = run_mapper(cli.parse_pemapper(_argv(g3_dir, n_pairs, True)))
        torch.cuda.synchronize(dev)
        t_g3 = time.time() - t0
    finally:
        del os.environ["PECALLER_GROUP_K"]
    _check_launches("v2 group_k=3", dict(sw_cuda.LAUNCHES), len(batches),
                    ("sw_align_x", "sw_tb_rows"))
    if not any(p.group == 3 and p.capture_s is not None
               for p in eng3.programs):
        raise AssertionError("group_k=3 captured no grouped program")
    _gate("v2 group_k=3", _artifacts(g3_dir), want)

    sdx = read_sdx(base + ".sdx")
    eager = FusedMapperEngine2(
        sdx, read_seq(base + ".seq", sdx.genome_size), index, nbr=nbr,
        device=dev, graph=False, paired=True, min_align=0.9, min_dist=0,
        max_dist=500, nthreads=os.cpu_count() or 2)
    cmp = graph_vs_eager(eng, eager, batches, dev)
    del eager
    rates3, how3, per_batch3 = _rates(eng3, batches)
    say("main_path", pairs=n_pairs, batch=BATCH, byte_equal=sorted(want),
        launches=launches, reads_per_s=cmp["graph"]["reads_per_s"],
        graph=cmp.pop("graph"), eager=cmp.pop("eager"), **cmp,
        group_k_3=dict(byte_equal=sorted(want),
                       reads_per_s=rates3[len(rates3) // 2],
                       reads_per_s_passes=rates3, spread=_spread(rates3),
                       passes=how3, host_ms_per_batch={
                           k: 1e3 * v for k, v in per_batch3.items()},
                       device_run_s=round(t_g3, 1)),
        n_fallback=n_fallback, n_tiefix=n_tiefix,
        max_memory_allocated=peak,
        seconds=dict(data=round(t_data, 1), nbr_index=round(t_nbr, 1),
                     device_run=round(t_dev, 1), host_run=round(t_host, 1)))
    del eng, eng3
    torch.cuda.empty_cache()
    return launches, host


def _check_launches(what, launches, n_batches, kernels, per_batch=1):
    """Each of ``kernels`` launched ``per_batch`` times a batch in the
    run, replays of the captured graphs included."""
    for k in kernels:
        if launches[k] != per_batch * n_batches:
            raise AssertionError(
                f"{what}: {k} counted {launches[k]} launches for "
                f"{n_batches} batches ({launches})")


def tie_local_pileup(p_ref, p_dev, max_width=8, max_frac=0.01):
    """The rule of tests/util.py assert_tie_local_pileup (copied): the
    device and oracle pileups may differ only by exact-score-tie shifts,
    short clusters of rows whose per-column sums cancel.  One extension
    for the v1 engine, which has no tie re-walk: a cluster may also trade
    counts between the four base columns when its base total, deletions
    and insertions cancel.  That is a tie-rotated insertion: the int DP
    and the f64 oracle insert different read bases at the same score,
    so different read bases land on the reference rows.  Returns (rows
    that differ, the rotated clusters as (first row, column sums))."""
    import numpy as np
    d = p_dev.astype(np.int64) - p_ref.astype(np.int64)
    if d[:, :4].sum() != 0 or (d[:, 4:].sum(axis=0) != 0).any():
        raise AssertionError("global totals differ")
    nz = np.nonzero(d.any(axis=1))[0]
    nnz = max(int((p_ref.sum(1) > 0).sum()), 1)
    if len(nz) > max(4, int(nnz * max_frac)):
        raise AssertionError(f"{len(nz)} differing rows of {nnz}")
    rotated = []
    if len(nz) == 0:
        return 0, rotated
    splits = np.nonzero(np.diff(nz) > max_width)[0]
    for cl in np.split(nz, splits + 1):
        width = int(cl[-1] - cl[0]) + 1
        if width > max_width:
            raise AssertionError(f"diff cluster at {cl[0]} spans {width} "
                                 "rows")
        col = d[cl[0]:cl[-1] + 1].sum(axis=0)
        if (col == 0).all():
            continue
        if col[:4].sum() != 0 or (col[4:] != 0).any():
            raise AssertionError(f"cluster at {cl[0]} does not cancel: "
                                 f"{col.tolist()}")
        rotated.append((int(cl[0]), col.tolist()))
    return len(nz), rotated


def v1_path(n_pairs, host):
    """Phase 5: the fused v1 engine on phase 4's genome and reads,
    graphed, against phase 4's host oracle artifacts; then graphed
    against eager on the first V1_RATE_BATCHES batches.  Returns K3's
    launches."""
    import numpy as np
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.mapper.device_pipeline import FusedMapperEngine
    from pecaller_tpu_torch.mapper.runner import map_files
    from pecaller_tpu_torch.ops import sw_cuda

    v1_dir = _run_dir("v1")
    cfg = cli.parse_pemapper(_argv(v1_dir, n_pairs, True))
    dev = torch.device("cuda", 0)
    sdx = read_sdx(cfg.sdx_path)
    genome = read_seq(os.path.join(DATA, "g.seq"), sdx.genome_size)
    index = load_index(os.path.join(DATA, "g"))
    kw = dict(device=dev, bisulfite=cfg.bisulfite, min_align=cfg.min_align,
              min_dist=cfg.min_dist, max_dist=cfg.max_dist,
              paired=cfg.paired, nthreads=cfg.nthreads)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = FusedMapperEngine(sdx, genome, index, **kw)
    t_build = time.time() - t0
    batches = _batches(n_pairs)
    sw_cuda.reset_launches()
    t0 = time.time()
    map_files(cfg, eng, sdx, genome)
    torch.cuda.synchronize(dev)
    t_run = time.time() - t0
    launches = dict(sw_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    _check_launches("v1", launches, len(batches), ("sw_align",), 2)
    n_fallback = eng.n_fallback

    got, want = _artifacts(v1_dir), _artifacts(os.path.join(DATA, "host"))
    diff = [k for k in ("out.summary.txt", "r1.fastq.mfile",
                        "r2.fastq.mfile") if got[k] != want[k]]
    if diff:
        raise AssertionError(f"v1 artifacts differ from the host "
                             f"oracle's: {diff}")
    n_tie_rows, rotated = tie_local_pileup(host.final_pileup(),
                                           eng.final_pileup())
    ins_h = sorted((k, len(s)) for k, _, s in host.ins_records)
    ins_v = sorted((k, len(s)) for k, _, s in eng.ins_records)
    if ins_h != ins_v:
        raise AssertionError("v1 insertion records differ from the host "
                             "oracle's (read, length) multiset")
    pileup_equal = got[".pileup.gz"] == want[".pileup.gz"]

    # reads/s over the first V1_RATE_BATCHES batches: four eager passes
    # over all 13 took ~46 s of the smoke's time limit
    eager = FusedMapperEngine(sdx, genome, index, graph=False, **kw)
    cmp = graph_vs_eager(eng, eager, batches[:V1_RATE_BATCHES], dev)
    del eager
    say("v1_path", pairs=n_pairs, batch=BATCH,
        byte_equal=["out.summary.txt", "r1.fastq.mfile", "r2.fastq.mfile"]
        + ([".pileup.gz"] if pileup_equal else []),
        pileup_rows_tie_shifted=n_tie_rows,
        tie_rotated_insertion_clusters=rotated, insertions=len(ins_v),
        launches=launches, batches=len(batches),
        rate_batches=len(batches[:V1_RATE_BATCHES]),
        reads_per_s=cmp["graph"]["reads_per_s"], graph=cmp.pop("graph"),
        eager=cmp.pop("eager"), **cmp, n_fallback=n_fallback,
        max_memory_allocated=peak,
        seconds=dict(engine_build=round(t_build, 1),
                     device_run=round(t_run, 1)))
    del eng
    torch.cuda.empty_cache()
    return launches


def _octile_shards(index, data=MID):
    """Phase 10's two octile shards of ``data``'s genome (host build)."""
    from pecaller_tpu_torch.formats.sdx import read_sdx
    from pecaller_tpu_torch.index.shard import build_octile_shards, plan_shards
    sdx = read_sdx(os.path.join(data, "g.sdx"))
    return build_octile_shards(index, plan_shards(sdx, 2))


def mid_path(n_pairs):
    """Phase 6: the v2.5 path (v2 step on the quartered-key index) at the
    bench's mid size, through the port's command line, graphed; then
    graphed against eager.  Returns K1/K2 launches, the host oracle's
    engine (phase 7's reference) and phase 10's octile shards with their
    build seconds (built beside the quartered-key build and the
    oracle)."""
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.index.quarter import load_quarter_index
    from pecaller_tpu_torch.mapper.device_map2 import (FusedMapperEngine2,
                                                       QuarterDeviceIndex)
    from pecaller_tpu_torch.mapper.runner import run_mapper
    from pecaller_tpu_torch.ops import sw_cuda

    made = make_data(n_pairs, data=MID, length=MID_LEN, name="chr21x",
                     seed=2025)
    base = os.path.join(MID, "g")
    t0 = time.time()
    index = load_index(base)
    host_dir = _run_dir("host", MID)         # the oracle, beside the build
    oracle = _background(lambda: run_mapper(cli.parse_pemapper(
        _argv(host_dir, n_pairs, False, MID))))
    octile = _background(lambda: _octile_shards(index))
    qi = load_quarter_index(base, index)             # build + cache .q4x
    t_quarter = time.time() - t0
    host, t_host = oracle()
    octile_built = octile()
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    dq = QuarterDeviceIndex(qi, dev)
    torch.cuda.synchronize(dev)
    t_upload = time.time() - t0
    q_bytes = sum(a.numel() * a.element_size() for a in dq.args)
    del dq
    torch.cuda.empty_cache()

    dev_dir = _run_dir("device", MID)
    torch.cuda.reset_peak_memory_stats(dev)
    sw_cuda.reset_launches()
    t0 = time.time()
    eng = run_mapper(cli.parse_pemapper(_argv(dev_dir, n_pairs, True,
                                              MID)))
    torch.cuda.synchronize(dev)
    t_dev = time.time() - t0
    launches = dict(sw_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if getattr(eng.state.dnbr, "mode", None) != "quarter":
        raise AssertionError(f"the runner took {type(eng).__name__}, not "
                             "the v2 engine on the quartered-key index")
    batches = _batches(n_pairs, MID)
    _check_launches("v2.5", launches, len(batches), ("sw_align_x",
                                                     "sw_tb_rows"))
    n_fallback, n_tiefix = eng.n_fallback, eng.n_tiefix
    n_cap = eng.n_cap_fallback

    got, want = _artifacts(dev_dir), _artifacts(host_dir)
    diff = [k for k in want if got[k] != want[k]]
    if diff:
        raise AssertionError(f"v2.5 artifacts differ from the host "
                             f"oracle's: {diff}")
    if want["out.summary.txt"].count(b"\n") < 5 or not want[".pileup.gz"]:
        raise AssertionError("host oracle wrote empty artifacts")

    sdx = read_sdx(base + ".sdx")
    eager = FusedMapperEngine2(
        sdx, read_seq(base + ".seq", sdx.genome_size), index, quarter=qi,
        device=dev, graph=False, paired=True, min_align=0.9, min_dist=0,
        max_dist=500, nthreads=os.cpu_count() or 2)
    cmp = graph_vs_eager(eng, eager, batches, dev)
    del eager, qi
    say("mid_path", genome=MID_LEN, pairs=n_pairs, batch=BATCH,
        index="quarter", byte_equal=sorted(want), launches=launches,
        reads_per_s=cmp["graph"]["reads_per_s"], graph=cmp.pop("graph"),
        eager=cmp.pop("eager"), **cmp, n_fallback=n_fallback,
        n_tiefix=n_tiefix, n_cap_fallback=n_cap, quarter_bytes=q_bytes,
        max_memory_allocated=peak,
        seconds=dict(data=made and round(made[0], 1),
                     exact_index=made and round(made[1], 1),
                     quarter_index=round(t_quarter, 1),
                     upload=round(t_upload, 3), device_run=round(t_dev, 1),
                     host_run=round(t_host, 1)))
    del eng
    torch.cuda.empty_cache()
    return launches, host, octile_built


def _split_timers(eng, keep=False):
    """Time the split engine ``eng``'s batches, seed step and traceback
    on the host clock: returns lists of seconds a call (``batch``,
    ``seed``: the host seeder, or the device step's dispatch and its
    wait, both ends dispatched before the first wait; ``traceback``: the
    program's input copies, replay and the wait for its records), and
    with ``keep`` the outputs of each seed step and traceback (``seeds``,
    ``rec``, host arrays in call order)."""
    import numpy as np
    acc = {"batch": [], "seed": [], "traceback": []}
    if keep:
        acc.update(seeds=[], rec=[])

    def timer(name, what, out=None):
        fn = getattr(eng, name)

        def run(*a, **k):
            t = time.time()
            res = fn(*a, **k)
            acc[what].append(time.time() - t)
            if out is not None:
                acc[out].append([np.array(x) for x in (
                    res if isinstance(res, tuple) else (res,))])
            return res
        setattr(eng, name, run)
    timer("map_batch", "batch")
    if eng._seed_fns is None:
        timer("_initial_map", "seed")
    else:
        timer("_initial_map_dispatch", "seed")
        timer("_initial_map_resolve", "seed", "seeds" if keep else None)
    timer("_traceback", "traceback", "rec" if keep else None)
    return acc


def _split_rate(acc, batches):
    """Reads/s of the batches' map_batch seconds, and host seconds a
    batch of the seed step, the traceback and the whole batch."""
    n = len(batches)
    return dict(reads_per_s=2 * sum(len(b[1]) for b in batches)
                / sum(acc["batch"]),
                host_s_per_batch={k: sum(acc[k]) / n for k in (
                    "seed", "traceback", "batch")},
                traceback_calls=len(acc["traceback"]))


def split_graph_vs_eager(graphed, eager, batches, dev):
    """The split engine of a gate run (device seeds, graphed) against one
    built with graph=False on the same seed index: both map every batch
    once (eager first; the graphed engine's counters and records reset,
    its programs captured in the gate run, so its keys replay); every
    seed step's and traceback's output, the final pileup and the
    insertion records bitwise; reads/s and host seconds a batch of each
    (``_split_rate``); the graphs' capture and instantiate seconds and
    pool bytes."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.mapper.program import capture_stats
    graphed.reset_group()
    out, seen = {}, {}
    for name, eng in (("eager", eager), ("graph", graphed)):
        acc = _split_timers(eng, keep=True)
        for s1, l1, s2, l2, nos in batches:
            eng.map_batch(s1, l1, s2, l2, read_nos=nos)
        torch.cuda.synchronize(dev)
        seen[name] = (acc["seeds"], acc["rec"], eng.final_pileup(),
                      sorted(eng.ins_records))
        out[name] = _split_rate(acc, batches)
    for i, what in enumerate(("seed step", "traceback")):
        a, b = seen["graph"][i], seen["eager"][i]
        if len(a) != len(b) or not all(
                np.array_equal(x, y) for u, v in zip(a, b)
                for x, y in zip(u, v)):
            raise AssertionError(f"the graphed {what}'s outputs differ "
                                 "from the eager one's")
    if not np.array_equal(seen["graph"][2], seen["eager"][2]) or \
            seen["graph"][3] != seen["eager"][3]:
        raise AssertionError("graphed and eager split engines' pileups or "
                             "insertion records differ")
    if capture_stats(eager.programs)["graphs"]:
        raise AssertionError("graph=False captured a graph")
    out["graph"].update(capture_stats(graphed.programs))
    out.update(bitwise_batches=len(batches),
               bitwise_seed_steps=len(seen["graph"][0]),
               bitwise_tracebacks=len(seen["graph"][1]),
               graph_over_eager=out["graph"]["reads_per_s"]
               / out["eager"]["reads_per_s"])
    return out


def _keep_batches(eng, acc, n):
    """Keep the outputs of ``eng``'s first ``n`` map_batch calls, each
    with the traceback records it made (``acc["rec"]`` of
    ``_split_timers(keep=True)``): a list of (outputs, records)."""
    import numpy as np
    kept, fn = [], eng.map_batch

    def run(*a, **k):
        r0 = len(acc["rec"])
        res = fn(*a, **k)
        if len(kept) < n:
            kept.append(([np.array(x) for x in res], acc["rec"][r0:]))
        return res
    eng.map_batch = run
    return kept


def split_path(n_pairs, host):
    """Phase 7: the split engine on phase 6's data with device seeds,
    its seed steps and tracebacks graphed, gated as v1 against phase 6's
    host oracle; then with host seeds (the runner's configuration at
    2^30 bases and more) over the first SPLIT_HOST_BATCHES batches, each
    batch's codes, m1, m2 and traceback records bitwise to the
    device-seed run's on that batch (tests/test_torch_split.py's
    test_host_and_device_seeds_agree holds the two seeders equal over
    whole runs); then the device-seed engine against graph=False
    (``split_graph_vs_eager``).  Returns K3's launches summed over both
    runs and the graphs' pool bytes of each."""
    import numpy as np
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.mapper.device_engine import DeviceMapperEngine
    from pecaller_tpu_torch.mapper.program import capture_stats
    from pecaller_tpu_torch.mapper.runner import map_files
    from pecaller_tpu_torch.ops import sw, sw_cuda

    dev = torch.device("cuda", 0)
    sdx = read_sdx(os.path.join(MID, "g.sdx"))
    genome = read_seq(os.path.join(MID, "g.seq"), sdx.genome_size)
    index = load_index(os.path.join(MID, "g"))
    batches = _batches(n_pairs, MID)
    p_host = host.final_pileup()
    ins_h = sorted((k, len(s)) for k, _, s in host.ins_records)
    want = _artifacts(os.path.join(MID, "host"))
    k3_launches, pools = 0, {}
    align = sw_cuda.sw_align
    kept = {}
    for seeds in ("device", "host"):
        d = _run_dir(f"split_{seeds}", MID)
        cfg = cli.parse_pemapper(_argv(d, n_pairs, True, MID))
        kw = dict(bisulfite=cfg.bisulfite, min_align=cfg.min_align,
                  min_dist=cfg.min_dist, max_dist=cfg.max_dist,
                  paired=cfg.paired, nthreads=cfg.nthreads)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        eng = DeviceMapperEngine(
            sdx, genome, index, device=dev, device_seeds=seeds == "device",
            **kw)
        t_build = time.time() - t0
        # the engine's largest K3 call
        seen = {}

        def k3(refs, *a, **k):
            if refs.shape[0] >= seen.get("lanes", 0):
                seen.update(lanes=refs.shape[0], args=(refs, *a), kw=k)
            return align(refs, *a, **k)
        acc = _split_timers(eng, keep=True)
        kept[seeds] = _keep_batches(eng, acc, SPLIT_HOST_BATCHES)
        run = batches if seeds == "device" else batches[:SPLIT_HOST_BATCHES]
        sw_cuda.sw_align = k3
        try:
            sw_cuda.reset_launches()
            t0 = time.time()
            if seeds == "device":
                map_files(cfg, eng, sdx, genome)
            else:
                for s1, l1, s2, l2, nos in run:
                    eng.map_batch(s1, l1, s2, l2, read_nos=nos)
            torch.cuda.synchronize(dev)
            t_run = time.time() - t0
            launches = dict(sw_cuda.LAUNCHES)
        finally:
            sw_cuda.sw_align = align
        if launches["sw_align"] != 2 * len(run):
            raise AssertionError(f"K3 launched {launches['sw_align']} "
                                 f"times for {len(run)} batches")
        k3_launches += launches["sw_align"]
        gate = {}
        if seeds == "device":
            got = _artifacts(d)
            diff = [k for k in ("out.summary.txt", "r1.fastq.mfile",
                                "r2.fastq.mfile") if got[k] != want[k]]
            if diff:
                raise AssertionError(f"split ({seeds} seeds) artifacts "
                                     f"differ from the host oracle's: {diff}")
            n_tie_rows, rotated = tie_local_pileup(p_host,
                                                   eng.final_pileup())
            ins_s = sorted((k, len(s)) for k, _, s in eng.ins_records)
            if ins_s != ins_h:
                raise AssertionError(
                    f"split ({seeds} seeds) insertion records differ from "
                    "the host oracle's (read, length) multiset")
            gate = dict(
                byte_equal=["out.summary.txt", "r1.fastq.mfile",
                            "r2.fastq.mfile"]
                + ([".pileup.gz"] if got[".pileup.gz"] == want[".pileup.gz"]
                   else []),
                pileup_rows_tie_shifted=n_tie_rows,
                tie_rotated_insertion_clusters=rotated,
                insertions=len(ins_s))
        else:
            for i, ((a, ra), (b, rb)) in enumerate(zip(kept["host"],
                                                       kept["device"])):
                if len(a) != len(b) or not all(
                        np.array_equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"split batch {i}: host seeds' "
                                         "codes, m1 or m2 differ from "
                                         "device seeds'")
                if len(ra) != len(rb) or not all(
                        np.array_equal(x, y) for u, v in zip(ra, rb)
                        for x, y in zip(u, v)):
                    raise AssertionError(f"split batch {i}: host seeds' "
                                         "traceback records differ from "
                                         "device seeds'")
            gate = dict(bitwise_to_device_seeds=dict(
                batches=len(kept["host"]),
                what="codes, m1, m2 and traceback records a batch"))
        n_fallback = eng.n_fallback
        peak = torch.cuda.max_memory_allocated(dev)
        # map_batch returns the batch's result on the host, so its
        # seconds are the batch's; the first batch is timed too (the
        # kernels were built and loaded in phase 3)
        rate, batch_s = _split_rate(acc, run), list(acc["batch"])
        graphs = capture_stats(eng.programs)
        if not graphs["graphs"]:
            raise AssertionError(f"split ({seeds} seeds): no program "
                                 "captured a graph")
        pools[seeds] = graphs["pool_bytes"]

        k3_at, cmp = {}, {}
        if seeds == "device":
            # K3 at the engine's shape: kernel against plain, bitwise,
            # timed
            args, kw3 = seen["args"], seen["kw"]
            refs, bl, reads, rl = args
            nr = kw3["n_rows"]
            kk = align(*args, **kw3)
            pp = sw.sw_align_device(*args, **kw3)
            err = _max_abs_err(kk, pp)
            if err:
                raise AssertionError(f"K3 != plain at the split engine's "
                                     f"shape {tuple(refs.shape)} x "
                                     f"{reads.shape[1]}")
            cells = int((torch.clamp(bl, 0, nr).long()
                         * rl.clamp(0, reads.shape[1]).long()).sum())
            k3_at = dict(
                shape=[refs.shape[0], refs.shape[1], reads.shape[1], nr],
                group=sw_cuda.load_kernels().sw_lane_group(reads.shape[1]),
                cols=sw_cuda.load_kernels().sw_lane_cols(reads.shape[1], 0),
                max_abs_err=err, ms=_timed(lambda: align(*args, **kw3), 5),
                plain_ms=_timed(lambda: sw.sw_align_device(*args, **kw3),
                                2),
                bound=bound_ms("sw_align", cells, sum(
                    x.numel() * x.element_size() for x in args),
                    sum(x.numel() * x.element_size() for x in kk)))
            del kk, pp, args
            eager = DeviceMapperEngine(sdx, genome, index, device=dev,
                                       graph=False, seed_index=eng._dindex,
                                       **kw)
            cmp = split_graph_vs_eager(eng, eager, batches, dev)
            del eager
        del seen
        say("split_path", seeds=seeds, genome=MID_LEN, pairs=n_pairs,
            batch=BATCH, **gate, launches=launches, batches=len(run),
            k3=k3_at, **rate, batch_s=batch_s,
            passes="the run's batches (map_batch seconds), graphed",
            graphs=graphs, **cmp, n_fallback=n_fallback,
            max_memory_allocated=peak,
            seconds=dict(engine_build=round(t_build, 1),
                         device_run=round(t_run, 1)))
        del eng, acc
        torch.cuda.empty_cache()
    return k3_launches, pools


def human_counts(gs=HUMAN_LEN, edges=(2 ** 30, 2 ** 31), split_pools=None):
    """Phase 7b: the split engine's pileup counters at hg38 scale, 2
    bytes a cell, on the card; pileup_scatter with sw_traceback_scatter's
    event layout (lanes of window rows from an int64 start) at starts on
    both sides of 2^30 and 2^31 and in the genome's last window (rows
    past its end dropped), one cell pushed past 65,535, as a program
    that adds the events and reads the touched rows back (the counters
    captured by address, as the engine's traceback program holds them):
    called three times (eager, captured and replayed, replayed), the
    touched rows after each call against np.add.at on uint16; its
    graph's pool bytes beside the counters' and the split engine's
    programs' (phase 7, ``split_pools``)."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.mapper.program import StepProgram
    from pecaller_tpu_torch.ops import sw
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    counts = torch.zeros((gs, 6), dtype=torch.int16, device=dev)
    torch.cuda.synchronize(dev)
    t_alloc = time.time() - t0
    rng = np.random.default_rng(7)
    T = 250                                   # walk steps of a 128-row lane
    e30, e31 = edges
    starts = np.array([e30 - 130, e30 - 1, e30, e31 - 130, e31 - 1, e31,
                       gs - 121, gs - 60, gs - 1, 5, 2 ** 32 + 17], np.int64)
    starts = np.concatenate([starts, rng.integers(0, gs - 130, 53)])
    B = len(starts)
    rows = np.where(rng.random((B, T)) < 0.6,
                    np.minimum(np.arange(T) // 2, 127)[None, :], -1)
    kind = rng.integers(0, 6, (B, T)).astype(np.int8)
    ins = (rng.random((B, T)) < 0.05) & (rows >= 0)
    ev_abs = np.where(rows >= 0, rows + starts[:, None], -1).reshape(-1)
    kind, ins = kind.reshape(-1), ins.reshape(-1)
    # one cell near the wrap, then 9 more events on it a call
    hot = e31 + 3
    counts[hot, 2] = 65530 - 65536
    ev_abs = np.concatenate([ev_abs, np.full(9, hot)])
    kind = np.concatenate([kind, np.full(9, 2, np.int8)])
    ins = np.concatenate([ins, np.zeros(9, bool)])

    inb = (ev_abs >= 0) & (ev_abs < gs)
    touched = np.unique(np.concatenate([ev_abs[inb], [hot]]))
    base = np.zeros((len(touched), 6), np.int64)
    base[np.searchsorted(touched, hot), 2] = 65530
    add = np.zeros((len(touched), 6), np.int64)
    r = np.searchsorted(touched, ev_abs[inb])
    k = kind[inb].astype(np.int64)
    np.add.at(add, (r[k < 5], k[k < 5]), 1)
    np.add.at(add, (r[ins[inb]], 5), 1)

    def step(e, kd, i, rows_):
        return sw.pileup_scatter(e, kd, i, counts)[rows_]
    prog = StepProgram(step, dev)
    secs = []
    for call in (1, 2, 3):
        t0 = time.time()
        got = prog([(ev_abs, kind, ins, touched)])[0].cpu().numpy().view(
            np.uint16)
        secs.append(time.time() - t0)
        want = ((base + call * add) & 0xFFFF).astype(np.uint16)
        if not np.array_equal(got, want):
            bad = np.nonzero((got != want).any(axis=1))[0]
            raise AssertionError(
                f"call {call}: {len(bad)} touched rows differ from "
                f"np.add.at, first at {int(touched[bad[0]])}")
    if prog.capture_s is None:
        raise AssertionError("the counters' program captured no graph")
    # nothing else changed: the card's nonzero cells, counted in slices
    nz = sum(int(torch.count_nonzero(counts[i:i + (1 << 28)]))
             for i in range(0, gs, 1 << 28))
    if nz != int(np.count_nonzero(want)):
        raise AssertionError("counts outside the touched rows changed")
    say("human_counts", genome=gs, shape=[gs, 6], dtype="int16",
        counts_bytes=counts.numel() * counts.element_size(),
        events=int(inb.sum()), rows_touched=len(touched),
        past_2_31=int((touched >= e31).sum()),
        wrapped=int(got[np.searchsorted(touched, hot), 2]),
        calls=["eager", "captured and replayed", "replayed"],
        graph_pool_bytes=prog.pool_bytes,
        split_engine_pool_bytes=split_pools,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        seconds=dict(alloc=round(t_alloc, 3),
                     calls=[round(x, 4) for x in secs]))
    del counts, prog
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the caller (phases 8 and 8b)

CALL_SAMPLES = 3
CALL_DEPTH = 30
# phase 8b: (samples, sites) of one full screen chunk each
SCREEN_CHUNKS = ((3, 1 << 18), (64, 1 << 15))
# phase 8b: tails in two smaller buckets (2^11 and 2^13 sites)
SCREEN_TAILS = (1500, 5000)
# the f32 error the screen's band allows for (caller/device_screen.py)
SCREEN_TOL = 0.15


def make_call_data(data=DATA):
    """bench.py's caller cohort (bench.py:142-197) over phase 4's genome,
    written once under .smoke/callbench/ with the port's formats: 3
    samples, Poisson depth 30 (seed 77), SNPs at 1/1500, deletions and
    insertions at 1/8000 each, errors Poisson(0.005 x depth), genotypes
    0/1/2.  Returns the directory and the seconds it took (None where it
    was already made)."""
    import numpy as np
    from pecaller_tpu_torch.formats.pileup import write_pileup
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    cb = os.path.join(data, "callbench")
    tag = os.path.join(cb, "ready")
    if os.path.exists(tag):
        return cb, None
    t0 = time.time()
    shutil.rmtree(cb, ignore_errors=True)
    os.makedirs(cb)
    sdx = read_sdx(os.path.join(data, "g.sdx"))
    genome = read_seq(os.path.join(data, "g.seq"), sdx.genome_size)
    gs = sdx.genome_size
    lut = np.full(256, -1, np.int16)
    for ch, i in zip(b"ACGT", range(4)):
        lut[ch] = i
    ref = lut[genome]
    ok = ref >= 0
    rng = np.random.default_rng(77)
    is_snp = rng.random(gs) < 1 / 1500
    alt = (ref + rng.integers(1, 4, gs)) % 4
    is_del = rng.random(gs) < 1 / 8000
    is_ins = rng.random(gs) < 1 / 8000
    pos_all = np.arange(gs, dtype=np.uint32)
    for s in range(CALL_SAMPLES):
        depth = rng.poisson(CALL_DEPTH, gs).astype(np.int32)
        cnt = np.zeros((gs, 6), np.int32)
        rows = np.arange(gs)
        rc = np.maximum(ref, 0)
        cnt[rows, rc] = depth
        err = np.minimum(rng.poisson(0.005 * CALL_DEPTH, gs), depth)
        ecol = (ref + rng.integers(1, 4, gs)) % 4
        cnt[rows, rc] -= err
        cnt[rows, ecol] += err
        gt = rng.integers(0, 3, gs)
        m = is_snp & (gt > 0)
        half = np.where(gt[m] == 1, cnt[m, :4].max(1) // 2,
                        cnt[m, :4].max(1))
        cnt[np.nonzero(m)[0], alt[m]] += half
        cnt[np.nonzero(m)[0], rc[m]] -= half
        md = is_del & (gt > 0)
        cnt[md, 4] = np.where(gt[md] == 1, depth[md] // 2, depth[md])
        cnt[np.nonzero(md)[0], rc[md]] -= cnt[md, 4]
        mi = is_ins & (gt > 0)
        cnt[mi, 5] = np.where(gt[mi] == 1, depth[mi] // 2, depth[mi])
        cnt = np.clip(cnt, 0, 65535).astype(np.uint16)
        keep = ok & (depth > 0)
        write_pileup(os.path.join(cb, f"s{s}.pileup.gz"),
                     pos_all[keep], cnt[keep])
    for f in ("g.sdx", "g.seq"):
        shutil.copy(os.path.join(data, f), os.path.join(cb, f))
    open(tag, "w").close()
    return cb, time.time() - t0


def _call_artifacts(base):
    out = {}
    for ext in (".snp", ".dist", ".base.gz", ".piles.gz"):
        with open(base + ext, "rb") as f:
            raw = f.read()
        out[ext] = gzip.decompress(raw) if ext.endswith(".gz") else raw
    return out


def _call_gate(route, base, want):
    got = _call_artifacts(base)
    diff = [k for k in want if got[k] != want[k]]
    if diff:
        raise AssertionError(f"caller route {route}: {diff} differ from "
                             "the exact path's")


def _call_passes(run, n=3):
    """sites/s of ``run()`` (which returns run_caller's result): the
    median of ``n`` passes after a warm pass, the passes, and the median
    pass's result."""
    run()
    passes = []
    for _ in range(n):
        t0 = time.time()
        res = run()
        passes.append((res["n_sites"] / (time.time() - t0), res))
    passes.sort(key=lambda p: p[0])
    return passes[n // 2][0], [p[0] for p in passes], passes[n // 2][1]


def caller_path(n_pairs, data=DATA):
    """Phase 8: the caller on bench.py's 3-sample cohort over phase 4's
    4.6 Mb genome.  The exact native engine on every callable site (no
    screen: device_screen and host_screen False) is the oracle; (a) the
    port's command line `pecaller pileup g.sdx 3 ours 0.95 0.001 n
    <threads> n` (phase 0 on the host, phase 1 on the card where a
    window's UNRES sites exceed the small-set rule) and (b) both screen
    phases on the card
    (host_screen False) must each give the oracle's artifacts byte for
    byte, the screen's (phase, bucket) steps as device programs; then
    route (b) with graph=False, gated the same, one pass after a warm
    pass."""
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.caller import CallerConfig, run_caller
    threads = os.cpu_count() or 2
    dev = torch.device("cuda", 0)
    # what earlier phases still hold on the card: the peaks below
    # include it
    held = torch.cuda.memory_allocated(dev)
    cb, want, t_data, t_exact = call_oracle(n_pairs, data)

    routes = {}
    # (a): the default route, through the command line (the run reads
    # the pileups of its working directory)
    argv = ["pileup", "g.sdx", str(CALL_SAMPLES), "ours", "0.95", "0.001",
            "n", str(threads + 1), "n"]
    cwd = os.getcwd()
    os.chdir(cb)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        if cli.main(["pecaller", *argv]) != 0:
            raise AssertionError("pecaller exited non-zero")
        _call_gate("a", os.path.join(cb, "ours"), want)
        routes["a"] = _call_passes(
            lambda: run_caller(cli.parse_pecaller(argv))) + (
            torch.cuda.max_memory_allocated(dev),)
    finally:
        os.chdir(cwd)
    # (b): both screen phases on the card
    cfg_b = CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(cb, "both"), directory=cb, nthreads=threads,
        host_screen=False)
    torch.cuda.reset_peak_memory_stats(dev)
    run_caller(cfg_b)
    _call_gate("b", cfg_b.out_base, want)
    routes["b"] = _call_passes(lambda: run_caller(cfg_b)) + (
        torch.cuda.max_memory_allocated(dev),)
    if not routes["b"][2]["screen_sites"]["phase1"]:
        raise AssertionError("route b: phase 1 took no site on the card")
    if not routes["b"][2]["programs"]["screen"]["graphs"]:
        raise AssertionError("route b: the screen captured no graph")
    # (b) eager: the screen's steps with graph=False, one pass after a
    # warm pass, the same gate
    cfg_e = dataclasses.replace(cfg_b, out_base=os.path.join(cb, "eager"),
                                graph=False)
    eager_b = _call_passes(lambda: run_caller(cfg_e), 1)
    _call_gate("b eager", cfg_e.out_base, want)
    if eager_b[2]["programs"]["screen"]["graphs"]:
        raise AssertionError("graph=False captured a graph")

    out = {}
    for k, (rate, rates, res, peak) in routes.items():
        out[k] = dict(sites_per_s=rate, sites_per_s_passes=rates,
                      spread=(rates[-1] - rates[0]) / rate,
                      phases_s=res["phases"],
                      sites_on_card=res["screen_sites"],
                      codes=res["codes"], native_sites=res["native_sites"],
                      programs=res["programs"]["screen"],
                      max_memory_allocated=peak)
    out["b_eager"] = dict(sites_per_s=eager_b[0],
                          passes="one pass after a warm pass",
                          phases_s=eager_b[2]["phases"],
                          graph_over_eager=routes["b"][0] / eager_b[0])
    say("caller_path", samples=CALL_SAMPLES, sites=routes["a"][2]["n_sites"],
        byte_equal=sorted(want), passes="median of 3 after a warm pass",
        a_phase1_on_card="the card takes a window's phase 1 only where "
        "len(un) * indiv > 65536; not known for this data before the run",
        routes=out, exact_s=t_exact, data_s=t_data,
        memory_allocated_at_start=held)
    return cb, want


def screen_fuzz(rng, n, indiv):
    """(reads (n, indiv, 6) uint16, ref_int (n,) uint8, ctype (n,) uint8)
    at the screen's edges: tests/test_screen.py's kinds (shallow, het-ish,
    low-level errors, Del and Ins support around 3, hom-alt), a margin
    sweep (depth 8-48, 0-5 alt reads), depths around TMAX and DEPTH_GATE,
    counts of 32768 and more, argmax ties (equal alternate counts, no
    alternate read), references of 4 and 5 and chrY sites.  Plain sites
    (every read the reference base) have depth 8-59, so that with many
    samples some are EASY."""
    import numpy as np
    from pecaller_tpu_torch.caller.device_screen import (CMAX, DEPTH_GATE,
                                                         TMAX)
    shape = (n, indiv)
    ref = rng.integers(0, 4, n)
    ref = np.where(rng.random(n) < 0.03, rng.integers(4, 6, n), ref)
    ctype = np.where(rng.random(n) < 0.2, 2, 0).astype(np.uint8)
    kind = np.broadcast_to(rng.integers(0, 12, n)[:, None], shape)
    depth = np.select(
        [kind == 0, kind == 1, kind == 7, kind == 8, kind == 9, kind == 10],
        [rng.integers(8, 60, shape), rng.integers(0, 12, shape),
         rng.integers(TMAX - 2, TMAX + 3, shape),
         rng.integers(DEPTH_GATE - 3, DEPTH_GATE + 4, shape),
         rng.integers(32768, 65536, shape), rng.integers(8, 49, shape)],
        rng.integers(0, 40, shape))
    rc = np.broadcast_to(np.minimum(ref, 3)[:, None], shape)
    a1 = (rc + 1) % 4
    ar = (rc + rng.integers(1, 4, shape)) % 4
    c = np.zeros(shape + (6,), np.int64)
    r_ = np.arange(n)[:, None]
    i_ = np.arange(indiv)[None, :]
    c[r_, i_, rc] = depth
    het = rng.integers(0, 1 << 16, shape) % (depth + 1)
    sweep = rng.integers(0, 6, shape)
    few = rng.choice([0, 1, CMAX, CMAX + 1], shape)
    tie = rng.integers(0, 3, shape)
    # (kind, column, its count, reads taken from the reference column)
    for k, col, cnt, take in (
            (2, a1, np.where(depth > 2, het, 0),
             np.where(depth > 2, het // 2, 0)),
            (3, ar, rng.integers(0, 4, shape), 0),
            (4, 4, rng.integers(0, 6, shape), 0),
            (5, 5, rng.integers(0, 6, shape), 0),
            (6, (rc + 2) % 4, np.where(depth > 4, depth, 0),
             np.where(depth > 4, depth - rng.integers(0, 3, shape), 0)),
            (7, a1, few, few), (8, a1, few % 3, few % 3),
            (9, ar, rng.integers(0, 4, shape), 0),
            (10, ar, sweep, sweep), (11, a1, tie, 0),
            (11, (rc + 2) % 4, tie, 0)):
        m = kind == k
        c[r_, i_, np.broadcast_to(col, shape)] += np.where(m, cnt, 0)
        c[r_, i_, rc] -= np.where(m, take, 0)
    reads = np.clip(c, 0, 65535).astype(np.uint16)
    return reads, ref.astype(np.uint8), ctype


def screen_margins_f64(reads, ref_int, haploid):
    """Float64 pass-1 margins of every (site, sample) with the screen's
    tables (numpy, scipy.special.gammaln): (beam margin: the ref genotype
    over every alternate the beam may expand; ungated margin: over every
    alternate), each (S, I)."""
    import numpy as np
    from scipy.special import gammaln
    from pecaller_tpu_torch.caller.device_screen import _tables
    ta, tota, _ = _tables(haploid)
    n_sc, _, G, _ = ta.shape
    ta = ta.reshape(n_sc * 4, G, 6).astype(np.float64)
    tota = tota.reshape(n_sc * 4, G).astype(np.float64)
    a1 = gammaln(tota) - gammaln(ta).sum(-1)
    S, indiv, _ = reads.shape
    g = np.arange(G)
    mb = np.empty((S, indiv))
    ma = np.empty((S, indiv))
    step = max(1, (1 << 19) // indiv)
    for lo in range(0, S, step):
        r = reads[lo:lo + step].astype(np.int64)
        tot = r[..., :5].sum(-1)
        ref_b = np.minimum(ref_int[lo:lo + step].astype(np.int64),
                           3)[:, None]
        flat = (np.clip(tot, 10, 100) - 10) * 4 + ref_b
        like = (a1[flat] + gammaln(ta[flat] + r[:, :, None, :]).sum(-1)
                - gammaln(tota[flat] + (tot + r[..., 5])[..., None]))
        is_ref = g == ref_b[..., None]
        blocked = ((((g == 4) | (g == 12)) & (r[..., 4:5] < 3)) |
                   (((g == 5) | (g == 13)) & (r[..., 5:6] < 3)))
        like_ref = np.where(is_ref, like, -np.inf).max(-1)
        mb[lo:lo + step] = like_ref - np.where(is_ref | blocked, -np.inf,
                                               like).max(-1)
        ma[lo:lo + step] = like_ref - np.where(is_ref, -np.inf,
                                               like).max(-1)
    return mb, ma


def screen_contract(codes, ref_codes, reads, ref_int, ctype, haploid):
    """Hold phase-1 ``codes`` to the screen's contract: no site is EASY
    unless its float64 margins pass the exact criterion (every active
    sample's beam margin > 2.3 and, with 4 samples or more, its ungated
    margin > 0; the bad-base gates do not fire, the reference is A, C,
    G or T, no sample is deeper than DEPTH_GATE), and ``codes`` equal
    ``ref_codes`` except at sites where an active sample's float64
    margin lies within SCREEN_TOL of a threshold (2.3 + BAND; BAND for
    the ungated margin).  Raises where it does not hold; returns the
    number of sites whose codes differ."""
    import numpy as np
    from pecaller_tpu_torch.caller.device_screen import (BAND, DEPTH_GATE,
                                                         EASY)
    mb, ma = screen_margins_f64(reads, ref_int, haploid)
    r = reads.astype(np.int64)
    tot = r[..., :5].sum(-1)
    indiv = reads.shape[1]
    active = tot > (1 if haploid else 2)
    exact = mb > 2.3
    near = np.abs(mb - (2.3 + BAND)) < SCREEN_TOL
    if indiv >= 4:
        exact &= ma > 0
        near |= np.abs(ma - BAND) < SCREEN_TOL
    bad = (tot.sum(-1) < 8 * indiv) | (
        (2 * (tot >= 8).sum(-1) < indiv) & (ctype != 2))
    easy_ok = ((~active | exact).all(-1) & ~bad & (ref_int < 4)
               & ((tot + r[..., 5]) <= DEPTH_GATE).all(-1))
    wrong = np.flatnonzero((codes == EASY) & ~easy_ok)
    if len(wrong):
        raise AssertionError(f"{len(wrong)} sites EASY against the f64 "
                             f"criterion, first {int(wrong[0])}")
    diff = codes != ref_codes
    far = np.flatnonzero(diff & ~(active & near).any(-1))
    if len(far):
        raise AssertionError(f"{len(far)} sites differ outside the "
                             f"{SCREEN_TOL} band, first {int(far[0])}")
    return int(diff.sum())


def screen_check():
    """Phase 8b: CallerScreen on the card at one full chunk of 3 samples
    (2^18 sites) and one of 64 (2^15), on screen_fuzz's counts: phase-0
    codes bitwise equal to the CPU's and to the native phase 0
    (host_screen_stats); phase 1 on every site held to screen_contract
    against the CPU's; both phases as device programs (graphs, called
    twice a key so that the second call captures and replays) bitwise
    to the same screen with graph=False at the full chunk and at a tail
    in each of two smaller buckets (SCREEN_TAILS); each phase's ms per
    chunk, the eager steps and one graph replay (CUDA events); the
    programs' capture and instantiate seconds and pool bytes; the
    screen's own sites/s (host arrays in, codes out), graphed and
    eager."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.caller.device_screen import (CallerScreen,
                                                         UNRES,
                                                         _phase0_tables)
    from pecaller_tpu_torch.caller.native import host_screen_stats
    dev = torch.device("cuda", 0)
    held = torch.cuda.memory_allocated(dev)    # as in caller_path
    out = []
    for indiv, n in SCREEN_CHUNKS:
        rng = np.random.default_rng(88 + indiv)
        reads, ref_int, ctype = screen_fuzz(rng, n, indiv)
        gpu = CallerScreen(indiv, False)
        eager = CallerScreen(indiv, False, graph=False)
        cpu = CallerScreen(indiv, False, device="cpu")
        if gpu.chunk != n:
            raise AssertionError(f"chunk {gpu.chunk} != {n}")
        c0 = gpu.phase0(reads, ref_int, ctype)
        c0_cpu = cpu.phase0(reads, ref_int, ctype)
        c0_nat = host_screen_stats(
            reads, np.ones((n, indiv), np.uint8), ref_int, ctype,
            _phase0_tables(False), indiv, False, os.cpu_count() or 2,
            np.zeros((indiv, 501), np.int64), np.zeros(indiv, np.int64),
            np.zeros(indiv, np.int64), np.zeros(indiv, np.int64))[0]
        for name, other in (("cpu", c0_cpu), ("native", c0_nat)):
            if not np.array_equal(c0, other):
                raise AssertionError(
                    f"phase 0 at {indiv} samples: {int((c0 != other).sum())}"
                    f" codes differ from the {name} phase 0")
        c1 = gpu.phase1(reads, ref_int, ctype)
        c1_cpu = cpu.phase1(reads, ref_int, ctype)
        n_band = screen_contract(c1, c1_cpu, reads, ref_int, ctype, False)

        # graphed against eager: the second call of each key captures
        # and replays
        checked = []
        for m in (n, *SCREEN_TAILS):
            x = (reads[:m], ref_int[:m], ctype[:m])
            for ph in ("phase0", "phase1"):
                want = getattr(eager, ph)(*x)
                for _ in range(2):
                    got = getattr(gpu, ph)(*x)
                    if not np.array_equal(got, want):
                        raise AssertionError(
                            f"{ph} at {indiv} samples, {m} sites: the "
                            "graphed codes differ from the eager ones")
            checked.append(dict(sites=m, bucket=gpu._bucket(m)))
        stats = gpu.program_stats()
        if stats["graphs"] != 2 * len(checked):
            raise AssertionError(f"{stats['graphs']} graphs for "
                                 f"{len(checked)} buckets")

        args = (torch.from_numpy(reads.view(np.int16)).to(dev),
                torch.from_numpy(ref_int).to(dev),
                torch.from_numpy(ctype).to(dev))
        ms = {}
        for ph in ("phase0", "phase1"):
            (prog, _, _), = gpu.programs[(ph, n)]
            torch.cuda.reset_peak_memory_stats(dev)
            ms[ph] = dict(eager_ms=_timed(
                lambda: eager._fn(ph, dev)(*args), 5),
                eager_max_memory_allocated=torch.cuda.max_memory_allocated(
                    dev),
                replay_ms=_timed(prog._graph.replay, 5),
                capture_s=prog.capture_s, instantiate_s=prog.instantiate_s,
                pool_bytes=prog.pool_bytes)
        rates = {}
        for name, scr in (("graph", gpu), ("eager", eager)):
            scr(reads, ref_int, ctype)
            t0 = time.time()
            codes = scr(reads, ref_int, ctype)
            rates[name] = n / (time.time() - t0)
        out.append(dict(
            samples=indiv, sites=n, chunk=gpu.chunk,
            phase0_unres=int((c0 == UNRES).sum()),
            codes={k: int((codes == v).sum())
                   for k, v in (("hard", 0), ("easy", 1), ("bad", 2))},
            phase1_differ_from_cpu_in_band=n_band,
            graph_equal_eager=checked, ms_per_chunk=ms, programs=stats,
            screen_sites_per_s=rates))
    say("screen_check", chunks=out, memory_allocated_at_start=held,
        fuzz="test_screen kinds, margin sweep, TMAX and DEPTH_GATE edges, "
        "counts >= 32768, argmax ties, ref 4 and 5, chrY",
        note="ms by CUDA events over 5 calls on the full chunk: eager_ms "
        "the phase's step eagerly, replay_ms one replay of its graph; "
        "sites/s on the host clock over one whole call after a warm call")


# ---------------------------------------------------------------------------
# phases 9-11: the scale-out (reads-axis mesh, genome-sharded octile
# engine, multi-process runs), every shard on cuda:0

HG38 = 3_100_000_000


def _card():
    """The card every shard of phases 9-11 sits on."""
    import torch
    return torch.device("cuda", 0)


def map_oracle(n_pairs, data=DATA):
    """The host oracle: `pemapper` on ``data``'s reads with --host,
    under ``data``/host.  Returns its directory and engine."""
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.mapper.runner import run_mapper
    host_dir = _run_dir("host", data)
    host = run_mapper(cli.parse_pemapper(_argv(host_dir, n_pairs, False,
                                               data)))
    return host_dir, host


def call_oracle(n_pairs, data=DATA):
    """Phase 8's cohort and its oracle, the exact native engine on every
    callable site.  Returns the cohort's directory, the oracle's
    artifacts, and the seconds of the data and of the oracle."""
    from pecaller_tpu_torch.caller import CallerConfig, run_caller
    make_data(n_pairs, data)
    cb, t_data = make_call_data(data)
    t0 = time.time()
    exact = run_caller(CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(cb, "exact"), directory=cb,
        nthreads=os.cpu_count() or 2, device_screen=False,
        host_screen=False))
    t_exact = time.time() - t0
    want = _call_artifacts(os.path.join(cb, "exact"))
    if not 0 < exact["n_sites"] == want[".base.gz"].count(b"\n") \
            == exact["native_sites"]:
        raise AssertionError("the exact path did not call every site")
    return cb, want, t_data, t_exact


def _gate(what, got, want):
    diff = [k for k in want if got[k] != want[k]]
    if diff:
        raise AssertionError(f"{what}: {diff} differ from the host "
                             "oracle's")


def _spread(rates):
    return (rates[-1] - rates[0]) / rates[len(rates) // 2]


def reads_mesh(n_pairs, host_dir, cb, call_want):
    """Phase 9: the reads-axis mesh, two shards on cuda:0.  `pemapper
    ...` as phase 4's command line with mesh_shards 2 through
    run_mapper(device=[cuda:0, cuda:0]), each shard's step a graph: all
    five artifacts byte-equal to the host oracle; graphed against the
    eager mesh engine (graph_vs_eager; phase 4 has one device's reads/s
    in the same call); the caller on phase 8's cohort with a 2-shard
    screen mesh (host_screen False) byte-equal to the exact engine.
    Returns K1/K2 launches of the mapping run."""
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.caller import CallerConfig, run_caller
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.index.nbr import load_nbr_index
    from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
    from pecaller_tpu_torch.mapper.runner import run_mapper
    from pecaller_tpu_torch.ops import sw_cuda
    from pecaller_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    d = _run_dir("mesh")
    cfg = cli.parse_pemapper(_argv(d, n_pairs, True))
    cfg.mesh_shards = 2
    torch.cuda.reset_peak_memory_stats(dev)
    sw_cuda.reset_launches()
    t0 = time.time()
    eng = run_mapper(cfg, device=[dev, dev])
    torch.cuda.synchronize(dev)
    t_run = time.time() - t0
    launches = dict(sw_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if eng._n_sh != 2 or len(eng.states) != 2:
        raise AssertionError("the runner did not build a 2-shard mesh")
    batches = _batches(n_pairs)
    _check_launches("reads mesh", launches, len(batches),
                    ("sw_align_x", "sw_tb_rows"), 2)
    want = _artifacts(host_dir)
    _gate("reads-axis mesh", _artifacts(d), want)
    n_fallback, n_tiefix = eng.n_fallback, eng.n_tiefix

    base = os.path.join(DATA, "g")
    sdx = read_sdx(base + ".sdx")
    index = load_index(base)
    eager = FusedMapperEngine2(
        sdx, read_seq(base + ".seq", sdx.genome_size), index,
        nbr=load_nbr_index(base, index), device=dev, paired=True,
        min_align=cfg.min_align, min_dist=cfg.min_dist,
        max_dist=cfg.max_dist, nthreads=cfg.nthreads, graph=False,
        mesh=make_mesh(2, 1, [dev, dev]))
    cmp = graph_vs_eager(eng, eager, batches, dev)
    del eng, eager
    torch.cuda.empty_cache()

    cfg_c = CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(cb, "mesh"), directory=cb,
        nthreads=os.cpu_count() or 2, host_screen=False,
        mesh=make_mesh(2, 1, [dev, dev]))
    run_caller(cfg_c)
    _call_gate("mesh", cfg_c.out_base, call_want)
    rate, rates, res = _call_passes(lambda: run_caller(cfg_c))
    say("reads_mesh", shards=2, devices=[str(dev)] * 2, pairs=n_pairs,
        batch=BATCH, byte_equal=sorted(want), launches=launches,
        reads_per_s=cmp["graph"]["reads_per_s"], graph=cmp.pop("graph"),
        eager=cmp.pop("eager"), **cmp,
        n_fallback=n_fallback, n_tiefix=n_tiefix, max_memory_allocated=peak,
        seconds=dict(device_run=round(t_run, 1)),
        caller=dict(shards=2, byte_equal=sorted(call_want),
                    sites_per_s=rate, sites_per_s_passes=rates,
                    spread=_spread(rates), sites_on_card=res["screen_sites"]),
        scaling="every shard on one card: correctness, not scaling")
    return launches


def _mesh_program(eng):
    """The layout and capture figures of a genome-mesh engine's main
    program (the shape key with the most calls)."""
    prog = max(eng.programs, key=lambda p: p.calls)
    return dict(devices=[str(d) for d in prog.by_device],
                collectives=len(prog.collectives),
                segments_a_shard=prog.segments,
                graphs_a_batch=prog.n_graphs, copies_a_batch=prog.n_copies,
                capture_s=prog.capture_s, instantiate_s=prog.instantiate_s,
                pool_bytes_by_device=prog.pool_bytes_by_device)


def genome_mesh(n_pairs, host_dir, built=None):
    """Phase 10: the genome-sharded octile engine on phase 6's data, two
    genome shards on cuda:0, built directly (the runner has no route to
    it): the shard plan and octile builds timed, each shard's table
    bytes; `map_files` with phase 6's command line, each batch's step a
    MeshProgram (a CUDA graph a shard a segment between its collectives,
    a graph a card a collective's reduction, the output gathered on the
    first card), against phase 6's host oracle, all five artifacts
    byte-equal; then graph_vs_eager against the engine on the same
    shards with graph=False (lockstep).  Where the machine has two
    cards, the same shards on cuda:0 and cuda:1: the same gate, the raw
    outputs of the first batches bitwise to the one-card program's,
    reads/s and each card's peak memory; with one card a line says that
    run did not happen.  ``built``: the octile shards and their build
    seconds where phase 6 built them beside its oracle, else built here.
    Returns K1/K2 launches of the gate run."""
    import numpy as np
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.index.quarter import OCT_LOCAL_MAX
    from pecaller_tpu_torch.index.shard import plan_shards
    from pecaller_tpu_torch.mapper.gshard import OctileShardedEngine
    from pecaller_tpu_torch.mapper.runner import map_files
    from pecaller_tpu_torch.ops import sw_cuda
    from pecaller_tpu_torch.parallel.mesh import make_mesh

    dev = _card()
    base = os.path.join(MID, "g")
    sdx = read_sdx(base + ".sdx")
    genome = read_seq(base + ".seq", sdx.genome_size)
    index = load_index(base)
    t0 = time.time()
    plan = plan_shards(sdx, 2)
    t_plan = time.time() - t0
    if built is None:
        t0 = time.time()
        built = _octile_shards(index), time.time() - t0
    shards, t_build = built
    table_bytes = [sum(np.asarray(a).nbytes
                       for a in (s.tagt, s.valt, s.pos, s.qw))
                   for s in shards]
    d = _run_dir("gshard", MID)
    cfg = cli.parse_pemapper(_argv(d, n_pairs, True, MID))
    torch.cuda.reset_peak_memory_stats(dev)

    def engine(graph, devs=(dev, dev)):
        return OctileShardedEngine(
            sdx, genome, index, make_mesh(1, 2, list(devs)), plan=plan,
            shards=shards, bisulfite=cfg.bisulfite, min_align=cfg.min_align,
            min_dist=cfg.min_dist, max_dist=cfg.max_dist, paired=cfg.paired,
            nthreads=cfg.nthreads, graph=graph)
    t0 = time.time()
    eng = engine(True)
    torch.cuda.synchronize(dev)
    t_upload = time.time() - t0
    sw_cuda.reset_launches()
    t0 = time.time()
    map_files(cfg, eng, sdx, genome)
    torch.cuda.synchronize(dev)
    t_run = time.time() - t0
    launches = dict(sw_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if not (launches["sw_align_x"] and launches["sw_tb_rows"]):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    want = _artifacts(host_dir)
    _gate("genome-sharded octile", _artifacts(d), want)
    n_fallback, n_tiefix, n_cap = (eng.n_fallback, eng.n_tiefix,
                                   eng.n_cap_fallback)
    program = _mesh_program(eng)
    if program["segments_a_shard"] != 14 or program["copies_a_batch"]:
        raise AssertionError(f"the one-card program's layout: {program}")
    eager = engine(False)
    batches = _batches(n_pairs, MID)
    cmp = graph_vs_eager(eng, eager, batches, dev)
    del eager
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards >= 2:
        two_cards = _genome_mesh_cards(engine, eng, batches, want, n_pairs,
                                       sdx, genome)
    else:
        two_cards = dict(ran=False, why="the machine has one card: the "
                         "two-card run did not happen")
    del eng, shards
    torch.cuda.empty_cache()
    per_base = sum(table_bytes) / sdx.genome_size
    say("genome_mesh", shards=2, devices=[str(dev)] * 2,
        genome=sdx.genome_size, pairs=n_pairs, batch=BATCH,
        shard_bases_idx=[int(x) for x in plan.bases_idx],
        shard_cover_idx=[int(x) for x in plan.cover_idx],
        table_bytes=table_bytes, byte_equal=sorted(want), launches=launches,
        program=program,
        reads_per_s=cmp["graph"]["reads_per_s"], graph=cmp.pop("graph"),
        eager=cmp.pop("eager"), **cmp, n_fallback=n_fallback,
        n_tiefix=n_tiefix, n_cap_fallback=n_cap,
        max_memory_allocated=peak,
        seconds=dict(plan=round(t_plan, 4), octile_build=round(t_build, 1),
                     engine_build=round(t_upload, 1),
                     device_run=round(t_run, 1)),
        hg38=dict(
            genome=HG38, min_shards=-(-HG38 // OCT_LOCAL_MAX),
            table_bytes_at_this_runs_bytes_per_base=int(per_base * HG38),
            scaling_md_count="~130 GB (pos 99 + nibbles 25 + starts 8)",
            note="beyond one 80 GB card and beyond a smoke's host build"),
        cards=cards)
    say("genome_mesh_cards", cards=cards, **two_cards)
    return launches


def _genome_mesh_cards(engine, one, batches, want, n_pairs, sdx, genome):
    """Phase 10 on two cards: the same shards on cuda:0 and cuda:1
    (``engine(True, cards)``), `map_files` gated against the host oracle
    as on one card, the raw outputs of the first 3 batches bitwise to
    the one-card program ``one``'s, then reads/s (median of 3 after a
    warm pass), host ms a batch, one replay's device ms and each card's
    peak memory above what it held before (cuda:0 keeps the one-card
    engine)."""
    import numpy as np
    import torch
    from pecaller_tpu_torch import cli
    from pecaller_tpu_torch.mapper.runner import map_files
    from pecaller_tpu_torch.utils.log import spans, spans_since
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    # cuda:0 still holds the one-card engine
    resident = {c: torch.cuda.memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.time()
    eng = engine(True, cards)
    _sync()
    t_upload = time.time() - t0
    d = _run_dir("gshard_cards", MID)
    cfg = cli.parse_pemapper(_argv(d, n_pairs, True, MID))
    t0 = time.time()
    map_files(cfg, eng, sdx, genome)
    _sync()
    t_run = time.time() - t0
    _gate("genome-sharded octile on two cards", _artifacts(d), want)
    got = _raw_outputs(eng, batches[:3])
    ref = _raw_outputs(one, batches[:3])
    for i, (a, b) in enumerate(zip(got, ref)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"batch {i}: the two-card program differs "
                                 "from the one-card program")
    program = _mesh_program(eng)
    if program["copies_a_batch"] != 2 * 13 + 1:
        raise AssertionError(f"the two-card program's layout: {program}")
    before = spans()
    rates, how, per_batch = _rates(eng, batches)
    mesh_ms = _mesh_ms(spans_since(before))
    out = dict(ran=True, devices=[str(c) for c in cards],
               byte_equal=sorted(want), bitwise_to_one_card_batches=3,
               reads_per_s=rates[len(rates) // 2], reads_per_s_passes=rates,
               spread=_spread(rates), passes=how,
               host_ms_per_batch={k: 1e3 * v for k, v in per_batch.items()},
               **mesh_ms,
               replay_ms_per_batch=_replay_ms(eng, cards[0]),
               program=program,
               peak_above_resident={
                   str(c): torch.cuda.max_memory_allocated(c) - resident[c]
                   for c in cards},
               seconds=dict(engine_build=round(t_upload, 1),
                            device_run=round(t_run, 1)))
    del eng
    torch.cuda.empty_cache()
    return out


_PART_SCRIPT = """
import os, sys
root, d, pid, coord, what, device = sys.argv[1:7]
pid = int(pid)
sys.path.insert(0, root)
import torch
torch.set_num_threads(int(sys.argv[9]))       # two processes share the host
from pecaller_tpu_torch.parallel.distributed import init_distributed
init_distributed(coord, 2, pid)
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
if what == "map":
    from pecaller_tpu_torch.mapper.runner import MapperConfig
    from pecaller_tpu_torch.parallel.distributed import run_mapper_distributed
    cfg = MapperConfig(
        out_base=os.path.join(d, "dist"), sdx_path=sys.argv[7], paired=True,
        files1=[os.path.join(d, f"a{i}_1.fastq") for i in range(2)],
        files2=[os.path.join(d, f"a{i}_2.fastq") for i in range(2)],
        max_dist=500, min_dist=0, min_align=0.9, batch_size=int(sys.argv[8]),
        nthreads=int(sys.argv[9]))
    eng = run_mapper_distributed(cfg, coord, 2, pid)
    card = torch.device("cuda", pid % torch.cuda.device_count())
    assert type(eng).__name__ == "FusedMapperEngine2" and eng.device == card
else:
    from pecaller_tpu_torch.caller import CallerConfig
    from pecaller_tpu_torch.parallel.distributed import run_caller_distributed
    cb = sys.argv[7]
    run_caller_distributed(CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(d, "call"), directory=cb,
        nthreads=int(sys.argv[9]), device=device), coord, 2, pid)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "pecaller_tpu."))]
assert not bad, bad
dist.destroy_process_group()
print("process", pid, what, "done", flush=True)
"""


def _two_processes(d, what, *extra):
    """Run _PART_SCRIPT in two processes joined on localhost; kill both
    if either fails or hangs.  Returns the wall seconds."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    script = os.path.join(d, "part.py")
    with open(script, "w") as f:
        f.write(_PART_SCRIPT)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, script, ROOT, d, str(p), coord, what,
         *map(str, extra)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"{what} process exited "
                                     f"{p.returncode}: {out.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.time() - t0


def _split_fastq(src, dsts, n_first):
    """The first ``n_first`` records of ``src`` to dsts[0], the rest to
    dsts[1]."""
    with open(src, "rb") as f:
        lines = f.readlines()
    for dst, part in zip(dsts, (lines[:4 * n_first], lines[4 * n_first:])):
        with open(dst, "wb") as f:
            f.writelines(part)


def multi_process(n_pairs, host_dir, cb, call_want):
    """Phase 11: two processes joined by init_distributed (gloo, on
    localhost), both on cuda:0.  run_mapper_distributed maps phase 4's
    reads split into two fastq pairs, each process on the card its
    default gives it (cuda:{p % cards}): the parts' pileups merge to the
    host oracle's (single-process) pileup and their .mfile dumps to its
    .mfile bytes.  run_caller_distributed and merge_caller_parts call
    phase 8's cohort: .snp, .dist and the decompressed .base.gz and
    .piles.gz byte-equal to the exact engine's single run."""
    import numpy as np
    from pecaller_tpu_torch.caller import CallerConfig
    from pecaller_tpu_torch.formats.pileup import read_pileup
    from pecaller_tpu_torch.formats.sdx import read_sdx
    from pecaller_tpu_torch.parallel.distributed import merge_caller_parts

    d = os.path.join(DATA, "dist")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    half = n_pairs // 2
    for e in (1, 2):
        _split_fastq(os.path.join(DATA, f"r{e}.fastq"),
                     [os.path.join(d, f"a{i}_{e}.fastq") for i in range(2)],
                     half)
    threads = max(1, (os.cpu_count() or 2) // 2)
    device = str(_card())
    t_map = _two_processes(d, "map", device, os.path.join(DATA, "g.sdx"),
                           BATCH, threads)
    gs = read_sdx(os.path.join(DATA, "g.sdx")).genome_size
    merged = np.zeros((gs, 6), np.int64)
    for p in range(2):
        pos, cnt = read_pileup(os.path.join(d, f"dist.part{p}.pileup.gz"))
        merged[pos] += cnt
    single = np.zeros((gs, 6), np.int64)
    spos, scnt = read_pileup(os.path.join(host_dir, "out.pileup.gz"))
    single[spos] += scnt
    if not single.any() or not np.array_equal(merged, single):
        raise AssertionError("the parts' pileups do not merge to the "
                             "single run's")
    for e in (1, 2):
        parts = b"".join(
            open(os.path.join(d, f"a{i}_{e}.fastq.mfile"), "rb").read()
            for i in range(2))
        with open(os.path.join(host_dir, f"r{e}.fastq.mfile"), "rb") as f:
            if parts != f.read():
                raise AssertionError(f"the parts' r{e} .mfile differ from "
                                     "the single run's")

    t_call = _two_processes(d, "call", device, cb, BATCH, threads)
    merge_caller_parts(CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(d, "call"), directory=cb), 2)
    got = _call_artifacts(os.path.join(d, "call"))
    diff = [k for k in call_want if got[k] != call_want[k]]
    if diff:
        raise AssertionError(f"the caller's merged parts: {diff} differ "
                             "from the single run's")
    say("multi_process", processes=2, backend="gloo",
        devices=[device] * 2,
        mapper=dict(pairs=n_pairs, files=2, merged_equal=[
            "pileup", "r1.fastq.mfile", "r2.fastq.mfile"],
            wall_s=round(t_map, 1)),
        caller=dict(byte_equal=sorted(call_want), wall_s=round(t_call, 1)),
        note="wall includes each process's start, index load and writers")


# ---------------------------------------------------------------------------
# phase 12: the joint-configuration beam of the caller's HARD sites

BEAM_FUZZ = ((3, False), (5, False), (2, True))
BEAM_FUZZ_SITES = 40_000
BEAM_SWEEP = (3, 8, 16, 32)
BEAM_SWEEP_SITES = 8192


def beam_fuzz(rng, n, indiv):
    """tests/test_beam.py's adversarial count patterns (its _fuzz_sites,
    the same draws from ``rng``): het mixes, low-level errors, indel
    support near the 3-read gate, deep/shallow, multiallelic messes.
    Returns (reads (n, indiv, 6) uint16, ref (n,) uint8)."""
    import numpy as np
    cnt = np.zeros((n, indiv, 6), np.uint16)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    for k in range(n):
        rc = int(ref[k])
        kind = rng.integers(0, 10)
        for i in range(indiv):
            depth = int(rng.integers(3, 60))
            c = np.zeros(6, np.int64)
            c[rc] = depth
            if kind == 0:                       # clean hom ref
                pass
            elif kind == 1:                     # clear het
                alt = (rc + 1 + rng.integers(3)) % 4
                c[alt] = depth // 2
                c[rc] -= depth // 2
            elif kind == 2:                     # hom alt
                alt = (rc + 1 + rng.integers(3)) % 4
                c[alt] = c[rc]
                c[rc] = int(rng.integers(0, 3))
            elif kind == 3:                     # marginal errors
                alt = (rc + 1 + rng.integers(3)) % 4
                c[alt] = int(rng.integers(1, 8))
            elif kind == 4:                     # del around the gate
                c[4] = int(rng.integers(0, 8))
                c[rc] = max(depth - c[4], 0)
            elif kind == 5:                     # ins around the gate
                c[5] = int(rng.integers(0, 8))
            elif kind == 6:                     # multiallelic mess
                for a in range(4):
                    c[a] = int(rng.integers(0, depth))
            elif kind == 7:                     # mixed indel + snp
                c[(rc + 1) % 4] = int(rng.integers(0, depth))
                c[4] = int(rng.integers(0, 6))
                c[5] = int(rng.integers(0, 6))
            elif kind == 8:                     # shallow
                c[:] = 0
                c[rc] = int(rng.integers(0, 4))
            else:                               # uneven cohort
                c[rc] = int(rng.integers(0, 100))
            cnt[k, i] = np.minimum(c, 65535)
    return cnt, ref


def native_calls(reads, ref, indiv, haploid, ctype=None, nthreads=2):
    """The port's exact native engine on every site (theta 0.001,
    threshold 0.95, no pedigree): pecall_sites's six outputs."""
    import numpy as np
    from pecaller_tpu_torch.caller.native import load_pecall, pecall_sites
    lib, model = load_pecall(indiv, haploid, 0.001, 1e-8, 0.95, False,
                             np.full(indiv, -1, np.int32),
                             np.full(indiv, -1, np.int32),
                             np.zeros(indiv, np.int32))
    n = len(ref)
    return pecall_sites(lib, model, reads, ref,
                        np.zeros(n, np.uint8) if ctype is None else ctype,
                        np.full(n, int(haploid), np.uint8), nthreads)


def beam_contract(reads, ref, out, want, indiv, haploid, ctype=None):
    """Hold a beam result ``out`` (DeviceBeam's seven arrays) to the
    beam's contract: on every site it leaves unflagged, finish_f64's
    calls, probs, types, acnt and active equal the native engine's
    ``want`` (native_calls) bitwise.  Returns the flag rate."""
    import numpy as np
    from pecaller_tpu_torch.caller.device_beam import finish_f64
    n_cfg, cfgs, flags, _, _, hrank, hval = out
    ok = flags == 0
    got = finish_f64(reads[ok], ref[ok], n_cfg[ok], cfgs[ok], hrank[ok],
                     hval[ok], indiv=indiv, haploid=haploid, theta=0.001,
                     threshold=0.95,
                     ctype=None if ctype is None else ctype[ok])
    calls, probs, types, _, acnt, active = want
    for name, g, w in zip(("calls", "probs", "types", "acnt", "active"),
                          got, (calls, probs, types, acnt, active)):
        if not np.array_equal(g, w[ok]):
            bad = (g != w[ok]).reshape(len(g), -1).any(1)
            raise AssertionError(
                f"beam at {indiv} samples: finished {name} differ from the "
                f"native engine's on {int(bad.sum())} unflagged sites")
    return float(1.0 - ok.mean())


def beam_sets_agree(a, b):
    """Two beam results on the same sites: where both leave a site
    unflagged, equal n_cfg and config sets equal as sets of rows.
    Returns the number of such sites; raises where they differ."""
    import numpy as np
    both = np.flatnonzero((a[2] == 0) & (b[2] == 0))
    for k in both:
        m = a[0][k]
        if m != b[0][k] or set(map(bytes, a[1][k, :m])) != \
                set(map(bytes, b[1][k, :m])):
            raise AssertionError(f"site {k}: the beams' config sets differ")
    return len(both)


def _hard_sites(indiv, n, seed):
    """``n`` beam_fuzz sites of ``indiv`` samples that the site screen
    (on the card) leaves HARD: the sites a run sends to the beam."""
    import numpy as np
    from pecaller_tpu_torch.caller.device_screen import HARD, CallerScreen
    rng = np.random.default_rng(seed)
    reads, ref = beam_fuzz(rng, 2 * n, indiv)
    codes = CallerScreen(indiv, False)(reads, ref,
                                       np.zeros(len(ref), np.uint8))
    hard = np.flatnonzero(codes == HARD)[:n]
    if len(hard) < n:
        raise AssertionError(f"{len(hard)} HARD fuzz sites at {indiv} "
                             f"samples, {n} wanted")
    return reads[hard], ref[hard]


def _device_profile(fn):
    """torch.profiler over one call of ``fn`` after a warm call: the
    card's kernel ms, the number of kernels and copies on the card, and
    the three ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    def on_card(e):             # kernels and copies, not the host ops
        return str(getattr(e, "device_type", "")).endswith("CUDA")
    ka = prof.key_averages()
    ops = [e for e in ka if not on_card(e)]
    return dict(device_ms=sum(self_dev_us(e) for e in ka if on_card(e))
                / 1e3,
                device_events=sum(on_card(e) for e in prof.events()),
                top_device=[(e.key, self_dev_us(e) / 1e3) for e in sorted(
                    ops, key=self_dev_us, reverse=True)[:3]])


def beam_path(cb, want):
    """Phase 12: (a) phase 8's cohort through run_caller(device_beam=
    True), the four artifacts byte-equal to the exact engine's; (b) the
    40,000-site fuzz at (3, diploid), (5, diploid), (2, haploid) on
    cuda:0 held to beam_contract; (c) the sweep at 3, 8, 16 and 32
    samples on 8,192 HARD fuzz sites each: beam, beam + finisher, beam +
    finisher + native on the flagged sites, and the native engine alone
    (nthreads = host cores), each in sites/s; one chunk of the graphed
    beam bitwise to the eager chunk, each one's ms a chunk (CUDA events)
    and its peak memory.  The beam's chunk runs as a device program
    throughout."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.caller import CallerConfig, run_caller
    from pecaller_tpu_torch.caller.device_beam import DeviceBeam, finish_f64
    from pecaller_tpu_torch.mapper.program import capture_stats
    dev = torch.device("cuda", 0)
    threads = os.cpu_count() or 2
    t_phase = time.time()
    t0 = time.time()
    cfg = CallerConfig(
        pileup_ext="pileup", sdx_path=os.path.join(cb, "g.sdx"),
        out_base=os.path.join(cb, "beam"), directory=cb, nthreads=threads,
        device_beam=True)
    run_caller(cfg)
    t_warm = time.time() - t0
    res = run_caller(cfg)
    _call_gate("beam", cfg.out_base, want)
    if not res["beam_sites"]:
        raise AssertionError("the beam took no site of the cohort")
    if not res["programs"]["beam"]["graphs"]:
        raise AssertionError("the cohort's beam captured no graph")
    cohort = dict(sites=res["n_sites"], hard=res["codes"]["hard"],
                  beam_sites=res["beam_sites"],
                  beam_flagged=res["beam_flagged"],
                  native_sites=res["native_sites"],
                  beam_s=res["phases"].get("beam"),
                  beam_finish_s=res["phases"].get("beam_finish"),
                  native_s=res["phases"].get("native"),
                  programs=res["programs"],
                  first_run_s=t_warm, byte_equal=sorted(want))

    fuzz = []
    for indiv, hap in BEAM_FUZZ:
        rng = np.random.default_rng(999 + indiv)
        reads, ref = beam_fuzz(rng, BEAM_FUZZ_SITES, indiv)
        nat = native_calls(reads, ref, indiv, hap, nthreads=threads)
        beam = DeviceBeam(indiv, hap, 0.001, 0.95)
        t0 = time.time()
        out = beam(reads, ref)
        t_beam = time.time() - t0
        rate = beam_contract(reads, ref, out, nat, indiv, hap)
        if rate >= (0.45 if indiv < 4 else 0.80):
            raise AssertionError(f"beam flag rate {rate} at {indiv}")
        fuzz.append(dict(samples=indiv, haploid=hap, sites=len(ref),
                         flag_rate=rate, beam_s=t_beam,
                         unflagged_bitwise=True))

    sweep = []
    for indiv in BEAM_SWEEP:
        reads, ref = _hard_sites(indiv, BEAM_SWEEP_SITES, 5 + indiv)
        n = len(ref)
        beam = DeviceBeam(indiv, False, 0.001, 0.95)
        beam(reads[:beam.chunk], ref[:beam.chunk])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.time()
        out = beam(reads, ref)
        t_beam = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        ok = out[2] == 0
        t0 = time.time()
        fin = finish_f64(reads[ok], ref[ok], out[0][ok], out[1][ok],
                         out[5][ok], out[6][ok], indiv=indiv,
                         haploid=False, theta=0.001, threshold=0.95)
        t_fin = time.time() - t0
        t0 = time.time()
        rest = native_calls(reads[~ok], ref[~ok], indiv, False,
                            nthreads=threads)
        t_rest = time.time() - t0
        t0 = time.time()
        nat = native_calls(reads, ref, indiv, False, nthreads=threads)
        t_nat = time.time() - t0
        # the beam path's outputs, site for site, against the native run
        for k, (f, r, w) in enumerate(zip(fin, (rest[0], rest[1], rest[2],
                                                rest[4], rest[5]),
                                          (nat[0], nat[1], nat[2], nat[4],
                                           nat[5]))):
            path = np.empty_like(w)
            path[ok], path[~ok] = f, r
            if not np.array_equal(path, w):
                raise AssertionError(f"sweep at {indiv} samples: output "
                                     f"{k} of the beam path differs")
        # one chunk, graphed (the run above captured the program)
        # against eager, bitwise, and each one's ms
        chunk = tuple(torch.from_numpy(x[:beam.chunk]).to(dev) for x in
                      (reads.view(np.int16), ref))
        got = beam.program([chunk])[0].clone()
        if not torch.equal(got, beam.chunk_fn(*chunk)):
            raise AssertionError(f"sweep at {indiv} samples: the graphed "
                                 "chunk differs from the eager one")
        ms = _timed(lambda: beam.chunk_fn(*chunk), 3)
        replay_ms = _timed(beam.program._graph.replay, 3)
        prof = _device_profile(lambda: beam.chunk_fn(*chunk))
        sweep.append(dict(
            samples=indiv, sites=n, flag_rate=float(1 - ok.mean()),
            beam_sites_per_s=n / t_beam,
            beam_finish_sites_per_s=n / (t_beam + t_fin),
            beam_path_sites_per_s=n / (t_beam + t_fin + t_rest),
            native_sites_per_s=n / t_nat, native_threads=threads,
            beam_s=t_beam, finish_s=t_fin, native_flagged_s=t_rest,
            native_s=t_nat, chunk=beam.chunk, chunk_ms=ms,
            replay_ms=replay_ms, graph_equal_eager=True,
            program=capture_stats([beam.program]),
            chunk_device_ms=prof["device_ms"],
            chunk_device_events=prof["device_events"],
            chunk_idle_share=1.0 - prof["device_ms"] / ms,
            chunk_top_device=prof["top_device"],
            beam_max_memory_allocated=peak))
    say("beam", cohort=cohort, fuzz=fuzz, sweep=sweep,
        seconds=time.time() - t_phase,
        note="the beam's chunk a device program (a CUDA graph); sites/s "
        "on host arrays (upload, fetch and unpack included); chunk_ms "
        "(the eager chunk) and replay_ms (one replay of the chunk's graph) "
        "by CUDA events over 3 chunks of 1024 sites, chunk_device_ms the "
        "eager chunk's kernels' own time (torch.profiler); beam path = "
        "beam + finisher + native on the flagged sites")


# ---------------------------------------------------------------------------
# phase 13: the sharded map and call steps

MAP_STEP_LANES = 8192
CALL_STEP_SITES = 1 << 16


def sharded_steps():
    """Phase 13: sharded_map_step on two shards of cuda:0 at 8,192 lanes
    of the v1 shape (N 160, M 112, raw bytes), graphed (one MeshProgram:
    called on lanes a, b, a, so the second call captures and replays
    and the third replays), every output bitwise against the one-device
    plain path (sw_align_device, the traceback and pileup_scatter on
    cuda:0) over phase 4's genome size on lanes a and against the step
    with graph=False on lanes b, bisulfite off and on; where the
    machine has two cards the same over cuda:0 and cuda:1, graphed and
    with graph=False, against the same references;
    then sharded_call_step, with graph=False and graphed (called three
    times: eagerly, captured, replayed), each bitwise to site_likelihoods
    on one device.
    Returns K3's launches of the graphed step."""
    import numpy as np
    import torch
    from pecaller_tpu_torch.caller.device_model import site_likelihoods
    from pecaller_tpu_torch.ops import sw, sw_cuda
    from pecaller_tpu_torch.parallel.mesh import (
        make_mesh, sharded_call_step, sharded_map_step)
    dev = torch.device("cuda", 0)
    t_phase = time.time()
    mesh = make_mesh(2, 1, [dev, dev])
    gs = GENOME_LEN
    gs_pad = -(-gs // mesh.size) * mesh.size
    out = {}
    launches = 0

    def lanes(seed):
        return [torch.from_numpy(x).to(dev) for x in mk_lanes(
            np.random.default_rng(seed), MAP_STEP_LANES, 160, 112, 90, 101,
            raw=True)]

    def check(name, got, want, bis):
        for what, a, b in zip(("score", "bk", "bi", "pileup"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded_map_step ({name}) {what} "
                                     f"differs (bisulfite {bis})")

    def call(step, x):
        t0 = time.time()
        score, bk, bi, blocks = step(*x)
        _sync()
        return (score, bk, bi, torch.cat([b.to(dev) for b in blocks])), \
            time.time() - t0
    cards = torch.cuda.device_count()
    two = dict(cards=cards)
    for bis in (False, True):
        a, b = lanes(1300 + bis), lanes(1310 + bis)
        ps, pk, pi = sw.sw_align_device(*a, bisulfite=bis)
        ev_pos, ev_kind, ins_j, _ = sw.sw_traceback_device(
            *a, pk, pi, bisulfite=bis)
        plain = sw.pileup_scatter(
            ev_pos.reshape(-1).long(), ev_kind.reshape(-1),
            (ins_j >= 0).reshape(-1),
            torch.zeros((gs_pad, 6), dtype=torch.int16, device=dev))
        if not plain.any():
            raise AssertionError("sharded_map_step added no event")
        want_a = (ps, pk, pi, plain)
        eager = sharded_map_step(mesh, gs, bisulfite=bis, graph=False)
        want_b, t_eager = call(eager, b)
        step = sharded_map_step(mesh, gs, bisulfite=bis)
        k0 = sw_cuda.LAUNCHES["sw_align"]
        secs = []
        for name, x, want in (("eager call", a, want_a),
                              ("captured", b, want_b),
                              ("replayed", a, want_a)):
            got, t = call(step, x)
            secs.append(t)
            check(name, got, want, bis)
        launches += sw_cuda.LAUNCHES["sw_align"] - k0
        prog, = step.programs.values()
        key = "bisulfite" if bis else "plain"
        out[key] = dict(
            step_s=dict(zip(("eager_call", "capture_and_replay", "replay"),
                            secs)),
            graph_false_step_s=t_eager, capture_s=prog.capture_s,
            instantiate_s=prog.instantiate_s,
            pool_bytes_by_device=prog.pool_bytes_by_device,
            segments_a_shard=prog.segments, graphs_a_call=prog.n_graphs,
            events=int(plain.long().sum()))
        if cards >= 2:
            # the same step over two cards, bitwise to one card
            mesh2 = make_mesh(2, 1, [torch.device("cuda", i)
                                     for i in range(2)])
            step2 = sharded_map_step(mesh2, gs, bisulfite=bis)
            secs = []
            for name, x, want in (("two cards, eager call", a, want_a),
                                  ("two cards, captured", b, want_b),
                                  ("two cards, replayed", a, want_a)):
                got, t = call(step2, x)
                secs.append(t)
                check(name, got, want, bis)
            got, _ = call(sharded_map_step(mesh2, gs, bisulfite=bis,
                                           graph=False), b)
            check("two cards, graph=False", got, want_b, bis)
            prog2, = step2.programs.values()
            two[key] = dict(
                bitwise_to_one_card=True,
                step_s=dict(zip(("eager_call", "capture_and_replay",
                                 "replay"), secs)),
                pool_bytes_by_device=prog2.pool_bytes_by_device,
                graphs_a_call=prog2.n_graphs, copies_a_call=prog2.n_copies)
            del step2, prog2
        del step, eager, prog
    if cards < 2:
        two.update(ran=False, why="the machine has one card: the two-card "
                   "run did not happen")
    rng = np.random.default_rng(13)
    reads = torch.from_numpy(rng.integers(
        0, 400, (CALL_STEP_SITES, 3, 6)).astype(np.int16)).to(dev)
    ref_int = torch.from_numpy(rng.integers(
        0, 4, CALL_STEP_SITES).astype(np.uint8)).to(dev)
    want = site_likelihoods(reads, ref_int)
    t0 = time.time()
    got = sharded_call_step(mesh, 3, graph=False)(reads, ref_int)
    torch.cuda.synchronize(dev)
    t_eager = time.time() - t0
    if not torch.equal(got, want):
        raise AssertionError("sharded_call_step (graph=False) differs from "
                             "site_likelihoods on one device")
    call = sharded_call_step(mesh, 3)
    secs = []
    for name in ("eager call", "captured", "replayed"):
        t0 = time.time()
        got = call(reads, ref_int)
        torch.cuda.synchronize(dev)
        secs.append(time.time() - t0)
        if not torch.equal(got, want):
            raise AssertionError(f"sharded_call_step ({name}) differs from "
                                 "site_likelihoods on one device")
    prog, = call.programs.values()
    say("sharded_steps", shards=mesh.size, devices=[str(dev)] * mesh.size,
        map_lanes=MAP_STEP_LANES, map_shape=[160, 112], genome_size=gs,
        k3_launches=launches, bitwise=True, map=out,
        call_sites=CALL_STEP_SITES, call_equal_one_device=True,
        call_graph_equal_eager=True,
        call_step_s=dict(zip(("eager_call", "capture_and_replay", "replay"),
                             secs)),
        call_graph_false_step_s=t_eager,
        call_program=dict(capture_s=prog.capture_s,
                          instantiate_s=prog.instantiate_s,
                          pool_bytes=prog.pool_bytes),
        map_two_cards=two, seconds=time.time() - t_phase)
    return launches


def _foreign_modules():
    return {m for m in sys.modules
            if any(m == p or m.startswith(p + ".")
                   for p in ("jax", "pecaller_tpu"))}


REPLACES = {
    "sw_align_x": ("pecaller_tpu_torch/csrc/sw_align_x.cu",
                   "pecaller_tpu/ops/sw_pallas2.py:139"),
    "sw_tb_rows": ("pecaller_tpu_torch/csrc/sw_tb_rows.cu",
                   "pecaller_tpu/ops/sw_pallas2.py:325"),
    "sw_align": ("pecaller_tpu_torch/csrc/sw_align.cu",
                 "pecaller_tpu/ops/sw_pallas.py:118"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=100_000,
                    help="read pairs of the main-path runs")
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 only (card, build, kernel check): "
                    "the kernels line with launches null, no result line")
    ap.add_argument("--caller", action="store_true",
                    help="phases 1, 8, 8b and 12 only (card, caller, "
                    "screen contract, beam): no kernels line, no result "
                    "line")
    ap.add_argument("--scaleout", action="store_true",
                    help="phases 1-3, 9-11 and 13 (reads-axis mesh, "
                    "genome shards, two processes, sharded steps) with "
                    "the data and oracles they need: the kernels line, "
                    "no result line")
    args = ap.parse_args()
    t_start = time.time()
    sys.path.insert(0, ROOT)
    before = _foreign_modules()
    import torch
    card_info()
    if args.caller:
        cb, call_want = caller_path(args.pairs)
        screen_check()
        beam_path(cb, call_want)
        say("total", seconds=time.time() - t_start)
        return
    build(sass=args.kernels)
    kres = kernel_check()
    chain_check()
    if args.kernels:
        launches = dict.fromkeys(REPLACES)
    elif args.scaleout:
        make_data(args.pairs)
        host_dir, _ = map_oracle(args.pairs)
        cb, call_want, _, _ = call_oracle(args.pairs)
        launches = reads_mesh(args.pairs, host_dir, cb, call_want)
        make_data(MID_PAIRS, data=MID, length=MID_LEN, name="chr21x",
                  seed=2025)
        mid_host, _ = map_oracle(MID_PAIRS, MID)
        for k, v in genome_mesh(MID_PAIRS, mid_host).items():
            launches[k] += v
        multi_process(args.pairs, host_dir, cb, call_want)
        launches["sw_align"] += sharded_steps()
    else:
        launches, host = main_path(args.pairs)
        launches["sw_align"] += v1_path(args.pairs, host)["sw_align"]
        del host
        mid, host, octile = mid_path(MID_PAIRS)
        for k in launches:
            launches[k] += mid[k]
        k3_split, split_pools = split_path(MID_PAIRS, host)
        launches["sw_align"] += k3_split
        del host
        human_counts(split_pools=split_pools)
        cb, call_want = caller_path(args.pairs)
        screen_check()
        beam_path(cb, call_want)
        host_dir = os.path.join(DATA, "host")
        for k, v in reads_mesh(args.pairs, host_dir, cb, call_want).items():
            launches[k] += v
        for k, v in genome_mesh(MID_PAIRS, os.path.join(MID, "host"),
                                octile).items():
            launches[k] += v
        multi_process(args.pairs, host_dir, cb, call_want)
        launches["sw_align"] += sharded_steps()
    entered = sorted(_foreign_modules() - before)
    if entered:
        raise AssertionError(f"the run imported {entered[:5]}")
    say("total", seconds=time.time() - t_start)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": REPLACES[k][0],
         "replaces": REPLACES[k][1], "launches": launches[k],
         "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
         "plain_ms": kres[k]["plain_ms"], "bound_ms": kres[k]["bound"][0],
         "bound_by": kres[k]["bound"][1], "library_ms": None}
        for k in REPLACES]}), flush=True)
    if args.kernels or args.scaleout:
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
