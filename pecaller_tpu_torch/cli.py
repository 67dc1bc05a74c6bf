"""Command line of the PyTorch port: every pipeline stage.

``python -m pecaller_tpu_torch <command> ...``, with the argv of the
reference binary or script each command replaces (as ``python -m
pecaller_tpu <command>`` takes it):

  index_genome      stdin answer-file protocol (index_genome_whole)
  pemapper          pemapper.c CLI [--device[=DEV] | --host]
                    [--batch-size N]
  pemapper_tsw      pemapper_tsw.c CLI (trimming + output groups), the
                    same options
  pecaller          pecaller.c CLI [--device[=DEV]]
  dump_pileups      dump_pileups.c CLI
  pecall_merger     pecall_merger.c CLI
  snp_to_vcf        snp_to_vcf.c CLI (stdout)
  make_snplist      make_snplist_formerge.pl
  make_snplist_restricted  make_snplist_formerge_restricted.pl
  merge_indel_snp   merge_indel_snp.pl
  snp_tran_counter  snp_tran_counter.pl (stdout)
  snp_tran_silent_rep  snp_tran_silent_rep.pl (stdout)
  map_directory     map_directory_array.pl (runs locally, no qsub)
                    [--device[=DEV] | --host]
  call_directory    call_directory.pl (runs locally, no qsub)
                    [--device[=DEV]]
  merge_dir_fa      merge_dir_fa.pl

Devices.  ``pemapper``, ``pemapper_tsw`` and ``map_directory`` map on
the card by default: the device engine that ``mapper.runner.
device_route`` names for the genome, on every visible CUDA device (a
reads mesh where there are several), and they fail where there is none.
``--device=DEV`` names the torch device (``--device=cpu`` runs the
device route on the CPU, as the tests do; a bare ``--device`` is the
default); ``--host`` maps with the exact host engine instead, which is
what the JAX package's command line does without ``--device``.
``--host`` with ``--device`` is a usage error (exit code 2).
``--batch-size`` sets the read pairs per batch (default 20000).
``pecaller`` and ``call_directory`` screen sites on the first CUDA
device and fail where there is none; ``--device=cpu`` screens on the
CPU.
"""

from __future__ import annotations

import os
import sys

USAGE = ("usage: python -m pecaller_tpu_torch <command> <args>; commands: "
         "index_genome, pemapper, pemapper_tsw, pecaller, dump_pileups, "
         "pecall_merger, snp_to_vcf, make_snplist, make_snplist_restricted, "
         "merge_indel_snp, snp_tran_counter, snp_tran_silent_rep, "
         "map_directory, call_directory, merge_dir_fa; the mappers "
         "(pemapper, pemapper_tsw, map_directory) run on the card unless "
         "given --host (the exact host engine) or --device=cpu")


class UsageError(ValueError):
    """A command line that names conflicting options (exit code 2)."""


def _yes(s: str) -> bool:
    return "y" in s.lower()


def _read_list(path):
    names, out_names = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or len(tok[0]) <= 2:
                break
            names.append(tok[0])
            out_names.append(tok[1] if len(tok) > 1 else "")
    return names, out_names


def _take_device(argv):
    """(argv without its --device[=DEV] flags, whether one was given,
    DEV or None)."""
    flags = [a for a in argv if a == "--device" or a.startswith("--device=")]
    dev = (flags[-1].partition("=")[2] or None) if flags else None
    return [a for a in argv if a not in flags], bool(flags), dev


def _take_route(argv):
    """(argv without its --device[=DEV] and --host flags, whether the
    device route maps, DEV or None): the device route unless --host."""
    argv, device, torch_device = _take_device(argv)
    host = "--host" in argv
    if host and device:
        raise UsageError("--host (the exact host engine) and --device "
                         "(the device route) exclude each other")
    return [a for a in argv if a != "--host"], not host, torch_device


def parse_pemapper(argv, tsw: bool = False):
    """The MapperConfig of a ``pemapper`` (``tsw``: ``pemapper_tsw``,
    two trim arguments after max_reads and the array list's output
    names) command line."""
    from .mapper.runner import MapperConfig
    argv, device, torch_device = _take_route(list(argv))
    batch_size = MapperConfig.batch_size
    if "--batch-size" in argv:
        k = argv.index("--batch-size")
        batch_size = int(argv[k + 1])
        del argv[k:k + 2]
    out, sdxp, mode = argv[0], argv[1], argv[2]
    paired = mode[0].upper() == "P"
    array = len(mode) > 1 and mode[1].upper() == "A"
    if paired:
        f1, f2 = argv[3], argv[4]
        max_dist, min_dist = int(argv[5]), int(argv[6])
        bis, min_align = _yes(argv[7]), float(argv[8])
        threads, max_reads = int(argv[9]), int(argv[10])
        trim = (int(argv[11]), int(argv[12])) if tsw else (0, 0)
    else:
        f1, f2 = argv[3], None
        max_dist = min_dist = 0
        bis, min_align = _yes(argv[4]), float(argv[5])
        threads, max_reads = int(argv[6]), int(argv[7])
        trim = (int(argv[8]), int(argv[9])) if tsw else (0, 0)
    out_names = []
    if array:
        files1, out_names = _read_list(f1)
        files2, _ = _read_list(f2) if paired else ([], [])
    else:
        files1 = [f1]
        files2 = [f2] if paired else []
    return MapperConfig(out_base=out, sdx_path=sdxp, paired=paired,
                        files1=files1, files2=files2, max_dist=max_dist,
                        min_dist=min_dist, bisulfite=bis,
                        min_align=min_align, max_reads=max_reads,
                        nthreads=max(1, threads - 1), device=device,
                        batch_size=batch_size, torch_device=torch_device,
                        trim_start=trim[0], trim_end=trim[1],
                        out_names=out_names if tsw else [])


def parse_pecaller(argv):
    """The CallerConfig of a ``pecaller`` command line."""
    from .caller import CallerConfig
    argv, _, device = _take_device(list(argv))
    ext, sdxp = argv[0], argv[1]
    out = argv[3]
    prob, theta = float(argv[4]), float(argv[5])
    haploid = _yes(argv[6])
    threads = int(argv[7])
    use_ped = _yes(argv[8])
    ped = dn = guide = None
    rest = argv[9:]
    if use_ped:
        ped, dn = rest[0], float(rest[1])
        guide = rest[2] if len(rest) > 2 else None
    else:
        guide = rest[0] if rest else None
    return CallerConfig(pileup_ext=ext, sdx_path=sdxp, out_base=out,
                        prob_to_call=prob, theta=theta, haploid=haploid,
                        use_ped=use_ped, ped_path=ped,
                        denovo_rate=dn if dn else 1e-8, guide_path=guide,
                        nthreads=max(1, threads - 1), device=device)


def parse_dump_pileups(argv):
    """The CallerConfig of a ``dump_pileups`` command line (no screen:
    every site is dumped)."""
    from .caller import CallerConfig
    return CallerConfig(pileup_ext=argv[0], sdx_path=argv[1],
                        out_base=argv[3], prob_to_call=float(argv[4]),
                        theta=float(argv[5]), haploid=_yes(argv[6]),
                        nthreads=max(1, int(argv[7]) - 1), dump_mode=True)


def parse_map_directory(argv):
    """Pair the fastqs of a directory (map_directory_array.pl, run
    locally instead of qsub): the MapperConfig that maps them."""
    from .mapper.runner import MapperConfig
    argv, device, torch_device = _take_route(list(argv))
    directory, sdxp = argv[0], argv[1]
    fastqs = sorted(set(
        f.split(".")[0] for f in os.listdir(directory)
        if "fastq" in f and not f.endswith("mfile")))
    tails = {}
    for f in os.listdir(directory):
        if "fastq" in f and not f.endswith("mfile"):
            parts = f.split(".")
            tails[parts[0]] = "." + ".".join(parts[1:])
    matches = {}
    for a in fastqs:
        b = a.replace("_1_", "_2_").replace("_R1_", "_R2_")
        if b != a and b in fastqs:
            matches[a] = b
            matches[b] = a
    files1, files2 = [], []
    done = set()
    paired = False
    for a in fastqs:
        if a in done:
            continue
        if a in matches:
            paired = True
            b = matches[a]
            done.update((a, b))
            files1.append(os.path.join(directory, a + tails[a]))
            files2.append(os.path.join(directory, b + tails[b]))
        else:
            done.add(a)
            files1.append(os.path.join(directory, a + tails[a]))
    return MapperConfig(out_base=directory.rstrip("/"), sdx_path=sdxp,
                        paired=paired, files1=files1, files2=files2,
                        max_dist=500, min_dist=0, min_align=0.85,
                        max_reads=200000000, nthreads=23, device=device,
                        torch_device=torch_device)


def parse_call_directory(argv):
    """The CallerConfig of call_directory.pl (run locally): the
    directory's pileups, optional guide bed and pedigree."""
    from .caller import CallerConfig
    argv, _, device = _take_device(list(argv))
    directory, sdxp = argv[0], argv[1]
    guide = argv[2] if len(argv) > 2 else None
    ped = argv[3] if len(argv) > 3 else None
    return CallerConfig(pileup_ext="pileup", sdx_path=sdxp,
                        out_base=directory.rstrip("/"), prob_to_call=0.95,
                        theta=0.001, haploid=False, use_ped=ped is not None,
                        ped_path=ped, denovo_rate=1e-8, guide_path=guide,
                        directory=directory, nthreads=23, device=device)


def cmd_merge_dir_fa(argv):
    """Merge per-chromosome .fa.gz into one fasta (merge_dir_fa.pl)."""
    import argparse
    import gzip
    import time
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dir", required=True)
    ap.add_argument("-c", "--chr_list", required=True)
    ap.add_argument("-o", "--out", required=True)
    ns = ap.parse_args(argv)
    chrs = []
    for part in ns.chr_list.split(","):
        if "-" in part and part[0].isdigit():
            a, b = part.split("-")
            chrs += [f"chr{i}" for i in range(int(a), int(b) + 1)]
        else:
            chrs.append(f"chr{part}")
    found = {}
    for f in sorted(os.listdir(ns.dir)):
        if f.endswith(".fa.gz"):
            with gzip.open(os.path.join(ns.dir, f), "rt") as fh:
                found[f[:-6]] = fh.read()
    stamp = time.strftime("%Y-%m-%d")
    outpath = f"{ns.out}.{stamp}.fa"
    with open(outpath, "w") as out:
        printed = set()
        for c in chrs:
            if c not in found:
                raise SystemExit(f"ERROR: Did not find expected chr '{c}'")
            out.write(found[c])
            printed.add(c)
        for c in sorted(found):
            if c not in printed:
                out.write(found[c])
    print(f"Wrote {outpath}")
    return 0


def _index_genome(argv):
    from .index import index_genome_cli
    return index_genome_cli(argv)


def _map(cfg):
    from .mapper.runner import run_mapper
    run_mapper(cfg)
    return 0


def _call(cfg):
    from .caller import run_caller
    run_caller(cfg)
    return 0


def _merger(argv):
    from .cohort import run_merger
    # maxsnps/maxsamples (argv[0:2]) are allocation hints; unused here
    run_merger(bedfile=argv[2], outfile=argv[3], sdxfile=argv[4],
               is_haploid=_yes(argv[5]))
    return 0


def _snp_to_vcf(argv):
    from .cohort import snp_to_vcf
    min_prob = float(argv[2]) if len(argv) > 2 else 0.0
    snp_to_vcf(argv[0], argv[1], sys.stdout, min_prob=min_prob)
    return 0


def _cohort(name, n_args, stdout=False):
    """A cohort-tail stage taking ``n_args`` positional arguments (and
    sys.stdout last where it prints)."""
    def run(argv):
        from . import cohort
        fn = getattr(cohort, name)
        fn(*argv[:n_args], *((sys.stdout,) if stdout else ()))
        return 0
    return run


COMMANDS = {
    "index_genome": _index_genome,
    "pemapper": lambda a: _map(parse_pemapper(a)),
    "pemapper_tsw": lambda a: _map(parse_pemapper(a, tsw=True)),
    "pecaller": lambda a: _call(parse_pecaller(a)),
    "dump_pileups": lambda a: _call(parse_dump_pileups(a)),
    "pecall_merger": _merger,
    "snp_to_vcf": _snp_to_vcf,
    "make_snplist": _cohort("make_snplist", 2),
    "make_snplist_restricted": _cohort("make_snplist_restricted", 2),
    "merge_indel_snp": _cohort("merge_indel_snp", 4),
    "snp_tran_counter": _cohort("snp_tran_counter", 1, stdout=True),
    "snp_tran_silent_rep": _cohort("snp_tran_silent_rep", 3, stdout=True),
    "map_directory": lambda a: _map(parse_map_directory(a)),
    "call_directory": lambda a: _call(parse_call_directory(a)),
    "merge_dir_fa": cmd_merge_dir_fa,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    try:
        return COMMANDS[argv[0]](argv[1:])
    except UsageError as e:
        print(f"{argv[0]}: {e}\n{USAGE}", file=sys.stderr)
        return 2
