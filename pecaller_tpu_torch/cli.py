"""Command line of the PyTorch port.

``python -m pecaller_tpu_torch pemapper <pemapper.c argv>
[--device[=DEV]] [--batch-size N]``: the argv of the reference
``pemapper`` (as ``python -m pecaller_tpu pemapper`` takes it).
``--device`` maps with the fused device engine on the first CUDA device
and fails where there is none; ``--device=cpu`` runs that engine on the
CPU (as the tests do); without it the exact host engine maps.
``--batch-size`` sets the read pairs per batch (default 20000).
"""

from __future__ import annotations

import sys

from .mapper.runner import MapperConfig, run_mapper


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


def parse_pemapper(argv) -> MapperConfig:
    argv = list(argv)
    dev_args = [a for a in argv
                if a == "--device" or a.startswith("--device=")]
    device = bool(dev_args)
    torch_device = None
    if dev_args:                # "--device=cpu" names the torch device
        torch_device = dev_args[-1].partition("=")[2] or None
    argv = [a for a in argv if a not in dev_args]
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
    else:
        f1, f2 = argv[3], None
        max_dist = min_dist = 0
        bis, min_align = _yes(argv[4]), float(argv[5])
        threads, max_reads = int(argv[6]), int(argv[7])
    if array:
        files1, _ = _read_list(f1)
        files2, _ = _read_list(f2) if paired else ([], [])
    else:
        files1 = [f1]
        files2 = [f2] if paired else []
    return MapperConfig(out_base=out, sdx_path=sdxp, paired=paired,
                        files1=files1, files2=files2, max_dist=max_dist,
                        min_dist=min_dist, bisulfite=bis,
                        min_align=min_align, max_reads=max_reads,
                        nthreads=max(1, threads - 1), device=device,
                        batch_size=batch_size, torch_device=torch_device)


def cmd_pemapper(argv) -> int:
    run_mapper(parse_pemapper(argv))
    return 0


COMMANDS = {"pemapper": cmd_pemapper}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m pecaller_tpu_torch pemapper <args> "
              "[--device[=DEV]] [--batch-size N]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])
