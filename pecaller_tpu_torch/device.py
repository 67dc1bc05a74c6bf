"""The torch device of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; None means the first CUDA device.
    Raises where CUDA is asked for and there is none: the device path
    runs on the card unless the caller names the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: the device path runs on the card; "
            "pass device=\"cpu\" (--device=cpu on the command line) to run "
            "it on the CPU, or map with the exact host engine "
            "(MapperConfig(device=False), --host)")
    return dev
