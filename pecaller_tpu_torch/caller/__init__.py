"""The variant caller: pileup streams, the site screen on a torch device
and the exact native engine (``run_caller``)."""

from .runner import run_caller, CallerConfig

__all__ = ["run_caller", "CallerConfig"]
