"""Structured logging + profiling (SURVEY §5.1: the reference has only
progress printfs; the new build gets structured timing from day one).

Usage:
    from pecaller_tpu_torch.utils.log import get_logger, stage_timer
    log = get_logger("mapper")
    with stage_timer(log, "sw_batch", reads=B):
        ...

Set PECALLER_TPU_LOG=json for machine-readable lines, =0 to silence.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time

_FMT = os.environ.get("PECALLER_TPU_LOG", "text")


def get_logger(name: str) -> logging.Logger:
    log = logging.getLogger(f"pecaller_tpu_torch.{name}")
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(h)
        log.setLevel(logging.WARNING if _FMT == "0" else logging.INFO)
        log.propagate = False
    return log


def event(log: logging.Logger, kind: str, **fields) -> None:
    if _FMT == "json":
        log.info(json.dumps({"event": kind, **fields}))
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        log.info("%s %s", kind, kv)


@contextlib.contextmanager
def stage_timer(log: logging.Logger, stage: str, **fields):
    t0 = time.time()
    try:
        yield
    finally:
        event(log, "stage", name=stage, secs=round(time.time() - t0, 4),
              **fields)

