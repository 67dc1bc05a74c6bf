"""pecaller_tpu_torch — the PyTorch/CUDA port of pecaller_tpu.

Paired- and single-end device mapping on one torch device (the first
CUDA device unless the caller names another, e.g. the CPU in tests):

  mapper/runner.py         run_mapper: engine choice; map_files: batch
                           loop, .mfile dumps, checkpoints, writers
  mapper/device_map2.py    the fused v2 step and FusedMapperEngine2
                           (nbr index; kernels K1, K2)
  mapper/device_pipeline.py  the fused v1 step and FusedMapperEngine
                           (exact-key seed tables; kernel K3)
  mapper/device_seeds.py   v1 seed tables and seed + chain core
  mapper/host_prep.py      numpy helpers (thresholds, genome packing)
  ops/sw2.py, ops/sw.py    plain integer SW align + traceback (PyTorch)
  ops/sw_cuda.py           wrappers of the CUDA kernels in csrc/
  index/quarter.py         size checks of the quartered-key index
  device.py                the entry points' torch device
  cli.py                   python -m pecaller_tpu_torch pemapper ...

Host code kept as its own copy of the reference package's JAX-free
modules, under the same sub-package names: formats/, index/builder.py,
index/nbr.py, native/ (C oracle engines, built into build/native/),
ops/encode.py, mapper/seeds.py, mapper/engine.py (the host oracle
MapperEngine), utils/ (hugepage allocator, logging).

This package imports torch and never jax, and nothing of
``pecaller_tpu``: not even its JAX-free modules.
"""

# Install the hugepage-backed numpy allocator (native/npalloc.c), as the
# reference package does at import: large host arrays fault 2 MiB pages.
# Opt out with PECALLER_NO_HUGEPAGES=1.
from .utils.npalloc import install as _npalloc_install  # noqa: E402

_npalloc_install()
