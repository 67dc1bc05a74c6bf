"""Native (C) runtime components, built on demand with the system toolchain.

``swexact`` is the bit-exact float64 Smith-Waterman oracle engine used by
the parity mapper path and golden tests; the TPU production kernel lives in
ops/sw.py.
"""

from .build import load_swexact

__all__ = ["load_swexact"]
