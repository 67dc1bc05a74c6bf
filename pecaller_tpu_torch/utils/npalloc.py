"""Build + install the hugepage numpy allocator (native/npalloc.c).

Call :func:`install` once per process (idempotent).  Set
``PECALLER_NO_HUGEPAGES=1`` to disable.  See native/npalloc.c for why
this matters on this VM (4 KiB first-touch at ~30-50 MB/s).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

_installed = False


def _build() -> str:
    import numpy as np
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(pkg, "native", "npalloc.c")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    cache = os.path.join(os.path.dirname(pkg), "build", "npalloc", digest)
    so = os.path.join(cache, "pecaller_npalloc" + suffix)
    if not os.path.exists(so):
        os.makedirs(cache, exist_ok=True)
        tmp = so + f".build{os.getpid()}"
        subprocess.run(
            ["gcc", "-O2", "-shared", "-fPIC",
             "-I" + sysconfig.get_paths()["include"],
             "-I" + np.get_include(), "-o", tmp, src],
            check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def install() -> bool:
    """Install the allocator; returns True if active."""
    global _installed
    if _installed:
        return True
    if os.environ.get("PECALLER_NO_HUGEPAGES"):
        return False
    try:
        so = _build()
        spec = importlib.util.spec_from_file_location(
            "pecaller_npalloc", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.install()
        _installed = True
        return True
    except Exception:
        return False
