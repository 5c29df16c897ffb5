"""Native (C++) host-side helpers, built with g++ and loaded with ctypes.

Port of the JAX package's `native/` loader. `colmap_fast.cpp` is a copy of
its source. The library is built on first use into `build/native/` at the
root of the checkout, named by a hash of its source and the flags (as
`renderer/_build.py` names the CUDA libraries), so an edited source
rebuilds and nothing is written inside the package. `load_library(name)`
returns the ctypes library, or None when no compiler is present or the
build fails: callers keep a pure-Python path for that case. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(name: str) -> Path:
    """Compile `<name>.cpp` unless its build is current; returns the
    library's path. Raises when g++ is missing or fails."""
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", tmp], check=True,
                       capture_output=True)
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(name: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(str(build(name)))
    except (OSError, subprocess.CalledProcessError):
        return None
