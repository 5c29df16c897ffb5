"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each source is compiled on first use into `build/kernels/` at the root of
the checkout, as a shared library with a plain C interface, named by a hash
of its source, the `csrc/` headers it includes and the flags, so an edited
source or included header rebuilds and an unchanged one loads from the
previous build. The renderer's kernels and the SSIM loss's share this.
Nothing here runs at import time.

The compiler's report (`-Xptxas -v`: registers, shared memory, spills) is
kept beside the library as `<name>-<hash>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its build is current; returns the
    library's path. Raises with the compiler's output when nvcc fails."""
    # the source, the headers beside it that it includes, and the flags
    source = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'#include\s+"([^"/]+\.cuh)"', source)))
    src = b"".join([source, *((CSRC / h.decode()).read_bytes() for h in headers)])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    return ctypes.CDLL(str(build(name)))
