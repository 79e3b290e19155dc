"""Build and load the port's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded through ctypes).

A source `csrc/<name>.cu` becomes `build/kernels/<name>-<hash>.so` at the
root of the checkout, at first use; the hash covers the source and the
compiler flags, so an edited source rebuilds and an unchanged one loads
what is already there.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> Tuple[Path, str]:
    """Build csrc/<name>.cu unless it is built already.  Returns the
    library's path and nvcc's output with the ptxas report ("" when the
    library was already built)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return out, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build(name)[0]))
