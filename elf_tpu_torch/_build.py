"""Build and load the port's native code: the CUDA kernels (nvcc) and the
host-side C helpers (the host C compiler), each into a shared library with
a plain C interface, loaded through ctypes.

A source `csrc/<name>.cu` or `csrc/<name>.c` becomes
`build/kernels/<name>-<hash>.so` at the root of the checkout, at first
use; the hash (`source_hash`) covers the source, the headers under `csrc/`
and the compiler flags, so an edited source or header rebuilds and an
unchanged one loads what is already there.  Nothing is built when a module
is imported, and a failed build raises.
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
CC_FLAGS = ("-O2", "-shared", "-fPIC")


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


def host_cc() -> str:
    """The host C compiler: $CC, then cc, gcc, clang on PATH."""
    for c in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no host C compiler found (set CC)")


def source_hash(src: Path, flags) -> str:
    """The hash that names the library of `src`: the source, every header
    beside it (`*.cuh`, `*.h`, by name and content) and the compiler
    flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted([*src.parent.glob("*.cuh"), *src.parent.glob("*.h")]):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Tuple[Path, str]:
    """Build csrc/<name>.cu (nvcc) or csrc/<name>.c (host compiler) unless
    it is built already.  Returns the library's path and the compiler's
    output, for nvcc with the ptxas report ("" when the library was
    already built)."""
    src = CSRC / f"{name}.cu"
    if src.exists():
        compiler, flags = nvcc, NVCC_FLAGS
    else:
        src = CSRC / f"{name}.c"
        compiler, flags = host_cc, CC_FLAGS
    out = BUILD_DIR / f"{name}-{source_hash(src, flags)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler(), *flags, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed for {src.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu or .c, built first if needed."""
    return ctypes.CDLL(str(build(name)[0]))
