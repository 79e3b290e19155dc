"""The Go engine's two liberty kernels: CUDA wrappers and plain versions.

Counterpart of `elf_tpu/env/go/pallas_kernels.py`.  Each kernel has

 - a wrapper (`analyze_libs_cuda`, `step_analysis_cuda`) that checks its
   inputs, allocates the outputs and launches the CUDA kernel of
   `csrc/go_libs.cu` (union-find labelling in shared memory) on the
   current stream, counting the launch;
 - a plain PyTorch version (`analyze_libs_ref`, `step_analysis_ref`): the
   CPU path and the oracle the kernel is held against on the card;
 - a dispatcher (`analyze_libs`, `step_analysis`) that takes the kernel for
   a CUDA tensor, at every batch size, and the plain version for a CPU
   tensor.  There is no fall back from the kernel to the plain version.

Shapes and dtypes are the JAX functions': stones int8 [B, N*N] (or
[B, N, N]), action / color int32 [B]; lib_min / lib_max int32 [B, N, N],
captured bool [B, N*N].
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

INF = 2**20
EMPTY = 0

# Launch counts of the CUDA kernels (one per wrapper call that launched).
analyze_libs_launches = 0
step_analysis_launches = 0


def reset_launch_counts() -> None:
    global analyze_libs_launches, step_analysis_launches
    analyze_libs_launches = 0
    step_analysis_launches = 0


def launch_counts() -> dict:
    return {
        "analyze_libs": analyze_libs_launches,
        "step_analysis": step_analysis_launches,
    }


def add_launch_counts(counts: dict) -> None:
    """Add `counts` (keyed as `launch_counts`) to the launch counts: what a
    replayed CUDA graph launches, or minus what its capture counted."""
    global analyze_libs_launches, step_analysis_launches
    analyze_libs_launches += counts["analyze_libs"]
    step_analysis_launches += counts["step_analysis"]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def shift(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """out[..., r, c] = x[..., r - dr, c - dc], `fill` outside the board."""
    n = x.shape[-1]
    out = torch.full_like(x, fill)
    out[..., max(dr, 0):n + min(dr, 0), max(dc, 0):n + min(dc, 0)] = (
        x[..., max(-dr, 0):n + min(-dr, 0), max(-dc, 0):n + min(-dc, 0)]
    )
    return out


def _init_lib_fields(stones2d: torch.Tensor):
    """Per-stone min/max flat index of *adjacent* empty points."""
    n = stones2d.shape[-1]
    idx = torch.arange(n * n, dtype=torch.int32,
                       device=stones2d.device).reshape(n, n)
    idx = idx.expand(stones2d.shape)
    empty = stones2d == EMPTY
    lm = torch.full(stones2d.shape, INF, dtype=torch.int32,
                    device=stones2d.device)
    lx = torch.full_like(lm, -1)
    for dr, dc in _DIRS:
        nbr_empty = shift(empty, dr, dc, False)
        nbr_idx = shift(idx, dr, dc, 0)
        lm = torch.where(nbr_empty, torch.minimum(lm, nbr_idx), lm)
        lx = torch.where(nbr_empty, torch.maximum(lx, nbr_idx), lx)
    stone = ~empty
    lm = torch.where(stone, lm, INF)
    lx = torch.where(stone, lx, -1)
    return lm, lx


def _fixpoint(stones2d: torch.Tensor, lm: torch.Tensor, lx=None):
    """Min (and max, when `lx` is given) propagation over same-colour
    4-connectivity until nothing changes (one host sync per round)."""
    same = [
        (stones2d != EMPTY) & (shift(stones2d, dr, dc, 0) == stones2d)
        for dr, dc in _DIRS
    ]
    while True:
        plm, plx = lm, lx
        for (dr, dc), sm in zip(_DIRS, same):
            lm = torch.where(sm, torch.minimum(lm, shift(lm, dr, dc, INF)), lm)
            if lx is not None:
                lx = torch.where(sm, torch.maximum(lx, shift(lx, dr, dc, -1)),
                                 lx)
        changed = (lm != plm).any()
        if lx is not None:
            changed = changed | (lx != plx).any()
        if not bool(changed):
            return lm, lx


def analyze_libs_ref(stones2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the liberty fixpoint (`engine._analyze_libs_neighbor`
    of the JAX package): int8 [B, N, N] -> (lib_min, lib_max) int32."""
    lm, lx = _init_lib_fields(stones2d)
    return _fixpoint(stones2d, lm, lx)


def step_analysis_ref(stones: torch.Tensor, action: torch.Tensor,
                      color: torch.Tensor):
    """Plain version of the fused step analysis: the XLA branch of
    `engine.step_core` with the kernel's placement rule (0 <= action < N*N
    places `color`, overwriting; anything else places nothing)."""
    B, n2 = stones.shape
    size = math.isqrt(n2)
    pts = torch.arange(n2, dtype=torch.int32, device=stones.device)
    place = (pts[None, :] == action[:, None]) & (action < n2)[:, None]
    s1 = torch.where(place, color[:, None].to(torch.int8), stones)
    s1_2d = s1.reshape(B, size, size)
    lm1, _ = _fixpoint(s1_2d, _init_lib_fields(s1_2d)[0])
    opp = (3 - color).to(torch.int8)
    captured = (lm1 == INF) & (s1_2d == opp[:, None, None])
    s2_2d = torch.where(captured, torch.zeros_like(s1_2d), s1_2d)
    lm, lx = analyze_libs_ref(s2_2d)
    return s2_2d.reshape(B, n2), lm, lx, captured.reshape(B, n2)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from elf_tpu_torch import _build

        lib = _build.load("go_libs")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.go_analyze_libs.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.go_step_analysis.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                         vp]
        lib.go_analyze_libs.restype = lib.go_step_analysis.restype = ci
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _board_size(n2: int) -> int:
    size = math.isqrt(n2)
    if size * size != n2 or not 2 <= size <= 32:
        raise ValueError(f"unsupported board: {n2} points")
    return size


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def analyze_libs_cuda(stones2d: torch.Tensor):
    """CUDA liberty analysis (union-find in shared memory): int8 [B, N, N]
    -> (lib_min, lib_max) int32; nothing is launched for an empty batch."""
    global analyze_libs_launches
    B, n, _ = stones2d.shape
    _check(stones2d, "stones2d", torch.int8, (B, n, n))
    _board_size(n * n)
    lm = torch.empty((B, n, n), dtype=torch.int32, device=stones2d.device)
    lx = torch.empty_like(lm)
    if B == 0:
        return lm, lx
    stream = torch.cuda.current_stream(stones2d.device).cuda_stream
    rc = _kernels().go_analyze_libs(
        stones2d.data_ptr(), lm.data_ptr(), lx.data_ptr(), B, n, stream
    )
    _raise_on(rc, "go_analyze_libs")
    analyze_libs_launches += 1
    return lm, lx


def step_analysis_cuda(stones: torch.Tensor, action: torch.Tensor,
                       color: torch.Tensor):
    """CUDA fused step analysis (union-find in shared memory): (s2 int8
    [B, N*N], lib_min int32 [B, N, N], lib_max int32 [B, N, N], captured
    bool [B, N*N]); nothing is launched for an empty batch."""
    global step_analysis_launches
    B, n2 = stones.shape
    size = _board_size(n2)
    _check(stones, "stones", torch.int8, (B, n2))
    _check(action, "action", torch.int32, (B,))
    _check(color, "color", torch.int32, (B,))
    if action.device != stones.device or color.device != stones.device:
        raise ValueError("stones, action and color must share one device")
    dev = stones.device
    s2 = torch.empty((B, n2), dtype=torch.int8, device=dev)
    lm = torch.empty((B, size, size), dtype=torch.int32, device=dev)
    lx = torch.empty_like(lm)
    cap = torch.empty((B, n2), dtype=torch.bool, device=dev)
    if B == 0:
        return s2, lm, lx, cap
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernels().go_step_analysis(
        stones.data_ptr(), action.data_ptr(), color.data_ptr(),
        s2.data_ptr(), lm.data_ptr(), lx.data_ptr(), cap.data_ptr(),
        B, size, stream,
    )
    _raise_on(rc, "go_step_analysis")
    step_analysis_launches += 1
    return s2, lm, lx, cap


# ---------------------------------------------------------------------------
# dispatch: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------


def analyze_libs(stones2d: torch.Tensor):
    if stones2d.is_cuda:
        return analyze_libs_cuda(stones2d.contiguous())
    return analyze_libs_ref(stones2d)


def step_analysis(stones: torch.Tensor, action: torch.Tensor,
                  color: torch.Tensor):
    if stones.is_cuda:
        return step_analysis_cuda(stones.contiguous(), action.contiguous(),
                                  color.contiguous())
    return step_analysis_ref(stones, action, color)
