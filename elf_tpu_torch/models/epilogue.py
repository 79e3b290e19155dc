"""The serving nets' epilogues: what follows each convolution of a frozen
net, as one pass.

The post-activation ResNet (`PolicyValueNet`) has one mode, `epilogue`.

After a convolution `v` (compute dtype) of the serving forward:

    v = v + conv_bias                   (where given: cuDNN's own bias add)
    y = relu((float(v) - mean) * mul + bias).to(dtype)
    y = relu(skip + y)                  (where given: the residual add)

with BatchNorm's running statistics and `mul = rsqrt(running_var + eps) *
weight`, which the caller computes once.  These are the passes, roundings
and order of operations of `BatchNorm.forward` + ReLU + casts (+ the skip
add of `ResBlock.forward`), so every version here gives the same bits.

 - `epilogue_cuda`: checks its inputs, allocates the output and launches
   the CUDA kernel of `csrc/net_epilogue.cu` on the current stream,
   counting the launch (`launches["net_epilogue"]`); activations NHWC (`channels_last`),
   bf16 or fp32, channels a multiple of 8 (bf16) or 4 (fp32);
 - `epilogue_ref`: the plain PyTorch version, any layout: the CPU path and
   the oracle the kernel is held against on the card;
 - `epilogue`: the kernel for a CUDA tensor, the plain version for a CPU
   tensor, counted as `net.epilogues` while tracing is on.

The pre-activation nested-bottleneck net (`models/nbt.py`) has two more,
each with an activation `act`, "relu" or "mish" (`mish`, KataGo's form of
x * tanh(softplus(x))), and the kernels of `csrc/nbt_epilogue.cu`, a
library of its own that only such a net loads:

    normact   s = skip + v                  (where given: the residual add)
              f = float(s) + rowbias[b, c]  (where given: a per-row bias)
              y = act((f - mean) * mul + bias).to(dtype)
              -> y, or (s, y) with the skip
    pool      g = act((float(v) - mean) * mul + bias)       (fp32, not kept)
              -> fp32 [B, 3C]: `board_pool(g, kind)`

`board_pool` is KataGo's pooling over the board's A = H x W points, with
the sum taken in a fixed order (along each board row, then over the rows)
so that the kernel gives its bits: "gpool" [mean, mean (sqrt(A) - 14) /
10, max], "value" [mean, mean (sqrt(A) - 14) / 10, mean ((sqrt(A) - 14)^2
/ 100 - 0.1)].  `normact_ref` / `pool_ref` are the plain versions,
`normact_cuda` / `pool_cuda` the kernels, and `normact` / `pool` choose by
the tensor's device and count `net.epilogues` (and a pool `net.gpools`
too) while tracing is on.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from elf_tpu_torch import profiling

# Launches of each CUDA kernel, by kernel name (one per wrapper call that
# launched): `epilogue_cuda`'s, and the nested-bottleneck net's
# (`normact_cuda`, `pool_cuda`).
launches = {"net_epilogue": 0, "nbt_normact": 0, "nbt_pool": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def epilogue_ref(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
                 conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: v [B, C, H, W] in the compute dtype; mean, mul, bias
    fp32 [C]; skip like v; conv_bias [C] in v's dtype."""
    dt = v.dtype
    if conv_bias is not None:
        v = v + conv_bias[:, None, None]
    y = (v.float() - mean[:, None, None]) * mul[:, None, None]
    y = F.relu(y + bias[:, None, None]).to(dt)
    if skip is None:
        return y
    return F.relu(skip + y)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from elf_tpu_torch import _build

        lib = _build.load("net_epilogue")
        vp = ctypes.c_void_p
        lib.net_epilogue.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, vp]
        lib.net_epilogue.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_layout(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected a channels_last tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")


def _check_channel(t: torch.Tensor, name: str, dtype: torch.dtype, C: int,
                   device) -> None:
    if t.device != device or t.dtype != dtype or t.shape != (C,) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} [{C}] on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def epilogue_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                  bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
                  conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel: v [B, C, H, W] channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes; the rest as `epilogue_ref`.  Returns a new
    channels_last tensor like v."""
    if not v.is_cuda:
        raise ValueError(f"v: expected a CUDA tensor, got {v.device}")
    if v.dtype not in _DTYPES or v.dim() != 4:
        raise TypeError(f"v: expected a 4-d bf16 or fp32 tensor, got "
                        f"{v.dtype} {tuple(v.shape)}")
    _check_layout(v, "v")
    B, C, H, W = v.shape
    lanes = 16 // v.element_size()
    if C % lanes or C // lanes > 256:
        raise ValueError(f"v: {C} channels; the kernel takes multiples of "
                         f"{lanes} up to {256 * lanes}")
    for t, name in ((mean, "mean"), (mul, "mul"), (bias, "bias")):
        _check_channel(t, name, torch.float32, C, v.device)
    if conv_bias is not None:
        _check_channel(conv_bias, "conv_bias", v.dtype, C, v.device)
    if skip is not None:
        if (skip.device, skip.dtype, skip.shape) != (v.device, v.dtype,
                                                     v.shape):
            raise ValueError(f"skip: expected {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}, got {skip.dtype} "
                             f"{tuple(skip.shape)} on {skip.device}")
        _check_layout(skip, "skip")
    out = torch.empty_like(v, memory_format=torch.channels_last)
    if v.numel() == 0:
        return out
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _kernel().net_epilogue(
        v.data_ptr(), None if conv_bias is None else conv_bias.data_ptr(),
        mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(),
        B * H * W, C, _DTYPES[v.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"net_epilogue: CUDA error {rc} at launch")
    launches["net_epilogue"] += 1
    return out


def epilogue(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
             bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
             conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    profiling.count("net.epilogues")
    if v.is_cuda:
        return epilogue_cuda(v, mean, mul, bias, skip, conv_bias)
    return epilogue_ref(v, mean, mul, bias, skip, conv_bias)


# ---------------------------------------------------------------------------
# the nested-bottleneck net's modes
# ---------------------------------------------------------------------------

ACTS = {"relu": 0, "mish": 1}
POOLS = {"gpool": 0, "value": 1}
LOG2E = 1.4426950408889634


def mish(f: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in KataGo's form: with e = exp(x), taken as
    2^(x log2 e), and n = e (e + 2), tanh(softplus(x)) = n / (n + 2),
    taken as x n r for x <= -0.6 and x - 2 x r above, r = 1 / (n + 2);
    each op rounded in f's dtype.  Large x gives x (r falls to 0), +inf
    gives NaN."""
    e = torch.exp2(f * LOG2E)
    n = e * (e + 2.0)
    r = torch.reciprocal(n + 2.0)
    neg = f <= -0.6
    t = torch.where(neg, n, f) * r
    return torch.where(neg, f * t, f - 2.0 * t)


def activation(name: str):
    """The activation called `name`: "relu" or "mish"."""
    if name not in ACTS:
        raise ValueError(f"activation {name!r}: expected one of "
                         f"{sorted(ACTS)}")
    return F.relu if name == "relu" else mish


def pool_scales(area: int) -> tuple:
    """(1 / A, (sqrt(A) - 14) / 10, (sqrt(A) - 14)^2 / 100 - 0.1) in double,
    each rounded to fp32 where it meets an fp32 tensor."""
    root = math.sqrt(area) - 14.0
    return 1.0 / area, root / 10.0, root * root / 100.0 - 0.1


def board_pool(g: torch.Tensor, kind: str) -> torch.Tensor:
    """g fp32 [B, C, H, W] -> fp32 [B, 3C]: KataGo's pooling ("gpool" or
    "value", see the module), the sum and the max taken along each board
    row (w = 0, 1, ...), then over the rows (h = 0, 1, ...); the max is
    `fmax`, which passes over a NaN."""
    B, C, H, W = g.shape
    rs = rm = g[..., 0]
    for w in range(1, W):
        rs = rs + g[..., w]
        rm = torch.fmax(rm, g[..., w])
    s, m = rs[..., 0], rm[..., 0]
    for h in range(1, H):
        s = s + rs[..., h]
        m = torch.fmax(m, rm[..., h])
    inv, k1, k2 = pool_scales(H * W)
    mean = s * inv
    third = m if POOLS[kind] == 0 else mean * k2
    return torch.cat([mean, mean * k1, third], 1)


def normact_ref(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                bias: torch.Tensor, act: str,
                skip: Optional[torch.Tensor] = None,
                rowbias: Optional[torch.Tensor] = None):
    """Plain version: v [B, C, H, W] in the compute dtype; mean, mul, bias
    fp32 [C]; skip like v; rowbias fp32 [B, C].  Returns y, or (s, y)
    with the skip."""
    dt = v.dtype
    if skip is not None:
        v = skip + v
    f = v.float()
    if rowbias is not None:
        f = f + rowbias[:, :, None, None]
    y = (f - mean[:, None, None]) * mul[:, None, None]
    y = activation(act)(y + bias[:, None, None]).to(dt)
    return y if skip is None else (v, y)


def pool_ref(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
             bias: torch.Tensor, act: str, kind: str) -> torch.Tensor:
    """Plain version: v [B, C, H, W] in the compute dtype; mean, mul, bias
    fp32 [C] -> fp32 [B, 3C]."""
    y = (v.float() - mean[:, None, None]) * mul[:, None, None]
    return board_pool(activation(act)(y + bias[:, None, None]), kind)


_nbt_lib = None


def _nbt_kernel():
    global _nbt_lib
    if _nbt_lib is None:
        from elf_tpu_torch import _build

        lib = _build.load("nbt_epilogue")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.nbt_normact.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                    ctypes.c_longlong, i, i, i, i, vp]
        lib.nbt_pool.argtypes = [vp, vp, vp, vp, vp, i, i, i, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_float, i, i, i, vp]
        lib.nbt_normact.restype = lib.nbt_pool.restype = i
        _nbt_lib = lib
    return _nbt_lib


def _check_input(v: torch.Tensor, mean, mul, bias, act: str) -> tuple:
    """The checks both kernels make; returns (B, C, H, W)."""
    if not v.is_cuda:
        raise ValueError(f"v: expected a CUDA tensor, got {v.device}")
    if v.dtype not in _DTYPES or v.dim() != 4:
        raise TypeError(f"v: expected a 4-d bf16 or fp32 tensor, got "
                        f"{v.dtype} {tuple(v.shape)}")
    _check_layout(v, "v")
    B, C, H, W = v.shape
    lanes = 16 // v.element_size()
    if C % lanes or C // lanes > 256:
        raise ValueError(f"v: {C} channels; the kernels take multiples of "
                         f"{lanes} up to {256 * lanes}")
    for t, name in ((mean, "mean"), (mul, "mul"), (bias, "bias")):
        _check_channel(t, name, torch.float32, C, v.device)
    activation(act)
    return B, C, H, W


def normact_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, act: str,
                 skip: Optional[torch.Tensor] = None,
                 rowbias: Optional[torch.Tensor] = None):
    """The CUDA kernel of `normact_ref`: v channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes; skip and rowbias not both.  Returns new
    channels_last tensors like v."""
    B, C, H, W = _check_input(v, mean, mul, bias, act)
    if skip is not None and rowbias is not None:
        raise ValueError("normact: a skip and a row bias together")
    if skip is not None:
        if (skip.device, skip.dtype, skip.shape) != (v.device, v.dtype,
                                                     v.shape):
            raise ValueError(f"skip: expected {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}, got {skip.dtype} "
                             f"{tuple(skip.shape)} on {skip.device}")
        _check_layout(skip, "skip")
    if rowbias is not None and B * H * W >= 2**31:
        raise ValueError(f"v: {B * H * W} pixels; with a row bias the "
                         "kernel takes fewer than 2^31")
    if rowbias is not None and (
            rowbias.device != v.device or rowbias.dtype != torch.float32
            or rowbias.shape != (B, C) or not rowbias.is_contiguous()
            or rowbias.data_ptr() % 16):
        raise ValueError(f"rowbias: expected a contiguous, 16-byte aligned "
                         f"float32 [{B}, {C}] on {v.device}, got "
                         f"{rowbias.dtype} "
                         f"{tuple(rowbias.shape)} on {rowbias.device}")
    y = torch.empty_like(v, memory_format=torch.channels_last)
    s = None if skip is None else torch.empty_like(
        v, memory_format=torch.channels_last)
    if v.numel():
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = _nbt_kernel().nbt_normact(
            v.data_ptr(), ptr(skip), ptr(rowbias), mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(), ptr(s), y.data_ptr(), B * H * W,
            H * W, C, _DTYPES[v.dtype], ACTS[act],
            torch.cuda.current_stream(v.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nbt_normact: CUDA error {rc} at launch")
        launches["nbt_normact"] += 1
    return y if skip is None else (s, y)


def pool_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: torch.Tensor, act: str, kind: str) -> torch.Tensor:
    """The CUDA kernel of `pool_ref`: v channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes, at most 512 8-byte vectors, and 8 H C
    bytes of shared memory at most 227 KB."""
    B, C, H, W = _check_input(v, mean, mul, bias, act)
    if kind not in POOLS:
        raise ValueError(f"kind {kind!r}: expected one of {sorted(POOLS)}")
    if C // (8 // v.element_size()) > 512 or 8 * H * C > 232448:
        raise ValueError(f"v: {C} channels on {H} rows; the kernel takes at "
                         "most 512 8-byte vectors and 227 KB of partials")
    out = torch.empty((B, 3 * C), dtype=torch.float32, device=v.device)
    if v.numel():
        inv, k1, k2 = pool_scales(H * W)
        rc = _nbt_kernel().nbt_pool(
            v.data_ptr(), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, inv, k1, k2, C, _DTYPES[v.dtype],
            (ACTS[act] << 1) | POOLS[kind],
            torch.cuda.current_stream(v.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nbt_pool: CUDA error {rc} at launch")
        launches["nbt_pool"] += 1
    return out


def normact(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
            bias: torch.Tensor, act: str, skip: Optional[torch.Tensor] = None,
            rowbias: Optional[torch.Tensor] = None):
    profiling.count("net.epilogues")
    if v.is_cuda:
        return normact_cuda(v, mean, mul, bias, act, skip, rowbias)
    return normact_ref(v, mean, mul, bias, act, skip, rowbias)


def pool(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
         bias: torch.Tensor, act: str, kind: str) -> torch.Tensor:
    profiling.count("net.epilogues")
    profiling.count("net.gpools")
    if v.is_cuda:
        return pool_cuda(v, mean, mul, bias, act, kind)
    return pool_ref(v, mean, mul, bias, act, kind)
