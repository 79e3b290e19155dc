"""The serving net's trunk epilogue: what follows each trunk convolution
of a frozen net, as one pass.

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
   counting the launch (`launches`); activations NHWC (`channels_last`),
   bf16 or fp32, channels a multiple of 8 (bf16) or 4 (fp32);
 - `epilogue_ref`: the plain PyTorch version, any layout: the CPU path and
   the oracle the kernel is held against on the card;
 - `epilogue`: the kernel for a CUDA tensor, the plain version for a CPU
   tensor, counted as `net.epilogues` while tracing is on.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from elf_tpu_torch import profiling

# Launches of the CUDA kernel (one per wrapper call that launched).
launches = 0

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
    global launches
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
    launches += 1
    return out


def epilogue(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
             bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
             conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    profiling.count("net.epilogues")
    if v.is_cuda:
        return epilogue_cuda(v, mean, mul, bias, skip, conv_bias)
    return epilogue_ref(v, mean, mul, bias, skip, conv_bias)
