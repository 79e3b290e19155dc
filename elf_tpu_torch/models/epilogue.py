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

The learner's trunk (`PolicyValueNet`'s training forward) has one more,
`train_epilogue`, after each trunk convolution `v` (compute dtype, NHWC)
of a training forward, with BatchNorm's batch statistics:

    v = v + conv_bias                   (where given: cuDNN's own bias add)
    x = float(v);  mean = x.mean(B, H, W)
    var = max(0, (x * x).mean(B, H, W) - mean^2)    (flax's variance)
    y = relu((x - mean) * (rsqrt(var + eps) * weight) + bias).to(dtype)
    y = relu(skip + y)                  (where given: the residual add)
    -> (y, mean, var), and the gradients of v, conv_bias, weight, bias, skip

 - `train_epilogue_ref`: the plain version, the torch ops of
   `BatchNorm.batch_norm` + ReLU + casts (+ `ResBlock`'s skip add) in
   their order, whose autograd is the backward: what the kernels are held
   against (a CPU training forward keeps the modules themselves);
 - `train_epilogue_cuda`: the kernels of `csrc/net_train_epilogue.cu`,
   joined by a `torch.autograd.Function`.  Forward: the batch statistics
   (a pass over v and a small launch that sums the blocks' partials in a
   fixed order: `launches["net_train_stats"]`), then the serving kernel
   `epilogue_cuda` with them; backward: a reduce pass, a small launch, an
   apply pass that writes d v (and d skip) in the compute dtype
   (`launches["net_train_grad"]`).  It saves v, the statistics and, on a
   skip layer, its output, and no fp32 activation; two calls on the same
   input give the same bits.  Activations channels_last, bf16 or fp32, as
   `epilogue_cuda`;
 - `train_epilogue`: the kernels, counted as `net.train_epilogues` (each
   forward call) and `net.train_epilogue_grads` (each backward call) while
   tracing is on; a CPU tensor is refused, never sent to the plain
   version.

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
# launched): `epilogue_cuda`'s, the learner's statistics and backward
# (`train_epilogue_cuda`, whose forward also launches `epilogue_cuda`), and
# the nested-bottleneck net's (`normact_cuda`, `pool_cuda`).
launches = {"net_epilogue": 0, "net_train_stats": 0, "net_train_grad": 0,
            "nbt_normact": 0, "nbt_pool": 0}

BN_EPS = 1e-5

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Each library's C functions and their argument types (each returns an int:
# 0, or a CUDA error), the stream last where the function launches.  Each
# library is built and loaded the first time one of its functions is called.
_SIGNATURES = {
    "net_epilogue": {"net_epilogue": [_VP] * 7 + [_LL, _I, _I, _VP]},
    "net_train_epilogue": {
        "net_train_capacity": [_I, _I],
        "net_train_stats": [_VP] * 4 + [_I] + [_VP] * 4
        + [_LL, _I, _I, ctypes.c_double, _VP],
        "net_train_grad": [_VP] * 12 + [_I] + [_VP] * 5
        + [_LL, _I, _I, ctypes.c_double, _VP],
    },
    "nbt_epilogue": {
        "nbt_normact": [_VP] * 8 + [_LL, _I, _I, _I, _I, _VP],
        "nbt_pool": [_VP] * 5 + [_I, _I, _I] + [ctypes.c_float] * 3
        + [_I, _I, _I, _VP],
    },
}
_fns: dict = {}


def _fn(name: str):
    """The C function `name`, its library built and loaded first if need
    be."""
    if name not in _fns:
        from elf_tpu_torch import _build

        lib_name = next(k for k, fns in _SIGNATURES.items() if name in fns)
        lib = _build.load(lib_name)
        for fn, argtypes in _SIGNATURES[lib_name].items():
            _fns[fn] = getattr(lib, fn)
            _fns[fn].argtypes, _fns[fn].restype = argtypes, _I
    return _fns[name]


def _launch(name: str, v: torch.Tensor, *args) -> None:
    """Call the C function `name` on `args` and the current stream of v's
    card, raise on its CUDA error and count the launch."""
    rc = _fn(name)(*args, torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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


def _check_layout(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: expected a channels_last tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")


def _check_v(v: torch.Tensor) -> tuple:
    """The checks every kernel makes of its activation v; returns (B, C, H,
    W)."""
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
    return B, C, H, W


def _check_skip(skip: Optional[torch.Tensor], v: torch.Tensor) -> None:
    if skip is None:
        return
    if (skip.device, skip.dtype, skip.shape) != (v.device, v.dtype, v.shape):
        raise ValueError(f"skip: expected {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}, got {skip.dtype} {tuple(skip.shape)} "
                         f"on {skip.device}")
    _check_layout(skip, "skip")


def _check_channels(v: torch.Tensor, dtype: torch.dtype,
                    **vectors: Optional[torch.Tensor]) -> None:
    """Each of `vectors` that is given: a contiguous `dtype` [C] on v's
    device, C v's channels."""
    C = v.shape[1]
    for name, t in vectors.items():
        if t is not None and (t.device != v.device or t.dtype != dtype
                              or t.shape != (C,) or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} [{C}] "
                             f"on {v.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def epilogue_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                  bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
                  conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel: v [B, C, H, W] channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes; the rest as `epilogue_ref`.  Returns a new
    channels_last tensor like v."""
    B, C, H, W = _check_v(v)
    _check_channels(v, torch.float32, mean=mean, mul=mul, bias=bias)
    _check_channels(v, v.dtype, conv_bias=conv_bias)
    _check_skip(skip, v)
    out = torch.empty_like(v, memory_format=torch.channels_last)
    if v.numel():
        _launch("net_epilogue", v, v.data_ptr(), _ptr(conv_bias),
                mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), _ptr(skip),
                out.data_ptr(), B * H * W, C, _DTYPES[v.dtype])
    return out


def epilogue(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
             bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
             conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    profiling.count("net.epilogues")
    if v.is_cuda:
        return epilogue_cuda(v, mean, mul, bias, skip, conv_bias)
    return epilogue_ref(v, mean, mul, bias, skip, conv_bias)


# ---------------------------------------------------------------------------
# the learner's trunk: batch statistics and a backward
# ---------------------------------------------------------------------------

def train_epilogue_ref(v: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
                       conv_bias: Optional[torch.Tensor] = None):
    """Plain version: v [B, C, H, W] in the compute dtype; weight, bias and
    conv_bias BN's and the convolution's fp32 [C]; skip like v.  Returns
    (y, mean, var), differentiable in every tensor argument."""
    dt = v.dtype
    if conv_bias is not None:
        v = v + conv_bias.to(dt)[:, None, None]
    x = v.float()
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * weight
    y = (x - mean[:, None, None]) * mul[:, None, None]
    y = F.relu(y + bias[:, None, None]).to(dt)
    return (y if skip is None else F.relu(skip + y)), mean, var


_capacity: dict = {}


def _partials(v: torch.Tensor) -> tuple:
    """(scratch, capacity): room for the partial sums of the most blocks a
    pass over v may launch on its card (found once per card and shape)."""
    C = v.shape[1]
    key = (v.device, C, v.dtype)
    if key not in _capacity:
        with torch.cuda.device(v.device):
            n = _fn("net_train_capacity")(C, _DTYPES[v.dtype])
        if n <= 0:
            raise RuntimeError(f"net_train_capacity: CUDA error {-n}")
        _capacity[key] = n
    n = _capacity[key]
    return torch.empty((n, 2, C), dtype=torch.float32, device=v.device), n


def train_stats_cuda(v: torch.Tensor, weight: torch.Tensor,
                     conv_bias: Optional[torch.Tensor] = None) -> tuple:
    """The statistics kernels: (mean, var, mul, gate) fp32 [C] of v (+ the
    conv bias, in v's dtype): flax's batch mean and variance, mul =
    rsqrt(var + eps) * weight, gate 1 where the variance was not clamped.
    Inputs as `train_epilogue_cuda` checks them."""
    B, C, H, W = v.shape
    mean, var, mul, gate = (torch.empty(C, dtype=torch.float32,
                                        device=v.device) for _ in range(4))
    scratch, capacity = _partials(v)
    _launch("net_train_stats", v, v.data_ptr(), _ptr(conv_bias),
            weight.data_ptr(), scratch.data_ptr(), capacity, mean.data_ptr(),
            var.data_ptr(), mul.data_ptr(), gate.data_ptr(), B * H * W, C,
            _DTYPES[v.dtype], BN_EPS)
    return mean, var, mul, gate


def train_grad_cuda(v: torch.Tensor, conv_bias: Optional[torch.Tensor],
                    mean: torch.Tensor, var: torch.Tensor, mul: torch.Tensor,
                    gate: torch.Tensor, bias: torch.Tensor,
                    out: Optional[torch.Tensor], g: torch.Tensor) -> tuple:
    """The backward kernels of a layer, given g = d y: (d v, d skip, d
    weight, d bias, d conv_bias), d skip None without `out` (the output of
    a skip layer) and d conv_bias None without a conv bias (in v's dtype)."""
    B, C, H, W = v.shape
    dv = torch.empty_like(v, memory_format=torch.channels_last)
    dskip = None if out is None else torch.empty_like(
        v, memory_format=torch.channels_last)
    coef1, coef2, dweight, dbias = (torch.empty(
        C, dtype=torch.float32, device=v.device) for _ in range(4))
    dcb = None if conv_bias is None else torch.empty_like(dbias)
    scratch, capacity = _partials(v)
    _launch("net_train_grad", v, v.data_ptr(), _ptr(conv_bias),
            mean.data_ptr(), var.data_ptr(), mul.data_ptr(), gate.data_ptr(),
            bias.data_ptr(), _ptr(out), g.data_ptr(), dv.data_ptr(),
            _ptr(dskip), scratch.data_ptr(), capacity, coef1.data_ptr(),
            coef2.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), _ptr(dcb),
            B * H * W, C, _DTYPES[v.dtype], BN_EPS)
    return dv, dskip, dweight, dbias, dcb


class _TrainEpilogue(torch.autograd.Function):
    """One trunk layer of a training forward on the card: the statistics
    kernels, the serving epilogue kernel with them, and the backward
    kernels.  Saves v (the conv bias in v's dtype), the statistics and, on
    a skip layer, the output."""

    @staticmethod
    def forward(ctx, v, conv_bias, weight, bias, skip):
        cb = None if conv_bias is None else conv_bias.to(v.dtype)
        mean, var, mul, gate = train_stats_cuda(v, weight, cb)
        y = epilogue_cuda(v, mean, mul, bias, skip, cb)
        ctx.save_for_backward(v, cb, mean, var, mul, gate, bias,
                              y if skip is not None else None)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        profiling.count("net.train_epilogue_grads")
        v, cb, mean, var, mul, gate, bias, out = ctx.saved_tensors
        g = gy.contiguous(memory_format=torch.channels_last)
        dv, dskip, dweight, dbias, dcb = train_grad_cuda(
            v, cb, mean, var, mul, gate, bias, out, g)
        return dv, dcb, dweight, dbias, dskip


def train_epilogue_cuda(v: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor,
                        skip: Optional[torch.Tensor] = None,
                        conv_bias: Optional[torch.Tensor] = None):
    """The kernels of `train_epilogue_ref`, differentiable: v [B, C, H, W]
    channels_last, bf16 or fp32, C a multiple of 16 bytes' lanes, at least
    one pixel; the rest as `train_epilogue_ref`.  Returns (y, mean, var), y
    a new channels_last tensor like v."""
    B, C, H, W = _check_v(v)
    _check_channels(v, torch.float32, weight=weight, bias=bias,
                    conv_bias=conv_bias)
    _check_skip(skip, v)
    if B * H * W == 0:
        raise ValueError("v: the batch statistics need at least one pixel")
    return _TrainEpilogue.apply(v, conv_bias, weight, bias, skip)


def train_epilogue(v: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   skip: Optional[torch.Tensor] = None,
                   conv_bias: Optional[torch.Tensor] = None):
    profiling.count("net.train_epilogues")
    return train_epilogue_cuda(v, weight, bias, skip, conv_bias)


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


def normact_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, act: str,
                 skip: Optional[torch.Tensor] = None,
                 rowbias: Optional[torch.Tensor] = None):
    """The CUDA kernel of `normact_ref`: v channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes; skip and rowbias not both.  Returns new
    channels_last tensors like v."""
    B, C, H, W = _check_v(v)
    _check_channels(v, torch.float32, mean=mean, mul=mul, bias=bias)
    activation(act)
    if skip is not None and rowbias is not None:
        raise ValueError("normact: a skip and a row bias together")
    _check_skip(skip, v)
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
        _launch("nbt_normact", v, v.data_ptr(), _ptr(skip), _ptr(rowbias),
                mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), _ptr(s),
                y.data_ptr(), B * H * W, H * W, C, _DTYPES[v.dtype],
                ACTS[act])
    return y if skip is None else (s, y)


def pool_cuda(v: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: torch.Tensor, act: str, kind: str) -> torch.Tensor:
    """The CUDA kernel of `pool_ref`: v channels_last, bf16 or fp32, C a
    multiple of 16 bytes' lanes, at most 512 8-byte vectors, and 8 H C
    bytes of shared memory at most 227 KB."""
    B, C, H, W = _check_v(v)
    _check_channels(v, torch.float32, mean=mean, mul=mul, bias=bias)
    activation(act)
    if kind not in POOLS:
        raise ValueError(f"kind {kind!r}: expected one of {sorted(POOLS)}")
    if C // (8 // v.element_size()) > 512 or 8 * H * C > 232448:
        raise ValueError(f"v: {C} channels on {H} rows; the kernel takes at "
                         "most 512 8-byte vectors and 227 KB of partials")
    out = torch.empty((B, 3 * C), dtype=torch.float32, device=v.device)
    if v.numel():
        inv, k1, k2 = pool_scales(H * W)
        _launch("nbt_pool", v, v.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, H, W, inv, k1, k2, C,
                _DTYPES[v.dtype], (ACTS[act] << 1) | POOLS[kind])
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
