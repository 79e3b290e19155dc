"""Policy/value ResNet for inference: counterpart of
`elf_tpu/models/resnet.py` (reference `df_model3.py:113-306`).

  input  [B, N, N, C] float32, NHWC as in the JAX package (permuted to
         NCHW inside)
  trunk  3x3 conv(+bias) -> BN -> ReLU, then `num_block` residual blocks
         of conv-BN-ReLU, conv-BN-ReLU, + skip, ReLU (the second ReLU fires
         before the skip add, as in the reference)
  policy 1x1 conv -> 2 ch -> BN -> ReLU -> dense (N*N+1) -> log_softmax
  value  1x1 conv -> 1 ch -> BN -> ReLU -> dense 256 -> ReLU -> dense 1
         -> tanh

Numerics follow the JAX net: the convolutions run in the compute dtype
(bf16 when `use_bf16`, their weights stored in it), every BatchNorm and
the dense layers in fp32, with explicit casts rather than autocast.  BN
uses the running statistics (eps 1e-5, flax's default) in flax's order of
operations.  `pi_fc` consumes the NHWC flatten of the policy planes, as
the flax Dense does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elf_tpu_torch.device import DeviceLike, resolve_device

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    board_size: int = 19
    num_planes: int = 18
    num_block: int = 20
    dim: int = 256
    value_hidden: int = 256
    use_bf16: bool = True

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size + 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32


class BatchNorm(nn.Module):
    """Inference BatchNorm in fp32: (x - mean) * (rsqrt(var + eps) * scale)
    + bias, flax's order of operations."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, dtype: torch.dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=True, dtype=dtype)


class ResBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv(dim, dim, 3, dtype)
        self.bn1 = BatchNorm(dim)
        self.conv2 = _conv(dim, dim, 3, dtype)
        self.bn2 = BatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y.to(dt))))
        return F.relu(x + y.to(dt))


class PolicyValueNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.init_conv = _conv(cfg.num_planes, cfg.dim, 3, dt)
        self.init_bn = BatchNorm(cfg.dim)
        self.blocks = nn.ModuleList(
            [ResBlock(cfg.dim, dt) for _ in range(cfg.num_block)]
        )
        self.pi_conv = _conv(cfg.dim, 2, 1, dt)
        self.pi_bn = BatchNorm(2)
        self.pi_fc = nn.Linear(2 * cfg.board_size ** 2, cfg.num_actions)
        self.v_conv = _conv(cfg.dim, 1, 1, dt)
        self.v_bn = BatchNorm(1)
        self.v_fc1 = nn.Linear(cfg.board_size ** 2, cfg.value_hidden)
        self.v_fc2 = nn.Linear(cfg.value_hidden, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, N, N, C] float32 -> (log_pi [B, A] f32, value [B] f32)."""
        dt = self.cfg.compute_dtype
        B = x.shape[0]
        h = x.permute(0, 3, 1, 2).to(dt)
        h = F.relu(self.init_bn(self.init_conv(h))).to(dt)
        for block in self.blocks:
            h = block(h)
        p = F.relu(self.pi_bn(self.pi_conv(h)))
        p = p.permute(0, 2, 3, 1).reshape(B, -1)        # NHWC flatten
        log_pi = F.log_softmax(self.pi_fc(p), dim=-1)
        v = F.relu(self.v_bn(self.v_conv(h))).reshape(B, -1)
        v = self.v_fc2(F.relu(self.v_fc1(v)))
        return log_pi, torch.tanh(v[:, 0])


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda",
                seed: int = 0) -> PolicyValueNet:
    """A PolicyValueNet with seeded random weights, in eval mode."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    net = PolicyValueNet(cfg)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim > 1:
                fan_in = int(np.prod(p.shape[1:]))
                w = torch.randn(p.shape, generator=g) / np.sqrt(fan_in)
                p.copy_(w.to(p.dtype))
            elif name.endswith("bias"):
                p.zero_()
    return net.to(dev).eval()


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def params_from_jax(params: Mapping, batch_stats: Mapping, cfg: ModelConfig,
                    device: DeviceLike = "cuda") -> PolicyValueNet:
    """A PolicyValueNet holding the flax `params` / `batch_stats` trees
    (nested dicts of numpy arrays or tensors, as `flax` or
    `checkpoint.load_checkpoint` restore them).

    conv [kh, kw, I, O] -> [O, I, kh, kw]; dense [I, O] -> [O, I];
    BN scale/bias/mean/var -> weight/bias/running_mean/running_var."""
    dev = resolve_device(device)
    net = PolicyValueNet(cfg)

    def conv(mod: nn.Conv2d, p):
        mod.weight.copy_(_t(p["kernel"]).permute(3, 2, 0, 1).to(mod.weight.dtype))
        mod.bias.copy_(_t(p["bias"]).to(mod.bias.dtype))

    def dense(mod: nn.Linear, p):
        mod.weight.copy_(_t(p["kernel"]).t().to(torch.float32))
        mod.bias.copy_(_t(p["bias"]).to(torch.float32))

    def bn(mod: BatchNorm, p, s):
        mod.weight.copy_(_t(p["scale"]).to(torch.float32))
        mod.bias.copy_(_t(p["bias"]).to(torch.float32))
        mod.running_mean.copy_(_t(s["mean"]).to(torch.float32))
        mod.running_var.copy_(_t(s["var"]).to(torch.float32))

    with torch.no_grad():
        conv(net.init_conv, params["init_conv"])
        bn(net.init_bn, params["init_bn"], batch_stats["init_bn"])
        for i, block in enumerate(net.blocks):
            p, s = params[f"block{i}"], batch_stats[f"block{i}"]
            conv(block.conv1, p["conv1"])
            bn(block.bn1, p["bn1"], s["bn1"])
            conv(block.conv2, p["conv2"])
            bn(block.bn2, p["bn2"], s["bn2"])
        for head in ("pi", "v"):
            conv(getattr(net, f"{head}_conv"), params[f"{head}_conv"])
            bn(getattr(net, f"{head}_bn"), params[f"{head}_bn"],
               batch_stats[f"{head}_bn"])
        dense(net.pi_fc, params["pi_fc"])
        dense(net.v_fc1, params["v_fc1"])
        dense(net.v_fc2, params["v_fc2"])
    return net.to(dev).eval()


def load_model(path: str, cfg: ModelConfig,
               device: DeviceLike = "cuda") -> PolicyValueNet:
    """PolicyValueNet from a flax-msgpack checkpoint of the JAX trainer."""
    from elf_tpu_torch.models.checkpoint import load_checkpoint

    params, batch_stats, _ = load_checkpoint(path)
    return params_from_jax(params, batch_stats, cfg, device)


def eval_fn_builder(net: PolicyValueNet, batch_stats=None):
    """The actor's `eval_fn_builder(params, batch_stats)` for a torch net:
    the net is the params, and carries its own BN statistics."""

    def eval_fn(feats: torch.Tensor, to_play: torch.Tensor):
        return net(feats)

    return eval_fn
