"""Policy-only convnet: counterpart of `elf_tpu/models/policy_net.py`
(the reference's darkforest-style `Model_Policy`, df_model.py:15).

A deep stack of 3x3 convolutions (LeakyReLU 0.1, then BatchNorm)
predicts the next `num_future_actions` moves with one softmax head per
horizon, trained with the MultiplePrediction loss.  The defaults are the
reference's: 19x19, the 25 df planes, 39 layers of 128 channels.

  input   [B, N, N, C] float32, NHWC as in the JAX package
  layers  conv 3x3 (+bias, compute dtype) -> LeakyReLU 0.1 (or ReLU) ->
          BatchNorm (fp32, cast back to the compute dtype)
  head    conv 3x3 -> num_future_actions channels, in fp32
  output  log_pis [B, T, N*N + 1]: the board logits in flat r*N + c order
          and a constant pass logit per horizon (`pass_bias`, init -6.0;
          the reference heads have no pass), log-softmaxed per horizon

Numerics follow the flax module: fp32 master weights, convolutions in bf16
where `use_bf16`, BN in fp32 with flax's defaults (momentum 0.99, which is
torch's 0.01, eps 1e-5), the final convolution in fp32.
`policy_params_from_jax` / `policy_params_to_jax` carry the flax trees
across, as `resnet.params_from_jax` / `params_to_jax` do for the ResNet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    _from_flax,
    _get,
    _put,
    _t,
    _to_flax,
    init_weights,
)

# flax nn.BatchNorm: running = 0.99 * running + 0.01 * batch
FLAX_BN_MOMENTUM = 0.99
PASS_BIAS_INIT = -6.0


@dataclasses.dataclass(frozen=True)
class PolicyNetConfig:
    board_size: int = 19
    num_planes: int = 25        # df feature set
    num_layer: int = 39
    dim: int = 128
    num_future_actions: int = 1
    bn: bool = True
    leaky_relu: bool = True
    use_bf16: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32


class PolicyNet(nn.Module):
    def __init__(self, cfg: PolicyNetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        cins = [cfg.num_planes] + [cfg.dim] * (cfg.num_layer - 1)
        self.convs = nn.ModuleList([Conv(c, cfg.dim, 3, dt) for c in cins])
        self.bns = nn.ModuleList(
            [BatchNorm(cfg.dim, 1.0 - FLAX_BN_MOMENTUM)
             for _ in range(cfg.num_layer if cfg.bn else 0)])
        self.final_conv = Conv(cfg.dim, cfg.num_future_actions, 3,
                               torch.float32)
        self.pass_bias = nn.Parameter(
            torch.full((cfg.num_future_actions,), PASS_BIAS_INIT))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x [B, N, N, C] -> log_pis [B, num_future_actions, N*N + 1] f32.
        `train` normalises with the batch statistics and updates the
        running ones."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        B = x.shape[0]
        h = x.permute(0, 3, 1, 2).to(dt)
        for i, conv in enumerate(self.convs):
            h = conv(h)
            h = F.leaky_relu(h, 0.1) if cfg.leaky_relu else F.relu(h)
            if cfg.bn:
                h = self.bns[i](h, train).to(dt)
        out = self.final_conv(h.float())                  # [B, T, N, N]
        logits = out.reshape(B, cfg.num_future_actions, -1)
        pass_col = self.pass_bias[None, :, None].expand(B, -1, 1)
        return F.log_softmax(torch.cat([logits, pass_col], dim=2), dim=2)


def init_policy_net(cfg: PolicyNetConfig, generator: torch.Generator,
                    device: DeviceLike = "cuda") -> PolicyNet:
    """A PolicyNet with flax's default initialisation drawn from
    `generator` (a CPU generator): `lecun_normal` kernels (truncated
    normal, variance 1 / fan_in), zero biases, BN scale 1 and statistics
    (0, 1), `pass_bias` -6.0."""
    net = PolicyNet(cfg)
    init_weights(net, generator)
    with torch.no_grad():
        net.pass_bias.fill_(PASS_BIAS_INIT)
    return net.to(resolve_device(device))


# --------------------------------------------------------------------------
# the flax trees
# --------------------------------------------------------------------------

def _flax_names(cfg: PolicyNetConfig
                ) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch name, flax path, kind) of every parameter and BN statistic,
    kinds as in `resnet._flax_names`."""
    for i in range(cfg.num_layer):
        yield f"convs.{i}.weight", (f"conv{i}", "kernel"), "conv"
        yield f"convs.{i}.bias", (f"conv{i}", "bias"), "vec"
        if cfg.bn:
            yield f"bns.{i}.weight", (f"bn{i}", "scale"), "vec"
            yield f"bns.{i}.bias", (f"bn{i}", "bias"), "vec"
            yield f"bns.{i}.running_mean", (f"bn{i}", "mean"), "stat"
            yield f"bns.{i}.running_var", (f"bn{i}", "var"), "stat"
    yield "final_conv.weight", ("final_conv", "kernel"), "conv"
    yield "final_conv.bias", ("final_conv", "bias"), "vec"
    yield "pass_bias", ("pass_bias",), "vec"


def policy_params_from_jax(params: Mapping, batch_stats: Mapping,
                           cfg: PolicyNetConfig,
                           device: DeviceLike = "cuda") -> PolicyNet:
    """A PolicyNet holding the flax `params` / `batch_stats` trees of
    `elf_tpu.models.policy_net.PolicyNet` (nested dicts of numpy arrays or
    tensors): conv [kh, kw, I, O] -> [O, I, kh, kw]; BN scale / bias /
    mean / var -> weight / bias / running_mean / running_var."""
    net = PolicyNet(cfg)
    own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    with torch.no_grad():
        for name, path, kind in _flax_names(cfg):
            tree = batch_stats if kind == "stat" else params
            t = _from_flax(_t(_get(tree, path)), kind)
            if t.shape != own[name].shape:
                raise ValueError(
                    f"shape mismatch at {name}: {tuple(t.shape)} vs "
                    f"{tuple(own[name].shape)}")
            own[name].copy_(t)
    return net.to(resolve_device(device))


def policy_params_to_jax(net: PolicyNet) -> Tuple[Dict, Dict]:
    """Inverse of `policy_params_from_jax`: (params, batch_stats) as nested
    dicts of numpy arrays in flax's layouts."""
    own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    params: Dict = {}
    stats: Dict = {}
    for name, path, kind in _flax_names(net.cfg):
        t = _to_flax(own[name].detach(), kind).cpu().contiguous()
        _put(stats if kind == "stat" else params, path, t.numpy().copy())
    return params, stats
