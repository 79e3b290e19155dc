"""KataGo's nested-bottleneck residual net (`b18c384nbt`: KataGo's
`python/katago/train/modelconfigs.py` and `docs/KataGoMethods.md`; global
pooling: Wu, arXiv:1902.10565, section 3 and appendix), for serving.

  input  [B, N, N, C] float32 NHWC, as `PolicyValueNet` takes it
  trunk  a `input_kernel` x `input_kernel` convolution to `trunk_channels`,
         then `num_blocks` nested blocks on the raw trunk stream x:
           r = NAC(1x1, trunk -> mid)(x), NAC(c)(h) = conv_c(act(norm(h)))
           `inner_blocks` inner blocks, each r <- r + NAC(3x3)(NAC(3x3)(r))
           x <- x + NAC(1x1, mid -> trunk)(r)
         and in the blocks of `gpool_blocks` (1-based, as KataGo's block
         list counts them) the first inner block pools the board:
           a = act(norm(r)), t = conv3x3(a) (mid - gpool channels),
           g = act(norm_g(conv3x3(a))) (gpool channels),
           t <- t + W_g pool(g) over the board, r <- r + conv3x3(act(norm(t)))
         then act(norm(x))
  policy 1x1 convolutions to P (p1) and G (g1); pool(act(norm(G))) through
         a dense layer added to P per channel; act(norm(P)); a 1x1
         convolution to the 361 point logits; the pass logit a dense layer
         of the pooled G; log-softmax over N*N + 1
  value  1x1 convolution to v1, act(norm), value pooling, dense to v2, act,
         dense to 3 logits (win, loss, no result); the value is
         P(win) - P(loss)

`pool` is KataGo's (`epilogue.board_pool`): [mean, mean (sqrt(A) - 14) /
10, max] over the A = N*N points, and for the value head [mean, mean
(sqrt(A) - 14) / 10, mean ((sqrt(A) - 14)^2 / 100 - 0.1)].  `act` is
`activation`, mish (KataGo's form, `epilogue.mish`) or relu.

Numerics, as `PolicyValueNet`'s: fp32 master weights; every convolution
without bias in the compute dtype (bf16 when `use_bf16`), as are the trunk
stream, the inner stream and each convolution's input; every norm, the
pooling and the dense layers in fp32.  The norms are the port's
`BatchNorm` with its running statistics: at inference a per-channel
affine, as KataGo's exported nets reduce theirs to a scale and a bias.

The training forward (`net(x, train=True)`, the learner's).  Every norm
normalises by the batch's mean and biased variance over (B, N, N) in fp32
(`BatchNorm.batch_norm`) and then moves its running statistics once, after
the forward, by the port's momentum rule (`NbtConfig.bn_momentum`, as
`ModelConfig`'s); the activation is torch's own (`F.mish` or `F.relu`);
the board's pooling takes torch's mean and max; the convolutions run
NHWC (`torch.channels_last`) in the compute dtype from fp32 master
weights cast per call; pooling and dense layers stay fp32.  The backward
is autograd's through these torch ops.  `NbtConfig(remat=True)`
recomputes each nested block in the backward pass
(`torch.utils.checkpoint`); a recomputed block computes its statistics
again and writes nothing.  While tracing is on, `net.train_normacts`
counts each norm-and-activation call of a training forward (118 a forward
at `b18c384nbt`'s layout, and 114 more for remat's recompute) and
`net.train_gpools` each pooling (8, and 6 more).

The serving path (`NestedBottleneckNet.serve`).  A serving copy
(`resnet.prepare_serving`) whose channels are multiples of 8 holds each
norm's `rsqrt(running_var + eps) * weight` (`serving_mul`).  On a CUDA
input it keeps every activation NHWC (`torch.channels_last`) from the
first convolution to the heads, and follows each convolution but the
policy's last with one epilogue (`models/epilogue.py`): the next layer's
norm and activation, with the residual add before it (`normact` with a
skip, which writes the raw sum too), the pooled term before it (with a
row bias), or the board's pooling after it (`pool`, which writes only the
pooled values).  Those are the modules' roundings and order of operations,
so it gives the bits of the copy's own modules (the same bf16
channels_last weights); the modules of a net with fp32 weights, cast at
each call, may get another cuDNN algorithm for a 1x1 convolution.  A
forward at `gpool_blocks` of 6 in 18 blocks: 118 epilogues, 8 of them
pools (`net.epilogues`, `net.gpools`), counted with `net.forwards`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elf_tpu_torch import profiling
from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.models.epilogue import (activation, board_pool, normact,
                                           pool, pool_scales)
from elf_tpu_torch.models.resnet import (BatchNorm, Conv, ModelConfig,
                                         ServingNet, init_weights)


@dataclasses.dataclass(frozen=True)
class NbtConfig:
    """Every width of the net; the defaults are `b18c384nbt`'s trunk, mid
    and pooling widths and depth at 19x19 on the port's 18 AGZ planes.
    The head widths (arXiv:1902.10565's appendix), the pooled blocks,
    mish and the input convolution are assumed, not read from KataGo's
    own entry for the net."""

    board_size: int = 19
    num_planes: int = 18
    trunk_channels: int = 384
    mid_channels: int = 192
    gpool_channels: int = 64
    num_blocks: int = 18
    inner_blocks: int = 2
    gpool_blocks: Tuple[int, ...] = (3, 6, 9, 12, 15, 18)
    input_kernel: int = 5
    p1_channels: int = 32
    g1_channels: int = 32
    v1_channels: int = 32
    v2_size: int = 64
    activation: str = "mish"
    use_bf16: bool = True
    bn_momentum: float = 0.0   # as `ModelConfig.bn_momentum`
    # recompute each nested block in the backward pass (the batch-2048
    # train step needs it)
    remat: bool = False

    torch_bn_momentum = ModelConfig.torch_bn_momentum

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32


def _k(norm: BatchNorm) -> tuple:
    """A serving copy's epilogue constants of `norm`: mean, mul, bias."""
    return norm.running_mean, norm.serving_mul, norm.bias


def _train_act(name: str):
    """The training forward's activation: torch's own, whose backward is
    autograd's."""
    activation(name)                # refuses an unknown name
    return F.relu if name == "relu" else F.mish


def _normact(norm: BatchNorm, h: torch.Tensor, act, stats: list):
    """act(norm(h)) in fp32 with the batch statistics, appended to `stats`
    as (mean, var)."""
    profiling.count("net.train_normacts")
    y, mean, var = norm.batch_norm(h)
    stats += [mean, var]
    return act(y)


def _conv(conv: Conv, h: torch.Tensor) -> torch.Tensor:
    """conv(h) of a training forward: NHWC in the compute dtype, the fp32
    master weight cast per call."""
    w = conv.weight.to(conv.dtype, memory_format=torch.channels_last)
    h = h.to(conv.dtype, memory_format=torch.channels_last)
    return F.conv2d(h, w, None, padding=conv.padding)


def _pool(g: torch.Tensor, kind: str) -> torch.Tensor:
    """`board_pool(g, kind)` of a training forward, by torch's mean and
    max."""
    profiling.count("net.train_gpools")
    _, k1, k2 = pool_scales(g.shape[2] * g.shape[3])
    mean = g.mean(dim=(2, 3))
    third = g.amax(dim=(2, 3)) if kind == "gpool" else mean * k2
    return torch.cat([mean, mean * k1, third], 1)


class NormActConv(nn.Module):
    """conv(act(norm(h))): the norm belongs to the convolution it feeds."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.norm = BatchNorm(cin)
        self.conv = Conv(cin, cout, k, dtype, bias=False)

    def forward(self, h: torch.Tensor, act) -> torch.Tensor:
        return self.conv(act(self.norm(h)).to(self.conv.dtype))

    def train_forward(self, h: torch.Tensor, act, stats: list):
        return _conv(self.conv, _normact(self.norm, h, act, stats))


class ResBlock(nn.Module):
    """r + NAC(3x3)(NAC(3x3)(r)), pre-activation."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.normactconv1 = NormActConv(c, c, 3, dtype)
        self.normactconv2 = NormActConv(c, c, 3, dtype)

    @property
    def first_norm(self) -> BatchNorm:
        return self.normactconv1.norm

    def forward(self, r: torch.Tensor, act) -> torch.Tensor:
        return r + self.normactconv2(self.normactconv1(r, act), act)

    def train_forward(self, r: torch.Tensor, act, stats: list):
        u = self.normactconv1.train_forward(r, act, stats)
        return r + self.normactconv2.train_forward(u, act, stats)

    def serve(self, r, a, after: BatchNorm, act: str):
        """(r, act(after(r))) of the block, from a = act(first_norm(r))."""
        u = normact(self.normactconv1.conv(a), *_k(self.normactconv2.norm),
                    act)
        return normact(self.normactconv2.conv(u), *_k(after), act, skip=r)


class GPoolResBlock(nn.Module):
    """KataGo's global-pooling residual block (pre-activation)."""

    def __init__(self, c: int, c_gpool: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = BatchNorm(c)
        self.conv1r = Conv(c, c - c_gpool, 3, dtype, bias=False)
        self.conv1g = Conv(c, c_gpool, 3, dtype, bias=False)
        self.normg = BatchNorm(c_gpool)
        self.linear_g = nn.Linear(3 * c_gpool, c - c_gpool, bias=False)
        self.norm2 = BatchNorm(c - c_gpool)
        self.conv2 = Conv(c - c_gpool, c, 3, dtype, bias=False)

    @property
    def first_norm(self) -> BatchNorm:
        return self.norm1

    def forward(self, r: torch.Tensor, act) -> torch.Tensor:
        dt = self.conv2.dtype
        a = act(self.norm1(r)).to(dt)
        g = board_pool(act(self.normg(self.conv1g(a))), "gpool")
        t = self.conv1r(a).float() + self.linear_g(g)[:, :, None, None]
        return r + self.conv2(act(self.norm2(t)).to(dt))

    def train_forward(self, r: torch.Tensor, act, stats: list):
        a = _normact(self.norm1, r, act, stats).to(
            self.conv2.dtype, memory_format=torch.channels_last)
        g = _pool(_normact(self.normg, _conv(self.conv1g, a), act, stats),
                  "gpool")
        t = _conv(self.conv1r, a).float() + self.linear_g(g)[:, :, None, None]
        return r + _conv(self.conv2, _normact(self.norm2, t, act, stats))

    def serve(self, r, a, after: BatchNorm, act: str):
        g = pool(self.conv1g(a), *_k(self.normg), act, "gpool")
        u = normact(self.conv1r(a), *_k(self.norm2), act,
                    rowbias=self.linear_g(g))
        return normact(self.conv2(u), *_k(after), act, skip=r)


class NestedBlock(nn.Module):
    """x + NAC(1x1)(inner blocks(NAC(1x1)(x))), KataGo's
    NestedBottleneckResBlock."""

    def __init__(self, cfg: NbtConfig, pooled: bool):
        super().__init__()
        dt, mid = cfg.compute_dtype, cfg.mid_channels
        self.normactconvp = NormActConv(cfg.trunk_channels, mid, 1, dt)
        self.blockstack = nn.ModuleList([
            GPoolResBlock(mid, cfg.gpool_channels, dt) if pooled and j == 0
            else ResBlock(mid, dt) for j in range(cfg.inner_blocks)])
        self.normactconvq = NormActConv(mid, cfg.trunk_channels, 1, dt)

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        r = self.normactconvp(x, act)
        for blk in self.blockstack:
            r = blk(r, act)
        return x + self.normactconvq(r, act)

    def train_forward(self, x: torch.Tensor, act):
        """(output, the batch statistics of the block's norms in order),
        which the caller writes."""
        stats: list = []
        r = self.normactconvp.train_forward(x, act, stats)
        for blk in self.blockstack:
            r = blk.train_forward(r, act, stats)
        return x + self.normactconvq.train_forward(r, act, stats), tuple(stats)

    def serve(self, x, a, after: BatchNorm, act: str):
        """(x, act(after(x))) of the block, from a = act(norm_p(x))."""
        r = self.normactconvp.conv(a)
        stack = list(self.blockstack)
        a = normact(r, *_k(stack[0].first_norm), act)
        nexts = [blk.first_norm for blk in stack[1:]]
        for blk, nxt in zip(stack, nexts + [self.normactconvq.norm]):
            r, a = blk.serve(r, a, nxt, act)
        return normact(self.normactconvq.conv(a), *_k(after), act, skip=x)


class PolicyHead(nn.Module):
    def __init__(self, cfg: NbtConfig):
        super().__init__()
        dt, c, p1, g1 = (cfg.compute_dtype, cfg.trunk_channels,
                         cfg.p1_channels, cfg.g1_channels)
        self.conv1p = Conv(c, p1, 1, dt, bias=False)
        self.conv1g = Conv(c, g1, 1, dt, bias=False)
        self.normg = BatchNorm(g1)
        self.linear_g = nn.Linear(3 * g1, p1, bias=False)
        self.norm2 = BatchNorm(p1)
        self.conv2p = Conv(p1, 1, 1, dt, bias=False)
        self.linear_pass = nn.Linear(3 * g1, 1)

    def forward(self, h: torch.Tensor, act) -> torch.Tensor:
        g = board_pool(act(self.normg(self.conv1g(h))), "gpool")
        p = self.conv1p(h).float() + self.linear_g(g)[:, :, None, None]
        return self._log_pi(act(self.norm2(p)).to(h.dtype), g)

    def train_forward(self, h: torch.Tensor, act, stats: list):
        g = _pool(_normact(self.normg, _conv(self.conv1g, h), act, stats),
                  "gpool")
        p = _conv(self.conv1p, h).float() + self.linear_g(g)[:, :, None, None]
        return self._log_pi(_normact(self.norm2, p, act, stats).to(h.dtype), g)

    def serve(self, h: torch.Tensor, act: str) -> torch.Tensor:
        g = pool(self.conv1g(h), *_k(self.normg), act, "gpool")
        p = normact(self.conv1p(h), *_k(self.norm2), act,
                    rowbias=self.linear_g(g))
        return self._log_pi(p, g)

    def _log_pi(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        logits = self.conv2p(p).float().reshape(p.shape[0], -1)
        return F.log_softmax(torch.cat([logits, self.linear_pass(g)], 1), -1)


class ValueHead(nn.Module):
    def __init__(self, cfg: NbtConfig):
        super().__init__()
        v1 = cfg.v1_channels
        self.conv1 = Conv(cfg.trunk_channels, v1, 1, cfg.compute_dtype,
                          bias=False)
        self.norm1 = BatchNorm(v1)
        self.linear2 = nn.Linear(3 * v1, cfg.v2_size)
        self.linear3 = nn.Linear(cfg.v2_size, 3)

    def forward(self, h: torch.Tensor, act) -> torch.Tensor:
        v = board_pool(act(self.norm1(self.conv1(h))), "value")
        return self._value(v, act)

    def train_forward(self, h: torch.Tensor, act, stats: list):
        v = _pool(_normact(self.norm1, _conv(self.conv1, h), act, stats),
                  "value")
        return self._value(v, act)

    def serve(self, h: torch.Tensor, act: str) -> torch.Tensor:
        v = pool(self.conv1(h), *_k(self.norm1), act, "value")
        return self._value(v, activation(act))

    def _value(self, v: torch.Tensor, act) -> torch.Tensor:
        p = torch.softmax(self.linear3(act(self.linear2(v))), -1)
        return p[:, 0] - p[:, 1]


class NestedBottleneckNet(ServingNet):
    def __init__(self, cfg: NbtConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_spatial = Conv(cfg.num_planes, cfg.trunk_channels,
                                 cfg.input_kernel, cfg.compute_dtype,
                                 bias=False)
        self.blocks = nn.ModuleList([
            NestedBlock(cfg, i + 1 in cfg.gpool_blocks)
            for i in range(cfg.num_blocks)])
        self.norm_trunkfinal = BatchNorm(cfg.trunk_channels)
        self.policy_head = PolicyHead(cfg)
        self.value_head = ValueHead(cfg)
        for norm in self.serving_norms():
            norm.momentum = cfg.torch_bn_momentum

    def forward(self, x: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, N, N, C] float32 -> (log_pi [B, A] f32, value [B] f32),
        with the norms' running statistics, or with `train` the batch
        statistics (`train_forward`)."""
        if train:
            return self.train_forward(x)
        if self.takes_serving_path(x, train):
            return self.serve(x)
        act = activation(self.cfg.activation)
        dt = self.cfg.compute_dtype
        h = self.conv_spatial(x.permute(0, 3, 1, 2).to(dt))
        for blk in self.blocks:
            h = blk(h, act)
        h = act(self.norm_trunkfinal(h)).to(dt)
        return self.policy_head(h, act), self.value_head(h, act)

    def train_forward(self, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward (see the module): the batch statistics,
        which move the running ones once, after the forward; with
        `cfg.remat` each nested block is recomputed in the backward."""
        act = _train_act(self.cfg.activation)
        stats: list = []
        h = _conv(self.conv_spatial, x.permute(0, 3, 1, 2))
        for blk in self.blocks:
            if self.cfg.remat:
                h, bs = checkpoint(blk.train_forward, h, act,
                                   use_reentrant=False)
            else:
                h, bs = blk.train_forward(h, act)
            stats += bs
        h = _normact(self.norm_trunkfinal, h, act, stats).to(
            self.cfg.compute_dtype, memory_format=torch.channels_last)
        log_pi = self.policy_head.train_forward(h, act, stats)
        value = self.value_head.train_forward(h, act, stats)
        for norm, mean, var in zip(self.serving_norms(), stats[0::2],
                                   stats[1::2], strict=True):
            norm.update_running(mean, var)
        return log_pi, value

    def serve(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving path of a serving copy: `forward`, each convolution
        followed by one epilogue; on a CPU input the epilogues are the
        plain versions."""
        profiling.count("net.forwards")
        act = self.cfg.activation
        h = x.permute(0, 3, 1, 2).to(self.cfg.compute_dtype,
                                      memory_format=torch.channels_last)
        trunk = self.conv_spatial(h)
        a = normact(trunk, *_k(self.blocks[0].normactconvp.norm), act)
        afters = [blk.normactconvp.norm for blk in self.blocks[1:]]
        for blk, after in zip(self.blocks, afters + [self.norm_trunkfinal]):
            trunk, a = blk.serve(trunk, a, after, act)
        return self.policy_head.serve(a, act), self.value_head.serve(a, act)

    def serving_norms(self) -> list:
        """Every norm: `serve` hands each to an epilogue."""
        return [m for m in self.modules() if isinstance(m, BatchNorm)]


def build_model(cfg: NbtConfig, device: DeviceLike = "cuda",
                seed: int = 0) -> NestedBottleneckNet:
    """A NestedBottleneckNet with seeded random weights (`init_weights`:
    flax's defaults in distribution)."""
    dev = resolve_device(device)
    net = NestedBottleneckNet(cfg)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev)


def load_model(path: str, cfg: NbtConfig,
               device: DeviceLike = "cuda") -> NestedBottleneckNet:
    """A NestedBottleneckNet from a checkpoint of the port's learner
    (`checkpoint.save_checkpoint` or `save_params_checkpoint`, whose trees
    are flat under the net's own names); names and shapes must agree."""
    from elf_tpu_torch.models.checkpoint import read_checkpoint

    payload = read_checkpoint(path)
    net = NestedBottleneckNet(cfg)
    net.load_state_dict({**payload["params"], **payload["batch_stats"]})
    return net.to(resolve_device(device))

