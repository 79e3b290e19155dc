"""Policy/value ResNet, inference and training: counterpart of
`elf_tpu/models/resnet.py` (reference `df_model3.py:113-306`).

  input  [B, N, N, C] float32, NHWC as in the JAX package (permuted to
         NCHW inside)
  trunk  3x3 conv(+bias) -> BN -> ReLU, then `num_block` residual blocks
         of conv-BN-ReLU, conv-BN-ReLU, + skip, ReLU (the second ReLU fires
         before the skip add, as in the reference)
  policy 1x1 conv -> 2 ch -> BN -> ReLU -> dense (N*N+1) -> log_softmax
  value  1x1 conv -> 1 ch -> BN -> ReLU -> dense 256 -> ReLU -> dense 1
         -> tanh

Numerics follow the JAX net.  Every parameter is an fp32 master weight.
The convolutions run in the compute dtype (bf16 when `use_bf16`): weight,
bias and input are cast per call, with explicit casts rather than
autocast; every BatchNorm and the dense layers run in fp32.  Serving
goes through `serving_copy`, a frozen copy whose convolutions already hold
the compute dtype, so no call casts them.  `net(x)` normalises with the running
statistics; `net(x, train=True)` normalises with the batch statistics and
updates the running ones, as flax's BatchNorm does (eps 1e-5, fast
variance, biased batch variance in the running statistic).  `pi_fc`
consumes the NHWC flatten of the policy planes, as the flax Dense does.

`ModelConfig(remat=True)` recomputes each residual block in the backward
pass (`torch.utils.checkpoint`, the counterpart of flax's `nn.remat`); the
trunk's first layer and the heads keep their activations.  A training
forward collects every BN layer's batch statistics and writes the running
statistics once, after the forward: a recomputed block computes its
statistics again but writes nothing, so they move once per step, as
flax's `mutable=["batch_stats"]` moves them.

On a mesh (`parallel.mesh.shard_state`) the same forward runs over the
ranks of a ("dp", "tp") world: a BatchNorm whose `sync` is set reduces
its batch statistics over the dp group, a Conv or Dense layer whose `tp`
is set holds its tp shard and runs as a column- or row-parallel layer,
and a BatchNorm whose `channels` is set normalises that slice of the
channels.  Without a mesh these attributes are None and the forward is
the plain one, bit for bit.

The serving path (`PolicyValueNet.serve`).  A serving copy
(`prepare_serving`) holds each trunk BN's `rsqrt(running_var + eps) *
weight` (`serving_mul`), computed once with the same torch ops as the
forward computes it.  Its forward on a CUDA input keeps every trunk
activation NHWC (`torch.channels_last`, the layout of cuDNN's kernels; the
copy's conv weights are stored so) and runs each trunk convolution without
its bias, then one epilogue kernel (`models/epilogue.py`): the bias add,
BN, ReLU, the casts and, after a block's second convolution, the skip add
and its ReLU, with the modules' roundings and order of operations, so it
gives their bits (cuDNN may pick another convolution algorithm for the
NHWC layout, which can move a forward's last bits).  The heads, `PolicyNet`
and a sharded net keep the modules.  `net.forwards` counts serving forwards
and `net.epilogues` the epilogues while tracing is on.

The training path (`_train_layer`).  A training forward on a CUDA input of
a net without mesh attributes, whose channels are a multiple of 8, runs
each trunk layer as its convolution and one training epilogue
(`models/epilogue.py`'s `train_epilogue`): BN with the batch statistics,
ReLU, the casts and the skip add, hand-written CUDA forward and backward,
returning the statistics.  The activations and their gradients stay
channels_last from the first convolution to the heads, and each
convolution runs without its bias (the epilogue adds it) and with its
weight cast to channels_last per call.  A CPU input keeps the modules.
`net.train_epilogues` counts the epilogues' forward calls (a recomputed
block's too) and `net.train_epilogue_grads` their backward calls while
tracing is on.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elf_tpu_torch import profiling
from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.models.epilogue import BN_EPS, epilogue, train_epilogue


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    board_size: int = 19
    num_planes: int = 18
    num_block: int = 20
    dim: int = 256
    value_hidden: int = 256
    bn_momentum: float = 0.0   # torch convention (df_model3 default 0.0)
    use_bf16: bool = True
    # recompute the residual blocks in the backward pass (less activation
    # memory for more operations; the batch-2048 train step needs it)
    remat: bool = False

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size + 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bf16 else torch.float32

    @property
    def torch_bn_momentum(self) -> float:
        """running = (1 - m) * running + m * batch.  The reference passes
        `momentum=(bn_momentum or None)`, so 0.0 means torch's default 0.1
        (`elf_tpu/models/resnet.py:54-63` keeps the same quirk)."""
        return self.bn_momentum if self.bn_momentum > 0 else 0.1


class BatchNorm(nn.Module):
    """BatchNorm over (B, H, W) in fp32, flax's order of operations:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, dim: int, momentum: float = 0.1):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        # on a mesh: the Mesh whose dp group the batch statistics are
        # reduced over, and the slice of the channels this rank holds
        self.sync = None
        self.channels: Optional[slice] = None
        # a serving copy's rsqrt(running_var + eps) * weight
        # (`prepare_serving`)
        self.serving_mul: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Running statistics, or with `train` the batch statistics, which
        then also update the running ones."""
        if not train:
            return self._normalise(x.float(), *self._running())
        y, mean, var = self.batch_norm(x)
        self.update_running(mean, var)
        return y

    def batch_norm(self, x: torch.Tensor):
        """(y, mean, var): normalised with the batch statistics, which are
        returned and not written."""
        x = x.float()
        if self.sync is not None:
            mean, var = self.sync.dp_moments(x)
            return self._normalise(x, mean, var), mean, var
        # flax `_compute_stats`: var = max(0, E[x^2] - E[x]^2), and the
        # running statistic takes this biased batch variance
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        return self._normalise(x, mean, var), mean, var

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        running_mean, running_var = self._running()
        running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _running(self):
        """The running statistics of this rank's channels (views)."""
        if self.channels is None:
            return self.running_mean, self.running_var
        return (self.running_mean[self.channels],
                self.running_var[self.channels])

    def _normalise(self, x, mean, var):
        weight, bias = self.weight, self.bias
        if self.channels is not None:
            weight, bias = weight[self.channels], bias[self.channels]
        mul = torch.rsqrt(var + BN_EPS) * weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return y + bias[:, None, None]


def _bn(bn: BatchNorm, x: torch.Tensor, stats: Optional[list]):
    """`bn` on x: the running statistics where `stats` is None, else the
    batch statistics, appended to `stats` as (mean, var)."""
    if stats is None:
        return bn(x)
    y, mean, var = bn.batch_norm(x)
    stats += [mean, var]
    return y


class Conv(nn.Module):
    """k x k "same" convolution with fp32 master weight and, unless `bias`
    is False, bias, computed in `dtype` (flax `nn.Conv(dtype=...)` with
    fp32 `param_dtype`)."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.padding = k // 2
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.tp = None      # on a mesh: its `parallel.mesh.LayerSplit`

    def _conv(self, x, w, b):
        return F.conv2d(x, w, b, padding=self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # no copy is made where the parameters already have the dtype
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.tp is None:
            return self._conv(x, w, b)
        return self.tp.apply(self._conv, x, w, b)


class Dense(nn.Linear):
    """nn.Linear that can run as a tp shard (`tp`, as Conv's)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return F.linear(x, self.weight, self.bias)
        return self.tp.apply(F.linear, x, self.weight, self.bias)


class ResBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, momentum: float = 0.1):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, dtype)
        self.bn1 = BatchNorm(dim, momentum)
        self.conv2 = Conv(dim, dim, 3, dtype)
        self.bn2 = BatchNorm(dim, momentum)

    def forward(self, x: torch.Tensor, train: bool = False,
                epilogues: bool = False):
        """(output, batch statistics): with `train` the four tensors
        (mean1, var1, mean2, var2), which the caller writes; else ().  With
        `epilogues` (a training forward) each layer is one training
        epilogue (`_train_layer`)."""
        dt = x.dtype
        stats = [] if train else None
        if epilogues:
            y = _train_layer(self.conv1, self.bn1, x, stats)
            y = _train_layer(self.conv2, self.bn2, y, stats, skip=x)
            return y, tuple(stats)
        y = F.relu(_bn(self.bn1, self.conv1(x), stats))
        y = F.relu(_bn(self.bn2, self.conv2(y.to(dt)), stats))
        return F.relu(x + y.to(dt)), tuple(stats or ())


class ServingNet(nn.Module):
    """A net that `prepare_serving` can make a serving copy of.  It gives
    `serve(x)`, the forward with the running statistics through the
    epilogues, and `serving_norms()`, the norms `serve` hands to them."""

    serves = False      # set by `prepare_serving` where the copy can serve

    def takes_serving_path(self, x: torch.Tensor, train: bool) -> bool:
        """Whether `forward` runs `serve`: a serving copy that can, a CUDA
        input, the running statistics."""
        return not train and x.is_cuda and self.serves


class PolicyValueNet(ServingNet):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt, m = cfg.compute_dtype, cfg.torch_bn_momentum
        self.init_conv = Conv(cfg.num_planes, cfg.dim, 3, dt)
        self.init_bn = BatchNorm(cfg.dim, m)
        self.blocks = nn.ModuleList(
            [ResBlock(cfg.dim, dt, m) for _ in range(cfg.num_block)]
        )
        self.pi_conv = Conv(cfg.dim, 2, 1, dt)
        self.pi_bn = BatchNorm(2, m)
        self.pi_fc = nn.Linear(2 * cfg.board_size ** 2, cfg.num_actions)
        self.v_conv = Conv(cfg.dim, 1, 1, dt)
        self.v_bn = BatchNorm(1, m)
        self.v_fc1 = Dense(cfg.board_size ** 2, cfg.value_hidden)
        self.v_fc2 = Dense(cfg.value_hidden, 1)

    def takes_train_epilogues(self, x: torch.Tensor, train: bool) -> bool:
        """Whether `forward` runs its trunk through the training epilogues
        (`_train_layer`): a training forward on a CUDA input of a net
        without mesh attributes whose channels are a multiple of 8."""
        return (train and x.device.type == "cuda"
                and _fits_epilogues(self, self.trunk_bns()))

    def forward(self, x: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, N, N, C] float32 -> (log_pi [B, A] f32, value [B] f32).
        `train` selects the batch statistics and updates the running ones,
        once, after the forward; with `cfg.remat` it recomputes each block
        in the backward pass."""
        if self.takes_serving_path(x, train):
            return self.serve(x)
        dt = self.cfg.compute_dtype
        stats = [] if train else None
        fused = self.takes_train_epilogues(x, train)
        h = x.permute(0, 3, 1, 2).to(dt)
        if fused:
            h = _train_layer(self.init_conv, self.init_bn, h, stats)
        else:
            h = F.relu(_bn(self.init_bn, self.init_conv(h), stats)).to(dt)
        for block in self.blocks:
            if train and self.cfg.remat:
                h, bs = checkpoint(block, h, True, fused, use_reentrant=False)
            else:
                h, bs = block(h, train, fused)
            if train:
                stats += bs
        log_pi, value = self._heads(h, stats)
        if train:
            bns = self.trunk_bns() + [self.pi_bn, self.v_bn]
            for bn, mean, var in zip(bns, stats[0::2], stats[1::2]):
                bn.update_running(mean, var)
        return log_pi, value

    def _heads(self, h: torch.Tensor, stats: Optional[list]):
        """(log_pi, value) of the trunk's output h."""
        B = h.shape[0]
        p = F.relu(_bn(self.pi_bn, self.pi_conv(h), stats))
        p = p.permute(0, 2, 3, 1).reshape(B, -1)        # NHWC flatten
        log_pi = F.log_softmax(self.pi_fc(p), dim=-1)
        v = F.relu(_bn(self.v_bn, self.v_conv(h), stats)).reshape(B, -1)
        v = self.v_fc2(F.relu(self.v_fc1(v)))
        return log_pi, torch.tanh(v[:, 0])

    def trunk_bns(self) -> list:
        """The trunk's BN layers in order: the first layer's, then each
        block's two."""
        return [self.init_bn] + [bn for blk in self.blocks
                                 for bn in (blk.bn1, blk.bn2)]

    serving_norms = trunk_bns

    def serve(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving path of a serving copy (`serving_copy`): `forward`
        with the running statistics, each trunk BN (with its ReLU, casts
        and skip add) one epilogue.  `forward` takes it on a CUDA input; on
        a CPU input the epilogues are the plain version."""
        profiling.count("net.forwards")
        h = x.permute(0, 3, 1, 2).to(self.cfg.compute_dtype,
                                      memory_format=torch.channels_last)
        h = _trunk_layer(self.init_conv, self.init_bn, h)
        for blk in self.blocks:
            y = _trunk_layer(blk.conv1, blk.bn1, h)
            h = _trunk_layer(blk.conv2, blk.bn2, y, skip=h)
        return self._heads(h, None)


def _trunk_layer(conv: Conv, bn: BatchNorm, h: torch.Tensor,
                 skip: Optional[torch.Tensor] = None):
    """relu(bn(conv(h))), or with `skip` relu(skip + relu(bn(conv(h)))),
    in the compute dtype: the convolution, then one epilogue.  cuDNN adds a
    convolution's bias as a pass of its own, rounded to the compute dtype,
    so on the card the epilogue takes that add; the CPU's convolution adds
    the bias inside."""
    if h.is_cuda:
        v, conv_bias = F.conv2d(h, conv.weight, None,
                                padding=conv.padding), conv.bias
    else:
        v, conv_bias = conv(h), None
    return epilogue(v, bn.running_mean, bn.serving_mul, bn.bias, skip,
                    conv_bias)


def _train_layer(conv: Conv, bn: BatchNorm, h: torch.Tensor,
                 stats: list, skip: Optional[torch.Tensor] = None):
    """relu(bn(conv(h))) with the batch statistics, or with `skip`
    relu(skip + relu(bn(conv(h)))), in the compute dtype on the card: the
    convolution on channels_last activations, its weight cast to
    channels_last per call and without its bias, then one training
    epilogue (`models/epilogue.py`), which adds the bias as the serving
    path does; appends (mean, var) to `stats`."""
    h = h.contiguous(memory_format=torch.channels_last)
    w = conv.weight.to(conv.dtype, memory_format=torch.channels_last)
    v = F.conv2d(h, w, None, padding=conv.padding)
    y, mean, var = train_epilogue(v, bn.weight, bn.bias, skip, conv.bias)
    stats += [mean, var]
    return y


# 1 / stddev of a unit normal truncated to (-2, 2): flax's `lecun_normal`
# divides by it so that the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation, in distribution: `lecun_normal`
    kernels (truncated normal, variance 1 / fan_in), zero biases, BN scale
    1, BN statistics (0, 1).  Serves `PolicyValueNet` and `PolicyNet`."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim > 1:
                fan_in = int(np.prod(p.shape[1:]))
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                p.copy_(w / (_TRUNC_STD * np.sqrt(fan_in)))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in net.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda",
                seed: int = 0) -> PolicyValueNet:
    """A PolicyValueNet with seeded random weights (`init_weights`)."""
    dev = resolve_device(device)
    net = PolicyValueNet(cfg)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev)


# --------------------------------------------------------------------------
# the flax trees: params / batch_stats as nested dicts in flax's layouts
# --------------------------------------------------------------------------

def _flax_names(cfg: ModelConfig) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch name, flax path, kind) of every parameter and BN statistic.
    kind: "conv" [O, I, kh, kw] <-> [kh, kw, I, O]; "dense" [O, I] <->
    [I, O]; "vec" as it is; "stat" a vector of `batch_stats`."""

    def conv(t, f):
        yield f"{t}.weight", (*f, "kernel"), "conv"
        yield f"{t}.bias", (*f, "bias"), "vec"

    def bn(t, f):
        yield f"{t}.weight", (*f, "scale"), "vec"
        yield f"{t}.bias", (*f, "bias"), "vec"
        yield f"{t}.running_mean", (*f, "mean"), "stat"
        yield f"{t}.running_var", (*f, "var"), "stat"

    def dense(t, f):
        yield f"{t}.weight", (*f, "kernel"), "dense"
        yield f"{t}.bias", (*f, "bias"), "vec"

    yield from conv("init_conv", ("init_conv",))
    yield from bn("init_bn", ("init_bn",))
    for i in range(cfg.num_block):
        for j in (1, 2):
            yield from conv(f"blocks.{i}.conv{j}", (f"block{i}", f"conv{j}"))
            yield from bn(f"blocks.{i}.bn{j}", (f"block{i}", f"bn{j}"))
    for head in ("pi", "v"):
        yield from conv(f"{head}_conv", (f"{head}_conv",))
        yield from bn(f"{head}_bn", (f"{head}_bn",))
    for fc in ("pi_fc", "v_fc1", "v_fc2"):
        yield from dense(fc, (fc,))


def _to_flax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t.t() if kind == "dense" else t


def _from_flax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    return t.t() if kind == "dense" else t


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _get(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tensors_to_flax(cfg: ModelConfig, named: Mapping[str, torch.Tensor],
                    stats: bool = False) -> dict:
    """The flax tree (nested dicts of CPU tensors in flax's layouts) of the
    tensors in `named`, keyed by the net's parameter names (`stats`: by its
    BN statistics' names).  Serves the parameters themselves and every
    optimizer slot shaped like them."""
    out: dict = {}
    for name, path, kind in _flax_names(cfg):
        if (kind == "stat") == stats:
            t = _to_flax(named[name].detach(), kind)
            _put(out, path, t.cpu().contiguous())
    return out


def flax_to_tensors(cfg: ModelConfig, tree: Mapping,
                    stats: bool = False) -> Dict[str, torch.Tensor]:
    """Inverse of `tensors_to_flax`: name -> tensor in torch's layout."""
    return {
        name: _from_flax(_t(_get(tree, path)), kind)
        for name, path, kind in _flax_names(cfg)
        if (kind == "stat") == stats
    }


def load_flax_trees(net: PolicyValueNet, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Copy the flax `params` / `batch_stats` trees into `net` (cast to
    its fp32 masters; shapes must agree)."""
    own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    with torch.no_grad():
        for tree, stats in ((params, False), (batch_stats, True)):
            for name, t in flax_to_tensors(net.cfg, tree, stats).items():
                if t.shape != own[name].shape:
                    raise ValueError(
                        f"checkpoint shape mismatch at {name}: "
                        f"{tuple(t.shape)} vs {tuple(own[name].shape)}")
                own[name].copy_(t)


def params_from_jax(params: Mapping, batch_stats: Mapping, cfg: ModelConfig,
                    device: DeviceLike = "cuda") -> PolicyValueNet:
    """A PolicyValueNet holding the flax `params` / `batch_stats` trees
    (nested dicts of numpy arrays or tensors, as `flax` or
    `checkpoint.msgpack_restore` give them).

    conv [kh, kw, I, O] -> [O, I, kh, kw]; dense [I, O] -> [O, I];
    BN scale/bias/mean/var -> weight/bias/running_mean/running_var."""
    dev = resolve_device(device)
    net = PolicyValueNet(cfg)
    load_flax_trees(net, params, batch_stats)
    return net.to(dev)


def params_to_jax(net: PolicyValueNet) -> Tuple[dict, dict]:
    """Inverse of `params_from_jax`: (params, batch_stats) as nested dicts
    of numpy arrays in flax's layouts."""

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy().copy()
                for k, v in tree.items()}

    params = tensors_to_flax(net.cfg, dict(net.named_parameters()))
    stats = tensors_to_flax(net.cfg, dict(net.named_buffers()), stats=True)
    return to_numpy(params), to_numpy(stats)


def load_model(path: str, cfg: ModelConfig,
               device: DeviceLike = "cuda") -> PolicyValueNet:
    """PolicyValueNet from a flax-msgpack checkpoint of the JAX trainer."""
    from elf_tpu_torch.models.checkpoint import read_checkpoint

    payload = read_checkpoint(path)
    return params_from_jax(payload["params"], payload["batch_stats"], cfg,
                           device)


def _fits_epilogues(net: nn.Module, norms: list) -> bool:
    """Whether the epilogue kernels can take `norms`, the norms a path of
    `net` hands them: no module of `net` has a mesh attribute set, and each
    norm has a multiple of 8 channels (the kernels' lanes)."""
    return all(bn.weight.shape[0] % 8 == 0 for bn in norms) and not any(
        getattr(m, "tp", None) is not None or (
            isinstance(m, BatchNorm)
            and (m.sync is not None or m.channels is not None))
        for m in net.modules())


def prepare_serving(net: ServingNet) -> None:
    """Make the frozen copy `net` a serving copy: its convolutions in the
    compute dtype and, where it can serve (every parameter frozen, no mesh
    attribute set, each of `serving_norms()` a multiple of 8 channels),
    each of those norms' `serving_mul` and, on the card, its conv weights
    in channels_last, so that it serves through `serve`."""
    convs = [m for m in net.modules() if isinstance(m, Conv)]
    for m in convs:
        m.to(m.dtype)
    norms = net.serving_norms()
    net.serves = (not any(p.requires_grad for p in net.parameters())
                  and _fits_epilogues(net, norms))
    for bn in norms:        # a copy that does not serve keeps none
        bn.serving_mul = (torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
                          if net.serves else None)
    if net.serves and convs[0].weight.is_cuda:
        for m in convs:
            m.to(memory_format=torch.channels_last)


def serving_copy(net: ServingNet) -> ServingNet:
    """A frozen copy of `net` (a `PolicyValueNet` or a
    `models.nbt.NestedBottleneckNet`) for inference, whose convolutions
    hold their weights in the compute dtype.  Later updates of `net` do not
    reach it, as a jitted function keeps the parameters it was given.
    Where it can, the copy serves through the net's `serve`
    (`prepare_serving`)."""
    frozen = copy.deepcopy(net).requires_grad_(False)
    prepare_serving(frozen)
    return frozen


def eval_fn_builder(net: nn.Module, batch_stats=None):
    """The actor's `eval_fn_builder(params, batch_stats)` for a torch net
    that maps [B, N, N, C] planes to (log_pi, value): the net is the params,
    and carries its own BN statistics.  The evaluator serves the weights as
    they are now (`serving_copy`)."""
    frozen = serving_copy(net)

    def eval_fn(feats: torch.Tensor, to_play: torch.Tensor):
        return frozen(feats)

    return eval_fn
