"""Device-mesh parallelism for the learner and the actors: counterpart of
`elf_tpu/parallel/mesh.py` (reference `nn.DataParallel`, df_model3.py:204,
and NCCL `DistributedDataParallel`, df_model3.py:213-247).

The JAX package shards one jitted step over a `Mesh(("dp", "tp"))` of the
chips one process drives (GSPMD).  PyTorch runs one process per card, so
here the mesh is a `torch.distributed` world with one rank per device,
arranged dp-major as `np.array(devices).reshape(n // tp, tp)` arranges
the chips: rank = dp_index * tp + tp_index.

 - dp: each dp index takes a contiguous share of the batch rows.  Every
   BatchNorm's batch mean and variance are reduced over the dp group (fp32
   sums of x and x^2, `all_reduce`, autograd-aware), so a training forward
   normalises with the statistics of the whole batch and updates the
   running ones from them, as flax BN does under GSPMD; gradients are
   averaged over dp in one flat `all_reduce`.
 - tp: the ResNet's channel dimensions are split Megatron-style
   (`param_shardings`): `init_conv` and every `conv1` column-parallel
   (output channels), every `conv2` row-parallel (input channels), the
   value head's `v_fc1` column- and `v_fc2` row-parallel.  A
   column-parallel layer is entered through `tp_copy` (identity forward,
   `all_reduce` backward) and a row-parallel one left through `tp_reduce`
   (`all_reduce` forward, identity backward); `init_conv`'s output is made
   whole again (`tp_gather`) before the first block.  Vectors (biases, BN
   scales and statistics) stay replicated; a rank uses the slice its
   channels need, and the gradient of a vector used in part is summed over
   tp so that every tp rank applies the same update.

Every sharded computation gives the unsharded one's result: the dp step
over a batch of B equals the single-device step over the same B.  With
one rank (`make_mesh(1)`) every path is the plain one.  Device
collectives run on the world's backend (NCCL on the card, gloo on the
CPU or for several ranks on one card); host gathers run on a CPU gloo
group beside it.  Only `all_reduce` and `broadcast` touch device tensors,
which gloo carries for CUDA tensors too.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from elf_tpu_torch.parallel.distributed import host_group


# --------------------------------------------------------------------------
# autograd-aware collectives
# --------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place; 16-bit floats are summed in fp32
    (gloo may refuse bf16, and a row-parallel layer's partial sums keep
    fp32's precision until the result is rounded once)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the gradient is summed over the group too (every
    rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _Copy(torch.autograd.Function):
    """Identity forward, sum of the gradients over the group backward: the
    entry of a column-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum forward, identity backward: the exit of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int, index: int,
            parts: int) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` in rank order: an
    `all_reduce` of zero-padded slots (gloo may refuse `all_gather` of
    CUDA tensors)."""
    c = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = c * parts
    full = x.new_zeros(shape)
    full.narrow(dim, index * c, c).copy_(x)
    return _all_reduce(full, group)


class _Gather(torch.autograd.Function):
    """Concatenation forward, this rank's slot of the gradient backward
    (what follows runs replicated, so every rank holds the whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, index, parts):
        ctx.dim, ctx.index, ctx.c = dim, index, x.shape[dim]
        return _gather(x, group, dim, index, parts)

    @staticmethod
    def backward(ctx, g):
        g = g.narrow(ctx.dim, ctx.index * ctx.c, ctx.c).contiguous()
        return g, None, None, None, None


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

class Mesh:
    """A ("dp", "tp") arrangement of a torch.distributed world, one rank per
    device (or a single rank without a process group).  Groups of size 1
    are not made: their collectives are identities.  A deep copy of a
    module that refers to the mesh shares it."""

    def __init__(self, dp: int, tp: int, rank: int = 0, dp_group=None,
                 tp_group=None, host_group=None):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.dp_index, self.tp_index = divmod(rank, tp)
        self.dp_group, self.tp_group = dp_group, tp_group
        self.host_group = host_group

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def __deepcopy__(self, memo):
        return self

    # -- device collectives (autograd-aware) -------------------------------

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dp == 1 else _AllReduce.apply(x, self.dp_group)

    def dp_moments(self, x: torch.Tensor):
        """(mean, biased var) per channel of NCHW `x` over the rows of every
        dp rank: fp32 sums of x and x^2, reduced over dp."""
        x = x.float()
        n = x.numel() // x.shape[1] * self.dp
        s = torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))])
        s = self.dp_sum(s)
        mean = s[0] / n
        return mean, (s[1] / n - mean * mean).clamp(min=0.0)

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.tp_group)

    def tp_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.tp_group)

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.tp_group, dim, self.tp_index, self.tp)

    # -- host collectives --------------------------------------------------

    def host_gather_rows(self, a: np.ndarray) -> np.ndarray:
        """Every dp index's rows of a per-board host array, concatenated in
        dp order (the tp ranks of one dp index hold the same rows; tp index
        0's copy is taken).  Collective over the world."""
        if self.size == 1:
            return a
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=(
            np.uint8 if a.dtype == bool else a.dtype)))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.host_group)
        return np.concatenate([parts[d * self.tp].numpy()
                               for d in range(self.dp)]).astype(a.dtype)

    # -- the train step's reductions ---------------------------------------

    def reduce_gradients(self, net, grads: List[torch.Tensor]) -> None:
        """In place: average over dp, then sum over tp the gradients of the
        vectors this rank uses in part (`net.named_parameters()` order)."""
        if self.dp > 1:
            _flat_all_reduce(grads, self.dp_group)
            torch._foreach_div_(grads, float(self.dp))
        if self.tp > 1:
            kinds = param_kinds(net)
            _flat_all_reduce([g for g, k in zip(grads, kinds)
                              if k == "partial"], self.tp_group)

    def global_norm(self, net, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the whole (unsharded) gradient: squares of
        the tp-split tensors summed over tp, each replicated tensor once."""
        from elf_tpu_torch.training.trainer import global_norm

        if self.tp == 1:
            return global_norm(grads)
        kinds = param_kinds(net)

        def sq(ts):
            if not ts:
                return grads[0].new_zeros(())
            return torch.stack(torch._foreach_norm(ts)).square().sum()

        split = sq([g for g, k in zip(grads, kinds) if k == "split"])
        dist.all_reduce(split, group=self.tp_group)
        rest = sq([g for g, k in zip(grads, kinds) if k != "split"])
        return torch.sqrt(split + rest)

    def dp_mean(self, stats: Dict[str, torch.Tensor]):
        """The dp mean of each scalar stat (the same on every rank)."""
        if self.dp == 1:
            return stats
        keys = list(stats)
        v = torch.stack([stats[k].float() for k in keys])
        dist.all_reduce(v, group=self.dp_group)
        v = v / self.dp
        return {k: v[i] for i, k in enumerate(keys)}


def _flat_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, in one bucket."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> Mesh:
    """A ("dp", "tp") mesh over the world's ranks, one per device.  Without
    a process group (or with `n_devices` 1 in a world of one) the mesh is
    the trivial 1 x 1 one: the plain step.  Collective: every rank calls
    it in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n}): the world has {world} ranks, "
                         "one per device")
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    dp = n // tp
    if world == 1:
        return Mesh(dp, tp)
    rank = dist.get_rank()
    d, t = divmod(rank, tp)
    dp_group = tp_group = None
    if dp > 1:
        for tt in range(tp):
            g = dist.new_group([dd * tp + tt for dd in range(dp)])
            if tt == t:
                dp_group = g
    if tp > 1:
        for dd in range(dp):
            g = dist.new_group([dd * tp + tt for tt in range(tp)])
            if dd == d:
                tp_group = g
    return Mesh(dp, tp, rank, dp_group, tp_group, host_group())


# --------------------------------------------------------------------------
# sharding rules and the sharded state
# --------------------------------------------------------------------------

# _PARAM_RULES in torch layouts: conv weights [out, in, kh, kw] and Linear
# weights [out, in], where flax kernels are [kh, kw, in, out] / [in, out].
# The dimension named is the one split over tp.
_PARAM_RULES = (
    (r"(^|\.)conv1\.weight$", 0),       # column-parallel
    (r"(^|\.)conv2\.weight$", 1),       # row-parallel
    (r"^init_conv\.weight$", 0),
    (r"^pi_fc\.weight$", None),
    (r"^v_fc1\.weight$", 0),            # P(None, "tp")
    (r"^v_fc2\.weight$", 1),            # P("tp", None)
)
# how each split layer is entered and left (see the module docstring)
_LAYER_MODES = (
    (r"(^|\.)conv1$", "column"),
    (r"(^|\.)conv2$", "row"),
    (r"^init_conv$", "gather"),
    (r"^v_fc1$", "column"),
    (r"^v_fc2$", "row"),
)
# BatchNorm layers fed by a column-parallel layer: a rank normalises its
# own channels
_SPLIT_BN = r"(^|\.)bn1$"
_SLOTS = ("trace", "mu", "nu")     # optimizer slots shaped like the params


def _rule(table, name: str):
    for pat, v in table:
        if re.search(pat, name):
            return v
    return None


def param_shardings(mesh: Mesh, net) -> Dict[str, Optional[int]]:
    """For each parameter of `net`, the dimension split over tp (None:
    replicated, as every vector and `pi_fc` are).  All None when tp = 1."""
    return {
        name: (_rule(_PARAM_RULES, name) if mesh.tp > 1 and p.ndim > 1
               else None)
        for name, p in net.named_parameters()
    }


def param_kinds(net) -> List[str]:
    """Per parameter of a sharded net (`named_parameters()` order):
    "split" (a tp shard), "partial" (a replicated vector this rank uses a
    slice of) or "replicated"."""
    kinds = {}
    for mname, m in net.named_modules():
        split = getattr(m, "tp", None)
        channels = getattr(m, "channels", None)
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if split is not None and pname == "weight":
                kinds[name] = "split"
            elif ((split is not None and split.mode != "row"
                   and pname == "bias") or channels is not None):
                kinds[name] = "partial"
            else:
                kinds[name] = "replicated"
    return [kinds[n] for n, _ in net.named_parameters()]


@dataclasses.dataclass(frozen=True)
class LayerSplit:
    """How a Conv or Dense layer runs over the tp group: "column" (output
    channels split, the bias sliced), "gather" (column, then the output
    made whole) or "row" (input channels split, the partial sums reduced,
    then the bias)."""

    mesh: Mesh
    mode: str

    def apply(self, op, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
        """`op(x, w, b)` (conv2d or linear) with the shard `w` of this rank."""
        m = self.mesh
        if self.mode == "row":
            y = m.tp_reduce(op(x, w, None))
            return y + b.reshape(-1, *([1] * (y.ndim - 2)))
        c = w.shape[0]
        y = op(m.tp_copy(x), w, b[m.tp_index * c:(m.tp_index + 1) * c])
        return m.tp_gather(y, dim=1) if self.mode == "gather" else y


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """The counterpart of the JAX TrainState of NamedShardings: the mesh and
    each parameter's split dimension (optimizer slots follow it)."""

    mesh: Mesh
    params: Dict[str, Optional[int]]


def _slot_dicts(opt_state: dict):
    """Every {param name: tensor} slot dict of an optimizer state."""
    for k, v in opt_state.items():
        if k in _SLOTS:
            yield v
        elif isinstance(v, dict):
            yield from _slot_dicts(v)


def _shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    c = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_index * c, c).clone()


def _channels(mesh: Mesh, dim: int) -> slice:
    c = dim // mesh.tp
    return slice(mesh.tp_index * c, (mesh.tp_index + 1) * c)


def shard_state(state, shardings: StateShardings):
    """This rank's shard of a full TrainState (a new one): split parameters
    and their optimizer slots narrowed to the rank's slice, the layers
    told how to run over the mesh.  The identity on a 1 x 1 mesh."""
    from elf_tpu_torch.training.trainer import TrainState

    mesh = shardings.mesh
    if mesh.size == 1:
        return state
    net = copy.deepcopy(state.net)
    opt_state = copy.deepcopy(state.opt_state)
    if mesh.tp > 1:
        for name, m in net.named_modules():
            mode = _rule(_LAYER_MODES, name)
            if mode is not None:
                m.tp = LayerSplit(mesh, mode)
            if re.search(_SPLIT_BN, name):
                m.channels = _channels(mesh, m.weight.shape[0])
        with torch.no_grad():
            for name, p in net.named_parameters():
                dim = shardings.params[name]
                if dim is not None:
                    p.data = _shard(p.data, dim, mesh)
                    for slots in _slot_dicts(opt_state):
                        slots[name] = _shard(slots[name], dim, mesh)
    if mesh.dp > 1:
        for m in net.modules():
            if hasattr(m, "sync"):
                m.sync = mesh
    return TrainState(net=net, opt_state=opt_state, step=state.step)


def gather_state(state, shardings: StateShardings):
    """The full TrainState of a rank's shard (a new one, on every rank):
    split parameters and slots gathered over tp, the split BN layers'
    running statistics assembled from each rank's channels, the layers
    plain again.  Collective over the world under tp."""
    from elf_tpu_torch.training.trainer import TrainState

    mesh = shardings.mesh
    if mesh.size == 1:
        return state
    net = copy.deepcopy(state.net)
    opt_state = copy.deepcopy(state.opt_state)

    def whole(t, dim):
        return _gather(t, mesh.tp_group, dim, mesh.tp_index, mesh.tp)

    with torch.no_grad():
        if mesh.tp > 1:
            for name, p in net.named_parameters():
                dim = shardings.params[name]
                if dim is not None:
                    p.data = whole(p.data, dim)
                    for slots in _slot_dicts(opt_state):
                        slots[name] = whole(slots[name], dim)
        for m in net.modules():
            if getattr(m, "channels", None) is not None:
                for buf in (m.running_mean, m.running_var):
                    buf.copy_(whole(buf[m.channels], 0))
            for attr in ("tp", "channels", "sync"):
                if hasattr(m, attr):
                    setattr(m, attr, None)
    return TrainState(net=net, opt_state=opt_state, step=state.step)


def replicate(mesh: Mesh, tree):
    """Shardings of a replicated tree: None (no split) at every leaf."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return None


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows [lo, hi) of a global batch (and the boards it
    plays): its dp index's contiguous share."""
    if batch % mesh.dp:
        raise ValueError(f"batch {batch} does not divide over dp={mesh.dp}")
    per = batch // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def make_sharded_train_step(trainer, mesh: Mesh, template_state,
                            train_mode: str = "mcts"):
    """(step_fn, shardings): the Trainer's step over the mesh (batch rows
    over dp, parameters over tp per `param_shardings`, optimizer slots
    following them).  `step_fn(shard, feats, target, winner)` takes this
    rank's rows and its shard of the state (`shard_state`), and returns
    the stats of the whole batch on every rank.  train_mode "offline"
    shards the df_pred supervised step instead.  On a 1 x 1 mesh the step
    is the plain one."""
    shardings = StateShardings(mesh, param_shardings(mesh,
                                                     template_state.net))
    on = None if mesh.size == 1 else mesh
    step_fn = (trainer.make_offline_train_step(mesh=on)
               if train_mode == "offline"
               else trainer.make_train_step(mesh=on))
    return step_fn, shardings
