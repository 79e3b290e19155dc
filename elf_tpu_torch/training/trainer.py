"""Learner: train step, optimizer, BN cooldown.  Counterpart of
`elf_tpu/training/trainer.py` (reference `model_interface.py:106`,
`trainer/trainer.py:209`, `df_model3.py:277 prepare_cooldown`).

The JAX trainer threads an immutable TrainState through jitted steps.
Here the state owns a net, and every step updates the net and the
optimizer slots in place and returns the same state object; whoever needs
a frozen copy takes `copy.deepcopy(state)` first.

The optimizer is written out as tensor updates in optax's order
(`make_optimizer`): clip by global norm, then L2 decay on every parameter
(BN scales and biases too: optax has no mask here), then SGD with a
momentum trace or Adam.  Its state is kept in the dict shape that
`flax.serialization.to_state_dict` gives the optax chain's state, so the
checkpoint writer (`models/checkpoint.py`) stores it as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.models.checkpoint import (  # noqa: F401  (re-exported)
    load_checkpoint,
    save_checkpoint,
    save_params_checkpoint,
    version_from_path,
)
from elf_tpu_torch.models.resnet import (
    ModelConfig,
    PolicyValueNet,
    init_weights,
)
from elf_tpu_torch.training.loss import (
    mcts_prediction_loss,
    multiple_prediction_loss,
)

ADAM_B1, ADAM_B2 = 0.9, 0.999      # optax.adam's defaults


@dataclasses.dataclass
class TrainState:
    net: PolicyValueNet     # parameters and BN statistics
    opt_state: dict         # the optax chain's state dict (see Optimizer)
    step: int


class Optimizer:
    """`optax.chain(clip_by_global_norm?, add_decayed_weights?, sgd|adam)`
    as in-place tensor updates.

    State: {"<i>": {}} for the stateless clip / decay links, and for the
    last link {"0": {"trace": slots}, "1": {}} (SGD) or {"0": {"count":
    i32 scalar on the host, "mu": slots, "nu": slots}, "1": {}} (Adam),
    where `slots` maps the net's parameter names to tensors shaped like
    the parameters."""

    def __init__(self, opts: TrainOptions):
        self.opts = opts
        self.adam = opts.opt_method == "adam"
        self.index = int(opts.grad_clip_norm > 0) + int(opts.weight_decay > 0)

    def init(self, net: PolicyValueNet) -> dict:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in net.named_parameters()}

        if self.adam:
            inner = {"count": torch.zeros((), dtype=torch.int32),
                     "mu": zeros(), "nu": zeros()}
        else:
            inner = {"trace": zeros()}
        state: dict = {str(i): {} for i in range(self.index)}
        state[str(self.index)] = {"0": inner, "1": {}}
        return state

    def update(self, net: PolicyValueNet, grads: List[torch.Tensor],
               grad_norm: torch.Tensor, opt_state: dict) -> None:
        """One optimizer step on `net` in place.  `grads` follow
        `net.named_parameters()` and are overwritten; `grad_norm` is their
        global norm."""
        o = self.opts
        names = [n for n, _ in net.named_parameters()]
        params = list(net.parameters())
        inner = opt_state[str(self.index)]["0"]
        if o.grad_clip_norm > 0:
            # optax: unchanged when norm < clip, else g / norm * clip
            scale = torch.where(grad_norm < o.grad_clip_norm,
                                torch.ones_like(grad_norm),
                                o.grad_clip_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        if o.weight_decay > 0:
            torch._foreach_add_(grads, params, alpha=o.weight_decay)
        if self.adam:
            mu = [inner["mu"][n] for n in names]
            nu = [inner["nu"][n] for n in names]
            inner["count"] += 1
            count = int(inner["count"])
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            bc1 = 1.0 - ADAM_B1 ** count
            bc2 = 1.0 - ADAM_B2 ** count
            # mu_hat / (sqrt(nu_hat) + eps): eps outside the square root
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, o.adam_eps)
            upd = torch._foreach_div(mu, den)
            torch._foreach_add_(params, upd, alpha=-o.lr / bc1)
        else:
            trace = [inner["trace"][n] for n in names]
            # t = g + momentum * t; p -= lr * t (no dampening, no Nesterov)
            torch._foreach_mul_(trace, o.momentum)
            torch._foreach_add_(trace, grads)
            torch._foreach_add_(params, trace, alpha=-o.lr)


def make_optimizer(opts: TrainOptions) -> Optimizer:
    return Optimizer(opts)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Trainer:
    def __init__(self, cfg: ModelConfig, opts: TrainOptions,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        self.tx = make_optimizer(opts)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Fresh state: flax's default initialisation drawn from
        `generator` (a CPU generator), zero optimizer slots, step 0."""
        net = PolicyValueNet(self.cfg)
        init_weights(net, generator)
        net = net.to(self.device)
        return TrainState(net=net, opt_state=self.tx.init(net), step=0)

    # -- steps --------------------------------------------------------------

    def _step_with(self, loss_fn: Callable, mesh=None) -> Callable:
        """A train step whose loss is `loss_fn(log_pi, value, target,
        winner)` -> (loss, stats): one training forward (BN statistics
        written once, with or without remat), the gradients of the fp32
        masters, their global norm, one optimizer update.

        With a `parallel.mesh.Mesh` the step takes this rank's batch rows
        and shard of the state (`parallel.mesh.make_sharded_train_step`):
        the gradients are averaged over dp and the partly used vectors'
        summed over tp before the norm and the update, and the stats are
        the dp mean, the same on every rank."""
        tx = self.tx

        def train_step(
            state: TrainState, features, target, winner
        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            net = state.net
            with torch.enable_grad():
                log_pi, value = net(features, train=True)
                loss, stats = loss_fn(log_pi, value, target, winner)
                grads = list(torch.autograd.grad(loss, list(net.parameters())))
            with torch.no_grad():
                stats = {k: v.detach() for k, v in stats.items()}
                if mesh is None:
                    stats["grad_norm"] = global_norm(grads)  # before clipping
                else:
                    mesh.reduce_gradients(net, grads)
                    stats = mesh.dp_mean(stats)
                    stats["grad_norm"] = mesh.global_norm(net, grads)
                tx.update(net, grads, stats["grad_norm"], state.opt_state)
            state.step += 1
            return state, stats

        return train_step

    def make_train_step(self, mesh=None) -> Callable:
        """AlphaZero step (df_kl): `train_step(state, features,
        mcts_scores, winner)` with the MCTSPrediction loss (`mesh`: see
        `_step_with`)."""
        value_weight = self.opts.value_loss_weight

        def loss_fn(log_pi, value, mcts_scores, winner):
            return mcts_prediction_loss(log_pi, value, mcts_scores, winner,
                                        value_weight=value_weight)

        return self._step_with(loss_fn, mesh)

    def make_offline_train_step(self, mesh=None) -> Callable:
        """Supervised step (df_pred): `train_step(state, features,
        offline_a, winner)` with MultiplePrediction over the multi-horizon
        `offline_a` [B, T] targets (multiple_prediction.py:30); the same
        optimizer, `grad_norm` stat and fp32 masters as `make_train_step`."""
        return self._step_with(multiple_prediction_loss, mesh)

    def make_cooldown_step(self) -> Callable:
        """BN re-estimation pass: a training-mode forward that changes the
        running statistics only (prepare_cooldown + cooldown passes,
        single_process.py:101)."""

        def cooldown_step(state: TrainState, features) -> TrainState:
            with torch.no_grad():
                state.net(features, train=True)
            return state

        return cooldown_step

    def make_eval_fn(self) -> Callable:
        """Inference forward `eval_fn(net, batch_stats, features)` ->
        (log_pi, value).  The net stands where the JAX trainer passes
        `params` and carries its own BN statistics; `batch_stats` is
        ignored."""

        def eval_fn(net, batch_stats, features):
            return net(features)

        return eval_fn
