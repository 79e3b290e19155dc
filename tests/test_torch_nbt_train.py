"""The learner of KataGo's nested-bottleneck net (`models/nbt.py`'s
training forward, `Trainer` through the registry, the checkpoints) on the
CPU, at `tests/test_torch_nbt.py`'s small size (9x9, trunk 32, mid 16,
pooling 8, one plain and one pooled block) and, for the counts, at
`b18c384nbt`'s widths.

The training forward's loss, every parameter's gradient and the running
statistics after a step against the plain float32 reference
(`models/nbt_reference.py`, batch statistics), with remat on and off; a
`make_trainer("kata_nbt")` step against the reference's SGD step; the
benchmark's training reference (`perfbench/reference/kata_nbt_train.py`)
against the package's; the counters; a learner's checkpoint read back by
the family's reader and by the self-play client's; and the benchmark's
`train_family` generator on a tiny cell.  The card's step:
`tests/test_torch_cuda.py`.

    python -m pytest tests/test_torch_nbt_train.py -q -n 0
"""

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elf_tpu_torch import profiling
from elf_tpu_torch.config import GameOptions, TrainOptions
from elf_tpu_torch.models import nbt, nbt_reference
from elf_tpu_torch.models.checkpoint import (load_checkpoint,
                                             save_params_checkpoint)
from elf_tpu_torch.models.registry import get_model_family, make_trainer
from elf_tpu_torch.models.resnet import BatchNorm
from elf_tpu_torch.training.loss import mcts_prediction_loss
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import Trainer, TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")

SMALL = nbt.NbtConfig(board_size=9, trunk_channels=32, mid_channels=16,
                      gpool_channels=8, num_blocks=2, gpool_blocks=(2,),
                      p1_channels=8, g1_channels=8, v1_channels=8, v2_size=8,
                      use_bf16=False)

# Tolerances of the fp32 training forward against the reference: the same
# arithmetic but for the variance's formula (flax's E[x^2] - E[x]^2
# against torch's var), the activations' layout (NHWC convolutions) and
# the reductions' order, carried through two blocks, the heads and the
# backward.  Measured at about 2e-7 (loss), 2e-5 (the worst leaf's
# gradient, against the larger of its norm and the median leaf's) and
# 2e-7 (running statistics).  The norms in bf16 miss each by 10 x or more
# (`test_the_tolerances_catch_bf16_norms`).
LOSS_TOL = 2e-6
GRAD_TOL = 2e-4
STATS_TOL = 2e-6


def _cfg_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _random_net(cfg, seed: int) -> nbt.NestedBottleneckNet:
    """Seeded weights, and the norms' scales, shifts and running statistics
    drawn away from the init."""
    net = nbt.build_model(cfg, "cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                C = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(C, generator=g) + 0.5)
                m.weight.copy_(torch.randn(C, generator=g) * 0.2 + 1.0)
                m.bias.copy_(torch.randn(C, generator=g) * 0.2)
        for name, p in net.named_parameters():
            if ".linear" in name and name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net


def _batch(cfg, B: int, seed: int):
    """(features [B, N, N, 18], visit distributions, winners)."""
    g = torch.Generator().manual_seed(seed)
    n2 = cfg.board_size ** 2
    x = (torch.rand(B, cfg.num_planes, cfg.board_size, cfg.board_size,
                    generator=g) < 0.3).float()
    x[:, 16] = 1.0
    x[:, 17] = 0.0
    pi = torch.rand(B, n2 + 1, generator=g) ** 4
    z = torch.where(torch.rand(B, generator=g) < 0.5, 1.0, -1.0)
    return x.permute(0, 2, 3, 1), pi / pi.sum(1, keepdim=True), z


def _reference_step(W0: dict, batch, cfg: dict, value_weight=1.0):
    """(loss, gradients by name, batch statistics by norm) of the plain
    reference's training forward."""
    W = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                     "running_var")))
         for k, v in W0.items()}
    stats = {}
    log_pi, value = nbt_reference.forward(W, batch[0], cfg, stats=stats)
    loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2],
                                   value_weight=value_weight)
    names = [k for k in W if W[k].requires_grad]
    grads = torch.autograd.grad(loss, [W[k] for k in names])
    return float(loss), dict(zip(names, grads)), stats


def _gaps(net, W0, batch):
    """The program's training step against the reference's: (loss gap,
    worst leaf's gradient gap, running statistics' gap)."""
    log_pi, value = net(batch[0], train=True)
    loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2])
    names = [n for n, _ in net.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(net.parameters()))))
    r_loss, r_grads, r_stats = _reference_step(W0, batch, _cfg_dict(net.cfg))
    norms = {k: float(g.norm()) for k, g in r_grads.items()}
    med = float(np.median(list(norms.values())))
    grad_gap = max(float((grads[k] - g).norm()) / max(norms[k], med)
                   for k, g in r_grads.items())
    m = net.cfg.torch_bn_momentum
    sd = net.state_dict()
    stats_gap = 0.0
    for name, (mean, var) in r_stats.items():
        for field, batch_stat in (("running_mean", mean),
                                  ("running_var", var)):
            want = (1 - m) * W0[f"{name}.{field}"] + m * batch_stat
            stats_gap = max(stats_gap, float(
                (sd[f"{name}.{field}"] - want).abs().max()))
    assert len(r_stats) == len(net.serving_norms())
    return abs(float(loss) - r_loss) / abs(r_loss), grad_gap, stats_gap


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_training_step_matches_the_reference(remat, seed):
    net = _random_net(dataclasses.replace(SMALL, remat=remat), seed)
    W0 = {k: v.clone() for k, v in net.state_dict().items()}
    loss_gap, grad_gap, stats_gap = _gaps(net, W0, _batch(SMALL, 6, seed))
    assert loss_gap <= LOSS_TOL
    assert grad_gap <= GRAD_TOL
    assert stats_gap <= STATS_TOL


def test_the_tolerances_catch_bf16_norms(monkeypatch):
    """Every norm's input and output rounded to bf16: each of the three
    gaps comes out above its tolerance."""
    plain = BatchNorm.batch_norm

    def bf16_norm(self, x):
        y, mean, var = plain(self, x.to(torch.bfloat16))
        return y.to(torch.bfloat16).float(), mean, var

    monkeypatch.setattr(BatchNorm, "batch_norm", bf16_norm)
    net = _random_net(SMALL, 0)
    W0 = {k: v.clone() for k, v in net.state_dict().items()}
    loss_gap, grad_gap, stats_gap = _gaps(net, W0, _batch(SMALL, 6, 0))
    assert loss_gap > 10 * LOSS_TOL
    assert grad_gap > 10 * GRAD_TOL
    assert stats_gap > 10 * STATS_TOL


def test_remat_gives_the_plain_step():
    """Remat recomputes each block with the same arithmetic: the same
    loss, gradients and running statistics bit for bit."""
    batch = _batch(SMALL, 5, 3)
    out = []
    for remat in (False, True):
        net = _random_net(dataclasses.replace(SMALL, remat=remat), 3)
        log_pi, value = net(batch[0], train=True)
        loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2])
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out.append((loss, grads, net.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_make_trainer_step_matches_the_reference_sgd_step():
    to = TrainOptions(batchsize=6, bf16=False, bn_momentum=0.3)
    trainer, mode, feature_set = make_trainer("kata_nbt", 9, to,
                                              device="cpu")
    assert isinstance(trainer, Trainer)
    assert (mode, feature_set) == ("mcts", "agz")
    assert trainer.cfg == nbt.NbtConfig(board_size=9, use_bf16=False,
                                        bn_momentum=0.3)
    # the same family at the small widths, to keep the CPU's work small
    trainer.cfg = dataclasses.replace(trainer.cfg, **{
        f.name: getattr(SMALL, f.name) for f in dataclasses.fields(SMALL)
        if f.name not in ("bn_momentum", "use_bf16")})
    state = trainer.init_state(torch.Generator().manual_seed(4))
    assert isinstance(state.net, nbt.NestedBottleneckNet)
    state.net.load_state_dict(_random_net(SMALL, 4).state_dict())
    W0 = {k: v.clone() for k, v in state.net.state_dict().items()}
    batch = _batch(SMALL, 6, 4)
    state, stats = trainer.make_train_step()(state, *batch)
    r_loss, r_grads, r_stats = _reference_step(W0, batch,
                                               _cfg_dict(trainer.cfg))
    assert abs(float(stats["loss/total"]) - r_loss) <= LOSS_TOL * r_loss
    # a fresh momentum trace: p1 = p0 - lr (g + wd p0)
    sd = state.net.state_dict()
    for k, g in r_grads.items():
        want = W0[k] - to.lr * (g + to.weight_decay * W0[k])
        step = float((want - W0[k]).norm())
        assert float((sd[k] - want).norm()) <= GRAD_TOL * max(step, 1e-12), k
    for name, (mean, _) in r_stats.items():
        want = 0.7 * W0[f"{name}.running_mean"] + 0.3 * mean
        assert torch.allclose(sd[f"{name}.running_mean"], want, rtol=0,
                              atol=STATS_TOL)
    assert state.step == 1
    # the optimizer's slots follow the net's parameter names
    assert list(state.opt_state["1"]["0"]["trace"]) == [
        n for n, _ in state.net.named_parameters()]


@contextlib.contextmanager
def _bench_path():
    sys.path[:0] = [BENCH, ROOT]
    try:
        yield
    finally:
        del sys.path[:2]


@pytest.mark.parametrize("remat", [False, True])
def test_benchmark_training_reference_equals_the_programs(remat):
    """The benchmark's float32 training forward (`kata_nbt_train`, built
    from `kata_nbt`'s pieces) against the package's reference: the same
    outputs, statistics and gradients, bit for bit."""
    with _bench_path():
        from reference import kata_nbt_train
    cfg = _cfg_dict(SMALL)
    W0 = dict(_random_net(SMALL, 6).state_dict())
    batch = _batch(SMALL, 4, 6)
    r_loss, r_grads, r_stats = _reference_step(W0, batch, cfg)
    W = {k: v.clone().requires_grad_(k in r_grads) for k, v in W0.items()}
    stats = {}
    log_pi, value = kata_nbt_train.forward(W, batch[0], cfg, remat=remat,
                                           stats=stats)
    loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2])
    grads = torch.autograd.grad(loss, [W[k] for k in r_grads])
    assert float(loss) == r_loss
    assert all(torch.equal(g, r_grads[k]) for k, g in zip(r_grads, grads))
    assert all(torch.equal(stats[k][i], r_stats[k][i])
               for k in r_stats for i in (0, 1))


def test_benchmark_sgd_steps_follow_the_programs_step():
    """`kata_nbt_train.sgd_steps` in fp32 against two program steps of
    an fp32 net: losses and parameters within the step's tolerances."""
    with _bench_path():
        from reference import kata_nbt_train
    cfg = dataclasses.replace(SMALL, remat=True)
    to = TrainOptions(batchsize=6, bf16=False)
    trainer = Trainer(cfg, to, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(8))
    state.net.load_state_dict(_random_net(SMALL, 8).state_dict())
    W0 = {k: v.clone() for k, v in state.net.state_dict().items()}
    batches = [_batch(SMALL, 6, 8 + i) for i in range(2)]
    step = trainer.make_train_step()
    losses = []
    for b in batches:
        state, stats = step(state, *b)
        losses.append(float(stats["loss/total"]))
    opts = {"lr": to.lr, "momentum": to.momentum,
            "weight_decay": to.weight_decay, "value_loss_weight": 1.0}
    r_losses, first, first_raw, W2 = kata_nbt_train.sgd_steps(
        W0, batches, _cfg_dict(cfg), opts)
    assert np.allclose(losses, r_losses, rtol=LOSS_TOL, atol=0)
    assert set(first) == set(first_raw) == set(W2) == {
        n for n, _ in state.net.named_parameters()}
    sd = state.net.state_dict()
    for k, w in W2.items():
        moved = float((w - W0[k]).norm())
        assert float((sd[k] - w).norm()) <= GRAD_TOL * max(moved, 1e-12), k


@pytest.mark.parametrize("cfg,normacts,gpools", [
    (SMALL, 17, 3),
    (dataclasses.replace(SMALL, remat=True), 17 + 13, 3 + 1),
    (nbt.NbtConfig(board_size=9, use_bf16=False, remat=True), 118 + 114,
     8 + 6)])
def test_counters_count_normacts_and_pools_per_step(cfg, normacts, gpools):
    """A step counts each norm-and-activation and each pooling of its
    training forward, and a remat block's recompute again (b18c384nbt:
    118 and 8 a forward, 114 and 6 recomputed: 232 and 14 a step)."""
    net = nbt.build_model(cfg, "cpu", seed=0)
    batch = _batch(cfg, 2, 0)
    step = Trainer(cfg, TrainOptions(), device="cpu").make_train_step()
    state = TrainState(net=net, opt_state=Trainer(cfg, TrainOptions(),
                                                  "cpu").tx.init(net),
                       step=0)
    profiling.reset()
    step(state, *batch)             # tracing off: nothing counted
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, *batch)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.train_normacts": normacts,
                 "net.train_gpools": gpools}


def test_learner_checkpoint_read_back_by_the_familys_reader(tmp_path):
    """The learner's checkpoint (`LearnerRunner.episode_summary`, as the
    training server writes it) restores the whole state, and the family's
    reader gives the net the clients play."""
    trainer = Trainer(SMALL, TrainOptions(num_cooldown=0), device="cpu")
    runner = LearnerRunner(trainer, None, str(tmp_path), trainer.opts,
                           seed=3)
    runner.state.net.load_state_dict(_random_net(SMALL, 3).state_dict())
    runner.state = trainer.make_train_step()(runner.state,
                                             *_batch(SMALL, 4, 3))[0]
    assert runner.episode_summary() == 1
    path = str(tmp_path / "save-1.bin")
    assert os.path.realpath(str(tmp_path / "latest")) == path
    net = get_model_family("kata_nbt").load_model(path, SMALL, "cpu")
    own = runner.state.net.state_dict()
    assert list(net.state_dict()) == list(own)
    assert all(torch.equal(v, own[k]) for k, v in net.state_dict().items())
    template = trainer.init_state(torch.Generator().manual_seed(0))
    back = load_checkpoint(path, template=template)
    assert back.step == 1
    for k, v in runner.state.opt_state["1"]["0"]["trace"].items():
        assert torch.equal(back.opt_state["1"]["0"]["trace"][k], v)
    assert all(torch.equal(v, own[k])
               for k, v in back.net.state_dict().items())


def test_clients_reader_plays_a_bf16_export(tmp_path):
    """The self-play client's reader (`net_reader`, through the registry)
    on a params-only bf16 export at b18c384nbt's widths."""
    from scripts.selfplay_client_torch import net_reader

    net = nbt.NestedBottleneckNet(nbt.NbtConfig())
    path = save_params_checkpoint(str(tmp_path / "save-5.bin"),
                                  TrainState(net=net, opt_state={}, step=5))
    g = GameOptions(model="kata_nbt", board_size=19)
    feature_set, eval_raw, read_net = net_reader(g, TrainOptions(), "cpu")
    assert feature_set == "agz"
    back = read_net(path)
    assert isinstance(back, nbt.NestedBottleneckNet)
    assert back.cfg == nbt.NbtConfig()
    own = net.state_dict()
    assert all(torch.equal(v, own[k].to(torch.bfloat16).float())
               for k, v in back.state_dict().items())
    x = _batch(nbt.NbtConfig(), 1, 0)[0]
    with torch.no_grad():
        lp, v = eval_raw(back, None, x)
    assert lp.shape == (1, 362) and v.shape == (1,)


def test_train_family_generator_on_a_tiny_cell():
    """The benchmark's `train_family` kind on a tiny nbt configuration on
    the CPU: the learner built through the registry, its checked steps
    followed by `kata_nbt_train`, correct by the cell's limits; a traced
    run reads the normacts a step."""
    with _bench_path():
        from harness import core
        cfg = dict(_cfg_dict(SMALL), name="small_nbt", reference="kata_nbt",
                   family="kata_nbt", komi=7.5, conv_dtype="float32",
                   bn_dtype="float32")
        cfg["gpool_blocks"] = list(cfg["gpool_blocks"])
        traffic = dict(core.load_json(core.BENCH / "traffic"
                                      / "train_family_b2048.json"),
                       batch=16, games=10, min_plies=12, max_plies=30,
                       policy_moves=6, checked_steps=2, trace_steps=2)
        limits = core.load_json(core.BENCH / "limits"
                                / "go19_b18c384nbt_learner."
                                "train_family_b2048.json")
        ctx = core.make_context("small.train_family", 2**33 + 3, 60.0, True,
                                time.perf_counter(),
                                device=torch.device("cpu"),
                                spec=core.load_spec(), config=cfg,
                                traffic=traffic, limits=limits)
        gen = core.generator(ctx)
        measured = gen.run(ctx)
        numbers = gen.check(ctx, measured)
        read = core.metric_reader("net.train_normacts_per_step.train_nbt")
        per_step = read(core.ReaderContext(ctx, measured))
    assert measured.units == 2 and measured.work["normact_bytes"] > 0
    assert numbers.pop("_failed") == 0
    assert numbers["batch_mismatches"] == 0
    correct, _ = core.judge(numbers, limits)
    assert correct
    assert per_step == 30.0
