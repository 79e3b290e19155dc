"""The port's learner against the JAX one on the CPU: losses, BatchNorm in
training mode, the optimizer, whole train steps and the cooldown step.

Inputs are made with numpy from a seed and go through both packages.  The
nets start from the same flax-initialised parameters, carried over by
`params_from_jax`.  Tolerances: losses and BatchNorm 1e-6; fp32 train
steps 1e-5 on every parameter, BN statistic and optimizer slot after
three steps and on every stat (relative to the stat where it exceeds 1:
`grad_norm` is about 8 here); bf16 compute `loss/total` within 3e-2 and the cosine of the
full gradient above 0.99."""

import copy

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.training import loss as jloss
from elf_tpu.training.trainer import Trainer as JTrainer
from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.models.checkpoint import _opt_tree
from elf_tpu_torch.models.resnet import (
    BatchNorm,
    ModelConfig,
    PolicyValueNet,
    build_model,
    eval_fn_builder,
    load_flax_trees,
    params_to_jax,
    serving_copy,
)
from elf_tpu_torch.training import loss as tloss
from elf_tpu_torch.training.trainer import TrainState, Trainer, version_from_path

pytestmark = pytest.mark.timeout(300)

SIZE, A, BATCH = 9, 82, 8
NET = dict(board_size=SIZE, num_block=2, dim=16)


def _batch(seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    feats = (rng.random((batch, SIZE, SIZE, 18)) < 0.3).astype(np.float32)
    pi = rng.dirichlet(np.full(A, 0.3), size=batch).astype(np.float32)
    winner = rng.choice([-1.0, 1.0], size=batch).astype(np.float32)
    return feats, pi, winner


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_close(ours, ref, atol, what):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys(), what
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, atol=atol, rtol=0,
                                   err_msg=f"{what}{k}")


def _pair(use_bf16=False, bn_momentum=0.0, **opts):
    """(JAX trainer, its state, port trainer, its state) from the same
    flax-initialised parameters."""
    opts = dict(batchsize=BATCH, **opts)
    jtr = JTrainer(JModelConfig(**NET, use_bf16=use_bf16,
                                bn_momentum=bn_momentum),
                   JTrainOptions(**opts))
    jstate = jtr.init_state(jax.random.PRNGKey(11))
    ttr = Trainer(ModelConfig(**NET, use_bf16=use_bf16,
                              bn_momentum=bn_momentum),
                  TrainOptions(**opts), device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_flax_trees(tstate.net, jax.device_get(jstate.params),
                    jax.device_get(jstate.batch_stats))
    return jtr, jstate, ttr, tstate


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_states_close(tstate, jstate, atol):
    params, stats = params_to_jax(tstate.net)
    _assert_trees_close(params, jax.device_get(jstate.params), atol, "params")
    _assert_trees_close(stats, jax.device_get(jstate.batch_stats), atol,
                        "batch_stats")
    _assert_trees_close(
        _np_tree(_opt_tree(tstate.net.cfg, tstate.opt_state)),
        flax.serialization.to_state_dict(jax.device_get(jstate.opt_state)),
        atol, "opt_state")
    assert tstate.step == int(jstate.step)


# ---------------------------------------------------------------- losses

def test_mcts_prediction_loss_matches_jax():
    rng = np.random.default_rng(0)
    log_pi = np.log(rng.dirichlet(np.full(A, 0.5), size=16)).astype(np.float32)
    value = np.tanh(rng.normal(size=16)).astype(np.float32)
    _, pi, winner = _batch(1, 16)
    for w in (1.0, 0.25):
        jt, js = jloss.mcts_prediction_loss(
            jnp.asarray(log_pi), jnp.asarray(value), jnp.asarray(pi),
            jnp.asarray(winner), value_weight=w)
        tt, ts = tloss.mcts_prediction_loss(
            torch.from_numpy(log_pi), torch.from_numpy(value),
            torch.from_numpy(pi), torch.from_numpy(winner), value_weight=w)
        assert ts.keys() == js.keys()
        assert abs(float(tt) - float(jt)) < 1e-6
        for k in js:
            assert abs(float(ts[k]) - float(js[k])) < 1e-6, k


def test_multiple_prediction_loss_matches_jax():
    rng = np.random.default_rng(2)
    log_pi = np.log(rng.dirichlet(np.full(A, 0.5), size=16)).astype(np.float32)
    value = np.tanh(rng.normal(size=16)).astype(np.float32)
    offline_a = rng.integers(0, A, size=(16, 3)).astype(np.int32)
    # make some first-horizon targets the argmax / a top-5 entry
    offline_a[:4, 0] = log_pi[:4].argmax(1)
    offline_a[4:8, 0] = np.argsort(-log_pi[4:8], axis=1)[:, 3]
    winner = rng.choice([-1.0, 1.0], size=16).astype(np.float32)
    jt, js = jloss.multiple_prediction_loss(
        jnp.asarray(log_pi), jnp.asarray(value), jnp.asarray(offline_a),
        jnp.asarray(winner))
    tt, ts = tloss.multiple_prediction_loss(
        torch.from_numpy(log_pi), torch.from_numpy(value),
        torch.from_numpy(offline_a), torch.from_numpy(winner))
    assert ts.keys() == js.keys()
    assert abs(float(tt) - float(jt)) < 1e-6
    for k in js:
        assert abs(float(ts[k]) - float(js[k])) < 1e-6, k
    assert 0.25 <= float(ts["acc/top1"]) < float(ts["acc/top5"])


# ------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("momentum", [0.1, 0.3])
def test_batchnorm_training_mode_matches_flax(momentum):
    """B = 2, 5x5: 50 values per channel, where the biased variance (flax's
    running statistic) and the unbiased one (torch's) differ by 2 %."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, size=(2, 5, 5, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.normal(size=4).astype(np.float32)
    mean0 = rng.normal(size=4).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 4).astype(np.float32)

    fbn = fnn.BatchNorm(use_running_average=False, momentum=1.0 - momentum,
                        dtype=jnp.float32)
    y_j, mut = fbn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm(4, momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        y_t = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_j), atol=1e-6, rtol=0)
    new = mut["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]),
                               atol=1e-6, rtol=0)
    # the unbiased variance would miss by far more than the tolerance
    flat = x.reshape(-1, 4)
    unbiased = (1 - momentum) * var0 + momentum * flat.var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(new["var"])).max() > 1e-3
    # inference mode leaves the statistics alone and uses them
    before = bn.running_var.clone()
    with torch.no_grad():
        y_eval = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(before, bn.running_var)
    assert not torch.allclose(y_eval, y_t)


def test_bn_momentum_zero_means_point_one():
    assert ModelConfig(bn_momentum=0.0).torch_bn_momentum == 0.1
    assert ModelConfig(bn_momentum=0.25).torch_bn_momentum == 0.25
    for m in (0.0, 0.25):
        assert (1.0 - JModelConfig(bn_momentum=m).flax_bn_momentum
                == pytest.approx(ModelConfig(bn_momentum=m).torch_bn_momentum))
    net = PolicyValueNet(ModelConfig(**NET, bn_momentum=0.0))
    assert net.init_bn.momentum == 0.1 and net.blocks[1].bn2.momentum == 0.1


# ------------------------------------------------------------ train steps

OPTIMIZERS = {
    "sgd_wd": dict(lr=0.05, weight_decay=1e-2),
    "sgd_clip": dict(lr=0.05, weight_decay=1e-2, grad_clip_norm=0.5),
    "adam": dict(opt_method="adam", lr=0.01, weight_decay=1e-2),
    "adam_clip_no_wd": dict(opt_method="adam", lr=0.01, weight_decay=0.0,
                            grad_clip_norm=0.5),
    "sgd_bn_momentum": dict(lr=0.05),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_train_steps_match_jax(name):
    bn_m = 0.3 if name == "sgd_bn_momentum" else 0.0
    jtr, jstate, ttr, tstate = _pair(bn_momentum=bn_m, **OPTIMIZERS[name])
    jstep = jax.jit(jtr.make_train_step())
    tstep = ttr.make_train_step()
    for i in range(3):
        feats, pi, winner = _batch(20 + i)
        jstate, jstats = jstep(jstate, jnp.asarray(feats), jnp.asarray(pi),
                               jnp.asarray(winner))
        tstate, tstats = tstep(tstate, torch.from_numpy(feats),
                               torch.from_numpy(pi), torch.from_numpy(winner))
        assert tstats.keys() == jstats.keys()
        for k in jstats:
            ref = float(jstats[k])
            assert abs(float(tstats[k]) - ref) < 1e-5 * max(1.0, abs(ref)), (i, k)
        if "clip" in name:
            assert float(tstats["grad_norm"]) > 0.5     # the clip is active
        if i == 0:
            _assert_states_close(tstate, jstate, 1e-5)
    _assert_states_close(tstate, jstate, 1e-5)


def test_bf16_train_step_close_to_jax():
    jtr, jstate, ttr, tstate = _pair(use_bf16=True, lr=0.05)
    feats, pi, winner = _batch(30)

    def jloss_fn(params):
        (log_pi, value), _ = jtr.model.apply(
            {"params": params, "batch_stats": jstate.batch_stats},
            jnp.asarray(feats), train=True, mutable=["batch_stats"])
        return jloss.mcts_prediction_loss(
            log_pi, value, jnp.asarray(pi), jnp.asarray(winner))[0]

    jl, jgrads = jax.value_and_grad(jloss_fn)(jstate.params)
    net = copy.deepcopy(tstate.net)
    log_pi, value = net(torch.from_numpy(feats), train=True)
    tl, _ = tloss.mcts_prediction_loss(log_pi, value, torch.from_numpy(pi),
                                       torch.from_numpy(winner))
    tl.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in net.parameters())
    assert abs(float(tl.detach()) - float(jl)) < 3e-2
    from elf_tpu_torch.models.resnet import tensors_to_flax

    tg = dict(_leaves(_np_tree(tensors_to_flax(
        net.cfg, {n: p.grad for n, p in net.named_parameters()}))))
    jg = dict(_leaves(jax.device_get(jgrads)))
    assert tg.keys() == jg.keys()
    a = np.concatenate([tg[k].ravel() for k in sorted(jg)])
    b = np.concatenate([jg[k].ravel() for k in sorted(jg)])
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.99, cos

    # and the whole step through the trainer
    jstate2, jstats = jax.jit(jtr.make_train_step())(
        jstate, jnp.asarray(feats), jnp.asarray(pi), jnp.asarray(winner))
    tstate, tstats = ttr.make_train_step()(
        tstate, torch.from_numpy(feats), torch.from_numpy(pi),
        torch.from_numpy(winner))
    assert abs(float(tstats["loss/total"]) - float(jstats["loss/total"])) < 3e-2


def test_cooldown_step_matches_jax_and_changes_no_parameter():
    jtr, jstate, ttr, tstate = _pair(lr=0.05)
    before = {n: p.clone() for n, p in tstate.net.named_parameters()}
    stats_before = params_to_jax(tstate.net)[1]
    jcool = jax.jit(jtr.make_cooldown_step())
    tcool = ttr.make_cooldown_step()
    for i in range(2):
        feats, _, _ = _batch(40 + i)
        jstate = jcool(jstate, jnp.asarray(feats))
        tstate = tcool(tstate, torch.from_numpy(feats))
    for n, p in tstate.net.named_parameters():
        assert torch.equal(p, before[n]), n
    assert tstate.step == 0
    stats = params_to_jax(tstate.net)[1]
    _assert_trees_close(stats, jax.device_get(jstate.batch_stats), 1e-6,
                        "batch_stats")
    moved = max(np.abs(a - b).max() for (_, a), (_, b) in
                zip(_leaves(stats), _leaves(stats_before)))
    assert moved > 1e-3


def test_inference_follows_the_master_weights():
    """A bf16 net casts its fp32 masters per call, so inference sees a train
    step and a load at once; an evaluator built by `eval_fn_builder` serves
    a frozen bf16 copy with the same outputs and keeps the weights it was
    built from."""
    _, _, ttr, tstate = _pair(use_bf16=True, lr=0.1)
    feats, pi, winner = _batch(50)
    x = torch.from_numpy(feats)

    def infer(net):
        with torch.inference_mode():
            return net(x)[0].clone()

    first = infer(tstate.net)
    assert torch.equal(first, infer(tstate.net))
    served = eval_fn_builder(tstate.net)
    frozen = serving_copy(tstate.net)
    assert frozen.init_conv.weight.dtype == torch.bfloat16
    assert frozen.pi_fc.weight.dtype == torch.float32
    assert tstate.net.init_conv.weight.dtype == torch.float32
    assert torch.equal(first, infer(frozen))
    ttr.make_train_step()(tstate, x, torch.from_numpy(pi),
                          torch.from_numpy(winner))
    after = infer(tstate.net)
    assert not torch.allclose(first, after)
    with torch.inference_mode():
        assert torch.equal(first, served(x, None)[0])
        assert torch.equal(after, eval_fn_builder(tstate.net)(x, None)[0])
    other = build_model(ModelConfig(**NET, use_bf16=True), device="cpu", seed=5)
    load_flax_trees(tstate.net, *params_to_jax(other))
    assert torch.equal(infer(tstate.net), infer(other))


def test_eval_fn_make_eval_fn_and_eval_mode():
    _, jstate, ttr, tstate = _pair()
    feats, _, _ = _batch(60)
    jtr = JTrainer(JModelConfig(**NET, use_bf16=False), JTrainOptions())
    lp_j, v_j = jtr.make_eval_fn()(jstate.params, jstate.batch_stats,
                                   jnp.asarray(feats))
    with torch.no_grad():
        lp_t, v_t = ttr.make_eval_fn()(tstate.net, None,
                                       torch.from_numpy(feats))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)


def test_init_state_follows_flax_defaults_in_distribution():
    ttr = Trainer(ModelConfig(board_size=9, num_block=2, dim=64,
                              use_bf16=False), TrainOptions(), device="cpu")
    a = ttr.init_state(torch.Generator().manual_seed(1))
    b = ttr.init_state(torch.Generator().manual_seed(1))
    c = ttr.init_state(torch.Generator().manual_seed(2))
    assert isinstance(a, TrainState) and a.step == 0
    for (n, p), (_, q), (_, r) in zip(a.net.named_parameters(),
                                      b.net.named_parameters(),
                                      c.net.named_parameters()):
        assert torch.equal(p, q), n
        if p.ndim > 1:
            fan_in = int(np.prod(p.shape[1:]))
            assert not torch.equal(p, r), n
            # lecun_normal: variance 1 / fan_in, truncated at 2 sigma of
            # the untruncated normal (2 / 0.8796 of the result's sigma)
            if p.numel() >= 4096:
                assert abs(float(p.detach().var()) * fan_in - 1.0) < 0.1, n
            assert float(p.detach().abs().max()) <= 2.0 / 0.87962566 / np.sqrt(fan_in) + 1e-6
        elif n.endswith("bias"):
            assert not p.any(), n
        else:
            assert torch.equal(p, torch.ones_like(p)), n
    for n, buf in a.net.named_buffers():
        want = 1.0 if n.endswith("running_var") else 0.0
        assert torch.equal(buf, torch.full_like(buf, want)), n
    trace = a.opt_state["1"]["0"]["trace"]
    assert set(trace) == {n for n, _ in a.net.named_parameters()}
    assert not any(t.any() for t in trace.values())


def test_option_groups_match_jax_defaults():
    import dataclasses

    from elf_tpu.config import ReplayOptions as JReplayOptions

    assert dataclasses.asdict(TrainOptions()) == dataclasses.asdict(JTrainOptions())
    assert dataclasses.asdict(ReplayOptions()) == dataclasses.asdict(JReplayOptions())


def test_remat_and_version_from_path(tmp_path):
    """A remat net builds and infers as the plain net does
    (tests/test_torch_remat.py holds its train step)."""
    remat = PolicyValueNet(ModelConfig(**NET, remat=True))
    plain = PolicyValueNet(ModelConfig(**NET))
    plain.load_state_dict(remat.state_dict())
    x = torch.from_numpy(_batch(95)[0])
    with torch.no_grad():
        for a, b in zip(remat(x), plain(x)):
            assert torch.equal(a, b)
    assert version_from_path(str(tmp_path / "save-120.bin")) == 120
    assert version_from_path(str(tmp_path / "init.bin")) == -1
