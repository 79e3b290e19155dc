"""Block remat (`ModelConfig(remat=True)`) in the port's train step.

A remat step recomputes each residual block in the backward pass and must
give the plain step's result: from one state (2 blocks, 16 channels,
seeded numpy batches), parameters and both optimizer slots within 1e-6,
and the BatchNorm running statistics bit for bit equal after one step and
after three.  The plain step writes each statistic once per step, so
equality also shows that the recomputed blocks write none.  Against the
JAX trainer with `ModelConfig(remat=True)` (flax `nn.remat`): every
parameter, statistic and slot within 1e-5 after three steps, as
tests/test_torch_train.py holds the plain step."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.training.trainer import Trainer as JTrainer
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models.resnet import ModelConfig, load_flax_trees
from elf_tpu_torch.training.trainer import Trainer
from tests.test_torch_train import BATCH, NET, _assert_states_close, _batch

pytestmark = pytest.mark.timeout(300)

OPTS = {
    "sgd": dict(lr=0.05, weight_decay=1e-2),
    "adam_clip": dict(opt_method="adam", lr=0.01, weight_decay=1e-2,
                      grad_clip_norm=0.5),
}


def _slots(state):
    """Every optimizer slot tensor by path."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            elif torch.is_tensor(v):
                out[f"{prefix}/{k}"] = v

    walk(state.opt_state, "")
    return out


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("bn_momentum", [0.0, 0.3])
@pytest.mark.parametrize("opt", list(OPTS))
def test_remat_step_equals_plain_step(opt, bn_momentum, use_bf16):
    cfg = ModelConfig(**NET, use_bf16=use_bf16, bn_momentum=bn_momentum)
    opts = TrainOptions(batchsize=BATCH, **OPTS[opt])
    plain_tr = Trainer(cfg, opts, device="cpu")
    remat_tr = Trainer(dataclasses.replace(cfg, remat=True), opts,
                       device="cpu")
    plain = plain_tr.init_state(torch.Generator().manual_seed(4))
    remat = copy.deepcopy(plain)
    remat.net.cfg = remat_tr.cfg
    start = {k: v.clone() for k, v in plain.net.named_buffers()}
    plain_step, remat_step = plain_tr.make_train_step(), remat_tr.make_train_step()
    for i in range(3):
        feats, pi, winner = (torch.from_numpy(a) for a in _batch(70 + i))
        _, ps = plain_step(plain, feats, pi, winner)
        _, rs = remat_step(remat, feats, pi, winner)
        for k in ps:
            assert abs(float(ps[k]) - float(rs[k])) <= 1e-6 * max(
                1.0, abs(float(ps[k]))), (i, k)
        for (n, a), (_, b) in zip(plain.net.named_buffers(),
                                  remat.net.named_buffers()):
            assert torch.equal(a, b), (i, n)
        for (n, a), (_, b) in zip(plain.net.named_parameters(),
                                  remat.net.named_parameters()):
            assert float((a - b).detach().abs().max()) <= 1e-6, (i, n)
        rslots = _slots(remat)
        for k, a in _slots(plain).items():
            assert float((a.float() - rslots[k].float()).abs().max()) <= 1e-6, \
                (i, k)
        assert plain.step == remat.step == i + 1
    # the statistics moved: the steps wrote them
    assert not all(torch.equal(v, dict(remat.net.named_buffers())[k])
                   for k, v in start.items())


def test_remat_step_matches_jax_remat():
    jtr = JTrainer(JModelConfig(**NET, use_bf16=False, remat=True),
                   JTrainOptions(batchsize=BATCH, **OPTS["sgd"]))
    jstate = jtr.init_state(jax.random.PRNGKey(11))
    ttr = Trainer(ModelConfig(**NET, use_bf16=False, remat=True),
                  TrainOptions(batchsize=BATCH, **OPTS["sgd"]), device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    load_flax_trees(tstate.net, jax.device_get(jstate.params),
                    jax.device_get(jstate.batch_stats))
    jstep = jax.jit(jtr.make_train_step())
    tstep = ttr.make_train_step()
    for i in range(3):
        feats, pi, winner = _batch(80 + i)
        jstate, jstats = jstep(jstate, jnp.asarray(feats), jnp.asarray(pi),
                               jnp.asarray(winner))
        tstate, tstats = tstep(tstate, torch.from_numpy(feats),
                               torch.from_numpy(pi), torch.from_numpy(winner))
        for k in jstats:
            ref = float(jstats[k])
            assert abs(float(tstats[k]) - ref) < 1e-5 * max(1.0, abs(ref)), \
                (i, k)
    _assert_states_close(tstate, jstate, 1e-5)


def test_remat_keeps_inference_and_cooldown():
    """Inference never recomputes, and the cooldown's training-mode forward
    writes the statistics once, as without remat."""
    cfg = ModelConfig(**NET, use_bf16=False)
    tr = Trainer(cfg, TrainOptions(batchsize=BATCH), device="cpu")
    plain = tr.init_state(torch.Generator().manual_seed(6))
    remat = copy.deepcopy(plain)
    remat.net.cfg = dataclasses.replace(cfg, remat=True)
    feats = torch.from_numpy(_batch(90)[0])
    with torch.no_grad():
        for a, b in zip(plain.net(feats), remat.net(feats)):
            assert torch.equal(a, b)
    cool = tr.make_cooldown_step()
    cool(plain, feats)
    cool(remat, feats)
    for (n, a), (_, b) in zip(plain.net.named_buffers(),
                              remat.net.named_buffers()):
        assert torch.equal(a, b), n
