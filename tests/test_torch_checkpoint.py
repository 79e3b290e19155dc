"""Checkpoints cross between the packages: a file either trainer writes
loads in the other, whole TrainState (`save-<step>.bin`) and params-only
export alike, and training goes on from it the same way (next step within
1e-5).  The port's msgpack encoder gives the bytes flax's gives."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.training import trainer as jtrainer
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models import checkpoint
from elf_tpu_torch.models.resnet import ModelConfig, load_model, params_to_jax
from elf_tpu_torch.training import trainer as ttrainer

pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(__file__))
SIZE, A, BATCH = 9, 82, 8
NET = dict(board_size=SIZE, num_block=2, dim=16, use_bf16=False)
OPTIMIZERS = {
    "sgd": dict(lr=0.05, weight_decay=1e-2),
    "sgd_clip": dict(lr=0.05, weight_decay=1e-2, grad_clip_norm=0.5),
    "sgd_plain": dict(lr=0.05, weight_decay=0.0),
    "adam": dict(opt_method="adam", lr=0.01, weight_decay=1e-2),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.random((BATCH, SIZE, SIZE, 18)) < 0.3).astype(np.float32)
    pi = rng.dirichlet(np.full(A, 0.3), size=BATCH).astype(np.float32)
    winner = rng.choice([-1.0, 1.0], size=BATCH).astype(np.float32)
    return feats, pi, winner


def _jstep(jtr, jstate, seed):
    return jax.jit(jtr.make_train_step())(
        jstate, *(jnp.asarray(a) for a in _batch(seed)))


def _tstep(ttr, tstate, seed):
    return ttr.make_train_step()(
        tstate, *(torch.from_numpy(a) for a in _batch(seed)))


def _trainers(opts):
    jtr = jtrainer.Trainer(JModelConfig(**NET),
                           JTrainOptions(batchsize=BATCH, **opts))
    ttr = ttrainer.Trainer(ModelConfig(**NET),
                           TrainOptions(batchsize=BATCH, **opts), device="cpu")
    return jtr, ttr


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_payloads_equal(ours, ref, atol=0.0):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    for k, r in ref.items():
        a, b = _np(ours[k]), _np(r)
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)


def _assert_state_equals_jax(tstate, jstate, atol=0.0):
    params, stats = params_to_jax(tstate.net)
    _assert_payloads_equal(params, jax.device_get(jstate.params), atol)
    _assert_payloads_equal(stats, jax.device_get(jstate.batch_stats), atol)
    _assert_payloads_equal(
        checkpoint._opt_tree(tstate.net.cfg, tstate.opt_state),
        flax.serialization.to_state_dict(jax.device_get(jstate.opt_state)),
        atol)
    assert tstate.step == int(jstate.step)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_port_checkpoint_loads_in_jax_and_training_goes_on(name, tmp_path):
    jtr, ttr = _trainers(OPTIMIZERS[name])
    tstate = ttr.init_state(torch.Generator().manual_seed(3))
    for i in range(2):
        tstate, _ = _tstep(ttr, tstate, i)
    path = ttrainer.save_checkpoint(str(tmp_path), tstate)
    assert os.path.basename(path) == "save-2.bin"
    assert ttrainer.version_from_path(path) == jtrainer.version_from_path(path) == 2

    # the file is what flax would have written for the same tree
    with open(path, "rb") as f:
        data = f.read()
    payload = flax.serialization.msgpack_restore(data)
    assert flax.serialization.msgpack_serialize(payload) == data

    jstate = jtrainer.load_checkpoint(
        str(tmp_path), template=jtr.init_state(jax.random.PRNGKey(0)))
    _assert_state_equals_jax(tstate, jstate)
    jstate, jstats = _jstep(jtr, jstate, 7)
    tstate, tstats = _tstep(ttr, tstate, 7)
    for k in jstats:
        ref = float(jstats[k])
        assert abs(float(tstats[k]) - ref) < 1e-5 * max(1.0, abs(ref)), k
    _assert_state_equals_jax(tstate, jstate, atol=1e-5)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_jax_checkpoint_loads_in_port_and_training_goes_on(name, tmp_path):
    jtr, ttr = _trainers(OPTIMIZERS[name])
    jstate = jtr.init_state(jax.random.PRNGKey(4))
    for i in range(2):
        jstate, _ = _jstep(jtr, jstate, i)
    jtrainer.save_checkpoint(str(tmp_path), jstate)
    template = ttr.init_state(torch.Generator().manual_seed(0))
    before = {n: p.clone() for n, p in template.net.named_parameters()}
    tstate = ttrainer.load_checkpoint(str(tmp_path), template)
    _assert_state_equals_jax(tstate, jstate)
    # the template is left as it was
    assert template.step == 0
    assert all(torch.equal(p, before[n])
               for n, p in template.net.named_parameters())
    jstate, jstats = _jstep(jtr, jstate, 8)
    tstate, tstats = _tstep(ttr, tstate, 8)
    for k in jstats:
        ref = float(jstats[k])
        assert abs(float(tstats[k]) - ref) < 1e-5 * max(1.0, abs(ref)), k
    _assert_state_equals_jax(tstate, jstate, atol=1e-5)


def test_params_exports_cross_both_ways(tmp_path):
    jtr, ttr = _trainers(OPTIMIZERS["sgd"])
    tstate = ttr.init_state(torch.Generator().manual_seed(5))
    tstate, _ = _tstep(ttr, tstate, 0)
    tpath = ttrainer.save_params_checkpoint(str(tmp_path / "t.bin"), tstate)
    with open(tpath, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    assert set(raw) == {"params", "batch_stats", "step"}
    assert all(v.dtype.name == "bfloat16" for _, v in _leaves(raw["params"]))

    jtemplate = jtr.init_state(jax.random.PRNGKey(0))
    jstate = jtrainer.load_checkpoint(tpath, template=jtemplate)
    assert int(jstate.step) == 1
    params, stats = params_to_jax(tstate.net)
    bf16 = lambda t: {k: bf16(v) if isinstance(v, dict) else
                      torch.from_numpy(v).bfloat16().float().numpy()
                      for k, v in t.items()}
    _assert_payloads_equal(bf16(params), jax.device_get(jstate.params))
    _assert_payloads_equal(bf16(stats), jax.device_get(jstate.batch_stats))
    assert all(a.dtype == jnp.float32
               for a in jax.tree.leaves(jstate.params))
    # a fresh optimizer: the template's zero trace
    assert not any(np.asarray(a).any()
                   for a in jax.tree.leaves(jstate.opt_state))

    jstate2 = jtr.init_state(jax.random.PRNGKey(6))
    jstate2, _ = _jstep(jtr, jstate2, 1)
    jpath = jtrainer.save_params_checkpoint(str(tmp_path / "j.bin"), jstate2)
    template = ttr.init_state(torch.Generator().manual_seed(0))
    template, _ = _tstep(ttr, template, 2)      # a non-zero optimizer trace
    tstate2 = ttrainer.load_checkpoint(jpath, template)
    assert tstate2.step == 1
    params, stats = params_to_jax(tstate2.net)
    jbf16 = lambda t: jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)), jax.device_get(t))
    _assert_payloads_equal(params, jbf16(jstate2.params))
    _assert_payloads_equal(stats, jbf16(jstate2.batch_stats))
    assert all(p.dtype == torch.float32 for p in tstate2.net.parameters())
    # a params-only file keeps the template's optimizer state
    for n, t in tstate2.opt_state["1"]["0"]["trace"].items():
        assert torch.equal(t, template.opt_state["1"]["0"]["trace"][n]), n

    # without a template: the trees as the file holds them
    p, s, step = checkpoint.load_checkpoint(jpath)
    assert step == 1 and p["init_conv"]["kernel"].dtype == torch.bfloat16


def test_committed_export_restores_at_fp32_and_shapes_are_checked():
    path = os.path.join(ROOT, "runs/prove19/export-best.bin")
    ttr = ttrainer.Trainer(ModelConfig(use_bf16=True),
                           TrainOptions(batchsize=4), device="cpu")
    template = ttr.init_state(torch.Generator().manual_seed(0))
    state = ttrainer.load_checkpoint(path, template)
    assert state.step == 648
    assert all(p.dtype == torch.float32 for p in state.net.parameters())
    ref = load_model(path, ModelConfig(use_bf16=True), device="cpu")
    for (n, p), (_, q) in zip(state.net.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(p, q), n
    raw = checkpoint.read_checkpoint(path)
    k = raw["params"]["block7"]["conv2"]["kernel"]
    assert k.dtype == torch.bfloat16
    assert torch.equal(state.net.blocks[7].conv2.weight,
                       k.float().permute(3, 2, 0, 1))
    trace = state.opt_state["1"]["0"]["trace"]
    assert not any(t.any() for t in trace.values())

    small = ttrainer.Trainer(ModelConfig(num_block=20, dim=128),
                             TrainOptions(), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ttrainer.load_checkpoint(
            path, small.init_state(torch.Generator().manual_seed(0)))


def test_latest_symlink_and_keep_last_k(tmp_path):
    jtr, ttr = _trainers(OPTIMIZERS["sgd_plain"])
    tstate = ttr.init_state(torch.Generator().manual_seed(1))
    jstate = jtr.init_state(jax.random.PRNGKey(1))
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    for step in (1, 2, 3, 4):
        tstate.step = step
        jstate = jstate._replace(step=jnp.asarray(step, jnp.int32))
        tpath = ttrainer.save_checkpoint(tdir, tstate, keep=2)
        jpath = jtrainer.save_checkpoint(jdir, jstate, keep=2)
        assert os.path.basename(tpath) == os.path.basename(jpath)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        assert os.readlink(os.path.join(tdir, "latest")) == f"save-{step}.bin"
    assert sorted(os.listdir(tdir)) == ["latest", "save-3.bin", "save-4.bin"]
    # a directory stands for its latest link, in both packages
    assert ttrainer.load_checkpoint(tdir, tstate).step == 4
    assert int(jtrainer.load_checkpoint(
        tdir, template=jtr.init_state(jax.random.PRNGKey(0))).step) == 4


def test_msgpack_writer_gives_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {
        "a": {"kernel": rng.normal(size=(3, 3, 2, 70)).astype(np.float32),
              "count": np.asarray(7, np.int32),
              "empty": {}},
        "bf16": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
        .bfloat16(),
        "small": np.zeros((1,), np.int8),       # a 1-byte-shape fixext-free case
        "step": 123456, "neg": -5, "big": 2 ** 40, "f": 0.5, "flag": True,
        "none": None, "name": "x" * 40,
        "wide": {str(i): i for i in range(20)},
    }
    ours = checkpoint.msgpack_serialize(tree)
    as_flax = dict(tree, bf16=np.asarray(
        jnp.asarray(tree["bf16"].float().numpy()).astype(jnp.bfloat16)))
    assert ours == flax.serialization.msgpack_serialize(as_flax)
    back = checkpoint.msgpack_restore(ours)
    assert back["step"] == 123456 and back["neg"] == -5 and back["big"] == 2 ** 40
    assert torch.equal(back["bf16"], tree["bf16"])
    np.testing.assert_array_equal(back["a"]["kernel"].numpy(),
                                  tree["a"]["kernel"])
    assert back["a"]["empty"] == {} and back["wide"]["19"] == 19
