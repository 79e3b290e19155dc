"""The port's PolicyValueNet with weights carried over from flax, against the
flax `apply_fn`; and the port's msgpack checkpoint reader against
`flax.serialization.msgpack_restore` on the committed checkpoints."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.models.resnet import apply_fn, init_params
from elf_tpu_torch.models import checkpoint
from elf_tpu_torch.models.resnet import ModelConfig, params_from_jax

pytestmark = pytest.mark.timeout(120)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BLOCKS, DIM = 9, 2, 32


def _perturbed_params(use_bf16: bool, seed: int = 0):
    """flax init params with every leaf (BN statistics included) moved off
    its trivial init, as numpy arrays."""
    cfg = JModelConfig(board_size=SIZE, num_block=BLOCKS, dim=DIM,
                       use_bf16=use_bf16)
    params, stats = init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    stats = jax.tree_util.tree_map_with_path(perturb, stats)
    return cfg, params, stats


def _features(K, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.random((K, SIZE, SIZE, 18)) < 0.3).astype(np.float32)
    x[..., 16] = rng.integers(0, 2, (K, 1, 1))
    x[..., 17] = 1.0 - x[..., 16]
    return x


def _both(use_bf16):
    jcfg, params, stats = _perturbed_params(use_bf16)
    x = _features(16)
    lp_j, v_j = apply_fn(jcfg)(params, stats, jnp.asarray(x))
    net = params_from_jax(
        params, stats,
        ModelConfig(board_size=SIZE, num_block=BLOCKS, dim=DIM,
                    use_bf16=use_bf16),
        device="cpu",
    )
    with torch.no_grad():
        lp_t, v_t = net(torch.from_numpy(x))
    assert lp_t.dtype == torch.float32 and lp_t.shape == (16, SIZE * SIZE + 1)
    assert v_t.dtype == torch.float32 and v_t.shape == (16,)
    return (np.asarray(lp_j), np.asarray(v_j)), (lp_t.numpy(), v_t.numpy())


def test_fp32_matches_flax():
    (lp_j, v_j), (lp_t, v_t) = _both(use_bf16=False)
    np.testing.assert_allclose(lp_t, lp_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(v_t, v_j, atol=1e-4, rtol=0)


def test_bf16_matches_flax():
    """bf16 convolutions: the two frameworks round at different places
    (flax rounds the conv output and then adds the bias in bf16; torch
    adds the bias before its one rounding; accumulation orders differ), so
    each activation may differ by a bf16 ulp (2^-8 relative).  The bound
    is 3e-2 abs on log_pi (|log_pi| ~ 4.4 here, ~2 ulps) and 1e-2 abs on
    the tanh value."""
    (lp_j, v_j), (lp_t, v_t) = _both(use_bf16=True)
    np.testing.assert_allclose(lp_t, lp_j, atol=3e-2, rtol=0)
    np.testing.assert_allclose(v_t, v_j, atol=1e-2, rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("path", ["runs/prod13/promoted-160.bin",
                                  "runs/prove19/export-best.bin"])
def test_checkpoint_reader_matches_flax(path):
    with open(os.path.join(ROOT, path), "rb") as f:
        data = f.read()
    ref = dict(_leaves(flax.serialization.msgpack_restore(data)))
    ours = dict(_leaves(checkpoint.msgpack_restore(data)))
    assert ref.keys() == ours.keys()
    for k, r in ref.items():
        o = ours[k]
        if not isinstance(r, np.ndarray):
            assert r == o, k
            continue
        assert tuple(o.shape) == r.shape, k
        if r.dtype.name == "bfloat16":
            assert o.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                o.view(torch.int16).numpy().view(np.uint16), r.view(np.uint16),
                err_msg=k)
        else:
            np.testing.assert_array_equal(o.numpy(), r, err_msg=k)


def test_committed_19x19_net_loads_and_matches_flax():
    """The production 20b256c export through the port's reader and
    params_from_jax, at fp32, against flax on the same weights."""
    params, stats, step = checkpoint.load_checkpoint(
        os.path.join(ROOT, "runs/prove19/export-best.bin"))
    assert step == 648
    net = params_from_jax(params, stats, ModelConfig(use_bf16=False),
                          device="cpu")
    rng = np.random.default_rng(2)
    x = (rng.random((2, 19, 19, 18)) < 0.2).astype(np.float32)
    x[..., 16], x[..., 17] = 1.0, 0.0
    fparams = flax.serialization.msgpack_restore(open(os.path.join(
        ROOT, "runs/prove19/export-best.bin"), "rb").read())
    # the JAX trainer restores exports onto its fp32 template
    # (trainer.load_checkpoint); do the same here
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    lp_j, v_j = apply_fn(JModelConfig(use_bf16=False))(
        f32(fparams["params"]), f32(fparams["batch_stats"]), jnp.asarray(x))
    with torch.no_grad():
        lp_t, v_t = net(torch.from_numpy(x))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)


def _replay_positions_13(games=8, plies=120, every=8, seed=13):
    """AGZ planes of 13x13 positions from games of seeded random legal
    moves, replayed through the port's GoState on the CPU."""
    from elf_tpu_torch.env.go import features
    from elf_tpu_torch.env.go import state as gostate

    size = 13
    rng = np.random.default_rng(seed)
    st = gostate.init_state(games, size, "cpu")
    codes = torch.zeros(games, dtype=torch.int32)
    xs = []
    for ply in range(plies):
        if ply % every == every - 1:
            xs.append(features.extract_agz(st, codes, size))
        legal = gostate.legal_moves(st, size).numpy().astype(np.float64)
        legal[:, -1] = 1e-3                    # rarely pass
        a = [rng.choice(legal.shape[1], p=row / row.sum()) for row in legal]
        st, info = gostate.step(st, torch.tensor(a, dtype=torch.int32), size)
        assert not bool(info.illegal.any())
    return torch.cat(xs).numpy()


@pytest.mark.parametrize("name", ["init", "promoted-160"])
def test_committed_13x13_nets_match_flax(name):
    """The JAX 13x13 production run's frozen init and promoted ver 160
    (10 blocks x 128 channels) through the port's `load_model` (the
    reader and `params_from_jax`), at fp32, against flax on the same
    weights, on positions of a 13x13 replay.  Tolerance: 3e-5 absolute on
    log_pi (|log_pi| reaches 8 here, where a float32 ulp is 9.5e-7, and
    the two frameworks sum 21 convolutions in different orders; 1.1e-5
    was the largest difference seen) and 1e-5 on the tanh value."""
    from elf_tpu_torch.models.resnet import load_model

    path = os.path.join(ROOT, "runs", "prod13", f"{name}.bin")
    net = load_model(path, ModelConfig(board_size=13, num_block=10, dim=128,
                                       use_bf16=False), device="cpu")
    x = _replay_positions_13()
    assert x.shape == (120, 13, 13, 18)
    fparams = flax.serialization.msgpack_restore(open(path, "rb").read())
    lp_j, v_j = apply_fn(JModelConfig(board_size=13, num_block=10, dim=128,
                                      use_bf16=False))(
        fparams["params"], fparams["batch_stats"], jnp.asarray(x))
    with torch.no_grad():
        lp_t, v_t = net(torch.from_numpy(x))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=3e-5,
                               rtol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5,
                               rtol=0)
