"""The port's Go engine against the JAX engine: `step_core` over random legal
games (every GoCore and StepInfo field, hashes as uint32 bit patterns),
`legal_moves`, `score_tromp_taylor`, the GoState step / handicap / reset,
and the D4 transforms.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import engine as jengine
from elf_tpu.env.go import features as jfeat
from elf_tpu.env.go import state as jstate
from elf_tpu_torch.env.go import engine as tengine
from elf_tpu_torch.env.go import features as tfeat
from elf_tpu_torch.env.go import state as tstate

pytestmark = pytest.mark.timeout(180)


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a


def _assert_core_equal(jc, tc, where):
    for name in jengine.GoCore._fields:
        a, b = np.asarray(getattr(jc, name)), _np(getattr(tc, name))
        if name.startswith("hash"):
            b = b.view(np.uint32)
        else:
            assert a.dtype == b.dtype, f"{name} dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {where}")


def _to_torch_core(jc):
    vals = []
    for name in jengine.GoCore._fields:
        a = np.array(getattr(jc, name))
        if name.startswith("hash"):
            a = a.view(np.int32)
        vals.append(torch.from_numpy(a))
    return tengine.GoCore(*vals)


@pytest.mark.parametrize("size,B,plies", [(9, 8, 90), (19, 4, 160)])
def test_step_core_random_legal_games(size, B, plies):
    """Lockstep random games (legal moves, passes, captures, ko): the port's
    step_core agrees with the JAX one on every field at every ply; a few
    illegal and out-of-range actions are mixed in."""
    n2 = size * size
    rng = np.random.default_rng(size)
    jcore = jengine.init_core(B, size)
    tcore = tengine.init_core(B, size, "cpu")
    legal = np.ones((B, n2 + 1), bool)
    for ply in range(plies):
        probs = legal / legal.sum(axis=1, keepdims=True)
        action = np.array([rng.choice(n2 + 1, p=p) for p in probs], np.int32)
        if ply % 17 == 5:
            action[0] = -3                       # negative action: a pass
        if ply % 13 == 7:
            occ = np.nonzero(np.asarray(jcore.stones)[1])[0]
            if occ.size:
                action[1] = occ[0]               # occupied point: illegal
        jcore2, jinfo = jengine.step_core(jcore, jnp.asarray(action), size)
        tcore2, tinfo = tengine.step_core(tcore, torch.from_numpy(action), size)
        _assert_core_equal(jcore2, tcore2, f"size {size} ply {ply}")
        for name in jengine.StepInfo._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jinfo, name)), _np(getattr(tinfo, name)),
                err_msg=f"StepInfo.{name} size {size} ply {ply}",
            )
        np.testing.assert_array_equal(
            np.asarray(jengine.legal_moves(jcore2, size)),
            tengine.legal_moves(tcore2, size).numpy(),
            err_msg=f"legal_moves size {size} ply {ply}",
        )
        jcore, tcore = jcore2, tcore2
        legal = np.asarray(jinfo.legal_next).copy()
        legal[np.asarray(jinfo.illegal)] = True
    np.testing.assert_array_equal(
        np.asarray(jengine.score_tromp_taylor(jcore, size)),
        tengine.score_tromp_taylor(tcore, size).numpy(),
    )


@pytest.mark.parametrize("size", [9, 19])
def test_legal_moves_and_score_on_random_positions(size):
    """Arbitrary (not necessarily reachable) positions with ko state."""
    B = 32
    n2 = size * size
    rng = np.random.default_rng(100 + size)
    jcore = jengine.init_core(B, size)
    stones = rng.choice(3, size=(B, n2), p=[0.5, 0.25, 0.25]).astype(np.int8)
    jcore = jcore._replace(
        stones=jnp.asarray(stones),
        to_play=jnp.asarray(rng.integers(1, 3, B).astype(np.int8)),
        ko_point=jnp.asarray(rng.integers(-1, n2, B).astype(np.int32)),
        ko_color=jnp.asarray(rng.integers(1, 3, B).astype(np.int8)),
        ko_age=jnp.asarray(rng.integers(0, 2, B).astype(np.int32)),
    )
    tcore = _to_torch_core(jcore)
    np.testing.assert_array_equal(
        np.asarray(jengine.legal_moves(jcore, size)),
        tengine.legal_moves(tcore, size).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jengine.score_tromp_taylor(jcore, size)),
        tengine.score_tromp_taylor(tcore, size).numpy(),
    )
    assert not tengine.is_terminal_core(tcore, size).any()


def test_state_step_handicap_and_evaluate():
    """GoState.step (superko history, snapshots, last_placed) from a
    handicap opening, against the JAX state module."""
    size, B = 9, 6
    n2 = size * size
    rng = np.random.default_rng(9)
    js = jstate.apply_handicap(jstate.init_state(B, size), 3, size)
    ts = tstate.apply_handicap(tstate.init_state(B, size, "cpu"), 3, size)
    for ply in range(70):
        legal = np.array(jstate.legal_moves(js, size))
        np.testing.assert_array_equal(
            legal, tstate.legal_moves(ts, size).numpy(), err_msg=f"ply {ply}")
        legal[~legal.any(axis=1), n2] = True     # terminated boards: pass
        probs = legal / legal.sum(axis=1, keepdims=True)
        action = np.array([rng.choice(n2 + 1, p=p) for p in probs], np.int32)
        js, _ = jstate.step(js, jnp.asarray(action), size)
        ts, _ = tstate.step(ts, torch.from_numpy(action), size)
        for name in jstate.GoState._fields:
            if name == "core":
                _assert_core_equal(js.core, ts.core, f"ply {ply}")
                continue
            a, b = np.asarray(getattr(js, name)), _np(getattr(ts, name))
            if name.startswith("hash_hist"):
                b = b.view(np.uint32)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} ply {ply}")
    np.testing.assert_array_equal(np.asarray(jstate.evaluate(js, size)),
                                  tstate.evaluate(ts, size).numpy())


@pytest.mark.parametrize("size", [9, 19])
def test_d4_transforms_match_jax(size):
    """Planes, actions and policies under all eight D4 codes."""
    n2 = size * size
    rng = np.random.default_rng(size)
    codes = np.tile(np.arange(8, dtype=np.int32), 2)
    K = codes.size
    planes = rng.random((K, 3, n2)).astype(np.float32)
    pi = rng.random((K, n2 + 1)).astype(np.float32)
    action = rng.integers(-1, n2 + 1, K).astype(np.int32)
    action[:3] = n2
    jc, tc = jnp.asarray(codes), torch.from_numpy(codes)
    pairs = [
        (jfeat.transform_planes(jnp.asarray(planes), jc, size),
         tfeat.transform_planes(torch.from_numpy(planes), tc, size)),
        (jfeat.transform_policy(jnp.asarray(pi), jc, size),
         tfeat.transform_policy(torch.from_numpy(pi), tc, size)),
        (jfeat.inv_transform_policy(jnp.asarray(pi), jc, size),
         tfeat.inv_transform_policy(torch.from_numpy(pi), tc, size)),
        (jfeat.transform_action(jnp.asarray(action), jc, size),
         tfeat.transform_action(torch.from_numpy(action), tc, size)),
        (jfeat.inv_transform_action(jnp.asarray(action), jc, size),
         tfeat.inv_transform_action(torch.from_numpy(action), tc, size)),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_reset_where_matches_jax():
    size, B = 9, 4
    js = jstate.init_state(B, size)
    ts = tstate.init_state(B, size, "cpu")
    a = np.array([10, 20, 30, 81], np.int32)
    js, _ = jstate.step(js, jnp.asarray(a), size)
    ts, _ = tstate.step(ts, torch.from_numpy(a), size)
    mask = np.array([True, False, True, False])
    js = jstate.reset_where(js, jnp.asarray(mask), size, handicap=2)
    ts = tstate.reset_where(ts, torch.from_numpy(mask), size, handicap=2)
    for name in jstate.GoState._fields:
        if name == "core":
            _assert_core_equal(js.core, ts.core, "reset_where")
            continue
        b = _np(getattr(ts, name))
        if name.startswith("hash_hist"):
            b = b.view(np.uint32)
        np.testing.assert_array_equal(np.asarray(getattr(js, name)), b,
                                      err_msg=name)


@pytest.mark.parametrize("entry", [tengine.init_core, tstate.init_state],
                         ids=["init_core", "init_state"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a device the engine's entry points ask for the card: with no
    CUDA they raise and name the CPU option; "cpu" gives CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(2, 9)
    out = entry(2, 9, "cpu")
    tensors = list(out.core) + list(out[1:]) if hasattr(out, "core") \
        else list(out)
    assert all(t.device.type == "cpu" for t in tensors)
