"""`bench_torch.py`, the port's twin of `bench.py`, on the CPU:

 - the env stage's chunk (`rollout_chunk`) against the JAX engine: its
   actions replayed through `elf_tpu.env.go.engine.step_core` and
   `is_terminal_core` with `bench.py`'s reset give every `GoCore` field and
   the carried legal mask bit for bit after every step (tolerance 0), at
   5x5 (the 49-ply cap forces resets) and 9x9 (from a mid-game, with
   captures); no drawn action is illegal;
 - `_fwd_flops` equal to `bench._fwd_flops` (exact integers);
 - `_is_oom`, and the train stage's halving on running out of memory;
 - every stage at a tiny size returns finite positive numbers in the
   shape of its JAX counterpart's result;
 - `main` with stubbed stages: one stdout JSON line whose keys are the
   ones `bench.py` prints (read from its source), the stderr lines, the
   self-play halving, and return code 1 after a failed or skipped stage;
 - the script imports nothing of JAX or the JAX package, and a stage
   called without `device` raises where there is no card.
"""

import ast
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import engine as jengine
from elf_tpu_torch.env.go import engine as tengine
from elf_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(core):
    vals = []
    for name, t in zip(tengine.GoCore._fields, core):
        a = t.numpy().copy()
        if name.startswith("hash"):
            a = a.view(np.uint32)
        vals.append(jnp.asarray(a))
    return jengine.GoCore(*vals)


def _assert_core_equal(jc, tc, where):
    for name in jengine.GoCore._fields:
        a = np.asarray(getattr(jc, name))
        b = getattr(tc, name).numpy()
        if name.startswith("hash"):
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, f"{name} dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {where}")


@pytest.mark.parametrize("size,B,chunk,lead,want", [
    (5, 32, 64, 0, "resets"),
    (9, 8, 32, 64, "captures"),
])
def test_rollout_chunk_equals_jax_engine(size, B, chunk, lead, want):
    """`lead` steps of the chunk bring the boards to mid-game; from there,
    one chunk of `chunk` steps with `actions_out` and the same chunk step by
    step (one-step chunks on a generator of the same seed, so the same
    draws) against the JAX engine fed the drawn actions."""
    n2 = size * size
    fresh = tengine.init_core(B, size, "cpu")
    legal = torch.ones((B, n2 + 1), dtype=torch.bool)
    gen = torch.Generator().manual_seed(size)
    start, start_legal, bad = bench_torch.rollout_chunk(
        fresh, fresh, legal, gen, size, lead)
    assert not bad.any()
    state = gen.get_state()

    actions = []
    whole = bench_torch.rollout_chunk(fresh, start, start_legal, gen, size,
                                      chunk, actions)
    assert len(actions) == chunk
    assert not whole[2].any()

    gen.set_state(state)
    jstep = jax.jit(jengine.step_core, static_argnums=2)
    jfresh = jengine.init_core(B, size)
    jcore, jlegal = _to_jax(start), jnp.asarray(start_legal.numpy())
    core, legal = start, start_legal
    resets = captures = 0
    for t in range(chunk):
        drawn = []
        core, legal, bad = bench_torch.rollout_chunk(fresh, core, legal, gen,
                                                     size, 1, drawn)
        a = drawn[0].numpy()
        np.testing.assert_array_equal(a, actions[t].numpy())
        assert np.asarray(jlegal)[np.arange(B), a].all(), f"step {t}"
        jcore, jinfo = jstep(jcore, jnp.asarray(a), size)
        assert not np.asarray(jinfo.illegal).any(), f"step {t}"
        captures += int(np.asarray(jinfo.captured).sum())
        done = jengine.is_terminal_core(jcore, size)
        resets += int(np.asarray(done).sum())
        jcore = jax.tree.map(
            lambda f, x: jnp.where(
                done.reshape(done.shape + (1,) * (x.ndim - 1)), f, x),
            jfresh, jcore)
        jlegal = jnp.where(done[:, None], True, jinfo.legal_next)
        _assert_core_equal(jcore, core, f"size {size} step {t}")
        np.testing.assert_array_equal(np.asarray(jlegal), legal.numpy(),
                                      err_msg=f"legal size {size} step {t}")
        assert not bad.any()
    assert {"resets": resets, "captures": captures}[want] > 0
    _assert_core_equal(jcore, whole[0], f"size {size}, the whole chunk")
    np.testing.assert_array_equal(np.asarray(jlegal), whole[1].numpy())


@pytest.mark.parametrize("args", [
    (1,), (128,), (2048,), (7, 9, 18, 3, 48), (5, 19, 25, 20, 256),
])
def test_fwd_flops_equals_bench(args):
    assert bench_torch._fwd_flops(*args) == bench._fwd_flops(*args)


def test_is_oom():
    assert bench_torch._is_oom(torch.cuda.OutOfMemoryError("any text"))
    assert bench_torch._is_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not bench_torch._is_oom(ValueError("bad shape"))
    assert not bench_torch._is_oom(RuntimeError("CUDA error: invalid"))


def _step_refusing(monkeypatch, above: int, error):
    """Train steps that raise `error` on a batch of more than `above`."""
    make = Trainer.make_train_step

    def guarded_maker(self, mesh=None):
        step = make(self, mesh)

        def guarded(state, feats, pi, winner):
            if feats.shape[0] > above:
                raise error
            return step(state, feats, pi, winner)

        return guarded

    monkeypatch.setattr(Trainer, "make_train_step", guarded_maker)


def test_train_step_halves_on_oom(monkeypatch, capsys):
    _step_refusing(monkeypatch, 256, torch.cuda.OutOfMemoryError(
        "CUDA out of memory"))
    bs, sps, tflops = bench_torch.bench_train_step(
        bs=512, blocks=1, dim=8, iters=1, device="cpu")
    assert bs == 256 and sps > 0 and tflops > 0
    assert "# train bs=512 OOM; halving" in capsys.readouterr().err


def test_train_step_does_not_halve_past_its_floor_or_other_errors(
        monkeypatch):
    _step_refusing(monkeypatch, 0, torch.cuda.OutOfMemoryError("oom"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench_torch.bench_train_step(bs=256, blocks=1, dim=8, iters=1,
                                     device="cpu")
    _step_refusing(monkeypatch, 0, ValueError("not memory"))
    with pytest.raises(ValueError):
        bench_torch.bench_train_step(bs=512, blocks=1, dim=8, iters=1,
                                     device="cpu")


TINY = {
    "env": (bench_torch.bench_env_steps,
            dict(B=2, size=5, chunk=8, iters=2), 1),
    "nn": (bench_torch.bench_nn_forward, dict(batch=2, blocks=1, dim=8), 1),
    "mcts": (bench_torch.bench_mcts_rollouts,
             dict(B=2, rollouts=16, m=8, blocks=1, dim=8), 1),
    "train": (bench_torch.bench_train_step,
              dict(bs=2, blocks=1, dim=8, iters=1), 3),
    "selfplay": (bench_torch.bench_selfplay_prod,
                 dict(B=2, rollouts=16, m=8, blocks=1, dim=8), 3),
}


@pytest.mark.parametrize("stage", sorted(TINY))
def test_stage_at_tiny_size(stage):
    fn, kwargs, n = TINY[stage]
    got = fn(device="cpu", **kwargs)
    vals = (got,) if n == 1 else got
    assert len(vals) == n
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in vals), got
    if stage == "train":
        assert got[0] == 2


def test_stages_leave_what_they_ran_on():
    env = {}
    bench_torch.bench_env_steps(B=2, size=5, chunk=4, iters=1, device="cpu",
                                out=env)
    assert env["core"].ply.shape == (2,) and env["legal"].shape == (2, 26)
    train = {}
    bench_torch.bench_train_step(bs=2, blocks=1, dim=8, iters=1,
                                 device="cpu", out=train)
    assert all(math.isfinite(v) for v in train["stats"].values())
    sp = {}
    bench_torch.bench_selfplay_prod(B=2, rollouts=8, m=8, blocks=1, dim=8,
                                    device="cpu", out=sp)
    assert len(sp["actor"].moves) == 2


@pytest.mark.parametrize("stage", sorted(TINY))
def test_stage_defaults_to_the_card(stage):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TINY[stage][0]()


def _printed_keys(rel):
    """The constant keys of the dict literals a script passes to
    `json.dumps`."""
    keys = []
    for node in ast.walk(ast.parse(open(os.path.join(REPO, rel)).read())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            keys.append([k.value for k in node.args[0].keys
                         if isinstance(k, ast.Constant)])
    return keys


def _stub_stages(monkeypatch, **override):
    stubs = dict(
        bench_env_steps=lambda: 2_500_000.0,
        bench_nn_forward=lambda batch=128: 9000.0 * batch / 128,
        bench_mcts_rollouts=lambda: 1500.0,
        bench_train_step=lambda: (2048, 0.84, 118.0),
        bench_selfplay_prod=lambda B=1024: (3.8, 6080.0, 30.4),
    )
    stubs.update(override)
    for name, fn in stubs.items():
        monkeypatch.setattr(bench_torch, name, fn)


def test_main_prints_bench_py_line(monkeypatch, capsys):
    assert _printed_keys("bench_torch.py") == _printed_keys("bench.py")
    _stub_stages(monkeypatch)
    assert bench_torch.main() == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert list(row) == _printed_keys("bench.py")[0]
    assert row == {"metric": "env_steps_per_sec_19x19_single_chip",
                   "value": 2500000.0, "unit": "steps/s",
                   "vs_baseline": 2.5}
    for want in ("# env_steps/s (19x19, B=4096): 2,500,000",
                 "# NN fwd evals/s (20b256c, bs=128): 9,000",
                 "# NN fwd evals/s (20b256c, bs=1024): 72,000",
                 "# MCTS rollouts/s (20b256c, B=16, 64 rollouts): 1,500",
                 "# train step (20b256c, remat, bs=2048): 0.840 steps/s, "
                 "118.0 TFLOP/s, 1,720 samples/s [hbm n/a]",
                 "# selfplay prod (19x19, B=1024, 1600 rollouts, 20b256c): "
                 "3.8 moves/s, 6,080 rollouts/s, ~30 games/hour/chip "
                 "[hbm n/a]",
                 "# total bench time: "):
        assert want in err, want
    assert "failed" not in err


def test_main_halves_selfplay_on_oom(monkeypatch, capsys):
    def selfplay(B=1024):
        if B > 256:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 1.0, 1600.0, 8.0

    _stub_stages(monkeypatch, bench_selfplay_prod=selfplay)
    assert bench_torch.main() == 0
    err = capsys.readouterr().err
    assert "# selfplay B=1024 OOM; halving" in err
    assert "# selfplay B=512 OOM; halving" in err
    assert "# selfplay prod (19x19, B=256, 1600 rollouts" in err


def test_main_returns_1_after_a_failed_stage(monkeypatch, capsys):
    def boom():
        raise RuntimeError("boom")

    _stub_stages(monkeypatch, bench_mcts_rollouts=boom)
    assert bench_torch.main() == 1
    out, err = capsys.readouterr()
    assert len(out.strip().splitlines()) == 1
    assert "# MCTS bench failed: boom" in err
    assert "# train step (20b256c, remat, bs=2048)" in err   # went on
    assert "# selfplay prod (19x19, B=1024" in err


def test_main_returns_1_after_a_skipped_stage(monkeypatch, capsys):
    monkeypatch.setenv("ELF_TPU_BENCH_BUDGET_S", "-1")
    _stub_stages(monkeypatch)
    assert bench_torch.main() == 1
    err = capsys.readouterr().err
    assert "# skipping train-step bench: over -1s budget" in err
    assert "# train bench failed: budget" in err
    assert "# selfplay prod bench failed: budget" in err


def test_imports_no_jax():
    banned = ("jax", "flax", "optax", "elf_tpu")
    for rel in ("bench_torch.py", "scripts/profile_mcts_torch.py",
                "scripts/production_selfplay_torch.py"):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{rel}: {name}"
