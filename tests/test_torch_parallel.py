"""The port's mesh parallelism (`elf_tpu_torch.parallel`) on the CPU: the
twin of tests/test_parallel.py.

Ranks are spawned with torch.multiprocessing over gloo, one process each:
a world of 2 (the dp = 2 and tp = 2 meshes in turn, the actors, the
checkpoint) and a world of 4 (dp 2 x tp 2).  Their results come back
through files and are held against the JAX package from the same weights
and batches: `jax.jit(Trainer.make_train_step())` on one device and the
GSPMD step on the 8-device CPU mesh (`make_mesh(8, tp=2)`), and the
offline (df_pred) step likewise.

Nets: 9x9, 2 blocks x 32 channels (the steps, as tests/test_parallel.py)
and 5x5, 1 block x 16 (the tp actor), fp32.  Tolerances: loss and stats
within 1e-5 relative (absolute below 1), parameters, BN statistics and
optimizer slots within 1e-5 absolute, after two steps with the gradient
clipped by its global norm (so a wrong tp norm moves every parameter).
The dp = 2 actor's records must equal the unsharded actor's exactly: its
evaluator is exact in float32 (priors on one move in eight, values in
sixteenths, as tests/test_torch_tree_reuse.py's), so batching cannot
change a bit.

The spawned ranks import this module: its module-level imports are torch
and the port only, and JAX and the JAX package are imported inside the
test functions.
"""

import copy
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

SPAWN_TIMEOUT_S = 240
B, T, SIZE = 16, 2, 9
A = SIZE * SIZE + 1
NET9 = dict(board_size=SIZE, num_planes=18, num_block=2, dim=32)
OPTS9 = dict(num_block=2, dim=32, batchsize=B, lr=0.001, grad_clip_norm=1.0)
NET5 = ModelConfig(board_size=5, num_block=1, dim=16, use_bf16=False)
MESHES = {"dp2": (2, 1), "tp2": (2, 2), "dp2tp2": (4, 2)}
ACTOR_B, ACTOR_MOVES = 8, 10
ACTOR_VARIANTS = {
    "direct": ({}, {}),
    "chunked": ({}, {"max_batches_per_call": 1}),
    "persistent": ({"persistent_tree": True}, {}),
}


# ---------------------------------------------------------------------------
# what the ranks run (module level, torch only)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(fn, world: int, *args) -> None:
    """Run fn(rank, world, port, *args) in `world` spawned processes; a
    rank that fails or outlives the deadline fails the test."""
    ctx = mp.start_processes(fn, args=(world, _free_port(), *args),
                             nprocs=world, join=False, start_method="spawn")
    try:
        import time

        deadline = time.time() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"{fn.__name__} ranks still running")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _init(rank: int, world: int, port: int) -> None:
    from elf_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                        backend="gloo")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _state_trees(state):
    """(params, batch_stats, opt_state) of a full TrainState in flax
    layouts, as numpy."""
    from elf_tpu_torch.models.checkpoint import _opt_tree
    from elf_tpu_torch.models.resnet import params_to_jax

    params, stats = params_to_jax(state.net)
    return params, stats, _np_tree(_opt_tree(state.net.cfg, state.opt_state))


def _learner(data, remat: bool = False):
    from elf_tpu_torch.training.trainer import Trainer

    trainer = Trainer(ModelConfig(**NET9, use_bf16=False, remat=remat),
                      TrainOptions(**OPTS9), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state.net.load_state_dict(data["sd"])
    return trainer, state


def _sharded_steps(mesh, data, train_mode: str, per_rank_bn: bool = False,
                   remat: bool = False):
    """Two sharded steps from the data's weights on its two batches:
    {"stats": [...], "trees": (params, batch_stats, opt_state)}."""
    from elf_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_state,
        make_sharded_train_step,
        shard_state,
    )

    trainer, state = _learner(data, remat)
    step, shardings = make_sharded_train_step(trainer, mesh, state,
                                              train_mode=train_mode)
    shard = shard_state(state, shardings)
    if per_rank_bn:             # the fault the comparisons must catch
        for m in shard.net.modules():
            if hasattr(m, "sync"):
                m.sync = None
    rows = batch_sharding(mesh, B)
    stats = []
    for feats, pi, winner, offline_a in data["batches"]:
        target = offline_a if train_mode == "offline" else pi
        shard, s = step(shard, feats[rows], target[rows], winner[rows])
        stats.append({k: float(v) for k, v in s.items()})
    return {"stats": stats,
            "trees": _state_trees(gather_state(shard, shardings))}


def _steps_rank(rank, world, port, data_path, out_dir):
    """Every mesh of this world size: two mcts and two offline steps."""
    from elf_tpu_torch.parallel.mesh import make_mesh

    _init(rank, world, port)
    data = torch.load(data_path, weights_only=False)
    results = {}
    for name, (n, tp) in MESHES.items():
        if n != world:
            continue
        mesh = make_mesh(n, tp=tp)
        for mode in ("mcts", "offline"):
            results[name, mode] = _sharded_steps(mesh, data, mode)
        results[name, "remat"] = _sharded_steps(mesh, data, "mcts",
                                                remat=True)
        if name == "dp2":
            results[name, "per_rank_bn"] = _sharded_steps(
                mesh, data, "mcts", per_rank_bn=True)
    if world == 2:
        results.update(_world2_extras(rank, data, out_dir))
    if rank == 0:
        torch.save(results, os.path.join(out_dir, f"world{world}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dyadic_eval_fn(feats, to_play):
    """Priors on one action in eight, value (black - white stones) / 16:
    exact in float32 whatever the batch (tests/test_torch_tree_reuse.py)."""
    K = feats.shape[0]
    n2 = feats.shape[1] * feats.shape[2]
    favored = (torch.arange(n2 + 1) * 37 + 13) % 8 == 0
    log_prior = torch.where(favored, 0.0, -1e4)
    mine = feats[..., 0].reshape(K, n2).sum(-1)
    theirs = feats[..., 1].reshape(K, n2).sum(-1)
    b = torch.where(to_play == BLACK, mine, theirs)
    w = torch.where(to_play == BLACK, theirs, mine)
    return (log_prior[None, :].expand(K, n2 + 1),
            ((b - w) / 16.0).clamp(-1.0, 1.0))


def _dyadic_builder(params, batch_stats):
    return dyadic_eval_fn


def make_actor(variant: str, mesh=None, builder=_dyadic_builder,
               size=SIZE, seed=5):
    """The actor of the dp = 2 comparison: root noise, a random symmetry
    per leaf, sampled moves for 3 plies, never-resign draws and random
    results from the host generator, games cut at 6 moves."""
    acfg, mcfg = ACTOR_VARIANTS[variant]
    return SelfplayActor(
        ActorConfig(board_size=size, batch=ACTOR_B, komi=7.5,
                    policy_distri_cutoff=3, never_resign_prob=0.5,
                    move_cutoff=6, cheat_selfplay_random_result=True,
                    **acfg),
        MCTSConfig(num_rollouts=24, rollouts_per_batch=4, root_epsilon=0.25,
                   **mcfg),
        builder, seed=seed, device="cpu", mesh=mesh)


def _records_json(records):
    out = []
    for r in records:
        d = r.to_json()
        d.pop("timestamp")
        out.append(d)
    return out


def _world2_extras(rank, data, out_dir):
    """The world-of-2 cases besides the steps: gather(shard) on a tp mesh,
    a tp = 2 runner's checkpoint, the dp = 2 actor in every variant, the
    tp = 2 actor and its leaf evaluations."""
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )
    from elf_tpu_torch.training.trainer import Trainer

    out = {}
    # gather_state(shard_state(s)) == s, slots included (momentum traces
    # made non-zero by one plain step first)
    trainer, state = _learner(data)
    feats, pi, winner, _ = data["batches"][0]
    state, _ = trainer.make_train_step()(state, feats, pi, winner)
    tp_mesh = make_mesh(2, tp=2)
    _, shardings = make_sharded_train_step(trainer, tp_mesh, state)
    back = gather_state(shard_state(state, shardings), shardings)
    out["roundtrip"] = (_state_trees(state), _state_trees(back))

    # a tp = 2 runner takes one step and writes its checkpoint
    out["runner"] = _runner_checkpoint(tp_mesh, data, out_dir)

    # the dp = 2 actor, every variant
    dp_mesh = make_mesh(2, tp=1)
    for variant in ACTOR_VARIANTS:
        actor = make_actor(variant, dp_mesh)
        recs = actor.play_moves(None, None, ACTOR_MOVES)
        out["actor", variant] = (_records_json(recs), actor.completed_games)

    # the tp = 2 actor through the tp-split 5x5 net
    net_state = Trainer(NET5, TrainOptions(num_block=1, dim=16),
                        device="cpu").init_state(
        torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():       # BN statistics that the slices must keep
        for name, buf in net_state.net.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    _, shardings = make_sharded_train_step(
        Trainer(NET5, TrainOptions(num_block=1, dim=16), device="cpu"),
        tp_mesh, net_state)
    sharded = shard_state(net_state, shardings)
    x = torch.rand((12, 5, 5, 18), generator=g)
    with torch.inference_mode():
        lp, v = eval_fn_builder(sharded.net)(x, None)
        lp_full, v_full = eval_fn_builder(net_state.net)(x, None)
    out["tp_eval_err"] = max(float((lp - lp_full).abs().max()),
                             float((v - v_full).abs().max()))
    actor = make_actor("direct", tp_mesh,
                       builder=lambda p, bs: eval_fn_builder(p), size=5)
    recs = actor.play_moves(sharded.net, None, ACTOR_MOVES)
    out["tp_actor", rank] = ([(r.result.content, r.thread_id) for r in recs],
                             actor.completed_games)
    if rank == 1:               # rank 1's returns travel through rank 0
        obj = [out["tp_actor", 1]]
        dist.broadcast_object_list(obj, src=1)
    else:
        obj = [None]
        dist.broadcast_object_list(obj, src=1)
        out["tp_actor", 1] = obj[0]
    return out


def _runner_checkpoint(mesh, data, out_dir):
    """A LearnerRunner on `mesh` takes one step (the data's first batch, fed
    to every rank by HostSync from rank 0's replay) and writes
    save-1.bin; returns the path and the single-device trees to hold the
    file against."""
    from elf_tpu_torch.config import ReplayOptions
    from elf_tpu_torch.parallel.mesh import batch_sharding
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner

    trainer, state = _learner(data)
    pipeline = TrainingPipeline(ReplayBuffer(ReplayOptions()), SIZE)
    opts = TrainOptions(**OPTS9, num_cooldown=0)
    runner = LearnerRunner(trainer, pipeline,
                           os.path.join(out_dir, "ckpt"), opts, mesh=mesh)
    runner.load_state(state)
    feats, pi, winner, _ = data["batches"][0]
    rows = batch_sharding(mesh, B)
    runner.state, _ = runner._train_step(runner.state, feats[rows], pi[rows],
                                         winner[rows])
    ver = runner.episode_summary()
    plain, pstate = _learner(data)
    pstate, _ = plain.make_train_step()(pstate, feats, pi, winner)
    return ver, runner.save_enabled, _state_trees(pstate)


# ---------------------------------------------------------------------------
# the parent: data, JAX references, comparisons
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        feats = (rng.random((B, SIZE, SIZE, 18)) < 0.3).astype(np.float32)
        pi = rng.dirichlet(np.full(A, 0.3), size=B).astype(np.float32)
        winner = rng.choice([-1.0, 1.0], size=B).astype(np.float32)
        offline_a = rng.integers(0, A, size=(B, T)).astype(np.int32)
        out.append((feats, pi, winner, offline_a))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both worlds once; JAX's references from the same weights."""
    import jax
    import jax.numpy as jnp

    from elf_tpu.config import TrainOptions as JTrainOptions
    from elf_tpu.models.resnet import ModelConfig as JModelConfig
    from elf_tpu.parallel import mesh as jmesh
    from elf_tpu.training.trainer import Trainer as JTrainer
    from elf_tpu_torch.models.resnet import PolicyValueNet, load_flax_trees

    out_dir = str(tmp_path_factory.mktemp("parallel"))
    jtr = JTrainer(JModelConfig(**NET9, use_bf16=False),
                   JTrainOptions(**OPTS9))
    jstate0 = jtr.init_state(jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate0.params)
    stats0 = jax.device_get(jstate0.batch_stats)
    net = PolicyValueNet(ModelConfig(**NET9, use_bf16=False))
    load_flax_trees(net, params0, stats0)
    batches = _batches()
    data_path = os.path.join(out_dir, "data.pt")
    torch.save({"sd": net.state_dict(),
                "batches": [tuple(torch.from_numpy(a) for a in b)
                            for b in batches]}, data_path)
    for world in (2, 4):
        _spawn(_steps_rank, world, data_path, out_dir)
    ranks = {}
    for world in (2, 4):
        ranks.update(torch.load(os.path.join(out_dir, f"world{world}.pt"),
                                weights_only=False))

    def jax_run(mode, mesh):
        fresh = jtr.init_state(jax.random.PRNGKey(0))
        if mode == "offline":
            make = jtr.make_offline_train_step
        else:
            make = jtr.make_train_step
        if mesh is None:
            step, state = jax.jit(make()), fresh
        else:
            step, shardings = jmesh.make_sharded_train_step(
                jtr, mesh, fresh, train_mode=mode)
            state = jmesh.shard_state(fresh, shardings)
        stats = []
        for feats, pi, winner, offline_a in batches:
            target = offline_a if mode == "offline" else pi
            state, s = step(state, jnp.asarray(feats), jnp.asarray(target),
                            jnp.asarray(winner))
            stats.append({k: float(v) for k, v in s.items()})
        state = jax.device_get(state)
        import flax

        trees = (state.params, state.batch_stats,
                 flax.serialization.to_state_dict(state.opt_state))
        return {"stats": stats, "trees": trees}

    refs = {}
    mesh8 = jmesh.make_mesh(8, tp=2)
    for mode in ("mcts", "offline"):
        refs["single", mode] = jax_run(mode, None)
        refs["mesh8", mode] = jax_run(mode, mesh8)
    return {"ranks": ranks, "refs": refs, "out_dir": out_dir}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_close(ours, ref, atol=1e-5, what=""):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys(), what
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, atol=atol, rtol=0,
                                   err_msg=f"{what}{k}")


def _assert_run_close(ours, ref, what):
    for i, (s, r) in enumerate(zip(ours["stats"], ref["stats"])):
        assert s.keys() == r.keys(), what
        for k in r:
            assert abs(s[k] - r[k]) <= 1e-5 * max(1.0, abs(r[k])), (
                f"{what} step {i} {k}: {s[k]} vs {r[k]}")
    for name, o, r in zip(("params", "batch_stats", "opt_state"),
                          ours["trees"], ref["trees"]):
        _assert_trees_close(o, r, what=f"{what} {name}")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("ref", ["single", "mesh8"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_jax(runs, mesh, ref):
    """Two dp / tp / dp x tp steps (global-batch BN, clipped gradient)
    against the JAX single-device step and its 8-device GSPMD step."""
    _assert_run_close(runs["ranks"][mesh, "mcts"], runs["refs"][ref, "mcts"],
                      f"{mesh} vs {ref}")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_offline_step_matches_jax(runs, mesh):
    _assert_run_close(runs["ranks"][mesh, "offline"],
                      runs["refs"]["single", "offline"], f"{mesh} offline")
    _assert_run_close(runs["ranks"][mesh, "offline"],
                      runs["refs"]["mesh8", "offline"], f"{mesh} offline")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_remat_step_matches_jax(runs, mesh):
    """With block remat the recomputed blocks reduce their statistics over
    the mesh again, and the running statistics still move once a step,
    from the global ones: the plain JAX step's result."""
    _assert_run_close(runs["ranks"][mesh, "remat"],
                      runs["refs"]["single", "mcts"], f"{mesh} remat")


@pytest.mark.timeout(600)
def test_per_rank_batchnorm_is_caught(runs):
    """The likely fault (per-rank BN statistics, DDP's default) moves the
    loss in its fourth digit, ten times the tolerance, so the comparisons
    catch it."""
    ours = runs["ranks"]["dp2", "per_rank_bn"]
    ref = runs["refs"]["single", "mcts"]
    loss = ours["stats"][0]["loss/total"]
    assert abs(loss - ref["stats"][0]["loss/total"]) > 1e-4 * abs(loss)
    with pytest.raises(AssertionError):
        _assert_run_close(ours, ref, "per-rank BN")


@pytest.mark.timeout(600)
def test_gather_of_shard_is_identity(runs):
    before, after = runs["ranks"]["roundtrip"]
    for o, r in zip(after, before):
        for (k, a), (_, b) in zip(sorted(_leaves(o)), sorted(_leaves(r))):
            assert np.array_equal(a, b), k


@pytest.mark.timeout(600)
def test_tp2_runner_checkpoint_reads_in_jax(runs):
    """The tp = 2 runner's rank 0 writes save-1.bin from the gathered full
    state; the JAX package loads it, and it holds the single-device step."""
    import jax

    from elf_tpu.training.trainer import load_checkpoint as jload

    ver, saved_on_rank0, (params, stats, _) = runs["ranks"]["runner"]
    assert ver == 1 and saved_on_rank0
    path = os.path.join(runs["out_dir"], "ckpt", "save-1.bin")
    loaded = jload(path)
    assert int(loaded.step) == 1
    _assert_trees_close(jax.device_get(loaded.params), params, what="params")
    _assert_trees_close(jax.device_get(loaded.batch_stats), stats,
                        what="batch_stats")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("variant", list(ACTOR_VARIANTS))
def test_dp2_actor_plays_the_unsharded_games(runs, variant):
    """Rank 0 of the dp = 2 actor returns exactly the unsharded actor's
    records (moves, policies, values, results, board order) at one seed:
    the direct search, the chunked one and persistent trees."""
    recs, completed = runs["ranks"]["actor", variant]
    actor = make_actor(variant)
    ref = actor.play_moves(None, None, ACTOR_MOVES)
    assert completed == actor.completed_games >= ACTOR_B
    assert recs == _records_json(ref)


@pytest.mark.timeout(600)
def test_tp2_actor_legal_records_and_leaf_evals(runs):
    """The tp = 2 actor's leaf evaluations are within 1e-5 of the unsharded
    net's; its games finish with legal records, every one on rank 0 in
    board order, none on rank 1."""
    from elf_tpu_torch.env.go import state as gostate
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves

    assert runs["ranks"]["tp_eval_err"] <= 1e-5
    recs0, completed = runs["ranks"]["tp_actor", 0]
    recs1, completed1 = runs["ranks"]["tp_actor", 1]
    assert recs1 == [] and completed1 == completed
    assert len(recs0) == completed >= ACTOR_B
    first = [tid for _, tid in recs0[:ACTOR_B]]
    assert first == sorted(first)
    moves = [sgf_string_to_moves(content, 5) for content, _ in recs0]
    st = gostate.init_state(len(moves), 5, "cpu")
    for i in range(max(len(m) for m in moves)):
        a = torch.tensor([m[i] if i < len(m) else 25 for m in moves],
                         dtype=torch.int32)
        live = torch.tensor([i < len(m) for m in moves])
        st, info = gostate.step(st, a, 5)
        assert not bool((info.illegal & live).any()), f"illegal at ply {i}"


# ---------------------------------------------------------------------------
# in-process cases (no process group)
# ---------------------------------------------------------------------------

def test_param_sharding_rules():
    from elf_tpu_torch.models.resnet import PolicyValueNet
    from elf_tpu_torch.parallel.mesh import Mesh, param_shardings

    net = PolicyValueNet(ModelConfig(**NET9))
    dims = param_shardings(Mesh(4, 2), net)
    assert dims["init_conv.weight"] == 0
    assert dims["blocks.0.conv1.weight"] == 0       # column-parallel
    assert dims["blocks.1.conv2.weight"] == 1       # row-parallel
    assert dims["v_fc1.weight"] == 0 and dims["v_fc2.weight"] == 1
    assert dims["pi_fc.weight"] is None
    assert all(d is None for n, d in dims.items()
               if n.endswith("bias") or ".bn" in n or "_bn" in n)
    assert all(d is None for d in param_shardings(Mesh(8, 1), net).values())


@pytest.mark.parametrize("opt_method", ["sgd", "adam"])
def test_opt_state_follows_param_shardings(opt_method):
    """Every optimizer slot is sharded exactly as its parameter: the same
    shape and the same rank's slice."""
    from elf_tpu_torch.parallel.mesh import (
        Mesh,
        StateShardings,
        _slot_dicts,
        param_shardings,
        shard_state,
    )
    from elf_tpu_torch.training.trainer import Trainer

    trainer = Trainer(ModelConfig(**NET9, use_bf16=False),
                      TrainOptions(**OPTS9, opt_method=opt_method),
                      device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    params = dict(state.net.named_parameters())
    with torch.no_grad():
        for slots in _slot_dicts(state.opt_state):
            for name, t in slots.items():
                t.copy_(params[name] * 3.0)
    mesh = Mesh(1, 2, rank=1)
    shard = shard_state(state, StateShardings(
        mesh, param_shardings(mesh, state.net)))
    params = dict(shard.net.named_parameters())
    n_slots = 0
    for slots in _slot_dicts(shard.opt_state):
        for name, t in slots.items():
            assert t.shape == params[name].shape, name
            assert torch.equal(t, params[name] * 3.0), name
            n_slots += 1
    assert n_slots == len(params) * (2 if opt_method == "adam" else 1)
    assert params["blocks.0.conv1.weight"].shape == (16, 32, 3, 3)
    assert params["blocks.0.conv2.weight"].shape == (32, 16, 3, 3)
    assert torch.equal(params["blocks.0.conv1.weight"],
                       state.net.blocks[0].conv1.weight[16:])


def test_mesh_of_one_is_the_plain_step_bit_for_bit():
    """LearnerRunner(mesh=make_mesh(1)) takes the plain runner's steps and
    cooldown bit for bit (no process group)."""
    from elf_tpu_torch.config import ReplayOptions
    from elf_tpu_torch.parallel import make_mesh
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner
    from elf_tpu_torch.training.trainer import Trainer

    assert not dist.is_initialized()
    mesh = make_mesh(1)
    assert mesh.shape == {"dp": 1, "tp": 1}
    runners = []
    for m in (None, mesh):
        trainer = Trainer(ModelConfig(**NET9, use_bf16=False),
                          TrainOptions(**OPTS9), device="cpu")
        pipeline = TrainingPipeline(ReplayBuffer(ReplayOptions()), SIZE)
        runners.append(LearnerRunner(trainer, pipeline, "unused",
                                     TrainOptions(**OPTS9), mesh=m, seed=3))
    stats = []
    for r in runners:
        out = []
        for feats, pi, winner, _ in _batches():
            r.state, s = r._train_step(r.state, torch.from_numpy(feats),
                                       torch.from_numpy(pi),
                                       torch.from_numpy(winner))
            out.append({k: v.clone() for k, v in s.items()})
        r.state = r._cooldown_step(r.state, torch.from_numpy(feats))
        stats.append(out)
    for a, b in zip(*stats):
        assert all(torch.equal(a[k], b[k]) for k in a)
    plain, meshed = (r.full_state() for r in runners)
    for (k, a), (_, b) in zip(plain.net.state_dict().items(),
                              meshed.net.state_dict().items()):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(
            sorted(_leaves(_state_trees(plain)[2])),
            sorted(_leaves(_state_trees(meshed)[2]))):
        assert np.array_equal(a, b), k


def test_host_sync_and_distributed_init_without_a_world(monkeypatch):
    """No args and no env: nothing joins a world.  An incomplete request
    raises."""
    from elf_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process"):
        maybe_initialize_distributed("127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="outside"):
        maybe_initialize_distributed("127.0.0.1:1", 2, 5)


def test_copy_of_a_sharded_net_shares_its_mesh():
    """serving_copy / deepcopy of a sharded net keep the same Mesh object
    (process groups cannot be copied)."""
    from elf_tpu_torch.models.resnet import serving_copy
    from elf_tpu_torch.parallel.mesh import (
        Mesh,
        StateShardings,
        param_shardings,
        shard_state,
    )
    from elf_tpu_torch.training.trainer import Trainer

    state = Trainer(NET5, TrainOptions(num_block=1, dim=16),
                    device="cpu").init_state(torch.Generator().manual_seed(0))
    mesh = Mesh(2, 2, rank=3)
    shard = shard_state(state, StateShardings(
        mesh, param_shardings(mesh, state.net)))
    frozen = serving_copy(shard.net)
    assert frozen.blocks[0].conv1.tp.mesh is mesh
    assert frozen.blocks[0].bn1.sync is mesh
    assert frozen.blocks[0].bn1.channels == slice(8, 16)
    assert copy.deepcopy(shard).net.v_fc2.tp.mode == "row"
