"""The slice as a whole: the port's SelfplayActor against the JAX one, at
9x9, with the same numpy weights (2 blocks, 32 channels, fp32), noise-free
search (16 rollouts, no random symmetry, no Dirichlet noise) and
argmax moves from ply 0 (policy_distri_cutoff=-1).

Demands identical actions on every ply, root visit distributions within
1e-6, and equal Record JSON except the timestamp.  The per-move values in a
record are NN outputs passed through the search; flax's and torch's fp32
convolutions sum in different orders, so those floats are compared within
1e-5 (the fp32 forward agrees to 1e-4, tests/test_torch_resnet.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import state as jgostate
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.models.resnet import apply_fn, init_params
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.selfplay.actor import ActorConfig as JActorConfig
from elf_tpu.selfplay.actor import SelfplayActor as JSelfplayActor
from elf_tpu_torch.env.go import state as tgostate
from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.models.resnet import (
    ModelConfig,
    build_model,
    eval_fn_builder,
    params_from_jax,
)
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

pytestmark = pytest.mark.timeout(300)

SIZE, B, PLIES, OPENING = 9, 4, 12, 3
ACTOR = dict(board_size=SIZE, batch=B, policy_distri_cutoff=-1,
             never_resign_prob=1.0, move_cutoff=PLIES,
             policy_distri_training_for_all=True)
SEARCH = dict(num_rollouts=16, rollouts_per_batch=4, rotation_flip=False,
              root_epsilon=0.0)


def _weights():
    """flax-initialized weights with non-trivial BN statistics, as numpy."""
    cfg = JModelConfig(board_size=SIZE, num_block=2, dim=32, use_bf16=False)
    params, stats = init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)

    def perturb(path, a):
        name = path[-1].key
        a = np.asarray(a, np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    stats = jax.tree_util.tree_map_with_path(perturb, stats)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return cfg, params, stats


def _record_json(r):
    d = r.to_json()
    d.pop("timestamp")
    values = d["result"].pop("values")
    return d, values


def test_port_actor_matches_jax_actor():
    jcfg, params, stats = _weights()
    fwd = apply_fn(jcfg)
    jactor = JSelfplayActor(
        JActorConfig(**ACTOR), JMCTSConfig(**SEARCH),
        lambda p, s: (lambda feats, to_play: fwd(p, s, feats)), seed=0,
    )
    net = params_from_jax(
        params, stats,
        ModelConfig(board_size=SIZE, num_block=2, dim=32, use_bf16=False),
        device="cpu",
    )
    tactor = SelfplayActor(ActorConfig(**ACTOR), MCTSConfig(**SEARCH),
                           eval_fn_builder, seed=0, device="cpu")
    # noise-free argmax play would repeat one game on every board: open
    # each board with its own random legal plies, in both actors
    rng = np.random.default_rng(5)
    for _ in range(OPENING):
        legal = tgostate.legal_moves(tactor.state, SIZE).numpy()[:, :-1]
        a = np.array([rng.choice(np.nonzero(m)[0]) for m in legal], np.int32)
        tactor.state, _ = tgostate.step(tactor.state, torch.from_numpy(a),
                                        SIZE)
        jactor.state, _ = jgostate.step(jactor.state, jnp.asarray(a), SIZE)

    for ply in range(PLIES - 1):
        jrec = jactor.play_moves(params, stats, 1)
        trec = tactor.play_moves(net, None, 1)
        assert jrec == [] and trec == []
        assert tactor.moves == jactor.moves, f"actions differ at ply {ply}"
        for b in range(B):
            np.testing.assert_allclose(
                np.stack(tactor.policies[b]), np.stack(jactor.policies[b]),
                atol=1e-6, rtol=0, err_msg=f"mcts_policy board {b} ply {ply}")
            np.testing.assert_allclose(tactor.values[b], jactor.values[b],
                                       atol=1e-5, rtol=0)

    jrec = jactor.play_moves(params, stats, 1)
    trec = tactor.play_moves(net, None, 1)
    assert len(trec) == len(jrec) == B
    for t, j in zip(trec, jrec):
        (td, tv), (jd, jv) = _record_json(t), _record_json(j)
        assert td == jd
        assert t.result.num_move == PLIES
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
        # wire compatibility: each package's record JSON loads in the other
        # and serializes back unchanged
        t_json = json.loads(json.dumps(t.to_json()))
        j_json = json.loads(json.dumps(j.to_json()))
        assert type(t).from_json(j_json).to_json() == j_json
        assert type(j).from_json(t_json).to_json() == t_json


def test_entry_points_default_to_cuda():
    """Without a card, every entry point refuses its default device; the
    CPU runs only when asked for by name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    small = ModelConfig(board_size=SIZE, num_block=1, dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfplayActor(ActorConfig(**ACTOR), MCTSConfig(**SEARCH),
                      eval_fn_builder)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(small)
    _, params, stats = _weights()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(params, stats, ModelConfig(
            board_size=SIZE, num_block=2, dim=32, use_bf16=False))
    st = tgostate.init_state(1, SIZE, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mcts(st.core, st.stone_hist, st.hist_len, None,
                 torch.Generator(), MCTSConfig(**SEARCH), SIZE)
    assert build_model(small, device="cpu").init_conv.weight.device.type == "cpu"


@pytest.mark.parametrize("option", [
    dict(batched_writes="on"), dict(feature_set="df"), dict(eval_chunk=8),
    dict(max_batches_per_call=2),
])
def test_unported_search_options_raise(option):
    """The production search options and df features build an actor whose
    moves replay legally (tests/test_torch_search_options.py and
    tests/test_torch_df.py hold them against the JAX package)."""
    actor = SelfplayActor(
        ActorConfig(**{**ACTOR, "batch": 2, "move_cutoff": 2}),
        MCTSConfig(**SEARCH, **option), eval_fn_builder, device="cpu")
    planes = 25 if option.get("feature_set") == "df" else 18
    net = build_model(ModelConfig(board_size=SIZE, num_block=1, dim=8,
                                  num_planes=planes), device="cpu")
    records = actor.play_moves(net, None, 2)
    assert len(records) == 2
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves

    moves = [sgf_string_to_moves(r.result.content, SIZE) for r in records]
    st = tgostate.init_state(2, SIZE, "cpu")
    for i in range(2):
        st, info = tgostate.step(
            st, torch.tensor([m[i] for m in moves], dtype=torch.int32), SIZE)
        assert not bool(info.illegal.any())


@pytest.mark.parametrize("option", [
    dict(persistent_tree=True), dict(preload_sgf="game.sgf"),
    dict(dump_record_prefix="games/g"),
])
def test_unported_actor_options_raise(option, tmp_path, monkeypatch):
    """The play surface's actor options (persistent trees, SGF preload, SGF
    dumps) build an actor that plays; tests/test_torch_play.py holds them
    against the JAX actor."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "game.sgf").write_text(f"(;SZ[{SIZE}];B[ee];W[cc])")
    (tmp_path / "games").mkdir()
    actor = SelfplayActor(
        ActorConfig(**{**ACTOR, "batch": 2, "move_cutoff": 1, **option}),
        MCTSConfig(**SEARCH), eval_fn_builder, device="cpu")
    net = build_model(ModelConfig(board_size=SIZE, num_block=1, dim=8),
                      device="cpu")
    records = actor.play_moves(net, None, 1)
    assert len(records) == 2
    if "preload_sgf" in option:
        assert int(actor._fresh_state.core.ply[0]) == 2
    if "persistent_tree" in option:
        assert actor.tree is not None
    if "dump_record_prefix" in option:
        assert len(list((tmp_path / "games").iterdir())) == 2


@pytest.mark.parametrize("option", ["remat", "mesh", "feature_set=df",
                                    "train_mode=offline"])
def test_unported_learner_options_raise(option, tmp_path):
    """`remat`, df batches, the offline train mode and the mesh are ported
    (tests/test_torch_remat.py, tests/test_torch_df.py,
    tests/test_torch_offline.py, tests/test_torch_parallel.py): a remat net
    and a df pipeline build, an offline runner takes a supervised step, and
    a runner on the 1 x 1 mesh takes the plain step."""
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner
    from elf_tpu_torch.training.trainer import Trainer

    small = dict(board_size=SIZE, num_block=1, dim=8)
    replay = ReplayBuffer(ReplayOptions(num_reader=2))
    if option == "remat":
        net = build_model(ModelConfig(**small, remat=True), device="cpu")
        assert net.cfg.remat
        return
    if option == "feature_set=df":
        assert TrainingPipeline(replay, SIZE, feature_set="df").feature_set \
            == "df"
        return
    trainer = Trainer(ModelConfig(**small), TrainOptions(batchsize=4),
                      device="cpu")
    if option == "train_mode=offline":
        from elf_tpu_torch.training.offline import record_from_sgf

        pipeline = TrainingPipeline(
            ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1)), SIZE)
        for text in ("(;SZ[9]RE[B+1];B[ee];W[cc];B[gg])",
                     "(;SZ[9]RE[W+1];B[cg];W[ec])"):
            pipeline.insert_record(record_from_sgf(text))
        runner = LearnerRunner(trainer, pipeline, str(tmp_path),
                               trainer.opts, train_mode="offline")
        stats = runner.run_minibatch()
        assert "acc/top1" in stats and runner.version() == 1
        return
    from elf_tpu_torch.parallel import make_mesh

    runner = LearnerRunner(trainer, TrainingPipeline(replay, SIZE),
                           str(tmp_path), trainer.opts, mesh=make_mesh(1))
    assert runner.sync is None and runner.save_enabled
    feats = torch.zeros((4, SIZE, SIZE, 18))
    pi = torch.full((4, SIZE * SIZE + 1), 1.0 / (SIZE * SIZE + 1))
    runner.state, stats = runner._train_step(runner.state, feats, pi,
                                             torch.ones(4))
    assert runner.version() == 1 and "loss/total" in stats


def test_policy_quantization_matches_jax():
    from elf_tpu.selfplay import records as jrec
    from elf_tpu_torch.selfplay import records as trec

    rng = np.random.default_rng(0)
    pis = [None, np.zeros(82, np.float32)]
    pis += [rng.dirichlet(np.full(82, a)).astype(np.float32)
            for a in (0.03, 0.3, 3.0)]
    for pi in pis:
        q = trec.quantize_policy(pi)
        assert q == jrec.quantize_policy(pi)
        np.testing.assert_array_equal(trec.dequantize_policy(q, 82),
                                      jrec.dequantize_policy(q, 82))
