"""The df-25 feature set in the port against the JAX package.

 - `analyze_libs3` and the 25 planes (`extract_df_parts`, `extract_df`) on
   seeded and hypothesis-drawn boards: lib_min / lib_max / lib_min2 equal
   (and lib_min / lib_max equal to `analyze_libs`), the binary and distance
   planes exact, the exp-decayed history planes within 1e-6 (XLA's and
   torch's `exp` may differ in the last bit);
 - `_leaf_last_placed` on a searched tree, exactly;
 - a df search, the lockstep actor (search and raw policy) and a 5x5 GTP
   transcript against the JAX ones, under an evaluator that reads the
   stone planes and the history planes thresholded at 0.5 (placed within
   the last six moves), so every prior and value is exact in float32 and a
   wrong placement ply shows;
 - df training batches (`HostBatch` df fields and their planes) against
   the JAX pipeline's;
 - `make_trainer("df_kl", use_df_feature=True)` builds a 25-plane net that
   trains.
The golden upstream df probes are in tests/test_torch_golden.py."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from elf_tpu.console.gtp import GtpConsole as JGtpConsole
from elf_tpu.console.gtp import GtpEngine as JGtpEngine
from elf_tpu.env.go import engine as jengine
from elf_tpu.env.go import features as jfeatures
from elf_tpu.search import mcts as jmcts
from elf_tpu.selfplay.actor import ActorConfig as JActorConfig
from elf_tpu.selfplay.actor import SelfplayActor as JSelfplayActor
from elf_tpu.training import pipeline as jpipeline
from elf_tpu.training import replay as jreplay_mod
from elf_tpu.config import ReplayOptions as JReplayOptions
from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.console.gtp import GtpConsole, GtpEngine
from elf_tpu_torch.env.go import engine, features
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.models.registry import make_trainer
from elf_tpu_torch.search import mcts
from elf_tpu_torch.selfplay import records as trecords
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
from elf_tpu_torch.training import pipeline as tpipeline
from elf_tpu_torch.training import replay as treplay_mod
from elf_tpu.selfplay import records as jrecords
from tests.test_torch_pipeline import _records
from tests.test_torch_tree_reuse import (
    assert_trees_equal,
    jax_numpy,
    state_pair,
    to_torch,
)

pytestmark = pytest.mark.timeout(600)

EXP_PLANES = (10, 11)


def random_parts(rng, B, size, density=0.6):
    """Seeded df inputs: boards, movers, ko points, plies and placement
    plies no later than the ply."""
    n2 = size * size
    stones = rng.choice([0, 1, 2], p=[1 - density, density / 2, density / 2],
                        size=(B, n2)).astype(np.int8)
    to_play = rng.choice([1, 2], size=B).astype(np.int8)
    ko_point = rng.integers(-1, n2, size=B).astype(np.int32)
    ko_active = rng.random(B) < 0.5
    ply = rng.integers(0, 300, size=B).astype(np.int32)
    last_placed = (rng.random((B, n2)) * (ply[:, None] + 1)).astype(np.int32)
    codes = rng.integers(0, 8, size=B).astype(np.int32)
    return stones, to_play, ko_point, ko_active, ply, last_placed, codes


def assert_planes_match(t, j, what=""):
    assert t.shape == j.shape, what
    exact = [k for k in range(t.shape[-1]) if k not in EXP_PLANES]
    np.testing.assert_array_equal(t[..., exact], j[..., exact], err_msg=what)
    np.testing.assert_allclose(t[..., EXP_PLANES], j[..., EXP_PLANES],
                               atol=1e-6, rtol=0, err_msg=what)


def check_parts(parts, size):
    B = parts[0].shape[0]
    s2d = parts[0].reshape(B, size, size)
    j3 = [np.asarray(a) for a in jengine.analyze_libs3(jnp.asarray(s2d), size)]
    t3 = [a.numpy() for a in engine.analyze_libs3(torch.from_numpy(s2d), size)]
    for name, a, b in zip(("lib_min", "lib_max", "lib_min2"), t3, j3):
        np.testing.assert_array_equal(a, b, err_msg=name)
    lm, lx = engine.analyze_libs(torch.from_numpy(s2d), size)
    np.testing.assert_array_equal(lm.numpy(), t3[0])
    np.testing.assert_array_equal(lx.numpy(), t3[1])
    j = np.asarray(jfeatures.extract_df_parts(
        *(jnp.asarray(a) for a in parts), size))
    t = features.extract_df_parts(*(torch.from_numpy(a) for a in parts), size)
    assert t.dtype == torch.float32
    assert tuple(t.shape) == (B, size, size, features.NUM_DF_PLANES)
    assert_planes_match(t.numpy(), j, f"size {size}")
    return t3


@pytest.mark.parametrize("size", [5, 9, 19])
def test_df_planes_match_jax_seeded(size):
    rng = np.random.default_rng(size)
    _, _, m2 = check_parts(random_parts(rng, 24, size), size)
    # the boards hold chains of 1, 2 and more liberties
    assert (m2 < engine.INF).any() and (m2 == engine.INF).any()


@settings(max_examples=10, deadline=None, derandomize=True)
@given(size=st.sampled_from([5, 9, 19]), density=st.floats(0.1, 0.95),
       seed=st.integers(0, 2**31 - 1))
def test_df_planes_match_jax_drawn(size, density, seed):
    check_parts(random_parts(np.random.default_rng(seed), 6, size, density),
                size)


def test_extract_df_of_a_played_game_matches_jax():
    js, ts = state_pair(seed=4, plies=14)
    for code in range(8):
        codes = np.full(2, code, np.int32)
        j = np.asarray(jfeatures.extract_df(js, jnp.asarray(codes), 9))
        t = features.extract_df(ts, torch.from_numpy(codes), 9).numpy()
        assert_planes_match(t, j, f"d4 {code}")


def test_distance_transform_is_the_l1_distance():
    rng = np.random.default_rng(0)
    src = rng.random((3, 7, 7)) < 0.1
    src[2] = False                                   # no source at all
    d = features._distance_transform_l1(
        torch.where(torch.from_numpy(src), 0.0, 10_000.0)).numpy()
    r, c = np.indices((7, 7))
    for b in range(3):
        pts = np.argwhere(src[b])
        want = np.full((7, 7), 10_000.0)
        for pr, pc in pts:
            want = np.minimum(want, np.abs(r - pr) + np.abs(c - pc))
        np.testing.assert_array_equal(d[b], want)


# ---------------------------------------------------------------------------
# search, actor and console
# ---------------------------------------------------------------------------


def df_eval(xp, where, size):
    """Equal priors on one action in eight, value (stones + stones placed
    within the last six moves, black minus white) / 16: exact in float32."""
    n2 = size * size
    A = n2 + 1
    favored = (np.arange(A) * 37 + 13) % 8 == 0
    log_pi = xp.asarray(np.where(favored, 0.0, -1e4).astype(np.float32))

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        f = feats.reshape(K, n2, 25)
        mine = (f[..., 7] + (f[..., 10] > 0.5)).sum(-1)
        theirs = (f[..., 8] + (f[..., 11] > 0.5)).sum(-1)
        b = where(to_play == 1, mine, theirs)
        w = where(to_play == 1, theirs, mine)
        return (xp.broadcast_to(log_pi[None, :], (K, A)),
                xp.clip((b - w) / 16.0, -1.0, 1.0))

    return eval_fn


def _df_search_pair(**over):
    kw = dict(num_rollouts=32, rollouts_per_batch=4, rotation_flip=False,
              feature_set="df", **over)
    js, ts = state_pair(seed=2, plies=10)
    jeval = df_eval(jnp, jnp.where, 9)
    jcfg = jmcts.MCTSConfig(**kw)
    jres, jtree = jax.jit(lambda core, hist, hlen, hl, hh, nh, lp:
                          jmcts.run_mcts(core, hist, hlen, jeval,
                                         jax.random.PRNGKey(0), jcfg, 9,
                                         game_hash_hist=(hl, hh, nh),
                                         root_last_placed=lp))(
        js.core, js.stone_hist, js.hist_len, js.hash_hist_lo,
        js.hash_hist_hi, js.nhash, js.last_placed)
    tres, ttree = mcts.run_mcts(
        ts.core, ts.stone_hist, ts.hist_len, df_eval(torch, torch.where, 9),
        torch.Generator().manual_seed(0), mcts.MCTSConfig(**kw), 9,
        game_hash_hist=(ts.hash_hist_lo, ts.hash_hist_hi, ts.nhash),
        root_last_placed=ts.last_placed, device="cpu")
    return js, jres, jtree, ts, tres, ttree


@pytest.mark.parametrize("eval_chunk", [0, 4])
def test_df_search_matches_jax(eval_chunk):
    _, jres, jtree, _, tres, ttree = _df_search_pair(eval_chunk=eval_chunk)
    assert_trees_equal(ttree, jtree, f"df eval_chunk={eval_chunk}")
    np.testing.assert_array_equal(tres.best_action.numpy(),
                                  np.asarray(jres.best_action))
    np.testing.assert_array_equal(tres.mcts_policy.numpy(),
                                  np.asarray(jres.mcts_policy))
    np.testing.assert_array_equal(tres.root_value.numpy(),
                                  np.asarray(jres.root_value))


def test_leaf_last_placed_matches_jax():
    js, _, jtree, ts, _, ttree = _df_search_pair()
    B, N = ttree.stones.shape[:2]
    rows = np.repeat(np.arange(B), N).astype(np.int32)
    leaf = np.tile(np.arange(N), B).astype(np.int32)
    j = np.asarray(jmcts._leaf_last_placed(
        jtree, jnp.asarray(rows), jnp.asarray(leaf), js.last_placed, 9))
    t = mcts._leaf_last_placed(ttree, torch.from_numpy(rows).long(),
                               torch.from_numpy(leaf).long(),
                               ts.last_placed, 9).numpy()
    np.testing.assert_array_equal(t, j)
    # deep nodes carry placements made inside the tree
    assert (t > np.repeat(ts.last_placed.numpy(), N, axis=0)).any()


@pytest.mark.parametrize("rollouts", [16, 0])
def test_df_actor_matches_jax(rollouts):
    size = 9
    acfg = dict(board_size=size, batch=2, policy_distri_cutoff=-1,
                never_resign_prob=1.0, move_cutoff=12)
    kw = dict(num_rollouts=rollouts, rollouts_per_batch=4,
              rotation_flip=False, feature_set="df")
    jactor = JSelfplayActor(JActorConfig(**acfg), jmcts.MCTSConfig(**kw),
                            lambda p, b: df_eval(jnp, jnp.where, size))
    tactor = SelfplayActor(ActorConfig(**acfg), mcts.MCTSConfig(**kw),
                           lambda p, b: df_eval(torch, torch.where, size),
                           device="cpu")
    jrecs = jactor.play_moves(None, None, 12)
    trecs = tactor.play_moves(None, None, 12)
    assert len(trecs) == len(jrecs) == 2
    for j, t in zip(jrecs, trecs):
        assert t.result.content == j.result.content
        assert t.result.values == j.result.values
        assert t.result.policies == j.result.policies


def test_df_gtp_transcript_matches_jax():
    script = ("boardsize 5\nclear_board\nkomi 0.5\nplay B C3\ngenmove W\n"
              "play B B2\ngenmove W\ngenmove B\nundo\ngenmove B\nshowboard\n"
              "final_score\n")
    kw = dict(num_rollouts=16, rollouts_per_batch=4, rotation_flip=False,
              remove_pass_if_dangerous=False, feature_set="df")
    common = dict(size=5, komi=7.5, seed=3, persistent_tree=True)
    jeng = JGtpEngine(lambda p, b: df_eval(jnp, jnp.where, 5),
                      jmcts.MCTSConfig(**kw), **common)
    teng = GtpEngine(lambda p, b: df_eval(torch, torch.where, 5),
                     mcts.MCTSConfig(**kw), **common, device="cpu")
    jeng.set_model(None, None)
    teng.set_model(None, None)
    jout, tout = io.StringIO(), io.StringIO()
    JGtpConsole(jeng).run(stdin=io.StringIO(script), stdout=jout)
    GtpConsole(teng).run(stdin=io.StringIO(script), stdout=tout)
    assert tout.getvalue() == jout.getvalue()
    assert "?" not in tout.getvalue()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,data_aug", [(9, -1), (19, 3)])
def test_df_batches_match_jax(size, data_aug):
    jp = jpipeline.TrainingPipeline(
        jreplay_mod.ReplayBuffer(JReplayOptions(num_reader=2, q_min_size=1,
                                                q_max_size=50), seed=3),
        size, seed=4, data_aug=data_aug, num_future_actions=2,
        feature_set="df")
    tp = tpipeline.TrainingPipeline(
        treplay_mod.ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                               q_max_size=50), seed=3),
        size, seed=4, data_aug=data_aug, num_future_actions=2,
        feature_set="df")
    for jr, tr in zip(_records(jrecords, size), _records(trecords, size)):
        jp.insert_record(jr)
        tp.insert_record(tr)
    for _ in range(2):
        jhb, thb = jp.sample_host_batch(16), tp.sample_host_batch(16)
        for name in thb._fields:
            a, b = getattr(thb, name), getattr(jhb, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        zero = tp.zero_host_batch(16)
        assert [(a.dtype, a.shape) for a in zero] == \
            [(a.dtype, a.shape) for a in thb]
        jf, jpi, jw = jp.device_batch(jhb)
        tf, tpi, tw = tp.device_batch(thb, device="cpu")
        assert tuple(tf.shape) == (16, size, size, 25)
        assert_planes_match(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        jf, ja, _ = jp.device_batch_offline(jhb)
        tf, ta, _ = tp.device_batch_offline(thb, device="cpu")
        assert_planes_match(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (thb.ko_point >= -1).all() and (thb.ply > 0).any()


def test_df_trainer_trains_on_df_batches():
    to = TrainOptions(num_block=1, dim=8, bf16=False, batchsize=8, lr=0.05)
    trainer, mode, fs = make_trainer("df_kl", 9, to, use_df_feature=True,
                                     device="cpu")
    assert (mode, fs, trainer.cfg.num_planes) == ("mcts", "df", 25)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    assert state.net.init_conv.weight.shape[1] == 25
    tp = tpipeline.TrainingPipeline(
        treplay_mod.ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                               q_max_size=50), seed=3),
        9, seed=4, feature_set="df")
    for r in _records(trecords, 9):
        tp.insert_record(r)
    batch = tp.device_batch(tp.sample_host_batch(8), device="cpu")
    step = trainer.make_train_step()
    losses = [float(step(state, *batch)[1]["loss/total"]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
