"""The search options of the production self-play configuration in the
port: `eval_chunk`, `batched_writes` and the actor's host-chunked search
(`max_batches_per_call`).

 - `eval_chunk` on and off give the same tree, field by field, bit for bit
   (the D4 codes are drawn for the whole simulation batch first), and the
   chunked search equals the JAX search with the same `eval_chunk` under
   an evaluator whose priors and values are exact in float32 (the
   first-play-urgency mean within 1e-6, as tests/test_torch_tree_reuse.py
   holds it);
 - every `batched_writes` value reproduces the golden reference search
   (tests/golden/ref_mcts_9) and the JAX search with the same value, as
   tests/test_golden_mcts.py pins both JAX write paths;
 - a move searched in calls of `max_batches_per_call` batches equals one
   searched in one call, with a white rollout budget that a wrong batch
   offset would change, and chunked self-play games replay legally (the
   twin of tests/test_actor.py's chunked games)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.search import mcts as jmcts
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.models.resnet import ModelConfig, build_model, eval_fn_builder
from elf_tpu_torch.search import mcts
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
from elf_tpu_torch.selfplay.records import TSOptions
from tests.test_torch_golden import _load, _make_eval_fn, _play_prefix
from tests.test_torch_tree_reuse import (
    Pair,
    assert_results_close,
    assert_trees_equal,
)

pytestmark = pytest.mark.timeout(300)

SIZE = 9


def _search(pair, cfg, capacity=40):
    """The port's search with `cfg` from a fresh tree on the pair's boards,
    with a fresh generator of seed 0."""
    ts = pair.ts
    tree = mcts.fresh_tree(2, SIZE, capacity, ts.core)
    return mcts.run_mcts(
        ts.core, ts.stone_hist, ts.hist_len, pair.teval,
        torch.Generator().manual_seed(0), cfg, SIZE, init_tree=tree,
        game_hash_hist=(ts.hash_hist_lo, ts.hash_hist_hi, ts.nhash),
        device="cpu")


@pytest.mark.parametrize("rotation_flip", [False, True])
@pytest.mark.parametrize("eval_chunk", [2, 4, 3])
def test_eval_chunk_gives_the_unchunked_tree(eval_chunk, rotation_flip):
    """m * B = 8 leaves per batch: chunks of 2 and 4 split the forward,
    3 does not divide it and leaves one forward, as in the JAX search."""
    pair = Pair()
    cfg = dataclasses.replace(pair.tcfg, rotation_flip=rotation_flip)
    calls = []
    plain = pair.teval

    def counting(feats, to_play):
        calls.append(feats.shape[0])
        return plain(feats, to_play)

    pair.teval = counting
    res_c, tree_c = _search(pair, dataclasses.replace(cfg,
                                                      eval_chunk=eval_chunk))
    chunk_calls, calls[:] = list(calls), []
    res_u, tree_u = _search(pair, cfg)
    # the two fresh roots, then 8 batches of 8 leaves
    assert calls == [2] + [8] * 8
    if 8 % eval_chunk == 0:
        assert chunk_calls == [2] + [eval_chunk] * (8 * 8 // eval_chunk)
    else:
        assert chunk_calls == calls
    for name in mcts.Tree._fields:
        assert torch.equal(getattr(tree_c, name), getattr(tree_u, name)), name
    for a, b in zip(res_c, res_u):
        assert torch.equal(a, b)


def test_eval_chunk_matches_jax():
    pair = Pair(eval_chunk=4)
    jtree, ttree = pair.fresh(40)
    jres, jtree, tres, ttree = pair.search(jtree, ttree)
    assert_trees_equal(ttree, jtree, "eval_chunk=4")
    assert_results_close(jres, tres, ttree, jtree)


@pytest.mark.parametrize("batched_writes", ["on", "off", "auto"])
def test_batched_writes_match_golden_and_jax(batched_writes):
    """Twin of tests/test_golden_mcts.py's both-write-paths case: the first
    golden 9x9 config with 8 rollouts per batch."""
    size = 9
    g = [g for g in _load("ref_mcts_9.jsonl.gz")
         if int(g.get("per_batch", 1)) > 1][0]
    kw = dict(num_rollouts=g["rollouts"], rollouts_per_batch=int(g["per_batch"]),
              c_puct=g["c_puct"], virtual_loss=int(g["vl"]), root_epsilon=0.0,
              komi=7.5, rotation_flip=False, unexplored_q_zero=bool(g["uqz"]),
              root_unexplored_q_zero=bool(g["ruqz"]),
              batched_writes=batched_writes)
    st = _play_prefix(g["prefix"], size)
    res, tree = mcts.run_mcts(
        st.core, st.stone_hist, st.hist_len, _make_eval_fn(size),
        torch.Generator().manual_seed(0), mcts.MCTSConfig(**kw), size,
        game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi, st.nhash),
        device="cpu")
    child = tree.child[0, 0].long()
    ours_n = torch.where(child >= 0, tree.n[0, child.clamp(min=0)], 0).numpy()
    ref_n = np.zeros(size * size + 1, np.int64)
    for e in g["edges"]:
        ref_n[e["a"]] = e["n"]
    np.testing.assert_array_equal(ours_n, ref_n)

    from elf_tpu.env.go import state as jstate
    from tests.test_golden_mcts import _make_eval_fn as jeval_fn
    from tests.test_golden_mcts import _play_prefix as jprefix

    js = jprefix(g["prefix"], size)
    jres, jtree = jax.jit(lambda core, hist, hlen, hl, hh, nh: jmcts.run_mcts(
        core, hist, hlen, jeval_fn(size), jax.random.PRNGKey(0),
        jmcts.MCTSConfig(**kw), size, game_hash_hist=(hl, hh, nh)))(
        js.core, js.stone_hist, js.hist_len, js.hash_hist_lo,
        js.hash_hist_hi, js.nhash)
    assert isinstance(js, jstate.GoState)
    np.testing.assert_array_equal(ours_n, np.asarray(jtree.n_edge)[0, 0])
    assert int(res.best_action[0]) == int(jres.best_action[0])
    np.testing.assert_allclose(res.root_q.numpy(), np.asarray(jres.root_q),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the actor's host-chunked search
# ---------------------------------------------------------------------------

ACTOR = dict(board_size=SIZE, batch=4, policy_distri_cutoff=4,
             never_resign_prob=1.0, move_cutoff=6)
# black 16 rollouts (4 batches), white 32 (8 batches): a chunk that restarted
# the batch count would give black 8 batches
SEARCH = dict(num_rollouts=16, white_num_rollouts=32, rollouts_per_batch=4,
              root_epsilon=0.25, root_alpha=0.3)


def _actor(**search):
    return SelfplayActor(ActorConfig(**ACTOR),
                         mcts.MCTSConfig(**{**SEARCH, **search}),
                         eval_fn_builder, seed=5, device="cpu")


def test_chunked_move_equals_one_call(monkeypatch):
    finalize = mcts.mcts_finalize
    net = build_model(ModelConfig(board_size=SIZE, num_block=1, dim=8,
                                  use_bf16=False), device="cpu", seed=2)
    whole, chunked = _actor(), _actor(max_batches_per_call=2)
    roots = []

    def spy(tree, gen, cfg):
        child = tree.child[:, 0].long()
        rows = torch.arange(child.shape[0])[:, None]
        n = torch.where(child >= 0, tree.n[rows, child.clamp(min=0)], 0)
        roots.append((tree.to_play[:, 0].clone(), n.sum(dim=1)))
        return finalize(tree, gen, cfg)

    monkeypatch.setattr(mcts, "mcts_finalize", spy)
    for _ in range(3):
        assert whole.play_moves(net, None, 1) == []
        assert chunked.play_moves(net, None, 1) == []
        assert len(whole.simulate_s) == 1
        assert len(chunked.simulate_s) == 4      # 8 batches in calls of 2
        assert torch.equal(whole.state.core.stones, chunked.state.core.stones)
        assert whole.moves == chunked.moves
        assert whole.values == chunked.values
        for a, b in zip(whole.policies, chunked.policies):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q)
    # every search spent its player's budget: 16 visits for black to move,
    # 32 for white, in the chunked searches as in the whole ones
    assert len(roots) == 6
    for to_play, visits in roots:
        want = torch.where(to_play == 1, 16, 32)
        assert torch.equal(visits, want.to(visits.dtype)), (to_play, visits)


@pytest.mark.parametrize("persistent", [False, True])
def test_chunked_search_games_are_legal(persistent):
    """Twin of tests/test_actor.py::test_chunked_search_games_are_legal:
    5x5, 6 batches in calls of 2, games to the end, replayed on a fresh
    engine."""
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves

    size = 5

    def uniform(params, batch_stats):
        def eval_fn(feats, to_play):
            K = feats.shape[0]
            return (torch.full((K, 26), -float(np.log(26))),
                    torch.zeros((K,)))
        return eval_fn

    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=2, komi=7.5,
                    policy_distri_cutoff=6, resign_thres=0.0,
                    never_resign_prob=1.0, persistent_tree=persistent),
        mcts.MCTSConfig(num_rollouts=12, rollouts_per_batch=2,
                        rotation_flip=False, root_epsilon=0.25,
                        root_alpha=0.5, max_batches_per_call=2),
        uniform, seed=3, device="cpu")
    records = []
    for _ in range(14):
        records.extend(actor.play_moves(None, None, 4))
        assert len(actor.simulate_s) == 3
        if records:
            break
    assert records
    for r in records:
        moves = sgf_string_to_moves(r.result.content, size)
        st = gostate.init_state(1, size, "cpu")
        for mv in moves:
            st, info = gostate.step(
                st, torch.tensor([mv], dtype=torch.int32), size)
            assert not bool(info.illegal[0]), moves


def test_server_options_keep_the_production_search_options():
    """A server's TSOptions set the budget and noise; the client's own
    `eval_chunk`, `max_batches_per_call` and `batched_writes` stay, and the
    search runs with them."""
    actor = _actor(max_batches_per_call=3, eval_chunk=8, batched_writes="on")
    ts = TSOptions(num_threads=1, num_rollouts_per_thread=24,
                   num_rollouts_per_batch=4, persistent_tree=False)
    assert actor.apply_ts_options(ts)
    cfg = actor.mcts_cfg
    assert (cfg.num_rollouts, cfg.max_batches_per_call, cfg.eval_chunk,
            cfg.batched_writes) == (24, 3, 8, "on")
    net = build_model(ModelConfig(board_size=SIZE, num_block=1, dim=8,
                                  use_bf16=False), device="cpu")
    actor.play_moves(net, None, 1)
    assert len(actor.simulate_s) == 3      # 8 white batches in 3, 3, 2
    with pytest.raises(ValueError):
        _actor(batched_writes="sometimes")
