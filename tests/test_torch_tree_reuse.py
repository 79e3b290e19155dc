"""Search-tree reuse in the port against the JAX package: `fresh_tree`,
`advance_tree` (onto a visited child, an unvisited action and a pass),
`reset_tree_where` and `run_mcts(init_tree=...)`.

Trees are compared field by field, exactly, after the same searches on the
same boards (9x9, B = 2, no random symmetry, no root noise).  The evaluator
gives one legal move in eight the same prior, the rest zero, and a value of (black - white
stones) / 16, so every prior, value and visit sum is exact in float32 and
both packages must store the same bits.  The one exception is the
first-play-urgency mean (`umean_q`, and `uparent_q` copied from it): a sum
of per-edge means w / n over all actions, which XLA and torch reduce in
different orders, so it may differ in the last bit (held within 1e-6).  The searches from a reused tree
are also held against the JAX search with the golden pseudo-NN (fixed
priors), as `test_torch_search.py` does: visits and best actions exactly,
root Q and the visit distribution within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import state as jstate
from elf_tpu.env.go.engine import BLACK as JBLACK
from elf_tpu.search import mcts as jmcts
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.search import mcts

pytestmark = pytest.mark.timeout(300)

SIZE = 9
A = SIZE * SIZE + 1


def dyadic_eval(xp, where, black):
    """Equal priors on one action in eight (zero on the rest, so the search
    goes deep), value (black - white stones) / 16: exact in float32."""
    n2 = SIZE * SIZE
    favored = (np.arange(A) * 37 + 13) % 8 == 0
    log_prior = xp.asarray(np.where(favored, 0.0, -1e4).astype(np.float32))

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(-1)
        theirs = feats[..., 1].reshape(K, n2).sum(-1)
        b = where(to_play == black, mine, theirs)
        w = where(to_play == black, theirs, mine)
        return (xp.broadcast_to(log_prior[None, :], (K, n2 + 1)),
                xp.clip((b - w) / 16.0, -1.0, 1.0))

    return eval_fn


def golden_eval(xp, where, black):
    """The golden pseudo-NN of `test_torch_search.py`."""
    n2 = SIZE * SIZE
    perm = (np.arange(A, dtype=np.int64) * 37 + 13) % A
    raw = ((1.0 + (perm % 64) / 64.0) * np.exp2(perm // 64)).astype(np.float32)
    log_prior = xp.log(xp.asarray(raw))

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(-1)
        theirs = feats[..., 1].reshape(K, n2).sum(-1)
        b = where(to_play == black, mine, theirs)
        w = where(to_play == black, theirs, mine)
        return (xp.broadcast_to(log_prior[None, :], (K, n2 + 1)),
                xp.clip((b - w) * 0.05, -1.0, 1.0))

    return eval_fn


EVALS = {"dyadic": dyadic_eval, "golden": golden_eval}


def to_torch(x):
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def jax_numpy(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def state_pair(seed: int = 1, plies: int = 6):
    """One black-to-move and one white-to-move (handicap) 9x9 board after
    `plies` random legal moves, as (JAX state, port state)."""
    rng = np.random.default_rng(seed)
    boards = [jstate.init_state(1, SIZE),
              jstate.apply_handicap(jstate.init_state(1, SIZE), 2, SIZE)]
    for _ in range(plies):
        for i, st in enumerate(boards):
            legal = np.nonzero(np.asarray(jstate.legal_moves(st, SIZE))[0, :-1])[0]
            boards[i], _ = jstate.step(
                st, jnp.asarray([rng.choice(legal)], jnp.int32), SIZE)
    js = jax.tree.map(lambda *xs: jnp.concatenate(xs), *boards)
    ts = gostate.GoState(*[
        type(f)(*map(to_torch, f)) if isinstance(f, tuple) else to_torch(f)
        for f in js
    ])
    return js, ts


def assert_trees_equal(ttree, jtree, where=""):
    for name in mcts.Tree._fields:
        t, j = to_numpy(getattr(ttree, name)), jax_numpy(getattr(jtree, name))
        if name in ("umean_q", "uparent_q"):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6,
                                       err_msg=f"Tree.{name} {where}")
        else:
            np.testing.assert_array_equal(t, j, err_msg=f"Tree.{name} {where}")


class Pair:
    """The same search configuration in both packages, over one pair of
    game states that the test steps in both."""

    def __init__(self, evaluator="dyadic", **cfg):
        kw = dict(num_rollouts=32, rollouts_per_batch=4, rotation_flip=False,
                  **cfg)
        self.jcfg = jmcts.MCTSConfig(**kw)
        self.tcfg = mcts.MCTSConfig(**kw)
        jeval = EVALS[evaluator](jnp, jnp.where, JBLACK)
        self.teval = EVALS[evaluator](torch, torch.where, BLACK)
        self.js, self.ts = state_pair()
        self.gen = torch.Generator().manual_seed(0)
        self.key = jax.random.PRNGKey(0)
        jcfg = self.jcfg

        def search(core, hist, hlen, hl, hh, nh, tree, key):
            return jmcts.run_mcts(core, hist, hlen, jeval, key, jcfg, SIZE,
                                  init_tree=tree,
                                  game_hash_hist=(hl, hh, nh))

        self._jsearch = jax.jit(search)

    def fresh(self, capacity):
        return (jmcts.fresh_tree(2, SIZE, capacity, self.js.core),
                mcts.fresh_tree(2, SIZE, capacity, self.ts.core))

    def search(self, jtree, ttree):
        js, ts = self.js, self.ts
        self.key, k = jax.random.split(self.key)
        jres, jtree = self._jsearch(
            js.core, js.stone_hist, js.hist_len, js.hash_hist_lo,
            js.hash_hist_hi, js.nhash, jtree, k)
        tres, ttree = mcts.run_mcts(
            ts.core, ts.stone_hist, ts.hist_len, self.teval, self.gen,
            self.tcfg, SIZE, init_tree=ttree,
            game_hash_hist=(ts.hash_hist_lo, ts.hash_hist_hi, ts.nhash),
            device="cpu")
        return jres, jtree, tres, ttree

    def play(self, actions, jtree, ttree, jactions=None):
        """Step both games by `actions` (the JAX one by `jactions` where
        given) and advance both trees."""
        a = np.asarray(actions, np.int32)
        ja = a if jactions is None else np.asarray(jactions, np.int32)
        self.js, _ = jstate.step(self.js, jnp.asarray(ja), SIZE)
        self.ts, _ = gostate.step(self.ts, torch.from_numpy(a), SIZE)
        cap = ttree.stones.shape[1]
        before = {k: v.clone() for k, v in ttree._asdict().items()}
        jtree = jmcts.advance_tree(jtree, jnp.asarray(ja), self.js.core,
                                   SIZE, cap)
        new = mcts.advance_tree(ttree, torch.from_numpy(a), self.ts.core,
                                SIZE, cap)
        for k, v in ttree._asdict().items():    # the old tree is untouched
            assert torch.equal(v, before[k]), k
        return jtree, new


def assert_results_close(jres, tres, ttree, jtree):
    child = ttree.child[:, 0].long()
    rows = torch.arange(child.shape[0])[:, None]
    t_n = torch.where(child >= 0, ttree.n[rows, child.clamp(min=0)], 0)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(jtree.n_edge)[:, 0])
    np.testing.assert_array_equal(tres.best_action.numpy(),
                                  np.asarray(jres.best_action))
    np.testing.assert_allclose(tres.mcts_policy.numpy(),
                               np.asarray(jres.mcts_policy), atol=1e-6)
    np.testing.assert_allclose(tres.root_q.numpy(), np.asarray(jres.root_q),
                               atol=1e-6)


def unvisited_actions(ttree, ts):
    """Per board, the first legal action without a child at the root."""
    legal = gostate.legal_moves(ts, SIZE)[:, :-1]
    free = legal & (ttree.child[:, 0, :-1] < 0)
    assert bool(free.any(dim=1).all())
    return torch.argmax(free.int(), dim=1).int().numpy()


@pytest.mark.parametrize("kind", ["visited", "unvisited", "pass"])
def test_fresh_advance_reset_match_jax(kind):
    p = Pair()
    cap = 2 * p.tcfg.num_rollouts + 2
    jtree, ttree = p.fresh(cap)
    assert_trees_equal(ttree, jtree, "fresh")
    jres, jtree, tres, ttree = p.search(jtree, ttree)
    assert_trees_equal(ttree, jtree, "after the first search")

    if kind == "visited":
        actions = tres.best_action.numpy()
        assert bool((ttree.child[torch.arange(2), 0,
                                 torch.from_numpy(actions).long()] >= 0).all())
    elif kind == "unvisited":
        actions = unvisited_actions(ttree, p.ts)
    else:
        actions = np.full(2, SIZE * SIZE, np.int32)
    jtree, ttree = p.play(actions, jtree, ttree)
    assert_trees_equal(ttree, jtree, f"after advancing ({kind})")
    if kind == "visited":
        assert bool((ttree.count > 1).all())
    if kind == "unvisited":
        assert bool((ttree.count == 1).all())
        assert not bool(ttree.expanded[:, 0].any())

    jres, jtree, tres, ttree = p.search(jtree, ttree)
    assert_trees_equal(ttree, jtree, "after the search from the reused tree")
    assert_results_close(jres, tres, ttree, jtree)

    # board 1's game restarts: its tree becomes a fresh one-node tree
    mask = np.array([False, True])
    js0, ts0 = state_pair(seed=2, plies=2)
    jtree = jmcts.reset_tree_where(jtree, jnp.asarray(mask), js0.core)
    out = mcts.reset_tree_where(ttree, torch.from_numpy(mask), ts0.core)
    assert out is ttree
    assert_trees_equal(ttree, jtree, "after reset_tree_where")
    assert int(ttree.count[1]) == 1 and int(ttree.count[0]) > 1


def test_two_searches_with_advance_match_jax():
    """Two searches from a persistent tree with the golden pseudo-NN."""
    p = Pair("golden")
    jtree, ttree = p.fresh(2 * p.tcfg.num_rollouts + 2)
    jres, jtree, tres, ttree = p.search(jtree, ttree)
    assert_results_close(jres, tres, ttree, jtree)
    jtree, ttree = p.play(tres.best_action.numpy(), jtree, ttree)
    carried = ttree.n[:, 0].clone()
    assert bool((carried > 0).all())
    jres, jtree, tres, ttree = p.search(jtree, ttree)
    assert_results_close(jres, tres, ttree, jtree)
    # the second search added its rollouts to the carried-over visits
    assert bool((ttree.n[:, 1:].sum(dim=1) >= p.tcfg.num_rollouts).all())


def test_full_reused_tree_takes_the_capacity_guard():
    """A reused tree filled to within a few nodes of its capacity: the
    frontier rollouts re-evaluate their node, as in the JAX search."""
    p = Pair()
    cap = p.tcfg.num_nodes          # what a fresh search needs, R + 2
    jtree, ttree = p.fresh(cap)
    jres, jtree, tres, ttree = p.search(jtree, ttree)
    jtree, ttree = p.play(tres.best_action.numpy(), jtree, ttree)
    assert bool((ttree.count + p.tcfg.num_rollouts > cap).all())
    jres, jtree, tres, ttree = p.search(jtree, ttree)
    assert bool((ttree.count == cap).all())
    assert_trees_equal(ttree, jtree, "after filling the tree")
    assert_results_close(jres, tres, ttree, jtree)


def test_capacity_clamps_to_int16_ids():
    js, ts = state_pair(plies=1)
    jtree = jmcts.fresh_tree(2, SIZE, 40_000, js.core)
    ttree = mcts.fresh_tree(2, SIZE, 40_000, ts.core)
    assert ttree.stones.shape[1] == jtree.stones.shape[1] == 32767
    assert_trees_equal(ttree, jtree, "fresh at the clamp")
    a = torch.tensor([SIZE * SIZE, 0], dtype=torch.int32)
    new = mcts.advance_tree(ttree, a, ts.core, SIZE, 32767)
    jnew = jmcts.advance_tree(jtree, jnp.asarray(a.numpy()), js.core, SIZE,
                              32767)
    assert_trees_equal(new, jnew, "advanced at the clamp")


def test_reused_root_keeps_its_raw_prior():
    """root_epsilon > 0 over three searches with advances between them: the
    root's stored raw prior is never replaced by a noised one, while the
    searched prior carries fresh noise every time (in both packages)."""
    p = Pair("golden", root_epsilon=0.25, root_alpha=0.3)
    jtree, ttree = p.fresh(2 * p.tcfg.num_rollouts + 2)
    for k in range(3):
        t_raw = ttree.root_raw_prior.clone()
        j_raw = np.asarray(jtree.root_raw_prior)
        t_reused = ttree.expanded[:, 0].clone()
        jres, jtree, tres, ttree = p.search(jtree, ttree)
        if k == 0:      # fresh roots: the evaluation's prior, in both
            np.testing.assert_allclose(ttree.root_raw_prior.numpy(),
                                       np.asarray(jtree.root_raw_prior),
                                       atol=1e-6)
        else:
            assert bool(t_reused.all())
            assert torch.equal(ttree.root_raw_prior, t_raw)
            np.testing.assert_array_equal(np.asarray(jtree.root_raw_prior),
                                          j_raw)
        for raw, prior in ((ttree.root_raw_prior, ttree.prior[:, 0].float()),
                           (torch.from_numpy(np.array(jtree.root_raw_prior)),
                            torch.from_numpy(jax_numpy(jtree.prior[:, 0])))):
            legal = raw >= 0
            assert torch.equal(legal, prior >= 0)
            assert not torch.equal(prior, raw.bfloat16().float())
            # the searched prior is (1 - eps) * raw + eps * noise: what is
            # left after taking out the raw part is a distribution
            base = raw.clamp(min=0) / raw.clamp(min=0).sum(1, keepdim=True)
            noise = torch.where(legal, (prior - 0.75 * base) / 0.25, 0.0)
            assert bool((noise > -0.05).all())
            np.testing.assert_allclose(noise.sum(1).numpy(), 1.0, atol=0.05)
        # each package plays its own best moves (their noise differs)
        jtree, ttree = p.play(tres.best_action.numpy(), jtree, ttree,
                              jactions=np.asarray(jres.best_action))
        assert bool(ttree.expanded[:, 0].all())
        assert bool(np.asarray(jtree.expanded)[:, 0].all())
