"""The port's search against the JAX search on options the golden fixtures
do not cover (per-player puct and rollout budgets, player swap, pure-Q
selection, prior picking, root FPU zeroing, pass gating), with the
golden pseudo-NN: identical root visits and best actions, visit
distributions and root Q within 1e-6.  And the port's descent, run to
trip counts fixed once per simulation batch, against the descent that
stops on a host read (the search as it ran before), bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import state as jstate
from elf_tpu.env.go.engine import BLACK as JBLACK
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.search.mcts import run_mcts as jrun_mcts
from elf_tpu_torch import profiling
from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.search import mcts as tmcts
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts

pytestmark = pytest.mark.timeout(240)

SIZE = 9


def _raw_priors(A):
    """gen_mcts_golden.cc raw_prior: a tie-free geometric ladder."""
    perm = (np.arange(A, dtype=np.int64) * 37 + 13) % A
    return ((1.0 + (perm % 64) / 64.0) * np.exp2(perm // 64)).astype(np.float32)


def _eval_fn(xp, where, black):
    """The golden pseudo-NN in numpy-like namespace `xp`: fixed priors,
    value = clip(0.05 * (black_stones - white_stones), -1, 1)."""
    n2 = SIZE * SIZE
    log_prior = xp.log(xp.asarray(_raw_priors(n2 + 1)))

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(-1)
        theirs = feats[..., 1].reshape(K, n2).sum(-1)
        b = where(to_play == black, mine, theirs)
        w = where(to_play == black, theirs, mine)
        v = xp.clip((b - w) * 0.05, -1.0, 1.0)
        return xp.broadcast_to(log_prior[None, :], (K, n2 + 1)), v

    return eval_fn


@pytest.mark.parametrize("option", [
    dict(white_puct=0.5, white_num_rollouts=16),
    dict(white_puct=0.5, white_num_rollouts=16, white_opts_on_black=True),
    dict(use_prior=False),
    dict(pick_method="prior"),
    dict(root_unexplored_q_zero=True, virtual_loss=3),
    dict(ply_pass_enabled=100, remove_pass_if_dangerous=False),
])
def test_search_options_match_jax(option):
    """Search options the golden fixtures do not cover, against the JAX
    search on one black-to-move and one white-to-move (handicap) board."""
    size = SIZE
    rng = np.random.default_rng(1)
    boards = [jstate.init_state(1, size),
              jstate.apply_handicap(jstate.init_state(1, size), 2, size)]
    for _ in range(6):
        for i, st in enumerate(boards):
            legal = np.nonzero(np.asarray(jstate.legal_moves(st, size))[0, :-1])[0]
            boards[i], _ = jstate.step(
                st, jnp.asarray([rng.choice(legal)], jnp.int32), size)
    js = jax.tree.map(lambda *xs: jnp.concatenate(xs), *boards)

    def to_torch(x):
        a = np.array(x)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)

    ts = gostate.GoState(*[
        type(f)(*map(to_torch, f)) if isinstance(f, tuple) else to_torch(f)
        for f in js
    ])
    kw = dict(num_rollouts=32, rollouts_per_batch=4, rotation_flip=False,
              **option)
    jres, jtree = jax.jit(lambda core, hist, hlen, hl, hh, nh: jrun_mcts(
        core, hist, hlen, _eval_fn(jnp, jnp.where, JBLACK), jax.random.PRNGKey(0),
        JMCTSConfig(**kw), size, game_hash_hist=(hl, hh, nh),
    ))(js.core, js.stone_hist, js.hist_len, js.hash_hist_lo, js.hash_hist_hi,
       js.nhash)
    tres, ttree = run_mcts(
        ts.core, ts.stone_hist, ts.hist_len, _eval_fn(torch, torch.where, BLACK),
        torch.Generator().manual_seed(0), MCTSConfig(**kw), size,
        game_hash_hist=(ts.hash_hist_lo, ts.hash_hist_hi, ts.nhash),
        device="cpu",
    )
    child = ttree.child[:, 0].long()
    rows = torch.arange(2)[:, None]
    t_n = torch.where(child >= 0, ttree.n[rows, child.clamp(min=0)], 0)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(jtree.n_edge)[:, 0])
    np.testing.assert_array_equal(tres.best_action.numpy(),
                                  np.asarray(jres.best_action))
    np.testing.assert_allclose(tres.mcts_policy.numpy(),
                               np.asarray(jres.mcts_policy), atol=1e-6)
    np.testing.assert_allclose(tres.root_q.numpy(), np.asarray(jres.root_q),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the fixed-trip-count descent against the read-ended one
# ---------------------------------------------------------------------------


def _read_ended_walk(tree, node, h_lo, h_hi):
    """The in-tree superko walk that stops when every row reached its root
    (a host read a level)."""
    B, N = tree.stones.shape[:2]
    rows = torch.arange(B)
    cur = node
    found = torch.zeros((B,), dtype=torch.bool)
    active = torch.ones_like(found)
    while bool(active.any()):
        safe = cur.clamp(0, N - 1)
        hit = active & (tree.hash_lo[rows, safe] == h_lo) & (
            tree.hash_hi[rows, safe] == h_hi)
        found = found | hit
        parent = tree.parent[rows, safe].long()
        active = active & (parent >= 0)
        cur = torch.where(active, parent, cur)
    return found


def _read_ended_descent(tree, cfg, size, game_hash_hist=None, active=None):
    """One rollout's select + expand whose depth loop stops when every row
    has finished (a host read a level): the descent as the search ran it
    before its trip counts were fixed."""
    B, N = tree.stones.shape[:2]
    rows = torch.arange(B)
    n2 = size * size
    A = n2 + 1
    cur = torch.zeros((B,), dtype=torch.long)
    leaf = torch.zeros_like(cur)
    done = tree.terminal[:, 0].clone()
    if active is not None:
        done = done | ~active
    depth = 0
    while depth < cfg.max_depth and not bool(done.all()):
        scores, new_umean = tmcts._puct_scores(tree, cur, cfg, depth == 0)
        a = torch.argmax(scores, dim=1)
        tree.umean_q[rows, cur] = torch.where(done, tree.umean_q[rows, cur],
                                              new_umean)
        child = tree.child[rows, cur, a].long()
        has_child = child >= 0
        safe_child = child.clamp(0, N - 1)
        tree.vl[rows, safe_child] += torch.where(
            ~done & has_child, cfg.virtual_loss, 0).to(torch.int32)
        child_pending = (has_child & ~tree.expanded[rows, safe_child]
                         & ~tree.terminal[rows, safe_child])
        child_terminal = has_child & tree.terminal[rows, safe_child]
        stop_expand = ~done & ~has_child
        stop_leaf = ~done & (child_pending | child_terminal)
        leaf = torch.where(stop_leaf, child, leaf)
        leaf = torch.where(stop_expand, -(cur * A + a) - 2, leaf)
        done = done | stop_expand | stop_leaf
        cur = torch.where(done, cur, safe_child)
        depth += 1
    leaf = torch.where(done, leaf, cur)

    need_expand = (leaf < -1) & (tree.count < N)
    frontier = (leaf < -1) & ~need_expand
    enc = torch.where(leaf < -1, -(leaf + 2), 0)
    exp_node = enc // A
    exp_a = enc % A
    core = tmcts._core_at(tree, rows, exp_node)
    child_core, step_info = engine.step_core(core, exp_a.to(torch.int32), size)
    new_id = torch.where(need_expand, tree.count.long(), 0).clamp(0, N - 1)
    tmcts._write_core(tree, new_id, child_core, need_expand)
    is_stone_move = exp_a < n2
    rep = _read_ended_walk(tree, exp_node, child_core.hash_lo,
                           child_core.hash_hi)
    if game_hash_hist is not None:
        gl, gh, gn = game_hash_hist
        k = torch.arange(gl.shape[1])[None, :]
        rep = rep | ((gl == child_core.hash_lo[:, None])
                     & (gh == child_core.hash_hi[:, None])
                     & (k < gn[:, None])).any(dim=1)
    rep = rep & is_stone_move & need_expand
    superko_value = torch.where(child_core.to_play == BLACK, 1.0, -1.0)
    term = engine.is_terminal_core(child_core, size) | rep
    pre_prior = torch.where(step_info.legal_next, 0.0, -1.0).to(torch.bfloat16)
    parent_umean = tree.umean_q[rows, exp_node]

    def put(arr, idx, val):
        old = arr[idx]
        m = need_expand.reshape((B,) + (1,) * (old.ndim - 1))
        arr[idx] = torch.where(m, val.to(arr.dtype) if torch.is_tensor(val)
                               else torch.full_like(old, val), old)

    at_new = (rows, new_id)
    tree.superko[at_new] = torch.where(need_expand, rep, tree.superko[at_new])
    tree.value[at_new] = torch.where(rep, superko_value, tree.value[at_new])
    put(tree.prior, at_new, pre_prior)
    put(tree.child, (rows, exp_node, exp_a), new_id)
    put(tree.parent, at_new, exp_node)
    put(tree.parent_a, at_new, exp_a)
    put(tree.terminal, at_new, term)
    put(tree.n, at_new, 0)
    put(tree.w, at_new, 0.0)
    put(tree.vl, at_new, cfg.virtual_loss)
    put(tree.umean_q, at_new, parent_umean)
    put(tree.uparent_q, at_new, parent_umean)
    tree.count.add_(need_expand.to(torch.int32))
    leaf = torch.where(need_expand, new_id, leaf)
    return torch.where(frontier, exp_node, leaf)


def _read_ended_batch(tree, cfg, size, m, game_hash_hist=None, active=None):
    return torch.stack([_read_ended_descent(tree, cfg, size, game_hash_hist,
                                            active) for _ in range(m)])


def _linear_eval(seed):
    """Seeded linear priors and values over the planes (of any count), so
    that the trees depend on the positions."""
    g = torch.Generator().manual_seed(seed)
    w = {}

    def eval_fn(feats, to_play):
        x = feats.reshape(feats.shape[0], -1).float()
        if x.shape[1] not in w:
            A = math.isqrt(feats.shape[1] * feats.shape[2]) ** 2 + 1
            w[x.shape[1]] = (torch.randn((x.shape[1], A), generator=g) * 0.3,
                             torch.randn((x.shape[1],), generator=g) * 0.1)
        w_pi, w_v = w[x.shape[1]]
        return torch.log_softmax(x @ w_pi, dim=1), torch.tanh(x @ w_v)

    return eval_fn


DESCENT_BASE = dict(num_rollouts=32, rollouts_per_batch=4, c_puct=1.5,
                    virtual_loss=2, root_epsilon=0.25, root_alpha=0.3,
                    rotation_flip=True, max_batches_per_call=3)
DESCENT_CASES = {
    "terminal_roots": {},
    "superko_history": {},
    "white_budget": dict(white_num_rollouts=12),
    "max_depth": dict(num_rollouts=64, max_depth=2),
    "at_capacity": dict(max_nodes=12),
    "df": dict(feature_set="df"),
    "reused_tree": dict(max_nodes=80),
}


def _descent_inputs(case, size=5, B=6):
    """A seeded state of B boards a few random legal moves in, shaped for
    `case`: two boards that passed twice, history hashes of half the
    roots' children, or the other player to move on every other board."""
    from elf_tpu_torch.env.go.engine import WHITE

    n2 = size * size
    g = torch.Generator().manual_seed(17)
    st = gostate.init_state(B, size, "cpu")
    for ply in range(7):
        legal = gostate.legal_moves(st, size)
        legal[:, n2] = False
        a = torch.argmax(torch.where(legal, torch.rand(legal.shape,
                                                       generator=g), -1.0),
                         dim=1).to(torch.int32)
        if case == "terminal_roots" and ply >= 5:
            a[:2] = n2
        st, _ = gostate.step(st, a, size)
    if case == "superko_history":
        legal = gostate.legal_moves(st, size)
        lo, hi, nh = (st.hash_hist_lo.clone(), st.hash_hist_hi.clone(),
                      st.nhash.clone())
        for p in range(0, n2, 2):
            child, _ = engine.step_core(st.core, torch.full((B,), p,
                                                            dtype=torch.int32),
                                        size)
            at = nh.long()
            rows = torch.arange(B)[legal[:, p]]
            lo[rows, at[rows]] = child.hash_lo[rows]
            hi[rows, at[rows]] = child.hash_hi[rows]
            nh[rows] += 1
        st = st._replace(hash_hist_lo=lo, hash_hist_hi=hi, nhash=nh)
    if case == "white_budget":
        tp = st.core.to_play.clone()
        tp[::2] = BLACK + WHITE - tp[::2]
        st = st._replace(core=st.core._replace(to_play=tp))
    return st


def _search_recorded(st, cfg, size, descent, init_tree=None, gen=None):
    """run_mcts with `descent` as the batch's select-and-expand; returns
    (result, tree, generator state, each batch's leaves)."""
    leaves = []

    def recorded(*args, **kwargs):
        out = descent(*args, **kwargs)
        leaves.append(out.clone())
        return out

    gen = gen or torch.Generator().manual_seed(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmcts, "_select_and_expand", recorded)
        res, tree = run_mcts(
            st.core, st.stone_hist, st.hist_len, _linear_eval(3), gen, cfg,
            size, init_tree=init_tree,
            game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi, st.nhash),
            root_last_placed=(st.last_placed if cfg.feature_set == "df"
                              else None),
            device="cpu")
    return res, tree, gen.get_state(), leaves


@pytest.mark.parametrize("case", sorted(DESCENT_CASES))
def test_fixed_trip_descent_equals_read_ended(case):
    """The descent run to trip counts fixed once per simulation batch
    equals the descent that stops on a host read when every row has
    finished, bit for bit: every tree field, each batch's leaves, the
    result and the generator's state after a multi-call search.  Traced,
    the descents read nothing on the host and the trip counts one value a
    batch."""
    size = 5
    cfg = MCTSConfig(**{**DESCENT_BASE, **DESCENT_CASES[case]})
    st = _descent_inputs(case, size)
    init = {}
    if case == "reused_tree":
        res0, tree0 = run_mcts(
            st.core, st.stone_hist, st.hist_len, _linear_eval(3),
            torch.Generator().manual_seed(2), cfg, size,
            game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi, st.nhash),
            device="cpu")
        st, _ = gostate.step(st, res0.best_action, size)
        init = {"adv": tmcts.advance_tree(tree0, res0.best_action, st.core,
                                          size, cfg.num_nodes)}

    def run(descent, traced=False):
        tree = init["adv"] if init else None
        tree = None if tree is None else tmcts.Tree(*(t.clone() for t in tree))
        if not traced:
            return _search_recorded(st, cfg, size, descent, tree)
        profiling.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            out = _search_recorded(st, cfg, size, descent, tree)
        return out, profiling.counters()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmcts._Descent, "descend", profiling.reads_counted_as(
            "test.descent")(tmcts._Descent.descend))
        mp.setattr(tmcts, "_trip_counts", profiling.reads_counted_as(
            "test.trip_counts")(tmcts._trip_counts))
        (res, tree, gen_state, leaves), counts = run(
            tmcts._select_and_expand, traced=True)
    ref_res, ref_tree, ref_gen_state, ref_leaves = run(_read_ended_batch)

    for field, a, b in zip(tree._fields, tree, ref_tree):
        assert torch.equal(a, b), field
    for a, b in zip(res, ref_res):
        assert torch.equal(a, b)
    assert torch.equal(gen_state, ref_gen_state)
    assert len(leaves) == len(ref_leaves) == counts["search.batches"]
    for a, b in zip(leaves, ref_leaves):
        assert torch.equal(a, b)
    m = cfg.rollouts_per_batch
    assert "test.descent" not in counts
    assert counts["test.trip_counts"] == counts["search.batches"]
    assert counts["search.descents"] == m * counts["search.batches"]
    assert "search.descents_replayed" not in counts   # no graphs on the CPU

    # the walk's W levels reach the root from the deepest expanded node
    T, W = tmcts._trip_counts(tree, cfg)
    deepest = torch.where(tree.expanded, tree.ply - tree.ply[:, :1],
                          -1).argmax(dim=1)
    d = tmcts._Descent(tree, cfg, size)
    d.h = (tree.hash_lo[:, 0], tree.hash_hi[:, 0])
    d.wcur.copy_(deepest)
    d.wactive.fill_(True)
    for _ in range(W):
        d.walk()
    assert bool(d.found.all())
    assert torch.equal(d.found, _read_ended_walk(tree, deepest, *d.h))
    assert T <= W and bool((~d.wactive).all())

    # each case reaches what it is there for
    if case == "terminal_roots":
        assert bool(tree.terminal[:2, 0].all()) and int(tree.count[0]) == 1
    elif case == "superko_history":
        assert bool(tree.superko.any())
    elif case == "white_budget":
        assert int(tree.count[0]) != int(tree.count[1])
    elif case == "max_depth":
        depth = (tree.ply - tree.ply[:, :1]).where(tree.expanded, 0)
        assert int(depth.max()) >= cfg.max_depth
    elif case == "at_capacity":
        assert bool((tree.count == cfg.num_nodes).all())
    elif case == "reused_tree":
        assert bool((init["adv"].count > 1).any())
