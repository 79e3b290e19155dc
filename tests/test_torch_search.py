"""The port's search against the JAX search on options the golden fixtures
do not cover (per-player puct and rollout budgets, player swap, pure-Q
selection, prior picking, root FPU zeroing, pass gating), with the
golden pseudo-NN: identical root visits and best actions, visit
distributions and root Q within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import state as jstate
from elf_tpu.env.go.engine import BLACK as JBLACK
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.search.mcts import run_mcts as jrun_mcts
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
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
