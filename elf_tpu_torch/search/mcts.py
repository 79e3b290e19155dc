"""Batched array-of-trees PUCT search: counterpart of
`elf_tpu/search/mcts.py` (reference `tree_search.h:327`, `mcts/mcts.h`).

A batch of B trees lives in ``[B, num_nodes, ...]`` tensors; every phase is
a lockstep tensor op over the B trees:

  select   argmax-PUCT descent (first-play urgency, virtual loss), one
           rollout at a time, `rollouts_per_batch` rollouts per batch;
  expand   one child per tree per rollout by stepping the Go engine (the
           step's liberty analysis is the CUDA `step_analysis` kernel on
           the card);
  evaluate one NN forward over all B * rollouts_per_batch leaves, with a
           random D4 symmetry per leaf and the terminal Tromp-Taylor
           shortcut;
  backprop visit counts and values up the parent chains; a leaf selected
           several times in one batch backprops once and removes all its
           virtual losses (tree_search.h:255).

Edge statistics live on the child node (an edge without a child has
n = w = vl = 0); `prior` is bf16 and encodes legality (-1 illegal, 0
legal-but-unevaluated); child / parent ids are int16, widened to long at
every gather.  Unlike the JAX functions, these update the tree in place.

Not ported yet (each raises NotImplementedError): the deferred-write
overlay (`batched_writes="on"`), `feature_set="df"`, `eval_chunk`,
`max_batches_per_call` and tree reuse (`init_tree`, `advance_tree`).
The data-dependent loops (descent, ancestor walk, backprop, fixpoints)
check their end condition on the host once per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go.engine import BLACK, GoCore
from elf_tpu_torch.env.go.features import (
    extract_agz_from_snapshots,
    inv_transform_policy,
)

NEG_INF = -1e9
_KO_INACTIVE = 10_000


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Same fields and defaults as the JAX MCTSConfig (see its comments)."""

    num_rollouts: int = 200
    rollouts_per_batch: int = 8
    c_puct: float = 1.5
    virtual_loss: int = 1
    root_epsilon: float = 0.0
    root_alpha: float = 0.03
    max_depth: int = 128
    komi: float = 7.5
    ply_pass_enabled: int = 0
    remove_pass_if_dangerous: bool = True
    rotation_flip: bool = True
    pick_method: str = "most_visited"
    white_puct: float = -1.0
    white_num_rollouts: int = 0
    white_opts_on_black: bool = False
    use_prior: bool = True
    unexplored_q_zero: bool = False
    root_unexplored_q_zero: bool = False
    max_nodes: int = 0
    eval_chunk: int = 0
    max_batches_per_call: int = 0
    feature_set: str = "agz"
    batched_writes: str = "auto"

    @property
    def num_nodes(self) -> int:
        if self.max_nodes > 0:
            return self.max_nodes
        return max(self.num_rollouts, self.white_num_rollouts) + 2


def check_supported(cfg: MCTSConfig) -> None:
    """Raise NotImplementedError for an option the port does not have yet."""
    if cfg.feature_set != "agz":
        raise NotImplementedError(f"feature_set={cfg.feature_set!r}")
    if cfg.eval_chunk:
        raise NotImplementedError("eval_chunk")
    if cfg.max_batches_per_call:
        raise NotImplementedError("max_batches_per_call")
    if cfg.batched_writes == "on":
        raise NotImplementedError("batched_writes='on' (deferred overlay)")
    if cfg.batched_writes not in ("auto", "off"):
        raise ValueError(f"batched_writes={cfg.batched_writes!r}")
    if cfg.pick_method not in ("most_visited", "prior", "uniform_random"):
        raise ValueError(f"pick_method={cfg.pick_method!r}")


class Tree(NamedTuple):
    """[B, N(, ...)] tensors; node 0 is the root."""

    stones: torch.Tensor     # int8  [B, N, n2]
    to_play: torch.Tensor    # int8  [B, N]
    ko_point: torch.Tensor   # int16 [B, N]
    ko_color: torch.Tensor   # int8  [B, N]
    ko_age: torch.Tensor     # int16 [B, N]
    ply: torch.Tensor        # int16 [B, N]
    passes: torch.Tensor     # int8  [B, N]
    hash_lo: torch.Tensor    # int32 [B, N]  u32 bits (in-tree superko)
    hash_hi: torch.Tensor    # int32 [B, N]
    prior: torch.Tensor      # bf16  [B, N, A] (-1 illegal; 0 pending-legal)
    child: torch.Tensor      # int16 [B, N, A] child node id or -1
    n: torch.Tensor          # int32 [B, N] visits through the incoming edge
    w: torch.Tensor          # f32   [B, N] black-persp. value sum
    vl: torch.Tensor         # int32 [B, N] virtual-loss count
    parent: torch.Tensor     # int16 [B, N]
    parent_a: torch.Tensor   # int16 [B, N]
    expanded: torch.Tensor   # bool  [B, N]
    terminal: torch.Tensor   # bool  [B, N]
    value: torch.Tensor      # f32   [B, N] NN/terminal value (black persp.)
    superko: torch.Tensor    # bool  [B, N] terminal by in-tree repetition
    umean_q: torch.Tensor    # f32   [B, N] running mean unsigned Q (FPU)
    uparent_q: torch.Tensor  # f32   [B, N] parent's mean at allocation
    count: torch.Tensor      # int32 [B]    allocated nodes
    root_raw_prior: torch.Tensor  # f32 [B, A] the root's un-noised prior


class MCTSResult(NamedTuple):
    mcts_policy: torch.Tensor  # f32 [B, A] normalized root visit distribution
    best_action: torch.Tensor  # i32 [B]
    root_value: torch.Tensor   # f32 [B] NN value at root (black perspective)
    root_q: torch.Tensor       # f32 [B] visit-weighted root Q (black persp.)


# eval_fn(features [M, N, N, C] f32, to_play [M]) -> (log_pi [M, A], value [M])
EvalFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def _make_tree(B: int, size: int, N: int, device) -> Tree:
    n2 = size * size
    A = n2 + 1
    N = min(N, 32767)   # node ids are int16

    def z(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(val, dtype, *shape):
        return torch.full(shape, val, dtype=dtype, device=device)

    return Tree(
        stones=z(torch.int8, B, N, n2),
        to_play=z(torch.int8, B, N),
        ko_point=full(-1, torch.int16, B, N),
        ko_color=z(torch.int8, B, N),
        ko_age=full(_KO_INACTIVE, torch.int16, B, N),
        ply=z(torch.int16, B, N),
        passes=z(torch.int8, B, N),
        hash_lo=z(torch.int32, B, N),
        hash_hi=z(torch.int32, B, N),
        prior=full(-1.0, torch.bfloat16, B, N, A),
        child=full(-1, torch.int16, B, N, A),
        n=z(torch.int32, B, N),
        w=z(torch.float32, B, N),
        vl=z(torch.int32, B, N),
        parent=full(-1, torch.int16, B, N),
        parent_a=full(-1, torch.int16, B, N),
        expanded=z(torch.bool, B, N),
        terminal=z(torch.bool, B, N),
        value=z(torch.float32, B, N),
        superko=z(torch.bool, B, N),
        umean_q=z(torch.float32, B, N),
        uparent_q=z(torch.float32, B, N),
        count=torch.ones((B,), dtype=torch.int32, device=device),
        root_raw_prior=full(-1.0, torch.float32, B, A),
    )


def _core_at(tree: Tree, rows: torch.Tensor, node: torch.Tensor) -> GoCore:
    """GoCore batch of nodes `node` on tree rows `rows` (both long [K]),
    widened back to the engine's dtypes."""
    K = node.shape[0]

    def g(a):
        return a[rows, node]

    return GoCore(
        stones=g(tree.stones),
        to_play=g(tree.to_play),
        ko_point=g(tree.ko_point).to(torch.int32),
        ko_color=g(tree.ko_color),
        ko_age=g(tree.ko_age).to(torch.int32),
        ply=g(tree.ply).to(torch.int32),
        passes=g(tree.passes).to(torch.int32),
        last_move=torch.full((K,), -1, dtype=torch.int32, device=node.device),
        hash_lo=g(tree.hash_lo),
        hash_hi=g(tree.hash_hi),
    )


def _write_core(tree: Tree, node: torch.Tensor, core: GoCore,
                mask: torch.Tensor) -> None:
    """tree[b, node[b]] = core[b] where mask[b] (in place)."""
    B = node.shape[0]
    rows = torch.arange(B, device=node.device)
    node = node.clamp(0, tree.stones.shape[1] - 1)

    def w(arr, val):
        old = arr[rows, node]
        m = mask.reshape((B,) + (1,) * (old.ndim - 1))
        arr[rows, node] = torch.where(m, val.to(arr.dtype), old)

    w(tree.stones, core.stones)
    w(tree.to_play, core.to_play)
    w(tree.ko_point, core.ko_point)
    w(tree.ko_color, core.ko_color)
    w(tree.ko_age, core.ko_age.clamp(max=_KO_INACTIVE))
    w(tree.ply, core.ply)
    w(tree.passes, core.passes)
    w(tree.hash_lo, core.hash_lo)
    w(tree.hash_hi, core.hash_hi)


def _edge_stats(tree: Tree, node: torch.Tensor):
    """Per-action (n, w, vl) at `node` [B], gathered from the child nodes
    (zero where no child exists): a plain gather."""
    B = node.shape[0]
    N = tree.n.shape[1]
    rows = torch.arange(B, device=node.device)
    child = tree.child[rows, node].long()                  # [B, A]
    has = child >= 0
    cs = child.clamp(0, N - 1)
    r2 = rows[:, None]
    n = torch.where(has, tree.n[r2, cs], 0)
    w = torch.where(has, tree.w[r2, cs], 0.0)
    vl = torch.where(has, tree.vl[r2, cs], 0)
    return n, w, vl


def _puct_scores(tree: Tree, node: torch.Tensor, cfg: MCTSConfig,
                 is_root: bool):
    """Selection scores at `node` (tree_search_node.h:360 + getScore):

      q = (+-w - vl) / (n + vl)     for edges with n + vl > 0
      q = +-unsignedMeanQ           for unexplored edges (FPU)
      u = c_puct * prior * sqrt(sum n + 1) / (1 + n)

    Returns (scores [B, A], new_umean [B]), the node's updated running mean
    unsigned Q (tree_search_node.h:227), in the JAX function's float order."""
    B = node.shape[0]
    rows = torch.arange(B, device=node.device)
    prior = tree.prior[rows, node].float()                 # [B, A]
    n_i, w, vl_i = _edge_stats(tree, node)
    n = n_i.float()
    vl = vl_i.float()
    legal = prior >= 0.0

    to_play = tree.to_play[rows, node]
    sign = torch.where(to_play == BLACK, 1.0, -1.0)[:, None]

    umean = tree.umean_q[rows, node]
    if cfg.unexplored_q_zero or (cfg.root_unexplored_q_zero and is_root):
        umean = torch.zeros_like(umean)
    umean2 = umean[:, None]

    n_eff = n + vl
    w_eff = w * sign - vl
    q = torch.where(n_eff > 0, w_eff / n_eff.clamp(min=1.0), sign * umean2)

    visited = legal & (n_eff > 0)
    uq = torch.where(n > 0, w / n.clamp(min=1.0), umean2)
    new_umean = (
        tree.uparent_q[rows, node]
        + torch.where(visited, uq, 0.0).sum(dim=1)
    ) / (visited.sum(dim=1).float() + 1.0)

    if not cfg.use_prior:
        return torch.where(legal, q, NEG_INF), new_umean
    total = n.sum(dim=1, keepdim=True)
    c = cfg.c_puct
    if cfg.white_puct > 0:
        root_player = tree.to_play[:, 0]
        opts_player = BLACK if cfg.white_opts_on_black else engine.WHITE
        c = torch.where(root_player == opts_player, cfg.white_puct,
                        cfg.c_puct)[:, None].float()
    u = c * prior.clamp(min=0.0) * torch.sqrt(total + 1.0) / (1.0 + n)
    return torch.where(legal, q + u, NEG_INF), new_umean


def _hash_in_ancestors(tree: Tree, node: torch.Tensor, h_lo: torch.Tensor,
                       h_hi: torch.Tensor) -> torch.Tensor:
    """bool [B]: does (h_lo, h_hi) equal a position hash on the path
    node -> root?  (In-tree positional-superko detection.)"""
    B = node.shape[0]
    N = tree.stones.shape[1]
    rows = torch.arange(B, device=node.device)
    cur = node
    found = torch.zeros((B,), dtype=torch.bool, device=node.device)
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


def _select_and_expand(tree: Tree, cfg: MCTSConfig, size: int,
                       game_hash_hist=None,
                       active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One rollout's select + expand for all B trees (writes the tree in
    place).  Returns the leaf id [B]: a newly allocated node, an existing
    pending or terminal node, or the root for terminal/inactive roots."""
    B, N = tree.stones.shape[:2]
    dev = tree.stones.device
    rows = torch.arange(B, device=dev)
    n2 = size * size
    A = n2 + 1

    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    leaf = torch.zeros_like(cur)             # fallback: root (re-eval)
    done = tree.terminal[:, 0].clone()       # terminal roots: nothing to do
    if active is not None:
        done = done | ~active
    depth = 0
    while depth < cfg.max_depth and not bool(done.all()):
        scores, new_umean = _puct_scores(tree, cur, cfg, depth == 0)
        a = torch.argmax(scores, dim=1)
        tree.umean_q[rows, cur] = torch.where(done, tree.umean_q[rows, cur],
                                              new_umean)
        child = tree.child[rows, cur, a].long()
        has_child = child >= 0
        safe_child = child.clamp(0, N - 1)
        # virtual loss on the traversed edge = on the child node
        tree.vl[rows, safe_child] += torch.where(
            ~done & has_child, cfg.virtual_loss, 0).to(torch.int32)
        child_pending = (has_child & ~tree.expanded[rows, safe_child]
                         & ~tree.terminal[rows, safe_child])
        child_terminal = has_child & tree.terminal[rows, safe_child]
        stop_expand = ~done & ~has_child
        stop_leaf = ~done & (child_pending | child_terminal)
        leaf = torch.where(stop_leaf, child, leaf)
        # encode the expansion edge (cur, a) as -(cur*A + a) - 2
        leaf = torch.where(stop_expand, -(cur * A + a) - 2, leaf)
        done = done | stop_expand | stop_leaf
        cur = torch.where(done, cur, safe_child)
        depth += 1
    leaf = torch.where(done, leaf, cur)      # depth cap: re-evaluate

    # --- expansion: decode (node, action), step env, allocate --------------
    need_expand = (leaf < -1) & (tree.count < N)
    frontier = (leaf < -1) & ~need_expand
    enc = torch.where(leaf < -1, -(leaf + 2), 0)
    exp_node = enc // A
    exp_a = enc % A

    core = _core_at(tree, rows, exp_node)
    child_core, step_info = engine.step_core(core, exp_a.to(torch.int32), size)
    new_id = torch.where(need_expand, tree.count.long(), 0).clamp(0, N - 1)
    _write_core(tree, new_id, child_core, need_expand)

    # in-tree positional superko: a stone move recreating a path-ancestor
    # or game-history position terminates, scored for the player to move
    is_stone_move = exp_a < n2
    rep = _hash_in_ancestors(tree, exp_node, child_core.hash_lo,
                             child_core.hash_hi)
    if game_hash_hist is not None:
        gl, gh, gn = game_hash_hist
        k = torch.arange(gl.shape[1], device=dev)[None, :]
        rep = rep | ((gl == child_core.hash_lo[:, None])
                     & (gh == child_core.hash_hi[:, None])
                     & (k < gn[:, None])).any(dim=1)
    rep = rep & is_stone_move & need_expand
    superko_value = torch.where(child_core.to_play == BLACK, 1.0, -1.0)
    term = engine.is_terminal_core(child_core, size) | rep
    # pre-prior: legality of the child position, in the prior's sign
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


def _leaf_snapshots(tree: Tree, rows: torch.Tensor, leaf: torch.Tensor,
                    root_hist: torch.Tensor, root_hist_len: torch.Tensor):
    """8 board snapshots ending at `leaf` (oldest first), walking parent
    chains and extending into the game history below the root.  Returns
    (snaps int8 [K, 8, n2], valid bool [K, 8]); a snapshot is valid iff it
    is a post-move board."""
    H = root_hist.shape[1]
    N = tree.stones.shape[1]
    snaps, valid = [], []
    cur = leaf
    in_tree = torch.ones_like(leaf, dtype=torch.bool)
    k = torch.zeros_like(leaf)   # moves before the root, once out of tree
    for _ in range(H):
        safe = cur.clamp(0, N - 1)
        from_tree = tree.stones[rows, safe]
        from_hist = root_hist[rows, (H - 1 - k).clamp(0, H - 1)]
        snaps.append(torch.where(in_tree[:, None], from_tree, from_hist))
        valid.append(torch.where(in_tree, tree.ply[rows, safe] > 0,
                                 k < root_hist_len[rows]))
        parent = tree.parent[rows, safe].long()
        exiting = in_tree & (parent < 0)
        k = torch.where(in_tree, exiting.long(), k + 1)
        cur = torch.where(in_tree & ~exiting, parent, cur)
        in_tree = in_tree & ~exiting
    return torch.stack(snaps[::-1], dim=1), torch.stack(valid[::-1], dim=1)


def _evaluate_states(core: GoCore, is_term: torch.Tensor, snaps, valid,
                     legal: torch.Tensor, eval_fn: EvalFn,
                     gen: torch.Generator, cfg: MCTSConfig, size: int,
                     last_is_pass: torch.Tensor):
    """Evaluate K gathered states: (prior [K, A] f32, value [K] black
    persp.), with pass gating (mcts.h post_nn_result +
    remove_pass_if_dangerous) and the terminal TT shortcut."""
    K = core.stones.shape[0]
    n2 = size * size
    dev = core.stones.device
    if cfg.rotation_flip:
        codes = torch.randint(0, 8, (K,), generator=gen, device=dev)
    else:
        codes = torch.zeros((K,), dtype=torch.long, device=dev)
    feats = extract_agz_from_snapshots(snaps, valid, core.to_play, codes, size)
    log_pi, value = eval_fn(feats, core.to_play)
    pi = inv_transform_policy(torch.exp(log_pi.float()), codes, size)
    value = value.float()

    score = engine.score_tromp_taylor(core, size).float() - cfg.komi
    black_winning = score > 0
    mover_losing = torch.where(core.to_play == BLACK, ~black_winning,
                               black_winning)
    pass_ok = core.ply >= cfg.ply_pass_enabled
    if cfg.remove_pass_if_dangerous:
        pass_ok = pass_ok & (~mover_losing | last_is_pass)
    legal = legal.clone()
    legal[:, n2] &= pass_ok
    legal[:, n2] |= ~legal.any(dim=1)

    pi = torch.where(legal, pi, 0.0)
    # exact reference normalization: total starts at 1e-10 (mcts.h:243)
    pi = pi / (pi.sum(dim=1, keepdim=True) + 1e-10)
    prior = torch.where(legal, pi, -1.0)
    value = torch.where(is_term, torch.where(black_winning, 1.0, -1.0), value)
    return prior, value


def _backprop_multi(tree: Tree, rows: torch.Tensor, leaves: torch.Tensor,
                    values: torch.Tensor, active0: torch.Tensor,
                    vl_mult: torch.Tensor, cfg: MCTSConfig) -> None:
    """All K = m*B backprops of one simulation batch as one lockstep walk;
    duplicate (board, node) hits accumulate (index_put_ with accumulate)."""
    N = tree.stones.shape[1]
    cur, active = leaves, active0
    while bool(active.any()):
        safe = cur.clamp(0, N - 1)
        p = tree.parent[rows, safe].long()
        upd = active & (p >= 0)
        idx = upd.nonzero().squeeze(1)
        at = (rows[idx], safe[idx])
        tree.n.index_put_(at, torch.ones_like(idx, dtype=torch.int32),
                          accumulate=True)
        tree.w.index_put_(at, values[idx], accumulate=True)
        tree.vl.index_put_(
            at, (-cfg.virtual_loss * vl_mult[idx]).to(torch.int32),
            accumulate=True)
        cur = torch.where(upd, p, cur)
        active = upd


def _log_gamma(alpha: float, shape, gen: torch.Generator, device):
    """log of Gamma(alpha, 1) draws: Marsaglia-Tsang on alpha + 1 with the
    U^(1/alpha) boost for alpha < 1, in log space (a draw for alpha = 0.03
    underflows float32 as a plain value)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        take = todo & ok
        out = torch.where(take, math.log(d) + torch.log(v.clamp(min=1e-30)),
                          out)
        todo = todo & ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=gen, device=device)
        out = out + torch.log(u) / alpha
    return out


def dirichlet_noise(legal: torch.Tensor, alpha: float,
                    gen: torch.Generator) -> torch.Tensor:
    """f32 [B, A] Dirichlet(alpha) draws over each row's legal actions
    (normalized gamma draws; zero on illegal actions)."""
    lg = _log_gamma(alpha, legal.shape, gen, legal.device)
    lg = torch.where(legal, lg, -math.inf)
    top = lg.amax(dim=1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    noise = torch.where(legal, torch.exp(lg - top), 0.0)
    return noise / noise.sum(dim=1, keepdim=True).clamp(min=1e-10)


def gumbel_categorical(logits: torch.Tensor,
                       gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row (argmax of logits + Gumbel noise, as
    jax.random.categorical)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def mcts_root_prepare(root_core: GoCore, root_hist: torch.Tensor,
                      root_hist_len: torch.Tensor, eval_fn: EvalFn,
                      gen: torch.Generator, cfg: MCTSConfig,
                      size: int) -> Tree:
    """Phase 1: a fresh tree whose root is evaluated (+ Dirichlet noise)."""
    B = root_core.stones.shape[0]
    dev = root_core.stones.device
    rows = torch.arange(B, device=dev)
    root_ids = torch.zeros((B,), dtype=torch.long, device=dev)

    tree = _make_tree(B, size, cfg.num_nodes, dev)
    _write_core(tree, root_ids, root_core,
                torch.ones((B,), dtype=torch.bool, device=dev))
    tree.terminal[:, 0] = engine.is_terminal_core(root_core, size)
    root_terminal = tree.terminal[:, 0].clone()

    root_legal = engine.legal_moves(root_core, size)
    snaps, valid = _leaf_snapshots(tree, rows, root_ids, root_hist,
                                   root_hist_len)
    raw_prior, value = _evaluate_states(
        _core_at(tree, rows, root_ids), root_terminal, snaps, valid,
        root_legal, eval_fn, gen, cfg, size,
        last_is_pass=root_core.last_move >= size * size,
    )
    prior = raw_prior
    if cfg.root_epsilon > 0:
        legal = prior >= 0
        noise = dirichlet_noise(legal, cfg.root_alpha, gen)
        base = prior.clamp(min=0.0)
        base = base / base.sum(dim=1, keepdim=True).clamp(min=1e-10)
        mixed = (1 - cfg.root_epsilon) * base + cfg.root_epsilon * noise
        prior = torch.where(legal, mixed, -1.0)
    tree.prior[:, 0] = prior.to(torch.bfloat16)
    tree.value[:, 0] = value
    tree.expanded[:, 0] = True
    tree.root_raw_prior.copy_(raw_prior)
    return tree


def mcts_simulate(tree: Tree, root_hist: torch.Tensor,
                  root_hist_len: torch.Tensor, eval_fn: EvalFn,
                  gen: torch.Generator, cfg: MCTSConfig, size: int,
                  n_batches: int, game_hash_hist=None,
                  batch_offset: int = 0) -> Tree:
    """Phase 2: `n_batches` simulation batches, each `rollouts_per_batch`
    select/expand passes + one fused leaf evaluation + one backprop walk."""
    B, N = tree.stones.shape[:2]
    dev = tree.stones.device
    rows = torch.arange(B, device=dev)
    A = size * size + 1
    m = max(1, cfg.rollouts_per_batch)
    mB = m * B

    budget = None
    if cfg.white_num_rollouts > 0:
        black_nb = max(1, cfg.num_rollouts // m)
        white_nb = max(1, cfg.white_num_rollouts // m)
        opts_player = BLACK if cfg.white_opts_on_black else engine.WHITE
        budget = torch.where(tree.to_play[:, 0] == opts_player,
                             white_nb, black_nb)
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev),
                         -1)[:, :, None]
    flat_rows = rows.repeat(m)

    for batch_idx in range(batch_offset, batch_offset + n_batches):
        active = None if budget is None else (batch_idx < budget)
        leaves = torch.stack([
            _select_and_expand(tree, cfg, size, game_hash_hist, active)
            for _ in range(m)
        ])                                                  # [m, B]

        # ---- one fused NN evaluation over all m*B leaves ----
        safe = leaves.reshape(mB).clamp(0, N - 1)
        flat_core = _core_at(tree, flat_rows, safe)
        flat_term = tree.terminal[flat_rows, safe]
        snaps, valid = _leaf_snapshots(tree, flat_rows, safe, root_hist,
                                       root_hist_len)
        flat_legal = tree.prior[flat_rows, safe] >= 0
        flat_lip = tree.parent_a[flat_rows, safe].long() == A - 1
        priors, values = _evaluate_states(
            flat_core, flat_term, snaps, valid, flat_legal, eval_fn, gen,
            cfg, size, last_is_pass=flat_lip,
        )
        # superko-terminal leaves keep the stored next-player-wins value
        flat_sk = tree.superko[flat_rows, safe]
        values = torch.where(flat_sk, tree.value[flat_rows, safe], values)

        # a leaf selected k > 1 times in this batch backprops once (its
        # first occurrence) but removes all k virtual losses
        eq = leaves[:, None, :] == leaves[None, :, :]       # [m, m, B]
        flat_dup = (eq & earlier).any(dim=1).reshape(mB)
        dup_count = eq.sum(dim=1, dtype=torch.int32).reshape(mB)

        # first occurrence of each fresh non-terminal leaf writes its
        # prior, value and expanded flag; terminal leaves their value
        write = ~flat_dup & ~tree.expanded[flat_rows, safe] & ~flat_term
        at = write.nonzero().squeeze(1)
        tree.prior[flat_rows[at], safe[at]] = priors[at].to(torch.bfloat16)
        tree.expanded[flat_rows[at], safe[at]] = True
        at = ((write | flat_term) & ~flat_dup).nonzero().squeeze(1)
        tree.value[flat_rows[at], safe[at]] = values[at]

        active0 = (~tree.terminal[:, 0]).repeat(m) & ~flat_dup
        if active is not None:
            active0 = active0 & active.repeat(m)
        _backprop_multi(tree, flat_rows, safe, values, active0, dup_count, cfg)
    return tree


def mcts_finalize(tree: Tree, gen: torch.Generator,
                  cfg: MCTSConfig) -> MCTSResult:
    """Phase 3: the root statistics as an MCTSResult."""
    B = tree.stones.shape[0]
    dev = tree.stones.device
    n_root, w_root, _ = _edge_stats(
        tree, torch.zeros((B,), dtype=torch.long, device=dev))
    root_prior = tree.prior[:, 0].float()
    legal_root = root_prior >= 0
    visits = torch.where(legal_root, n_root.float(), 0.0)
    mcts_policy = visits / visits.sum(dim=1, keepdim=True).clamp(min=1e-10)
    if cfg.pick_method == "prior":
        best = torch.argmax(torch.where(legal_root, root_prior, -1.0), dim=1)
    elif cfg.pick_method == "uniform_random":
        best = gumbel_categorical(torch.where(legal_root, 0.0, -1e9), gen)
    else:  # most_visited
        best = torch.argmax(visits + 1e-6 * root_prior.clamp(min=0.0), dim=1)
    root_q = w_root.sum(dim=1) / visits.sum(dim=1).clamp(min=1.0)
    return MCTSResult(
        mcts_policy=mcts_policy,
        best_action=best.to(torch.int32),
        root_value=tree.value[:, 0].clone(),
        root_q=root_q,
    )


def run_mcts(
    root_core: GoCore,
    root_hist: torch.Tensor,       # int8 [B, 8, n2] game snapshots, oldest first
    root_hist_len: torch.Tensor,   # int32 [B]
    eval_fn: EvalFn,
    gen: torch.Generator,
    cfg: MCTSConfig,
    size: int,
    init_tree: Optional[Tree] = None,
    game_hash_hist=None,           # (hash_hist_lo, hash_hist_hi, nhash)
    root_last_placed: Optional[torch.Tensor] = None,
    device: DeviceLike = "cuda",
) -> Tuple[MCTSResult, Tree]:
    """cfg.num_rollouts simulations for B boards in lockstep (prepare ->
    simulate -> finalize).  All tensors must lie on `device`, and `gen`
    must be a torch.Generator of that device."""
    dev = resolve_device(device)
    check_supported(cfg)
    if init_tree is not None:
        raise NotImplementedError("init_tree (persistent tree reuse)")
    if root_last_placed is not None:
        raise NotImplementedError("root_last_placed (df features)")
    if root_core.stones.device != dev:
        raise ValueError(f"root_core lies on {root_core.stones.device}, "
                         f"run_mcts was asked for {dev}")
    tree = mcts_root_prepare(root_core, root_hist, root_hist_len, eval_fn,
                             gen, cfg, size)
    m = max(1, cfg.rollouts_per_batch)
    n_batches = max(1, max(cfg.num_rollouts, cfg.white_num_rollouts) // m)
    mcts_simulate(tree, root_hist, root_hist_len, eval_fn, gen, cfg, size,
                  n_batches, game_hash_hist=game_hash_hist)
    return mcts_finalize(tree, gen, cfg), tree
