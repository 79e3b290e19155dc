"""Batched array-of-trees PUCT search: counterpart of
`elf_tpu/search/mcts.py` (reference `tree_search.h:327`, `mcts/mcts.h`).

A batch of B trees lives in ``[B, num_nodes, ...]`` tensors; every phase is
a lockstep tensor op over the B trees:

  select   argmax-PUCT descent (first-play urgency, virtual loss), one
           rollout at a time, `rollouts_per_batch` rollouts per batch;
  expand   one child per tree per rollout by stepping the Go engine (the
           step's liberty analysis is the CUDA `step_analysis` kernel on
           the card);
  evaluate one NN forward over all B * rollouts_per_batch leaves (or
           sequential chunks of `eval_chunk` leaves), with a random D4
           symmetry per leaf and the terminal Tromp-Taylor shortcut; the
           leaf's planes are AGZ-18 (8 snapshots up the parent chain) or
           df-25 (`feature_set="df"`: placement plies up the parent chain
           from the game's `root_last_placed`);
  backprop visit counts and values up the parent chains; a leaf selected
           several times in one batch backprops once and removes all its
           virtual losses (tree_search.h:255).

Edge statistics live on the child node (an edge without a child has
n = w = vl = 0); `prior` is bf16 and encodes legality (-1 illegal, 0
legal-but-unevaluated); child / parent ids are int16, widened to long at
every gather.  Unlike the JAX functions, these update the tree in place.

Tree reuse across moves (`fresh_tree`, `advance_tree`, `reset_tree_where`,
`run_mcts(init_tree=...)`) keeps the played line's subtree and its stats.

`batched_writes` takes "auto", "on" and "off", and every value runs the
same direct writes: the JAX package's deferred-write overlay exists
because every XLA scatter is a full-array pass, and both of its paths give
the direct-write path's trees.  With `max_batches_per_call` `run_mcts`
calls `mcts_simulate` in chunks of that many batches (the JAX actor's
host-chunked search), each with its cumulative batch offset.  The
data-dependent loops (descent, ancestor walk, backprop, fixpoints) check
their end condition on the host once per step.

While tracing is on (`profiling`), each simulation batch records the
spans `elf.mcts.select_expand`, `elf.mcts.evaluate` and `elf.mcts.backprop`
and counts `search.batches`, every host read of a device value that
`mcts_simulate` and its callees make (each through `profiling.read`)
counts `search.host_reads`, and `mcts_root_prepare` records
`elf.mcts.prepare`.

A search over boards split across dp ranks (`shard`, a `BoardRows`) makes
every random draw for all the boards on every rank and keeps its own
rows, so each board's search is the unsharded one's.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go.engine import BLACK, GoCore
from elf_tpu_torch.env.go.features import (
    extract_agz_from_snapshots,
    extract_df_parts,
    inv_transform_policy,
)
from elf_tpu_torch.profiling import count, read, reads_counted_as, span

NEG_INF = -1e9
_KO_INACTIVE = 10_000


class BoardRows(NamedTuple):
    """The boards [lo, hi) of `total` that this rank searches, when the
    boards are split over dp ranks.  `gather(mask)` is collective: the
    [total] bool mask (host) of every rank's [hi - lo] masks."""

    lo: int
    hi: int
    total: int
    gather: Callable[[np.ndarray], np.ndarray]


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
    """Raise ValueError for an option value the search does not know."""
    if cfg.feature_set not in ("agz", "df"):
        raise ValueError(f"feature_set={cfg.feature_set!r}")
    if cfg.batched_writes not in ("auto", "on", "off"):
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
    while read(active.any()):
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
    while depth < cfg.max_depth and not read(done.all()):
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


def _leaf_last_placed(tree: Tree, rows: torch.Tensor, leaf: torch.Tensor,
                      root_lp: torch.Tensor, size: int) -> torch.Tensor:
    """int32 [K, n2]: per-point 1-based placement ply at `leaf` (the df
    planes' history input, board.cc _infos[].last_placed).

    The edge into a node X placed a stone at parent_a[X], at the 1-based
    ply tree.ply[X].  Walking leaf -> root meets the latest placements
    first, so the first write to a point wins, as the last placement wins
    in forward play; below the root the game's `root_lp` [B, n2] fills
    the rest."""
    K = leaf.shape[0]
    n2 = size * size
    N = tree.stones.shape[1]
    pts = torch.arange(n2, device=leaf.device)[None, :]
    lp = torch.zeros((K, n2), dtype=torch.int32, device=leaf.device)
    filled = torch.zeros((K, n2), dtype=torch.bool, device=leaf.device)
    cur = leaf
    active = torch.ones((K,), dtype=torch.bool, device=leaf.device)
    while read(active.any()):
        safe = cur.clamp(0, N - 1)
        a = tree.parent_a[rows, safe].long()
        parent = tree.parent[rows, safe].long()
        is_stone = active & (parent >= 0) & (a >= 0) & (a < n2)
        onehot = (pts == a[:, None]) & is_stone[:, None] & ~filled
        lp = torch.where(onehot, tree.ply[rows, safe].to(torch.int32)[:, None],
                         lp)
        filled |= onehot
        active = active & (parent >= 0)
        cur = torch.where(active, parent, cur)
    return torch.where(filled, lp, root_lp[rows])


def _draw_codes(K: int, gen: torch.Generator, cfg: MCTSConfig,
                device) -> torch.Tensor:
    """One D4 code per leaf: random with `rotation_flip`, else 0.  Drawn for
    a whole simulation batch at once, so `eval_chunk` changes no draw."""
    if cfg.rotation_flip:
        return torch.randint(0, 8, (K,), generator=gen, device=device)
    return torch.zeros((K,), dtype=torch.long, device=device)


def _root_codes(fresh: torch.Tensor, B: int, gen: torch.Generator,
                cfg: MCTSConfig, device,
                shard: Optional[BoardRows]) -> Optional[torch.Tensor]:
    """The D4 codes of the roots to evaluate (`fresh`, local ids), drawn for
    the fresh roots of every rank; None when no root is fresh here."""
    if shard is None or not cfg.rotation_flip:
        if not fresh.numel():
            return None
        return _draw_codes(fresh.numel(), gen, cfg, device)
    local = np.zeros(B, bool)
    local[fresh.cpu().numpy()] = True
    every = shard.gather(local)
    if not every.any():
        return None
    codes = _draw_codes(int(every.sum()), gen, cfg, device)
    # each fresh board's place among every rank's fresh boards
    at = (np.cumsum(every) - 1)[shard.lo:shard.hi][local]
    return codes[torch.from_numpy(at).to(device)] if fresh.numel() else None


def _leaf_codes(m: int, B: int, gen: torch.Generator, cfg: MCTSConfig,
                device, shard: Optional[BoardRows]) -> torch.Tensor:
    """The D4 codes of a simulation batch's m * B leaves ([m, B] order),
    drawn for every rank's boards."""
    if shard is None:
        return _draw_codes(m * B, gen, cfg, device)
    codes = _draw_codes(m * shard.total, gen, cfg, device)
    return codes.view(m, shard.total)[:, shard.lo:shard.hi].reshape(-1)


def _evaluate_states(core: GoCore, is_term: torch.Tensor, hist,
                     legal: torch.Tensor, eval_fn: EvalFn,
                     codes: torch.Tensor, cfg: MCTSConfig, size: int,
                     last_is_pass: torch.Tensor):
    """Evaluate K gathered states: (prior [K, A] f32, value [K] black
    persp.), with pass gating (mcts.h post_nn_result +
    remove_pass_if_dangerous) and the terminal TT shortcut.  `hist` is
    (snaps, valid) for the AGZ planes, or the df planes' per-point
    placement plies [K, n2]."""
    n2 = size * size
    if cfg.feature_set == "df":
        ko_active = (core.ko_age == 0) & (core.ko_point >= 0)
        feats = extract_df_parts(core.stones, core.to_play, core.ko_point,
                                 ko_active, core.ply, hist, codes, size)
    else:
        feats = extract_agz_from_snapshots(*hist, core.to_play, codes, size)
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
    while read(active.any()):
        safe = cur.clamp(0, N - 1)
        p = tree.parent[rows, safe].long()
        upd = active & (p >= 0)
        idx = read(upd, torch.nonzero).squeeze(1)
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


def _drawn_rows(shape, shard: Optional[BoardRows]):
    """The shape to draw for `shape`'s rows: every rank's boards."""
    return shape if shard is None else (shard.total,) + tuple(shape[1:])


def _own_rows(x: torch.Tensor, shard: Optional[BoardRows]) -> torch.Tensor:
    return x if shard is None else x[shard.lo:shard.hi]


def dirichlet_noise(legal: torch.Tensor, alpha: float,
                    gen: torch.Generator,
                    shard: Optional[BoardRows] = None) -> torch.Tensor:
    """f32 [B, A] Dirichlet(alpha) draws over each row's legal actions
    (normalized gamma draws; zero on illegal actions)."""
    lg = _own_rows(_log_gamma(alpha, _drawn_rows(legal.shape, shard), gen,
                              legal.device), shard)
    lg = torch.where(legal, lg, -math.inf)
    top = lg.amax(dim=1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    noise = torch.where(legal, torch.exp(lg - top), 0.0)
    return noise / noise.sum(dim=1, keepdim=True).clamp(min=1e-10)


def gumbel_categorical(logits: torch.Tensor, gen: torch.Generator,
                       shard: Optional[BoardRows] = None) -> torch.Tensor:
    """One categorical draw per row (argmax of logits + Gumbel noise, as
    jax.random.categorical)."""
    u = _own_rows(torch.rand(_drawn_rows(logits.shape, shard), generator=gen,
                             device=logits.device), shard)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def fresh_tree(B: int, size: int, capacity: int, root_core: GoCore) -> Tree:
    """An empty tree of `capacity` nodes (clamped to 32767) per board whose
    unexpanded root is `root_core`: where a persistent-tree search starts."""
    tree = _make_tree(B, size, capacity, root_core.stones.device)
    root = torch.zeros((B,), dtype=torch.long, device=root_core.stones.device)
    _write_core(tree, root, root_core, torch.ones_like(root, dtype=torch.bool))
    tree.terminal[:, 0] = engine.is_terminal_core(root_core, size)
    return tree


def reset_tree_where(tree: Tree, mask: torch.Tensor, root_core: GoCore) -> Tree:
    """Make the trees of boards where `mask` is True fresh one-node trees
    rooted at `root_core` (their games restarted); in place."""
    B, N = tree.stones.shape[:2]
    size = math.isqrt(tree.stones.shape[2])
    fresh = fresh_tree(B, size, N, root_core)
    for have, new in zip(tree, fresh):
        m = mask.reshape((B,) + (1,) * (have.ndim - 1))
        have.copy_(torch.where(m, new, have))
    return tree


def _subtree_members(parent: torch.Tensor, new_root: torch.Tensor,
                     alloc: torch.Tensor) -> torch.Tensor:
    """bool [B, N]: the allocated nodes whose ancestor chain reaches
    `new_root` [B] (-1: none), the root included.  Pointer jumping over
    `parent` (ids < 0: no parent) for ceil(log2 N) + 1 rounds covers every
    chain of up to N nodes with no host sync; the set equals the
    parent-by-parent fixpoint's."""
    B, N = parent.shape
    dev = parent.device
    anc = torch.where(parent >= 0, parent.long(), N)
    anc = torch.cat([anc, torch.full((B, 1), N, dtype=torch.long, device=dev)],
                    dim=1)                                  # N: no ancestor
    hit = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    hit[:, :N] = (torch.arange(N, device=dev)[None, :] == new_root[:, None])
    for _ in range(max(1, math.ceil(math.log2(N))) + 1):
        hit = hit | torch.gather(hit, 1, anc)
        anc = torch.gather(anc, 1, anc)
    return hit[:, :N] & alloc


def advance_tree(tree: Tree, actions: torch.Tensor, new_root_core: GoCore,
                 size: int, capacity: int) -> Tree:
    """Re-root each tree at the played action's child, keeping its subtree
    and stats (tree_search_node.h:420 `treeAdvance`): node ids are compacted
    in allocation order (parents before children, so the new root becomes
    node 0), node-id-valued fields are remapped and the other nodes are
    dropped.  A board whose action has no child gets a fresh one-node tree.
    The new root's core is the stepped game's (`new_root_core`), and its
    stored prior, never noised, becomes `root_raw_prior`.  Returns a new
    Tree; `tree` is left as it was."""
    B, N = tree.stones.shape[:2]
    A = tree.prior.shape[2]
    dev = tree.stones.device
    rows = torch.arange(B, device=dev)
    a = actions.long().clamp(0, A - 1)

    new_root = tree.child[rows, 0, a].long()
    alloc = torch.arange(N, device=dev)[None, :] < tree.count[:, None]
    member = _subtree_members(tree.parent, new_root, alloc)
    new_id = torch.cumsum(member.long(), dim=1) - 1        # valid on members

    # node-id-valued fields point into the new numbering, -1 outside it
    child = tree.child.long()
    cs = child.clamp(0, N - 1)
    r3 = rows[:, None, None]
    child_remap = torch.where(member[r3, cs] & (child >= 0), new_id[r3, cs], -1)
    parent = tree.parent.long()
    ps = parent.clamp(0, N - 1)
    r2 = rows[:, None]
    parent_remap = torch.where(member[r2, ps] & (parent >= 0), new_id[r2, ps],
                               -1)

    # members scatter to their new ids, the rest into a dump slot at
    # `capacity` that is cut off
    pos = torch.where(member, new_id, capacity)
    fills = {
        "ko_point": -1, "ko_age": _KO_INACTIVE, "prior": -1.0, "child": -1,
        "parent": -1, "parent_a": -1,
    }

    def scatter(name, arr):
        out = torch.full((B, capacity + 1) + arr.shape[2:], fills.get(name, 0),
                         dtype=arr.dtype, device=dev)
        out[r2, pos] = arr
        return out[:, :capacity]

    src = tree._replace(child=child_remap.to(torch.int16),
                        parent=parent_remap.to(torch.int16))
    new = Tree(**{
        name: scatter(name, arr)
        for name, arr in src._asdict().items()
        if name not in ("count", "root_raw_prior")
    }, count=member.sum(dim=1, dtype=torch.int32).clamp(min=1),
        root_raw_prior=torch.empty((B, A), device=dev))
    new.root_raw_prior.copy_(new.prior[:, 0].float())
    # the new root: the game's stepped core, detached from its old parent
    _write_core(new, torch.zeros_like(rows), new_root_core,
                torch.ones_like(rows, dtype=torch.bool))
    new.parent[:, 0] = -1
    new.parent_a[:, 0] = -1
    new.terminal[:, 0] = engine.is_terminal_core(new_root_core, size)
    return new


def _root_lp(root_last_placed: Optional[torch.Tensor], B: int, size: int,
             device) -> torch.Tensor:
    """The game's placement plies [B, n2] for df leaves (zeros if None)."""
    if root_last_placed is not None:
        return root_last_placed
    return torch.zeros((B, size * size), dtype=torch.int32, device=device)


def mcts_root_prepare(root_core: GoCore, root_hist: torch.Tensor,
                      root_hist_len: torch.Tensor, eval_fn: EvalFn,
                      gen: torch.Generator, cfg: MCTSConfig, size: int,
                      init_tree: Optional[Tree] = None,
                      root_last_placed: Optional[torch.Tensor] = None,
                      shard: Optional[BoardRows] = None) -> Tree:
    """Phase 1: adopt `init_tree` (in place) or make a fresh tree, evaluate
    the roots that are not expanded yet, and mix Dirichlet noise into every
    root's raw prior.  A reused root keeps its value and its stored raw
    prior, so noise never compounds across moves.  `root_last_placed`
    [B, n2]: the game's placement plies, which df planes read."""
    with span("elf.mcts.prepare"):
        B = root_core.stones.shape[0]
        dev = root_core.stones.device
        if init_tree is None:
            tree = fresh_tree(B, size, cfg.num_nodes, root_core)
        else:
            tree = init_tree

        fresh = (~tree.expanded[:, 0]).nonzero().squeeze(1)
        raw_prior = tree.root_raw_prior.clone()
        codes = _root_codes(fresh, B, gen, cfg, dev, shard)
        if fresh.numel():
            root_ids = torch.zeros_like(fresh)
            sub_core = GoCore(*(t[fresh] for t in root_core))
            if cfg.feature_set == "df":
                hist = _root_lp(root_last_placed, B, size, dev)[fresh]
            else:
                hist = _leaf_snapshots(tree, fresh, root_ids, root_hist,
                                       root_hist_len)
            prior_eval, value_eval = _evaluate_states(
                _core_at(tree, fresh, root_ids), tree.terminal[fresh, 0],
                hist, engine.legal_moves(sub_core, size), eval_fn, codes,
                cfg, size, last_is_pass=sub_core.last_move >= size * size,
            )
            raw_prior[fresh] = prior_eval
            tree.value[fresh, 0] = value_eval
        prior = raw_prior
        if cfg.root_epsilon > 0:
            legal = prior >= 0
            noise = dirichlet_noise(legal, cfg.root_alpha, gen, shard)
            base = prior.clamp(min=0.0)
            base = base / base.sum(dim=1, keepdim=True).clamp(min=1e-10)
            mixed = (1 - cfg.root_epsilon) * base + cfg.root_epsilon * noise
            prior = torch.where(legal, mixed, -1.0)
        tree.prior[:, 0] = prior.to(torch.bfloat16)
        tree.expanded[:, 0] = True
        tree.root_raw_prior.copy_(raw_prior)
        return tree


@reads_counted_as("search.host_reads")
def mcts_simulate(tree: Tree, root_hist: torch.Tensor,
                  root_hist_len: torch.Tensor, eval_fn: EvalFn,
                  gen: torch.Generator, cfg: MCTSConfig, size: int,
                  n_batches: int, game_hash_hist=None,
                  batch_offset: int = 0,
                  root_last_placed: Optional[torch.Tensor] = None,
                  shard: Optional[BoardRows] = None) -> Tree:
    """Phase 2: `n_batches` simulation batches, each `rollouts_per_batch`
    select/expand passes + one fused leaf evaluation + one backprop walk.

    `batch_offset`: the index of the first batch in the whole search (a
    search run in several calls passes its cumulative count, so that the
    per-player budgets of `white_num_rollouts` count across calls).  The
    leaves of a batch are evaluated in one forward, or, where `eval_chunk`
    divides the m * B leaves into more than one part, in sequential forwards
    of `eval_chunk` leaves (the JAX condition, `elf_tpu/search/mcts.py:1297`);
    their D4 codes are drawn for the whole batch first, so chunking changes
    no draw."""
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
    c = cfg.eval_chunk
    chunk = c if c and mB > c and mB % c == 0 else mB
    df = cfg.feature_set == "df"
    if df:
        root_lp = _root_lp(root_last_placed, B, size, dev)

    for batch_idx in range(batch_offset, batch_offset + n_batches):
        active = None if budget is None else (batch_idx < budget)
        with span("elf.mcts.select_expand"):
            leaves = torch.stack([
                _select_and_expand(tree, cfg, size, game_hash_hist, active)
                for _ in range(m)
            ])                                                  # [m, B]

        # ---- one fused NN evaluation over all m*B leaves ----
        with span("elf.mcts.evaluate"):
            safe = leaves.reshape(mB).clamp(0, N - 1)
            flat_core = _core_at(tree, flat_rows, safe)
            flat_term = tree.terminal[flat_rows, safe]
            if df:
                hist = _leaf_last_placed(tree, flat_rows, safe, root_lp,
                                         size)
            else:
                hist = _leaf_snapshots(tree, flat_rows, safe, root_hist,
                                       root_hist_len)
            flat_legal = tree.prior[flat_rows, safe] >= 0
            flat_lip = tree.parent_a[flat_rows, safe].long() == A - 1
            codes = _leaf_codes(m, B, gen, cfg, dev, shard)
            parts = [
                _evaluate_states(
                    GoCore(*(t[sl] for t in flat_core)), flat_term[sl],
                    hist[sl] if df else (hist[0][sl], hist[1][sl]),
                    flat_legal[sl], eval_fn, codes[sl], cfg, size,
                    last_is_pass=flat_lip[sl])
                for sl in (slice(s, s + chunk) for s in range(0, mB, chunk))
            ]
            priors = torch.cat([p for p, _ in parts])
            values = torch.cat([v for _, v in parts])
            # superko-terminal leaves keep the stored next-player-wins
            # value
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
            at = read(write, torch.nonzero).squeeze(1)
            tree.prior[flat_rows[at], safe[at]] = priors[at].to(
                torch.bfloat16)
            tree.expanded[flat_rows[at], safe[at]] = True
            at = read((write | flat_term) & ~flat_dup,
                      torch.nonzero).squeeze(1)
            tree.value[flat_rows[at], safe[at]] = values[at]

        with span("elf.mcts.backprop"):
            active0 = (~tree.terminal[:, 0]).repeat(m) & ~flat_dup
            if active is not None:
                active0 = active0 & active.repeat(m)
            _backprop_multi(tree, flat_rows, safe, values, active0,
                            dup_count, cfg)
        count("search.batches")
    return tree


def total_batches(cfg: MCTSConfig) -> int:
    """Simulation batches in one search: the larger budget over m."""
    m = max(1, cfg.rollouts_per_batch)
    return max(1, max(cfg.num_rollouts, cfg.white_num_rollouts) // m)


def mcts_finalize(tree: Tree, gen: torch.Generator, cfg: MCTSConfig,
                  shard: Optional[BoardRows] = None) -> MCTSResult:
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
        best = gumbel_categorical(torch.where(legal_root, 0.0, -1e9), gen,
                                  shard)
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
    root_last_placed: Optional[torch.Tensor] = None,  # int32 [B, n2], df
    device: DeviceLike = "cuda",
    simulate_s: Optional[list] = None,
    shard: Optional[BoardRows] = None,
) -> Tuple[MCTSResult, Tree]:
    """cfg.num_rollouts simulations for B boards in lockstep (prepare ->
    simulate -> finalize).  All tensors must lie on `device`, and `gen`
    must be a torch.Generator of that device.

    `init_tree`: a tree from `fresh_tree` or `advance_tree`, searched on in
    place (its stats carry over; fresh noise is mixed into the reused roots'
    raw priors); the returned tree is that object.

    The simulation runs in `mcts_simulate` calls of at most
    `cfg.max_batches_per_call` batches (all in one call when it is 0), each
    given its cumulative batch offset: the same draws in the same order, so
    the same result as one call.  `simulate_s`, where given, receives the
    host seconds of each call.  `shard`: this rank's share of boards split
    over dp ranks (`BoardRows`; every rank calls run_mcts together)."""
    dev = resolve_device(device)
    check_supported(cfg)
    if root_core.stones.device != dev:
        raise ValueError(f"root_core lies on {root_core.stones.device}, "
                         f"run_mcts was asked for {dev}")
    tree = mcts_root_prepare(root_core, root_hist, root_hist_len, eval_fn,
                             gen, cfg, size, init_tree=init_tree,
                             root_last_placed=root_last_placed, shard=shard)
    total = total_batches(cfg)
    chunk = min(cfg.max_batches_per_call or total, total)
    for offset in range(0, total, chunk):
        t0 = time.perf_counter()
        mcts_simulate(tree, root_hist, root_hist_len, eval_fn, gen, cfg, size,
                      min(chunk, total - offset),
                      game_hash_hist=game_hash_hist, batch_offset=offset,
                      root_last_placed=root_last_placed, shard=shard)
        if simulate_s is not None:
            simulate_s.append(time.perf_counter() - t0)
    if shard is None:
        return mcts_finalize(tree, gen, cfg), tree
    return mcts_finalize(tree, gen, cfg, shard), tree
