"""Traffic kind "selfplay": lockstep self-play through the program's
`SelfplayActor.play_moves`, one move per call, every board from the empty
board, the net's weights drawn from the seed.  A closed loop: each move
waits for the last.  The unit of work is one lockstep move of all boards;
the work is the search's simulations, boards x rollouts per move.

Traffic parameters: boards, rollouts, rollouts_per_batch, c_puct,
virtual_loss, root_epsilon, root_alpha, ply_pass_enabled, rotation_flip,
eval_chunk, batched_writes, max_batches_per_call, policy_distri_cutoff,
resign_thres, never_resign_prob, warm_moves (set-up), trace_moves (the
traced window), check_boards and check_nodes (the sample the search and
net check reads).

The check, after the window (`check`):
  engine   every board's game replayed from the empty board by the
           reference engine: each move legal, and the program's position
           equal to the reference's after the warm-up and after every
           window move; in the last move's search trees of `check_boards`
           boards drawn from the seed, every edge's child position equal to
           the reference step of its parent, and every expanded node's
           legal points equal to the reference's;
  search   in those trees: each node's visits one more than its children's
           (a terminal node: its own visits), its value sum likewise, no
           virtual loss left, the root's result (visit distribution, Q)
           recomputed from the tree, and each board's played move one the
           search visited (the most visited past the sampling cutoff);
  net      at up to `check_nodes` expanded nodes of those trees, the
           reference net on planes it builds itself from the reference
           positions, under each of the eight symmetries: the program's
           stored prior over legal points and its value against the
           reference's under the symmetry that fits best.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import core, weights
from harness.gocheck import program_position, replay_games
from harness.trace import WINDOW, Tracer
from reference import agz, go


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_config(cfg: dict):
    from elf_tpu_torch.models.resnet import ModelConfig

    return ModelConfig(board_size=cfg["board_size"],
                       num_planes=cfg["num_planes"],
                       num_block=cfg["num_block"], dim=cfg["dim"],
                       value_hidden=cfg["value_hidden"],
                       use_bf16=cfg["conv_dtype"] == "bfloat16")


def port_net(cfg: dict, W: dict, dev):
    """The program's net, built on the device, holding a copy of W."""
    from elf_tpu_torch.models.resnet import PolicyValueNet

    with torch.device(dev):
        net = PolicyValueNet(model_config(cfg))
    net.load_state_dict(W)
    return net.eval()


def run(ctx) -> core.Measured:
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    W = weights.make(cfg, ctx.reference, core.sub_seed(ctx.seed, 0), dev)
    net = port_net(cfg, W, dev)
    counters = {"eval_rows": 0, "simulate_s": 0.0}
    counting = [False]

    def builder(params, batch_stats):
        fn = eval_fn_builder(params, batch_stats)

        def eval_fn(feats, to_play):
            with ctx.spans("net"):
                out = fn(feats, to_play)
            if counting[0]:
                counters["eval_rows"] += feats.shape[0]
            return out

        return eval_fn

    B = tr["boards"]
    actor = SelfplayActor(
        ActorConfig(board_size=cfg["board_size"], batch=B, komi=cfg["komi"],
                    policy_distri_cutoff=tr["policy_distri_cutoff"],
                    resign_thres=tr["resign_thres"],
                    never_resign_prob=tr["never_resign_prob"]),
        MCTSConfig(num_rollouts=tr["rollouts"],
                   rollouts_per_batch=tr["rollouts_per_batch"],
                   c_puct=tr["c_puct"], virtual_loss=tr["virtual_loss"],
                   root_epsilon=tr["root_epsilon"],
                   root_alpha=tr["root_alpha"],
                   ply_pass_enabled=tr["ply_pass_enabled"],
                   rotation_flip=tr["rotation_flip"],
                   eval_chunk=tr["eval_chunk"],
                   batched_writes=tr["batched_writes"],
                   max_batches_per_call=tr["max_batches_per_call"]),
        builder, seed=core.sub_seed(ctx.seed, 1), device=dev)
    kept = {}
    search = actor._search

    def keep_search(state, eval_fn):
        kept.clear()
        res, tree = search(state, eval_fn)
        kept.update(res=res, tree=tree)
        return res, tree

    actor._search = keep_search
    ended = {}              # board -> the move strings of its ended games
    for _ in range(tr["warm_moves"]):
        for r in actor.play_moves(net, None, 1):
            ended.setdefault(r.thread_id, []).append(r.result.content)
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    snaps = {tr["warm_moves"]: program_position(actor.state.core)}
    tracer = Tracer() if ctx.trace else None
    limit = tr["trace_moves"] if ctx.trace else None
    counting[0] = True
    units = 0
    if tracer:
        tracer.start()
    ends = []
    t0 = time.perf_counter()
    with ctx.spans(WINDOW):
        while time.perf_counter() - t0 < ctx.seconds and (
                limit is None or units < limit):
            with ctx.spans("actor"):
                recs = actor.play_moves(net, None, 1)
            _sync(dev)
            for r in recs:
                ended.setdefault(r.thread_id, []).append(r.result.content)
            counters["simulate_s"] += sum(actor.simulate_s)
            units += 1
            ends.append(time.perf_counter() - t0)
            snaps[tr["warm_moves"] + units] = program_position(
                actor.state.core)
    window_s = time.perf_counter() - t0
    summary = tracer.stop() if tracer else None
    counting[0] = False
    L = tr["warm_moves"] + units
    moves = np.full((B, L), -1, np.int64)
    lost = 0                # live games that did not play every move
    for b in range(B):
        if b not in ended and len(actor.moves[b]) == L:
            moves[b] = actor.moves[b]
        elif b not in ended:
            lost += 1
    payload = dict(
        W=W, snaps=snaps, moves=moves, lost=lost, L=L,
        ended=[c for games in ended.values() for c in games],
        policies=[list(p) for p in actor.policies],
        tree=kept["tree"], res=kept["res"])
    del actor, net, kept
    return core.Measured(
        setup_s=setup_s, window_s=window_s, units=units,
        work={"rollouts": units * B * tr["rollouts"]},
        counters=counters, attempted=units * B, payload=payload,
        trace=summary, unit_ends=ends)


# ----------------------------------------------------------------- check


def _tree_rows(tree, rows):
    return {k: getattr(tree, k)[rows] for k in tree._fields}


def _node_positions(T, root_pos, size):
    """Reference positions of every allocated node of the sampled trees,
    each stepped from its parent's (parents have smaller ids).  Returns
    (positions as [S, N] dicts, legal-edge flag [S, N])."""
    S, N = T["parent"].shape
    dev = T["parent"].device
    n2 = size * size
    pos = {"stones": torch.zeros((S, N, n2), dtype=torch.int8, device=dev),
           "to_play": torch.zeros((S, N), dtype=torch.int8, device=dev),
           "ko": torch.full((S, N), -1, dtype=torch.long, device=dev),
           "ply": torch.zeros((S, N), dtype=torch.long, device=dev),
           "passes": torch.zeros((S, N), dtype=torch.long, device=dev)}
    for k in pos:
        pos[k][:, 0] = root_pos[k]
    edge_ok = torch.ones((S, N), dtype=torch.bool, device=dev)
    alloc = torch.arange(N, device=dev)[None, :] < T["count"].long()[:, None]
    parent = T["parent"].long()
    depth = torch.zeros((S, N), dtype=torch.long, device=dev)
    for x in range(1, N):
        p = parent[:, x].clamp(min=0)
        depth[:, x] = depth.gather(1, p[:, None])[:, 0] + 1
    depth = torch.where(alloc, depth, -1)
    for d in range(1, int(depth.max()) + 1):
        s_idx, x_idx = (depth == d).nonzero(as_tuple=True)
        p_idx = parent[s_idx, x_idx]
        par = {k: v[s_idx, p_idx] for k, v in pos.items()}
        child, legal = go.step(par, T["parent_a"][s_idx, x_idx].long(), size)
        for k in pos:
            pos[k][s_idx, x_idx] = child[k].to(pos[k].dtype)
        edge_ok[s_idx, x_idx] = legal
    return pos, edge_ok, alloc


def _program_nodes(T):
    """The program's node positions in the reference's form ([S, N])."""
    ko_on = (T["ko_age"].long() == 0) & (T["ko_color"] == T["to_play"])
    return {"stones": T["stones"], "to_play": T["to_play"],
            "ko": torch.where(ko_on, T["ko_point"].long(), -1),
            "ply": T["ply"].long(), "passes": T["passes"].long()}


def _ended_games(texts, size, dev, may_resign) -> int:
    """How many of the ended games' records hold an illegal move or end
    where the rules do not end a game."""
    if not texts:
        return 0
    n2 = size * size
    games = [agz.sgf_to_moves(t, size) for t in texts]
    G, T = len(games), max(len(g) for g in games)
    mv = torch.full((G, T), n2, dtype=torch.long, device=dev)
    for i, g in enumerate(games):
        mv[i, :len(g)] = torch.as_tensor(g, dtype=torch.long)
    n = torch.as_tensor([len(g) for g in games], device=dev)
    pos = go.empty_position(G, size, dev)
    bad = torch.zeros(G, dtype=torch.bool, device=dev)
    seen = [pos["stones"]]
    for t in range(T):
        nxt, legal = go.step(pos, mv[:, t], size)
        on = t < n
        bad |= on & ~legal
        pos = {k: torch.where(on.view((-1,) + (1,) * (v.dim() - 1)), nxt[k],
                              v) for k, v in pos.items()}
        seen.append(torch.where(on[:, None] & (mv[:, t] < n2)[:, None],
                                pos["stones"], -1))
    last = torch.stack(seen[:-1], 1)                     # [G, T, n2]
    repeated = (last == pos["stones"][:, None]).all(-1)
    repeated &= torch.arange(T, device=dev)[None, :] < n[:, None]
    ends = (pos["passes"] >= 2) | (n >= 2 * n2 - 1) | repeated.any(1)
    return int((bad | ~(ends | may_resign)).sum())


def check(ctx, m: core.Measured) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ref = ctx.reference
    ref.exact_fp32()
    P = m.payload
    size = cfg["board_size"]
    n2 = size * size
    B = tr["boards"]
    L = P["L"]
    rng = np.random.default_rng([ctx.seed, 7])

    # ---- engine: every board's game, replayed
    moves = torch.as_tensor(P["moves"], device=dev)
    live = torch.as_tensor(P["moves"][:, 0] >= 0, device=dev)
    played = moves.clamp(min=0)
    start = go.empty_position(B, size, dev)
    boards, positions, bad = replay_games(played, start, size, P["snaps"])
    engine_bad = int((bad * live).sum()) + P["lost"]
    failed = int(((bad > 0) & live).sum()) + P["lost"]
    # a game that ended in the run: its record replayed, every move legal
    # and the end one the rules make (two passes, the move cap, a repeated
    # position) or, where the traffic lets players resign, a resignation
    ended_bad = _ended_games(P["ended"], size, dev,
                             tr["never_resign_prob"] < 1.0)
    engine_bad += ended_bad
    failed += ended_bad

    # ---- the last move's trees on a sample of boards
    cand = np.nonzero(P["moves"][:, 0] >= 0)[0]
    if not len(cand):
        return {"engine_mismatches": engine_bad, "_failed": failed}
    rows = np.sort(rng.choice(cand, min(tr["check_boards"], len(cand)),
                              replace=False))
    R = torch.as_tensor(rows, device=dev)
    T = _tree_rows(P["tree"], R)
    S, N = T["parent"].shape
    root_pos = {k: v[R] for k, v in positions[L - 1].items()}
    prog_root = {k: v[:, 0] for k, v in _program_nodes(T).items()}
    search_bad = int((~go.same_position(prog_root, root_pos)).sum())
    pos, edge_ok, alloc = _node_positions(T, root_pos, size)
    prog = _program_nodes(T)
    nonroot = alloc.clone()
    nonroot[:, 0] = False
    same = ((pos["stones"] == prog["stones"]).all(-1)
            & (pos["to_play"] == prog["to_play"]) & (pos["ko"] == prog["ko"])
            & (pos["ply"] == prog["ply"]) & (pos["passes"] == prog["passes"]))
    engine_bad += int((nonroot & ~(same & edge_ok)).sum())
    # the parent's child pointer names the node
    par = T["parent"].long().clamp(min=0)
    pa = T["parent_a"].long().clamp(min=0)
    back = T["child"].long()[torch.arange(S, device=dev)[:, None], par, pa]
    ids = torch.arange(N, device=dev)[None, :]
    search_bad += int((nonroot & (back != ids)).sum())

    expanded = T["expanded"] & alloc & ~T["terminal"]
    ex_s, ex_x = expanded.nonzero(as_tuple=True)
    flat = {k: v[ex_s, ex_x] for k, v in pos.items()}
    legal_ref = go.legal_mask(flat, size)[:, :n2] if len(ex_s) else None
    prior = T["prior"].float()
    prior[:, 0] = T["root_raw_prior"]
    legal_prog = prior[ex_s, ex_x, :n2] >= 0
    if legal_ref is not None:
        engine_bad += int((legal_prog != legal_ref).any(1).sum())
    search_bad += int((alloc & ~T["terminal"] & ~T["expanded"]).sum())

    # ---- search accounting, on the host
    h = {k: T[k].cpu().numpy() for k in ("n", "w", "vl", "value", "parent",
                                           "terminal", "count")}
    res_pol = P["res"].mcts_policy[R].cpu().numpy()
    res_q = P["res"].root_q[R].cpu().numpy()
    kid = T["child"][:, 0].long().cpu().numpy()
    root_prior = T["prior"][:, 0].float().cpu().numpy()
    for s in range(S):
        c = int(h["count"][s])
        n, w = h["n"][s, :c].astype(np.int64), h["w"][s, :c].astype(np.float64)
        par_s = h["parent"][s, :c].astype(np.int64)
        cn, cw = np.zeros(c, np.int64), np.zeros(c, np.float64)
        np.add.at(cn, par_s[1:], n[1:])
        np.add.at(cw, par_s[1:], w[1:])
        term = h["terminal"][s, :c]
        val = h["value"][s, :c].astype(np.float64)
        inner = ~term
        inner[0] = False
        search_bad += int((n[inner] != 1 + cn[inner]).sum())
        tol = 1e-3 * np.maximum(1, n)
        search_bad += int((np.abs(w - val - cw)[inner] > tol[inner]).sum())
        tt = term.copy()
        tt[0] = False
        search_bad += int(((n < 1) | (cn > 0)
                           | (np.abs(w - val * n) > tol))[tt].sum())
        search_bad += int(n[0] != 0) + int((h["vl"][s, :c] != 0).sum())
        has = kid[s] >= 0
        visits = np.where(has & (root_prior[s] >= 0),
                          h["n"][s][np.clip(kid[s], 0, None)], 0
                          ).astype(np.float32)
        pol = visits / max(np.float32(visits.sum()), np.float32(1e-10))
        search_bad += int(not np.array_equal(pol, res_pol[s]))
        wsum = np.where(has, h["w"][s][np.clip(kid[s], 0, None)], 0.0).sum()
        q = wsum / max(visits.sum(), 1.0)
        search_bad += int(abs(q - res_q[s]) > 1e-4)
        a = int(P["moves"][rows[s], L - 1])
        if L - 1 <= tr["policy_distri_cutoff"]:
            search_bad += int(not res_pol[s][a] > 0)
        else:
            best = int(np.argmax(visits + np.float32(1e-6)
                                 * np.clip(root_prior[s], 0, None)))
            search_bad += int(a != best)
    # every stored visit distribution of the window's moves holds its move
    for b in cand:
        for t in range(L - m.units, L):
            pol = P["policies"][b][t]
            if pol is not None:
                search_bad += int(not pol[P["moves"][b, t]] > 0)

    # ---- the net at the trees' expanded nodes, re-derived
    numbers = {"engine_mismatches": engine_bad,
               "search_mismatches": search_bad, "_failed": failed}
    M = len(ex_s)
    pick = np.sort(rng.choice(M, min(tr["check_nodes"], M), replace=False))
    sel = torch.as_tensor(pick, device=dev)
    ns, nx = ex_s[sel], ex_x[sel]
    if not len(pick):
        return numbers
    K = len(pick)
    # histories: the node and its ancestors, then the game before the root
    hist = torch.zeros((K, 8, n2), dtype=torch.int8, device=dev)
    valid = torch.zeros((K, 8), dtype=torch.bool, device=dev)
    cur = nx.clone()
    intree = torch.ones(K, dtype=torch.bool, device=dev)
    back_k = torch.zeros(K, dtype=torch.long, device=dev)
    root_ply = L - 1
    for j in range(8):
        st = pos["stones"][ns, cur]
        ply = pos["ply"][ns, cur]
        game_t = (root_ply - back_k).clamp(min=0)
        gb = boards[game_t, R[ns]]
        hist[:, j] = torch.where(intree[:, None], st, gb)
        valid[:, j] = torch.where(intree, ply >= 1, game_t >= 1)
        up = T["parent"].long()[ns, cur]
        leaving = intree & (up < 0)
        back_k = torch.where(intree, leaving.long(), back_k + 1)
        cur = torch.where(intree & ~leaving, up, cur)
        intree = intree & ~leaving
    to_play = pos["to_play"][ns, nx]
    codes = torch.arange(8, device=dev).repeat(K)
    x = agz.planes(hist.repeat_interleave(8, 0), valid.repeat_interleave(8, 0),
                   to_play.repeat_interleave(8), codes, size)
    W = P["W"]
    W = P["W"]
    legal = prior[ns, nx, :n2] >= 0                                # [K, n2]

    def board_q(log_pi, codes_, rows):
        """The policy over the legal points, in the board's frame."""
        p = agz.policy_from_frame(torch.exp(log_pi), codes_, size)[:, :n2]
        p = torch.where(legal[rows], p, 0.0)
        return p / p.sum(1, keepdim=True).clamp(min=1e-30)

    def log_gap(q, q0, rows):
        """The widest gap of log-probabilities over the legal points."""
        d = (q.clamp(min=1e-30).log() - q0.clamp(min=1e-30).log()).abs()
        return torch.where(legal[rows], d, 0.0).amax(-1)

    kk = torch.arange(K, device=dev)
    node8 = kk.repeat_interleave(8)
    lp, v = ref.evaluate(W, x, cfg, "fp32")
    q_ref = board_q(lp, codes, node8)
    q_prog = torch.where(legal, prior[ns, nx, :n2], 0.0)
    q_prog = q_prog / q_prog.sum(1, keepdim=True).clamp(min=1e-30)
    dist = log_gap(q_ref, q_prog[node8], node8).view(K, 8)
    rows8 = kk * 8 + dist.argmin(1)        # the symmetry that fits best
    q_ref, v_ref = q_ref[rows8], v[rows8]
    x, codes = x[rows8], codes[rows8]
    val_prog = T["value"][ns, nx]

    # the yardstick of rounding: the reference with its convolution path
    # in bfloat16, as the configuration states it, against float32, at
    # the same nodes and symmetries
    def gaps(mode):
        lp_m, v_m = ref.evaluate(W, x, cfg, mode)
        return (log_gap(board_q(lp_m, codes, kk), q_ref, kk),
                (v_m - v_ref).abs())

    e_pi, e_v = gaps("bf16")

    def ratios(tag, d_pi, d_v):
        print(f"{tag or 'program.'}widest gaps: log-prior "
              f"{float(d_pi.max()):.4g}, value {float(d_v.max()):.4g}; "
              f"bf16 reference: {float(e_pi.max()):.4g}, "
              f"{float(e_v.max()):.4g}", file=sys.stderr)
        numbers[f"{tag}eval_logprior_ratio"] = float(d_pi.mean() / e_pi.mean())
        numbers[f"{tag}eval_value_ratio"] = float(d_v.mean() / e_v.mean())

    ratios("", dist[kk, rows8 - kk * 8], (val_prog - v_ref).abs())
    if ctx.control:
        ratios("control.", *gaps("fp8"))
    return numbers
