"""Traffic kind "train": the learner's minibatch through the program's
`LearnerRunner.run_minibatch` (replay sample, features, device batch,
train step), the learner pulling one batch after the other.  The unit of
work is one step; the work is positions, steps x batch.

The replay buffer is filled at set-up with games the benchmark makes from
the seed: its own engine (`reference/go.py`) plays `games` random legal
games in lockstep, each to a length drawn from [min_plies, max_plies] and
ended by two passes, and every move gets a visit distribution drawn from
the seed over up to `policy_moves` legal moves (the played one the most
visited); the games enter the program as records in its JSON form.  The
net's weights are drawn from the seed and handed to the runner's state
through its state-dict interface.

Traffic parameters: batch, remat, games, min_plies, max_plies,
policy_moves, checked_steps (set-up steps the reference follows, also the
warm-up), trace_steps (the traced window).

The check (training, by the builders' rule): the first `checked_steps`
steps run through the window's own call at set-up; the reference rebuilds
each of their batches from its own games and the program's draws (game,
ply, symmetry), compares it with the program's device batch, and follows
the steps in float32 from the same weights.  Compared: each step's loss,
the first step's gradient as the optimizer takes it (from the parameters
it left: (p0 - p1) / lr), and the parameters' change after the last
checked step, the last two by the worst leaf and over all leaves
(`_gaps`).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from harness import core, weights
from harness.trace import WINDOW, Tracer
from reference import agz, go


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------------------- games


def make_games(tr: dict, size: int, seed: int, dev):
    """The replay's games: (records as JSON dicts, boards [G, Lmax + 1, n2]
    int8 on the host (the board after each ply), lengths [G])."""
    G, n2 = tr["games"], size * size
    g = torch.Generator(device=dev).manual_seed(seed)
    want = torch.randint(tr["min_plies"], tr["max_plies"] + 1, (G,),
                         generator=g, device=dev)
    Lmax = tr["max_plies"] + 2
    pos = go.empty_position(G, size, dev)
    boards = torch.zeros((Lmax + 1, G, n2), dtype=torch.int8, device=dev)
    moves = torch.full((Lmax, G), n2, dtype=torch.long, device=dev)
    k = tr["policy_moves"]
    pol_idx = torch.zeros((Lmax, G, k), dtype=torch.long, device=dev)
    pol_w = torch.zeros((Lmax, G, k), device=dev)
    for t in range(Lmax):
        legal = go.legal_mask(pos, size)
        board_legal = legal[:, :n2]
        u = torch.rand((G, n2), generator=g, device=dev)
        score = torch.where(board_legal, u, -1.0)
        a = torch.where(board_legal.any(1), score.argmax(1), n2)
        a = torch.where(t >= want, n2, a)                 # two closing passes
        top = torch.topk(score, k, dim=1)
        idx = torch.where(top.values >= 0, top.indices, -1)
        w = torch.rand((G, k), generator=g, device=dev) ** 2 * 0.9
        # the played move first, with the most visits
        idx = torch.cat([a[:, None], idx[:, :-1]], 1)
        w = torch.cat([torch.ones((G, 1), device=dev), w[:, :-1]], 1)
        dup = (idx[:, 1:] == a[:, None])
        w[:, 1:] = torch.where(dup | (idx[:, 1:] < 0), 0.0, w[:, 1:])
        pol_idx[t], pol_w[t] = idx.clamp(min=0), w
        moves[t] = a
        pos, ok = go.step(pos, a, size, legal=legal)
        boards[t + 1] = pos["stones"]
    lengths = (want + 2).cpu().numpy()
    moves = moves.T.cpu().numpy()
    boards = boards.transpose(0, 1).cpu().numpy()
    q = torch.round(pol_w * 255.0).long().transpose(0, 1).cpu().numpy()
    pidx = pol_idx.transpose(0, 1).cpu().numpy()
    reward = (torch.rand((G,), generator=g, device=dev) < 0.5).cpu().numpy()
    records = []
    for i in range(G):
        L = int(lengths[i])
        pols = []
        for t in range(L):
            keep = q[i, t] > 0
            order = np.argsort(pidx[i, t][keep])
            pols.append({"idx": pidx[i, t][keep][order].tolist(),
                         "q": q[i, t][keep][order].tolist()})
        records.append({
            "request": {"vers": {"black_ver": 0, "white_ver": -1},
                        "client_ctrl": {}},
            "result": {"reward": 1.0 if reward[i] else -1.0,
                       "content": agz.moves_to_sgf(moves[i, :L], size),
                       "policies": pols, "values": [0.0] * L,
                       "using_models": [0], "num_move": L,
                       "black_never_resign": True,
                       "white_never_resign": True, "first_player": 1,
                       "setup_black": [], "setup_white": []},
            "timestamp": 0.0, "thread_id": i, "seq": 0, "pri": 0.0,
            "offline": False})
    return records, boards, lengths


# -------------------------------------------------------------- the run


def run(ctx) -> core.Measured:
    from elf_tpu_torch.config import ReplayOptions, TrainOptions
    from elf_tpu_torch.selfplay.records import Record
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner
    from elf_tpu_torch.training.trainer import Trainer

    from harness.selfplay import model_config

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    size = cfg["board_size"]
    records, boards, lengths = make_games(tr, size, core.sub_seed(ctx.seed, 4),
                                          dev)
    drawn = []

    class Replay(ReplayBuffer):
        """The program's buffer, noting which records each batch drew."""

        def sample_many(self, k):
            items = super().sample_many(k)
            if log[0]:
                drawn.append([it.record.thread_id for it in items])
            return items

    log = [False]
    replay = Replay(ReplayOptions(), seed=core.sub_seed(ctx.seed, 5))
    pipeline = TrainingPipeline(replay, size, seed=core.sub_seed(ctx.seed, 6))
    for d in records:
        pipeline.insert_record(Record.from_json(d))
    counters = {"pipeline_s": 0.0, "steps": 0}
    seen = {"host": [], "device": []}

    class Pipe:
        """The pipeline the runner pulls from: the program's, timed by the
        host clock and, in a traced run, marked by harness ranges."""

        def __getattr__(self, name):
            return getattr(pipeline, name)

        def sample_host_batch(self, n):
            t = time.perf_counter()
            with ctx.spans("sample_host_batch"):
                hb = pipeline.sample_host_batch(n)
            counters["pipeline_s"] += time.perf_counter() - t
            if log[0]:
                seen["host"].append(hb)
            return hb

        def device_batch(self, hb, device="cuda"):
            t = time.perf_counter()
            with ctx.spans("device_batch"):
                out = pipeline.device_batch(hb, device)
            counters["pipeline_s"] += time.perf_counter() - t
            if log[0]:
                seen["device"].append(tuple(x.clone() for x in out))
            return out

    opts = TrainOptions(batchsize=tr["batch"], num_block=cfg["num_block"],
                        dim=cfg["dim"])
    mcfg = dataclasses.replace(model_config(cfg), remat=tr["remat"])
    trainer = Trainer(mcfg, opts, device=dev)
    runner = LearnerRunner(trainer, Pipe(), "unused", opts,
                           seed=core.sub_seed(ctx.seed, 7))
    W0 = weights.make(cfg, ctx.reference, core.sub_seed(ctx.seed, 0), dev)
    net = runner.state.net
    net.load_state_dict(W0)
    params = dict(net.named_parameters())

    # the checked steps: the window's own call, at set-up
    log[0] = True
    losses, grad_norm, change_norm = [], {}, {}
    for s in range(tr["checked_steps"]):
        stats = runner.run_minibatch()
        losses.append(stats["loss/total"])
        if s == 0:
            grad_norm = {k: float(torch.linalg.vector_norm(
                (W0[k] - p.detach()) / opts.lr)) for k, p in params.items()}
    change_norm = {k: float(torch.linalg.vector_norm(p.detach() - W0[k]))
                   for k, p in params.items()}
    log[0] = False
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    tracer = Tracer() if ctx.trace else None
    limit = tr["trace_steps"] if ctx.trace else None
    counters["pipeline_s"] = 0.0
    units = 0
    if tracer:
        tracer.start()
    ends = []
    t0 = time.perf_counter()
    with ctx.spans(WINDOW):
        while time.perf_counter() - t0 < ctx.seconds and (
                limit is None or units < limit):
            with ctx.spans("run_minibatch"):
                stats = runner.run_minibatch()
            if stats is None:
                raise RuntimeError("the replay gave no batch")
            units += 1
            ends.append(time.perf_counter() - t0)
    _sync(dev)
    window_s = time.perf_counter() - t0
    summary = tracer.stop() if tracer else None
    counters["steps"] = units
    payload = dict(W0=W0, records=records, boards=boards, lengths=lengths,
                   drawn=drawn, host=seen["host"], device=seen["device"],
                   losses=losses, grad_norm=grad_norm,
                   change_norm=change_norm, opts=opts)
    del runner, trainer, net, params, pipeline, replay
    return core.Measured(
        setup_s=setup_s, window_s=window_s, units=units,
        work={"positions": units * tr["batch"], "train_steps": units},
        counters=counters, attempted=units, payload=payload, trace=summary,
        unit_ends=ends)


# ----------------------------------------------------------------- check


def _rebuild(P, size, dev):
    """The reference's own batches for the checked steps, and the count of
    rows where the program's batch differs from it."""
    n2 = size * size
    A = n2 + 1
    index = {}
    boards, lengths = P["boards"], P["lengths"]
    for gi in range(len(lengths)):
        for t in range(int(lengths[gi])):
            index.setdefault((gi, boards[gi, t].tobytes()), []).append(t)
    out, bad = [], 0
    for hb, (feats, pi_t, z), ids in zip(P["host"], P["device"], P["drawn"]):
        K = len(ids)
        ply = np.zeros(K, np.int64)
        found = np.ones(K, bool)
        for i, gi in enumerate(ids):
            nvalid = int(hb.valid[i].sum())
            if nvalid < 8:
                ply[i] = nvalid
                continue
            hits = [t for t in index.get((gi, hb.snaps[i, 7].tobytes()), [])
                    if t >= 8 and t % 2 == (0 if hb.to_play[i] == 1 else 1)
                    and all((boards[gi, t - 7 + j] == hb.snaps[i, j]).all()
                            for j in range(8))]
            if len(hits) != 1:
                found[i] = False
            else:
                ply[i] = hits[0]
        g = np.asarray(ids)
        hist = np.stack([boards[g, np.clip(ply - j, 0, None)]
                         for j in range(8)], 1)                  # newest first
        valid = np.stack([ply - j >= 1 for j in range(8)], 1)
        to_play = np.where(ply % 2 == 0, 1, 2)
        codes = torch.as_tensor(hb.codes, device=dev)
        x = agz.planes(torch.as_tensor(hist, device=dev),
                       torch.as_tensor(valid, device=dev),
                       torch.as_tensor(to_play, device=dev), codes, size)
        pi = np.stack([agz.dequantize(P["records"][gi]["result"]["policies"]
                                      [ply[i]], A)
                       for i, gi in enumerate(ids)])
        pi = agz.policy_to_frame(torch.as_tensor(pi, device=dev), codes, size)
        zr = torch.as_tensor(np.asarray(
            [1.0 if P["records"][gi]["result"]["reward"] > 0 else -1.0
             for gi in ids], np.float32), device=dev)
        same = ((x == feats).flatten(1).all(1) & (pi == pi_t).all(1)
                & (zr == z) & torch.as_tensor(found, device=dev))
        bad += int((~same).sum())
        out.append((x, pi, zr))
    return out, bad


def _gaps(losses_p, grad_p, change_p, losses_r, first, first_raw, W3, W0):
    """One side's numbers against the float32 reference: the loss gap by
    the worst step; the first gradient's and the change's norm gaps by the
    worst leaf, each against the larger of the leaf's own norm and the
    median leaf's, and of the norms over all leaves (`*_global`).  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    (nought to rounding: the convolution biases that a batch-statistics BN
    follows) are left out; `grad_gap_all` keeps them, for the record."""
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(losses_p, losses_r))}
    names = list(first)
    raw = {k: float(torch.linalg.vector_norm(first_raw[k])) for k in names}
    raw_med = float(np.median(list(raw.values())))
    moved = [k for k in names if raw[k] >= 1e-3 * raw_med]
    gr = {k: float(torch.linalg.vector_norm(first[k])) for k in names}
    med = float(np.median(list(gr.values())))
    grad = {k: abs(grad_p[k] - gr[k]) / max(gr[k], med) for k in names}
    dr = {k: float(torch.linalg.vector_norm(W3[k] - W0[k])) for k in moved}
    dmed = float(np.median(list(dr.values())))
    change = {k: abs(change_p[k] - dr[k]) / max(dr[k], dmed) for k in moved}
    out["grad_gap_all"] = max(grad.values())
    grad = {k: grad[k] for k in moved}
    glob = lambda d: float(np.sqrt(sum(d[k] ** 2 for k in moved)))
    out["grad_gap_global"] = abs(glob(grad_p) - glob(gr)) / glob(gr)
    out["change_gap_global"] = abs(glob(change_p) - glob(dr)) / glob(dr)
    for what, gaps in (("grad", grad), ("change", change)):
        out[f"{what}_gap"] = max(gaps.values())
        worst = sorted(gaps, key=gaps.get)[-3:]
        print(f"worst leaves by {what}: "
              + ", ".join(f"{k} {gaps[k]:.4g}" for k in worst),
              file=sys.stderr)
    return out


def _side(W0, run):
    """Norms of a side's (losses, first, first_raw, W3) as the program's
    are read: loss list, first-gradient norms, change norms."""
    losses, first, _, W3 = run
    return (losses,
            {k: float(torch.linalg.vector_norm(v)) for k, v in first.items()},
            {k: float(torch.linalg.vector_norm(W3[k] - W0[k])) for k in W3})


def check(ctx, m: core.Measured) -> dict:
    cfg, dev = ctx.config, ctx.device
    ref = ctx.reference
    ref.exact_fp32()
    P = m.payload
    batches, bad = _rebuild(P, cfg["board_size"], dev)
    P["host"] = P["device"] = None
    o = P["opts"]
    opts = {"lr": o.lr, "momentum": o.momentum, "weight_decay": o.weight_decay,
            "value_loss_weight": o.value_loss_weight}
    W0 = P["W0"]
    fp32 = ref.sgd_steps(W0, batches, cfg, opts)
    losses_r, first, first_raw, W3 = fp32
    numbers = {"batch_mismatches": bad, "_failed": int(bad > 0)}
    numbers.update(_gaps(P["losses"], P["grad_norm"], P["change_norm"],
                         losses_r, first, first_raw, W3, W0))
    if ctx.control:
        for tag, kw in (("control", {"conv_mode": "fp8"}),
                        ("half", {"half": True})):
            side = _side(W0, ref.sgd_steps(W0, batches, cfg, opts, **kw))
            numbers.update({f"{tag}.{k}": v for k, v in _gaps(
                *side, losses_r, first, first_raw, W3, W0).items()})
    return numbers
