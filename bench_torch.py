"""Benchmark entry point of the PyTorch/CUDA port: twin of `bench.py`.

Prints ONE JSON line on stdout, with `bench.py`'s keys: {"metric",
"value", "unit", "vs_baseline"}.

Primary metric: 19x19 lockstep env throughput (steps/s on one card) for a
4096-board batch where every step takes the full legal mask, draws a
random legal move, steps the engine and resets the finished boards.
`vs_baseline` is the fraction of the 1M env-steps/s north star of
`BASELINE.md`, as in `bench.py`.

The diagnostics go to stderr in `bench.py`'s order and wording: NN forward
evals/s at batch 128 and 1024, MCTS rollouts/s (B = 16, 64 rollouts), the
remat train step at batch 2048 and production self-play at B = 1024 x 1600
rollouts, all at 19x19 with the 20-block 256-channel net (bf16
convolutions) and random weights drawn from seed 0.  A stage that fails
prints `bench.py`'s `# ... failed: ...` line and its traceback, and the run
goes on; `main` then returns 1 (so does a stage skipped for the
`ELF_TPU_BENCH_BUDGET_S` budget), where `bench.py` exits 0.

Every stage takes `device` ("cuda" by default; it raises without a card).
The CUDA kernels build at their first launch (`elf_tpu_torch/_build.py`).

    python3 bench_torch.py
"""

import gc
import json
import os
import sys
import time
import traceback

import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import engine
from elf_tpu_torch.models.resnet import ModelConfig, build_model, eval_fn_builder
from elf_tpu_torch.search.mcts import MCTSConfig, gumbel_categorical
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
from elf_tpu_torch.training.trainer import Trainer
from scripts.production_selfplay_torch import PRODUCTION_SEARCH
from scripts.profile_mcts_torch import search, search_inputs


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_finished(fresh, core, done):
    """`core` with every board where `done` is set replaced by `fresh`'s."""
    return engine.GoCore(*(
        torch.where(done.view((-1,) + (1,) * (x.dim() - 1)), f, x)
        for f, x in zip(fresh, core)))


def rollout_chunk(fresh, core, legal, gen, size, chunk, actions_out=None):
    """`chunk` lockstep steps of every board: a uniform draw among the legal
    actions, the engine step, and a reset to `fresh` of each board the step
    ended.  The next legal mask rides on the step's own analysis
    (`info.legal_next`); a reset board's is all legal.  With `actions_out`
    (a list) each step's actions are appended to it.  Returns (core, legal,
    illegal): `illegal` [B] is set on a board that drew an illegal action
    (`legal_next` is undefined on such a row)."""
    illegal = torch.zeros_like(legal[:, 0])
    for _ in range(chunk):
        a = gumbel_categorical(torch.where(legal, 0.0, -1e9), gen)
        a = a.to(torch.int32)
        core, info = engine.step_core(core, a, size)
        illegal |= info.illegal
        done = engine.is_terminal_core(core, size)
        core = reset_finished(fresh, core, done)
        legal = info.legal_next | done[:, None]
        if actions_out is not None:
            actions_out.append(a)
    return core, legal, illegal


def bench_env_steps(B=4096, size=19, chunk=64, iters=4, device="cuda",
                    out=None):
    """Env steps/s: 3 warm-up chunks (the first fed the empty board's mask),
    then `iters` timed chunks, each `rollout_chunk` of `chunk` steps; the
    host clock stops after a fetch of a real value.  Raises if any step drew
    an illegal action.  With `out` (a dict) the stage leaves there the state
    it ended in: `fresh`, `core`, `legal` and `gen`."""
    dev = resolve_device(device)
    fresh = engine.init_core(B, size, dev)
    core = engine.init_core(B, size, dev)
    legal = torch.ones((B, size * size + 1), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    illegal = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(3):
        core, legal, bad = rollout_chunk(fresh, core, legal, gen, size, chunk)
        illegal |= bad
        core.ply[:1].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        core, legal, bad = rollout_chunk(fresh, core, legal, gen, size, chunk)
        illegal |= bad
    core.ply[:1].cpu()
    dt = time.perf_counter() - t0
    if bool(illegal.any()):
        raise RuntimeError("env: a step drew an illegal action")
    if out is not None:
        out.update(fresh=fresh, core=core, legal=legal, gen=gen)
    return B * chunk * iters / dt


def bench_nn_forward(batch=128, blocks=20, dim=256, device="cuda"):
    """NN forward evals/s: a zero NHWC input, one warm-up forward and one
    warm-up of the chain, then 8 timed forwards, each fed the last one's
    input plus 0 x its value, so that none can be skipped."""
    dev = resolve_device(device)
    cfg = ModelConfig(board_size=19, num_planes=18, num_block=blocks, dim=dim)
    net = build_model(cfg, dev, seed=0).eval()
    x = torch.zeros((batch, 19, 19, 18), device=dev)
    with torch.inference_mode():
        _, v = net(x)
        x = x + v[:1, None, None, None] * 0
        _, v = net(x)
        v[:1].cpu()
        t0 = time.perf_counter()
        n = 8
        for _ in range(n):
            x = x + v[:1, None, None, None] * 0
            _, v = net(x)
        v[:1].cpu()
    dt = time.perf_counter() - t0
    return batch * n / dt


def bench_mcts_rollouts(B=16, rollouts=64, m=8, blocks=20, dim=256,
                        device="cuda"):
    """MCTS rollouts/s at the production net: `profile_mcts_torch.py`'s
    full search from empty boards, one warm-up call, then 3 timed calls
    with generators seeded 1, 2, 3."""
    dev = resolve_device(device)
    inputs = search_inputs(B, rollouts, m, blocks, dim, True, dev)
    search(inputs, inputs[3], 0)[:1, :1].cpu()
    t0 = time.perf_counter()
    n = 3
    for i in range(n):
        search(inputs, inputs[3], i + 1)[:1, :1].cpu()
    dt = time.perf_counter() - t0
    return B * rollouts * n / dt


def _fwd_flops(batch, size=19, planes=18, blocks=20, dim=256, num_actions=362):
    """Forward FLOPs of the 20b256c net (2 x MACs), conv-dominated."""
    n2 = size * size
    f = n2 * 9 * planes * dim * 2                 # init conv
    f += 2 * blocks * n2 * 9 * dim * dim * 2      # residual trunk
    f += n2 * dim * 2 * 2 + n2 * 2 * num_actions * 2   # policy head
    f += n2 * dim * 1 * 2 + n2 * 256 * 2          # value head
    return f * batch


def _is_oom(e: Exception) -> bool:
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(e).lower())


def _release() -> None:
    """Return the memory of what is no longer referenced to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def bench_selfplay_prod(B=1024, rollouts=1600, m=8, blocks=20, dim=256,
                        device="cuda", out=None):
    """Self-play at the production operating point: B lockstep boards x
    `rollouts` per move at 20b256c bf16, the production search of
    `scripts/production_selfplay_torch.py` in calls of 10 simulation
    batches; persistent trees off, as the reference's production default.
    One move to warm up, one timed.  With `out` (a dict) the actor is left
    there as `actor`.

    Returns (moves_per_sec, rollouts_per_sec, games_per_hour_est)."""
    dev = resolve_device(device)
    cfg = ModelConfig(board_size=19, num_planes=18, num_block=blocks, dim=dim)
    net = build_model(cfg, dev, seed=0)
    acfg = ActorConfig(board_size=19, batch=B, persistent_tree=False,
                       policy_distri_cutoff=30)
    mcfg = MCTSConfig(num_rollouts=rollouts, rollouts_per_batch=m,
                      max_batches_per_call=10, **PRODUCTION_SEARCH)
    actor = SelfplayActor(acfg, mcfg, eval_fn_builder, seed=0, device=dev)
    actor.play_moves(net, None, 1)
    _sync(dev)
    t0 = time.perf_counter()
    actor.play_moves(net, None, 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    if out is not None:
        out["actor"] = actor
    moves_ps = B / dt
    return moves_ps, B * rollouts / dt, moves_ps / 450.0 * 3600.0


def _train_steps(bs, blocks, dim, iters, dev, out):
    cfg = ModelConfig(board_size=19, num_planes=18, num_block=blocks,
                      dim=dim, remat=True)
    opts = TrainOptions(batchsize=bs, num_block=blocks, dim=dim)
    trainer = Trainer(cfg, opts, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.make_train_step()
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.rand((bs, 19, 19, 18), generator=g, device=dev)
    pi = torch.full((bs, 362), 1.0 / 362.0, device=dev)
    winner = torch.ones((bs,), device=dev)
    state, stats = step(state, feats, pi, winner)      # warm-up
    float(next(iter(stats.values())))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, stats = step(state, feats, pi, winner)
    # every step updates the state the next one reads, so one fetch of
    # the last stats waits for all of them
    float(next(iter(stats.values())))
    dt = time.perf_counter() - t0
    if out is not None:
        out["stats"] = {k: float(v) for k, v in stats.items()}
    sps = iters / dt
    # fwd + bwd + remat-recompute ~ 4x forward FLOPs
    tflops = 4 * _fwd_flops(bs, blocks=blocks, dim=dim) * sps / 1e12
    return bs, sps, tflops


def bench_train_step(bs=2048, blocks=20, dim=256, iters=4, device="cuda",
                     out=None):
    """Train-step throughput at the reference server operating point
    (batch 2048, 20b256c) with block remat; the batch halves on running out
    of memory, down to min(bs, 256).  With `out` (a dict) the last step's
    stats are left there as `stats`.

    Returns (achieved_bs, steps_per_sec, achieved_tflops)."""
    dev = resolve_device(device)
    floor = min(bs, 256)
    while bs >= floor:
        try:
            return _train_steps(bs, blocks, dim, iters, dev, out)
        except RuntimeError as e:      # torch.cuda.OutOfMemoryError is one
            if not (_is_oom(e) and bs > floor):
                raise
        # out of the handler, the failed attempt's trainer, state and
        # batch are gone with its frames: release them before the retry
        print(f"# train bs={bs} OOM; halving", file=sys.stderr)
        bs //= 2
        _release()
    return 0, 0.0, 0.0


def _hbm_info() -> str:
    """Peak device memory of the process over the card's total."""
    if not torch.cuda.is_available():
        return "n/a"
    used = torch.cuda.max_memory_allocated() / 2**30
    lim = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory / 2**30
    return f"{used:.1f}/{lim:.1f} GiB"


def main() -> int:
    t_all = time.time()
    # soft wall-clock budget for the diagnostic stages, so that a slow
    # stage cannot cost the primary metric a harness timeout
    budget_s = float(os.environ.get("ELF_TPU_BENCH_BUDGET_S", "2400"))
    failed = []

    def over_budget(stage):
        if time.time() - t_all > budget_s:
            print(f"# skipping {stage}: over {budget_s:.0f}s budget "
                  f"(set ELF_TPU_BENCH_BUDGET_S to raise)", file=sys.stderr)
            return True
        return False

    def stage_failed(what, e):
        print(f"# {what} failed: {e}", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        failed.append(what)

    env_sps = bench_env_steps()
    print(f"# env_steps/s (19x19, B=4096): {env_sps:,.0f}", file=sys.stderr)
    # the ONE stdout line goes out as soon as the primary metric exists
    print(
        json.dumps(
            {
                "metric": "env_steps_per_sec_19x19_single_chip",
                "value": round(env_sps, 1),
                "unit": "steps/s",
                "vs_baseline": round(env_sps / 1_000_000.0, 4),
            }
        ),
        flush=True,
    )
    _release()
    try:
        nn_sps = bench_nn_forward()
        print(f"# NN fwd evals/s (20b256c, bs=128): {nn_sps:,.0f}",
              file=sys.stderr)
        nn_sps_big = bench_nn_forward(batch=1024)
        print(
            f"# NN fwd evals/s (20b256c, bs=1024): {nn_sps_big:,.0f}",
            file=sys.stderr,
        )
    except Exception as e:  # noqa: BLE001
        stage_failed("NN bench", e)
    _release()
    try:
        mcts_rps = bench_mcts_rollouts()
        print(
            f"# MCTS rollouts/s (20b256c, B=16, 64 rollouts): {mcts_rps:,.0f}",
            file=sys.stderr,
        )
    except Exception as e:  # noqa: BLE001
        stage_failed("MCTS bench", e)
    _release()
    try:
        if over_budget("train-step bench"):
            raise TimeoutError("budget")
        bs, sps, tflops = bench_train_step()
        print(
            f"# train step (20b256c, remat, bs={bs}): {sps:.3f} steps/s, "
            f"{tflops:,.1f} TFLOP/s, {sps * bs:,.0f} samples/s "
            f"[hbm {_hbm_info()}]",
            file=sys.stderr,
        )
    except Exception as e:  # noqa: BLE001
        stage_failed("train bench", e)
    # the train step's memory goes back to the card before self-play, so
    # that its halving answers to self-play's own needs alone
    _release()
    try:
        B = 1024
        while B >= 128:
            try:
                if over_budget("selfplay prod bench"):
                    raise TimeoutError("budget")
                mps, rps, gph = bench_selfplay_prod(B=B)
                print(
                    f"# selfplay prod (19x19, B={B}, 1600 rollouts, 20b256c): "
                    f"{mps:,.1f} moves/s, {rps:,.0f} rollouts/s, "
                    f"~{gph:,.0f} games/hour/chip [hbm {_hbm_info()}]",
                    file=sys.stderr,
                )
                break
            except RuntimeError as e:
                if not (_is_oom(e) and B > 128):
                    raise
            print(f"# selfplay B={B} OOM; halving", file=sys.stderr)
            B //= 2
            _release()
    except Exception as e:  # noqa: BLE001
        stage_failed("selfplay prod bench", e)
    print(f"# total bench time: {time.time()-t_all:.1f}s", file=sys.stderr)
    if failed:
        print(f"# failed stages: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
