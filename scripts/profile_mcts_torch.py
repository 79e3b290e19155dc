#!/usr/bin/env python
"""Decompose small-batch MCTS cost on the PyTorch/CUDA port: twin of
`scripts/profile_mcts.py` on `elf_tpu_torch`.

Times three variants of one search configuration (default: 19x19 20b256c,
B = 16, 64 rollouts, m = 8, random symmetries), from empty boards with a
net of random weights drawn from seed 0:

  full       run_mcts with the real net                -> rollouts/s
  nn_only    the same sequence of net calls (one root
             batch of B, then rollouts/m batches of
             B*m leaves), nothing else                 -> the net's bound
  tree_only  run_mcts with constant logits             -> the tree alone

and prints a JSON breakdown with the JAX script's keys.  Each variant is
called once to warm up, then `--iters` times, each call timed by the host
clock up to `torch.cuda.synchronize()`, with the search's generator seeded
anew per call.  `--trace_dir` also writes a torch.profiler trace of one
`full` call (`elf_tpu_torch.profiling.Profiler`).  At exit one JSON line on
stderr gives the device and the liberty kernels' launch counts per variant
(`full` counts its traced call too).

  python scripts/profile_mcts_torch.py --B 16 --iters 5
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.env.go.engine import init_core
from elf_tpu_torch.env.go.state import MAX_AGZ_HISTORY
from elf_tpu_torch.models.resnet import ModelConfig, build_model, eval_fn_builder
from elf_tpu_torch.profiling import Profiler
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts


def search_inputs(B: int, rollouts: int, m: int, blocks: int, dim: int,
                  rotation_flip: bool, device):
    """What a timed search runs on: empty 19x19 boards with no history, the
    net of random weights drawn from seed 0 as an evaluator, and the search
    config.  Returns (core, hist, hlen, eval_fn, mcfg)."""
    size = 19
    cfg = ModelConfig(board_size=size, num_planes=18, num_block=blocks,
                      dim=dim)
    eval_fn = eval_fn_builder(build_model(cfg, device, seed=0))
    mcfg = MCTSConfig(num_rollouts=rollouts, rollouts_per_batch=m,
                      rotation_flip=rotation_flip)
    core = init_core(B, size, device)
    hist = torch.zeros((B, MAX_AGZ_HISTORY, size * size), dtype=torch.int8,
                       device=device)
    hlen = torch.zeros((B,), dtype=torch.int32, device=device)
    return core, hist, hlen, eval_fn, mcfg


def search(inputs, eval_fn, seed: int):
    """One `run_mcts` over `inputs` (`search_inputs`) with `eval_fn` and a
    generator seeded `seed` on their device; returns the root policy."""
    core, hist, hlen, _, mcfg = inputs
    device = core.stones.device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        res, _ = run_mcts(core, hist, hlen, eval_fn, gen, mcfg, 19,
                          device=device)
    return res.mcts_policy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--rollouts", type=int, default=64)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace_dir", type=str, default="")
    ap.add_argument("--rotation_flip", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    B, rollouts, m = args.B, args.rollouts, args.m
    size, A = 19, 362
    inputs = search_inputs(B, rollouts, m, args.blocks, args.dim,
                           bool(args.rotation_flip), device)
    eval_fn = inputs[3]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    launches = {}

    def timed(fn, label):
        """Seconds per call after one warm-up call; the launch counts of
        all of them go to `launches[label]`."""
        sync()
        kernels.reset_launch_counts()
        fn(-1)
        sync()
        t0 = time.perf_counter()
        for i in range(args.iters):
            fn(i)
            sync()
        dt = (time.perf_counter() - t0) / args.iters
        launches[label] = kernels.launch_counts()
        return dt

    # ---- full search ----------------------------------------------------
    t_full = timed(lambda i: search(inputs, eval_fn, 100 + i), "full")

    # ---- net only: the same calls (root batch B, n_batches of B*m) ------
    n_batches = rollouts // m
    froot = torch.zeros((B, size, size, 18), device=device)
    fsim = torch.zeros((B * m, size, size, 18), device=device)
    to_play = torch.ones((B * m,), dtype=torch.int8, device=device)

    def nn_only(i):
        with torch.inference_mode():
            lp, v = eval_fn(froot, to_play[:B])
            acc = lp.sum() + v.sum()
            for _ in range(n_batches):
                lp, v = eval_fn(fsim, to_play)
                acc = acc + lp.sum() + v.sum()
        return acc

    t_nn = timed(nn_only, "nn_only")

    # ---- tree only: constant logits, no net -----------------------------
    def const_eval(feats, to_play_):
        K = feats.shape[0]
        return (torch.full((K, A), -math.log(A), device=feats.device),
                torch.zeros((K,), device=feats.device))

    t_tree = timed(lambda i: search(inputs, const_eval, 100 + i), "tree_only")

    if args.trace_dir:
        kernels.reset_launch_counts()
        with Profiler(args.trace_dir).trace():
            search(inputs, eval_fn, 103)
            sync()
        launches["full"] = {k: v + launches["full"][k]
                            for k, v in kernels.launch_counts().items()}

    total_r = B * rollouts
    print(json.dumps({
        "B": B, "rollouts": rollouts, "m": m,
        "blocks": args.blocks, "dim": args.dim,
        "t_full_ms": round(t_full * 1e3, 2),
        "t_nn_only_ms": round(t_nn * 1e3, 2),
        "t_tree_only_ms": round(t_tree * 1e3, 2),
        "rollouts_per_s_full": round(total_r / t_full),
        "rollouts_per_s_nn_bound": round(total_r / t_nn),
        "tree_overhead_ms": round((t_full - t_nn) * 1e3, 2),
        "nn_fraction": round(t_nn / t_full, 4),
    }), flush=True)
    print(json.dumps({"device": str(device), "kernel_launches": launches}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
