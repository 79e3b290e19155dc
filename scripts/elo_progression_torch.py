#!/usr/bin/env python
"""Elo progression across a checkpoint directory, on the PyTorch/CUDA
port: twin of `scripts/elo_progression.py` on `elf_tpu_torch`.

Plays colour-swapped matches between successive checkpoints
(`save-<step>.bin`, as the trainer keeps them) and chains the Elo deltas
into a progression table (the standalone counterpart of watching the
server-driven eval ladder promote candidates, `ctrl_eval.h`).  `--pairs`
plays direct matches by step number instead, with a per-colour breakdown.
Same options, JSON lines and return code (1 with fewer than two
checkpoints) as the JAX script, plus `--device` (default `cuda`).  At exit
one JSON line on stderr gives the device and the liberty kernels' launch
counts.

  python scripts/elo_progression_torch.py --ckpt_dir runs/prove9 \\
      --board_size 9 --blocks 4 --dim 64 --games_per_pair 64 \\
      --num_rollouts 64
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.models.registry import make_trainer
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import (
    ActorConfig,
    SelfplayActor,
    make_pair_eval_builder,
)
from elf_tpu_torch.tools.match import elo_diff, head_to_head
from elf_tpu_torch.training.trainer import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", type=str, required=True)
    ap.add_argument("--board_size", type=int, default=9)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--games_per_pair", type=int, default=64)
    ap.add_argument("--num_rollouts", type=int, default=64)
    ap.add_argument("--rollouts_per_batch", type=int, default=8)
    ap.add_argument("--max_pairs", type=int, default=0, help="0 = all")
    ap.add_argument("--include_init", type=str, default="",
                    help="path to a random-init checkpoint as Elo 0 anchor")
    ap.add_argument("--pairs", type=str, default="",
                    help="explicit matches 'a:b,c:d' by step number "
                         "(0 = the --include_init anchor) instead of the "
                         "successive-checkpoint ladder — for direct "
                         "anchor matches and transitivity checks at "
                         "higher rollout budgets")
    ap.add_argument("--model", type=str, default="df_kl")
    ap.add_argument("--use_df_feature", type=int, default=0)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpts = sorted(
        (int(m.group(1)), os.path.join(args.ckpt_dir, f))
        for f in os.listdir(args.ckpt_dir)
        if (m := re.match(r"save-(\d+)\.bin$", f))
    )
    paths = [p for _, p in ckpts]
    steps = [s for s, _ in ckpts]
    if args.include_init:
        paths.insert(0, args.include_init)
        steps.insert(0, 0)
    if len(paths) < 2:
        print("need at least two checkpoints", file=sys.stderr)
        return 1
    if args.max_pairs > 0 and len(paths) > args.max_pairs + 1:
        keep = [0] + list(
            range(len(paths) - args.max_pairs, len(paths))
        )
        paths = [paths[i] for i in keep]
        steps = [steps[i] for i in keep]

    to = TrainOptions(batchsize=64, num_block=args.blocks, dim=args.dim)
    trainer, _mode, feature_set = make_trainer(
        args.model, args.board_size, to,
        use_df_feature=bool(args.use_df_feature), device=device,
    )
    template = trainer.init_state(torch.Generator().manual_seed(0))
    eval_raw = trainer.make_eval_fn()

    actor = SelfplayActor(
        ActorConfig(board_size=args.board_size,
                    batch=max(args.games_per_pair // 2, 1),
                    komi=args.komi, policy_distri_cutoff=0,
                    resign_thres=0.0, never_resign_prob=1.0),
        MCTSConfig(feature_set=feature_set,
                   num_rollouts=args.num_rollouts,
                   rollouts_per_batch=args.rollouts_per_batch,
                   c_puct=1.5, root_epsilon=0.0, komi=args.komi,
                   ply_pass_enabled=max(
                       6, args.board_size ** 2 * 160 // 361)),
        make_pair_eval_builder(eval_raw), seed=args.seed, device=device,
    )

    states = {}

    def load(path):
        if path not in states:
            states[path] = load_checkpoint(path, template=template)
        return states[path]

    def launches_line():
        print(json.dumps({"device": str(device),
                          "kernel_launches": kernels.launch_counts()}),
              file=sys.stderr, flush=True)

    kernels.reset_launch_counts()
    if args.pairs:
        by_step = dict(zip(steps, paths))
        for spec in args.pairs.split(","):
            hi, lo = (int(x) for x in spec.split(":"))
            a, b = load(by_step[hi]), load(by_step[lo])
            sink = []
            wins, total = head_to_head(
                actor, (a.net, None), (b.net, None),
                max(args.games_per_pair // 2, 1), record_sink=sink,
            )
            wr = wins / max(total, 1)
            # per-colour breakdown: on small boards at high rollout budgets
            # outcomes can become komi/colour-determined, and a 0.500
            # aggregate with 0 % as black and 100 % as white says "search
            # saturated", not "equal strength".  A won as black iff its win
            # carries reward > 0 (noswap half), as white iff reward < 0
            # (swap half): exact with a half-point komi
            as_black = sum(
                1 for (r, a_won) in sink if a_won and r.result.reward > 0
            )
            as_white = sum(
                1 for (r, a_won) in sink if a_won and r.result.reward < 0
            )
            black_wins_total = sum(
                1 for (r, _) in sink if r.result.reward > 0
            )
            print(json.dumps({
                "step": hi, "vs_step": lo, "direct": True,
                "rollouts": args.num_rollouts,
                "wins": wins, "n": total, "winrate": round(wr, 4),
                "wins_as_black": as_black, "wins_as_white": as_white,
                "black_wins_total": black_wins_total,
                "elo_delta": round(elo_diff(wr), 1),
            }), flush=True)
            states.clear()
        launches_line()
        return 0

    elo = 0.0
    print(json.dumps({"step": steps[0], "elo": 0.0, "anchor": True}),
          flush=True)
    for i in range(1, len(paths)):
        a, b = load(paths[i]), load(paths[i - 1])
        wins, total = head_to_head(
            actor, (a.net, None), (b.net, None),
            max(args.games_per_pair // 2, 1),
        )
        wr = wins / max(total, 1)
        delta = elo_diff(wr)
        elo += delta
        print(json.dumps({
            "step": steps[i], "vs_step": steps[i - 1],
            "wins": wins, "n": total, "winrate": round(wr, 4),
            "elo_delta": round(delta, 1), "elo": round(elo, 1),
        }), flush=True)
        states.pop(paths[i - 1], None)
    launches_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
