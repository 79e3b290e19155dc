#!/usr/bin/env python
"""Supervised learning demo of the PyTorch/CUDA port: predict the moves
of an SGF archive.  Twin of `scripts/demo_supervised.py`.

Loads the SGF games of `--sgf_dir` through the offline loader and trains
`df_pred`-style (the MultiplePrediction loss: NLL of the played move +
value MSE on the result).  Top-1 accuracy rising far above the 1/362
chance floor shows that the feature pipeline, augmentation, net and
optimizer learn, apart from self-play.

Same options and JSON lines as the JAX script, with two changes:
`--device` (default cuda; the CPU only when asked for with `--device
cpu`), and `--sgf_dir` is required (the JAX default, the reference's
ladder suite, is not in the repository).

  python scripts/demo_supervised_torch.py --sgf_dir DIR --steps 300
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.models.registry import make_trainer
from elf_tpu_torch.training.offline import OfflineLoader
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--sgf_dir", type=str, required=True,
                    help="directory of .sgf (or record .json/.jsonl) files")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--num_future_actions", type=int, default=1,
                    help="multi-horizon MultiplePrediction targets")
    ap.add_argument("--model", type=str, default="df_pred",
                    help="model family (models/registry.py); df_pred is "
                         "the supervised MultiplePrediction family")
    ap.add_argument("--use_df_feature", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    size = 19
    to = TrainOptions(batchsize=args.batch, num_block=args.blocks,
                      dim=args.dim, lr=args.lr, num_cooldown=0)
    trainer, train_mode, feature_set = make_trainer(
        args.model, size, to, use_df_feature=bool(args.use_df_feature),
        device=device,
    )
    replay = ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                        q_max_size=1000), seed=0)
    pipeline = TrainingPipeline(replay, size, seed=0,
                                num_future_actions=args.num_future_actions,
                                feature_set=feature_set)
    n = OfflineLoader(pipeline, num_threads=8).load_dir(args.sgf_dir)
    print(json.dumps({"loaded_games": n, "model": args.model,
                      "train_mode": train_mode,
                      "feature_set": feature_set}), flush=True)

    # the runner maps the train mode to its step and batch builder; the
    # demo saves no checkpoint, so it needs no checkpoint directory
    runner = LearnerRunner(trainer, pipeline, ckpt_dir="", opts=to, seed=0,
                           train_mode=train_mode)

    t0 = time.time()
    accs = []
    for step in range(args.steps):
        stats = runner.run_minibatch()
        acc = stats.get("acc/top1", 0.0)
        nll = stats["loss/policy"]
        accs.append(acc)
        if step % 20 == 0 or step == args.steps - 1:
            print(json.dumps({
                "step": step,
                "t": round(time.time() - t0, 1),
                "top1_acc": round(acc, 4),
                "nll": round(nll, 4),
            }), flush=True)
    early = float(np.mean(accs[:10]))
    late = float(np.mean(accs[-10:]))
    print(json.dumps({
        "final": True,
        "acc_first10": round(early, 4),
        "acc_last10": round(late, 4),
        "chance_floor": round(1.0 / 362, 4),
        "learned": late > 10 * max(early, 1.0 / 362),
        "wall_s": round(time.time() - t0, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
