#!/usr/bin/env python
"""End-to-end learning demo of the PyTorch/CUDA port: 9x9 self-play ->
replay -> learner, in one process.  Twin of `scripts/demo_train_9x9.py`
on `elf_tpu_torch`.

Runs the full AlphaZero loop with a small net and prints loss, entropy and
game statistics per iteration as JSON lines; then plays the trained model
against its random initialisation (colour-swapped halves) as a learning
check, and prints a final JSON summary.  Same options and output as the
JAX script, plus `--device` (default `cuda`); `--out` has no default,
since checkpoints cross between the two packages and a shared directory
would mix the two scripts' files.

At demo scale (minutes of training) both sides' search with terminal
Tromp-Taylor shortcuts masks net-strength differences: a win rate above
0.5 needs a longer run (`scripts/prove_learning_torch.py`).

  python scripts/demo_train_9x9_torch.py --iters 40 --out build/demo9_torch
"""

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.models.resnet import ModelConfig, eval_fn_builder
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import (
    ActorConfig,
    SelfplayActor,
    make_pair_eval_builder,
)
from elf_tpu_torch.stats import WinRate
from elf_tpu_torch.tools.match import head_to_head
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--out", type=str, required=True,
                    help="checkpoint directory; give each run its own")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--batch_boards", type=int, default=96)
    ap.add_argument("--rollouts", type=int, default=48)
    ap.add_argument("--train_bs", type=int, default=256)
    ap.add_argument("--minibatches_per_iter", type=int, default=8)
    ap.add_argument("--eval_games", type=int, default=16)
    ap.add_argument("--final_eval", choices=["policy", "mcts", "both"],
                    default="both",
                    help="final trained-vs-random check: raw-policy play "
                    "(clean net-quality signal), MCTS play (strength at "
                    "the demo's rollout count), or both")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    size = 9
    cfg = ModelConfig(board_size=size, num_planes=18, num_block=args.blocks,
                      dim=args.dim)
    to = TrainOptions(batchsize=args.train_bs, num_block=args.blocks,
                      dim=args.dim, lr=0.02, num_cooldown=4)
    trainer = Trainer(cfg, to, device=device)
    eval_raw = trainer.make_eval_fn()

    replay = ReplayBuffer(ReplayOptions(num_reader=8, q_min_size=2,
                                        q_max_size=2000), seed=0)
    pipeline = TrainingPipeline(replay, size, seed=0)
    runner = LearnerRunner(trainer, pipeline, args.out, to, seed=0)
    # random-init snapshot for the final eval: a deep copy, since the train
    # step updates the net and its optimizer slots in place
    state0 = copy.deepcopy(runner.state)

    acfg = ActorConfig(board_size=size, batch=args.batch_boards, komi=7.5,
                       policy_distri_cutoff=10, resign_thres=0.0,
                       never_resign_prob=1.0)
    # ply_pass_enabled matters even at demo scale: with pass legal from
    # ply 0, the winning side's search (FPU gives an unexplored pass the
    # parent-mean Q) pours visits into pass and the policy target teaches
    # the net to pass everywhere (the reference's production configs set
    # ply_pass_enabled=160 for this reason, start_client.sh:24)
    mcfg = MCTSConfig(num_rollouts=args.rollouts, rollouts_per_batch=8,
                      c_puct=1.5, root_epsilon=0.25, root_alpha=0.2,
                      komi=7.5, ply_pass_enabled=40)
    actor = SelfplayActor(acfg, mcfg, eval_fn_builder, seed=1, device=device)

    wr = WinRate()
    t0 = time.time()
    for it in range(args.iters):
        recs = actor.play_moves(runner.state.net, None, 12)
        for r in recs:
            pipeline.insert_record(r)
            wr.feed(r.result.reward)
        stats = None
        if replay.size() >= 32:
            for _ in range(args.minibatches_per_iter):
                stats = runner.run_minibatch() or stats
        line = {
            "iter": it,
            "t": round(time.time() - t0, 1),
            "games": actor.completed_games,
            "replay": replay.size(),
            "step": int(runner.state.step),
        }
        if stats:
            line.update({
                "loss": round(stats["loss/total"], 4),
                "policy_loss": round(stats["loss/policy"], 4),
                "value_loss": round(stats["loss/value"], 4),
                "entropy": round(stats["entropy"], 4),
            })
        print(json.dumps(line), flush=True)

    runner.episode_summary()

    # learning check: trained vs random init, swapped halves, argmax play.
    # Policy-only play (num_rollouts=0, the actPolicyOnly path) isolates net
    # quality; MCTS play measures strength at the demo's rollout count
    # (where terminal TT shortcuts can mask small-net differences).
    def trained_vs_random(num_rollouts: int, seed: int):
        eval_actor = SelfplayActor(
            ActorConfig(board_size=size, batch=max(args.eval_games // 2, 1),
                        komi=7.5, policy_distri_cutoff=0, resign_thres=0.0,
                        never_resign_prob=1.0),
            MCTSConfig(num_rollouts=num_rollouts, rollouts_per_batch=8,
                       c_puct=1.5, root_epsilon=0.0, komi=7.5,
                       ply_pass_enabled=40),
            make_pair_eval_builder(eval_raw), seed=seed, device=device,
        )
        return head_to_head(eval_actor, (runner.state.net, None),
                            (state0.net, None), max(args.eval_games // 2, 1))

    summary = {
        "final": True,
        "selfplay_black_winrate": round(wr.black_winrate(), 3),
    }
    if args.final_eval in ("policy", "both"):
        w, n = trained_vs_random(0, seed=9)
        summary["policy_only_trained_vs_random"] = f"{w}/{n}"
        summary["policy_only_winrate"] = round(w / max(n, 1), 3)
    if args.final_eval in ("mcts", "both"):
        w, n = trained_vs_random(args.rollouts, seed=11)
        summary["mcts_trained_vs_random"] = f"{w}/{n}"
        summary["mcts_winrate"] = round(w / max(n, 1), 3)
    summary["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
