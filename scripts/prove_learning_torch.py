#!/usr/bin/env python
"""Prove that the self-play RL loop strengthens the model.

This is the system-level claim the whole platform exists for
(reference `README.rst:13`: ELF OpenGo trains a superhuman player
via self-play): run the real selfplay -> replay -> train loop (no cheat
modes) on a small board until the trained checkpoint beats its own
random initialization in color-swapped head-to-head games at FIXED
rollouts.

Protocol:
 - 9x9 (default), small ResNet, real MCTS self-play with Dirichlet root
   noise + diverse opening sampling; no resign (clean outcomes).
 - Training interleaved with self-play at a fixed samples-per-position
   ratio (each generated position is trained on ~`sample_ratio` times).
 - Every `eval_every_games` finished games: checkpoint + a 2-half
   color-swapped eval of the current net vs the FROZEN random init
   (tools.match.head_to_head: boards reset at the half
   boundary, so no swap contamination) at `eval_rollouts` rollouts.
 - The win-rate-vs-games curve goes to `<out>/learning_curve.jsonl`;
   when a periodic eval reaches `target_winrate`, a final confirmation
   match of `final_games` games decides success.

Resumable: re-running with the same --out continues from the latest
checkpoint; the random-init snapshot (`init.bin`) is written once on the
first run so the baseline stays fixed across resumes.

This is the PyTorch/CUDA counterpart of `scripts/prove_learning.py`: the
same options, protocol, output files and return code, on `elf_tpu_torch`,
plus `--device` (default `cuda`; `cpu` runs the plain PyTorch path) and
`--use_bf16`.  `--out` has no default: checkpoints cross between the two
packages, so a shared directory would resume the other script's run.

On one GPU:

  python scripts/prove_learning_torch.py --out build/prove9_torch

CI-scale variant on the CPU (tests/test_torch_learning.py asserts on it):

  python scripts/prove_learning_torch.py --device cpu --seed 11 \
      --out build/ci5_torch --board_size 5 --blocks 1 --dim 16 \
      --batch_boards 32 --rollouts 16 --train_bs 64 --komi 2.5 \
      --sample_ratio 2.0 --eval_every_games 120 --eval_games 24 \
      --eval_rollouts 0 --final_games 48 --target_winrate 0.6 \
      --min_replay_games 32 --max_seconds 420 --policy_distri_cutoff 4 \
      --ply_pass_enabled 8
"""

import argparse
import copy
import json
import os
import sys
import time
import zlib

import torch

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
from elf_tpu_torch.training.trainer import (
    Trainer,
    load_checkpoint,
    save_checkpoint,
    save_params_checkpoint,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True,
                    help="run directory; a run resumes from what it holds, "
                         "so give each run its own")
    ap.add_argument("--board_size", type=int, default=9)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch_boards", type=int, default=256)
    ap.add_argument("--rollouts", type=int, default=96)
    ap.add_argument("--rollouts_per_batch", type=int, default=8)
    ap.add_argument("--c_puct", type=float, default=1.5)
    ap.add_argument("--root_alpha", type=float, default=0.2)
    ap.add_argument("--train_bs", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--value_weight", type=float, default=1.0,
                    help="scale on the value MSE loss term (0.25 tames "
                         "the small-replay value-overfit dip)")
    ap.add_argument("--sample_ratio", type=float, default=1.5,
                    help="avg times each generated position is trained on")
    ap.add_argument("--policy_distri_cutoff", type=int, default=-1,
                    help="diverse-sampling ply cutoff; -1 = n2*30/361")
    ap.add_argument("--ply_pass_enabled", type=int, default=-1,
                    help="pass legal from this ply; -1 = n2*160/361")
    ap.add_argument("--replay_games", type=int, default=6000,
                    help="replay window (games, FIFO)")
    ap.add_argument("--min_replay_games", type=int, default=64)
    ap.add_argument("--eval_every_games", type=int, default=1500)
    ap.add_argument("--eval_games", type=int, default=64,
                    help="games per periodic eval (2 swapped halves)")
    ap.add_argument("--eval_rollouts", type=int, default=64)
    ap.add_argument("--final_games", type=int, default=200,
                    help="games in the final confirmation match")
    ap.add_argument("--target_winrate", type=float, default=0.65)
    ap.add_argument("--max_seconds", type=float, default=6 * 3600,
                    help="CUMULATIVE wall-clock budget across resumes "
                         "(progress.json restores elapsed time)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--keep", type=int, default=10,
                    help="keep-last-k full checkpoints in --out")
    ap.add_argument("--anchor_every", type=int, default=0,
                    help="every N periodic evals, also play the current "
                         "net vs a rolling ANCHOR checkpoint (then advance "
                         "the anchor) — trained-vs-trained progress signal "
                         "that stays informative inside the vs-init value "
                         "dip; 0 = off")
    ap.add_argument("--ladder_every", type=int, default=0,
                    help="ladder-suite raw-policy scorecard every N "
                         "periodic evals (19x19 only; "
                         "<out>/ladder_scorecard.jsonl); 0 = off")
    ap.add_argument("--export", type=int, default=0,
                    help="1 = maintain durable bf16 params-only exports in "
                         "--out (init_params.bin / export-latest.bin / "
                         "export-best.bin) small enough to commit, so a "
                         "later run can resume or re-evaluate from them")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--use_bf16", type=int, default=1,
                    help="1 = bf16 convolutions on fp32 master weights "
                         "(default); 0 = fp32 throughout")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    size = args.board_size
    n2 = size * size
    cutoff = (
        args.policy_distri_cutoff
        if args.policy_distri_cutoff >= 0
        else max(4, n2 * 30 // 361)
    )
    pass_ply = (
        args.ply_pass_enabled
        if args.ply_pass_enabled >= 0
        else max(6, n2 * 160 // 361)
    )

    cfg = ModelConfig(board_size=size, num_planes=18, num_block=args.blocks,
                      dim=args.dim, use_bf16=bool(args.use_bf16))
    to = TrainOptions(batchsize=args.train_bs, num_block=args.blocks,
                      dim=args.dim, lr=args.lr, num_cooldown=8,
                      value_loss_weight=args.value_weight)
    trainer = Trainer(cfg, to, device=device)
    eval_raw = trainer.make_eval_fn()

    os.makedirs(args.out, exist_ok=True)
    curve_path = os.path.join(args.out, "learning_curve.jsonl")
    state_path = os.path.join(args.out, "progress.json")
    init_path = os.path.join(args.out, "init.bin")

    runner = LearnerRunner(
        trainer,
        TrainingPipeline(
            ReplayBuffer(
                ReplayOptions(num_reader=8, q_min_size=1,
                              q_max_size=max(1, args.replay_games // 8)),
                seed=args.seed,
            ),
            size, seed=args.seed,
        ),
        args.out, to, seed=args.seed,
    )
    runner.ckpt_keep = args.keep
    replay = runner.pipeline.replay

    progress = {"games": 0, "positions": 0, "train_steps": 0, "wall": 0.0,
                "eval_idx": 0, "best_winrate": -1.0}
    init_export = os.path.join(args.out, "init_params.bin")
    latest_export = os.path.join(args.out, "export-latest.bin")
    if os.path.exists(init_path) or os.path.exists(init_export):
        template = runner.state
        # full init.bin if present; otherwise the committed bf16 export
        # (cross-round resume: full checkpoints live outside git and do
        # not survive a fresh machine, the exports do)
        state0 = load_checkpoint(
            init_path if os.path.exists(init_path) else init_export,
            template=template,
        )
        latest = os.path.join(args.out, "latest")
        if os.path.exists(latest):
            runner.state = load_checkpoint(latest, template=template)
        elif os.path.exists(latest_export):
            runner.state = load_checkpoint(latest_export, template=template)
        if os.path.exists(state_path):
            with open(state_path) as f:
                progress.update(json.load(f))
        print(f"# resumed at step={int(runner.state.step)} "
              f"games={progress['games']}", flush=True)
    else:
        # frozen random-init baseline — written exactly once
        state0 = copy.deepcopy(runner.state)
        # the outcome at a small size turns on the init the seed draws, and
        # the draw depends on the torch build: print what this run drew
        crc = 0
        for p in state0.net.parameters():
            crc = zlib.crc32(p.detach().cpu().numpy().tobytes(), crc)
        print(f"# torch {torch.__version__} device {device} seed "
              f"{args.seed} init_crc32 {crc:08x}", flush=True)
        save_checkpoint(args.out, state0, keep=1000)
        os.replace(os.path.join(args.out, "save-0.bin"), init_path)
        # repoint `latest` (left dangling by the rename) so a resume
        # before the first periodic checkpoint restarts from the init
        # weights, not from a silently fresh re-initialization
        latest = os.path.join(args.out, "latest")
        if os.path.lexists(latest):
            os.remove(latest)
        os.symlink("init.bin", latest)
    if args.export and not os.path.exists(
        os.path.join(args.out, "init_params.bin")
    ):
        save_params_checkpoint(
            os.path.join(args.out, "init_params.bin"), state0
        )

    acfg = ActorConfig(
        board_size=size, batch=args.batch_boards, komi=args.komi,
        policy_distri_cutoff=cutoff, resign_thres=0.0,
        never_resign_prob=1.0,
    )
    mcfg = MCTSConfig(
        num_rollouts=args.rollouts,
        rollouts_per_batch=args.rollouts_per_batch,
        c_puct=args.c_puct, root_epsilon=0.25, root_alpha=args.root_alpha,
        komi=args.komi, ply_pass_enabled=pass_ply,
    )

    actor = SelfplayActor(acfg, mcfg, eval_fn_builder, seed=args.seed + 1,
                          device=device)

    eval_actor = SelfplayActor(
        ActorConfig(board_size=size, batch=max(args.eval_games // 2, 1),
                    komi=args.komi, policy_distri_cutoff=0,
                    resign_thres=0.0, never_resign_prob=1.0),
        MCTSConfig(num_rollouts=args.eval_rollouts,
                   rollouts_per_batch=args.rollouts_per_batch,
                   c_puct=args.c_puct, root_epsilon=0.0, komi=args.komi,
                   ply_pass_enabled=pass_ply),
        make_pair_eval_builder(eval_raw), seed=args.seed + 2,
        device=device,
    )

    def snapshot_state():
        # the train step updates the state in place: a frozen copy
        return copy.deepcopy(runner.state)

    def run_eval(n_games, opponent=None, actor_override=None):
        cur = snapshot_state()
        opp = opponent if opponent is not None else state0
        a = actor_override or eval_actor
        wins, total = head_to_head(
            a, (cur.net, None), (opp.net, None),
            max(n_games // 2, 1),
        )
        return wins, total

    # rolling trained-vs-trained anchor (vs-init evals
    # lose resolution inside the value dip; current-vs-anchor stays
    # informative because both sides are trained)
    anchor_path = os.path.join(args.out, "anchor.bin")
    anchor_state = None
    if args.anchor_every > 0 and os.path.exists(anchor_path):
        anchor_state = load_checkpoint(anchor_path, template=runner.state)

    # ladder-suite behavioural curve (19x19 suite only)
    ladder_on = args.ladder_every > 0 and size == 19
    scorecard_path = os.path.join(args.out, "ladder_scorecard.jsonl")
    if ladder_on:
        from elf_tpu_torch.tools.ladder import ladder_policy_scorecard

        def ladder_score(st):
            res = ladder_policy_scorecard(
                lambda feats, to_play: eval_raw(st.net, None, feats),
                device=device,
            )
            return res.matched, res.total

        if not os.path.exists(scorecard_path):
            m0, t0_ = ladder_score(state0)
            with open(scorecard_path, "a") as f:
                f.write(json.dumps({
                    "step": 0, "games": 0, "matched": m0, "total": t0_,
                    "accuracy": round(m0 / max(t0_, 1), 4),
                    "weights": "init",
                }) + "\n")
            print(f"# ladder baseline (init): {m0}/{t0_}", flush=True)

    wr = WinRate()
    t0 = time.time() - progress["wall"]
    last_beat = time.time()
    owed = 0.0
    next_eval = (
        (progress["games"] // args.eval_every_games + 1)
        * args.eval_every_games
    )
    last_stats = {}
    done = False
    final_result = None

    while not done:
        recs = actor.play_moves(runner.state.net, None, 16)
        for r in recs:
            runner.pipeline.insert_record(r)
            wr.feed(r.result.reward)
            progress["games"] += 1
            progress["positions"] += r.result.num_move
            owed += r.result.num_move * args.sample_ratio / args.train_bs
        if replay.size() >= args.min_replay_games:
            while owed >= 1.0:
                stats = runner.run_minibatch()
                if stats is None:
                    break
                last_stats = stats
                progress["train_steps"] += 1
                owed -= 1.0
        else:
            owed = min(owed, 20.0)  # don't dump a huge burst at warmup

        wall = time.time() - t0
        progress["wall"] = wall
        if time.time() - last_beat > 30:
            last_beat = time.time()
            print(json.dumps({
                "beat": True, "wall_s": round(wall, 1),
                "games": progress["games"],
                "positions": progress["positions"],
                "train_steps": progress["train_steps"],
                "games_per_hour": round(progress["games"] / max(wall, 1)
                                        * 3600, 1),
                **{k: round(v, 4) for k, v in last_stats.items()
                   if k.startswith("loss/total")},
            }), flush=True)
            with open(state_path, "w") as f:
                json.dump(progress, f)
        if progress["games"] >= next_eval:
            runner.episode_summary()
            wins, total = run_eval(args.eval_games)
            progress["eval_idx"] += 1
            point = {
                "games": progress["games"],
                "positions": progress["positions"],
                "step": int(runner.state.step),
                "wall_s": round(wall, 1),
                "wins": wins,
                "n": total,
                "winrate": round(wins / max(total, 1), 4),
                "selfplay_black_winrate": round(wr.black_winrate(), 3),
                **{k: round(v, 4) for k, v in last_stats.items()
                   if k.startswith("loss") or k == "entropy"},
            }
            if (args.anchor_every > 0
                    and progress["eval_idx"] % args.anchor_every == 0):
                if anchor_state is not None:
                    aw, an = run_eval(args.eval_games, opponent=anchor_state)
                    point.update({
                        "anchor_step": int(anchor_state.step),
                        "anchor_wins": aw, "anchor_n": an,
                        "anchor_winrate": round(aw / max(an, 1), 4),
                    })
                # advance the anchor to the current net
                anchor_state = snapshot_state()
                save_params_checkpoint(anchor_path, anchor_state)
            if ladder_on and progress["eval_idx"] % args.ladder_every == 0:
                lm_, lt_ = ladder_score(snapshot_state())
                point.update({"ladder_matched": lm_, "ladder_total": lt_})
                with open(scorecard_path, "a") as f:
                    f.write(json.dumps({
                        "step": int(runner.state.step),
                        "games": progress["games"],
                        "matched": lm_, "total": lt_,
                        "accuracy": round(lm_ / max(lt_, 1), 4),
                        "weights": "trained",
                    }) + "\n")
            if args.export:
                cur = snapshot_state()
                save_params_checkpoint(latest_export, cur)
                if point["winrate"] >= progress["best_winrate"]:
                    progress["best_winrate"] = point["winrate"]
                    save_params_checkpoint(
                        os.path.join(args.out, "export-best.bin"), cur
                    )
            with open(curve_path, "a") as f:
                f.write(json.dumps(point) + "\n")
            with open(state_path, "w") as f:
                json.dump(progress, f)
            print(json.dumps(point), flush=True)
            next_eval += args.eval_every_games

            if point["winrate"] >= args.target_winrate:
                # final confirmation match at full size
                fw, fn = run_eval(args.final_games)
                final_result = {
                    "final": True,
                    "games": progress["games"],
                    "step": int(runner.state.step),
                    "wall_s": round(time.time() - t0, 1),
                    "wins": fw,
                    "n": fn,
                    "winrate": round(fw / max(fn, 1), 4),
                    "target": args.target_winrate,
                    "passed": fw / max(fn, 1) >= args.target_winrate,
                }
                with open(curve_path, "a") as f:
                    f.write(json.dumps(final_result) + "\n")
                print(json.dumps(final_result), flush=True)
                if final_result["passed"]:
                    done = True
        if time.time() - t0 > args.max_seconds:
            print(json.dumps({"timeout": True, **progress}), flush=True)
            break

    runner.episode_summary()
    with open(state_path, "w") as f:
        json.dump(progress, f)
    if final_result and final_result["passed"]:
        print("LEARNING PROVEN: trained model beats its random init "
              f"{final_result['wins']}/{final_result['n']} "
              f"(winrate {final_result['winrate']:.3f} >= "
              f"{args.target_winrate})", flush=True)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
