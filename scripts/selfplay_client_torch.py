#!/usr/bin/env python
"""Self-play client of the PyTorch/CUDA port: one lockstep actor shard
reporting to the training server.

Twin of `scripts/selfplay_client.py` on `elf_tpu_torch` (reference
`scripts/elfgames/go/selfplay.py` + `start_client.sh`): connect to the
control server (`scripts/train_server_torch.py`), load model versions from
the shared checkpoint directory on request, play MCTS self-play games and,
when the server assigns them, colour-swapped candidate-vs-baseline eval
games on a second, noise-free actor that never resigns; ship the records.

Same options as the JAX script, plus `--device` (default `cuda`; the CPU
runs only when asked for with `--device cpu`).  `--model kata_nbt` plays
with KataGo's nested-bottleneck net (`elf_tpu_torch/models/nbt.py`,
`b18c384nbt`'s widths); each version is read by the model family's reader
(`registry.ModelFamily.load_model`).  SIGINT or SIGTERM ends the
play loop after the current round (a second signal at once); the client
then logs one `summary {...}` JSON line: stage timers (`selfplay_moves`,
`eval_moves`, `ship_records`), board moves per second, completed games,
the liberty kernels' launch counts since the loop started, peak device
memory.

Example (prod-shaped, start_client.sh:11):
  python scripts/selfplay_client_torch.py --ckpt_dir /ckpts \
      --server_addr 10.0.0.1 --port 5556 --num_games 32 \
      --num_rollouts 1600 --root_epsilon 0.25
"""

import dataclasses
import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.config import (
    ControlOptions,
    GameOptions,
    MCTSOptions,
    OptionMap,
    OptionSpec,
    TrainOptions,
)
from elf_tpu_torch.control.client import SelfplayClient
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.logging_utils import configure, get_indexed_logger
from elf_tpu_torch.models.registry import get_model_family, make_trainer
from elf_tpu_torch.models.resnet import eval_fn_builder, serving_copy
from elf_tpu_torch.profiling import Profiler
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import (
    ActorConfig,
    SelfplayActor,
    make_pair_eval_builder,
)


def parse_args(argv=None):
    spec = OptionSpec.from_dataclasses(
        [GameOptions, MCTSOptions, TrainOptions, ControlOptions]
    )
    parser = spec.to_argparse()
    parser.add_argument("--ckpt_dir", type=str, required=True)
    parser.add_argument("--moves_per_round", type=int, default=16)
    parser.add_argument("--max_rounds", type=int, default=0,
                        help="stop after this many rounds (0 = forever)")
    parser.add_argument("--max_games", type=int, default=0,
                        help="stop after completing this many games "
                             "(work-based; 0 = forever)")
    parser.add_argument("--wait_server_ready", type=int, default=1,
                        help="block until the server reports ready "
                             "before starting the play loop")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--loglevel", type=str, default="info")
    return spec, parser.parse_args(argv)


def net_reader(g: GameOptions, to: TrainOptions, device):
    """(feature_set, eval_raw, read_net) of the model family `g.model`:
    the pair evaluator's forward `eval_raw(net, batch_stats, features)` and
    `read_net(path)`, the net of a checkpoint file on `device`, by the
    family's reader."""
    trainer, _train_mode, feature_set = make_trainer(
        g.model, g.board_size, to, use_df_feature=g.use_df_feature,
        device=device,
    )
    load = get_model_family(g.model).load_model
    return (feature_set, trainer.make_eval_fn(),
            lambda path: load(path, trainer.cfg, device))


def main(argv=None):
    spec, args = parse_args(argv)
    om = OptionMap(spec, vars(args))
    g = om.get(GameOptions)
    mo = om.get(MCTSOptions)
    to = om.get(TrainOptions)
    co = om.get(ControlOptions)

    device = resolve_device(args.device)
    configure(args.loglevel)
    logger = get_indexed_logger("scripts.selfplay_client_torch-")

    feature_set, eval_raw, read_net = net_reader(g, to, device)

    acfg = ActorConfig(
        board_size=g.board_size,
        batch=g.num_games,
        komi=g.komi,
        policy_distri_cutoff=g.policy_distri_cutoff,
        resign_thres=co.resign_thres,
        never_resign_prob=co.never_resign_prob,
        cheat_selfplay_random_result=g.cheat_selfplay_random_result,
        dump_record_prefix=g.dump_record_prefix,
        handicap=g.handicap_level,
        persistent_tree=mo.persistent_tree,
        move_cutoff=g.move_cutoff,
        num_games_per_thread=g.num_games_per_thread,
        preload_sgf=g.preload_sgf,
        preload_sgf_move_to=g.preload_sgf_move_to,
        policy_distri_training_for_all=g.policy_distri_training_for_all,
        following_pass=g.following_pass,
    )
    mcfg = MCTSConfig(
        feature_set=feature_set,
        num_rollouts=mo.num_rollouts,
        rollouts_per_batch=mo.rollouts_per_batch,
        c_puct=mo.c_puct,
        virtual_loss=mo.virtual_loss,
        root_epsilon=mo.root_epsilon,
        root_alpha=mo.root_alpha,
        komi=g.komi,
        ply_pass_enabled=g.ply_pass_enabled,
        white_puct=g.white_puct,
        white_num_rollouts=g.white_num_rollouts,
        use_prior=mo.use_prior,
        unexplored_q_zero=mo.unexplored_q_zero,
        root_unexplored_q_zero=mo.root_unexplored_q_zero,
        max_nodes=mo.max_nodes,
    )
    actor = SelfplayActor(acfg, mcfg, eval_fn_builder, seed=g.seed,
                          device=device)
    # eval-capable: a second actor plays candidate-vs-baseline jobs with
    # noise-free MCTS (the server strips noise in the shipped mcts_opt)
    eval_actor = SelfplayActor(
        dataclasses.replace(acfg, never_resign_prob=1.0, resign_thres=0.0),
        dataclasses.replace(mcfg, root_epsilon=0.0, root_alpha=0.0),
        make_pair_eval_builder(eval_raw),
        seed=g.seed + 1, device=device,
    )

    def load_params(ver: int):
        # a missing file raises OSError, one still being written ValueError:
        # the client retries (or skips an eval round) on both
        path = os.path.join(args.ckpt_dir, f"save-{ver}.bin")
        return serving_copy(read_net(path)), None

    client = SelfplayClient(
        co, actor, load_params, port=co.port, eval_actor=eval_actor,
        cheat_eval_new_model_wins_half=g.cheat_eval_new_model_wins_half,
    )
    logger.info(
        "client %s -> %s:%d (B=%d, %d rollouts, %s)",
        client.identity, co.server_addr, co.port, g.num_games,
        mo.num_rollouts, device,
    )
    stop = threading.Event()

    def on_signal(signum, frame):
        # the first signal ends the loop after this round; a second one
        # interrupts whatever runs (a model-load retry loop, a round)
        if stop.is_set():
            raise KeyboardInterrupt
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    if args.wait_server_ready:
        if not client.wait_server_ready():
            logger.error("server never became ready; exiting")
            sys.exit(2)
        logger.info("server ready")
    prof = Profiler()
    kernels.reset_launch_counts()
    try:
        client.run(moves_per_round=args.moves_per_round,
                   max_rounds=args.max_rounds if args.max_rounds > 0 else None,
                   max_games=args.max_games if args.max_games > 0 else None,
                   stop_fn=stop.is_set, profiler=prof)
    except KeyboardInterrupt:
        pass
    finally:
        client.transport.close()
        phases = {}
        for name, boards in (("selfplay_moves", actor.cfg.batch),
                             ("eval_moves",
                              eval_actor.active_boards or eval_actor.cfg.batch)):
            s = prof.timer.records.get(name)
            if s is not None and s.counter:
                phases[name] = {
                    "rounds": s.counter, "total_s": s.summation,
                    "min_s": s.min_value, "max_s": s.max_value,
                    "board_moves_per_s": (s.counter * args.moves_per_round
                                          * boards / s.summation),
                }
        s = prof.timer.records.get("ship_records")
        if s is not None and s.counter:
            phases["ship_records"] = {"n": s.counter, "total_s": s.summation}
        summary = {
            "identity": client.identity, "device": str(device),
            "moves_per_round": args.moves_per_round, "phases": phases,
            "selfplay_games": actor.completed_games,
            "eval_games": eval_actor.completed_games,
            "kernel_launches": kernels.launch_counts(),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
        }
        logger.info("summary %s", json.dumps(summary))


if __name__ == "__main__":
    main()
