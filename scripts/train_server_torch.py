#!/usr/bin/env python
"""Training server of the PyTorch/CUDA port: learner + TCP control plane.

Twin of `scripts/train_server.py` on `elf_tpu_torch` (reference
`scripts/elfgames/go/train.py` + `start_server.sh`): starts the control
plane, waits for sufficient self-play, then runs train episodes,
checkpoints `save-<step>.bin`, and queues each new version for
evaluation; `EvalSubCtrl` promotes or rejects it from the eval games the
clients (`scripts/selfplay_client_torch.py`) play.

Same options as the JAX script, plus `--device` (default `cuda`; the CPU
runs only when asked for with `--device cpu`).  `--model df_pred` trains
supervised (the offline train mode, MultiplePrediction on the records'
moves); `--model df_policy` raises ValueError, as the JAX server does.  `--load` takes checkpoints
of either package.  `--use_mesh` on one device runs the plain train step,
as the JAX trivial 1-device mesh does; more than one device, and the
`--dist_*` flags, raise NotImplementedError until `parallel/` is ported.
`--trace_dir` writes a torch.profiler Chrome trace of the first episode.
On exit (the episode/promotion/time limits, or SIGINT) the server logs one
`summary {...}` JSON line: stage timers, game counts, promotions, peak
device memory.

Example (prod-shaped, start_server.sh:10):
  python scripts/train_server_torch.py --ckpt_dir /ckpts --batchsize 256 \
      --num_block 20 --dim 256 --lr 0.01 --port 5556
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.config import (
    ControlOptions,
    GameOptions,
    MCTSOptions,
    OptionMap,
    OptionSpec,
    ReplayOptions,
    TrainOptions,
)
from elf_tpu_torch.control.server import TrainServer
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.logging_utils import configure, get_indexed_logger
from elf_tpu_torch.models.registry import make_trainer
from elf_tpu_torch.profiling import Profiler
from elf_tpu_torch.selfplay.records import TSOptions
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import load_checkpoint


def parse_args(argv=None):
    spec = OptionSpec.from_dataclasses(
        [GameOptions, MCTSOptions, TrainOptions, ReplayOptions,
         ControlOptions]
    )
    parser = spec.to_argparse()
    parser.add_argument("--ckpt_dir", type=str, required=True)
    parser.add_argument("--num_minibatch", type=int, default=1000)
    parser.add_argument("--num_episodes", type=int, default=0,
                        help="0 = run forever")
    parser.add_argument("--target_promotions", type=int, default=0,
                        help="exit cleanly once this many eval-gated "
                             "promotions happened (0 = no target)")
    parser.add_argument("--max_seconds", type=float, default=0,
                        help="wall-clock budget; exit cleanly when "
                             "exceeded (0 = no budget)")
    parser.add_argument("--ckpt_keep", type=int, default=10,
                        help="keep-last-k checkpoints")
    parser.add_argument("--load", type=str, default="",
                        help="resume from checkpoint path or dir")
    parser.add_argument("--use_mesh", type=int, default=1,
                        help="data-parallel train step over all devices; "
                             "one device runs the plain step, more raise "
                             "until parallel/ is ported")
    parser.add_argument("--dist_coordinator", type=str, default="",
                        help="multi-process learner: not ported yet")
    parser.add_argument("--dist_num_processes", type=int, default=0)
    parser.add_argument("--dist_process_id", type=int, default=-1)
    parser.add_argument("--trace_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the "
                             "first episode here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--loglevel", type=str, default="info")
    args = parser.parse_args(argv)
    return spec, args


def main(argv=None):
    spec, args = parse_args(argv)
    om = OptionMap(spec, vars(args))
    g = om.get(GameOptions)
    mo = om.get(MCTSOptions)
    to = om.get(TrainOptions)
    ro = om.get(ReplayOptions)
    co = om.get(ControlOptions)

    if (args.dist_coordinator or args.dist_num_processes
            or args.dist_process_id >= 0):
        raise NotImplementedError(
            "--dist_*: the multi-process learner is not ported yet "
            "(ROADMAP Queue 1, parallel/)")
    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.use_mesh and n_dev > 1:
        raise NotImplementedError(
            f"--use_mesh over {n_dev} devices: data-parallel training is "
            "not ported yet (ROADMAP Queue 1, parallel/); expose one device "
            "or pass --use_mesh 0")
    configure(args.loglevel)
    logger = get_indexed_logger("scripts.train_server_torch-")

    # model family -> trainer, train mode, feature set (registry.py)
    trainer, train_mode, feature_set = make_trainer(
        g.model, g.board_size, to, use_df_feature=g.use_df_feature,
        device=device,
    )
    logger.info("learner: model %s, train mode %s, feature set %s, "
                "%d input planes", g.model, train_mode, feature_set,
                trainer.cfg.num_planes)
    if args.use_mesh:
        logger.info("training on 1 device (%s): the plain step", device)

    # pipeline + server wiring: accepted records flow into the pipeline
    replay = ReplayBuffer(ro, seed=g.seed)
    pipeline = TrainingPipeline(
        replay, g.board_size, seed=g.seed,
        data_aug=g.data_aug,
        num_future_actions=g.num_future_actions,
        feature_set=feature_set,
    )
    runner = LearnerRunner(trainer, pipeline, args.ckpt_dir, to,
                           seed=g.seed, train_mode=train_mode)
    if args.load:
        runner.state = load_checkpoint(args.load, template=runner.state)
        logger.info("resumed from %s at step %d", args.load,
                    int(runner.state.step))

    # the server drives the fleet's search settings: every request ships
    # TSOptions built from --num_rollouts/--c_puct/--root_epsilon/...
    # (model_pair.h:10); eval requests get the noise-free variant
    # server-side (ctrl_eval.h:233)
    runner.ckpt_keep = args.ckpt_keep
    server = TrainServer(
        co, ro, port=co.port, record_sink=pipeline.insert_record,
        journal_dir=os.path.join(args.ckpt_dir, "journal"),
        mcts_opt=TSOptions.from_search_options(mo),
        promotion_log=os.path.join(args.ckpt_dir, "promotions.jsonl"),
    )
    server.replay = replay  # share the buffer
    if args.load:
        # server restart: rebuild replay from the record journal
        server.resume_from_journal()
    server.start()
    initial_ver = runner.version()
    # write the initial checkpoint BEFORE declaring ready: clients gate on
    # the status endpoint's ready=True and immediately load this version
    runner.episode_summary()
    if co.eval_old_model >= 0:
        # eval-only bring-up: candidate = loaded model, baseline =
        # --eval_old_model (train.py:60 setEvalMode)
        server.set_eval_mode(initial_ver, co.eval_old_model)
    else:
        server.set_initial_version(initial_ver)
    logger.info("server up on :%d, initial version %d",
                server.port, initial_ver)

    def on_promote(ver: int) -> None:
        logger.info("model %d promoted to selfplay baseline", ver)

    server.on_promote = on_promote
    # learner<->selfplay coupling: skip stale in-flight batches after a
    # promotion (train.py:70-78)
    runner.version_provider = server.selfplay.version
    runner.keep_prev_selfplay = co.keep_prev_selfplay

    prof = Profiler(trace_dir=args.trace_dir)
    episode = 0
    try:
        logger.info("waiting for sufficient selfplay...")
        with prof.phase("wait_selfplay"):
            server.wait_for_sufficient_selfplay(timeout=86400)
        t_start = time.time()
        while True:
            if args.num_episodes and episode >= args.num_episodes:
                break
            if (args.target_promotions > 0
                    and len(server.promotions) >= args.target_promotions):
                logger.info("target of %d promotions reached; exiting",
                            args.target_promotions)
                break
            if (args.max_seconds > 0
                    and time.time() - t_start > args.max_seconds):
                logger.info("wall budget exhausted; exiting")
                break
            episode += 1
            # trace only the first episode (trace files grow fast)
            tracer = prof.trace() if episode == 1 else contextlib.nullcontext()
            with tracer:
                with prof.phase("train_episode"):
                    stats = runner.episode(args.num_minibatch)
                with prof.phase("cooldown_checkpoint"):
                    ver = runner.episode_summary()
            with prof.phase("notify_eval"):
                server.notify_new_version(initial_ver, ver)
            logger.info(
                "episode %d: ver %d, %s | %s",
                episode, ver,
                {k: round(v, 4) for k, v in stats.items()},
                server.info(),
            )
            logger.info("%s", prof.report())
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        phases = {k: {"n": s.counter, "total_s": s.summation,
                      "min_s": s.min_value, "max_s": s.max_value}
                  for k, s in prof.timer.records.items()
                  if not k.startswith("before_")}
        summary = {
            "episodes": episode, "num_minibatch": args.num_minibatch,
            "phases": phases,
            "num_selfplay_games": server.num_selfplay_games,
            "num_eval_games": server.num_eval_games,
            "replay_size": server.replay.size(),
            "promotions": server.promotions,
            "device": str(device),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
        }
        logger.info("summary %s", json.dumps(summary))


if __name__ == "__main__":
    main()
