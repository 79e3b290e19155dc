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
of either package.

The learner over several cards (`elf_tpu_torch.parallel`): one process
per card.  `--use_mesh 1` with n > 1 visible cards spawns n ranks on this
host (NCCL, tp = 2 when n is even, as the JAX script picks it); on one
device it runs the plain step, as the JAX trivial 1-device mesh does.
`--dist_coordinator host:port --dist_num_processes N --dist_process_id i`
(one process per card, across hosts; `--use_mesh 1` required) joins rank
i of a dp-only world on `cuda:<i mod visible cards>` (gloo with `--device
cpu`).  Rank 0 hosts the TCP control plane and the replay buffer and
broadcasts each sampled batch and its decisions (wait, stop); every rank
trains on its rows of the batch; rank 0 writes the checkpoints.
`--trace_dir` writes a torch.profiler Chrome trace of the first episode
(rank 0).  On exit (the episode/promotion/time limits, or SIGINT) each
process logs one `summary {...}` JSON line: stage timers, game counts,
promotions, peak device memory.

Example (prod-shaped, start_server.sh:10):
  python scripts/train_server_torch.py --ckpt_dir /ckpts --batchsize 256 \
      --num_block 20 --dim 256 --lr 0.01 --port 5556
"""

import contextlib
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

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
from elf_tpu_torch.parallel.distributed import maybe_initialize_distributed
from elf_tpu_torch.parallel.mesh import make_mesh
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
                        help="shard the train step over all local cards, "
                             "one rank each (tp = 2 when their number is "
                             "even); one device runs the plain step")
    parser.add_argument("--dist_coordinator", type=str, default="",
                        help="host:port of rank 0's rendezvous: run one "
                             "train_server_torch.py process per card with "
                             "the same flags (+ --dist_process_id); rank 0 "
                             "hosts the TCP control plane and broadcasts "
                             "batches, the step spans the global dp mesh "
                             "(DistributedDataParallel counterpart, "
                             "df_model3.py:213-247)")
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


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _local_rank(rank: int, world: int, tp: int, port: int, argv) -> None:
    """One spawned rank of `--use_mesh 1` over this host's cards."""
    maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank)
    serve(*parse_args(argv), tp=tp)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    spec, args = parse_args(argv)
    if args.dist_coordinator and not args.use_mesh:
        raise ValueError("--dist_* requires --use_mesh 1 (the multi-host "
                         "learner is the sharded step over the global mesh)")
    if args.dist_coordinator:
        maybe_initialize_distributed(
            args.dist_coordinator, args.dist_num_processes,
            args.dist_process_id,
            backend="gloo" if args.device == "cpu" else "nccl")
        return serve(spec, args, tp=1)
    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.use_mesh and n_dev > 1:
        # one rank per card; tp = 2 when the cards pair up (train_server.py)
        tp = 2 if n_dev % 2 == 0 else 1
        mp.spawn(_local_rank, args=(n_dev, tp, _free_port(), argv),
                 nprocs=n_dev)
        return None
    return serve(spec, args, tp=1)


def serve(spec, args, tp: int = 1):
    """The server's main loop in this process: rank 0 of a
    torch.distributed world (or the only process) with the control plane,
    or another rank following it."""
    om = OptionMap(spec, vars(args))
    g = om.get(GameOptions)
    mo = om.get(MCTSOptions)
    to = om.get(TrainOptions)
    ro = om.get(ReplayOptions)
    co = om.get(ControlOptions)

    device = resolve_device(args.device)
    configure(args.loglevel)
    logger = get_indexed_logger("scripts.train_server_torch-")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    # model family -> trainer, train mode, feature set (registry.py)
    trainer, train_mode, feature_set = make_trainer(
        g.model, g.board_size, to, use_df_feature=g.use_df_feature,
        device=device,
    )
    logger.info("learner: model %s, train mode %s, feature set %s, "
                "%d input planes, on %s", g.model, train_mode, feature_set,
                trainer.cfg.num_planes, device)
    mesh = None
    if args.use_mesh:
        # one device gets the trivial 1 x 1 mesh: the plain step
        mesh = make_mesh(world, tp=tp)
        logger.info("training on mesh %s (%d processes)", mesh.shape, world)

    # pipeline + server wiring: accepted records flow into the pipeline
    replay = ReplayBuffer(ro, seed=g.seed)
    pipeline = TrainingPipeline(
        replay, g.board_size, seed=g.seed,
        data_aug=g.data_aug,
        num_future_actions=g.num_future_actions,
        feature_set=feature_set,
    )
    runner = LearnerRunner(trainer, pipeline, args.ckpt_dir, to, mesh=mesh,
                           seed=g.seed, train_mode=train_mode)
    if args.load:
        runner.load_state(load_checkpoint(args.load,
                                          template=runner.full_state()))
        logger.info("resumed from %s at step %d", args.load,
                    int(runner.state.step))

    # the server drives the fleet's search settings: every request ships
    # TSOptions built from --num_rollouts/--c_puct/--root_epsilon/...
    # (model_pair.h:10); eval requests get the noise-free variant
    # server-side (ctrl_eval.h:233)
    runner.ckpt_keep = args.ckpt_keep
    sync = runner.sync  # HostSync over several ranks, else None
    server = None
    if rank0:
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
    if rank0:
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
        # promotion (train.py:70-78; several ranks: rank 0 stale-checks
        # before broadcasting, LearnerRunner._multihost_batch)
        runner.version_provider = server.selfplay.version
        runner.keep_prev_selfplay = co.keep_prev_selfplay

    prof = Profiler(trace_dir=args.trace_dir if rank0 else "")
    episode = 0
    try:
        logger.info("waiting for sufficient selfplay...")
        with prof.phase("wait_selfplay"):
            if sync is None:
                server.wait_for_sufficient_selfplay(timeout=86400)
            else:
                # collective: rank 0 polls the real gate, everyone agrees
                while True:
                    ok = bool(rank0 and server.wait_for_sufficient_selfplay(
                        timeout=0.5, poll=0.25))
                    if sync.flag(ok):
                        break
                    time.sleep(1.0)
        t_start = time.time()

        def should_stop() -> bool:
            if args.num_episodes and episode >= args.num_episodes:
                return True
            if (server is not None and args.target_promotions > 0
                    and len(server.promotions) >= args.target_promotions):
                logger.info("target of %d promotions reached; exiting",
                            args.target_promotions)
                return True
            if (args.max_seconds > 0
                    and time.time() - t_start > args.max_seconds):
                logger.info("wall budget exhausted; exiting")
                return True
            return False

        while True:
            # several ranks: rank 0's verdict is authoritative (promotion
            # count and wall clock may differ across processes)
            if sync.flag(should_stop()) if sync is not None else should_stop():
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
                if rank0:
                    server.notify_new_version(initial_ver, ver)
            logger.info(
                "episode %d: ver %d, %s | %s",
                episode, ver,
                {k: round(v, 4) for k, v in stats.items()},
                server.info() if rank0 else f"worker {dist.get_rank()}",
            )
            logger.info("%s", prof.report())
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.stop()
        phases = {k: {"n": s.counter, "total_s": s.summation,
                      "min_s": s.min_value, "max_s": s.max_value}
                  for k, s in prof.timer.records.items()
                  if not k.startswith("before_")}
        summary = {
            "episodes": episode, "num_minibatch": args.num_minibatch,
            "phases": phases,
            "rank": dist.get_rank() if dist.is_initialized() else 0,
            "world": world,
            "device": str(device),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
        }
        if server is not None:
            summary.update(
                num_selfplay_games=server.num_selfplay_games,
                num_eval_games=server.num_eval_games,
                replay_size=server.replay.size(),
                promotions=server.promotions)
        logger.info("summary %s", json.dumps(summary))
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
