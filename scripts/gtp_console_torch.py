#!/usr/bin/env python
"""GTP console of the PyTorch/CUDA port: play against a checkpoint.

Twin of `scripts/gtp_console.py` on `elf_tpu_torch` (reference
`df_console.py` and the `gtp.sh` launcher): reads GTP on stdin, answers on
stdout.  Same options as the JAX script (`GameOptions`, `MCTSOptions`,
`TrainOptions`, `--load`, `--resign_thres`) and the same play settings (no
root noise, a random symmetry per leaf), plus `--device` (default `cuda`;
the CPU runs only when asked for with `--device cpu`).  `--load` takes a
whole `save-<step>.bin` or a params-only export.

At exit it writes one JSON line to stderr: genmoves played, seconds per
genmove (each one, the first being the warm-up), rollouts/s over the
searches after the first, the root visits each search carried over from
the previous one (and the visits the earlier tree held below the move
played into that root, which they must equal), the liberty kernels'
launch counts, peak device memory.

Example (the play-strength engine of gtp.sh):
  python scripts/gtp_console_torch.py --load runs/prove19/export-best.bin \\
      --num_block 20 --dim 256 --num_rollouts 1600 --persistent_tree true
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.config import (
    GameOptions,
    MCTSOptions,
    OptionMap,
    OptionSpec,
    TrainOptions,
)
from elf_tpu_torch.console.gtp import GtpConsole, GtpEngine
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.models.registry import make_trainer
from elf_tpu_torch.models.resnet import eval_fn_builder
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.training.trainer import load_checkpoint


def play_options(argv, extra):
    """Parse the play scripts' common options; `extra(parser)` adds the
    script's own.  Returns (args, GameOptions, MCTSOptions, TrainOptions)."""
    spec = OptionSpec.from_dataclasses([GameOptions, MCTSOptions, TrainOptions])
    parser = spec.to_argparse()
    parser.add_argument("--load", type=str, default="",
                        help="checkpoint or export (empty = random weights)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    extra(parser)
    args = parser.parse_args(argv)
    om = OptionMap(spec, vars(args))
    return args, om.get(GameOptions), om.get(MCTSOptions), om.get(TrainOptions)


def load_net(args, g, to, device):
    """(net, feature set) of `--model`, with the weights of `--load` or,
    without it, random weights drawn from seed 0."""
    trainer, _mode, feature_set = make_trainer(
        g.model, g.board_size, to, use_df_feature=g.use_df_feature,
        device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    if args.load:
        state = load_checkpoint(args.load, template=state)
    return state.net, feature_set


def play_mcts_config(mo, g, feature_set) -> MCTSConfig:
    """The play and analysis settings (README.rst:147, :164): play puct, no
    root noise, a random symmetry per leaf."""
    return MCTSConfig(
        feature_set=feature_set,
        num_rollouts=mo.num_rollouts,
        rollouts_per_batch=mo.rollouts_per_batch,
        c_puct=mo.c_puct,
        virtual_loss=mo.virtual_loss,
        root_epsilon=0.0,
        komi=g.komi,
        rotation_flip=True,
    )


def summary(device, searches, time_key: str, cfg: MCTSConfig) -> dict:
    """The exit summary of a play script from its searches' log."""
    m = max(1, cfg.rollouts_per_batch)
    rollouts = max(1, cfg.num_rollouts // m) * m     # run_mcts's batches
    steady = searches[1:] or searches
    busy = sum(s["search_s"] for s in steady)
    return {
        "device": str(device),
        "searches": len(searches),
        "rollouts_per_search": rollouts,
        time_key: [s.get(time_key) for s in searches],
        "search_s": [s["search_s"] for s in searches],
        "rollouts_per_s": rollouts * len(steady) / busy if busy else None,
        "carried_visits": [s["carried_visits"] for s in searches],
        "root_reused": [s["root_reused"] for s in searches],
        "kernel_launches": kernels.launch_counts(),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def main(argv=None):
    args, g, mo, to = play_options(argv, lambda p: p.add_argument(
        "--resign_thres", type=float, default=0.05,
        help="resign when the mover's value < -1 + this (0 never resigns; "
             "README.rst:147 play uses 0.05)"))
    device = resolve_device(args.device)
    net, feature_set = load_net(args, g, to, device)
    mcfg = play_mcts_config(mo, g, feature_set)
    engine = GtpEngine(eval_fn_builder, mcfg, size=g.board_size, komi=g.komi,
                       seed=g.seed, persistent_tree=mo.persistent_tree,
                       following_pass=g.following_pass,
                       resign_thres=args.resign_thres, device=device)
    engine.set_model(net, None)
    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        GtpConsole(engine).run()
    finally:
        out = summary(device, engine.searches, "genmove_s", mcfg)
        out["genmoves"] = sum(1 for s in engine.searches if s.get("moved"))
        out["expected_carry"] = [s["expected_carry"] for s in engine.searches]
        print(json.dumps(out), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
