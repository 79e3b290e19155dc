#!/usr/bin/env python
"""Analysis mode of the PyTorch/CUDA port: analyse an SGF game with a
checkpoint.

Twin of `scripts/analysis.py` on `elf_tpu_torch` (the reference's
`analysis.sh`, README.rst:153-166): preload an SGF, replay it to a move,
then print the engine's suggested move, value and prior at every position
and dump the search tree of each move under `--dump_record_prefix`.  Same
options as the JAX script, plus `--device` (default `cuda`; the CPU runs
only when asked for with `--device cpu`).

At exit it writes one JSON line to stderr: positions analysed, seconds per
position (each one, the first being the warm-up), rollouts/s over the
searches after the first, the carried-over root visits, the liberty
kernels' launch counts, peak device memory.

Examples:
  # the reference's behaviour: self-play from the preloaded position
  python scripts/analysis_torch.py --load runs/prove19/export-best.bin \\
      --preload_sgf game.sgf --preload_sgf_move_to 40 \\
      --dump_record_prefix tree --num_rollouts 1600

  # review an existing game move by move
  python scripts/analysis_torch.py --load runs/prove19/export-best.bin \\
      --preload_sgf game.sgf --follow_sgf --verbose
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.console.analysis import AnalysisConfig, AnalysisDriver
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.models.resnet import eval_fn_builder

from gtp_console_torch import load_net, play_mcts_config, play_options, summary


def add_options(parser):
    parser.add_argument("--follow_sgf", action="store_true",
                        help="follow the record's moves instead of self-play")
    parser.add_argument("--max_moves", type=int, default=0,
                        help="analyse at most this many moves (0 = all)")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--verbose", action="store_true",
                        help="print the top-k alternatives of every move")


def main(argv=None):
    args, g, mo, to = play_options(argv, add_options)
    device = resolve_device(args.device)
    net, feature_set = load_net(args, g, to, device)
    mcfg = play_mcts_config(mo, g, feature_set)
    acfg = AnalysisConfig(
        preload_sgf=g.preload_sgf,
        preload_sgf_move_to=g.preload_sgf_move_to,
        dump_record_prefix=g.dump_record_prefix,
        follow_sgf=args.follow_sgf,
        max_moves=args.max_moves,
        komi=g.komi,
        top_k=args.top_k,
        verbose=args.verbose,
    )
    driver = AnalysisDriver(eval_fn_builder, mcfg, acfg, size=g.board_size,
                            seed=g.seed, device=device)
    driver.set_model(net, None)
    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        driver.run()
    finally:
        out = summary(device, driver.searches, "position_s", mcfg)
        out["preloaded_moves"] = driver.start_ply
        print(json.dumps(out), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
