#!/usr/bin/env python
"""Head-to-head checkpoint match of the PyTorch/CUDA port: twin of
`scripts/eval_match.py` on `elf_tpu_torch`.

Plays two models against each other with colour-swapped halves and
reports the win rate and Elo difference: the standalone counterpart of the
server-driven eval subsystem (`ctrl_eval.h`), with its fair-pick
structure (half the games swapped).  Same options as the JAX script
(`GameOptions`, `MCTSOptions`, `TrainOptions`, `--a`, `--b`,
`--num_eval_games`) and the same eval settings (argmax moves, no resign,
no root noise), plus `--device` (default `cuda`).  `--a` and `--b` take a
whole `save-<step>.bin` or a params-only export.

Prints one line per game on stderr, the result line on stdout, and at exit
one JSON line on stderr: the device and the liberty kernels' launch
counts.

Example:
  python scripts/eval_match_torch.py --a ckpts/save-2000.bin \\
      --b ckpts/save-1000.bin --num_eval_games 64 --num_rollouts 200
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
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import (
    ActorConfig,
    SelfplayActor,
    make_pair_eval_builder,
)
from elf_tpu_torch.stats import WinRate
from elf_tpu_torch.tools.match import elo_diff, head_to_head
from elf_tpu_torch.training.trainer import Trainer, load_checkpoint


def main(argv=None):
    spec = OptionSpec.from_dataclasses([GameOptions, MCTSOptions, TrainOptions])
    parser = spec.to_argparse()
    parser.add_argument("--a", type=str, required=True, help="candidate ckpt")
    parser.add_argument("--b", type=str, required=True, help="baseline ckpt")
    parser.add_argument("--num_eval_games", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    om = OptionMap(spec, vars(args))
    g = om.get(GameOptions)
    mo = om.get(MCTSOptions)
    to = om.get(TrainOptions)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        board_size=g.board_size, num_planes=18,
        num_block=to.num_block, dim=to.dim, use_bf16=to.bf16,
    )
    trainer = Trainer(cfg, to, device=device)
    template = trainer.init_state(torch.Generator().manual_seed(0))
    sa = load_checkpoint(args.a, template=template)
    sb = load_checkpoint(args.b, template=template)
    eval_raw = trainer.make_eval_fn()

    acfg = ActorConfig(
        board_size=g.board_size, batch=min(args.num_eval_games // 2, 32) or 1,
        komi=g.komi, policy_distri_cutoff=0,  # always argmax (eval strength)
        resign_thres=0.0, never_resign_prob=1.0,
    )
    # eval MCTS strips root noise (ctrl_eval.h:233)
    mcfg = MCTSConfig(
        num_rollouts=mo.num_rollouts, rollouts_per_batch=mo.rollouts_per_batch,
        c_puct=mo.c_puct, virtual_loss=mo.virtual_loss, root_epsilon=0.0,
        komi=g.komi,
    )
    actor = SelfplayActor(acfg, mcfg, make_pair_eval_builder(eval_raw),
                          seed=g.seed, device=device)

    # head_to_head resets the actor at the half boundary, so the swap half
    # never inherits (and mis-scores) games started under the noswap colours
    kernels.reset_launch_counts()
    wr = WinRate()
    sink: list = []
    wins_a, total = head_to_head(
        actor, (sa.net, None), (sb.net, None), args.num_eval_games // 2,
        record_sink=sink,
    )
    for i, (r, a_won) in enumerate(sink):
        wr.feed(r.result.reward)
        print(
            f"game {i + 1}: {'A' if a_won else 'B'} wins "
            f"({r.result.num_move} moves)",
            file=sys.stderr,
        )

    winrate = wins_a / max(total, 1)
    print(
        f"A={os.path.basename(args.a)} vs B={os.path.basename(args.b)}: "
        f"{wins_a}/{total} = {winrate:.3f}  elo_diff={elo_diff(winrate):+.1f}  "
        f"({wr.summary()})", flush=True,
    )
    print(json.dumps({"device": str(device),
                      "kernel_launches": kernels.launch_counts()}),
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
