#!/usr/bin/env python
"""Scored ladder-suite run of the PyTorch/CUDA port: twin of
`scripts/ladder_bench.py` on `elf_tpu_torch`.

The reference's 116-scenario behavioural suite (`ladder_suite/`,
README.rst:173) as a benchmark: for each (sgf, move#) probe the position is
replayed and the engine must produce the game's ladder-critical move.
Score = matched / total.  The suite is `elf_tpu_torch.tools.ladder`'s
`DEFAULT_SUITE`, read when the run starts.

With `--load` this scores a checkpoint or export (`load_checkpoint`), with
`--torch_import` a reference torch checkpoint such as the public
pretrained-go-19x19-v2.bin (`tools/import_torch.py`); without either, the
raw-policy or MCTS play of a net with random weights drawn from seed 0 (a
floor, printed to check the harness).  Same options and output as the JAX
script (one JSON line on stdout, the first misses on stderr), plus
`--device` (default `cuda`) and `--use_bf16`.

Example:
  python scripts/ladder_bench_torch.py --load ckpts/save-100.bin \\
      --num_block 20 --dim 256 --num_rollouts 400
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.device import resolve_device
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.features import extract_agz
from elf_tpu_torch.models.resnet import (
    ModelConfig,
    eval_fn_builder,
    params_from_jax,
)
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts
from elf_tpu_torch.tools import ladder
from elf_tpu_torch.training.trainer import Trainer, load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--load", type=str, default="",
                    help="checkpoint (empty = random weights)")
    ap.add_argument("--torch_import", type=str, default="",
                    help="import a reference torch checkpoint instead")
    ap.add_argument("--num_block", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--num_rollouts", type=int, default=0,
                    help="0 = raw policy argmax (no search)")
    ap.add_argument("--rollouts_per_batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--use_bf16", type=int, default=1,
                    help="1 = bf16 convolutions (default); 0 = fp32")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    size = 19
    cfg = ModelConfig(board_size=size, num_planes=18, num_block=args.num_block,
                      dim=args.dim, use_bf16=bool(args.use_bf16))
    trainer = Trainer(cfg, TrainOptions(num_block=args.num_block,
                                        dim=args.dim), device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    net = state.net
    if args.torch_import:
        from elf_tpu_torch.tools.import_torch import load_torch_checkpoint

        params, stats, _ = load_torch_checkpoint(args.torch_import, cfg)
        net = params_from_jax(params, stats, cfg, device)
    elif args.load:
        net = load_checkpoint(args.load, template=state).net
    eval_fn = eval_fn_builder(net)

    if args.num_rollouts > 0:
        mcfg = MCTSConfig(num_rollouts=args.num_rollouts,
                          rollouts_per_batch=args.rollouts_per_batch,
                          c_puct=1.5, rotation_flip=False)

        def gen_move(st, sz):
            # one fixed draw per search, as the JAX script's PRNGKey(0)
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.inference_mode():
                res, _ = run_mcts(st.core, st.stone_hist, st.hist_len,
                                  eval_fn, gen, mcfg, sz, device=device)
            return int(res.best_action[0])
    else:
        def gen_move(st, sz):
            feats = extract_agz(
                st, torch.zeros((1,), dtype=torch.int32, device=device), sz)
            with torch.inference_mode():
                log_pi, _ = eval_fn(feats, st.core.to_play)
            lm = gostate.legal_moves(st, sz)
            return int(torch.argmax(torch.where(lm, log_pi, -1e9), dim=1)[0])

    t0 = time.time()
    res = ladder.run_ladder_suite(gen_move, limit=args.limit or None,
                                  device=device)
    print(json.dumps({
        "metric": "ladder_suite_accuracy",
        "matched": res.matched,
        "total": res.total,
        "accuracy": round(res.accuracy, 4),
        "mode": ("mcts%d" % args.num_rollouts) if args.num_rollouts
                else "raw_policy",
        "weights": ("import" if args.torch_import else
                    ("ckpt" if args.load else "random")),
        "wall_s": round(time.time() - t0, 1),
    }), flush=True)
    for f in res.failures[:10]:
        print("# miss:", f, file=sys.stderr)


if __name__ == "__main__":
    main()
