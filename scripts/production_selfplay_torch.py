#!/usr/bin/env python
"""Production self-play moves of the port on one card.

The JAX package's production self-play configuration (`bench.py`'s
production bench): 19x19 boards with the 20-block 256-channel net, B =
1024 lockstep games, c_puct 0.85, virtual loss 5, root noise eps 0.25
alpha 0.03, passes from ply 160, a random symmetry per leaf, 2048-leaf
evaluation chunks, the search run in calls of 10 simulation batches (as
`bench.py`), and `batched_writes="on"`.  The
weights are the committed export (`runs/prove19/export-best.bin`) unless
`--load` names another file.  One warm-up move at 64 rollouts (cuDNN's
plans, the first kernel loads), then one timed move at the production
budget of 1600 rollouts from the empty board; both are replayed on the
host through the plain versions of the liberty kernels (`chip_smoke.py`'s
`replay_is_legal`) and must be legal.  Prints one JSON line: seconds
of the move and of each simulate call, moves/s, rollouts/s, leaf
evaluations/s, peak device memory, the liberty kernels' launches in the
timed move, and the card (nvidia-smi name and power limit).

    python scripts/production_selfplay_torch.py
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOARD, BOARDS, PER_BATCH, BATCHES_PER_CALL = 19, 1024, 8, 10
ROLLOUTS, WARMUP_ROLLOUTS = 1600, 64
# bench.py's production search but for the budget and the calls' size
PRODUCTION_SEARCH = dict(c_puct=0.85, virtual_loss=5, root_epsilon=0.25,
                         root_alpha=0.03, ply_pass_enabled=160,
                         rotation_flip=True, eval_chunk=2048,
                         batched_writes="on")


def production_actor(boards: int, rollouts: int, per_batch: int,
                     max_batches_per_call: int, seed: int = 0):
    """A SelfplayActor with the production search at `rollouts`."""
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    return SelfplayActor(
        ActorConfig(board_size=BOARD, batch=boards, policy_distri_cutoff=30,
                    never_resign_prob=1.0),
        MCTSConfig(num_rollouts=rollouts, rollouts_per_batch=per_batch,
                   max_batches_per_call=max_batches_per_call,
                   **PRODUCTION_SEARCH),
        eval_fn_builder, seed=seed, device="cuda")


def timed_move(actor, net):
    """One lockstep move, timed by the host clock after a device
    synchronise: (seconds, [seconds of each simulate call])."""
    import torch

    t0 = time.perf_counter()
    if actor.play_moves(net, None, 1):
        raise RuntimeError("a game ended at its first moves")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, list(actor.simulate_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--load", type=str,
                    default=os.path.join(REPO, "runs/prove19/export-best.bin"))
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import replay_is_legal
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, load_model

    if not torch.cuda.is_available():
        print("production_selfplay_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    net = load_model(args.load, ModelConfig(board_size=BOARD), "cuda")
    warm = production_actor(BOARDS, WARMUP_ROLLOUTS, PER_BATCH,
                            BATCHES_PER_CALL)
    warm_s, _ = timed_move(warm, net)
    replay_is_legal(warm.moves, BOARD)      # exits on an illegal move
    del warm
    actor = production_actor(BOARDS, ROLLOUTS, PER_BATCH,
                             BATCHES_PER_CALL, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    move_s, simulate_s = timed_move(actor, net)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    replay_is_legal(actor.moves, BOARD)
    print(json.dumps(dict(
        card=card, boards=BOARDS, rollouts=ROLLOUTS,
        rollouts_per_batch=PER_BATCH, max_batches_per_call=BATCHES_PER_CALL,
        warmup_move_s=warm_s, move_s=move_s, simulate_s=simulate_s,
        moves_per_s=BOARDS / move_s,
        rollouts_per_s=BOARDS * ROLLOUTS / move_s,
        leaf_evals_per_s=BOARDS * (ROLLOUTS + 1) / move_s,
        peak_memory_bytes=peak, launches=launches,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
