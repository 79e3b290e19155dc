#!/usr/bin/env python
"""The production proof's anchor match, played by either package on the
same checkpoints: `final_anchor_match` of `scripts/prove_production.py`
(`--package jax`) or of `scripts/prove_production_torch.py` (`--package
torch`), a checkpoint against the run's `init.bin`, with the wins split
by colour.

The anchor opens deterministically (`policy_distri_cutoff` 0, no root
noise); `--cutoff K` plays the first K moves from the visit distribution
instead, as the eval gate's games do (the clients' eval actor keeps the
client's cutoff, max(4, n2 * 30 // 361): 6 at 9x9, 14 at 13x13).  Both
packages read the checkpoints the port writes.

  python tools/prod_anchor_parity.py --package torch --out RUN --ver 300 \\
      --games 64 --cutoff 0 --device cpu

RUN holds `init.bin` and `ckpt/save-<ver>.bin` (or `promoted-<ver>.bin`).
Every other option is the proof's own and passes through to its
`parse_args` (`--board_size`, `--komi`, `--num_block`, `--dim`,
`--eval_num_games`, `--final_rollouts`, ...); left out, it is the proof's
default (the 9x9 4b64c protocol).  The README's 13x13 anchor on the card:

  python tools/prod_anchor_parity.py --package torch --out runs/prod13 \\
      --ver 160 --games 100 --board_size 13 --num_block 10 --dim 128 \\
      --eval_num_games 400 --value_weight 0.25 --train_bs 256

Prints one JSON line: wins, games, wins as black and as white, the wins
among the first K games each half finished, K = half the eval's games
(the gate takes the first results of each half: 25 of a 50-game eval;
results arrive in the order the lockstep boards finish, board order
within a call), the sorted game lengths, the lockstep moves played and
the wall time.  The JAX package plays on the CPU; the port on
`--device` (default cuda).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ver", type=int, required=True)
    ap.add_argument("--games", type=int, default=200)
    ap.add_argument("--cutoff", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the port's device (--package torch): cuda or cpu")
    return ap.parse_known_args(argv)


def anchor(args, proof_argv=()):
    """Play the anchor; return (the JSON line's dict, [(record, won)])."""
    argv = ["--out", args.out, "--final_games", str(args.games),
            *proof_argv]
    if args.package == "jax":
        from elf_tpu.selfplay import actor as actor_mod
        from elf_tpu.tools import match
        from scripts import prove_production as proof

        argv += ["--platform", "cpu"]
    else:
        from elf_tpu_torch.selfplay import actor as actor_mod
        from elf_tpu_torch.tools import match
        from scripts import prove_production_torch as proof

        argv += ["--device", args.device]

    sink, moves = [], []
    head_to_head = match.head_to_head
    actor_config = actor_mod.ActorConfig

    def counted_h2h(actor, *a, **k):
        play = actor.play_moves

        def play_moves(params, bstats, n):
            moves.append(n)
            return play(params, bstats, n)

        actor.play_moves = play_moves
        return head_to_head(actor, *a, record_sink=sink, **k)

    match.head_to_head = counted_h2h
    actor_mod.ActorConfig = lambda **k: dataclasses.replace(
        actor_config(**k), policy_distri_cutoff=args.cutoff)
    try:
        t0 = time.time()
        proof_args = proof.parse_args(argv)
        wins, total = proof.final_anchor_match(proof_args, args.ver)
        wall = time.time() - t0
    finally:
        match.head_to_head = head_to_head
        actor_mod.ActorConfig = actor_config
    half = len(sink) // 2
    first = proof_args.eval_num_games // 2
    return {
        "package": args.package, "ver": args.ver, "cutoff": args.cutoff,
        "board_size": proof_args.board_size,
        "rollouts": proof_args.final_rollouts,
        "wins": wins, "n": total,
        "as_black": sum(int(w) for _, w in sink[:half]),
        "as_white": sum(int(w) for _, w in sink[half:]),
        "first_k": first,
        "first_k_wins": sum(int(w) for _, w in sink[:half][:first])
        + sum(int(w) for _, w in sink[half:][:first]),
        "moves": sorted(int(r.result.num_move) for r, _ in sink),
        "lockstep_moves": sum(moves),
        "wall_s": round(wall, 1),
    }, sink


def main(argv=None):
    args, proof_argv = parse_args(argv)
    line, _ = anchor(args, proof_argv)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
