#!/usr/bin/env python
"""The production proof's anchor match, played by either package on the
same checkpoints: `final_anchor_match` of `scripts/prove_production.py`
(`--package jax`) or of `scripts/prove_production_torch.py` (`--package
torch`), a checkpoint against the run's `init.bin`, with the wins split
by colour.

The anchor opens deterministically (`policy_distri_cutoff` 0, no root
noise); `--cutoff K` plays the first K moves from the visit distribution
instead, as the eval gate's games do (the clients' eval actor keeps the
client's cutoff, max(4, n2 * 30 // 361): 6 at 9x9).  Both packages read
the checkpoints the port writes.

  python tools/prod_anchor_parity.py --package torch --out RUN --ver 300 \\
      --games 64 --cutoff 0

RUN holds `init.bin` and `ckpt/save-<ver>.bin` (or `promoted-<ver>.bin`).
Prints one JSON line: wins, games, wins as black and as white, the wins
among the first K games each half finished, K = half the eval's games
(the gate takes the first 25 results of each half of a 50-game eval;
results arrive in the order the lockstep boards finish, board order
within a call), the sorted game lengths and the wall time.  The
protocol's other options are the scripts' defaults (the 9x9 4b64c
proof).  Both packages play on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ver", type=int, required=True)
    ap.add_argument("--games", type=int, default=200)
    ap.add_argument("--cutoff", type=int, default=0)
    args = ap.parse_args(argv)

    argv = ["--out", args.out, "--final_games", str(args.games)]
    if args.package == "jax":
        from elf_tpu.selfplay import actor as actor_mod
        from elf_tpu.tools import match
        from scripts import prove_production as proof

        argv += ["--platform", "cpu"]
    else:
        from elf_tpu_torch.selfplay import actor as actor_mod
        from elf_tpu_torch.tools import match
        from scripts import prove_production_torch as proof

        argv += ["--device", "cpu"]

    sink = []
    head_to_head = match.head_to_head
    match.head_to_head = lambda *a, **k: head_to_head(*a, record_sink=sink,
                                                      **k)
    actor_config = actor_mod.ActorConfig
    actor_mod.ActorConfig = lambda **k: dataclasses.replace(
        actor_config(**k), policy_distri_cutoff=args.cutoff)
    t0 = time.time()
    proof_args = proof.parse_args(argv)
    wins, total = proof.final_anchor_match(proof_args, args.ver)
    half = len(sink) // 2
    first = proof_args.eval_num_games // 2
    print(json.dumps({
        "package": args.package, "ver": args.ver, "cutoff": args.cutoff,
        "wins": wins, "n": total,
        "as_black": sum(int(w) for _, w in sink[:half]),
        "as_white": sum(int(w) for _, w in sink[half:]),
        "first_k": first,
        "first_k_wins": sum(int(w) for _, w in sink[:half][:first])
        + sum(int(w) for _, w in sink[half:][:first]),
        "moves": sorted(int(r.result.num_move) for r, _ in sink),
        "wall_s": round(time.time() - t0, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
