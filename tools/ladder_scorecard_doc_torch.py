#!/usr/bin/env python
"""Assemble a ladder-suite scorecard with the PyTorch/CUDA port: twin of
`tools/ladder_scorecard_doc.py` on `elf_tpu_torch`.

One row per scorer over the reference's ladder suite (`ladder_suite/`,
README.rst:173; `elf_tpu_torch.tools.ladder.DEFAULT_SUITE`):

  - `solver`: the model-free host ladder reader (`native/ladder.py`, the
    checkLadder counterpart) classifies each probe move.  Most probe moves
    are mid-chase continuations rather than checkLadder-style capture
    starters, so this row reports how many probes the reader sees as
    ladder-capture starters: a floor and a semantic note, not a
    playing-strength number.
  - `init` / `trained` rows: copied from a prove_learning run's
    `ladder_scorecard.jsonl` (--ladder_every cadence), the raw-policy
    argmax match rate of the model against the probe move
    (`elf_tpu_torch.tools.ladder.ladder_policy_scorecard`).

Same options and rows as the JAX tool.  `--out` (relative to the
repository root) defaults under `build/`, so a run never overwrites the
committed `docs/ladder_scorecard.jsonl` that the JAX tool writes.

Usage:
  python tools/ladder_scorecard_doc_torch.py --run runs/prove19
"""

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", type=str, default="runs/prove19")
    ap.add_argument("--out", type=str,
                    default="build/ladder_scorecard_torch.jsonl")
    args = ap.parse_args(argv)

    from elf_tpu_torch.tools.ladder import classify_suite

    res = classify_suite()
    c = collections.Counter(r.classification for r in res)
    depths = [r.depth for r in res if r.classification != "none"]
    rows = [{
        "weights": "solver",
        "total": len(res),
        "capture_starters": len(res) - c.get("none", 0),
        "mean_capture_depth": round(sum(depths) / max(len(depths), 1), 1),
        "note": ("native/ladder.c classification of each probe move; "
                 "most probes are mid-chase moves outside checkLadder's "
                 "capture-starter definition"),
    }]
    run_card = os.path.join(args.run, "ladder_scorecard.jsonl")
    if os.path.exists(run_card):
        with open(run_card) as f:
            rows += [json.loads(l) for l in f if l.strip()]
    out = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
