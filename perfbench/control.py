"""The readings that set a cell's limits: the program's on many seeds, and
the control's on the same runs.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--out FILE]

Runs the cell once per seed in one process (each run builds its system
anew, measures for --seconds, and is checked as a benchmark run is), with
the control switched on: besides the program's numbers the check reads
the control's, the plain reference put in the program's place in the
precision below the one the configuration states (float8 convolutions
for the nets' bfloat16), or, for the engine, with a rule it states broken
(no ko); the learner's check also reads the fault of a step that takes
half of its batch.  Prints one JSON line per seed: {seed, numbers,
limits}.  The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402


def readings(workload: str, seeds, seconds: float, device=None,
             **overrides) -> list:
    """[{seed, numbers, limits}] of one run per seed, control on."""
    import torch

    spec = core.load_spec()
    device = device or core.check_card(core.find_cell(spec, workload)["chips"])
    out = []
    for seed in seeds:
        ctx = core.make_context(workload, seed, seconds, False,
                                time.perf_counter(), device=device,
                                spec=spec, control=True, **overrides)
        gen = core.generator(ctx)
        m = gen.run(ctx)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = gen.check(ctx, m)
        numbers.pop("_failed", None)
        out.append({"seed": seed, "numbers": numbers, "limits": ctx.limits})
        del m, ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds)
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
