"""One run of one cell: find its pieces by name, check the card, drive the
cell's traffic through the program, check what the timed path produced
against the plain reference, and print the result line.

The pieces, all found by the names in `BENCHMARK.json`:
  configs/<config>.json     the configuration (sizes, precisions, and the
                            module of its plain reference under reference/)
  traffic/<traffic>.json    the traffic mix; its "kind" names the general
                            generator in harness/<kind>.py
  limits/<cell>.json        the limit of each number `correct` compares
  metrics/<metric>.py       one reader per metric: read(ctx) -> value or None

A generator's `run(ctx)` builds the system under test, warms up the
cell's own shapes, measures for ctx.seconds (the window ends with the last
whole unit of work that began inside it) and returns a Measured; its
`check(ctx, measured)` runs once the window has closed and the program's
state is freed, and returns {number: value} for the comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = BENCH.parent                                      # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "elf_tpu")


class NoCard(RuntimeError):
    pass


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_file(spec: dict, name: str) -> Path:
    for c in spec["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metric_reader(name: str) -> Callable:
    path = BENCH / "metrics" / f"{name}.py"
    modname = "perfbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports: with trace off its end-to-end ones,
    with trace on the per-layer ones that list it (or, without a list,
    those that move an end-to-end metric it reports)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def sub_seed(seed: int, k: int) -> int:
    """A 32-bit seed for stream k of the run, drawn from --seed (which may
    exceed 32 bits)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    spans: Any = None
    reference: Any = None     # the configuration's plain reference module
    # control.py only: the check also reads the control (and the learner's
    # half-batch fault)
    control: bool = False


@dataclasses.dataclass
class Measured:
    """What a generator hands back after its window."""

    setup_s: float
    window_s: float
    units: int                     # whole units of work in the window
    work: Dict[str, float]         # counted work, by kind
    counters: Dict[str, Any]       # the program's and the harness's counts
    attempted: int                 # answers the check looks at
    payload: Dict[str, Any]        # what the check reads (host or device)
    trace: Any = None              # TraceSummary of a traced run
    unit_ends: list = dataclasses.field(default_factory=list)  # s into it


def check_card(chips: int) -> Any:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {chips}")
    return torch.device("cuda", 0)


def set_cache_dirs() -> None:
    """Every build or kernel cache of the program inside the checkout, at
    fixed paths (the program's own kernels build into build/kernels)."""
    cache = ROOT / "build" / "perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_context(name: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device=None, spec=None,
                 config=None, traffic=None, limits=None, control=False):
    from harness.trace import Spans

    spec = spec or load_spec()
    cell = find_cell(spec, name) if config is None else {
        "name": name, "chips": 1}
    if config is None:
        config = load_json(config_file(spec, cell["config"]))
        traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
        limits = load_json(BENCH / "limits" / f"{name}.json")
    ref = importlib.import_module(f"reference.{config['reference']}")
    return Context(cell=cell, config=config, traffic=traffic, limits=limits,
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   t_start=t_start, spans=Spans(trace), reference=ref,
                   control=control)


def generator(ctx: Context):
    return importlib.import_module(f"harness.{ctx.traffic['kind']}")


def memory_peak(device) -> int:
    import torch

    if device is not None and device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit)]): each number at or under its
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name in sorted(limits):
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limits[name]
        ok &= bool(good)
        rows.append((name, v, limits[name]))
    return ok, rows


def run_cell(ctx: Context, spec: dict, out=sys.stdout, err=sys.stderr,
             metrics_spec=None) -> dict:
    """Measure, check and report one run; returns the result line's dict."""
    import torch

    gen = generator(ctx)
    measured = gen.run(ctx)
    peak = memory_peak(ctx.device)
    gc.collect()
    if ctx.device is not None and ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = gen.check(ctx, measured)
    counted = int(numbers.pop("_failed", 0))
    correct, rows = judge(numbers, ctx.limits)
    failed = max(counted, 0 if correct else 1)
    metric_list = metrics_spec if metrics_spec is not None else cell_metrics(
        spec, ctx.cell["name"], ctx.trace)
    rctx = ReaderContext(ctx, measured)
    metrics = {}
    for m in metric_list:
        v = metric_reader(m["name"])(rctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device is not None and ctx.device.type == "cuda"
            else str(ctx.device))
    device = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
              "count": ctx.cell.get("chips", 1), "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": int(measured.attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if measured.trace is not None:
        device["busy_s"] = measured.trace.busy_s
        device["window_s"] = measured.trace.window_s
        line["breakdown"] = measured.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in this process: {bad}")
    units = np.diff([0.0] + measured.unit_ends)
    if len(units):
        print(f"unit seconds: {len(units)} units, first {units[0]:.4f}, "
              f"min {units.min():.4f}, median {np.median(units):.4f}, max "
              f"{units.max():.4f}, last {units[-1]:.4f}", file=err)
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=err)
    print(json.dumps(line), file=out, flush=True)
    return line


class ReaderContext:
    """What a metric reader sees."""

    def __init__(self, ctx: Context, m: Measured):
        from harness import yardstick

        self.config = ctx.config
        self.setup_s = m.setup_s
        self.window_s = m.window_s
        self.work = m.work
        self.counters = m.counters
        self.trace = m.trace
        self.yardstick = yardstick


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    spec = load_spec()
    cell = find_cell(spec, args.workload)
    try:
        device = check_card(cell["chips"])
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    ctx = make_context(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start, device=device, spec=spec)
    run_cell(ctx, spec)
    return 0
