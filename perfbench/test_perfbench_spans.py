"""CPU tests of the readers of the program's own spans and counters, on a
hand-built Chrome trace whose program spans (`elf.*`) nest as the
program's do: the search's phases inside `actor`, `net` inside
`elf.mcts.evaluate`, the pipeline's spans inside `sample_host_batch` and
`device_batch`.  The program opens no span inside `step_core` or `net`,
whose launches the accepted metrics count by the innermost range.

    python -m pytest perfbench/test_perfbench_spans.py -q -n 0
"""

import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core, spans, yardstick  # noqa: E402
from harness.trace import WINDOW, TraceSummary  # noqa: E402

NEW = {"search.select_expand_share.selfplay",
       "search.select_expand_share.selfplay_host",
       "search.backprop_share.selfplay", "search.backprop_share.selfplay_host",
       "search.host_reads_per_batch.selfplay",
       "search.host_reads_per_batch.selfplay_host",
       "device_idle.search_loop.selfplay",
       "device_idle.search_loop.selfplay_host",
       "pipeline.features_ms_per_step.train", "device_idle.pipeline.train"}

HARNESS = [(WINDOW, 0, 1000), ("actor", 100, 500), ("net", 260, 300),
           ("step_core", 600, 700), ("sample_host_batch", 750, 800),
           ("device_batch", 820, 900)]
PROGRAM = [("elf.mcts.select_expand", 110, 200),
           ("elf.mcts.evaluate", 210, 318), ("elf.mcts.backprop", 330, 400),
           ("elf.pipeline.sample", 755, 795),
           ("elf.pipeline.features", 830, 890)]
# (name, start, end, launched at); us
OPS = [("step_analysis_kernel<19>", 140, 160, 130), ("conv", 265, 290, 262),
       ("add", 350, 360, 340), ("step_analysis_kernel<19>", 615, 625, 612),
       ("where", 650, 660, 645), ("copy", 840, 860, 835)]


def chrome(with_program: bool) -> dict:
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
           "dur": e - s}
          for n, s, e in HARNESS + (PROGRAM if with_program else [])]
    for k, (n, s, e, at) in enumerate(OPS):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": at, "dur": 2,
                   "args": {"correlation": k}})
        ev.append({"ph": "X", "cat": "kernel", "name": n, "ts": s,
                   "dur": e - s, "args": {"correlation": k}})
    return {"traceEvents": ev}


def reader_ctx(trace):
    cfg = core.load_json(core.BENCH / "configs" / "go19_20b256c.json")
    return types.SimpleNamespace(
        config=cfg, setup_s=1.0, window_s=trace.window_s,
        work={"positions": 4096, "rollouts": 1000, "steps": 100},
        counters={"eval_rows": 2048, "simulate_s": 5e-4, "steps": 2,
                  "pipeline_s": 1e-4, "boards": 4096},
        trace=trace, yardstick=yardstick)


def read_all(names, trace):
    ctx = reader_ctx(trace)
    return {n: core.metric_reader(n)(ctx) for n in names}


def test_program_spans_leave_the_accepted_metrics_alone():
    accepted = [m["name"] for m in core.load_spec()["per_layer"]
                if m["name"] not in NEW]
    plain = read_all(accepted, TraceSummary(chrome(False)))
    traced = read_all(accepted, TraceSummary(chrome(True)))
    assert all(v is not None for v in plain.values())
    assert traced == plain


def test_new_readers_by_hand(monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: {
        "search.host_reads": 300, "search.batches": 4})
    got = read_all(sorted(NEW), TraceSummary(chrome(True)))
    want = {
        "search.select_expand_share.selfplay": 9.0,       # 90 of 1000 us
        "search.backprop_share.selfplay": 7.0,
        "search.host_reads_per_batch.selfplay": 75.0,
        # idle: 90 - 20 in select_expand, 70 - 10 in backprop
        "device_idle.search_loop.selfplay": 13.0,
        "pipeline.features_ms_per_step.train": 0.03,      # 60 us, 2 steps
        # idle: 40 in sample, 60 - 20 in features
        "device_idle.pipeline.train": 8.0,
    }
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-12), name
        if name.endswith(".selfplay"):
            assert got[name + "_host"] == got[name]


def test_new_readers_find_nothing_without_program_spans(monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: {})
    got = read_all(sorted(NEW), TraceSummary(chrome(False)))
    assert got == {n: None for n in NEW}


def test_idle_gaps_take_the_innermost_program_span():
    gaps = dict(TraceSummary(chrome(True)).breakdown()["idle_gaps"])
    want = {"harness": 280e-6, "actor": 315e-6, "elf.mcts.evaluate": 105e-6,
            "step_core": 25e-6, "sample_host_batch": 180e-6}
    assert gaps == pytest.approx(want, rel=1e-9)
    plain = dict(TraceSummary(chrome(False)).breakdown()["idle_gaps"])
    assert plain == pytest.approx({"harness": 280e-6, "actor": 420e-6,
                                   "step_core": 25e-6,
                                   "sample_host_batch": 180e-6}, rel=1e-9)
