"""CPU tests of the readers of the net's epilogue counters
(`net.epilogues_per_forward.selfplay` and `.selfplay_host`): the program's
`net.epilogues` over `net.forwards` in a traced window, nothing without a
trace or without the counters.

    python -m pytest perfbench/test_perfbench_epilogues.py -q -n 0
"""

import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core, spans  # noqa: E402

NAMES = ("net.epilogues_per_forward.selfplay",
         "net.epilogues_per_forward.selfplay_host")


def read(name, trace, counters, monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: counters)
    return core.metric_reader(name)(types.SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name", NAMES)
def test_epilogues_per_forward(name, monkeypatch):
    c = {"net.epilogues": 41 * 130, "net.forwards": 130,
         "search.batches": 32}
    assert read(name, object(), c, monkeypatch) == 41.0
    c = {"net.epilogues": 21 * 50 + 7, "net.forwards": 50}
    assert read(name, object(), c, monkeypatch) == pytest.approx(21.14)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name, monkeypatch):
    c = {"net.epilogues": 41, "net.forwards": 1}
    assert read(name, None, c, monkeypatch) is None       # untraced
    assert read(name, object(), {}, monkeypatch) is None  # the parent
    assert read(name, object(), {"net.forwards": 3}, monkeypatch) is None
    assert read(name, object(), {"net.epilogues": 3}, monkeypatch) is None


def test_both_are_declared_in_their_cells():
    spec = {m["name"]: m for m in core.load_spec()["per_layer"]}
    assert spec[NAMES[0]]["workloads"] == ["go19_20b256c.selfplay_b1024_r64"]
    assert spec[NAMES[1]]["workloads"] == ["go13_10b128c.selfplay_b192_r96"]
    for n in NAMES:
        assert spec[n]["layer"] == "net kernels"
        assert spec[n]["source"] == "program_counter"
