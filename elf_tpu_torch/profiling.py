"""Tracing, spans, counters and stage timers: counterpart of
`elf_tpu/profiling.py`.

The reference has in-tree stage timers only (`RLTimer`,
trainer/timer.py:12; `elf_utils::MyClock`, utils/utils.h:183).  Here, as
in the JAX package, named host regions feed an `RLTimer`, and with a
`trace_dir` a profiler session records the host and device timeline:
`trace()` is a `torch.profiler` session that writes a Chrome trace
(`trace-<pid>-<n>.json`, viewable in Perfetto or chrome://tracing) into
`trace_dir`, and `phase()` is also a span there.

Spans and counters inside the program:

    with span("elf.mcts.backprop"):      # a range in the profiler's trace
        ...
    count("search.batches")             # an in-memory count
    if not read(done.all()): ...        # a host read of a device value

    @reads_counted_as("search.host_reads")
    def mcts_simulate(...): ...         # reads made in it count there

Both are on exactly while a `torch.profiler` session records: `trace()`
with a `trace_dir`, or any caller's own session (the benchmark's traced
window).  Nothing turns them on otherwise.  Off, `span` returns one shared
no-op context and `count` returns at once, so the hot paths pay one read
of torch's profiler flag a site.  On, a span is a
`torch.profiler.record_function` range, in the same trace and on the same
clock as the card's kernels, so an idle gap on the card can be put down
to the span the host was in.  Every span name starts with `elf.`.
`counters()` returns a copy of the counts and `reset()` clears them.
`read(x)` is `bool(x)` (or `how(x)`), a read for which the host waits for
the card; the function that decides which reads to count says so once,
with `reads_counted_as`, and the module that makes a read need not know.

    prof = Profiler(trace_dir="build/trace")   # or "" for timers only
    with prof.trace():
        with prof.phase("train_episode"):
            runner.episode(n)
    prof.report()                              # per-phase wall time

Every hook is a no-op for the profiler when `trace_dir` is empty, so call
sites stay unconditional; the stage timer runs either way, and on a CUDA
device it waits for the card at each stage boundary, so a stage's time is
the work queued in it and not only its enqueue.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _torch_profiler

from elf_tpu_torch.stats import RLTimer

_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_reads_to: Optional[str] = None     # the counter of `read`, if any


def span(name: str):
    """A named range in the profiler's trace while tracing is on; the
    shared no-op context otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if not _torch_profiler._is_profiler_enabled:
        return
    _counts[name] = _counts.get(name, 0) + n


def read(x: torch.Tensor, how: Callable = bool):
    """`how(x)`, a host read of the device value `x` (the host waits for
    the card), counted while tracing is on under the name of the
    innermost `reads_counted_as` function it is made in."""
    if _reads_to is not None:
        count(_reads_to)
    return how(x)


def reads_counted_as(name: str):
    """Decorator: the host reads that `read` makes in the function and its
    callees count as `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            global _reads_to
            outer, _reads_to = _reads_to, name
            try:
                return fn(*args, **kwargs)
            finally:
                _reads_to = outer
        return counted
    return wrap


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_counts)


def reset() -> None:
    _counts.clear()


def _sync_card() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    def __init__(self, trace_dir: str = ""):
        """trace_dir: where the profiler writes its traces ('' = timers
        only).  A trace holds the card's kernels too where there is one."""
        self.trace_dir = trace_dir
        self.timer = RLTimer()
        self._n_traces = 0

    @contextlib.contextmanager
    def trace(self):
        """One profiler session around a region of work (the program's
        spans and counters are on for its duration)."""
        if not self.trace_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace-{os.getpid()}-{self._n_traces}.json")
        self._n_traces += 1
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(path)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Named region: the span `elf.<name>` in the trace and a stage in
        the host timer, whose boundaries wait for the card."""
        _sync_card()
        self.timer.record(f"before_{name}")
        with span(f"elf.{name}"):
            yield
            _sync_card()
        self.timer.record(name)

    def report(self) -> str:
        return "profile: " + self.timer.print()
