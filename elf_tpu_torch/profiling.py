"""Tracing and stage timers: counterpart of `elf_tpu/profiling.py`.

The reference has in-tree stage timers only (`RLTimer`,
trainer/timer.py:12; `elf_utils::MyClock`, utils/utils.h:183).  Here, as
in the JAX package, named host regions feed an `RLTimer`, and with a
`trace_dir` a profiler session records the host and device timeline:
`trace()` is a `torch.profiler` session that writes a Chrome trace
(`trace-<pid>-<n>.json`, viewable in Perfetto or chrome://tracing) into
`trace_dir`, and `phase()` is also a `torch.profiler.record_function`
region there.

    prof = Profiler(trace_dir="build/trace")   # or "" for timers only
    with prof.trace():
        with prof.phase("train_episode"):
            runner.episode(n)
    prof.report()                              # per-phase wall time

Every hook is a no-op for the profiler when `trace_dir` is empty, so call
sites stay unconditional; the stage timer runs either way.
"""

from __future__ import annotations

import contextlib
import os

import torch

from elf_tpu_torch.stats import RLTimer


class Profiler:
    def __init__(self, trace_dir: str = ""):
        """trace_dir: where the profiler writes its traces ('' = timers
        only).  A trace holds the card's kernels too where there is one."""
        self.trace_dir = trace_dir
        self.timer = RLTimer()
        self._n_traces = 0

    @contextlib.contextmanager
    def trace(self):
        """One profiler session around a region of work."""
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
        """Named region: a `record_function` span in the trace and a stage
        in the host timer."""
        self.timer.record(f"before_{name}")
        if self.trace_dir:
            cm = torch.profiler.record_function(name)
        else:
            cm = contextlib.nullcontext()
        with cm:
            yield
        self.timer.record(name)

    def report(self) -> str:
        return "profile: " + self.timer.print()
