"""The traced run: torch.profiler over the measured window, and the trace
reduced in memory to what the per-layer metrics read.

The harness marks its calls into the program with `span(name)` ranges
(torch.profiler.record_function; a no-op in an untraced run) and the
whole window with `WINDOW`.  After the window the profiler's trace is
written to a temporary file under TMPDIR, read back and deleted, and
reduced to a `TraceSummary`: every device operation (kernel, memcpy,
memset) with its interval and the innermost harness range its launch was
made from, the window's interval, and the host ranges themselves.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

from harness import yardstick

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Harness ranges around the calls into the program, recorded only in
    a traced run."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if self.on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


class Tracer:
    """torch.profiler over CPU and CUDA, started and stopped by hand."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()

    def stop(self) -> "TraceSummary":
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        return TraceSummary(data)


class TraceSummary:
    def __init__(self, data: dict):
        events = data["traceEvents"] if isinstance(data, dict) else data
        launch_ts = {}
        ranges = []
        dev = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = float(e["ts"])
            elif cat == "user_annotation":
                ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                               e["name"]))
        win = [r for r in ranges if r[2] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.w0, self.w1 = win[0][0], win[0][1]
        # harness ranges inside the window, innermost found by start order
        self.ranges = sorted(r for r in ranges if r[2] != WINDOW)
        self._starts = [r[0] for r in self.ranges]
        self.ops = []      # (start_us, end_us, name, range or None)
        for e in dev:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if t < self.w0 or s > self.w1:
                continue
            corr = (e.get("args") or {}).get("correlation")
            at = launch_ts.get(corr)
            self.ops.append((max(s, self.w0), min(t, self.w1), e["name"],
                             self.range_at(at) if at is not None else None))

    def range_at(self, ts: float):
        """The innermost harness range open on the host at `ts`, or None."""
        i = bisect.bisect_right(self._starts, ts)
        best = None
        for j in range(i - 1, max(-1, i - 64), -1):
            s, e, name = self.ranges[j]
            if s <= ts <= e:
                if best is None or s >= best[0]:
                    best = (s, e, name)
        return None if best is None else best[2]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return yardstick.union_length((s, e) for s, e, _, _ in self.ops) * 1e-6

    def device_s(self, rng: str) -> float:
        """Seconds in which an operation launched inside `rng` ran."""
        return yardstick.union_length(
            (s, e) for s, e, _, r in self.ops if r == rng) * 1e-6

    def op_count(self, rng: str) -> int:
        return sum(1 for op in self.ops if op[3] == rng)

    def range_count(self, rng: str) -> int:
        return sum(1 for r in self.ranges if r[2] == rng
                   and self.w0 <= r[0] <= self.w1)

    def kernel_s(self, fragments) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        one of `fragments`."""
        hits = [(s, e) for s, e, n, _ in self.ops
                if any(f in n for f in fragments)]
        return sum(e - s for s, e in hits) * 1e-6, len(hits)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle time
        of the device summed by the harness range the host was in."""
        by_name = defaultdict(float)
        for s, e, n, _ in self.ops:
            by_name[n] += (e - s) * 1e-6
        busy = yardstick.merge((s, e) for s, e, _, _ in self.ops)
        gaps = defaultdict(float)
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self.range_at((a + b) / 2) or "harness"] += (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}
