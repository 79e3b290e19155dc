"""The program's own spans and counters, for the per-layer metrics that
read them.

The program (`elf_tpu_torch.profiling`) records its spans, named `elf.*`,
as `record_function` ranges while a profiler session records: in a traced
run they lie in the window's trace beside the harness's ranges, on the
clock of the card's operations, and the program's counters count the
window's work (nothing else in a run is profiled).  `TraceSummary` keeps
every range it finds; these functions read the program's spans from
them by name.  A program without spans or counters leaves nothing to read:
no intervals, no counters.
"""

from __future__ import annotations

from harness import yardstick


def intervals(trace, names) -> list:
    """Host intervals (start, end; us) of the named program spans, cut to
    the window."""
    names = set(names)
    return [(max(s, trace.w0), min(e, trace.w1)) for s, e, n in trace.ranges
            if n in names and e > trace.w0 and s < trace.w1]


def span_s(trace, names) -> float:
    """Seconds of the window in which the host was inside one of the
    named spans."""
    return yardstick.union_length(intervals(trace, names)) * 1e-6


def span_stats(trace, name: str) -> tuple:
    """(count, summed seconds) of the span `name` in the window."""
    iv = intervals(trace, [name])
    return len(iv), sum(e - s for s, e in iv) * 1e-6


def overlap(a: list, b: list) -> float:
    """Length covered by both of two lists of disjoint sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while(trace, names) -> float:
    """Seconds in which no device operation ran while the host was inside
    one of the named spans."""
    spans = yardstick.merge(intervals(trace, names))
    busy = yardstick.merge((s, e) for s, e, _, _ in trace.ops)
    return (sum(e - s for s, e in spans) - overlap(spans, busy)) * 1e-6


def counters() -> dict:
    """The program's counters ({} where the program keeps none)."""
    from elf_tpu_torch import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}
