"""Counters, timers and game-outcome statistics: the port's copy of
`elf_tpu/stats.py`.

 - `ValueStats` / `MultiCounter` (reference `rlpytorch/utils.py:90/:145`):
   min/max/avg feeds and named counters with periodic summaries.
 - `RLTimer` (`trainer/timer.py:12`): wall time per named stage.
 - `WinRate` (`stats/stats.py` WinRate + `game_stats.h` WinRateStats).
 - `Ranking` / `GameStats` (`game_stats.h:21`, `game_utils.h`): chosen-move
   rank histogram and the client-side aggregate.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional


class ValueStats:
    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def feed(self, v: float) -> None:
        self.summation += v
        self.counter += 1
        if v > self.max_value:
            self.max_value = v
            self.max_idx = self.counter
        if v < self.min_value:
            self.min_value = v
            self.min_idx = self.counter

    def mean(self) -> float:
        return self.summation / self.counter if self.counter else 0.0

    def summary(self, info: str = "") -> str:
        if self.counter == 0:
            return f"{info or self.name}: N/A"
        return (
            f"{info or self.name}: avg {self.mean():.6f}, "
            f"min {self.min_value:.6f}[{self.min_idx}], "
            f"max {self.max_value:.6f}[{self.max_idx}] (n={self.counter})"
        )

    def reset(self) -> None:
        self.counter = 0
        self.summation = 0.0
        self.max_value = -1e38
        self.min_value = 1e38
        self.max_idx = 0
        self.min_idx = 0


class MultiCounter:
    def __init__(self):
        self.counts: Dict[str, int] = defaultdict(int)
        self.stats: Dict[str, ValueStats] = defaultdict(ValueStats)
        self.total_count = 0
        self.last_time = time.time()

    def inc(self, key: str, n: int = 1) -> None:
        self.counts[key] += n
        self.total_count += n

    def feed(self, key: str, v: float) -> None:
        self.stats[key].feed(v)

    def summary(self, global_counter=None) -> str:
        elapsed = time.time() - self.last_time
        lines = [f"[{global_counter}] time elapsed: {elapsed:.2f}s"]
        for k, v in self.counts.items():
            lines.append(f"[{k}]: {v}/{elapsed:.2f}s = {v/max(elapsed,1e-9):.2f}/s")
        for k, s in self.stats.items():
            lines.append(s.summary(info=k))
        return "\n".join(lines)

    def reset(self) -> None:
        self.counts.clear()
        for s in self.stats.values():
            s.reset()
        self.last_time = time.time()


class RLTimer:
    """Wall time per named stage (trainer/timer.py:12), on the monotonic
    clock."""

    def __init__(self):
        self.restart()

    def restart(self) -> None:
        self.overall = time.perf_counter()
        self.last = self.overall
        self.records: Dict[str, ValueStats] = defaultdict(ValueStats)

    def record(self, name: str) -> None:
        now = time.perf_counter()
        self.records[name].feed(now - self.last)
        self.last = now

    def print(self, nstep: int = 1) -> str:
        parts = [
            f"{k}: {s.summation / max(nstep, 1) * 1000:.2f}ms"
            for k, s in self.records.items()
        ]
        return ", ".join(parts)


class WinRate:
    """Per-outcome accounting (stats/stats.py WinRate + game_stats.h
    WinRateStats): feeds rewards (+/-) and reports win rates."""

    def __init__(self):
        self.black_wins = 0
        self.white_wins = 0
        self.total = 0
        self.recent: List[float] = []

    def feed(self, reward: float) -> None:
        self.total += 1
        if reward > 0:
            self.black_wins += 1
        else:
            self.white_wins += 1
        self.recent.append(reward)
        if len(self.recent) > 1000:
            self.recent.pop(0)

    def black_winrate(self) -> float:
        return self.black_wins / self.total if self.total else 0.0

    def recent_black_winrate(self) -> float:
        if not self.recent:
            return 0.0
        return sum(1 for r in self.recent if r > 0) / len(self.recent)

    def summary(self) -> str:
        return (
            f"B/W: {self.black_wins}/{self.white_wins} "
            f"({100*self.black_winrate():.1f}% B), "
            f"recent {100*self.recent_black_winrate():.1f}%"
        )


class Ranking:
    """Histogram of chosen-move rank within the policy (game_utils.h
    Ranking): rank 0 = argmax move chosen."""

    def __init__(self, max_rank: int = 10):
        self.counts = [0] * (max_rank + 2)
        self.total = 0

    def feed(self, rank: int) -> None:
        self.total += 1
        self.counts[min(rank, len(self.counts) - 1)] += 1

    def summary(self) -> str:
        if not self.total:
            return "Ranking: N/A"
        parts = [
            f"r{i}:{c * 100 // self.total}%"
            for i, c in enumerate(self.counts)
            if c
        ]
        return f"Ranking({self.total}): " + " ".join(parts)


class GameStats:
    """Client-side aggregate surfaced to the control plane
    (game_stats.h:21 getGameStats)."""

    def __init__(self):
        self.winrate = WinRate()
        self.ranking = Ranking()
        self.move_counts = ValueStats("moves")

    def feed_game(self, reward: float, num_moves: int) -> None:
        self.winrate.feed(reward)
        self.move_counts.feed(num_moves)

    def summary(self) -> str:
        return " | ".join(
            [self.winrate.summary(), self.move_counts.summary(), self.ranking.summary()]
        )
