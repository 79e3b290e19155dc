"""Outcome accounting: the port's copy of `WinRate` from
`elf_tpu/stats.py:112` (reference stats/stats.py WinRate + game_stats.h
WinRateStats)."""

from __future__ import annotations

from typing import List


class WinRate:
    """Feeds rewards (+ black win / - white win) and reports win rates."""

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
