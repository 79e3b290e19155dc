"""Self-play control: per-version stats, sufficiency gates, dynamic resign

The port's copy of `elf_tpu/control/selfplay_ctrl.py`, same behaviour.
threshold.

Counterpart of the reference's `src_cpp/elfgames/go/train/ctrl_selfplay.h`:
 - `ResignThresholdCalculator` (ctrl_selfplay.h:31): collect the winner's
   per-game minimum mover-perspective value over never-resign games; the
   resign threshold tracks the `falsePositiveTarget` quantile of that
   history, moving at most `max_delta` per update and clamped to
   [min, max].  (Values are shifted to [0, 2]: winner value + 1.)
 - `SelfPlayRecord` (ctrl_selfplay.h:168): per-version game/win/resign
   counters + checkpointing cadence.
 - `SelfPlaySubCtrl` (ctrl_selfplay.h:317): version-gated feeding, the
   `selfplay_init_num` / `selfplay_update_num` sufficiency gate, and
   request filling (current version + resign parameters).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from elf_tpu_torch.config import ControlOptions
from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.selfplay.records import MsgRequest, Record


class ResignThresholdCalculator:
    def __init__(
        self,
        hist_size: int = 2500,
        false_positive_target: float = 0.05,
        initial_threshold: float = 0.05,
        min_threshold: float = 0.0,
        max_threshold: float = 0.5,
    ):
        assert hist_size > 0
        assert 1e-6 < false_positive_target < 1 - 1e-6
        assert 0.0 <= min_threshold <= max_threshold <= 2.0
        self.hist_size = hist_size
        self.fp_target = false_positive_target
        self.threshold = initial_threshold
        self.min_threshold = min_threshold
        self.max_threshold = max_threshold
        self.winner_min_values: deque = deque()
        self.num_games = 0
        self.num_black_win = 0
        self.num_never_resign = 0
        self.num_fp = 0

    def feed(self, record: Record, black_never_resign: bool,
             white_never_resign: bool) -> None:
        """ctrl_selfplay.h:51 feed: values alternate by mover starting from
        record.result.first_player (black perspective throughout).
        Handicap records start with WHITE's move at index 0."""
        self.num_games += 1
        black_win = record.result.reward > 0
        if black_win:
            self.num_black_win += 1
        if not black_never_resign and not white_never_resign:
            return
        self.num_never_resign += 1
        if (black_win and black_never_resign) or (
            not black_win and white_never_resign
        ):
            values = record.result.values
            first = int(record.result.first_player) or 1
            # index parity of the winner's moves
            winner_is_first = black_win == (first == 1)
            start = 0 if winner_is_first else 1
            min_value = 2.0
            for i in range(start, len(values), 2):
                v = (1.0 + values[i]) if black_win else (1.0 - values[i])
                min_value = min(min_value, v)
            self._feed_winner_min(min_value)

    def _feed_winner_min(self, v: float) -> None:
        while len(self.winner_min_values) >= self.hist_size:
            self.winner_min_values.popleft()
        self.winner_min_values.append(v)
        if v < self.threshold:
            self.num_fp += 1

    def update_threshold(self, max_delta: float = 0.01) -> float:
        n = len(self.winner_min_values)
        pos = int(self.fp_target * n)
        if pos < 2 or pos + 2 >= n:
            return self.threshold
        vals = np.partition(np.asarray(self.winner_min_values), pos)
        old = self.threshold
        t = float(vals[pos])
        t = min(t, old + max_delta)
        t = max(t, old - max_delta)
        t = max(t, self.min_threshold)
        t = min(t, self.max_threshold)
        self.threshold = t
        return t

    def info(self) -> str:
        return (
            f"ResignCalc[thres={self.threshold:.4f} fp_target={self.fp_target} "
            f"games={self.num_games} bw={self.num_black_win} "
            f"never={self.num_never_resign} fp={self.num_fp}]"
        )


class SelfPlayRecord:
    """Per-model-version bookkeeping (ctrl_selfplay.h:168)."""

    def __init__(self, ver: int):
        self.ver = ver
        self.counter = 0
        self.black_win = 0
        self.white_win = 0
        self.resigned = 0
        self.move_count = 0
        # learner weight updates issued while this selfplay version was
        # current (ctrl_selfplay.h:311 num_weight_update_)
        self.num_weight_update = 0

    def feed(self, r: Record) -> None:
        self.counter += 1
        if r.result.reward > 0:
            self.black_win += 1
        else:
            self.white_win += 1
        self.move_count += r.result.num_move

    def need_wait_for_more_sample(self, opts: ControlOptions) -> bool:
        """ctrl_selfplay.h:243: the learner may take its k-th weight update
        only after selfplay_init_num + k * selfplay_update_num fresh games
        of the current version."""
        if opts.selfplay_init_num <= 0:
            return False
        if self.counter < opts.selfplay_init_num:
            return True
        if opts.selfplay_update_num <= 0:
            return False
        return self.counter < (
            opts.selfplay_init_num
            + opts.selfplay_update_num * self.num_weight_update
        )

    def info(self) -> str:
        n = max(1, self.counter)
        return (
            f"ver {self.ver}: {self.counter} games, "
            f"B {self.black_win} ({100*self.black_win/n:.1f}%), "
            f"avg moves {self.move_count/n:.1f}"
        )


class SelfPlaySubCtrl:
    def __init__(self, opts: ControlOptions, mcts_opt=None):
        self.opts = opts
        # server-driven MCTS options shipped inside every selfplay request
        # (ModelPair.mcts_opt, model_pair.h:10)
        self.mcts_opt = mcts_opt
        self.records: Dict[int, SelfPlayRecord] = {}
        self.cur_ver = -1
        self.resign_calc = ResignThresholdCalculator(
            hist_size=getattr(opts, "resign_target_hist_size", 2500),
            false_positive_target=getattr(opts, "resign_target_fp_rate", 0.05),
            initial_threshold=opts.resign_thres,
            min_threshold=getattr(opts, "resign_thres_lower_bound", 0.0),
            max_threshold=getattr(opts, "resign_thres_upper_bound", 0.5),
        )
        self.lock = threading.Lock()
        self.logger = get_indexed_logger("control.SelfPlaySubCtrl-")
        self._games_at_ver_start = 0

    def set_version(self, ver: int) -> None:
        with self.lock:
            if ver != self.cur_ver:
                self.logger.info("selfplay version %d -> %d", self.cur_ver, ver)
                self.cur_ver = ver
                self.records.setdefault(ver, SelfPlayRecord(ver))

    def version(self) -> int:
        with self.lock:
            return self.cur_ver

    def feed(self, r: Record, black_never_resign: bool = False,
             white_never_resign: bool = False) -> bool:
        """Accept only records from the current version
        (ctrl_selfplay.h:340 version gate).  Returns acceptance."""
        with self.lock:
            ver = r.request.vers.black_ver
            if ver != self.cur_ver:
                return False
            rec = self.records.setdefault(ver, SelfPlayRecord(ver))
            rec.feed(r)
            self.resign_calc.feed(r, black_never_resign, white_never_resign)
            if rec.counter % 100 == 0:
                self.resign_calc.update_threshold()
            return True

    def num_games(self, ver: Optional[int] = None) -> int:
        with self.lock:
            ver = self.cur_ver if ver is None else ver
            rec = self.records.get(ver)
            return rec.counter if rec else 0

    def is_sufficient(self, initial: bool) -> bool:
        """selfplay_init_num before the first train step, selfplay_update_num
        per subsequent version (ctrl_selfplay.h:243)."""
        need = (
            self.opts.selfplay_init_num if initial else self.opts.selfplay_update_num
        )
        return self.num_games() >= need

    # -- learner<->selfplay coupling (ctrl_selfplay.h:387 + game_ctrl.h:72) --

    VERSION_OLD = "version_old"
    VERSION_INVALID = "version_invalid"
    INSUFFICIENT_SAMPLE = "insufficient_sample"
    SUFFICIENT_SAMPLE = "sufficient_sample"

    def need_wait_for_more_sample(self, selfplay_ver: int) -> str:
        """SelfPlaySubCtrl::needWaitForMoreSample: the learner passes the
        selfplay version it trained against; if a promotion moved past it
        the wait ends (VERSION_OLD)."""
        with self.lock:
            if selfplay_ver < self.cur_ver:
                return self.VERSION_OLD
            rec = self.records.get(self.cur_ver)
            if rec is None:
                return self.VERSION_INVALID
            return (
                self.INSUFFICIENT_SAMPLE
                if rec.need_wait_for_more_sample(self.opts)
                else self.SUFFICIENT_SAMPLE
            )

    def notify_current_weight_update(self) -> None:
        """ctrl_selfplay.h:255 notifyWeightUpdate: raises the fresh-game bar
        for the learner's NEXT weight update at this selfplay version."""
        with self.lock:
            rec = self.records.get(self.cur_ver)
            if rec is not None:
                rec.num_weight_update += 1

    def fill_in_request(self, req: MsgRequest) -> None:
        with self.lock:
            req.vers.black_ver = self.cur_ver
            req.vers.white_ver = -1
            if self.mcts_opt is not None:
                req.vers.mcts_opt = self.mcts_opt
            req.client_ctrl.resign_thres = self.resign_calc.threshold
            req.client_ctrl.never_resign_prob = self.opts.never_resign_prob
            # async self-play: games continue across model versions
            # (ctrl_selfplay.h:263 msg->client_ctrl.async)
            req.client_ctrl.async_mode = getattr(
                self.opts, "selfplay_async", False
            )

    def info(self) -> str:
        with self.lock:
            rec = self.records.get(self.cur_ver)
            return (
                (rec.info() if rec else f"ver {self.cur_ver}: no games")
                + " | " + self.resign_calc.info()
            )
