"""Candidate-model evaluation: color-swapped halves, win-rate bound early

The port's copy of `elf_tpu/control/eval_ctrl.py`, same behaviour.
stop, stuck handling, promotion decision.

Counterpart of the reference's `src_cpp/elfgames/go/train/ctrl_eval.h` +
`fair_pick.h`:
 - `WinCount` with `CheckWinrateBound` (fair_pick.h:61): decide WIN/LOSS
   early once the winrate interval [wins/n_max, (wins+uncertain)/n_max]
   clears the threshold; stuck requests shrink the denominator.
 - `Pick` = two `BatchRequest` halves (swap / noswap), each registering
   clients up to half the game budget (fair_pick.h:248).
 - `ModelPerf` per (candidate, baseline) pair; reward negated for the
   swapped half (ctrl_eval.h:99).
 - `EvalSubCtrl`: queue of candidates, per-client request filling, feed,
   and the promote-at->=`eval_winrate_thres` decision (ctrl_eval.h:240).
"""

from __future__ import annotations

import enum
import threading
from typing import Dict, List, Optional, Tuple

from elf_tpu_torch.config import ControlOptions
from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.selfplay.records import MsgRequest, Record


class WinEstimate(enum.Enum):
    WIN = "win"
    LOSS = "loss"
    INCOMPLETE = "incomplete"


class WinCount:
    def __init__(self) -> None:
        self.n_win = 0
        self.n_done = 0
        self.n_stuck = 0

    def add(self, reward: float) -> None:
        if reward > 0:
            self.n_win += 1
        self.n_done += 1

    def winrate(self) -> float:
        return self.n_win / self.n_done if self.n_done else 0.0

    def is_done(self, n_request: int) -> bool:
        return self.n_stuck + self.n_done >= n_request

    def check_winrate_bound(self, n_request: int, thres: float) -> WinEstimate:
        n_done_max = max(1, n_request - self.n_stuck)
        n_uncertain = n_done_max - self.n_done
        upper = (n_uncertain + self.n_win) / n_done_max
        lower = self.n_win / n_done_max
        if upper < thres:
            return WinEstimate.LOSS
        if lower >= thres:
            return WinEstimate.WIN
        return WinEstimate.INCOMPLETE


class BatchRequest:
    """Half of an evaluation (fair_pick.h:129) with PER-GAME accounting: a
    registered client may settle any number of games until the half fills.

    The reference settles one result per registration because its unit is
    a whole 32-thread client process; our unit is a lockstep [B]-board
    shard that ships B records — per-identity accounting would discard
    B-1 of them and a 1-client fleet could never finish a 400-game eval.
    The win-rate-bound semantics (n_done + n_stuck vs max) are preserved."""

    def __init__(self, max_num_request: int):
        self.max_num_request = max_num_request
        self.registered: Dict[str, int] = {}  # identity -> #results settled
        self.win_count = WinCount()

    def is_full(self) -> bool:
        return (
            self.win_count.n_done + self.win_count.n_stuck
            >= self.max_num_request
        )

    def register(self, identity: str) -> bool:
        """True if this client should (keep) play(ing) for this half."""
        if self.is_full():
            return False
        self.registered.setdefault(identity, 0)
        return True

    def add_result(self, identity: str, reward: float) -> bool:
        if identity not in self.registered or self.is_full():
            return False
        self.registered[identity] += 1
        self.win_count.add(reward)
        return True

    def check_stuck(self, is_client_dead) -> None:
        # a dead client that returned nothing shrinks the denominator by
        # one expected game (fair_pick.h:168 STUCK semantics)
        n_stuck = sum(
            1
            for ident, n in self.registered.items()
            if n == 0 and is_client_dead(ident)
        )
        self.win_count.n_stuck = n_stuck


class ModelPerf:
    """Performance of candidate vs baseline over swap/noswap halves
    (ctrl_eval.h:21)."""

    def __init__(self, candidate: int, baseline: int, opts: ControlOptions):
        self.candidate = candidate
        self.baseline = baseline
        self.opts = opts
        half = max(1, opts.eval_num_games // 2)
        self.noswap = BatchRequest(half)
        self.swap = BatchRequest(half)
        self.decided: Optional[WinEstimate] = None
        self._next_swap = False  # alternate halves across assignments

    def fill_in_request(self, identity: str, req: MsgRequest) -> bool:
        """Register the client for a half; True if assigned.

        A registered client KEEPS its half until that half fills
        (fair_pick.h registration persistence): our clients play
        multi-round lockstep games, so flipping the swap assignment on
        every request would re-color games mid-flight and corrupt reward
        attribution.  First-time assignments alternate halves so colors
        stay balanced across a fleet."""
        sticky = [
            (swap, batch)
            for swap, batch in ((False, self.noswap), (True, self.swap))
            if identity in batch.registered and not batch.is_full()
        ]
        if sticky:
            order = [sticky[0][0]]
        else:
            order = [self._next_swap, not self._next_swap]
        for swap in order:
            batch = self.swap if swap else self.noswap
            if batch.register(identity):
                if not sticky:
                    self._next_swap = not swap
                req.vers.black_ver = self.candidate
                req.vers.white_ver = self.baseline
                req.client_ctrl.player_swap = swap
                # eval games never resign and play with noise-free MCTS
                req.client_ctrl.resign_thres = 0.0
                req.client_ctrl.never_resign_prob = 1.0
                return True
        return False

    def feed(self, identity: str, r: Record) -> bool:
        swap = r.request.client_ctrl.player_swap
        # swap half: candidate plays white, so its reward is negated
        reward = -r.result.reward if swap else r.result.reward
        batch = self.swap if swap else self.noswap
        return batch.add_result(identity, reward)

    def update_state(self, is_client_dead) -> Optional[WinEstimate]:
        if self.decided is not None:
            return self.decided
        self.noswap.check_stuck(is_client_dead)
        self.swap.check_stuck(is_client_dead)
        total = WinCount()
        total.n_win = self.noswap.win_count.n_win + self.swap.win_count.n_win
        total.n_done = self.noswap.win_count.n_done + self.swap.win_count.n_done
        total.n_stuck = self.noswap.win_count.n_stuck + self.swap.win_count.n_stuck
        est = total.check_winrate_bound(
            self.opts.eval_num_games, self.opts.eval_winrate_thres
        )
        if est != WinEstimate.INCOMPLETE:
            self.decided = est
        return est if est != WinEstimate.INCOMPLETE else None

    def winrate(self) -> float:
        total_win = self.noswap.win_count.n_win + self.swap.win_count.n_win
        total_done = self.noswap.win_count.n_done + self.swap.win_count.n_done
        return total_win / total_done if total_done else 0.0

    def info(self) -> str:
        return (
            f"eval {self.candidate} vs {self.baseline}: wr={self.winrate():.3f} "
            f"done={self.noswap.win_count.n_done + self.swap.win_count.n_done}"
            f"/{self.opts.eval_num_games} "
            f"stuck={self.noswap.win_count.n_stuck + self.swap.win_count.n_stuck}"
        )


class EvalSubCtrl:
    def __init__(self, opts: ControlOptions, mcts_opt=None):
        self.opts = opts
        # server-side MCTS options: eval jobs ship the noise-free variant
        # (ctrl_eval.h:233-236 strips root noise on the SERVER), with an
        # optional rollout-budget override (--eval_num_rollouts) so eval
        # strength/cost can differ from selfplay search
        self.mcts_opt = mcts_opt.noise_free() if mcts_opt is not None else None
        n_eval_ro = getattr(opts, "eval_num_rollouts", -1)
        if self.mcts_opt is not None and n_eval_ro >= 0:
            import dataclasses as _dc

            self.mcts_opt = _dc.replace(
                self.mcts_opt, num_threads=1,
                num_rollouts_per_thread=n_eval_ro,
            )
        self.last_promotion_info: Optional[dict] = None
        self.baseline = -1
        self.perfs: Dict[Tuple[int, int], ModelPerf] = {}
        self.pending: List[int] = []  # candidate queue
        self.lock = threading.Lock()
        self.logger = get_indexed_logger("control.EvalSubCtrl-")

    def set_baseline(self, ver: int) -> None:
        with self.lock:
            self.baseline = ver
            # retire candidates at/below the new baseline; surviving ones
            # are re-keyed against it (their old-baseline ModelPerf would
            # be unreachable and they would sit in the queue forever)
            self.pending = [c for c in self.pending if c > ver]
            for c in self.pending:
                self.perfs.setdefault(
                    (c, ver), ModelPerf(c, ver, self.opts)
                )

    def add_new_model_for_evaluation(self, candidate: int) -> None:
        with self.lock:
            if candidate <= self.baseline:
                return
            key = (candidate, self.baseline)
            if key not in self.perfs:
                self.perfs[key] = ModelPerf(candidate, self.baseline, self.opts)
                self.pending.append(candidate)
                self.logger.info(
                    "queued candidate %d vs baseline %d", candidate, self.baseline
                )

    def fill_in_request(self, identity: str, req: MsgRequest) -> bool:
        """Assign this eval-capable client a game if any candidate needs one."""
        with self.lock:
            for cand in self.pending:
                perf = self.perfs.get((cand, self.baseline))
                if perf and perf.decided is None and perf.fill_in_request(
                    identity, req
                ):
                    if self.mcts_opt is not None:
                        req.vers.mcts_opt = self.mcts_opt
                    # server-driven eval thread allocation: cap how many
                    # boards the client may dedicate to this eval job
                    # (ctrl_eval.h:140 num_game_thread_used =
                    # options_.eval_num_threads)
                    n = getattr(self.opts, "eval_num_threads", -1)
                    if n >= 0:
                        req.client_ctrl.num_game_thread_used = n
                    return True
            return False

    def feed(self, identity: str, r: Record) -> None:
        with self.lock:
            key = (r.request.vers.black_ver, r.request.vers.white_ver)
            perf = self.perfs.get(key)
            if perf is not None:
                perf.feed(identity, r)

    def check_promotions(self, is_client_dead) -> Optional[int]:
        """Returns a candidate version to promote, if any decided WIN
        (ctrl_eval.h:240 updateState)."""
        with self.lock:
            for cand in list(self.pending):
                perf = self.perfs.get((cand, self.baseline))
                if perf is None:
                    continue
                est = perf.update_state(is_client_dead)
                if est == WinEstimate.WIN:
                    self.logger.info("PROMOTE %s", perf.info())
                    self.last_promotion_info = {
                        "candidate": cand,
                        "baseline": self.baseline,
                        "winrate": round(perf.winrate(), 4),
                        "n_win": (perf.noswap.win_count.n_win
                                  + perf.swap.win_count.n_win),
                        "n_done": (perf.noswap.win_count.n_done
                                   + perf.swap.win_count.n_done),
                        "n_stuck": (perf.noswap.win_count.n_stuck
                                    + perf.swap.win_count.n_stuck),
                    }
                    self.pending.remove(cand)
                    return cand
                if est == WinEstimate.LOSS:
                    self.logger.info("rejected %s", perf.info())
                    self.pending.remove(cand)
            return None

    def info(self) -> str:
        with self.lock:
            lines = [
                self.perfs[(c, self.baseline)].info()
                for c in self.pending
                if (c, self.baseline) in self.perfs
            ]
            return f"EvalSubCtrl baseline={self.baseline}: " + (
                "; ".join(lines) if lines else "idle"
            )
