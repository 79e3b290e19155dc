"""Color-swapped head-to-head evaluation between two models: counterpart
of `elf_tpu/tools/match.py` (reference `ctrl_eval.h` + `fair_pick.h`).
Play `games_per_half` games with A as black, then `games_per_half` with A
as white, and count A's wins.

When the two halves share one vectorized actor, the swap half must not
inherit games in flight from the noswap half: those were started under
the other color assignment and would be scored with the wrong sign.
`head_to_head` restarts every board at the half boundary
(`actor.reset_all`), so in-flight games are discarded, never mis-scored.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple


def elo_diff(winrate: float) -> float:
    """Elo difference implied by a head-to-head winrate."""
    wr = min(max(winrate, 1e-6), 1 - 1e-6)
    return 400.0 * math.log10(wr / (1.0 - wr))


def head_to_head(
    actor,
    a_state: Tuple,
    b_state: Tuple,
    games_per_half: int,
    moves_per_call: int = 16,
    record_sink: Optional[List] = None,
) -> Tuple[int, int]:
    """Play 2 * games_per_half eval games of A vs B on `actor` (built with
    `make_pair_eval_builder`).

    a_state / b_state: (net, batch_stats) for each model; a torch net
    carries its own BN statistics, so batch_stats may be None.  A plays
    black in the first half, white in the second.  Returns (wins_a,
    total).  Games still in flight when a half's quota is reached are
    discarded (board reset), not carried into the other half.
    `record_sink`, if given, collects (record, a_won) tuples.
    """
    wins_a = 0
    total = 0
    for swap in (False, True):
        actor.reset_all()
        black, white = (b_state, a_state) if swap else (a_state, b_state)
        params = (black[0], white[0])
        bstats = (black[1], white[1])
        target = actor.completed_games + games_per_half
        while actor.completed_games < target:
            for r in actor.play_moves(params, bstats, moves_per_call):
                total += 1
                a_won = (r.result.reward < 0) if swap else (r.result.reward > 0)
                wins_a += int(a_won)
                if record_sink is not None:
                    record_sink.append((r, a_won))
    return wins_a, total
