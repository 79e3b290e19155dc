"""Comparisons of the program's Go positions with the reference engine's
(`reference/go.py`), shared by the self-play and engine generators."""

from __future__ import annotations

import torch

from reference import go


def program_position(core, rows=None) -> dict:
    """A reference position from the program's board state (GoCore-like:
    stones, to_play, ko_point, ko_color, ko_age, ply, passes), cloned.  The
    program's ko is active for the player to move when its age is 0 and
    its colour is the mover's."""
    pick = (lambda t: t) if rows is None else (lambda t: t[rows])
    to_play = pick(core.to_play)
    ko_on = (pick(core.ko_age) == 0) & (pick(core.ko_color) == to_play)
    return {"stones": pick(core.stones).clone(),
            "to_play": to_play.to(torch.int8).clone(),
            "ko": torch.where(ko_on, pick(core.ko_point).long(), -1),
            "ply": pick(core.ply).long().clone(),
            "passes": pick(core.passes).long().clone()}


def replay_games(moves, start: dict, size: int, snaps: dict):
    """Replay every board's moves from `start` with the reference engine.

    moves: long [K, L] (all boards play L moves); snaps: {t: program
    position after t moves} to compare with.  Returns (boards [L + 1, K,
    n2] int8, positions [L + 1] of dicts, mismatches [K] long): a mismatch
    is an illegal move or a position that differs from the program's."""
    K, L = moves.shape
    pos = start
    bad = torch.zeros((K,), dtype=torch.long, device=moves.device)
    boards, positions = [pos["stones"]], [pos]
    for t in range(L):
        pos, legal = go.step(pos, moves[:, t], size)
        bad += (~legal).long()
        if t + 1 in snaps:
            bad += (~go.same_position(pos, snaps[t + 1])).long()
        boards.append(pos["stones"])
        positions.append(pos)
    return torch.stack(boards), positions, bad
