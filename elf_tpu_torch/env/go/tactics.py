"""Tactical board analysis on whole batches: eyes, false and semi eyes,
self-atari.  Counterpart of `elf_tpu/env/go/tactics.py` (the reference's
board tactics API, board.cc):

  isEye        (board.cc:1850)  empty point whose 4 neighbours are all own
                                stones or off the board;
  isFakeEye    (board.cc:1887)  diagonal test: (edge & >= 1 opponent
                                diagonal) or (interior & >= 2);
  isTrueEye    (board.cc:1912)  eye and not fake;
  isSemiEye    (board.cc:1863)  eye whose diagonals hold exactly one
                                empty non-eye point (the strengthening /
                                falsifying move) and no opponent (edge) /
                                one opponent (interior);
  isSelfAtari  (board.cc:254)   play the stone and see whether its chain
                                is left with exactly one liberty.

Each is one masked tensor op over `[B, n2]` boards.  `self_atari_mask`
plays every candidate move at once on a batch expanded to `[B * n2]`
boards through the engine's step and liberty analysis, so on a CUDA
tensor both liberty kernels launch, once each, at batch B * n2.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go.engine import EMPTY, GoCore
from elf_tpu_torch.env.go.kernels import INF, shift

_DIAGS = ((-1, -1), (-1, 1), (1, -1), (1, 1))
_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _to2d(stones: torch.Tensor, size: int) -> torch.Tensor:
    return stones.reshape(stones.shape[0], size, size)


def _colors(stones: torch.Tensor, color) -> Tuple[torch.Tensor, torch.Tensor]:
    """(own, opponent) colours shaped to broadcast over [B, N, N]: `color`
    is i8 [B] or a scalar."""
    color = torch.as_tensor(color, dtype=torch.int8, device=stones.device)
    c2 = color.reshape(-1, 1, 1) if color.ndim else color
    return c2, (3 - c2).to(torch.int8)


def eye_mask(stones: torch.Tensor, color, size: int) -> torch.Tensor:
    """bool [B, n2]: empty points whose 4 in-board neighbours are all
    `color` (isEye, board.cc:1850)."""
    s2 = _to2d(stones, size)
    c2, _ = _colors(stones, color)
    ok = s2 == EMPTY
    for dr, dc in _DIRS:
        nbr = shift(s2, dr, dc, -1)          # -1: off the board
        ok = ok & ((nbr == c2) | (nbr == -1))
    return ok.reshape(stones.shape)


def fake_eye_mask(stones: torch.Tensor, color, size: int) -> torch.Tensor:
    """bool [B, n2] (isFakeEye, board.cc:1887).  As in the reference, the
    point need not be an eye: this is the raw diagonal test."""
    s2 = _to2d(stones, size)
    _, opp = _colors(stones, color)
    n_opp = torch.zeros(s2.shape, dtype=torch.int32, device=s2.device)
    n_edge = torch.zeros_like(n_opp)
    for dr, dc in _DIAGS:
        nbr = shift(s2, dr, dc, -1)
        n_opp += nbr == opp
        n_edge += nbr == -1
    fake = ((n_edge > 0) & (n_opp >= 1)) | ((n_edge == 0) & (n_opp >= 2))
    return fake.reshape(stones.shape)


def true_eye_mask(stones: torch.Tensor, color, size: int) -> torch.Tensor:
    """isTrueEye (board.cc:1912): eye and not fake."""
    return eye_mask(stones, color, size) & ~fake_eye_mask(stones, color, size)


def semi_eye(stones: torch.Tensor, color, size: int):
    """(mask bool [B, n2], move i32 [B, n2]): isSemiEye (board.cc:1863),
    an eye with exactly one empty non-eye diagonal (that diagonal is the
    strengthening / falsifying move, else -1) and no opponent diagonal on
    the edge / exactly one in the interior."""
    s2 = _to2d(stones, size)
    _, opp = _colors(stones, color)
    base = _to2d(eye_mask(stones, color, size), size)
    idx2 = torch.arange(size * size, dtype=torch.int32, device=s2.device)
    idx2 = idx2.reshape(size, size).expand(s2.shape)
    n_opp = torch.zeros(s2.shape, dtype=torch.int32, device=s2.device)
    n_edge = torch.zeros_like(n_opp)
    n_empty = torch.zeros_like(n_opp)
    move = torch.full_like(n_opp, -1)
    for dr, dc in _DIAGS:
        nbr = shift(s2, dr, dc, -1)
        nbr_eye = shift(base, dr, dc, False)
        nbr_idx = shift(idx2, dr, dc, -1)
        is_empty_noneye = (nbr == EMPTY) & ~nbr_eye
        n_opp += nbr == opp
        n_edge += nbr == -1
        n_empty += is_empty_noneye
        move = torch.where(is_empty_noneye, nbr_idx, move)
    mask = base & (
        ((n_edge > 0) & (n_opp == 0) & (n_empty == 1))
        | ((n_edge == 0) & (n_opp == 1) & (n_empty == 1))
    )
    move = torch.where(mask, move, -1)
    return mask.reshape(stones.shape), move.reshape(stones.shape)


def self_atari_mask(core: GoCore, size: int) -> torch.Tensor:
    """bool [B, n2]: points where the current player's move would leave
    its own chain with exactly one liberty (isSelfAtari, board.cc:254).

    Plays every candidate move at once: the [B] batch is repeated to
    [B * n2] boards, each playing one point (`engine.step_core`), and the
    liberty analysis of the boards after the moves (`engine.analyze_libs`)
    classifies the placed chain (lib_min == lib_max != INF is one
    liberty).  An analysis path, not the self-play loop."""
    B = core.stones.shape[0]
    n2 = size * size
    big = GoCore(*(f.repeat_interleave(n2, dim=0) for f in core))
    cand = torch.arange(n2, dtype=torch.int32,
                        device=core.stones.device).repeat(B)
    stepped, info = engine.step_core(big, cand, size)
    lm, lx = engine.analyze_libs(stepped.stones.reshape(B * n2, size, size),
                                 size)
    rows = torch.arange(B * n2, device=core.stones.device)
    at = cand.long()
    lm = lm.reshape(B * n2, n2)[rows, at]
    lx = lx.reshape(B * n2, n2)[rows, at]
    atari = (lm == lx) & (lm != INF)
    placed = stepped.stones[rows, at] == big.to_play
    return (atari & placed & ~info.illegal).reshape(B, n2)
