"""Full batched Go environment state: GoCore + histories.

Counterpart of `elf_tpu/env/go/state.py`: move history, positional-superko
detection over the hash history (go_state.cc:96), the 8-snapshot board
history feeding the AGZ feature planes, per-point placement ply,
termination and Tromp-Taylor evaluation (go_state.h:145, :194).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go.engine import BLACK, WHITE, GoCore, StepInfo

MAX_AGZ_HISTORY = 8  # board_feature.h:39 MAX_NUM_AGZ_HISTORY


class GoState(NamedTuple):
    core: GoCore
    last_placed: torch.Tensor   # int32 [B, N2] 1-based ply of each stone
    stone_hist: torch.Tensor    # int8  [B, 8, N2] post-move boards, oldest first
    hist_len: torch.Tensor      # int32 [B]
    hash_hist_lo: torch.Tensor  # int32 [B, H] pre-move hashes (u32 bits)
    hash_hist_hi: torch.Tensor  # int32 [B, H]
    nhash: torch.Tensor         # int32 [B]
    superko: torch.Tensor       # bool  [B]
    terminated: torch.Tensor    # bool  [B]

    @property
    def size(self) -> int:
        return math.isqrt(self.core.stones.shape[-1])


def init_state(batch: int, size: int, device: DeviceLike = "cuda") -> GoState:
    """Fresh states on `device` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    n2 = size * size
    max_h = 2 * n2 + 1
    i32 = dict(dtype=torch.int32, device=device)
    return GoState(
        core=engine.init_core(batch, size, device),
        last_placed=torch.zeros((batch, n2), **i32),
        stone_hist=torch.zeros((batch, MAX_AGZ_HISTORY, n2), dtype=torch.int8,
                               device=device),
        hist_len=torch.zeros((batch,), **i32),
        hash_hist_lo=torch.zeros((batch, max_h), **i32),
        hash_hist_hi=torch.zeros((batch, max_h), **i32),
        nhash=torch.zeros((batch,), **i32),
        superko=torch.zeros((batch,), dtype=torch.bool, device=device),
        terminated=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _tree_where(cond: torch.Tensor, a, b):
    """Select between two (nested) NamedTuples of tensors per batch element."""
    if isinstance(a, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (a.ndim - 1))
        return torch.where(c, a, b)
    return type(a)(*(_tree_where(cond, x, y) for x, y in zip(a, b)))


def step(state: GoState, action: torch.Tensor, size: int
         ) -> Tuple[GoState, StepInfo]:
    """Lockstep env step.  Terminated boards are frozen (no-op), matching
    `GoState::forward` returning false when terminated (go_state.cc:79)."""
    n2 = size * size
    dev = action.device
    action = action.to(torch.int32)
    core2, info = engine.step_core(state.core, action, size)

    is_pass = action >= n2
    moved = ~info.illegal & ~state.terminated
    placed = moved & ~is_pass

    # superko: the new position equals a recorded pre-move position
    # (checked only for stone moves; go_state.cc:99)
    H = state.hash_hist_lo.shape[1]
    k = torch.arange(H, device=dev)[None, :]
    in_hist = (
        (state.hash_hist_lo == core2.hash_lo[:, None])
        & (state.hash_hist_hi == core2.hash_hi[:, None])
        & (k < state.nhash[:, None])
    ).any(dim=1)
    new_superko = state.superko | (placed & in_hist)

    # append the pre-move hash (stone moves only, go_state.cc:113)
    slot = state.nhash.clamp(0, H - 1)
    at_slot = (k == slot[:, None]) & placed[:, None]
    hh_lo = torch.where(at_slot, state.core.hash_lo[:, None],
                        state.hash_hist_lo)
    hh_hi = torch.where(at_slot, state.core.hash_hi[:, None],
                        state.hash_hist_hi)
    nhash = torch.where(placed, state.nhash + 1, state.nhash)

    # board snapshot history (pushed on every successful forward, incl. pass)
    pushed = torch.cat([state.stone_hist[:, 1:], core2.stones[:, None]], dim=1)
    stone_hist = torch.where(moved[:, None, None], pushed, state.stone_hist)
    hist_len = torch.where(
        moved, (state.hist_len + 1).clamp(max=MAX_AGZ_HISTORY), state.hist_len
    )

    # last_placed stores the 1-based move number (board.cc:680)
    p = action.clamp(0, n2 - 1)
    pts = torch.arange(n2, dtype=torch.int32, device=dev)
    at_p = (pts[None, :] == p[:, None]) & placed[:, None]
    lp = torch.where(at_p, (state.core.ply + 1)[:, None], state.last_placed)

    core_out = _tree_where(state.terminated, state.core, core2)
    terminated = state.terminated | (
        moved
        & (
            (core2.passes >= 2)
            | (core2.ply >= 2 * n2 - 1)
            | (placed & in_hist)
        )
    )
    info = StepInfo(
        illegal=info.illegal & ~state.terminated,
        captured=torch.where(state.terminated, 0, info.captured),
        ko_created=info.ko_created & ~state.terminated,
        legal_next=info.legal_next & ~terminated[:, None],
    )
    return (
        GoState(
            core=core_out,
            last_placed=lp,
            stone_hist=stone_hist,
            hist_len=hist_len,
            hash_hist_lo=hh_lo,
            hash_hist_hi=hh_hi,
            nhash=nhash,
            superko=new_superko,
            terminated=terminated,
        ),
        info,
    )


def legal_moves(state: GoState, size: int) -> torch.Tensor:
    """[B, N2+1] mask; all-False on terminated boards."""
    lm = engine.legal_moves(state.core, size)
    return lm & ~state.terminated[:, None]


def evaluate(state: GoState, size: int, komi: float = 7.5) -> torch.Tensor:
    """f32 [B] final score from black's perspective (go_state.h:194):
    superko -> +-1 for the player to move; else TT score - komi."""
    tt = engine.score_tromp_taylor(state.core, size).to(torch.float32) - komi
    superko_val = torch.where(state.core.to_play == BLACK, 1.0, -1.0)
    return torch.where(state.superko, superko_val, tt)


def reset_where(state: GoState, mask: torch.Tensor, size: int,
                handicap: int = 0) -> GoState:
    """Reset boards where mask is True (vectorized game restart)."""
    fresh = init_state(state.core.stones.shape[0], size, mask.device)
    if handicap > 0:
        fresh = apply_handicap(fresh, handicap, size)
    return _tree_where(mask, fresh, state)


# Handicap placements (go_state.cc:33 HandicapTable, darkforestGo table).
_HANDICAPS = {
    2: ["D4", "Q16"],
    3: ["D4", "Q16", "Q4"],
    4: ["D4", "Q16", "D16", "Q4"],
    5: ["D4", "Q16", "D16", "Q4", "K10"],
    6: ["D4", "Q16", "D16", "Q4", "D10", "Q10"],
    7: ["D4", "Q16", "D16", "Q4", "D10", "Q10", "K10"],
    8: ["D4", "Q16", "D16", "Q4", "D10", "Q10", "K16", "K4"],
    9: ["D4", "Q16", "D16", "Q4", "D10", "Q10", "K16", "K4", "K10"],
}


def _handicap_flat(s: str, size: int) -> int:
    """The reference's handicap-coordinate semantics (go_state.cc:25 s2c):
    letter -> 0-based index-from-top with 'I' skipped, number-1 -> second
    index (not the GTP row-from-bottom convention)."""
    row = ord(s[0]) - ord("A")
    if row >= 9:
        row -= 1
    col = int(s[1:]) - 1
    if not (0 <= row < size and 0 <= col < size):
        raise ValueError(f"off-board handicap point {s} on {size}x{size}")
    return row * size + col


def apply_handicap(state: GoState, handicap: int, size: int) -> GoState:
    """Place handicap stones as black plays, then restore a fresh-game
    state with white to move (board.cc:109 PlaceHandicap)."""
    coords = _HANDICAPS.get(handicap, [])
    core = state.core
    B = core.stones.shape[0]
    dev = core.stones.device
    for gtp in coords:
        try:
            p = _handicap_flat(gtp, size)
        except ValueError:
            continue  # off-board on small sizes
        core = core._replace(
            to_play=torch.full((B,), BLACK, dtype=torch.int8, device=dev))
        core, _ = engine.step_core(
            core, torch.full((B,), p, dtype=torch.int32, device=dev), size)
    core = core._replace(
        to_play=torch.full((B,), WHITE if coords else BLACK, dtype=torch.int8,
                           device=dev),
        ply=torch.zeros((B,), dtype=torch.int32, device=dev),
        passes=torch.zeros((B,), dtype=torch.int32, device=dev),
        last_move=torch.full((B,), -1, dtype=torch.int32, device=dev),
        ko_age=torch.full((B,), 10_000, dtype=torch.int32, device=dev),
    )
    # PlaceHandicap stamps last_placed = the initial 1-based ply (board.cc:1379)
    last_placed = torch.where(core.stones == BLACK, 1, state.last_placed)
    return state._replace(core=core, last_placed=last_placed)
