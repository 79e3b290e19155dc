"""Batched Go engine in PyTorch: counterpart of `elf_tpu/env/go/engine.py`.

Every function works on ``[B, ...]`` tensors on one device.  Liberty
analysis (the min/max flat index of the empty points next to each chain,
see `kernels.py`) runs as a CUDA kernel on a CUDA tensor and as its plain
PyTorch version on a CPU tensor; every rule is derived from those two
fields exactly as in the JAX engine:

  zero-lib chain : stone & lib_min == INF
  atari (1 lib)  : lib_min == lib_max != INF
  >= 2 libs      : lib_min < lib_max

Differences in form, not in result: point lookups are gathers (the JAX
engine uses one-hot reductions because gathers are slow on a TPU), and the
32-bit Zobrist hashes are held as int32 bit patterns (compare with JAX
through ``.numpy().view(np.uint32)``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import kernels
from elf_tpu_torch.env.go.kernels import INF, shift
from elf_tpu_torch.env.go.zobrist import zobrist_tables
from elf_tpu_torch.profiling import read

EMPTY, BLACK, WHITE = 0, 1, 2

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


class GoCore(NamedTuple):
    """Minimal per-board state; every tensor has a leading batch dim [B]."""

    stones: torch.Tensor     # int8  [B, N2]  0 empty / 1 black / 2 white
    to_play: torch.Tensor    # int8  [B]      1 or 2
    ko_point: torch.Tensor   # int32 [B]      flat idx of ko point, or -1
    ko_color: torch.Tensor   # int8  [B]      player forbidden to take the ko
    ko_age: torch.Tensor     # int32 [B]      0 == ko restriction active
    ply: torch.Tensor        # int32 [B]      moves played so far
    passes: torch.Tensor     # int32 [B]      consecutive passes
    last_move: torch.Tensor  # int32 [B]      last action, -1 initially
    hash_lo: torch.Tensor    # int32 [B]      Zobrist hash (low), u32 bits
    hash_hi: torch.Tensor    # int32 [B]      Zobrist hash (high), u32 bits


class StepInfo(NamedTuple):
    illegal: torch.Tensor     # bool  [B] move was illegal (state unchanged)
    captured: torch.Tensor    # int32 [B] stones captured by this move
    ko_created: torch.Tensor  # bool  [B]
    legal_next: torch.Tensor  # bool  [B, N2+1] next player's legal mask
    #                           (undefined on illegal rows)


def init_core(batch: int, size: int, device: DeviceLike = "cuda") -> GoCore:
    """Empty boards, black to play, on `device` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    n2 = size * size
    i32 = dict(dtype=torch.int32, device=device)
    i8 = dict(dtype=torch.int8, device=device)
    return GoCore(
        stones=torch.zeros((batch, n2), **i8),
        to_play=torch.full((batch,), BLACK, **i8),
        ko_point=torch.full((batch,), -1, **i32),
        ko_color=torch.zeros((batch,), **i8),
        ko_age=torch.full((batch,), 10_000, **i32),
        ply=torch.zeros((batch,), **i32),
        passes=torch.zeros((batch,), **i32),
        last_move=torch.full((batch,), -1, **i32),
        hash_lo=torch.zeros((batch,), **i32),
        hash_hi=torch.zeros((batch,), **i32),
    )


@functools.lru_cache(maxsize=None)
def _zobrist(size: int, device: torch.device):
    """(lo, hi) int32 [N2, 3] tables holding the uint32 bit patterns."""
    lo, hi = zobrist_tables(size)
    return (torch.from_numpy(lo.view("int32").copy()).to(device),
            torch.from_numpy(hi.view("int32").copy()).to(device))


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an int32 [B, n] tensor (halving folds)."""
    n = x.shape[1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        x = torch.cat([x, x.new_zeros((x.shape[0], m - n))], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def _nbr_count(mask2d: torch.Tensor) -> torch.Tensor:
    """Number of on-board 4-neighbors where mask2d is True."""
    m = mask2d.to(torch.int32)
    return sum(shift(m, dr, dc, 0) for dr, dc in _DIRS)


def analyze_libs(stones2d: torch.Tensor, size: int):
    """(lib_min, lib_max) int32 [B, N, N] for every chain on the board."""
    return kernels.analyze_libs(stones2d)


def analyze_libs3(stones2d: torch.Tensor, size: int):
    """(lib_min, lib_max, lib_min2) int32 [B, N, N]: `analyze_libs`' fields
    and the second-smallest distinct liberty of each chain (INF where it
    has fewer than two), which tells chains with exactly 2 liberties from
    those with 3 or more (the df planes, board_feature.cc
    `getLibertyMap3binary`).  Plain PyTorch on every device, as in the
    JAX package, where it is an XLA fixpoint and no Pallas kernel: the
    same-colour propagation of `elf_tpu/env/go/engine.py:314` with one
    host check per round."""
    lm, lx = kernels._init_lib_fields(stones2d)
    n = stones2d.shape[-1]
    idx = torch.arange(n * n, dtype=torch.int32, device=stones2d.device)
    idx = idx.reshape(n, n).expand(stones2d.shape)
    empty = stones2d == EMPTY
    # second-smallest adjacent empty point per stone
    m2 = torch.full_like(lm, INF)
    for dr, dc in _DIRS:
        nbr = torch.where(shift(empty, dr, dc, False), shift(idx, dr, dc, 0),
                          INF)
        m2 = torch.where((nbr > lm) & (nbr < m2), nbr, m2)
    m2 = torch.where(empty, INF, m2)
    same = [(~empty) & (shift(stones2d, dr, dc, 0) == stones2d)
            for dr, dc in _DIRS]
    while True:
        prev = (lm, lx, m2)
        for (dr, dc), sm in zip(_DIRS, same):
            nlm = shift(lm, dr, dc, INF)
            # the two smallest distinct liberties of the union
            new_min = torch.minimum(lm, nlm)
            big = torch.maximum(lm, nlm)
            cand2 = torch.where(big == new_min, INF, big)
            new_m2 = torch.minimum(torch.minimum(m2, shift(m2, dr, dc, INF)),
                                   cand2)
            new_m2 = torch.where(new_m2 == new_min, INF, new_m2)
            lx = torch.where(sm, torch.maximum(lx, shift(lx, dr, dc, -1)), lx)
            lm = torch.where(sm, new_min, lm)
            m2 = torch.where(sm, new_m2, m2)
        if not bool(torch.stack([(a != b).any()
                                 for a, b in zip(prev, (lm, lx, m2))]).any()):
            return lm, lx, m2


def step_core(core: GoCore, action: torch.Tensor, size: int
              ) -> Tuple[GoCore, StepInfo]:
    """Apply one action per board (flat idx, or N2 == pass), lockstep.

    Out-of-range actions, negatives included, are passes.  Illegal moves
    (occupied / ko violation / suicide) leave the board unchanged and set
    info.illegal."""
    n2 = size * size
    B = core.stones.shape[0]
    dev = core.stones.device
    zlo, zhi = _zobrist(size, dev)
    rows = torch.arange(B, device=dev)
    action = action.to(torch.int32)

    is_pass = (action >= n2) | (action < 0)
    p = action.clamp(0, n2 - 1).long()
    color = core.to_play.to(torch.int32)
    opp = (3 - color).to(torch.int8)

    stones = core.stones
    occupied = stones[rows, p] != EMPTY
    ko_violation = (
        (p == core.ko_point)
        & (core.ko_age == 0)
        & (core.to_play == core.ko_color)
        & ~is_pass
    )

    # fused placement + capture + liberty analysis (CUDA kernel on the card)
    s2, lm2, lx2, cap_flat = kernels.step_analysis(stones, action, color)
    ncap = cap_flat.sum(dim=1, dtype=torch.int32)
    s2_2d = s2.reshape(B, size, size)
    lm_p = lm2.reshape(B, n2)[rows, p]
    lx_p = lx2.reshape(B, n2)[rows, p]

    suicide = ~is_pass & (lm_p == INF)
    illegal = ~is_pass & (occupied | ko_violation | suicide)

    # --- simple ko detection (board.cc:1384) ---------------------------------
    own_atari = (lm_p == lx_p) & (lm_p != INF)
    same_nbr = _nbr_count(s2_2d == core.to_play[:, None, None]).reshape(B, n2)
    own_single = same_nbr[rows, p] == 0
    ko_created = ~is_pass & own_atari & own_single & (ncap == 1)
    cap_idx = torch.argmax(cap_flat.to(torch.int32), dim=1).to(torch.int32)

    # --- zobrist update ------------------------------------------------------
    is_black = (color == BLACK)[:, None]
    z_col_lo = torch.where(is_black, zlo[None, :, 1], zlo[None, :, 2])
    z_col_hi = torch.where(is_black, zhi[None, :, 1], zhi[None, :, 2])
    z_opp_lo = torch.where(is_black, zlo[None, :, 2], zlo[None, :, 1])
    z_opp_hi = torch.where(is_black, zhi[None, :, 2], zhi[None, :, 1])
    place_lo = z_col_lo[rows, p]
    place_hi = z_col_hi[rows, p]
    cap_lo = _xor_reduce(torch.where(cap_flat, z_opp_lo, 0))
    cap_hi = _xor_reduce(torch.where(cap_flat, z_opp_hi, 0))
    new_hash_lo = core.hash_lo ^ place_lo ^ cap_lo
    new_hash_hi = core.hash_hi ^ place_hi ^ cap_hi

    # --- commit (guard illegal: state unchanged) -----------------------------
    ok_move = ~is_pass & ~illegal
    new_stones = torch.where(ok_move[:, None], s2, stones)
    new_hash_lo = torch.where(ok_move, new_hash_lo, core.hash_lo)
    new_hash_hi = torch.where(ok_move, new_hash_hi, core.hash_hi)

    advanced = is_pass | ok_move
    new_ko = ok_move & ko_created
    new_core = GoCore(
        stones=new_stones,
        to_play=torch.where(advanced, opp, core.to_play),
        ko_point=torch.where(new_ko, cap_idx, core.ko_point),
        ko_color=torch.where(new_ko, opp, core.ko_color),
        ko_age=torch.where(
            new_ko, 0, torch.where(advanced, core.ko_age + 1, core.ko_age)
        ),
        ply=torch.where(advanced, core.ply + 1, core.ply),
        passes=torch.where(
            is_pass, core.passes + 1, torch.where(ok_move, 0, core.passes)
        ),
        last_move=torch.where(advanced, action, core.last_move),
        hash_lo=new_hash_lo,
        hash_hi=new_hash_hi,
    )
    legal_next = _legal_from_analysis(
        s2_2d, lm2, lx2, new_core.to_play, new_core.ko_point,
        new_core.ko_color, new_core.ko_age, size,
    )
    info = StepInfo(
        illegal=illegal,
        captured=torch.where(ok_move, ncap, 0),
        ko_created=new_ko,
        legal_next=legal_next,
    )
    return new_core, info


def _legal_from_analysis(s2d, lm, lx, to_play, ko_point, ko_color, ko_age,
                         size: int) -> torch.Tensor:
    """Legality mask given a board and its liberty analysis (shared by
    `legal_moves` and the step's `legal_next`)."""
    n2 = size * size
    B = s2d.shape[0]
    empty = s2d == EMPTY
    friendly = s2d == to_play[:, None, None]
    enemy = (s2d != EMPTY) & ~friendly

    atari = (lm == lx) & (lm != INF)
    two_libs = lm < lx
    alive = friendly & two_libs
    capturable = enemy & atari

    has_empty_nbr = torch.zeros_like(empty)
    has_friend_alive = torch.zeros_like(empty)
    has_enemy_atari = torch.zeros_like(empty)
    for dr, dc in _DIRS:
        has_empty_nbr |= shift(empty, dr, dc, False)
        has_friend_alive |= shift(alive, dr, dc, False)
        has_enemy_atari |= shift(capturable, dr, dc, False)

    playable = empty & (has_empty_nbr | has_friend_alive | has_enemy_atari)
    flat = playable.reshape(B, n2)
    ko_active = (ko_age == 0) & (to_play == ko_color)
    pts = torch.arange(n2, dtype=torch.int32, device=s2d.device)
    ko_mask = (pts[None, :] == ko_point[:, None]) & ko_active[:, None]
    flat = flat & ~ko_mask
    return torch.cat([flat, flat.new_ones((B, 1))], dim=1)


def legal_moves(core: GoCore, size: int) -> torch.Tensor:
    """bool [B, N2 + 1] legal-action mask for `to_play` (pass always legal):
    empty, not a ko violation, and not suicide (`FindAllValidMoves`,
    board.cc:867)."""
    B = core.stones.shape[0]
    s2d = core.stones.reshape(B, size, size)
    lm, lx = analyze_libs(s2d, size)
    return _legal_from_analysis(
        s2d, lm, lx, core.to_play, core.ko_point, core.ko_color,
        core.ko_age, size,
    )


def is_terminal_core(core: GoCore, size: int) -> torch.Tensor:
    """Two-pass or max-move termination (superko handled by the full env);
    the reference terminates at 1-based ply >= 2*N^2 (go_state.h:146)."""
    return (core.passes >= 2) | (core.ply >= 2 * size * size - 1)


def score_tromp_taylor(core: GoCore, size: int) -> torch.Tensor:
    """int32 [B]: (black stones+territory) - (white stones+territory), by
    reachability flood fill (`simple_tt_scoring`, go_state.h:33-99).  The
    fill ends on a host read of whether it grew (`profiling.read`)."""
    B = core.stones.shape[0]
    s2d = core.stones.reshape(B, size, size)
    empty = s2d == EMPTY

    def reach(color):
        r = s2d == color
        passable = empty | r
        while True:
            grown = r
            for dr, dc in _DIRS:
                grown = grown | shift(r, dr, dc, False)
            grown = grown & passable
            if not read((grown != r).any()):
                return grown
            r = grown

    rb = reach(BLACK)
    rw = reach(WHITE)
    black_v = (rb & ~rw).sum(dim=(1, 2), dtype=torch.int32)
    white_v = (rw & ~rb).sum(dim=(1, 2), dtype=torch.int32)
    return black_v - white_v
