"""Feature planes + D4 symmetry: counterpart of `elf_tpu/env/go/features.py`.

 - AGZ 18-plane set (`extractAGZ`): 8 x (my stones, opp stones) history
   snapshots newest first, + black/white to-move indicators.
 - df 25-plane set (`extract`): liberty-class binaries (==1 / ==2 / >=3)
   for both sides, the simple-ko point, stone/empty masks, exp-decayed
   placement history, L1 closest-colour distance transforms, to-move
   indicators (planes 12, 13 and 18-24 stay zero, as the reference leaves
   them).

D4 symmetry (0..7 = rot + 4*flip, board_feature.h:96 `setD4Code`) is a
per-board gather through precomputed index maps (the JAX package selects
among eight statically transformed copies, because a gather is slow on a
TPU; the result is the same permutation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elf_tpu_torch.env.go import engine
from elf_tpu_torch.env.go.engine import BLACK, EMPTY, WHITE
from elf_tpu_torch.env.go.kernels import INF
from elf_tpu_torch.env.go.state import MAX_AGZ_HISTORY, GoState

NUM_AGZ_PLANES = 18    # board_feature.h:38 MAX_NUM_AGZ_FEATURE
NUM_DF_PLANES = 25     # board_feature.h:18 MAX_NUM_FEATURE


@functools.lru_cache(maxsize=None)
def _d4_maps_np(size: int):
    """(fwd, inv) int32 [8, N2]: fwd[g][p] = T_g(p); inv[g][q] = T_g^-1(q)."""
    n = size
    fwd = np.zeros((8, n * n), np.int32)
    for g in range(8):
        rot, flip = g % 4, g // 4
        for r in range(n):
            for c in range(n):
                rr, cc = r, c
                for _ in range(rot):  # CCW rotation in (row, col)
                    rr, cc = n - 1 - cc, rr
                if flip:
                    rr, cc = cc, rr
                fwd[g, r * n + c] = rr * n + cc
    inv = np.zeros_like(fwd)
    for g in range(8):
        inv[g, fwd[g]] = np.arange(n * n, dtype=np.int32)
    return fwd, inv


@functools.lru_cache(maxsize=None)
def _d4_maps(size: int, device: torch.device):
    fwd, inv = _d4_maps_np(size)
    return (torch.from_numpy(fwd).long().to(device),
            torch.from_numpy(inv).long().to(device))


def _gather_points(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """out[b, ..., q] = x[b, ..., index[b, q]] for x [B, ..., n2]."""
    idx = index.reshape(index.shape[:1] + (1,) * (x.ndim - 2)
                        + index.shape[1:]).expand(x.shape)
    return torch.gather(x, -1, idx)


def transform_planes(planes: torch.Tensor, codes: torch.Tensor,
                     size: int) -> torch.Tensor:
    """planes [B, C, N2] -> the same planes under each board's D4 code
    (out[T_g(p)] = in[p])."""
    _, inv = _d4_maps(size, planes.device)
    return _gather_points(planes, inv[codes.long()])


def _transform_action_impl(action, codes, size: int, inverse: bool):
    n2 = size * size
    fwd, inv = _d4_maps(size, action.device)
    table = inv if inverse else fwd
    p = action.clamp(0, n2 - 1).long()
    out = table[codes.long(), p].to(action.dtype)
    return torch.where(action >= n2, action, out)


def transform_action(action, codes, size: int):
    """coord2Action (board_feature.h:131): board coord -> action in the
    transformed frame.  Pass (== N2) maps to itself."""
    return _transform_action_impl(action, codes, size, inverse=False)


def inv_transform_action(action, codes, size: int):
    """action2Coord (board_feature.h:138): transformed action -> coord."""
    return _transform_action_impl(action, codes, size, inverse=True)


def transform_policy(pi: torch.Tensor, codes: torch.Tensor,
                     size: int) -> torch.Tensor:
    """Board-frame policy in the transformed frame: out[a'] = pi[T^-1(a')];
    pass unchanged."""
    n2 = size * size
    _, inv = _d4_maps(size, pi.device)
    moves = _gather_points(pi[:, :n2], inv[codes.long()])
    return torch.cat([moves, pi[:, n2:]], dim=1)


def inv_transform_policy(pi: torch.Tensor, codes: torch.Tensor,
                         size: int) -> torch.Tensor:
    """Policy over transformed actions back to board coords:
    out[b, p] = pi[b, fwd[code][p]]; pass unchanged."""
    n2 = size * size
    fwd, _ = _d4_maps(size, pi.device)
    moves = _gather_points(pi[:, :n2], fwd[codes.long()])
    return torch.cat([moves, pi[:, n2:]], dim=1)


def extract_agz(state: GoState, codes: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [B, N, N, 18] NHWC planes (board_feature.cc `extractAGZ`)."""
    hist = torch.arange(MAX_AGZ_HISTORY - 1, -1, -1,
                        device=state.hist_len.device)
    valid = hist[None, :] < state.hist_len[:, None]
    return extract_agz_from_snapshots(
        state.stone_hist, valid, state.core.to_play, codes, size
    )


def extract_agz_from_snapshots(
    snaps: torch.Tensor,    # int8 [K, 8, n2] board snapshots, oldest first
    valid: torch.Tensor,    # bool [K, 8] per-snapshot validity, oldest first
    to_play: torch.Tensor,  # int8 [K]
    codes: torch.Tensor,    # int  [K] D4 codes
    size: int,
) -> torch.Tensor:
    """AGZ planes from explicit snapshots.  Plane 2i / 2i+1 = to-move /
    opponent stones i moves ago (i = 0 current), zero beyond the game's
    length; planes 16/17 = black/white to move.  f32 [K, N, N, 18]."""
    K = snaps.shape[0]
    n2 = size * size
    st = transform_planes(snaps, codes, size).flip(1)     # newest first
    v = valid.flip(1)[:, :, None]
    tp = to_play[:, None, None]
    mine = (st == tp) & v
    theirs = (st == 3 - tp) & v
    stacked = torch.stack([mine, theirs], dim=2).reshape(K, 16, n2)
    ind = torch.stack([to_play == BLACK, to_play == WHITE], dim=1)
    ind = ind[:, :, None].expand(K, 2, n2)
    out = torch.cat([stacked, ind], dim=1).to(torch.float32)
    return out.reshape(K, NUM_AGZ_PLANES, size, size).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# df 25-plane features
# ---------------------------------------------------------------------------


def _distance_transform_l1(seed_zero: torch.Tensor) -> torch.Tensor:
    """Exact L1 distance transform of [B, N, N] (0 at sources, 10000
    elsewhere): d[i] = min_j d[j] + |i - j| along rows, then along columns.
    Along one axis, the sources at or before i give i + cummin(d - i), those
    at or after it -i + the reversed cummin of (d + i); the values are
    small integers, exact in float32 (board_feature.cc:18 sweeps four
    times instead)."""
    d = seed_zero
    for axis in (1, 2):
        shape = [1, 1, 1]
        shape[axis] = d.shape[axis]
        i = torch.arange(d.shape[axis], dtype=d.dtype,
                         device=d.device).reshape(shape)
        fwd = torch.cummin(d - i, dim=axis).values + i
        bwd = torch.cummin((d + i).flip(axis), dim=axis).values.flip(axis) - i
        d = torch.minimum(fwd, bwd)
    return d


def extract_df_parts(
    stones: torch.Tensor,       # int8 [B, n2]
    to_play: torch.Tensor,      # int8 [B]
    ko_point: torch.Tensor,     # int  [B] flat index (gated by ko_active)
    ko_active: torch.Tensor,    # bool [B]
    ply: torch.Tensor,          # int  [B] (0-based move count)
    last_placed: torch.Tensor,  # int32 [B, n2] 1-based placement ply per stone
    codes: torch.Tensor,        # int  [B] D4 codes
    size: int,
) -> torch.Tensor:
    """df planes from explicit parts (board_feature.cc `extract`), shared by
    the whole-state path (`extract_df`), the search's leaves (parts from
    the tree's nodes) and the training pipeline (parts from record
    replay).  f32 [B, N, N, 25] NHWC."""
    B = stones.shape[0]
    n2 = size * size
    s2d = stones.reshape(B, size, size)
    mine2d = s2d == to_play.to(s2d.dtype)[:, None, None]
    theirs2d = (s2d != EMPTY) & ~mine2d
    empty2d = s2d == EMPTY

    lm, lx, m2 = engine.analyze_libs3(s2d, size)
    lib1 = (lm != INF) & (m2 == INF)            # exactly 1 distinct liberty
    lib2 = (m2 != INF) & (m2 == lx)             # exactly 2
    lib3 = (m2 != INF) & (m2 < lx)              # 3 or more

    pts = torch.arange(n2, device=stones.device)
    ko_plane = (pts[None, :] == ko_point[:, None]) & ko_active[:, None]
    ply_ref = (ply + 1).to(torch.float32)       # the reference's 1-based _ply
    hist_exp = torch.exp((last_placed.to(torch.float32) - ply_ref[:, None])
                         / 10.0)

    far = torch.full((B, size, size), 10_000.0, device=stones.device)
    dist_mine = _distance_transform_l1(torch.where(mine2d, 0.0, far))
    dist_theirs = _distance_transform_l1(torch.where(theirs2d, 0.0, far))

    def f(x):
        return x.reshape(B, n2).to(torch.float32)

    zeros = torch.zeros((B, n2), device=stones.device)
    planes = [
        f(mine2d & lib1), f(mine2d & lib2), f(mine2d & lib3),          # 0-2
        f(theirs2d & lib1), f(theirs2d & lib2), f(theirs2d & lib3),    # 3-5
        f(ko_plane),                                                   # 6
        f(mine2d), f(theirs2d), f(empty2d),                            # 7-9
        hist_exp * f(mine2d), hist_exp * f(theirs2d),                  # 10-11
        zeros, zeros,                                                  # 12-13
        f(dist_mine), f(dist_theirs),                                  # 14-15
    ]
    stacked = transform_planes(torch.stack(planes, dim=1), codes, size)
    ind = torch.stack([to_play == BLACK, to_play == WHITE], dim=1)
    ind = ind[:, :, None].expand(B, 2, n2).to(torch.float32)
    pad = torch.zeros((B, NUM_DF_PLANES - 18, n2), device=stones.device)
    out = torch.cat([stacked, ind, pad], dim=1)
    return out.reshape(B, NUM_DF_PLANES, size, size).permute(0, 2, 3, 1)


def extract_df(state: GoState, codes: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [B, N, N, 25] NHWC df planes of a game state."""
    core = state.core
    return extract_df_parts(
        core.stones, core.to_play, core.ko_point,
        (core.ko_age == 0) & (core.ko_point >= 0),
        core.ply, state.last_placed, codes, size,
    )
