"""AGZ-18 feature planes + D4 symmetry: counterpart of
`elf_tpu/env/go/features.py:36-220`.

D4 symmetry (0..7 = rot + 4*flip, board_feature.h:96 `setD4Code`) is a
per-board gather through precomputed index maps (the JAX package selects
among eight statically transformed copies, because a gather is slow on a
TPU; the result is the same permutation).  The df-25 set is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elf_tpu_torch.env.go.engine import BLACK, WHITE
from elf_tpu_torch.env.go.state import MAX_AGZ_HISTORY, GoState

NUM_AGZ_PLANES = 18    # board_feature.h:38 MAX_NUM_AGZ_FEATURE


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
