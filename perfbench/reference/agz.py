"""Plain AlphaGo Zero input planes, the board's eight symmetries and the
record codecs, for the benchmark's reference.

Planes (AlphaGo Zero, Methods; as the program documents them): for i = 0
(now) to 7 moves ago, plane 2i holds the stones of the player to move and
plane 2i + 1 the opponent's, zero where the game is shorter; plane 16 is
all ones when black is to move, plane 17 when white is.  Layout NHWC.

Symmetry g = rot + 4 * flip: `rot` quarter turns, each taking (r, c) to
(n - 1 - c, r), then, for flip, the transpose.  A plane is moved so that
the value at point p lands on T_g(p); a policy over the transformed
frame is read back at T_g(p).

Imports torch and numpy alone.
"""

from __future__ import annotations

import numpy as np
import torch

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def d4_table(size: int) -> np.ndarray:
    """int64 [8, n2]: T_g(p)."""
    n = size
    out = np.zeros((8, n * n), np.int64)
    for g in range(8):
        for r in range(n):
            for c in range(n):
                rr, cc = r, c
                for _ in range(g % 4):
                    rr, cc = n - 1 - cc, rr
                if g >= 4:
                    rr, cc = cc, rr
                out[g, r * n + c] = rr * n + cc
    return out


def planes(history: torch.Tensor, valid: torch.Tensor, to_play: torch.Tensor,
           codes: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [K, N, N, 18] from history int8 [K, 8, n2] (newest first), valid
    bool [K, 8], to_play [K] (1 black, 2 white) and codes [K]."""
    K, H, n2 = history.shape
    me = to_play.long()[:, None, None]
    h = history.long()
    mine = ((h == me) & valid[:, :, None]).float()
    theirs = ((h == 3 - me) & valid[:, :, None]).float()
    x = torch.zeros((K, 18, n2), device=history.device)
    x[:, 0:16:2] = mine
    x[:, 1:16:2] = theirs
    x[:, 16] = (to_play.long() == 1).float()[:, None]
    x[:, 17] = (to_play.long() == 2).float()[:, None]
    T = torch.as_tensor(d4_table(size), device=history.device)[codes.long()]
    out = torch.zeros_like(x)
    out.scatter_(2, T[:, None, :].expand(K, 18, n2), x)
    return out.view(K, 18, size, size).permute(0, 2, 3, 1)


def policy_to_frame(pi: torch.Tensor, codes: torch.Tensor,
                    size: int) -> torch.Tensor:
    """A policy over board points (pass last) moved into the frame of each
    row's symmetry: out[T_g(p)] = pi[p]."""
    K, A = pi.shape
    n2 = size * size
    T = torch.as_tensor(d4_table(size), device=pi.device)[codes.long()]
    out = pi.clone()
    out[:, :n2] = 0
    out[:, :n2].scatter_(1, T, pi[:, :n2])
    return out


def policy_from_frame(pi: torch.Tensor, codes: torch.Tensor,
                      size: int) -> torch.Tensor:
    """The inverse: a policy over the transformed frame read at T_g(p)."""
    n2 = size * size
    T = torch.as_tensor(d4_table(size), device=pi.device)[codes.long()]
    out = pi.clone()
    out[:, :n2] = torch.gather(pi[:, :n2], 1, T)
    return out


def moves_to_sgf(moves, size: int) -> str:
    """The record's move string: "(;B[ab];W[cd];...)", a pass as []."""
    out = []
    for i, m in enumerate(moves):
        m = int(m)
        coord = "" if m >= size * size else (LETTERS[m % size]
                                             + LETTERS[m // size])
        out.append(f";{'BW'[i % 2]}[{coord}]")
    return "(" + "".join(out) + ")"


def sgf_to_moves(text: str, size: int) -> list:
    """The moves of a record's move string."""
    out = []
    for tok in text.strip("()").split(";")[1:]:
        coord = tok[2:-1]
        out.append(size * size if not coord else
                   LETTERS.index(coord[1]) * size + LETTERS.index(coord[0]))
    return out


def dequantize(d: dict, num_actions: int) -> np.ndarray:
    """The training target of the record's 8-bit form: q normalised."""
    pi = np.zeros((num_actions,), np.float32)
    if d.get("idx"):
        pi[np.asarray(d["idx"], np.int64)] = np.asarray(d["q"], np.float32)
        pi /= pi.sum()
    return pi
