"""A plain Go engine in PyTorch: the benchmark's reference for the rules.

Written from the rules, not from the program: chains are labelled by
min-label propagation with pointer jumping, liberties are found per chain
by scatter reductions, and a move is judged and applied board by board in
one batch.  The rules are those the program states: simple ko (the point
of a single captured stone is forbidden to the next player for one move
when the capturing stone stands alone with one liberty), suicide illegal,
a pass always legal, black first.

A position is a dict of tensors over K boards:
  stones  int8  [K, n2]  0 empty, 1 black, 2 white
  to_play int8  [K]      1 or 2
  ko      long  [K]      the point `to_play` may not take now, or -1
  ply     long  [K]      moves played
  passes  long  [K]      consecutive passes

Imports torch alone; runs on whatever device the tensors live on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EMPTY, BLACK, WHITE = 0, 1, 2


def _nbrs(x: torch.Tensor, size: int, fill) -> list:
    """The four neighbour values of every point of x [K, n2], `fill` off the
    board: [up, down, left, right], each [K, n2]."""
    K = x.shape[0]
    p = F.pad(x.view(K, size, size), (1, 1, 1, 1), value=fill)
    return [v.reshape(K, size * size) for v in (
        p[:, :-2, 1:-1], p[:, 2:, 1:-1], p[:, 1:-1, :-2], p[:, 1:-1, 2:])]


def chain_libs(stones: torch.Tensor, size: int):
    """(label, nlib) for every point of stones int8 [K, n2]: label long [K, n2]
    is the smallest point of the point's chain (n2 on empty points); nlib is
    the chain's liberty class, 0, 1 or 2 (two or more); 0 on empty points."""
    K, n2 = stones.shape
    s = stones.long()
    dev = stones.device
    idx = torch.arange(n2, device=dev).expand(K, n2)
    stone = s != EMPTY
    lab = torch.where(stone, idx, n2)
    same = [(c == s) & stone for c in _nbrs(s, size, -1)]
    pad = torch.full((K, 1), n2, dtype=torch.long, device=dev)
    while True:
        new = lab
        for sm, nl in zip(same, _nbrs(lab, size, n2)):
            new = torch.where(sm, torch.minimum(new, nl), new)
        new = torch.minimum(new, torch.gather(torch.cat([new, pad], 1), 1, new))
        if torch.equal(new, lab):
            break
        lab = new
    # smallest and largest liberty of each chain, kept at its label
    big = n2 + 1
    lo = torch.full((K, n2 + 1), big, dtype=torch.long, device=dev)
    hi = torch.full((K, n2 + 1), -1, dtype=torch.long, device=dev)
    for ne, ni in zip(_nbrs(s == EMPTY, size, False), _nbrs(idx, size, 0)):
        ok = ne & stone
        lo.scatter_reduce_(1, lab, torch.where(ok, ni, big), "amin")
        hi.scatter_reduce_(1, lab, torch.where(ok, ni, -1), "amax")
    lo_p, hi_p = torch.gather(lo, 1, lab), torch.gather(hi, 1, lab)
    nlib = torch.where(lo_p > n2, 0, torch.where(lo_p == hi_p, 1, 2))
    return lab, torch.where(stone, nlib, 0)


def legal_mask(pos: dict, size: int) -> torch.Tensor:
    """bool [K, n2 + 1]: the moves `to_play` may make (pass last, always)."""
    s = pos["stones"].long()
    K, n2 = s.shape
    _, nlib = chain_libs(pos["stones"], size)
    me = pos["to_play"].long()[:, None]
    empty = s == EMPTY
    ok = torch.zeros_like(empty)
    for c, nl in zip(_nbrs(s, size, -1), _nbrs(nlib, size, 0)):
        ok |= (c == EMPTY)                      # a liberty of its own
        ok |= (c == me) & (nl == 2)             # joins a chain that keeps one
        ok |= (c == 3 - me) & (nl == 1)         # captures
    pts = torch.arange(n2, device=s.device)[None, :]
    ok &= empty & (pts != pos["ko"][:, None])
    return torch.cat([ok, torch.ones((K, 1), dtype=torch.bool,
                                     device=s.device)], 1)


def step(pos: dict, action: torch.Tensor, size: int, legal=None,
         ko_rule: bool = True):
    """(next position, legal [K]).  An illegal move leaves its board as it
    was (the returned position is then not meaningful for that board).
    `legal`: the position's `legal_mask`, where the caller has it.
    `ko_rule=False` never makes a ko (a broken rule, for the control)."""
    s = pos["stones"].long()
    K, n2 = s.shape
    dev = s.device
    a = action.long()
    rows = torch.arange(K, device=dev)
    is_pass = a >= n2
    p = a.clamp(0, n2 - 1)
    me = pos["to_play"].long()
    if legal is None:
        legal = legal_mask(pos, size)
    legal = is_pass | legal[rows, p]
    place = ~is_pass & legal
    pts = torch.arange(n2, device=dev)[None, :]
    at = (pts == p[:, None]) & place[:, None]
    s1 = torch.where(at, me[:, None], s)
    _, nlib = chain_libs(s1.to(torch.int8), size)
    cap = (s1 == (3 - me)[:, None]) & (nlib == 0)
    s2 = torch.where(cap, EMPTY, s1)
    ncap = cap.sum(1)
    # ko: one stone taken by a lone stone that is left with one liberty
    _, nlib2 = chain_libs(s2.to(torch.int8), size)
    friends = sum((c == me[:, None]).long() for c in _nbrs(s2, size, -1))
    lone = friends[rows, p] == 0
    ko_made = place & (ncap == 1) & lone & (nlib2[rows, p] == 1) & ko_rule
    new = {
        "stones": s2.to(torch.int8),
        "to_play": torch.where(legal, 3 - me, me).to(torch.int8),
        "ko": torch.where(ko_made, cap.long().argmax(1), -1),
        "ply": pos["ply"] + legal.long(),
        "passes": torch.where(is_pass, pos["passes"] + 1,
                              torch.where(place, 0, pos["passes"])),
    }
    return new, legal


def empty_position(K: int, size: int, device) -> dict:
    z = torch.zeros((K,), dtype=torch.long, device=device)
    return {"stones": torch.zeros((K, size * size), dtype=torch.int8,
                                  device=device),
            "to_play": torch.full((K,), BLACK, dtype=torch.int8,
                                  device=device),
            "ko": z - 1, "ply": z.clone(), "passes": z.clone()}


def same_position(a: dict, b: dict) -> torch.Tensor:
    """bool [K]: the two positions agree in every field."""
    ok = (a["stones"] == b["stones"]).all(1)
    for k in ("to_play", "ko", "ply", "passes"):
        ok &= a[k].long() == b[k].long()
    return ok
