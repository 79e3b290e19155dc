"""Ladder behavioural suite runner: counterpart of `elf_tpu/tools/ladder.py`.

The reference's `ladder_suite/` (116 SGF ladder scenarios and a
`ladder_list` of (sgf, move-number) probes, README.rst:173): replay a game
to just before the probe move, ask the engine for a move, and compare it
with the move actually played, a ladder-reading scorecard for a model.

`batch_replay` replays many SGF games through the batched engine in
lockstep and reports every move the engine finds illegal, a
rules-compatibility check against real games.  On the card each of its
plies launches the `step_analysis` kernel once; the scorecard's legal mask
launches `analyze_libs`.

The suite directory is read when a function is called, not when it is
defined: `suite_dir=None` means this module's `DEFAULT_SUITE` as it is at
that moment, so a caller can point the module at another suite.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.coords import flat_to_gtp
from elf_tpu_torch.env.go.state import init_state, legal_moves, step
from elf_tpu_torch.sgf import parse_sgf

# the upstream suite's directory (ladder/*.sgf and ladder_list), looked for
# at the root of this checkout
DEFAULT_SUITE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "ladder_suite",
)


def _suite(suite_dir: Optional[str]) -> str:
    return DEFAULT_SUITE if suite_dir is None else suite_dir


def load_suite(suite_dir: Optional[str] = None) -> List[Tuple[str, int]]:
    """[(sgf_path, move_number)] from ladder_list."""
    suite_dir = _suite(suite_dir)
    entries = []
    with open(os.path.join(suite_dir, "ladder_list")) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                entries.append(
                    (os.path.join(suite_dir, "ladder", parts[0]), int(parts[1]))
                )
    return entries


def load_moves(sgf_path: str) -> Tuple[List[int], int]:
    with open(sgf_path) as f:
        game = parse_sgf(f.read())
    return [m for _, m in game.main_moves()], game.board_size


def batch_replay(move_lists: List[List[int]], size: int,
                 device: DeviceLike = "cuda"):
    """Replay many games in lockstep; returns (illegal_mask [B, L] bool
    numpy, final GoState on `device`).  Games shorter than L are padded with
    passes, which are never marked illegal, and their boards stay frozen
    once the game's moves are spent."""
    dev = resolve_device(device)
    B = len(move_lists)
    L = max(len(m) for m in move_lists)
    n2 = size * size
    padded = np.full((B, L), n2, np.int32)
    valid = np.zeros((B, L), bool)
    for i, ms in enumerate(move_lists):
        padded[i, : len(ms)] = ms
        valid[i, : len(ms)] = True
    actions = torch.from_numpy(padded).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)

    state = init_state(B, size, dev)
    illegal = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for t in range(L):
        prev = state
        state, info = step(state, actions[:, t], size)
        illegal[:, t] = info.illegal & valid_t[:, t]
        state = gostate._tree_where(~valid_t[:, t], prev, state)
    return illegal.cpu().numpy(), state


@dataclass
class LadderResult:
    total: int
    matched: int
    failures: List[Tuple[str, int, str, str]]  # (sgf, move#, expected, got)

    @property
    def accuracy(self) -> float:
        return self.matched / self.total if self.total else 0.0


def _result(scored) -> LadderResult:
    """LadderResult of [(sgf_path, n, expected, got, size)]."""
    matched = 0
    failures = []
    for sgf_path, n, expected, got, size in scored:
        if got == expected:
            matched += 1
        else:
            failures.append(
                (os.path.basename(sgf_path), n,
                 flat_to_gtp(expected, size), flat_to_gtp(got, size))
            )
    return LadderResult(
        total=matched + len(failures), matched=matched, failures=failures
    )


def _entries(suite_dir: Optional[str], limit: Optional[int]):
    entries = load_suite(suite_dir)
    return entries[:limit] if limit else entries


def run_ladder_suite(
    gen_move_fn,
    suite_dir: Optional[str] = None,
    limit: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> LadderResult:
    """gen_move_fn(state, size) -> flat action.  For each (sgf, n) probe,
    replay the first n moves on one board and compare the generated move
    with the game's move n (0-based)."""
    dev = resolve_device(device)
    scored = []
    for sgf_path, n in _entries(suite_dir, limit):
        moves, size = load_moves(sgf_path)
        if n >= len(moves):
            continue
        state = init_state(1, size, dev)
        for m in moves[:n]:
            state, _ = step(
                state, torch.tensor([m], dtype=torch.int32, device=dev), size)
        got = int(gen_move_fn(state, size))
        scored.append((sgf_path, n, moves[n], got, size))
    return _result(scored)


def ladder_policy_scorecard(
    eval_fn,
    suite_dir: Optional[str] = None,
    limit: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> LadderResult:
    """Raw-policy scorecard over the whole suite in ONE lockstep batch.

    The probe protocol of `run_ladder_suite` (replay to move n, compare the
    model's move with the game's move n), batched: every probe prefix is
    replayed in one `batch_replay` call and the model is asked once on the
    stacked [B] positions (identity symmetry).  `eval_fn(features,
    to_play)` returns `(log_pi, value)` (the SelfplayActor builder
    contract); the move compared is the legal-masked policy argmax (no
    search)."""
    from elf_tpu_torch.env.go.features import extract_agz

    dev = resolve_device(device)
    probes = []  # (sgf_path, n, prefix_moves, expected, size)
    for sgf_path, n in _entries(suite_dir, limit):
        moves, size = load_moves(sgf_path)
        if n >= len(moves):
            continue
        probes.append((sgf_path, n, moves[:n], moves[n], size))
    if not probes:
        return LadderResult(total=0, matched=0, failures=[])
    size = probes[0][4]
    assert all(p[4] == size for p in probes), "mixed board sizes in suite"

    _, state = batch_replay([p[2] for p in probes], size, dev)
    B = len(probes)
    feats = extract_agz(state, torch.zeros((B,), dtype=torch.int32,
                                           device=dev), size)
    with torch.inference_mode():
        log_pi, _ = eval_fn(feats, state.core.to_play)
    lm = legal_moves(state, size)
    got = torch.argmax(torch.where(lm, log_pi, -1e9), dim=1).cpu().numpy()
    return _result(
        (sgf_path, n, expected, int(got[i]), size)
        for i, (sgf_path, n, _, expected, size) in enumerate(probes)
    )


@dataclass
class SuiteClassification:
    """Model-free structural read of one suite probe."""

    sgf: str
    move_number: int
    played: int
    classification: str   # capture | doomed_escape | none
    depth: int


def classify_suite(
    suite_dir: Optional[str] = None, limit: Optional[int] = None
) -> List[SuiteClassification]:
    """Run the host ladder reader (`native/ladder.py`, the reference's
    checkLadder counterpart) over every ladder_list probe: classify the
    move actually played (move n, 1-based, by the player of ply n - 1) as
    a ladder-capture starter, a doomed escape, or neither.  Model-free:
    this reads the position itself, where `run_ladder_suite` scores a
    model's move choice.  Runs on the host; it builds no tensors."""
    from elf_tpu_torch.native.ladder import read_ladder
    from elf_tpu_torch.native.replayer import replay_to_snapshots

    out = []
    for sgf_path, n in _entries(suite_dir, limit):
        moves, size = load_moves(sgf_path)
        if n - 1 >= len(moves):
            continue
        snaps = replay_to_snapshots(moves[: n - 1], size)
        board = snaps[-1] if n > 1 else np.zeros(size * size, np.int8)
        mv = moves[n - 1]
        player = 1 if (n - 1) % 2 == 0 else 2
        cls, depth = read_ladder(board, mv, player, size)
        out.append(SuiteClassification(
            sgf=os.path.basename(sgf_path), move_number=n, played=mv,
            classification=cls, depth=depth,
        ))
    return out
