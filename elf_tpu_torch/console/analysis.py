"""SGF analysis mode: per-move suggestions and search-tree dumps; the port's
counterpart of `elf_tpu/console/analysis.py` (the reference's
`analysis.sh`, README.rst:153-166).

Preload an SGF (`preload_sgf`, `preload_sgf_move_to`), then search move by
move, printing the suggested move with its value and prior at every
position and writing one tree file per move under `dump_record_prefix`
(`GoStateExt::saveCurrentTree`, go_state_ext.h:158; the content of
`SearchTreeT::printTree`, tree_search_node.h:484).

Two continuations:
  self-play (the reference's): after the preload the engine plays both
      sides to the end of the game;
  follow: step through the record's remaining moves, reporting the
      engine's suggestion at each position.

Runs the B = 1 search of the GTP console with persistent tree reuse, on
`device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional, TextIO

import torch

from elf_tpu_torch.console.gtp import ladder_read, play_search, sync
from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.coords import flat_to_gtp
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.env.go.state import init_state, step
from elf_tpu_torch.search.mcts import MCTSConfig, advance_tree, check_supported
from elf_tpu_torch.search.tree_dump import render_tree, top_moves
from elf_tpu_torch.sgf import parse_sgf


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Same fields and defaults as the JAX AnalysisConfig."""

    preload_sgf: str = ""
    preload_sgf_move_to: int = -1   # -1 = whole record
    dump_record_prefix: str = ""    # write <prefix>_0_<ply>.tree per move
    follow_sgf: bool = False        # follow the record instead of self-play
    max_moves: int = 0              # 0 = to the end of the game
    komi: float = 7.5
    top_k: int = 5
    verbose: bool = False
    persistent_tree: bool = True


class AnalysisDriver:
    """Single-game analysis loop over the engine at B = 1."""

    def __init__(self, eval_fn_builder, mcts_cfg: MCTSConfig,
                 cfg: AnalysisConfig, size: int = 19, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        check_supported(mcts_cfg)
        self.eval_fn_builder = eval_fn_builder
        self.mcts_cfg = mcts_cfg
        self.cfg = cfg
        self.size = size
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.eval_fn = None
        self.state = init_state(1, size, self.device)
        self.tree = None
        self.sgf_moves: List[int] = []
        self.start_ply = 0
        # one entry per analysed position (play_search), with the seconds
        # of the whole position: search, report, dump and move
        # (`position_s`)
        self.searches: List[dict] = []

    def set_model(self, params, batch_stats) -> None:
        self.eval_fn = self.eval_fn_builder(params, batch_stats)

    def _step(self, action: int) -> None:
        self.state, _ = step(
            self.state, torch.tensor([action], dtype=torch.int32,
                                     device=self.device), self.size)

    # -- position setup ----------------------------------------------------
    def load_sgf(self) -> None:
        if not self.cfg.preload_sgf:
            return
        with open(self.cfg.preload_sgf) as f:
            game = parse_sgf(f.read())
        if game.board_size != self.size:
            raise ValueError(
                f"SGF board size {game.board_size} != engine size {self.size}")
        self.sgf_moves = [m for _, m in game.main_moves()]
        upto = self.cfg.preload_sgf_move_to
        if upto < 0:
            # -1: the whole record before a self-play continuation (the
            # reference default); from the start when following it
            upto = 0 if self.cfg.follow_sgf else len(self.sgf_moves)
        upto = min(upto, len(self.sgf_moves))
        for a in self.sgf_moves[:upto]:
            self._step(a)
        self.start_ply = upto

    # -- search ------------------------------------------------------------
    def analyze_position(self):
        """One search at the current position; returns (action, root_q,
        suggestions, tree)."""
        res, self.tree = play_search(self.state, self.tree, self.eval_fn,
                                     self.gen, self.mcts_cfg, self.size,
                                     self.searches)
        action = int(res.best_action[0])
        root_q = float(res.root_q[0])
        suggestions = top_moves(self.tree, 0, self.size, k=self.cfg.top_k)
        return action, root_q, suggestions, self.tree

    def _play(self, action: int) -> None:
        self._step(action)
        if self.cfg.persistent_tree and self.tree is not None:
            self.tree = advance_tree(
                self.tree, torch.tensor([action], dtype=torch.int32,
                                        device=self.device),
                self.state.core, self.size, self.tree.stones.shape[1])
        else:
            self.tree = None

    def _ladder_annotation(self, played: int, mover: int) -> Optional[dict]:
        """Model-free ladder read of the move about to be played (the
        checkLadder counterpart, csrc/ladder.c): flags moves that start a
        working ladder or flee into one."""
        if played >= self.size * self.size:
            return None
        cls, depth = ladder_read(self.state, played, mover, self.size)
        if cls == "none":
            return None
        return {"type": cls, "depth": depth}

    def _dump_tree(self, ply: int, tree) -> Optional[str]:
        if not self.cfg.dump_record_prefix:
            return None
        path = f"{self.cfg.dump_record_prefix}_0_{ply}.tree"
        with open(path, "w") as f:
            f.write(render_tree(tree, 0, self.size))
        return path

    # -- the loop ----------------------------------------------------------
    def run(self, out: Optional[TextIO] = None) -> List[dict]:
        """Analyse move by move; returns one report dict per analysed ply."""
        out = out or sys.stdout
        self.load_sgf()
        reports: List[dict] = []
        ply = self.start_ply
        remaining = self.sgf_moves[self.start_ply:] if self.cfg.follow_sgf else []
        while True:
            if bool(self.state.terminated[0]):
                break
            if self.cfg.max_moves and len(reports) >= self.cfg.max_moves:
                break
            if self.cfg.follow_sgf and not remaining:
                break
            t0 = time.perf_counter()
            mover = int(self.state.core.to_play[0])
            action, root_q, suggestions, tree = self.analyze_position()
            mover_v = root_q if mover == BLACK else -root_q
            tree_path = self._dump_tree(ply, tree)
            played = remaining.pop(0) if self.cfg.follow_sgf else action
            rep = {
                "ply": ply,
                "to_play": "B" if mover == BLACK else "W",
                "suggested": flat_to_gtp(action, self.size),
                "value": round(mover_v, 4),
                "prior": round(float(self.tree.prior[0, 0, action]), 4),
                "played": flat_to_gtp(played, self.size),
                "top": suggestions,
            }
            if tree_path:
                rep["tree_file"] = tree_path
            ladder = self._ladder_annotation(played, mover)
            if ladder:
                rep["ladder"] = ladder
            reports.append(rep)
            line = (
                f"{rep['ply']:3d} {rep['to_play']} suggest {rep['suggested']}"
                f" V {rep['value']:+.3f} prior {rep['prior']:.3f}"
                f" played {rep['played']}"
            )
            if self.cfg.verbose:
                tops = " ".join(
                    f"{t['move']}(n={t['n']},q={t['q']:.2f})"
                    for t in rep["top"]
                )
                line += f"  | {tops}"
            print(line, file=out, flush=True)
            self._play(played)
            sync(self.device)
            self.searches[-1]["position_s"] = time.perf_counter() - t0
            ply += 1
        score = float(gostate.evaluate(self.state, self.size,
                                       self.cfg.komi)[0])
        result = f"B+{score:.1f}" if score > 0 else f"W+{-score:.1f}"
        print(f"final_score {result}", file=out, flush=True)
        return reports
