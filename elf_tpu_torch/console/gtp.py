"""GTP (Go Text Protocol) console: the port's play surface, counterpart of
`elf_tpu/console/gtp.py` (reference `df_console.py` + `console_lib.py:207`,
GoConsoleGTP).

A single-game driver: the human side arrives over GTP (`play`), the engine
side is a B = 1 search with the policy/value net (`genmove`).  Both liberty
kernels run at B = 1 on the card: `step_analysis` at every tree expansion
and every played move, `analyze_libs` for the legality check of `play` and
the legal mask of a search root that is not expanded yet.

Commands: protocol_version, name, version, known_command, list_commands,
quit, boardsize, clear_board, komi, play, genmove, undo, final_score,
showboard, final_status_list, time_settings, kgs-time_settings, time_left,
kgs-game_over and the `elf-ladder` extension.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import List, Optional, Tuple

import numpy as np
import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.coords import flat_to_gtp, gtp_to_flat
from elf_tpu_torch.env.go.engine import BLACK, WHITE
from elf_tpu_torch.env.go.state import init_state, legal_moves, step
from elf_tpu_torch.native.ladder import read_ladder
from elf_tpu_torch.search.mcts import (
    MCTSConfig,
    advance_tree,
    check_supported,
    fresh_tree,
    run_mcts,
)


def ladder_read(state: gostate.GoState, move: int, color: int, size: int):
    """`read_ladder` of `move` by `color` on board 0 of `state`, with its
    ko point where a ko is active."""
    core = state.core
    ko_point = int(core.ko_point[0])
    ko_active = int(core.ko_age[0]) == 0 and ko_point >= 0
    return read_ladder(core.stones[0].cpu().numpy(), move, color, size,
                       ko_point if ko_active else -1, int(core.ko_color[0]))


def edge_visits(tree, node: int) -> int:
    """Visits on the edges of `node` in board 0's tree."""
    child = tree.child[0, node].long()
    return int(torch.where(child >= 0, tree.n[0, child.clamp(min=0)],
                           0).sum())


def play_search(state: gostate.GoState, tree, eval_fn, gen: torch.Generator,
                cfg: MCTSConfig, size: int, log: List[dict]):
    """One B = 1 search at `state` from `tree` (a fresh tree where it is
    None), searched on in place.  Appends to `log` one entry: the search's
    seconds (`search_s`, the device synchronised), whether the root was
    expanded already (`root_reused`: then it is not evaluated and its legal
    mask not computed) and the visits on its edges that the tree carried
    into the search (`carried_visits`).  Returns (MCTSResult, tree)."""
    dev = state.core.stones.device
    if tree is None:
        tree = fresh_tree(1, size, max(cfg.max_nodes or
                                       (2 * cfg.num_rollouts + 2), 3),
                          state.core)
    entry = {"root_reused": bool(tree.expanded[0, 0]),
             "carried_visits": edge_visits(tree, 0)}
    t0 = time.perf_counter()
    with torch.no_grad():
        res, tree = run_mcts(
            state.core, state.stone_hist, state.hist_len, eval_fn, gen, cfg,
            size, init_tree=tree,
            game_hash_hist=(state.hash_hist_lo, state.hash_hist_hi,
                            state.nhash),
            root_last_placed=(state.last_placed
                              if cfg.feature_set == "df" else None),
            device=dev)
    sync(dev)
    entry["search_s"] = time.perf_counter() - t0
    log.append(entry)
    return res, tree


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GtpEngine:
    """Single-game state and move generation by MCTS, on `device`."""

    def __init__(self, eval_fn_builder, mcts_cfg: MCTSConfig,
                 size: int = 19, komi: float = 7.5, seed: int = 0,
                 persistent_tree: bool = True, following_pass: bool = False,
                 resign_thres: float = 0.05, device: DeviceLike = "cuda"):
        """eval_fn_builder(params, batch_stats) -> eval_fn(features, to_play),
        built again by each `set_model`."""
        self.device = resolve_device(device)
        check_supported(mcts_cfg)
        self.eval_fn_builder = eval_fn_builder
        self.mcts_cfg = mcts_cfg
        self.komi = komi
        # resign when the mover's value < -1 + resign_thres (ResignCheck,
        # game_utils.h:15); 0 never resigns
        self.resign_thres = resign_thres
        self.eval_fn = None
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # reuse the played line's subtree across genmove / play (treeAdvance)
        self.persistent_tree = persistent_tree
        # answer an opponent's pass with a pass when clearly winning
        # (following_pass, game_selfplay.cc:106)
        self.following_pass = following_pass
        self.tree = None
        # the visits below the last played move in the tree before it was
        # advanced: what the next search must find on its root's edges
        self.expected_carry = 0
        # one entry per genmove search (play_search), with `moved` (the
        # move was played, not a resignation), the seconds of the whole
        # genmove (`genmove_s`) and `expected_carry`
        self.searches: List[dict] = []
        self.reset(size)

    def set_model(self, params, batch_stats) -> None:
        self.eval_fn = self.eval_fn_builder(params, batch_stats)

    def reset(self, size: Optional[int] = None) -> None:
        if size is not None:
            self.size = size
        self.state = init_state(1, self.size, self.device)
        self.history: List[gostate.GoState] = [self.state]
        self.tree = None
        self.expected_carry = 0

    def _force_to_play(self, want: int) -> None:
        """GTP allows moves out of turn: set the player to move."""
        if int(self.state.core.to_play[0]) != want:
            self.state = self.state._replace(core=self.state.core._replace(
                to_play=torch.full((1,), want, dtype=torch.int8,
                                   device=self.device)))

    def _advance(self, action: int) -> None:
        """Carry the search tree across the played move."""
        if not self.persistent_tree or self.tree is None:
            self.tree = None
            self.expected_carry = 0
            return
        c = int(self.tree.child[0, 0, action])
        self.expected_carry = edge_visits(self.tree, c) if c >= 0 else 0
        self.tree = advance_tree(
            self.tree, torch.tensor([action], dtype=torch.int32,
                                    device=self.device),
            self.state.core, self.size, self.tree.stones.shape[1])

    def play(self, color: str, vertex: str) -> bool:
        a = gtp_to_flat(vertex, self.size)
        self._force_to_play(BLACK if color.lower().startswith("b") else WHITE)
        if not bool(legal_moves(self.state, self.size)[0, a]):
            return False
        self.state, info = step(
            self.state, torch.tensor([a], dtype=torch.int32,
                                     device=self.device), self.size)
        if bool(info.illegal[0]):
            return False
        self.history.append(self.state)
        self._advance(a)
        return True

    def genmove(self, color: str) -> str:
        t0 = time.perf_counter()
        want = BLACK if color.lower().startswith("b") else WHITE
        self._force_to_play(want)
        if bool(self.state.terminated[0]):
            return "pass"
        res, self.tree = play_search(self.state, self.tree, self.eval_fn,
                                     self.gen, self.mcts_cfg, self.size,
                                     self.searches)
        self.searches[-1].update(moved=False,
                                 expected_carry=self.expected_carry)
        a = int(res.best_action[0])
        v = float(res.root_q[0])
        mover_v = v if want == BLACK else -v
        if self.resign_thres > 0 and mover_v < -1.0 + self.resign_thres:
            return "resign"
        if (self.following_pass
                and int(self.state.core.last_move[0]) == self.size * self.size
                and mover_v > 0.9):
            score = float(gostate.evaluate(self.state, self.size,
                                           self.komi)[0])
            if (score if want == BLACK else -score) > 0:
                a = self.size * self.size      # follow the pass and win
        self.state, _ = step(
            self.state, torch.tensor([a], dtype=torch.int32,
                                     device=self.device), self.size)
        self.history.append(self.state)
        self._advance(a)
        sync(self.device)
        self.searches[-1].update(moved=True,
                                 genmove_s=time.perf_counter() - t0)
        return flat_to_gtp(a, self.size)

    def undo(self) -> bool:
        if len(self.history) < 2:
            return False
        self.history.pop()
        self.state = self.history[-1]
        self.tree = None  # the tree no longer matches the position
        self.expected_carry = 0
        return True

    def final_score(self) -> str:
        v = float(gostate.evaluate(self.state, self.size, self.komi)[0])
        if v > 0:
            return f"B+{v:.1f}"
        if v < 0:
            return f"W+{-v:.1f}"
        return "0"

    def showboard(self) -> str:
        stones = self.state.core.stones[0].cpu().numpy().reshape(
            self.size, self.size)
        sym = {0: ".", 1: "X", 2: "O"}
        cols = "ABCDEFGHJKLMNOPQRSTUVWXYZ"[: self.size]
        lines = ["   " + " ".join(cols)]
        for r in range(self.size):
            row = " ".join(sym[int(x)] for x in stones[r])
            lines.append(f"{self.size - r:2d} {row} {self.size - r}")
        lines.append("   " + " ".join(cols))
        return "\n".join(lines)


class GtpConsole:
    """GTP framing loop over stdio (console_lib.py command dispatch)."""

    COMMANDS = [
        "protocol_version", "name", "version", "known_command",
        "list_commands", "quit", "boardsize", "clear_board", "komi",
        "play", "genmove", "undo", "final_score", "showboard",
        "final_status_list", "time_settings", "kgs-time_settings",
        "time_left", "kgs-game_over", "elf-ladder",
    ]

    def __init__(self, engine: GtpEngine, name: str = "elf_tpu",
                 version: str = "0.1"):
        self.engine = engine
        self.name = name
        self.version = version
        self.done = False

    def handle(self, line: str) -> Optional[str]:
        line = line.split("#")[0].strip()
        if not line:
            return None
        parts = line.split()
        cmd_id = ""
        if parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
        if not parts:
            return None
        cmd, args = parts[0].lower(), parts[1:]
        try:
            ok, payload = self._dispatch(cmd, args)
        except Exception as e:  # noqa: BLE001
            # any failure answers "? <message>" and the console goes on, as
            # the JAX console does; a fault's traceback goes to stderr
            if not isinstance(e, (ValueError, IndexError, KeyError)):
                traceback.print_exc(file=sys.stderr)
            ok, payload = False, str(e)
        prefix = "=" if ok else "?"
        head = f"{prefix}{cmd_id}" if cmd_id else prefix
        return f"{head} {payload}".rstrip() + "\n"

    def _dispatch(self, cmd: str, args: List[str]) -> Tuple[bool, str]:
        e = self.engine
        if cmd == "protocol_version":
            return True, "2"
        if cmd == "name":
            return True, self.name
        if cmd == "version":
            return True, self.version
        if cmd == "known_command":
            return True, "true" if args and args[0] in self.COMMANDS else "false"
        if cmd == "list_commands":
            return True, "\n".join(self.COMMANDS)
        if cmd == "quit":
            self.done = True
            return True, ""
        if cmd == "boardsize":
            size = int(args[0])
            if size not in (5, 7, 9, 13, 19):
                return False, "unacceptable size"
            e.reset(size)
            return True, ""
        if cmd == "clear_board":
            e.reset()
            return True, ""
        if cmd == "komi":
            e.komi = float(args[0])
            return True, ""
        if cmd == "play":
            if len(args) < 2:
                return False, "syntax error"
            if not e.play(args[0], args[1]):
                return False, "illegal move"
            return True, ""
        if cmd == "genmove":
            if not args:
                return False, "syntax error"
            return True, e.genmove(args[0])
        if cmd == "undo":
            return (True, "") if e.undo() else (False, "cannot undo")
        if cmd == "final_score":
            return True, e.final_score()
        if cmd == "showboard":
            return True, "\n" + e.showboard()
        if cmd == "final_status_list":
            # Tromp-Taylor scoring counts every stone alive: "dead" and
            # "seki" are empty, "alive" lists the stones
            what = args[0].lower() if args else "dead"
            if what in ("dead", "seki"):
                return True, ""
            if what == "alive":
                stones = e.state.core.stones[0].cpu().numpy()
                return True, " ".join(flat_to_gtp(int(i), e.size)
                                      for i in np.nonzero(stones)[0])
            return False, "syntax error"
        if cmd in ("time_settings", "kgs-time_settings", "time_left"):
            # accepted and ignored: the search has a fixed rollout budget
            self.time_settings = args
            return True, ""
        if cmd == "kgs-game_over":
            return True, ""
        if cmd == "elf-ladder":
            # model-free ladder read of <color> <vertex> (csrc/ladder.c, the
            # checkLadder counterpart): "capture <depth>",
            # "doomed_escape <depth>" or "none"
            if len(args) < 2:
                return False, "syntax error"
            color = BLACK if args[0].lower().startswith("b") else WHITE
            mv = gtp_to_flat(args[1], e.size)
            if mv is None or mv >= e.size * e.size:
                return False, "invalid vertex"
            cls, depth = ladder_read(e.state, mv, color, e.size)
            return True, "none" if cls == "none" else f"{cls} {depth}"
        return False, "unknown command"

    def run(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            resp = self.handle(line)
            if resp is not None:
                stdout.write(resp + "\n")
                stdout.flush()
            if self.done:
                return
