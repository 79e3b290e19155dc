"""Lockstep self-play actor: counterpart of `elf_tpu/selfplay/actor.py`
(reference `game_selfplay.cc`).  B games advance together, one batched
search per ply:

 - MCTS with Dirichlet root noise (selfplay) / none (eval), or the raw net
   policy when `num_rollouts <= 0`;
 - diverse move sampling from the visit distribution while ply <=
   policy_distri_cutoff, the search's best move after
   (game_selfplay.cc:80);
 - resign when the mover-perspective value < -1 + resign_thres unless the
   game drew its never-resign flag (game_utils.h:15);
 - env step + termination (two passes / max moves / superko).

Finished games become protocol Records (and, with `dump_record_prefix`,
SGF files) and their boards restart in place; `apply_ts_options` takes the
search options a server sends.  With `persistent_tree` each board's search
tree carries the played move's subtree into the next move (`advance_tree`)
and restarts with its game (`reset_tree_where`); with `preload_sgf` every
game starts from the record's position.  With `max_batches_per_call` a
search runs as prepare, `mcts_simulate` calls of at most that many
simulation batches, then finalize (`run_mcts`; the JAX actor's
host-chunked search): the same draws in the same order, so the same move
as one call.  With
`feature_set="df"` the net reads df-25 planes.  Not ported yet: mesh
sharding.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go import engine, features
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.env.go.state import GoState, _tree_where, init_state, step
from elf_tpu_torch.search.mcts import (
    MCTSConfig,
    MCTSResult,
    advance_tree,
    check_supported,
    fresh_tree,
    gumbel_categorical,
    reset_tree_where,
    run_mcts,
)
from elf_tpu_torch.selfplay.records import MsgRequest, Record, make_record
from elf_tpu_torch.sgf import game_from_moves, parse_sgf, serialize_sgf

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    """Same fields and defaults as the JAX ActorConfig."""

    board_size: int = 19
    batch: int = 64
    komi: float = 7.5
    policy_distri_cutoff: int = 30
    resign_thres: float = 0.05
    never_resign_prob: float = 0.1
    cheat_selfplay_random_result: bool = False
    dump_record_prefix: str = ""
    handicap: int = 0
    persistent_tree: bool = False
    move_cutoff: int = -1
    num_games_per_thread: int = -1
    preload_sgf: str = ""
    preload_sgf_move_to: int = -1
    policy_distri_training_for_all: bool = False
    following_pass: bool = False


def make_pair_eval_builder(eval_raw):
    """Two-model evaluator for eval games (candidate vs baseline,
    ctrl_eval.h): params / batch_stats are (black_model, white_model)
    pairs, `eval_raw(params, batch_stats, feats)` is
    `Trainer.make_eval_fn()`; each MCTS leaf is routed to the mover's net.
    Lockstep-friendly at twice the NN cost."""

    def build(params, batch_stats):
        p_black, p_white = params
        b_black, b_white = batch_stats

        def eval_fn(feats, to_play):
            lp_b, v_b = eval_raw(p_black, b_black, feats)
            lp_w, v_w = eval_raw(p_white, b_white, feats)
            is_black = to_play == BLACK
            return (
                torch.where(is_black[:, None], lp_b, lp_w),
                torch.where(is_black, v_b, v_w),
            )

        return eval_fn

    return build


def _maybe_follow_pass(cfg: ActorConfig, state: GoState, action, v, size: int):
    """following_pass (game_selfplay.cc:106): answer an opponent pass with
    a pass when the TT score favors the mover and the mover-perspective
    search value > 0.9."""
    if not cfg.following_pass:
        return action
    n2 = size * size
    pre_score = engine.score_tromp_taylor(state.core, size).float() - cfg.komi
    is_black = state.core.to_play == BLACK
    we_good = torch.where(is_black, (pre_score > 0) & (v > 0.9),
                          (pre_score < 0) & (v < -0.9))
    last_pass = state.core.last_move == n2
    return torch.where(we_good & last_pass & ~state.terminated,
                       torch.full_like(action, n2), action)


class MoveOutput(NamedTuple):
    action: torch.Tensor           # i32 [B]
    mcts_policy: torch.Tensor      # f32 [B, A]
    predicted_value: torch.Tensor  # f32 [B] black perspective (root search value)
    resign: torch.Tensor           # bool [B] mover resigns before this move
    terminated: torch.Tensor       # bool [B] game over after this move
    final_score: torch.Tensor      # f32 [B] evaluate() of the post-move state


class SelfplayActor:
    def __init__(
        self,
        cfg: ActorConfig,
        mcts_cfg: MCTSConfig,
        eval_fn_builder: Callable[..., Any],
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        """eval_fn_builder(params, batch_stats) -> eval_fn(features, to_play);
        see `models.resnet.eval_fn_builder` for a torch net."""
        self.device = resolve_device(device)
        check_supported(mcts_cfg)
        self.cfg = cfg
        self.mcts_cfg = dataclasses.replace(mcts_cfg, komi=cfg.komi)
        self.eval_fn_builder = eval_fn_builder
        self.size = cfg.board_size
        self.n2 = self.size * self.size
        self.A = self.n2 + 1
        # host draws (never-resign flags, cheat results) as in the JAX actor
        self.rng = np.random.RandomState(seed)
        # device draws (D4 codes, Dirichlet noise, move sampling)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        B = cfg.batch
        self._fresh_state = self._make_fresh_state(B)
        self.state = self._fresh_state
        stones0 = self._fresh_state.core.stones[0].cpu().numpy()
        self._first_player = int(self._fresh_state.core.to_play[0])
        self._setup_black = np.nonzero(stones0 == 1)[0].tolist()
        self._setup_white = np.nonzero(stones0 == 2)[0].tolist()
        self.resign_thres = cfg.resign_thres
        self.never_resign_prob = cfg.never_resign_prob
        self.never_resign = self.rng.rand(B) < cfg.never_resign_prob
        self.moves: List[List[int]] = [[] for _ in range(B)]
        self.policies: List[List[Optional[np.ndarray]]] = [[] for _ in range(B)]
        self.values: List[List[float]] = [[] for _ in range(B)]
        self.seqs = np.zeros(B, np.int64)
        self.completed_games = 0
        self.reward_override_fn = None
        self.using_models: List[List[int]] = [[] for _ in range(B)]
        # ClientCtrl.num_game_thread_used: boards >= this index are frozen
        self.active_boards: Optional[int] = None
        self._dump_count = 0
        # the persistent search trees, made at the first move
        self.tree = None
        # host seconds of each `mcts_simulate` call of the last search
        self.simulate_s: List[float] = []

    def _start_state(self, B: int) -> GoState:
        state = init_state(B, self.size, self.device)
        if self.cfg.handicap:
            state = gostate.apply_handicap(state, self.cfg.handicap, self.size)
        return state

    def _make_fresh_state(self, B: int) -> GoState:
        """The position every game starts from: handicap stones, then the
        preloaded record's moves (go_game_specific.h:76-77)."""
        cfg = self.cfg
        state = self._start_state(B)
        if cfg.preload_sgf:
            with open(cfg.preload_sgf) as f:
                game = parse_sgf(f.read())
            moves = [m for _, m in game.main_moves()]
            if cfg.preload_sgf_move_to >= 0:
                moves = moves[: cfg.preload_sgf_move_to]
            for mv in moves:
                state, _ = step(state, torch.full((B,), mv, dtype=torch.int32,
                                                  device=self.device),
                                self.size)
        return state

    def set_active_boards(self, n: Optional[int]) -> None:
        """Freeze board slots >= n (ClientCtrl.num_game_thread_used)."""
        self.active_boards = (
            n if n is not None and 0 <= n < self.cfg.batch else None
        )

    def apply_ts_options(self, ts) -> bool:
        """Apply server-sent MCTS options (a records.TSOptions inside
        ModelPair, model_pair.h:10): rollout budget, noise, puct, pick
        method, persistent tree.  Returns True when the search
        configuration changed (the trees then start afresh)."""
        new_mcfg = dataclasses.replace(
            self.mcts_cfg, komi=self.cfg.komi, **ts.as_mcts_kwargs()
        )
        new_cfg = dataclasses.replace(
            self.cfg, persistent_tree=bool(ts.persistent_tree))
        if new_mcfg == self.mcts_cfg and new_cfg == self.cfg:
            return False
        check_supported(new_mcfg)
        self.mcts_cfg = new_mcfg
        self.cfg = new_cfg
        self.tree = None
        return True

    def finished_all(self) -> bool:
        n = self.cfg.num_games_per_thread
        return n > 0 and bool((self.seqs >= n).all())

    # ------------------------------------------------------------- one move

    def _policy_only(self, state: GoState, eval_fn) -> MCTSResult:
        """actPolicyOnly: the raw net policy over legal moves, no search."""
        size = self.size
        B = state.core.stones.shape[0]
        if self.mcts_cfg.rotation_flip:
            codes = torch.randint(0, 8, (B,), generator=self.gen,
                                  device=self.device)
        else:
            codes = torch.zeros((B,), dtype=torch.long, device=self.device)
        if self.mcts_cfg.feature_set == "df":
            feats = features.extract_df(state, codes, size)
        else:
            feats = features.extract_agz(state, codes, size)
        log_pi, value = eval_fn(feats, state.core.to_play)
        pi = features.inv_transform_policy(torch.exp(log_pi.float()), codes,
                                           size)
        pi = torch.where(gostate.legal_moves(state, size), pi, 0.0)
        pi = pi / pi.sum(dim=1, keepdim=True).clamp(min=1e-10)
        best = torch.argmax(pi, dim=1).to(torch.int32)
        value = value.float()
        return MCTSResult(mcts_policy=pi, best_action=best, root_value=value,
                          root_q=value)

    def _search(self, state: GoState, eval_fn):
        """One `run_mcts` over every board (on the persistent trees where
        they are on), recording the host seconds of each simulate call.
        Returns (MCTSResult, tree)."""
        cfg, mcfg, size = self.cfg, self.mcts_cfg, self.size
        if cfg.persistent_tree and self.tree is None:
            capacity = mcfg.max_nodes or (
                2 * max(mcfg.num_rollouts, mcfg.white_num_rollouts) + 2)
            self.tree = fresh_tree(state.core.stones.shape[0], size,
                                   max(capacity, 3), state.core)
        self.simulate_s = []
        return run_mcts(
            state.core, state.stone_hist, state.hist_len, eval_fn, self.gen,
            mcfg, size, init_tree=self.tree if cfg.persistent_tree else None,
            game_hash_hist=(state.hash_hist_lo, state.hash_hist_hi,
                            state.nhash),
            root_last_placed=(state.last_placed
                              if mcfg.feature_set == "df" else None),
            device=self.device, simulate_s=self.simulate_s)

    def _move(self, state: GoState, eval_fn, never_resign: torch.Tensor,
              resign_thres: float):
        cfg, mcfg, size = self.cfg, self.mcts_cfg, self.size
        search_tree = None
        if mcfg.num_rollouts <= 0:
            res = self._policy_only(state, eval_fn)
        else:
            res, search_tree = self._search(state, eval_fn)
        # diverse move below the cutoff ply (game_selfplay.cc:80)
        diverse = state.core.ply <= cfg.policy_distri_cutoff
        logits = torch.where(res.mcts_policy > 0,
                             torch.log(res.mcts_policy.clamp(min=1e-10)),
                             -1e9)
        sampled = gumbel_categorical(logits, self.gen).to(torch.int32)
        action = torch.where(diverse, sampled, res.best_action)
        action = _maybe_follow_pass(cfg, state, action, res.root_q, size)

        v = res.root_q
        mover_v = torch.where(state.core.to_play == BLACK, v, -v)
        resign = (mover_v < -1.0 + resign_thres) & ~never_resign \
            & ~state.terminated
        new_state, _ = step(state, action, size)
        new_state = _tree_where(resign, state, new_state)
        final_score = gostate.evaluate(new_state, size, cfg.komi)
        if cfg.persistent_tree and search_tree is not None:
            self.tree = advance_tree(search_tree, action, new_state.core, size,
                                     search_tree.stones.shape[1])
        return new_state, MoveOutput(
            action=action,
            mcts_policy=res.mcts_policy,
            predicted_value=v,
            resign=resign,
            terminated=new_state.terminated,
            final_score=final_score,
        )

    # ----------------------------------------------------------------- host

    def _select_white_opts_variant(self, request) -> None:
        """Per-player options follow the white_ver model; player_swap moves
        it onto black (game_selfplay.cc:182)."""
        mcfg = self.mcts_cfg
        if mcfg.white_puct <= 0 and mcfg.white_num_rollouts <= 0:
            return
        swap = bool(
            request is not None
            and not request.vers.is_selfplay()
            and request.client_ctrl.player_swap
        )
        if mcfg.white_opts_on_black != swap:
            self.mcts_cfg = dataclasses.replace(mcfg, white_opts_on_black=swap)

    def play_moves(self, params, batch_stats, n_moves: int,
                   request: Optional[MsgRequest] = None) -> List[Record]:
        """Advance all B games by n_moves plies; returns Records of games
        that finished (each finished board is reset in place)."""
        self._select_white_opts_variant(request)
        records: List[Record] = []
        eval_fn = self.eval_fn_builder(params, batch_stats)
        with torch.inference_mode():
            for _ in range(n_moves):
                records.extend(self._play_one(eval_fn, request))
        return records

    def _play_one(self, eval_fn, request) -> List[Record]:
        cfg = self.cfg
        B = cfg.batch
        dev = self.device
        if self.active_boards is not None:
            inact = torch.zeros(B, dtype=torch.bool, device=dev)
            inact[self.active_boards:] = True
            self.state = self.state._replace(
                terminated=self.state.terminated | inact)
        was_terminated = self.state.terminated.cpu().numpy()
        to_play_before = self.state.core.to_play.cpu().numpy()
        ply_before = self.state.core.ply.cpu().numpy()
        nr = torch.from_numpy(self.never_resign).to(dev)
        new_state, out = self._move(self.state, eval_fn, nr,
                                    float(self.resign_thres))

        action = out.action.cpu().numpy()
        policy = out.mcts_policy.cpu().numpy()
        value = out.predicted_value.cpu().numpy()
        resign = out.resign.cpu().numpy()
        terminated = out.terminated.cpu().numpy()
        score = out.final_score.cpu().numpy()

        records: List[Record] = []
        finished = np.zeros(B, bool)
        for b in range(B):
            if was_terminated[b]:
                continue
            if resign[b]:
                reward = -1.0 if int(to_play_before[b]) == BLACK else 1.0
                records.append(self._emit(b, reward, request))
                finished[b] = True
                continue
            self.moves[b].append(int(action[b]))
            store_pi = (
                cfg.policy_distri_training_for_all
                or int(ply_before[b]) <= cfg.policy_distri_cutoff
            )
            self.policies[b].append(policy[b] if store_pi else None)
            self.values[b].append(float(value[b]))
            hit_cutoff = (cfg.move_cutoff > 0
                          and len(self.moves[b]) >= cfg.move_cutoff)
            if terminated[b] or hit_cutoff:
                reward = float(np.sign(score[b])) or 1.0
                if cfg.cheat_selfplay_random_result:
                    reward = float(self.rng.choice([-1.0, 1.0]))
                if self.reward_override_fn is not None:
                    reward = float(self.reward_override_fn(b))
                records.append(self._emit(b, reward, request))
                finished[b] = True

        self.state = new_state
        if finished.any():
            # slots that reached their game quota stay frozen; the rest
            # restart from the fresh (handicap-applied) template
            reset = finished.copy()
            if cfg.num_games_per_thread > 0:
                for b in np.nonzero(finished)[0]:
                    if self.seqs[b] + 1 >= cfg.num_games_per_thread:
                        reset[b] = False
            frozen = finished & ~reset
            if frozen.any():
                self.state = self.state._replace(
                    terminated=self.state.terminated
                    | torch.from_numpy(frozen).to(dev))
            mask = torch.from_numpy(reset).to(dev)
            self.state = _tree_where(mask, self._fresh_state, self.state)
            if cfg.persistent_tree and self.tree is not None:
                self.tree = reset_tree_where(self.tree, mask, self.state.core)
            for b in np.nonzero(finished)[0]:
                self.moves[b] = []
                self.policies[b] = []
                self.values[b] = []
                self.using_models[b] = []
                self.never_resign = self.never_resign.copy()
                self.never_resign[b] = self.rng.rand() < self.never_resign_prob
                self.seqs[b] += 1
            self.completed_games += int(finished.sum())
        return records

    def reset_all(self) -> None:
        """Restart every game (sync-mode model change,
        game_selfplay.cc:222 OnReceive) from the empty or handicap board,
        without the preload, as the JAX actor does."""
        B = self.cfg.batch
        self.tree = None
        self.state = self._start_state(B)
        for b in range(B):
            if self.moves[b]:
                self.seqs[b] += 1
            self.moves[b] = []
            self.policies[b] = []
            self.values[b] = []
            self.using_models[b] = []
            self.never_resign[b] = self.rng.rand() < self.never_resign_prob

    def note_model_version(self, ver: int) -> None:
        """Track the model version for in-flight games (async mode)."""
        for b in range(self.cfg.batch):
            if not self.using_models[b] or self.using_models[b][-1] != ver:
                self.using_models[b].append(ver)

    def _maybe_dump_sgf(self, b: int, reward: float) -> None:
        """Write board b's finished game as `<prefix>-<b>-<seq>-<n>.sgf`
        (go_state_ext.h dumpSgf); the moves are those played after any
        preload.  A file that cannot be written is logged and skipped, as
        the JAX actor skips it."""
        if not self.cfg.dump_record_prefix:
            return
        result = f"B+{abs(reward)}" if reward > 0 else f"W+{abs(reward)}"
        game = game_from_moves(self.moves[b], self.size, komi=self.cfg.komi,
                               result=result)
        self._dump_count += 1
        path = (f"{self.cfg.dump_record_prefix}-{b}-{self.seqs[b]}-"
                f"{self._dump_count}.sgf")
        try:
            with open(path, "w") as f:
                f.write(serialize_sgf(game))
        except OSError as e:
            logger.warning("SGF dump %s not written: %s", path, e)

    def _emit(self, b: int, reward: float,
              request: Optional[MsgRequest]) -> Record:
        self._maybe_dump_sgf(b, reward)
        return make_record(
            self.moves[b],
            reward,
            self.policies[b],
            self.values[b],
            self.size,
            request=request,
            thread_id=b,
            seq=int(self.seqs[b]),
            never_resign=bool(self.never_resign[b]),
            using_models=list(self.using_models[b]),
            first_player=self._first_player,
            setup_black=self._setup_black,
            setup_white=self._setup_white,
        )
