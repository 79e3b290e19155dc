"""Self-play client: actor loop + record shipping + model-version control.

The port's copy of `elf_tpu/control/client.py`, same behaviour.

Counterpart of the reference's `src_cpp/elfgames/go/train/distri_client.h`:
 - `ThreadedWriterCtrl` (distri_client.h:10): ship finished-game Records to
   the server, parse the `MsgRequest` reply (model versions + client ctrl),
   throttle when idle;
 - the dispatcher broadcast (`OnReceive` restart decision matrix,
   game_selfplay.cc:222) collapses to: when the requested version changes,
   reload checkpoint params and (for a changed job type) restart games;
 - model loads come from the shared checkpoint directory on demand
   (selfplay.py:138 semantics), with retry.

The client owns one `SelfplayActor` (a [B]-board lockstep shard — the
counterpart of a whole 32-thread reference client process).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from elf_tpu_torch.config import ControlOptions
from elf_tpu_torch.control.transport import ControlClient, make_identity
from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.selfplay.actor import SelfplayActor
from elf_tpu_torch.selfplay.records import (
    MsgRequest,
    MsgRequestSeq,
    Records,
    ThreadState,
)


class SelfplayClient:
    def __init__(
        self,
        opts: ControlOptions,
        actor: SelfplayActor,
        load_params_fn: Callable[[int], tuple],
        port: Optional[int] = None,
        eval_actor: Optional[SelfplayActor] = None,
        cheat_eval_new_model_wins_half: bool = False,
    ):
        """load_params_fn(version) -> (params, batch_stats), what the
        actors' evaluators take: for the port's nets (net, None); called on
        version changes, retried on OSError / ValueError (a checkpoint
        missing or still being written; selfplay.py:146).

        eval_actor: a second actor (noise-free MCTS, pair eval builder from
        `make_pair_eval_builder`) used when the server assigns eval games
        (candidate vs baseline with player_swap)."""
        self.opts = opts
        self.actor = actor
        self.eval_actor = eval_actor
        self.cheat_eval = cheat_eval_new_model_wins_half
        self.load_params_fn = load_params_fn
        self.identity = make_identity()
        self.transport = ControlClient(
            opts.server_addr, port if port is not None else opts.port,
            identity=self.identity,
        )
        self.logger = get_indexed_logger("control.SelfplayClient-")
        self.request = MsgRequest()  # waiting: black_ver = -1
        self.params = None
        self.batch_stats = None
        self.loaded_ver = -1
        self._ver_cache = {}
        self._last_seq = -1
        # (black_ver, white_ver, player_swap) the eval actor's in-flight
        # games are being played under; a change restarts them
        self._eval_job = None

    # -- control round trips ------------------------------------------------

    def wait_server_ready(self, timeout: float = 3600.0,
                          poll: float = 2.0) -> bool:
        """Block until the server reports ready=True on the `status`
        title (initial model version set).  Gating startup on this —
        instead of a raw TCP connect — means clients never burn their
        run budget polling a server that is still compiling/loading."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            reply = self.transport.send("status", "")
            if isinstance(reply, dict) and reply.get("ready"):
                return True
            time.sleep(poll)
        return False

    def _ship(self, records) -> Optional[MsgRequest]:
        states = {
            b: ThreadState(
                thread_id=b,
                seq=int(self.actor.seqs[b]),
                move_idx=len(self.actor.moves[b]),
                black=self.request.vers.black_ver,
                white=self.request.vers.white_ver,
            )
            for b in range(self.actor.cfg.batch)
        }
        blob = Records(
            identity=self.identity, states=states, records=records
        ).to_json_string()
        reply = self.transport.send("content", blob)
        if reply is None:
            return None
        # sequenced replies (record.h:152): a gap means we missed requests
        # (reconnect / server restart) — log and resync
        rs = MsgRequestSeq.from_json(reply)
        if self._last_seq >= 0 and rs.seq != self._last_seq + 1:
            self.logger.warning(
                "request seq jump: %d -> %d (missed/stale requests)",
                self._last_seq, rs.seq,
            )
        self._last_seq = rs.seq
        return rs.request

    def _maybe_reload(self, req: MsgRequest) -> None:
        # server-driven MCTS options (restart() rebuilds AIs with
        # request.vers.mcts_opt, game_selfplay.cc:164): apply to whichever
        # actor will play this job
        if req.vers.mcts_opt is not None and not req.vers.wait():
            target = (
                self.actor
                if req.vers.is_selfplay() or self.eval_actor is None
                else self.eval_actor
            )
            if target.apply_ts_options(req.vers.mcts_opt):
                self.logger.info(
                    "applied server mcts_opt: rollouts=%d eps=%.3f",
                    req.vers.mcts_opt.total_rollouts,
                    req.vers.mcts_opt.root_epsilon,
                )
        ver = req.vers.black_ver
        if ver >= 0 and ver != self.loaded_ver:
            for attempt in range(60):
                try:
                    self.params, self.batch_stats = self.load_params_fn(ver)
                    prev = self.loaded_ver
                    self.loaded_ver = ver
                    self.logger.info("loaded model version %d", ver)
                    if req.vers.is_selfplay():
                        if req.client_ctrl.async_mode:
                            # async: games continue across versions
                            # (setAsync, game_selfplay.cc:151)
                            self.actor.note_model_version(ver)
                        elif prev >= 0:
                            # sync: restart in-flight games so every record
                            # is single-version (OnReceive restart matrix)
                            self.actor.reset_all()
                    break
                except (OSError, ValueError) as e:
                    self.logger.warning(
                        "model load %d failed (%s); retry %d", ver, e, attempt
                    )
                    time.sleep(2.0)
        self.request = req
        # propagate ClientCtrl to the actor that will PLAY this job —
        # eval jobs run on the eval actor, so the server's thread
        # allocation (num_game_thread_used, ctrl_eval.h:140) and resign
        # settings must land there, not on the idle selfplay actor
        target = (
            self.actor
            if req.vers.is_selfplay() or self.eval_actor is None
            else self.eval_actor
        )
        target.resign_thres = req.client_ctrl.resign_thres
        target.never_resign_prob = req.client_ctrl.never_resign_prob
        n_used = req.client_ctrl.num_game_thread_used
        target.set_active_boards(n_used if n_used >= 0 else None)

    # -- eval games ---------------------------------------------------------

    def _load_cached(self, ver: int):
        if ver not in self._ver_cache:
            self._ver_cache[ver] = self.load_params_fn(ver)
            # bound the cache
            while len(self._ver_cache) > 4:
                oldest = min(self._ver_cache)
                if oldest == ver:
                    break
                del self._ver_cache[oldest]
        return self._ver_cache[ver]

    def _play_eval_round(self, moves_per_round: int):
        """Play eval games: candidate (black_ver) vs baseline (white_ver),
        colors exchanged when player_swap (game_selfplay.cc:164)."""
        vers = self.request.vers
        swap = self.request.client_ctrl.player_swap
        job = (vers.black_ver, vers.white_ver, swap)
        if self._eval_job != job:
            # eval restart matrix (game_selfplay.cc:164-184 OnReceive): a
            # changed candidate/baseline/swap assignment rebuilds the AIs
            # and restarts in-flight games, so every record is scored
            # under the exact assignment it was played with — without
            # this, a mid-game swap flip re-colors live boards and
            # corrupts the eval winrate
            self.eval_actor.reset_all()
            self._eval_job = job
        try:
            cand = self._load_cached(vers.black_ver)
            base = self._load_cached(vers.white_ver)
        except (OSError, ValueError) as e:
            # a queued candidate can outlive its checkpoint: the server's
            # keep-k pruning may delete save-<ver>.bin while the eval is
            # still pending (found by tests/test_multiprocess.py::
            # test_distributed_learner_promotes — the client used to die
            # here and starve the whole control plane).  Skip the round;
            # the server's stuck-eval shrinkage / post-promotion re-keying
            # retires the candidate (ctrl_eval.h:148 aliveness path).
            self.logger.warning(
                "eval versions (%d, %d) unavailable (%s); skipping round",
                vers.black_ver, vers.white_ver, e,
            )
            time.sleep(1.0)
            return []
        black, white = (base, cand) if swap else (cand, base)
        params = (black[0], white[0])
        batch_stats = (black[1], white[1])
        if self.cheat_eval:
            # decide by version-hash coin flip (go_state_ext.h:86)
            h = hash((vers.black_ver, vers.white_ver))
            self.eval_actor.reward_override_fn = (
                lambda b: 1.0 if (h + b) % 2 == 0 else -1.0
            )
        return self.eval_actor.play_moves(
            params, batch_stats, moves_per_round, request=self.request,
        )

    # -- main loop ----------------------------------------------------------

    def run(
        self,
        moves_per_round: int = 16,
        max_rounds: Optional[int] = None,
        stop_fn: Optional[Callable[[], bool]] = None,
        profiler=None,
        max_games: Optional[int] = None,
    ) -> None:
        """Main loop.  `max_games`: WORK-based stop — exit once this many
        games have been completed (selfplay + eval) and every finished
        record has been shipped; unlike `max_rounds` it is immune to how
        long the server takes to hand out the first job."""
        if profiler is None:
            from elf_tpu_torch.profiling import Profiler

            profiler = Profiler()  # stage timers only
        rounds = 0
        pending = []

        def games_done() -> int:
            n = self.actor.completed_games
            if self.eval_actor is not None:
                n += self.eval_actor.completed_games
            return n

        while max_rounds is None or rounds < max_rounds:
            if stop_fn and stop_fn():
                return
            if max_games is not None and not pending and \
                    games_done() >= max_games:
                return
            rounds += 1
            if self.request.vers.wait():
                # no job yet: poll the server (idle throttle,
                # distri_client.h:97)
                req = self._ship(pending)
                pending = []
                if req is not None:
                    self._maybe_reload(req)
                if self.request.vers.wait():
                    time.sleep(1.0)
                continue
            if self.request.vers.is_selfplay() or self.eval_actor is None:
                with profiler.phase("selfplay_moves"):
                    recs = self.actor.play_moves(
                        self.params, self.batch_stats, moves_per_round,
                        request=self.request,
                    )
            else:
                with profiler.phase("eval_moves"):
                    recs = self._play_eval_round(moves_per_round)
            pending.extend(recs)
            with profiler.phase("ship_records"):
                req = self._ship(pending)
            if req is not None:
                pending = []
                self._maybe_reload(req)
            else:
                # server unreachable: keep records, back off
                # (15-min resend watchdog analog, distri_client.h:42)
                time.sleep(5.0)
            if rounds % 50 == 0:
                self.logger.info("%s", profiler.report())
