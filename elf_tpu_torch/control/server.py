"""Training-server control plane: the TrainCtrl + ThreadedCtrl equivalents.

The port's copy of `elf_tpu/control/server.py`, same behaviour.

Counterpart of the reference's `src_cpp/elfgames/go/train/game_ctrl.h` +
`distri_server.h`:

 - `TrainServer.on_receive` (TrainCtrl::OnReceive, game_ctrl.h:288): parse
   a Records batch -> update the client manager -> feed selfplay records to
   SelfPlaySubCtrl (version gate) + parity-insert into the replay buffer;
   eval records feed EvalSubCtrl.
 - `TrainServer.on_reply` (TrainCtrl::OnReply, game_ctrl.h:344): fill a
   MsgRequest for the client — an eval job if the client is eval-capable
   and a candidate needs games, else the current self-play version.
 - model plane (ThreadedCtrl, game_ctrl.h:41): `notify_new_version` queues
   a candidate for evaluation; a background sweep promotes candidates whose
   win-rate bound clears the threshold, updating the self-play version,
   optionally clearing the replay buffer (keep_prev_selfplay), and firing
   `on_promote` so the learner reloads / records the new baseline.
 - `wait_for_sufficient_selfplay` (game_ctrl.h:72).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from elf_tpu_torch.config import ControlOptions, ReplayOptions
from elf_tpu_torch.control.client_manager import ClientManager, ClientType
from elf_tpu_torch.control.eval_ctrl import EvalSubCtrl
from elf_tpu_torch.control.selfplay_ctrl import SelfPlaySubCtrl
from elf_tpu_torch.control.transport import ControlServer
from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.selfplay.records import MsgRequest, MsgRequestSeq, Records
from elf_tpu_torch.training.replay import ReplayBuffer


class TrainServer:
    def __init__(
        self,
        opts: ControlOptions,
        replay_opts: ReplayOptions,
        on_promote: Optional[Callable[[int], None]] = None,
        port: Optional[int] = None,
        replay_seed: int = 0,
        record_sink: Optional[Callable] = None,
        journal_dir: str = "",
        mcts_opt=None,
        promotion_log: str = "",
    ):
        """mcts_opt: a records.TSOptions shipped inside every request's
        ModelPair — the server drives rollout counts / noise / puct per
        job (model_pair.h:10); eval requests get the noise-free variant."""
        self.opts = opts
        self.logger = get_indexed_logger("control.TrainServer-")
        self.clients = ClientManager(
            opts.expected_num_clients, opts.client_max_delay_sec
        )
        self.selfplay = SelfPlaySubCtrl(opts, mcts_opt=mcts_opt)
        self.eval = EvalSubCtrl(opts, mcts_opt=mcts_opt)
        self.replay = ReplayBuffer(replay_opts, seed=replay_seed)
        # where accepted selfplay records go (default: raw replay insert;
        # the learner passes TrainingPipeline.insert_record to get
        # snapshot-precomputed items)
        self.record_sink = record_sink or self.replay.insert
        # on-disk journal of accepted records (ctrl_selfplay.h:233
        # RecordBuffer::saveCurrent): rebuildable replay on server restart
        self.journal = None
        if journal_dir:
            from elf_tpu_torch.control.journal import RecordJournal

            self.journal = RecordJournal(journal_dir)
        self.on_promote = on_promote
        # promotion history: every eval-gated baseline change, with the
        # deciding eval winrate — the audit trail the learning proof and
        # its status polls read (game_ctrl.h:202 updateModel)
        self.promotions: list = []
        self._promotion_log = promotion_log
        self.num_selfplay_games = 0
        self.num_eval_games = 0
        self._initial_ver_seen = False
        self.server = ControlServer(
            port if port is not None else opts.port,
            self.on_receive,
            self.on_reply,
        )
        self.port = self.server.port
        self._sweep_stop = threading.Event()
        self._sweep_thread = threading.Thread(target=self._sweep, daemon=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self._sweep_thread.start()

    def stop(self) -> None:
        self._sweep_stop.set()
        self.server.stop()
        if self.journal is not None:
            self.journal.close()

    def resume_from_journal(self) -> int:
        """Rebuild the replay buffer from journaled records (server restart
        path; the reference cannot do this — its replay buffer is lost)."""
        if self.journal is None:
            return 0
        n = self.journal.replay_into(
            self.record_sink,
            limit=self.replay.opts.q_max_size * self.replay.opts.num_reader,
        )
        self.num_selfplay_games += n
        if n:
            self.logger.info("resumed %d records from journal", n)
        return n

    # -- data plane ---------------------------------------------------------

    def on_receive(self, identity: str, title: str, body: str) -> None:
        if title != "content":
            return  # "ctrl" messages only refresh liveness
        recs = Records.from_json_string(body)
        self.clients.on_message(identity, recs.states)
        for r in recs.records:
            if r.request.vers.is_selfplay():
                accepted = self.selfplay.feed(
                    r,
                    r.result.black_never_resign,
                    r.result.white_never_resign,
                )
                if accepted:
                    self.record_sink(r)
                    if self.journal is not None:
                        self.journal.append(r)
                    self.num_selfplay_games += 1
            elif r.request.vers.black_ver >= 0:
                self.eval.feed(identity, r)
                self.num_eval_games += 1

    def on_reply(self, identity: str, title: str = "content") -> dict:
        if title == "status":
            # readiness/health probe: does NOT register the caller as a
            # client or consume a request seq (clients and tests gate
            # their startup on ready=True instead of a raw port connect)
            return self.status()
        c = self.clients.on_message(identity)
        req = MsgRequest()
        if c.type == ClientType.EVAL_THEN_SELFPLAY and self.eval.fill_in_request(
            identity, req
        ):
            pass
        else:
            self.selfplay.fill_in_request(req)
        # sequence every reply so clients detect stale/changed requests
        # (record.h:152 MsgRequestSeq; game_ctrl.h:344 OnReply incSeq)
        seq = c.seq
        c.seq += 1
        return MsgRequestSeq(seq=seq, request=req).to_json()

    def status(self) -> dict:
        """Machine-readable server state (the `status` control title)."""
        return {
            "status": True,
            "ready": self._initial_ver_seen,
            "selfplay_ver": self.selfplay.version(),
            "num_selfplay_games": self.num_selfplay_games,
            "num_eval_games": self.num_eval_games,
            "replay_size": self.replay.size(),
            "num_promotions": len(self.promotions),
            "last_promoted": (
                self.promotions[-1]["ver"] if self.promotions else -1
            ),
        }

    # -- model plane --------------------------------------------------------

    def set_initial_version(self, ver: int) -> None:
        """distri_server.h:61 setInitialVersion."""
        self.selfplay.set_version(ver)
        self.eval.set_baseline(ver)
        self._initial_ver_seen = True

    def set_eval_mode(self, new_ver: int, old_ver: int) -> None:
        """ThreadedCtrl::setEvalMode (game_ctrl.h:131): evaluate new_ver
        against the old_ver baseline instead of starting self-play — the
        --eval_old_model path (train.py:60)."""
        self.selfplay.set_version(old_ver)
        self.eval.set_baseline(old_ver)
        self.eval.add_new_model_for_evaluation(new_ver)
        self._initial_ver_seen = True

    def notify_new_version(self, old_ver: int, new_ver: int) -> None:
        """ThreadedCtrl::addNewModelForEvaluation (game_ctrl.h:118): queue
        the candidate for evaluation, then BLOCK the learner until enough
        fresh self-play games of the current version arrived — the
        learner<->selfplay coupling that stops the learner overtraining a
        stale buffer at fleet scale (game_ctrl.h:122-130)."""
        if self.opts.eval_num_games == 0:
            # no eval fleet: promote immediately (game_ctrl.h:120)
            self._promote(new_ver)
            return
        self.eval.add_new_model_for_evaluation(new_ver)
        self.wait_for_sufficient_selfplay(selfplay_ver=self.selfplay.version())

    def wait_for_sufficient_selfplay(
        self, timeout: float = 3600.0, poll: float = 2.0,
        selfplay_ver: Optional[int] = None,
    ) -> bool:
        """game_ctrl.h:72 waitForSufficientSelfplay.  With selfplay_ver:
        block on the per-version fresh-game bar (a promotion past that
        version also unblocks); without: the initial-start gate."""
        deadline = time.time() + timeout
        if selfplay_ver is None:
            while time.time() < deadline:
                if self.selfplay.is_sufficient(True) and self.replay.ready():
                    # the initial gate is the learner's 0th weight update:
                    # raise the fresh-game bar for the next one
                    self.selfplay.notify_current_weight_update()
                    return True
                if self._sweep_stop.is_set():
                    return False
                time.sleep(poll)
            return False
        while time.time() < deadline:
            res = self.selfplay.need_wait_for_more_sample(selfplay_ver)
            if res == self.selfplay.SUFFICIENT_SAMPLE:
                self.selfplay.notify_current_weight_update()
                return True
            if res in (self.selfplay.VERSION_OLD, self.selfplay.VERSION_INVALID):
                return True
            if self._sweep_stop.is_set():
                return False
            self.logger.info(
                "insufficient selfplay for version %d (%s)...",
                selfplay_ver, self.selfplay.info(),
            )
            time.sleep(poll)
        return False

    def _is_client_dead(self, identity: str) -> bool:
        c = self.clients.get(identity)
        return c is None or not c.active

    def _sweep(self) -> None:
        while not self._sweep_stop.wait(2.0):
            self.clients.sweep_dead()
            promoted = self.eval.check_promotions(self._is_client_dead)
            if promoted is not None:
                self._promote(promoted)

    def _promote(self, ver: int) -> None:
        """ThreadedCtrl::updateModel (game_ctrl.h:202): new baseline, new
        selfplay version, optional replay clear, learner notification."""
        self.logger.info("promoting model version %d", ver)
        entry = {"time": time.time(), "ver": ver}
        info = self.eval.last_promotion_info
        if info is not None and info.get("candidate") == ver:
            entry["eval"] = info
        self.promotions.append(entry)
        if self._promotion_log:
            import json

            with open(self._promotion_log, "a") as f:
                f.write(json.dumps(entry) + "\n")
        self.eval.set_baseline(ver)
        self.selfplay.set_version(ver)
        if not self.opts.keep_prev_selfplay:
            self.replay.clear()
        if self.on_promote:
            self.on_promote(ver)

    def info(self) -> str:
        return " | ".join(
            [
                self.clients.info(),
                self.selfplay.info(),
                self.eval.info(),
                self.replay.info(),
            ]
        )
