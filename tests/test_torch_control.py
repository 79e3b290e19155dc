"""The port's control plane on the CPU: the twin of tests/test_control.py
(wire protocol, eval, self-play, resign quantile, client manager, journal,
learner coupling, the in-process server + client loop over real sockets)
with `device="cpu"` and a 5x5 1-block net, and its parity with the JAX
package: the same values give byte-identical wire JSON in both packages,
the same seeded stream of records drives both packages' controllers to
the same thresholds, requests and decisions, and the option groups parse
the same argv to the same values.  Also: the registry, the stats and
profiler copies, the entry scripts' refusals, and a client whose
checkpoint is missing, half written or pruned."""

import dataclasses
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from elf_tpu import config as jconfig
from elf_tpu import stats as jstats
from elf_tpu.control import eval_ctrl as jeval
from elf_tpu.control import selfplay_ctrl as jsp
from elf_tpu.models import registry as jregistry
from elf_tpu.selfplay import records as jrec
from elf_tpu_torch import config as tconfig
from elf_tpu_torch import stats as tstats
from elf_tpu_torch.config import (
    ControlOptions,
    MCTSOptions,
    ReplayOptions,
    TrainOptions,
)
from elf_tpu_torch.control import client as tclient_mod
from elf_tpu_torch.control.client import SelfplayClient
from elf_tpu_torch.control.client_manager import ClientManager, ClientType
from elf_tpu_torch.control.eval_ctrl import BatchRequest, EvalSubCtrl
from elf_tpu_torch.control.journal import RecordJournal
from elf_tpu_torch.control.selfplay_ctrl import (
    ResignThresholdCalculator,
    SelfPlaySubCtrl,
)
from elf_tpu_torch.control.server import TrainServer
from elf_tpu_torch.models import registry as tregistry
from elf_tpu_torch.models.checkpoint import save_checkpoint
from elf_tpu_torch.models.resnet import (
    ModelConfig,
    build_model,
    eval_fn_builder,
    load_model,
)
from elf_tpu_torch.profiling import Profiler
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay import records as trec
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
from elf_tpu_torch.selfplay.records import (
    ClientCtrl,
    ModelPair,
    MsgRequest,
    MsgRequestSeq,
    Records,
    TSOptions,
)
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import Trainer
from scripts import selfplay_client_torch, train_server_torch

SIZE = 5
NET = ModelConfig(board_size=SIZE, num_block=1, dim=8, use_bf16=False)


def fake_record(ver=0, white_ver=-1, reward=1.0, swap=False, values=None,
                never_resign=False, rec=trec, first_player=1):
    """A Record of package `rec` (the port's records module or the JAX one)."""
    return rec.Record(
        request=rec.MsgRequest(
            vers=rec.ModelPair(black_ver=ver, white_ver=white_ver),
            client_ctrl=rec.ClientCtrl(player_swap=swap),
        ),
        result=rec.MsgResult(
            reward=reward,
            content="(;B[aa])",
            num_move=1,
            values=values or [0.5],
            black_never_resign=never_resign,
            white_never_resign=never_resign,
            first_player=first_player,
        ),
    )


def cpu_actor(batch=2, mcfg=None, builder=None, **acfg):
    return SelfplayActor(
        ActorConfig(board_size=SIZE, batch=batch, **acfg),
        mcfg or MCTSConfig(num_rollouts=4, rollouts_per_batch=2),
        builder or (lambda p, b: None), device="cpu",
    )


# ---------------------------------------------------------------------------
# twins of tests/test_control.py
# ---------------------------------------------------------------------------


class TestWireProtocol:
    def test_ts_options_roundtrip(self):
        ts = TSOptions(num_threads=8, num_rollouts_per_thread=200,
                       root_epsilon=0.25, root_alpha=0.03, c_puct=0.85,
                       persistent_tree=True, virtual_loss=5)
        d = ts.to_json()
        assert d["alg_opt"]["c_puct"] == 0.85
        assert "c_puct" not in d
        ts2 = TSOptions.from_json(d)
        assert ts2 == ts
        assert ts2.total_rollouts == 1600
        nf = ts2.noise_free()
        assert nf.root_epsilon == 0.0 and nf.root_alpha == 0.0
        assert nf.total_rollouts == 1600

    def test_model_pair_mcts_opt_roundtrip(self):
        mp = ModelPair(black_ver=3, white_ver=-1,
                       mcts_opt=TSOptions(num_threads=2))
        mp2 = ModelPair.from_json(mp.to_json())
        assert isinstance(mp2.mcts_opt, TSOptions)
        assert mp2.mcts_opt.num_threads == 2
        assert ModelPair.from_json(
            {"black_ver": 1, "white_ver": -1}).mcts_opt is None
        assert ModelPair().wait() and not mp.wait()

    def test_msg_request_seq_roundtrip(self):
        rs = MsgRequestSeq(seq=7, request=MsgRequest(
            vers=ModelPair(black_ver=1)))
        rs2 = MsgRequestSeq.from_json(rs.to_json())
        assert rs2.seq == 7 and rs2.request.vers.black_ver == 1

    def test_server_sequences_and_drives_mcts(self):
        opts = ControlOptions(expected_num_clients=2, eval_num_games=4,
                              selfplay_async=True)
        ropts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
        ts = TSOptions(num_threads=8, num_rollouts_per_thread=25,
                       root_epsilon=0.25, root_alpha=0.03)
        server = TrainServer(opts, ropts, port=0, mcts_opt=ts)
        try:
            server.set_initial_version(0)
            r0 = MsgRequestSeq.from_json(server.on_reply("c_eval"))
            r1 = MsgRequestSeq.from_json(server.on_reply("c_eval"))
            assert (r0.seq, r1.seq) == (0, 1)
            assert r0.request.vers.is_selfplay()
            assert r0.request.vers.mcts_opt.root_epsilon == 0.25
            assert r0.request.client_ctrl.async_mode
            server.eval.add_new_model_for_evaluation(10)
            r2 = MsgRequestSeq.from_json(server.on_reply("c_eval"))
            assert not r2.request.vers.is_selfplay()
            assert r2.request.vers.black_ver == 10
            assert r2.request.vers.mcts_opt.root_epsilon == 0.0
            assert r2.request.vers.mcts_opt.total_rollouts == 200
            # the status title answers without registering a client
            st = server.on_reply("probe", "status")
            assert st["ready"] and st["selfplay_ver"] == 0
            assert server.clients.get("probe") is None
        finally:
            server.stop()

    def test_eval_per_game_accounting(self):
        br = BatchRequest(max_num_request=8)
        assert br.register("c0")
        for k in range(8):
            assert br.add_result("c0", 1.0 if k % 2 else -1.0)
        assert br.is_full()
        assert not br.add_result("c0", 1.0)
        assert not br.register("c1")
        assert br.win_count.n_done == 8

    def test_single_client_finishes_whole_eval(self):
        opts = ControlOptions(eval_num_games=8, eval_winrate_thres=0.55)
        ev = EvalSubCtrl(opts)
        ev.set_baseline(0)
        ev.add_new_model_for_evaluation(1)
        swaps = []
        for _ in range(8):
            req = MsgRequest()
            assert ev.fill_in_request("only-client", req)
            swaps.append(req.client_ctrl.player_swap)
            reward = -1.0 if req.client_ctrl.player_swap else 1.0
            ev.feed("only-client", fake_record(
                ver=1, white_ver=0, reward=reward,
                swap=req.client_ctrl.player_swap,
            ))
        assert sum(swaps) == 4
        assert swaps == sorted(swaps) or swaps == sorted(swaps, reverse=True)
        assert ev.check_promotions(lambda _ident: False) == 1

    def test_eval_half_sticky_until_full(self):
        opts = ControlOptions(eval_num_games=8, eval_winrate_thres=0.55)
        ev = EvalSubCtrl(opts)
        ev.set_baseline(0)
        ev.add_new_model_for_evaluation(1)
        swaps = []
        for _ in range(5):
            req = MsgRequest()
            assert ev.fill_in_request("c0", req)
            swaps.append(req.client_ctrl.player_swap)
        assert len(set(swaps)) == 1
        for _ in range(4):
            ev.feed("c0", fake_record(
                ver=1, white_ver=0, reward=1.0, swap=swaps[0]))
        req = MsgRequest()
        assert ev.fill_in_request("c0", req)
        assert req.client_ctrl.player_swap != swaps[0]
        ev2 = EvalSubCtrl(opts)
        ev2.set_baseline(0)
        ev2.add_new_model_for_evaluation(1)
        r1, r2 = MsgRequest(), MsgRequest()
        assert ev2.fill_in_request("a", r1)
        assert ev2.fill_in_request("b", r2)
        assert r1.client_ctrl.player_swap != r2.client_ctrl.player_swap

    def test_pending_candidates_rekeyed_after_promotion(self):
        opts = ControlOptions(eval_num_games=4, eval_winrate_thres=0.55)
        ev = EvalSubCtrl(opts)
        ev.set_baseline(0)
        ev.add_new_model_for_evaluation(1)
        ev.add_new_model_for_evaluation(2)
        ev.set_baseline(1)
        req = MsgRequest()
        assert ev.fill_in_request("c0", req)
        assert req.vers.black_ver == 2
        assert req.vers.white_ver == 1

    def test_eval_job_change_restarts_client_games(self):
        opts = ControlOptions()
        actor, eval_actor = cpu_actor(), cpu_actor()
        client = SelfplayClient(
            opts, actor, load_params_fn=lambda ver: (None, None),
            port=1, eval_actor=eval_actor,
        )
        resets = []
        eval_actor.reset_all = lambda: resets.append(1)
        eval_actor.play_moves = lambda *a, **k: []

        def req(swap, black=1, white=0):
            return MsgRequest(vers=ModelPair(black_ver=black, white_ver=white),
                              client_ctrl=ClientCtrl(player_swap=swap))

        client.request = req(False)
        client._play_eval_round(4)
        assert len(resets) == 1
        client._play_eval_round(4)
        assert len(resets) == 1
        client.request = req(True)
        client._play_eval_round(4)
        assert len(resets) == 2
        client.request = req(True, black=2)
        client._play_eval_round(4)
        assert len(resets) == 3

    def test_eval_round_with_pruned_checkpoint_skips_not_dies(self,
                                                             monkeypatch):
        monkeypatch.setattr(tclient_mod.time, "sleep", lambda s: None)
        actor, eval_actor = cpu_actor(), cpu_actor()

        def load_params(ver):
            raise FileNotFoundError(f"save-{ver}.bin pruned")

        client = SelfplayClient(
            ControlOptions(), actor, load_params_fn=load_params,
            port=1, eval_actor=eval_actor,
        )
        played = []
        eval_actor.play_moves = lambda *a, **k: played.append(1) or []
        client.request = MsgRequest(
            vers=ModelPair(black_ver=8, white_ver=4),
            client_ctrl=ClientCtrl(player_swap=False),
        )
        assert client._play_eval_round(4) == []
        assert not played

    def test_ts_options_from_search_options(self):
        mo = MCTSOptions(num_rollouts=1600, rollouts_per_batch=8,
                         c_puct=0.85, virtual_loss=5, root_epsilon=0.25,
                         root_alpha=0.03, persistent_tree=True)
        ts = TSOptions.from_search_options(mo)
        assert ts.total_rollouts == 1600
        assert ts.num_rollouts_per_batch == 8
        assert ts.c_puct == 0.85
        assert ts.virtual_loss == 5
        assert ts.root_epsilon == 0.25
        assert ts.persistent_tree
        assert TSOptions.from_json(ts.to_json()) == ts

    def test_client_eval_obeys_server_options_and_thread_cap(self):
        opts = ControlOptions(expected_num_clients=2, eval_num_games=4,
                              eval_num_threads=2)
        ropts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
        ts = TSOptions(num_threads=1, num_rollouts_per_thread=16,
                       num_rollouts_per_batch=4,
                       root_epsilon=0.25, root_alpha=0.03)
        server = TrainServer(opts, ropts, port=0, mcts_opt=ts)
        try:
            server.set_initial_version(0)
            server.eval.add_new_model_for_evaluation(1)
            wrong = MCTSConfig(num_rollouts=8, rollouts_per_batch=2,
                               root_epsilon=0.77, root_alpha=0.5)
            actor = cpu_actor(batch=4, mcfg=wrong)
            eval_actor = cpu_actor(batch=4, mcfg=wrong)
            client = SelfplayClient(
                opts, actor, load_params_fn=lambda ver: (None, None),
                port=server.port, eval_actor=eval_actor,
            )
            req = MsgRequestSeq.from_json(
                server.on_reply(client.identity)).request
            assert not req.vers.is_selfplay()
            client._maybe_reload(req)
            assert eval_actor.mcts_cfg.root_epsilon == 0.0
            assert eval_actor.mcts_cfg.num_rollouts == 16
            assert eval_actor.active_boards == 2
            assert actor.active_boards is None
            assert actor.mcts_cfg.root_epsilon == 0.77
        finally:
            server.stop()

    def test_actor_applies_ts_options(self):
        actor = cpu_actor(mcfg=MCTSConfig(num_rollouts=8,
                                          rollouts_per_batch=2))
        ts = TSOptions(num_threads=2, num_rollouts_per_thread=8,
                       num_rollouts_per_batch=4, root_epsilon=0.25,
                       c_puct=0.85)
        assert actor.apply_ts_options(ts)
        assert actor.mcts_cfg.num_rollouts == 16
        assert actor.mcts_cfg.c_puct == 0.85
        assert not actor.apply_ts_options(ts)     # same options: no change
        # a server-sent persistent tree switches tree reuse on
        assert actor.apply_ts_options(
            dataclasses.replace(ts, persistent_tree=True))
        assert actor.cfg.persistent_tree
        assert actor.mcts_cfg.num_rollouts == 16
        assert not actor.apply_ts_options(
            dataclasses.replace(ts, persistent_tree=True))


class TestSubControllers:
    def test_selfplay_version_gate(self):
        opts = ControlOptions(selfplay_init_num=2, selfplay_update_num=3)
        sp = SelfPlaySubCtrl(opts)
        sp.set_version(5)
        assert not sp.feed(fake_record(ver=4))
        assert sp.feed(fake_record(ver=5))
        assert sp.num_games() == 1
        assert not sp.is_sufficient(initial=True)
        assert sp.feed(fake_record(ver=5))
        assert sp.is_sufficient(initial=True)

    def test_learner_selfplay_coupling(self):
        opts = ControlOptions(expected_num_clients=1, selfplay_init_num=2,
                              selfplay_update_num=2, eval_num_games=8)
        ropts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
        server = TrainServer(opts, ropts, port=0)
        try:
            server.set_initial_version(0)

            def feed(n):
                recs = Records(
                    identity="c0", states={},
                    records=[fake_record(ver=0,
                                         reward=1.0 if k % 2 else -1.0)
                             for k in range(n)],
                )
                server.on_receive("c0", "content", recs.to_json_string())

            feed(2)
            assert server.wait_for_sufficient_selfplay(timeout=5, poll=0.05)
            unblocked = threading.Event()

            def learner():
                server.notify_new_version(0, 100)
                unblocked.set()

            t = threading.Thread(target=learner, daemon=True)
            t.start()
            assert not unblocked.wait(1.0), "learner was not throttled"
            feed(2)
            assert unblocked.wait(10.0), "learner did not unblock"
            t.join(5)
            assert not t.is_alive()
            assert "eval 100 vs 0" in server.eval.info()
        finally:
            server.stop()

    def test_stale_batch_skipped(self, tmp_path):
        buf = ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                         q_max_size=20))
        pipe = TrainingPipeline(buf, SIZE, seed=0)
        pi = np.zeros(SIZE * SIZE + 1, np.float32)
        pi[3] = 1.0
        req = MsgRequest(vers=ModelPair(black_ver=0, white_ver=-1))
        for k in range(4):
            pipe.insert_record(trec.make_record(
                [3, 7], 1.0 if k % 2 else -1.0, [pi, pi], [0.0, 0.0], SIZE,
                request=req,
            ))
        opts = TrainOptions(batchsize=4, num_block=1, dim=8)
        runner = LearnerRunner(Trainer(NET, opts, device="cpu"), pipe,
                               str(tmp_path), opts)
        cur_ver = [0]
        runner.version_provider = lambda: cur_ver[0]
        runner.keep_prev_selfplay = False
        assert runner.run_minibatch() is not None
        cur_ver[0] = 5
        assert runner.run_minibatch() is None
        assert runner.skipped_stale_batches == 1
        runner.keep_prev_selfplay = True
        assert runner.run_minibatch() is not None

    def test_resign_threshold_quantile(self):
        rc = ResignThresholdCalculator(
            hist_size=1000, false_positive_target=0.1, initial_threshold=0.05,
            max_threshold=0.5,
        )
        rng = np.random.RandomState(0)
        for _ in range(200):
            vals = [float(v) for v in rng.uniform(-0.9, 0.9, size=10)]
            rc.feed(fake_record(reward=1.0, values=vals, never_resign=True),
                    True, True)
        t0 = rc.threshold
        for _ in range(30):
            rc.update_threshold(max_delta=0.01)
        assert rc.threshold != t0
        assert 0.0 <= rc.threshold <= 0.5

    def test_eval_promotion_flow(self):
        opts = ControlOptions(eval_num_games=8, eval_winrate_thres=0.55)
        ev = EvalSubCtrl(opts)
        ev.set_baseline(0)
        ev.add_new_model_for_evaluation(1)
        reqs = []
        for i in range(8):
            req = MsgRequest()
            assert ev.fill_in_request(f"client{i}", req)
            assert req.vers.black_ver == 1 and req.vers.white_ver == 0
            reqs.append(req)
        assert sum(r.client_ctrl.player_swap for r in reqs) == 4
        for i, req in enumerate(reqs):
            reward = -1.0 if req.client_ctrl.player_swap else 1.0
            ev.feed(f"client{i}", fake_record(
                ver=1, white_ver=0, reward=reward,
                swap=req.client_ctrl.player_swap))
        assert ev.check_promotions(lambda ident: False) == 1

    def test_eval_early_loss(self):
        opts = ControlOptions(eval_num_games=8, eval_winrate_thres=0.55)
        ev = EvalSubCtrl(opts)
        ev.set_baseline(0)
        ev.add_new_model_for_evaluation(1)
        for i in range(8):
            req = MsgRequest()
            assert ev.fill_in_request(f"c{i}", req)
            reward = 1.0 if req.client_ctrl.player_swap else -1.0
            ev.feed(f"c{i}", fake_record(
                ver=1, white_ver=0, reward=reward,
                swap=req.client_ctrl.player_swap))
        assert ev.check_promotions(lambda ident: False) is None
        assert ev.pending == []

    def test_client_manager_roles_and_death(self):
        cm = ClientManager(4, max_delay_sec=0.2, selfplay_only_ratio=0.5)
        types = [cm.on_message(f"c{i}").type for i in range(4)]
        assert types.count(ClientType.EVAL_THEN_SELFPLAY) == 2
        # the first client gets eval duty (client_manager.h:215)
        assert types[0] == ClientType.EVAL_THEN_SELFPLAY
        time.sleep(0.3)
        assert len(cm.sweep_dead()) == 4
        cm.on_message("c0")
        assert cm.num_alive() == 1


class TestEndToEnd:
    def test_server_client_loop(self):
        """Real sockets: a client with a 5x5 1-block net plays cheat-mode
        games, ships records, the server version-gates them."""
        opts = ControlOptions(expected_num_clients=1, selfplay_init_num=2,
                              selfplay_update_num=2, client_max_delay_sec=60)
        ropts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
        server = TrainServer(opts, ropts, port=0)
        server.start()
        try:
            server.set_initial_version(0)
            net = build_model(NET, "cpu", seed=0)
            actor = cpu_actor(
                mcfg=MCTSConfig(num_rollouts=4, rollouts_per_batch=2,
                                rotation_flip=False, root_epsilon=0.25,
                                root_alpha=0.5),
                builder=eval_fn_builder,
                policy_distri_cutoff=50, never_resign_prob=1.0,
                cheat_selfplay_random_result=True, move_cutoff=10,
            )
            client = SelfplayClient(
                opts, actor, load_params_fn=lambda ver: (net, None),
                port=server.port,
            )
            client.run(moves_per_round=10, max_rounds=30,
                       stop_fn=lambda: server.num_selfplay_games >= 3)
            client.transport.close()
            assert server.num_selfplay_games >= 3
            assert server.replay.size() >= 3
            assert client.loaded_ver == 0
            assert server.selfplay.is_sufficient(initial=True)
            assert server.clients.num_alive() == 1
        finally:
            server.stop()


class TestRecordJournal:
    def test_journal_append_rotate_resume(self, tmp_path):
        d = str(tmp_path / "journal")
        j = RecordJournal(d, rotate_every=3)
        for i in range(7):
            j.append(fake_record(ver=0, reward=1.0 if i % 2 else -1.0))
        j.close()
        files = sorted(f for f in os.listdir(d) if f.endswith(".jsonl"))
        assert files == ["records-0.jsonl", "records-1.jsonl",
                         "records-2.jsonl"]
        j2 = RecordJournal(d, rotate_every=3)
        got = []
        assert j2.replay_into(got.append) == 7 and len(got) == 7
        assert got[0].result.reward == -1.0
        j2.append(fake_record())
        j2.close()
        assert os.path.exists(os.path.join(d, "records-3.jsonl"))

    def test_server_journals_accepted_records(self, tmp_path):
        opts = ControlOptions(expected_num_clients=1, selfplay_init_num=1,
                              selfplay_update_num=1)
        ropts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
        server = TrainServer(opts, ropts, port=0,
                             journal_dir=str(tmp_path / "j"))
        try:
            server.set_initial_version(0)
            recs = Records(identity="c0", states={},
                           records=[fake_record(ver=0)])
            server.on_receive("c0", "content", recs.to_json_string())
            server.journal.flush()
            server2 = TrainServer(opts, ropts, port=0,
                                  journal_dir=str(tmp_path / "j"))
            try:
                server2.set_initial_version(0)
                assert server2.resume_from_journal() == 1
                assert server2.replay.size() == 1
            finally:
                server2.stop()
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _wire_objects(rec):
    """The same wire values, built with package `rec`."""
    ts = rec.TSOptions(num_threads=2, num_rollouts_per_thread=48,
                       num_rollouts_per_batch=4, root_epsilon=0.25,
                       root_alpha=0.2, virtual_loss=3, c_puct=0.85,
                       unexplored_q_zero=True)
    mp = rec.ModelPair(black_ver=12, white_ver=7, mcts_opt=ts)
    req = rec.MsgRequest(vers=mp, client_ctrl=rec.ClientCtrl(
        resign_thres=0.125, never_resign_prob=0.25, player_swap=True,
        async_mode=True, num_game_thread_used=16))
    seq = rec.MsgRequestSeq(seq=41, request=req)
    st = rec.ThreadState(thread_id=3, seq=9, move_idx=17, black=12, white=7)
    record = rec.Record(
        request=req,
        result=rec.MsgResult(
            reward=-1.0, content="(;B[aa];W[bb];B[])",
            policies=[{"idx": [0, 6], "q": [255, 17]}, {"idx": [], "q": []}],
            values=[0.25, -0.5, 0.125], using_models=[7, 12], num_move=3,
            black_never_resign=True, first_player=2, setup_black=[4],
            setup_white=[]),
        timestamp=1700000000.5, thread_id=3, seq=9, pri=0.5, offline=True)
    records = rec.Records(identity="go-host-abc",
                          states={3: st, 0: rec.ThreadState(thread_id=0)},
                          records=[record, rec.Record()])
    return {"TSOptions": ts, "ModelPair": mp, "MsgRequest": req,
            "MsgRequestSeq": seq, "ThreadState": st, "Record": record,
            "Records": records}


def _blob(obj) -> str:
    if hasattr(obj, "to_json_string"):
        return obj.to_json_string()
    return json.dumps(obj.to_json())


@pytest.mark.parametrize("name", ["TSOptions", "ModelPair", "MsgRequest",
                                  "MsgRequestSeq", "ThreadState", "Record",
                                  "Records"])
def test_wire_json_byte_identical_and_cross_parses(name):
    t, j = _wire_objects(trec)[name], _wire_objects(jrec)[name]
    assert _blob(t) == _blob(j)
    tcls, jcls = getattr(trec, name), getattr(jrec, name)
    if name == "Records":
        assert _blob(tcls.from_json_string(_blob(j))) == _blob(j)
        assert _blob(jcls.from_json_string(_blob(t))) == _blob(t)
    else:
        assert _blob(tcls.from_json(json.loads(_blob(j)))) == _blob(j)
        assert _blob(jcls.from_json(json.loads(_blob(t)))) == _blob(t)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]


def test_ts_options_conversions_match_jax():
    for mo_kw in ({}, {"num_rollouts": 96, "c_puct": 0.85,
                       "root_epsilon": 0.25, "pick_method": "prior"}):
        t = trec.TSOptions.from_search_options(MCTSOptions(**mo_kw))
        j = jrec.TSOptions.from_search_options(jconfig.MCTSOptions(**mo_kw))
        assert _blob(t) == _blob(j)
        assert _blob(t.noise_free()) == _blob(j.noise_free())
        assert t.as_mcts_kwargs() == j.as_mcts_kwargs()


def _record_stream(rng, n, ver_of, rec):
    """n fake records of package `rec` drawn from `rng` (a RandomState the
    caller seeds once per package)."""
    out = []
    for _ in range(n):
        reward = float(rng.choice([-1.0, 1.0]))
        vals = [float(v) for v in rng.uniform(-1.0, 1.0,
                                              size=rng.randint(1, 12))]
        nr = bool(rng.rand() < 0.4)
        first = int(rng.choice([1, 2]))
        out.append(fake_record(ver=ver_of(rng), reward=reward, values=vals,
                               never_resign=nr, rec=rec,
                               first_player=first))
    return out


def test_resign_threshold_matches_jax():
    kw = dict(hist_size=300, false_positive_target=0.1,
              initial_threshold=0.3, min_threshold=0.01, max_threshold=0.6)
    t, j = ResignThresholdCalculator(**kw), jsp.ResignThresholdCalculator(**kw)
    rt, rj = np.random.RandomState(5), np.random.RandomState(5)
    st = _record_stream(rt, 700, lambda r: 0, trec)
    sj = _record_stream(rj, 700, lambda r: 0, jrec)
    for k, (a, b) in enumerate(zip(st, sj)):
        t.feed(a, a.result.black_never_resign, a.result.white_never_resign)
        j.feed(b, b.result.black_never_resign, b.result.white_never_resign)
        if k % 7 == 0:
            assert abs(t.update_threshold(0.02)
                       - j.update_threshold(0.02)) <= 1e-12
    assert t.info() == j.info()
    assert t.num_fp == j.num_fp and t.num_never_resign == j.num_never_resign


def test_selfplay_subctrl_matches_jax():
    """The same seeded record stream through both packages' SelfPlaySubCtrl:
    the same acceptances, thresholds, sufficiency answers and request
    JSON, across version changes."""
    kw = dict(selfplay_init_num=20, selfplay_update_num=15,
              resign_thres=0.2, resign_target_hist_size=200,
              resign_target_fp_rate=0.1, selfplay_async=True)
    ts_t = trec.TSOptions(num_threads=1, num_rollouts_per_thread=64,
                          root_epsilon=0.25)
    ts_j = jrec.TSOptions(num_threads=1, num_rollouts_per_thread=64,
                          root_epsilon=0.25)
    t = SelfPlaySubCtrl(ControlOptions(**kw), mcts_opt=ts_t)
    j = jsp.SelfPlaySubCtrl(jconfig.ControlOptions(**kw), mcts_opt=ts_j)
    rt, rj = np.random.RandomState(9), np.random.RandomState(9)

    def ver_of(r):
        return int(r.choice([0, 0, 0, 3, 3, 5]))

    for phase, ver in enumerate((0, 3, 5)):
        t.set_version(ver)
        j.set_version(ver)
        st = _record_stream(rt, 260, ver_of, trec)
        sj = _record_stream(rj, 260, ver_of, jrec)
        for a, b in zip(st, sj):
            assert t.feed(a, a.result.black_never_resign,
                          a.result.white_never_resign) == \
                j.feed(b, b.result.black_never_resign,
                       b.result.white_never_resign)
            assert abs(t.resign_calc.threshold
                       - j.resign_calc.threshold) <= 1e-12
            for v in (0, 3, 5):
                assert t.need_wait_for_more_sample(v) == \
                    j.need_wait_for_more_sample(v)
            if t.need_wait_for_more_sample(ver) == t.SUFFICIENT_SAMPLE:
                t.notify_current_weight_update()
                j.notify_current_weight_update()
        for init in (True, False):
            assert t.is_sufficient(init) == j.is_sufficient(init)
        rq_t, rq_j = trec.MsgRequest(), jrec.MsgRequest()
        t.fill_in_request(rq_t)
        j.fill_in_request(rq_j)
        assert _blob(rq_t) == _blob(rq_j)
        assert t.info() == j.info()


@pytest.mark.parametrize("num_games, num_threads, steps", [
    (12, 4, 1500),
    (400, -1, 9000),
], ids=["12_games", "400_games_prod13"])
def test_eval_subctrl_matches_jax(num_games, num_threads, steps):
    """The same seeded stream of requests, results and client deaths through
    both packages' EvalSubCtrl: the same request JSON, the same promote /
    reject decisions (early stops included), the same re-keying of pending
    candidates after a promotion.  At 12 games (4 boards a client) and at
    the 13x13 protocol's 400 (every board of a client, the README's
    --eval_num_threads -1), where the win-rate bound stops evals early in
    both directions."""
    kw = dict(eval_num_games=num_games, eval_winrate_thres=0.55,
              eval_num_threads=num_threads, eval_num_rollouts=32)
    ts_t = trec.TSOptions(num_threads=1, num_rollouts_per_thread=64,
                          root_epsilon=0.25, root_alpha=0.03)
    ts_j = jrec.TSOptions(num_threads=1, num_rollouts_per_thread=64,
                          root_epsilon=0.25, root_alpha=0.03)
    t = EvalSubCtrl(ControlOptions(**kw), mcts_opt=ts_t)
    j = jeval.EvalSubCtrl(jconfig.ControlOptions(**kw), mcts_opt=ts_j)
    for c in (t, j):
        c.set_baseline(0)
    rng = np.random.RandomState(3)
    clients = [f"c{i}" for i in range(4)]
    dead = set()
    next_cand = 1
    decisions = []
    for step in range(steps):
        if rng.rand() < 0.02 or not t.pending:
            for c in (t, j):
                c.add_new_model_for_evaluation(next_cand)
            next_cand += 1
        ident = clients[rng.randint(len(clients))]
        if rng.rand() < 0.005:
            dead.add(ident)
        rq_t, rq_j = trec.MsgRequest(), jrec.MsgRequest()
        got = t.fill_in_request(ident, rq_t)
        assert got == j.fill_in_request(ident, rq_j)
        assert _blob(rq_t) == _blob(rq_j)
        if got:
            # the candidate's strength drifts with its version
            p_win = 0.2 + 0.6 * ((rq_t.vers.black_ver * 37) % 10) / 10
            cand_wins = rng.rand() < p_win
            swap = rq_t.client_ctrl.player_swap
            reward = (-1.0 if cand_wins else 1.0) if swap else \
                (1.0 if cand_wins else -1.0)
            for c, rec in ((t, trec), (j, jrec)):
                c.feed(ident, fake_record(
                    ver=rq_t.vers.black_ver, white_ver=rq_t.vers.white_ver,
                    reward=reward, swap=swap, rec=rec))
        before = list(t.pending)
        pt = t.check_promotions(lambda i: i in dead)
        pj = j.check_promotions(lambda i: i in dead)
        assert pt == pj
        assert t.pending == j.pending
        assert t.last_promotion_info == j.last_promotion_info
        for cand in before:
            if cand not in t.pending:
                perf = t.perfs[(cand, t.baseline)]
                n_done = (perf.noswap.win_count.n_done
                          + perf.swap.win_count.n_done)
                decisions.append(("PROMOTE" if cand == pt else "reject",
                                  n_done))
        if pt is not None:
            for c in (t, j):
                c.set_baseline(pt)
            # pending candidates re-keyed against the new baseline
            assert t.pending == j.pending
            assert sorted(t.perfs) == sorted(j.perfs)
            assert all((c, pt) in t.perfs for c in t.pending)
        assert t.info() == j.info()
    kinds = {k for k, _ in decisions}
    assert kinds == {"PROMOTE", "reject"}, decisions
    assert any(n < num_games for _, n in decisions), \
        "no decision stopped early"
    if num_games == 400:
        early = {k for k, n in decisions if n < num_games}
        assert early == {"PROMOTE", "reject"}, decisions


@pytest.mark.parametrize("name", ["GameOptions", "MCTSOptions",
                                  "TrainOptions", "ReplayOptions",
                                  "ControlOptions"])
def test_option_groups_match_jax(name):
    import typing

    tc, jc = getattr(tconfig, name), getattr(jconfig, name)
    tf, jf = dataclasses.fields(tc), dataclasses.fields(jc)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert typing.get_type_hints(tc) == typing.get_type_hints(jc)
    for a, b in zip(tf, jf):
        assert tconfig._field_default(a) == jconfig._field_default(b), a.name
        assert a.metadata["help"] == b.metadata["help"], a.name
    assert [c.__name__ for c in tconfig.ALL_OPTION_CLASSES] == \
        [c.__name__ for c in jconfig.ALL_OPTION_CLASSES]


def test_same_argv_parses_to_same_values():
    argv = ["--board_size", "9", "--komi", "5.5", "--num_rollouts", "96",
            "--c_puct", "0.85", "--use_mcts", "false", "--persistent_tree",
            "--lr", "0.02", "--num_reader", "8", "--eval_num_games", "50",
            "--selfplay_async", "1", "--server_addr", "10.0.0.1"]
    ts = tconfig.OptionSpec.from_dataclasses(tconfig.ALL_OPTION_CLASSES)
    js = jconfig.OptionSpec.from_dataclasses(jconfig.ALL_OPTION_CLASSES)
    tm, jm = ts.parse(argv), js.parse(argv)
    assert tm.values == jm.values
    assert tm.to_json() == jm.to_json()
    for tc, jc in zip(tconfig.ALL_OPTION_CLASSES, jconfig.ALL_OPTION_CLASSES):
        assert dataclasses.asdict(tm.get(tc)) == \
            dataclasses.asdict(jm.get(jc))
    # prefix/suffix lookups and the merge-collision rule
    t2 = tconfig.OptionMap(ts, {**tm.values, "lr0": 0.5})
    assert t2.get(TrainOptions, suffix="0").lr == 0.5

    @dataclasses.dataclass
    class Clash:
        komi: float = tconfig.opt(6.5, "another default")

    with pytest.raises(ValueError, match="collision on 'komi'"):
        ts.merge(Clash)


# ---------------------------------------------------------------------------
# registry, stats, profiler
# ---------------------------------------------------------------------------


def test_registry_matches_jax_and_refuses_unported():
    assert sorted(tregistry.MODELS) == sorted(jregistry.MODELS)
    for name in tregistry.MODELS:
        for df in (False, True):
            assert tregistry.family_feature_set(name, df) == \
                jregistry.family_feature_set(name, df)
        assert tregistry.MODELS[name].feature_set == \
            jregistry.MODELS[name].feature_set
    to = TrainOptions(num_block=1, dim=8, bf16=False)
    trainer, mode, fs = tregistry.make_trainer("df_kl", SIZE, to,
                                               device="cpu")
    assert isinstance(trainer, Trainer) and (mode, fs) == ("mcts", "agz")
    assert trainer.cfg == ModelConfig(board_size=SIZE, num_block=1, dim=8,
                                      use_bf16=False)
    _, mode, _ = tregistry.make_trainer("df_pred", SIZE, to, device="cpu")
    assert mode == "offline"
    with pytest.raises(ValueError, match="no value head"):
        tregistry.make_trainer("df_policy", SIZE, to, device="cpu")
    trainer, mode, fs = tregistry.make_trainer(
        "df_kl", SIZE, to, use_df_feature=True, device="cpu")
    assert (mode, fs, trainer.cfg.num_planes) == ("mcts", "df", 25)
    with pytest.raises(KeyError):
        tregistry.get_model_family("nope")


def test_stats_match_jax():
    rng = np.random.RandomState(1)
    feeds = rng.uniform(-3, 3, size=50)
    tv, jv = tstats.ValueStats("v"), jstats.ValueStats("v")
    tr, jr = tstats.Ranking(), jstats.Ranking()
    tg, jg = tstats.GameStats(), jstats.GameStats()
    for k, x in enumerate(feeds):
        tv.feed(float(x))
        jv.feed(float(x))
        tr.feed(k % 13)
        jr.feed(k % 13)
        tg.feed_game(float(np.sign(x)), k)
        jg.feed_game(float(np.sign(x)), k)
    assert tv.summary() == jv.summary()
    assert tr.summary() == jr.summary()
    assert tg.summary() == jg.summary()
    mc = tstats.MultiCounter()
    mc.inc("games", 3)
    mc.feed("loss", 1.5)
    assert mc.total_count == 3 and "loss: avg 1.500000" in mc.summary()
    timer = tstats.RLTimer()
    timer.record("a")
    assert timer.records["a"].counter == 1 and "a: " in timer.print()


def test_profiler_timers_and_trace(tmp_path):
    prof = Profiler()
    with prof.trace():
        with prof.phase("selfplay"):
            pass
    assert prof.timer.records["selfplay"].counter == 1
    assert prof.report().startswith("profile: ")
    traced = Profiler(trace_dir=str(tmp_path / "trace"))
    with traced.trace():
        with traced.phase("train_episode"):
            torch.ones(8).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    text = (tmp_path / "trace" / files[0]).read_text()
    assert '"elf.train_episode"' in text
    assert traced.timer.records["train_episode"].counter == 1


def test_profiler_phase_waits_for_the_card_on_a_monotonic_clock(
        monkeypatch):
    """Each stage boundary synchronises the card once CUDA is initialised
    (so a stage times its work, not its enqueue), on perf_counter."""
    clock = iter([10.0, 10.5, 12.0])
    monkeypatch.setattr(tstats, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append("sync"))
    prof = Profiler()
    with prof.phase("selfplay_moves"):
        assert syncs == ["sync"]
    assert syncs == ["sync", "sync"]
    rec = prof.timer.records
    assert rec["before_selfplay_moves"].summation == pytest.approx(0.5)
    assert rec["selfplay_moves"].summation == pytest.approx(1.5)


# ---------------------------------------------------------------------------
# the entry scripts and the checkpoint races
# ---------------------------------------------------------------------------


def test_entry_scripts_default_to_the_card(tmp_path):
    _, args = train_server_torch.parse_args(["--ckpt_dir", str(tmp_path)])
    assert args.device == "cuda"
    _, args = selfplay_client_torch.parse_args(["--ckpt_dir", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    for main in (train_server_torch.main, selfplay_client_torch.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--ckpt_dir", str(tmp_path)])


@pytest.mark.parametrize("argv,match", [
    # the ids of the cases that asserted NotImplementedError before the
    # multi-process learner was ported
    pytest.param(["--dist_coordinator", "localhost:1234", "--use_mesh", "0"],
                 r"--dist_\* requires --use_mesh 1", id="argv0-parallel/"),
    pytest.param(["--dist_num_processes", "2"], "single-process",
                 id="argv1-parallel/"),
    (["--model", "df_policy"], "no value head"),
    (["--use_df_feature", "1"], "df-25"),
])
def test_train_server_refuses_unported(tmp_path, argv, match, monkeypatch):
    """`--dist_coordinator` without `--use_mesh 1` raises the JAX
    script's assertion message.  `--dist_num_processes` alone serves
    single-process on the trivial mesh, as the JAX server ignores it.
    `--model df_policy` raises ValueError, as the JAX server's
    `make_trainer` does: the policy-only net has no value head to train.
    `--use_df_feature` builds a 25-plane learner on df batches.  The
    servers are stopped here before they serve."""
    import torch.distributed as dist

    base = ["--ckpt_dir", str(tmp_path), "--device", "cpu",
            "--num_block", "1", "--dim", "8", "--board_size", "5", "--port",
            "0"]
    if match in ("df-25", "single-process"):
        built = {}

        class Built(Exception):
            pass

        def runner(trainer, pipeline, *args, **kwargs):
            built.update(trainer=trainer, pipeline=pipeline, **kwargs)
            raise Built

        monkeypatch.setattr(train_server_torch, "LearnerRunner", runner)
        with pytest.raises(Built):
            train_server_torch.main(base + argv)
        if match == "single-process":
            assert not dist.is_initialized()
            assert built["mesh"].shape == {"dp": 1, "tp": 1}
            assert built["mesh"].size == 1
            return
        assert built["trainer"].cfg.num_planes == 25
        assert built["pipeline"].feature_set == "df"
        return
    with pytest.raises(ValueError, match=match):
        train_server_torch.main(base + argv)


def test_train_server_refuses_a_mesh_over_several_cards(tmp_path,
                                                        monkeypatch):
    """`--use_mesh 1` with four visible cards spawns four ranks, one per
    card, with tp = 2 (the JAX script's pick for an even count); each
    rank gets the command line.  The spawn is stubbed here."""
    spawned = {}
    monkeypatch.setattr(train_server_torch, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(train_server_torch.mp, "spawn",
                        lambda fn, args, nprocs: spawned.update(
                            fn=fn, args=args, nprocs=nprocs))
    argv = ["--ckpt_dir", str(tmp_path)]
    assert train_server_torch.main(argv) is None
    assert spawned["nprocs"] == 4
    assert spawned["fn"] is train_server_torch._local_rank
    world, tp, port, rank_argv = spawned["args"]
    assert (world, tp, rank_argv) == (4, 2, argv) and port > 0


def _small_state(step):
    opts = TrainOptions(batchsize=4, num_block=1, dim=8)
    state = Trainer(NET, opts, device="cpu").init_state(
        torch.Generator().manual_seed(step))
    state.step = step
    return state


@pytest.mark.parametrize("cut", [0, 1, 17, 0.5, -1])
def test_partial_checkpoint_raises_what_the_client_retries_on(tmp_path, cut):
    """A checkpoint cut short at any byte (a reader that opened it under a
    writer without the atomic rename) surfaces as ValueError, a missing one
    as OSError: the two errors the client's load retry catches."""
    path = save_checkpoint(str(tmp_path), _small_state(3))
    data = open(path, "rb").read()
    n = int(len(data) * cut) if isinstance(cut, float) else \
        (len(data) + cut if cut < 0 else cut)
    with open(path, "wb") as f:
        f.write(data[:n])
    with pytest.raises(ValueError):
        load_model(path, NET, "cpu")
    with pytest.raises(OSError):
        load_model(str(tmp_path / "save-99.bin"), NET, "cpu")


def test_client_retries_a_checkpoint_until_it_is_written(tmp_path,
                                                         monkeypatch):
    """The version the server asks for is first missing, then half written,
    then complete: the client retries through both errors and loads it."""
    monkeypatch.setattr(tclient_mod.time, "sleep", lambda s: None)
    path = save_checkpoint(str(tmp_path), _small_state(6))
    full = open(path, "rb").read()
    os.remove(path)
    stages = iter([None, full[: len(full) // 2], full])
    errors = []

    def load_params(ver):
        stage = next(stages)
        if stage is not None:
            with open(path, "wb") as f:
                f.write(stage)
        try:
            return load_model(os.path.join(str(tmp_path), f"save-{ver}.bin"),
                              NET, "cpu"), None
        except (OSError, ValueError) as e:
            errors.append(type(e))
            raise

    client = SelfplayClient(ControlOptions(), cpu_actor(), load_params,
                            port=1)
    client._maybe_reload(MsgRequest(vers=ModelPair(black_ver=6)))
    assert errors == [FileNotFoundError, ValueError]
    assert client.loaded_ver == 6
    assert isinstance(client.params, torch.nn.Module)


def test_concurrent_saves_never_give_a_reader_a_torn_file(tmp_path):
    """A client reading while the server writes and prunes (keep-k) sees a
    whole checkpoint or an OSError, never a torn file: the writer renames a
    finished temporary file into place."""
    d = str(tmp_path)
    stop = threading.Event()
    seen = {"ok": 0, "missing": 0}
    bad = []

    def reader():
        while not stop.is_set():
            for step in range(1, 25):
                try:
                    load_model(os.path.join(d, f"save-{step}.bin"), NET,
                               "cpu")
                    seen["ok"] += 1
                except OSError:
                    seen["missing"] += 1
                except Exception as e:  # noqa: BLE001  (recorded, asserted)
                    bad.append(repr(e))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for step in range(1, 25):
            save_checkpoint(d, _small_state(step), keep=2)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    assert not bad, bad[:3]
    assert seen["missing"] > 0
    assert sorted(os.listdir(d)) == ["latest", "save-23.bin", "save-24.bin"]
    load_model(os.path.join(d, "save-24.bin"), NET, "cpu")
