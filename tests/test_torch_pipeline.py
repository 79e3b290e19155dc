"""The port's replay path against the JAX package's, on the CPU.

 - replayer: the port's C replayer, its plain Python version, the JAX
   package's replayer and the golden trajectories' boards (generated from
   the reference C++) agree exactly, on games with captures, ko, passes,
   handicap setup stones and white moving first;
 - with the same seed and the same records, `ReplayBuffer.sample_many`,
   `TrainingPipeline.sample_host_batch` and `device_batch` give equal
   arrays in both packages (exactly: integers, one-hot planes and
   permuted float targets);
 - `ReplayItem.ko_at` / `last_placed_at` / `to_play_at` / `board_at` agree.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from elf_tpu.config import ReplayOptions as JReplayOptions
from elf_tpu.native.replayer import replay_to_snapshots as jreplay
from elf_tpu.selfplay import records as jrecords
from elf_tpu.training import pipeline as jpipeline
from elf_tpu.training import replay as jreplay_mod
from elf_tpu_torch import _build
from elf_tpu_torch.config import ReplayOptions
from elf_tpu_torch.native.replayer import (
    replay_to_snapshots,
    replay_to_snapshots_ref,
)
from elf_tpu_torch.selfplay import records as trecords
from elf_tpu_torch.training import pipeline as tpipeline
from elf_tpu_torch.training import replay as treplay_mod

pytestmark = pytest.mark.timeout(300)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _golden(size):
    with gzip.open(os.path.join(GOLDEN_DIR, f"ref_traj_{size}.jsonl.gz"),
                   "rt") as f:
        return [json.loads(line) for line in f]


def _stones(s):
    return (np.frombuffer(s.encode(), np.uint8) - ord("0")).astype(np.int8)


def _setup(game):
    start = _stones(game["start_stones"])
    return (np.nonzero(start == 1)[0].tolist(),
            np.nonzero(start == 2)[0].tolist())


@pytest.mark.parametrize("size", [9, 19])
def test_replayer_matches_plain_version_jax_and_golden(size):
    games = _golden(size)
    n2 = size * size
    seen = dict(passes=0, captures=0, handicap=0, white_first=0)
    for g in games:
        black, white = _setup(g)
        args = (g["actions"], size, g["start_player"], black, white)
        ours = replay_to_snapshots(*args)
        assert ours.dtype == np.int8 and ours.shape == (len(g["actions"]), n2)
        np.testing.assert_array_equal(ours, replay_to_snapshots_ref(*args))
        np.testing.assert_array_equal(ours, jreplay(*args))
        np.testing.assert_array_equal(
            ours, np.stack([_stones(s) for s in g["stones"]]))
        seen["passes"] += sum(a == n2 for a in g["actions"])
        counts = (ours != 0).sum(1)
        seen["captures"] += int((np.diff(counts) < 0).sum())
        seen["handicap"] += bool(black or white)
        seen["white_first"] += g["start_player"] == 2
    assert seen["passes"] and (seen["captures"] or size == 19)
    if size == 19:
        assert seen["handicap"] and seen["white_first"]


def test_replayer_ko_and_edge_cases():
    # a ko on 5x5: white 7 has one liberty at 8, black takes it there and
    # captures exactly that stone; then white fills elsewhere
    size = 5
    moves = [2, 3, 6, 9, 12, 13, 25, 7, 8, 20]
    ours = replay_to_snapshots(moves, size)
    np.testing.assert_array_equal(ours, replay_to_snapshots_ref(moves, size))
    np.testing.assert_array_equal(ours, jreplay(moves, size))
    assert ours[7, 7] == 2 and ours[8, 7] == 0 and ours[8, 8] == 1
    # no moves, a pass only, white first on setup stones
    assert replay_to_snapshots([], size).shape == (0, 25)
    one = replay_to_snapshots([25], size, 2, [0], [24])
    assert one[0, 0] == 1 and one[0, 24] == 2 and one.sum() == 3
    with pytest.raises(ValueError):
        replay_to_snapshots([99], size)
    with pytest.raises(ValueError):
        replay_to_snapshots([1], size, first_player=3)


def test_replayer_is_built_by_the_host_compiler():
    path, _ = _build.build("replayer")
    assert path.name.startswith("replayer-") and path.suffix == ".so"
    assert path.parent == _build.BUILD_DIR
    assert _build.build("replayer") == (path, "")      # built once


def _records(mod, size, n_games=12):
    """The same game records in either package's Record type: golden
    trajectories cut to different lengths, with visit distributions on
    the early plies, both outcomes, versions, and one handicap game."""
    games = _golden(size)
    rng = np.random.default_rng(7)
    out = []
    for i in range(n_games):
        g = games[i % len(games)]
        L = int(rng.integers(6, 60))
        moves = g["actions"][:L]
        black, white = _setup(g)
        pols = [rng.dirichlet(np.full(size * size + 1, 0.1)).astype(np.float32)
                if k < 10 else None for k in range(L)]
        req = mod.MsgRequest()
        req.vers.black_ver = 3 + i % 2
        out.append(mod.make_record(
            moves, 1.0 if i % 3 else -1.0, pols,
            [float(v) for v in rng.uniform(-1, 1, L)], size, request=req,
            thread_id=i, seq=i, first_player=g["start_player"],
            setup_black=black, setup_white=white))
    # an empty game (resigned before the first move)
    out.append(mod.make_record([], -1.0, [], [], size, thread_id=99, seq=99))
    return out


def test_replay_buffer_samples_match_jax():
    size = 9
    jbuf = jreplay_mod.ReplayBuffer(
        JReplayOptions(num_reader=4, q_min_size=1, q_max_size=3), seed=5)
    tbuf = treplay_mod.ReplayBuffer(
        ReplayOptions(num_reader=4, q_min_size=1, q_max_size=3), seed=5)
    assert not tbuf.ready()
    for jr, tr in zip(_records(jrecords, size), _records(trecords, size)):
        jbuf.insert(jr)
        tbuf.insert(tr)
    assert tbuf.ready() and tbuf.wait_ready(timeout=0.1)
    assert [len(q) for q in tbuf.queues] == [len(q) for q in jbuf.queues]
    assert tbuf.size() == jbuf.size() < 13          # eviction happened
    assert tbuf.info() == jbuf.info()
    js, ts = jbuf.sample_many(40), tbuf.sample_many(40)
    assert [r.seq for r in ts] == [r.seq for r in js]
    assert all(r.black_win == (i % 2 == 1)
               for i, q in enumerate(tbuf.queues) for r in q)
    jb = jreplay_mod.sample_training_batch(jbuf, 8, size,
                                           np.random.RandomState(1))
    tb = treplay_mod.sample_training_batch(tbuf, 8, size,
                                           np.random.RandomState(1))
    assert tb[0] == jb[0]
    for a, b in zip(tb[1:], jb[1:]):
        np.testing.assert_array_equal(a, b)
    tbuf.clear()
    assert tbuf.size() == 0 and tbuf.sample() is None


@pytest.mark.parametrize("size,data_aug,T", [(9, -1, 1), (19, -1, 3), (9, 5, 2)])
def test_host_and_device_batches_match_jax(size, data_aug, T):
    jopts = JReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
    topts = ReplayOptions(num_reader=2, q_min_size=1, q_max_size=50)
    jp = jpipeline.TrainingPipeline(
        jreplay_mod.ReplayBuffer(jopts, seed=3), size, seed=4,
        data_aug=data_aug, num_future_actions=T)
    tp = tpipeline.TrainingPipeline(
        treplay_mod.ReplayBuffer(topts, seed=3), size, seed=4,
        data_aug=data_aug, num_future_actions=T)
    assert tp.sample_host_batch(4) is None
    for jr, tr in zip(_records(jrecords, size), _records(trecords, size)):
        jp.insert_record(jr)
        tp.insert_record(tr)
    for _ in range(2):
        jhb, thb = jp.sample_host_batch(16), tp.sample_host_batch(16)
        for name in thb._fields:
            a, b = getattr(thb, name), getattr(jhb, name)
            if b is None:               # the df fields of an AGZ batch
                assert a is None, name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        zero = tp.zero_host_batch(16)
        assert [a if a is None else (a.dtype, a.shape) for a in zero] == \
            [a if a is None else (a.dtype, a.shape) for a in thb]

        jf, jpi, jw = jp.device_batch(jhb)
        tf, tpi, tw = tp.device_batch(thb, device="cpu")
        assert tf.dtype == torch.float32 and tuple(tf.shape) == (16, size, size, 18)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))

        jf, ja, jw = jp.device_batch_offline(jhb)
        tf, ta, tw = tp.device_batch_offline(thb, device="cpu")
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if data_aug < 0:
        assert len(set(thb.codes.tolist())) > 2
    assert set(thb.selfplay_ver.tolist()) <= {-1, 3, 4}


def test_replay_item_matches_jax():
    size = 9
    # a game with a real ko: find one among the golden games by the JAX item
    found_ko = 0
    for jr, tr in zip(_records(jrecords, size, 16), _records(trecords, size, 16)):
        ji, ti = jpipeline.ReplayItem(jr, size), tpipeline.ReplayItem(tr, size)
        assert ti.moves == ji.moves and ti.first_player == ji.first_player
        np.testing.assert_array_equal(ti.snapshots, ji.snapshots)
        np.testing.assert_array_equal(ti.setup_board, ji.setup_board)
        assert ti.black_win == ji.black_win
        for ply in range(len(ti.moves) + 1):
            assert ti.ko_at(ply, size) == ji.ko_at(ply, size)
            found_ko += ti.ko_at(ply, size) >= 0
            assert ti.to_play_at(ply) == ji.to_play_at(ply)
            np.testing.assert_array_equal(ti.board_at(ply), ji.board_at(ply))
            np.testing.assert_array_equal(ti.last_placed_at(ply, size * size),
                                          ji.last_placed_at(ply, size * size))
    # a hand-made ko on 5x5: white 7 is captured by black at 8
    moves = [2, 3, 6, 9, 12, 13, 25, 7, 8]
    rec = trecords.make_record(moves, 1.0, [None] * 9, [0.0] * 9, 5)
    jrec = jrecords.make_record(moves, 1.0, [None] * 9, [0.0] * 9, 5)
    ti, ji = tpipeline.ReplayItem(rec, 5), jpipeline.ReplayItem(jrec, 5)
    assert ti.ko_at(9, 5) == ji.ko_at(9, 5) == 7
    assert [ti.ko_at(p, 5) for p in range(9)] == [-1] * 9


def test_unported_pipeline_options_raise():
    """df batches are built (tests/test_torch_df.py holds them against the
    JAX pipeline); an unknown feature set and an odd reader count raise."""
    buf = treplay_mod.ReplayBuffer(ReplayOptions(num_reader=2))
    assert tpipeline.TrainingPipeline(buf, 9, feature_set="df").feature_set \
        == "df"
    with pytest.raises(ValueError):
        tpipeline.TrainingPipeline(buf, 9, feature_set="agz25")
    with pytest.raises(AssertionError):
        treplay_mod.ReplayBuffer(ReplayOptions(num_reader=3))
    if not torch.cuda.is_available():
        tp = tpipeline.TrainingPipeline(buf, 9)
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.device_batch(tp.zero_host_batch(2))
