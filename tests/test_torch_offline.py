"""The port's supervised path against the JAX package on the CPU: the C
move-string codec and main-line SGF parser, `record_from_sgf`, the
`OfflineLoader`, the offline train step inside `LearnerRunner`, and the two
entry points that reach it (`train_server_torch.py --model df_pred`,
`demo_supervised_torch.py`).

Inputs are seeded: random legal 5x5 games played by the port's engine,
written as SGF files with the port's writer.  Tolerances: the codec,
records, loader order and host batches exact; the fp32 offline steps 1e-5
on every parameter, BN statistic, optimizer slot and stat after three
steps, relative to the stat, or to the tensor's largest element, where
that exceeds 1."""

import gzip
import json
import os
import subprocess
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from elf_tpu.config import ReplayOptions as JReplayOptions
from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.native import sgf_codec as jcodec
from elf_tpu.training import offline as joffline
from elf_tpu.training.pipeline import TrainingPipeline as JPipeline
from elf_tpu.training.replay import ReplayBuffer as JReplay
from elf_tpu.training.runner import LearnerRunner as JRunner
from elf_tpu.training.trainer import Trainer as JTrainer
from elf_tpu_torch import _build
from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.env.go import engine as tengine
from elf_tpu_torch.models.checkpoint import _opt_tree
from elf_tpu_torch.models.resnet import ModelConfig, load_flax_trees, params_to_jax
from elf_tpu_torch.native import sgf_codec as tcodec
from elf_tpu_torch.sgf import game_from_moves, serialize_sgf
from elf_tpu_torch.training import offline as toffline
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import Trainer

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "ref_sgf_codec_19.jsonl.gz")
SIZE, BATCH = 5, 8


def _outcome(fn, *args):
    """fn(*args), or the exception's type where it raises."""
    try:
        return fn(*args)
    except Exception as e:      # the two packages must raise alike
        return type(e).__name__


def _random_games(n, size, plies, seed):
    """Move lists of `n` random legal games (passes rare), played in
    lockstep by the port's engine."""
    rng = np.random.default_rng(seed)
    n2 = size * size
    core = tengine.init_core(n, size, "cpu")
    legal = np.ones((n, n2 + 1), bool)
    moves = [[] for _ in range(n)]
    for _ in range(plies):
        w = legal.astype(float)
        w[:, n2] = 0.02
        a = np.array([rng.choice(n2 + 1, p=r / r.sum()) for r in w], np.int32)
        core, info = tengine.step_core(core, torch.from_numpy(a), size)
        legal = info.legal_next.numpy()
        for i in range(n):
            moves[i].append(int(a[i]))
    return moves


def _sgf_texts(n, size=SIZE, plies=12, seed=0):
    """SGF files of random games; results alternate between the colours."""
    out = []
    for i, mv in enumerate(_random_games(n, size, plies, seed)):
        res = f"B+{i + 0.5}" if i % 2 == 0 else "W+R"
        out.append(serialize_sgf(game_from_moves(mv, size, result=res)))
    return out


def _rec_json(rec):
    if rec is None:
        return None
    d = rec.to_json()
    d.pop("timestamp")
    return d


# ---------------------------------------------------------------- the codec

def _golden():
    with gzip.open(GOLDEN, "rt") as f:
        return [json.loads(line) for line in f]


def test_codec_matches_jax_on_the_golden_games():
    """The reference's own codec output (tests/golden): the port's C codec
    encodes and decodes every game as the JAX one does, byte for byte."""
    for g in _golden():
        s = tcodec.moves_to_sgf_string(g["moves"], 19)
        assert s == g["sgf"] == jcodec.moves_to_sgf_string(g["moves"], 19)
        back = tcodec.sgf_string_to_moves(g["sgf"], 19)
        assert back == g["moves"] == jcodec.sgf_string_to_moves(g["sgf"], 19)


@pytest.mark.parametrize("s,size", [
    ("", 19), ("(", 19), ("()", 9), ("(;B[aa];W[", 19), ("(;B[abc])", 19),
    ("(;B[zz])", 19), ("(;B[tt];W[tt])", 19), ("(;B[tt])", 21),
    ("(;B[aa]", 9), ("xyz", 5), ("(;B[ia];W[]", 9), ("(;B[aa])", 0),
    ("(;B[aa];W[bb];B[cc];W[dd];B[ee];W[ff];B[gg];W[hh];B[ii])", 9),
])
def test_codec_decode_malformed_matches_jax(s, size):
    """Text the C decoder refuses takes the Python codec's answer (or its
    exception) in both packages."""
    assert _outcome(tcodec.sgf_string_to_moves, s, size) == \
        _outcome(jcodec.sgf_string_to_moves, s, size)


@pytest.mark.parametrize("moves,size", [
    ([], 19), ([0, 360, 361], 19), ([362], 19), ([-1, 4], 5), ([3], 0),
    ([3], 26), (list(range(25)) + [25], 5),
])
def test_codec_encode_edges_match_jax(moves, size):
    assert _outcome(tcodec.moves_to_sgf_string, moves, size) == \
        _outcome(jcodec.moves_to_sgf_string, moves, size)


@pytest.mark.parametrize("text", [
    "(;GM[1]SZ[9]KM[6.5]HA[0]RE[B+R];B[ee];W[];B[tt];W[aa])",
    "(;SZ[19]RE[W+12.5];B[pd](;W[dp];B[qq])(;W[dd]))",
    "(;SZ[5]C[a [bracket\\] comment]AB[aa][bb];B[cc];W[dd])",
    "(;SZ[5]RE[" + "B+" + "x" * 100 + "];B[cc])",     # RE cut at 63 bytes
    "(;SZ[5];B[ff])", "(;SZ[5];B[abc])", "(;SZ[5];B[aa]", ")(",
    "(;SZ[5]" + ";B[aa];W[bb]" * 1100 + ")",           # over 2048 moves
    "no sgf at all", "",
])
def test_parse_sgf_main_matches_jax(text):
    assert tcodec.parse_sgf_main(text) == jcodec.parse_sgf_main(text)


def test_codec_build_failure_raises(monkeypatch):
    """A codec that does not build raises: no Python path takes its place."""
    monkeypatch.setattr(tcodec, "_lib", None)

    def broken(name):
        raise RuntimeError(f"build failed for {name}.c")

    monkeypatch.setattr(_build, "load", broken)
    for call in (lambda: tcodec.moves_to_sgf_string([0], 5),
                 lambda: tcodec.sgf_string_to_moves("(;B[aa])", 5),
                 lambda: tcodec.parse_sgf_main("(;B[aa])"),
                 lambda: toffline.record_from_sgf("(;SZ[5];B[aa])")):
        with pytest.raises(RuntimeError, match="build failed"):
            call()


# -------------------------------------------------------------- the records

@pytest.mark.parametrize("text,expected", [
    ("(;GM[1]SZ[5]RE[W+3.5];B[aa];W[bb])", None),
    ("(;GM[1]SZ[5]RE[b+1.5];B[aa];W[bb];B[cc])", 5),
    ("(;SZ[9]RE[B+R];B[ee];W[];B[tt])", None),
    ("(;SZ[9]RE[B+R];B[ee])", 5),                  # another size
    ("(;SZ[5]RE[B+1])", None),                     # no moves
    ("(;SZ[5];B[aa];W[bb])", None),                # no result: white
    ("(;SZ[5]RE[W+1];B[ff])", None),               # off the board
    ("(;SZ[5]RE[B+1];B[aa];W[bb]", None),          # C refuses, Python tries
    ("not sgf at all", None),
])
def test_record_from_sgf_matches_jax(text, expected):
    t = _outcome(toffline.record_from_sgf, text, expected)
    j = _outcome(joffline.record_from_sgf, text, expected)
    if isinstance(j, str):
        assert t == j
        return
    assert _rec_json(t) == _rec_json(j)
    if j is not None:
        assert t.offline and j.offline
        assert t.result.reward == j.result.reward


def test_offline_loader_matches_jax(tmp_path):
    """SGF, JSONL and JSON-list files and a broken file: the same records
    in the same order in every replay shard, and the same host batch."""
    texts = _sgf_texts(10)
    for i, t in enumerate(texts[:7]):
        (tmp_path / f"g{i:02d}.sgf").write_text(t)
    (tmp_path / "g99.sgf").write_text("(;SZ[9]RE[B+1];B[aa])")  # wrong size
    recs = [toffline.record_from_sgf(t) for t in texts[7:]]
    (tmp_path / "a.jsonl").write_text(
        "\n".join(json.dumps(r.to_json()) for r in recs[:2]) + "\n")
    (tmp_path / "b.json").write_text(json.dumps([recs[2].to_json()]))
    (tmp_path / "c.json").write_text("{broken")
    (tmp_path / "ignored.txt").write_text("(;SZ[5]RE[B+1];B[aa])")

    ropts = dict(num_reader=4, q_min_size=1, q_max_size=100)
    tp = TrainingPipeline(ReplayBuffer(ReplayOptions(**ropts), seed=3), SIZE,
                          seed=1)
    jp = JPipeline(JReplay(JReplayOptions(**ropts), seed=3), SIZE, seed=1)
    nt = toffline.OfflineLoader(tp, num_threads=4).load_dir(str(tmp_path))
    nj = joffline.OfflineLoader(jp, num_threads=4).load_dir(str(tmp_path))
    assert nt == nj == 10
    for tq, jq in zip(tp.replay.queues, jp.replay.queues):
        assert [_rec_json(it.record) for it in tq] == \
            [_rec_json(it.record) for it in jq]
        for ti, ji in zip(tq, jq):
            np.testing.assert_array_equal(ti.snapshots, ji.snapshots)
    first = sorted(str(f) for f in tmp_path.iterdir())[:3]
    assert toffline.OfflineLoader(tp).load_paths(first) == 3
    assert joffline.OfflineLoader(jp).load_paths(first) == 3
    thb, jhb = tp.sample_host_batch(BATCH), jp.sample_host_batch(BATCH)
    for name in jhb._fields:
        a, b = getattr(jhb, name), getattr(thb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


# ---------------------------------------------------- the offline learner

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_close(ours, ref, tol, what):
    """Every element within `tol` of its reference, absolute and relative.
    A BN running statistic averages a channel's activations, so its
    fp32 rounding scales with them, not with the average: a mean is held
    within `tol` times the channel's root mean square (sqrt(var + mean^2)),
    a variance within `tol` times its mean square (the df planes hold a 1e4
    distance plane, so a channel of the first BN layer can average values
    of 1e2 to 1e3 to a mean near 10)."""
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys(), what
    for k, r in ref.items():
        atol = tol
        if k.endswith(("/mean", "/var")):
            bn = k.rsplit("/", 1)[0]
            square = ref[bn + "/var"] + ref[bn + "/mean"] ** 2
            scale = square if k.endswith("/var") else np.sqrt(square)
            atol = tol * np.maximum(1.0, scale)
        err = np.abs(ours[k] - r)
        bound = atol + tol * np.abs(r)
        assert ours[k].shape == r.shape and (err <= bound).all(), \
            (what + k, float((err / bound).max()))


@pytest.fixture(scope="module")
def records():
    return [toffline.record_from_sgf(t) for t in _sgf_texts(12, plies=14,
                                                           seed=5)]


@pytest.mark.parametrize("T,df", [(1, False), (2, False), (1, True),
                                  (2, True)])
def test_offline_runner_matches_jax(records, tmp_path, T, df):
    """`LearnerRunner(train_mode="offline")` in both packages from the same
    flax-initialised parameters, fed the same records: three minibatches
    give the same stats, parameters, BN statistics and optimizer slots
    (fp32, 1e-5), at T = 1 and 2 future actions, AGZ and df planes."""
    fs = "df" if df else "agz"
    planes = 25 if df else 18
    opts = dict(batchsize=BATCH, num_block=1, dim=8, bf16=False, lr=0.05)
    net = dict(board_size=SIZE, num_planes=planes, num_block=1, dim=8,
               use_bf16=False)
    ropts = dict(num_reader=2, q_min_size=1, q_max_size=100)
    jp = JPipeline(JReplay(JReplayOptions(**ropts), seed=0), SIZE, seed=2,
                   num_future_actions=T, feature_set=fs)
    tp = TrainingPipeline(ReplayBuffer(ReplayOptions(**ropts), seed=0), SIZE,
                          seed=2, num_future_actions=T, feature_set=fs)
    for r in records:
        jp.insert_record(r)
        tp.insert_record(r)
    jr = JRunner(JTrainer(JModelConfig(**net), JTrainOptions(**opts)), jp,
                 str(tmp_path / "j"), JTrainOptions(**opts), seed=4,
                 train_mode="offline")
    tr = LearnerRunner(Trainer(ModelConfig(**net), TrainOptions(**opts),
                               device="cpu"), tp, str(tmp_path / "t"),
                       TrainOptions(**opts), seed=0, train_mode="offline")
    load_flax_trees(tr.state.net, jax.device_get(jr.state.params),
                    jax.device_get(jr.state.batch_stats))
    for step in range(3):
        js, ts = jr.run_minibatch(), tr.run_minibatch()
        assert ts.keys() == js.keys()
        assert "acc/top1" in ts and "grad_norm" in ts
        for k in js:
            assert abs(ts[k] - js[k]) <= 1e-5 * max(1.0, abs(js[k])), \
                (step, k, ts[k], js[k])
    params, stats = params_to_jax(tr.state.net)
    jstate = jax.device_get(jr.state)
    _assert_trees_close(params, jstate.params, 1e-5, "params")
    _assert_trees_close(stats, jstate.batch_stats, 1e-5, "batch_stats")
    _assert_trees_close(
        _opt_tree(tr.state.net.cfg, tr.state.opt_state),
        flax.serialization.to_state_dict(jstate.opt_state), 1e-5,
        "opt_state")
    assert tr.version() == jr.version() == 3


def test_offline_remat_step_equals_plain_step(records):
    """Under `ModelConfig(remat=True)` the offline step writes the BN
    statistics once per step: three steps from one state leave the plain
    steps' BN statistics bit for bit and parameters within 1e-6."""
    import copy
    import dataclasses

    tp = TrainingPipeline(ReplayBuffer(ReplayOptions(num_reader=2,
                                                     q_min_size=1), seed=0),
                          SIZE, seed=2, num_future_actions=2)
    for r in records:
        tp.insert_record(r)
    cfg = ModelConfig(board_size=SIZE, num_block=2, dim=8, use_bf16=False)
    opts = TrainOptions(batchsize=BATCH, lr=0.05)
    plain = Trainer(cfg, opts, device="cpu")
    remat = Trainer(dataclasses.replace(cfg, remat=True), opts, device="cpu")
    a = plain.init_state(torch.Generator().manual_seed(1))
    b = copy.deepcopy(a)
    b.net.cfg = remat.cfg
    step_a = plain.make_offline_train_step()
    step_b = remat.make_offline_train_step()
    for _ in range(3):
        batch = tp.device_batch_offline(tp.sample_host_batch(BATCH), "cpu")
        a, sa = step_a(a, *batch)
        b, sb = step_b(b, *batch)
        for k in sa:
            assert abs(float(sa[k]) - float(sb[k])) <= 1e-6, k
    for (n, x), (_, y) in zip(a.net.named_buffers(), b.net.named_buffers()):
        assert torch.equal(x, y), n
    for (n, x), (_, y) in zip(a.net.named_parameters(),
                              b.net.named_parameters()):
        torch.testing.assert_close(y, x, atol=1e-6, rtol=0, msg=n)


# ----------------------------------------------------------- entry points

def test_train_server_df_pred_takes_a_minibatch(records, tmp_path,
                                                monkeypatch):
    """`train_server_torch.py --model df_pred --device cpu` builds an
    offline learner on AGZ planes; given records, its runner takes a
    supervised minibatch (stopped here before the server starts)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import train_server_torch

    seen = {}

    class Stop(Exception):
        pass

    def runner(trainer, pipeline, *args, **kwargs):
        r = LearnerRunner(trainer, pipeline, *args, **kwargs)
        for rec in records:
            pipeline.insert_record(rec)
        seen.update(mode=r.train_mode, stats=r.run_minibatch(),
                    step=r.version(), planes=trainer.cfg.num_planes)
        raise Stop

    monkeypatch.setattr(train_server_torch, "LearnerRunner", runner)
    with pytest.raises(Stop):
        train_server_torch.main([
            "--ckpt_dir", str(tmp_path), "--device", "cpu", "--model",
            "df_pred", "--num_block", "1", "--dim", "8", "--board_size",
            str(SIZE), "--batchsize", str(BATCH), "--port", "0",
            "--q_min_size", "1", "--num_future_actions", "2"])
    assert seen["mode"] == "offline" and seen["step"] == 1
    assert seen["planes"] == 18
    assert {"acc/top1", "acc/top5", "loss/policy", "grad_norm"} <= \
        seen["stats"].keys()
    assert all(np.isfinite(v) for v in seen["stats"].values())


def test_demo_supervised_script_runs(tmp_path):
    """`scripts/demo_supervised_torch.py --device cpu` on an archive of
    eight 19x19 games: the JAX script's JSON lines, with the loaded count
    and a final summary."""
    for i, text in enumerate(_sgf_texts(8, size=19, plies=20, seed=9)):
        (tmp_path / f"g{i}.sgf").write_text(text)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "demo_supervised_torch.py"),
         "--device", "cpu", "--sgf_dir", str(tmp_path), "--blocks", "1",
         "--dim", "8", "--batch", "8", "--steps", "3",
         "--num_future_actions", "2"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert lines[0] == {"loaded_games": 8, "model": "df_pred",
                        "train_mode": "offline", "feature_set": "agz"}
    assert [x["step"] for x in lines[1:-1]] == [0, 2]
    final = lines[-1]
    assert final["final"] and final["chance_floor"] == round(1 / 362, 4)
    assert {"acc_first10", "acc_last10", "learned", "wall_s"} <= final.keys()
    missing = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "demo_supervised_torch.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert missing.returncode != 0 and "--sgf_dir" in missing.stderr
