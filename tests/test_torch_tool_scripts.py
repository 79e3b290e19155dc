"""The port's match, Elo, demo, profile and ladder scripts on the CPU
(`--device cpu`, 5x5 to 19x19 boards, 1-block 8-channel nets), driven
through their `main(argv)`:

 - flag parity: each script's argparse dests include its JAX twin's;
 - `eval_match_torch` and `elo_progression_torch` on checkpoints written
   by the JAX package: output lines and keys, totals of at least 2 x
   games per half (`head_to_head` counts every game a call of
   `play_moves` finishes), the per-colour split adding up to the wins, `elo_delta` equal to
   `elo_diff` of the win rate (rounded as printed), return code 1 with one
   checkpoint.  The scripts draw random symmetries, which the two packages
   draw differently, so their games are not compared; one level down,
   `head_to_head` on both packages' pair-eval actors without random
   symmetries gives equal wins, totals and records, policy-only and at 8
   rollouts (evaluators exact in float32, tolerance 0);
 - `demo_train_9x9_torch`: the net the final eval plays as the random
   initialisation is the initialisation, bit for bit, after training;
 - `profile_mcts_torch`: its JSON keys are the JAX script's, and
   `--trace_dir` writes a trace;
 - `ladder_bench_torch` and `tools/ladder_scorecard_doc_torch.py` on a
   suite built in a temporary directory; `prove_learning_torch
   --ladder_every 1` at 19x19 writes the `init` row, whose matched count
   is `ladder_policy_scorecard`'s on `init.bin`.
"""

import argparse
import ast
import copy
import functools
import importlib.util
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.selfplay.actor import ActorConfig as JActorConfig
from elf_tpu.selfplay.actor import SelfplayActor as JSelfplayActor
from elf_tpu.selfplay.actor import make_pair_eval_builder as jmake_pair
from elf_tpu.tools import ladder as jladder
from elf_tpu.tools import match as jmatch
from elf_tpu.training.trainer import Trainer as JTrainer
from elf_tpu.training.trainer import save_params_checkpoint as jsave_params
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import (
    ActorConfig,
    SelfplayActor,
    make_pair_eval_builder,
)
from elf_tpu_torch.sgf import game_from_moves, serialize_sgf
from elf_tpu_torch.tools import ladder as tladder
from elf_tpu_torch.tools import match as tmatch
from elf_tpu_torch.tools.match import elo_diff
from elf_tpu_torch.training.trainer import Trainer, load_checkpoint

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the nets are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("scripts/eval_match.py", "scripts/eval_match_torch.py"),
         ("scripts/elo_progression.py", "scripts/elo_progression_torch.py"),
         ("scripts/demo_train_9x9.py", "scripts/demo_train_9x9_torch.py"),
         ("scripts/ladder_bench.py", "scripts/ladder_bench_torch.py"),
         ("scripts/profile_mcts.py", "scripts/profile_mcts_torch.py"),
         ("tools/ladder_scorecard_doc.py",
          "tools/ladder_scorecard_doc_torch.py")]


def load_script(rel):
    """A script of the repo as a module (its `main` not run)."""
    name = "_script_" + re.sub(r"\W", "_", rel)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def parser_actions(rel, monkeypatch) -> list:
    """The argparse actions of the parser a script's `main` builds:
    `parse_args` is stopped before anything else runs."""
    def stop(parser, args=None, namespace=None):
        raise _Parsed(parser._actions)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as got:
            load_script(rel).main([])
    return got.value.args[0]


def argparse_dests(rel, monkeypatch) -> set:
    return {a.dest for a in parser_actions(rel, monkeypatch)} - {"help"}


def printed_keys(rel) -> list:
    """The constant keys of the dict literals a script passes to
    `json.dumps`, in source order."""
    keys = []
    for node in ast.walk(ast.parse(open(os.path.join(REPO, rel)).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys.append((node.lineno, [k.value for k in node.args[0].keys
                                       if isinstance(k, ast.Constant)]))
    return [k for _, k in sorted(keys)]


@pytest.mark.parametrize("jax_script,torch_script", PAIRS)
def test_flags_include_the_jax_scripts(jax_script, torch_script,
                                       monkeypatch):
    jd = argparse_dests(jax_script, monkeypatch)
    td = argparse_dests(torch_script, monkeypatch)
    assert jd <= td, sorted(jd - td)
    assert td - jd <= {"device", "use_bf16"}


@pytest.mark.parametrize("jax_script,torch_script", [
    ("scripts/ladder_bench.py", "scripts/ladder_bench_torch.py"),
    ("scripts/profile_mcts.py", "scripts/profile_mcts_torch.py"),
    ("scripts/elo_progression.py", "scripts/elo_progression_torch.py"),
])
def test_output_keys_are_the_jax_scripts(jax_script, torch_script):
    j, t = printed_keys(jax_script), printed_keys(torch_script)
    # the port's scripts add their launch-count line on stderr
    assert [k for k in t if k != ["device", "kernel_launches"]] == j
    assert len(j) >= 1


# ---------------------------------------------------------------------------
# checkpoints written by the JAX package, read by both
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """save-<step>.bin of three 5x5 1-block 8-channel JAX nets (steps 0, 5,
    9) in one directory, and a lone one in another."""
    d = tmp_path_factory.mktemp("ckpts")
    trainer = JTrainer(JModelConfig(board_size=5, num_block=1, dim=8),
                       JTrainOptions(num_block=1, dim=8))
    for step, seed in ((0, 1), (5, 2), (9, 3)):
        jsave_params(str(d / f"save-{step}.bin"),
                     trainer.init_state(jax.random.PRNGKey(seed)))
    lone = tmp_path_factory.mktemp("lone")
    jsave_params(str(lone / "save-3.bin"),
                 trainer.init_state(jax.random.PRNGKey(4)))
    return d, lone


NET5 = ["--board_size", "5", "--num_block", "1", "--dim", "8"]


def test_eval_match_script(jax_ckpts, capsys):
    d, _ = jax_ckpts
    mod = load_script("scripts/eval_match_torch.py")
    mod.main(["--device", "cpu", *NET5, "--komi", "2.5",
              "--a", str(d / "save-9.bin"), "--b", str(d / "save-0.bin"),
              "--num_eval_games", "4", "--num_rollouts", "4",
              "--rollouts_per_batch", "4"])
    out, err = capsys.readouterr()
    m = re.fullmatch(r"A=save-9\.bin vs B=save-0\.bin: (\d+)/(\d+) = "
                     r"(\d\.\d{3})  elo_diff=([+-]\d+\.\d)  \((.*)\)\n", out)
    assert m, out
    wins, total = int(m.group(1)), int(m.group(2))
    # head_to_head counts every game a call finishes, past the quota too
    assert total >= 4 and float(m.group(3)) == round(wins / total, 3)
    assert float(m.group(4)) == round(elo_diff(wins / total), 1)
    lines = err.strip().splitlines()
    games = [l for l in lines if l.startswith("game ")]
    assert len(games) == total
    assert sum(" A wins " in g for g in games) == wins
    summary = json.loads(lines[-1])
    assert summary["device"] == "cpu"
    assert set(summary["kernel_launches"]) == {"analyze_libs",
                                               "step_analysis"}


def test_elo_progression_script(jax_ckpts, capsys):
    d, lone = jax_ckpts
    mod = load_script("scripts/elo_progression_torch.py")
    common = ["--device", "cpu", "--board_size", "5", "--blocks", "1",
              "--dim", "8", "--komi", "2.5", "--games_per_pair", "4",
              "--num_rollouts", "4", "--rollouts_per_batch", "4"]
    assert mod.main(["--ckpt_dir", str(d), "--max_pairs", "1", *common]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    # --max_pairs 1 keeps the first checkpoint and the last pair
    assert rows[0] == {"step": 0, "elo": 0.0, "anchor": True}
    assert [(r["step"], r["vs_step"]) for r in rows[1:]] == [(9, 0)]
    for r in rows[1:]:
        assert r["n"] >= 4 and r["winrate"] == round(r["wins"] / r["n"], 4)
        assert r["elo_delta"] == round(elo_diff(r["wins"] / r["n"]), 1)
        assert r["elo"] == r["elo_delta"]

    assert mod.main(["--ckpt_dir", str(lone), "--include_init",
                     str(d / "save-5.bin"), "--pairs", "3:0", *common]) == 0
    out, err = capsys.readouterr()
    (row,) = [json.loads(l) for l in out.splitlines()]
    assert (row["step"], row["vs_step"], row["direct"]) == (3, 0, True)
    assert row["n"] >= 4 and row["rollouts"] == 4
    assert row["wins_as_black"] + row["wins_as_white"] == row["wins"]
    assert row["wins_as_black"] <= row["black_wins_total"] <= row["n"]
    assert row["elo_delta"] == round(elo_diff(row["wins"] / row["n"]), 1)
    assert json.loads(err.strip().splitlines()[-1])["device"] == "cpu"

    assert mod.main(["--ckpt_dir", str(lone), *common]) == 1
    assert "need at least two checkpoints" in capsys.readouterr().err


def _exact_pair_raw(xp):
    """eval_raw(model, batch_stats, feats) of exact models: model k (an
    integer, a traced one under jit) favours an eighth of the points that
    depends on k (log-prior 0 there, -16 elsewhere, so the policy-only
    argmax finds a legal move when every favoured point is taken) and
    values (own - opponent stones) / 16.  Within one package equal priors
    stay equal, and the values are exact in float32."""
    A = 26

    def raw(model, batch_stats, feats):
        favored = (np.arange(A) * 37 + 13 + 3 * model) % 8 == 0
        log_prior = xp.where(xp.asarray(favored), xp.asarray(0.0),
                             xp.asarray(-16.0))
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, 25).sum(-1)
        theirs = feats[..., 1].reshape(K, 25).sum(-1)
        return (xp.broadcast_to(log_prior[None, :], (K, A)),
                xp.clip((mine - theirs) / 16.0, -1.0, 1.0))

    return raw


@pytest.mark.parametrize("rollouts", [0, 8])
def test_head_to_head_pair_actors_match_jax(rollouts):
    acfg = dict(board_size=5, batch=2, komi=2.5, policy_distri_cutoff=-1,
                resign_thres=0.0, never_resign_prob=1.0)
    mcfg = dict(num_rollouts=rollouts, rollouts_per_batch=4,
                rotation_flip=False, root_epsilon=0.0, komi=2.5,
                ply_pass_enabled=8)
    jactor = JSelfplayActor(
        JActorConfig(**acfg), JMCTSConfig(**mcfg),
        jmake_pair(_exact_pair_raw(jax.numpy)), seed=3)
    tactor = SelfplayActor(
        ActorConfig(**acfg), MCTSConfig(**mcfg),
        make_pair_eval_builder(_exact_pair_raw(torch)), seed=3,
        device="cpu")
    jsink, tsink = [], []
    jres = jmatch.head_to_head(jactor, (1, 0), (0, 0), 2, moves_per_call=8,
                               record_sink=jsink)
    tres = tmatch.head_to_head(tactor, (1, None), (0, None), 2,
                               moves_per_call=8, record_sink=tsink)
    assert tres == jres and tres[1] >= 4
    assert [(r.result.content, r.result.reward, won) for r, won in tsink] \
        == [(r.result.content, r.result.reward, won) for r, won in jsink]


# ---------------------------------------------------------------------------
# the demo, the profile
# ---------------------------------------------------------------------------

@pytest.mark.timeout(400)
def test_demo_keeps_its_init_snapshot(tmp_path, monkeypatch, capsys):
    """The final eval plays the trained net against the initialisation as
    it was drawn (the runner's seed 0), though the train step updates the
    runner's net in place."""
    mod = load_script("scripts/demo_train_9x9_torch.py")
    played = []

    def recording(actor, a_state, b_state, games_per_half, **kw):
        played.append((copy.deepcopy(a_state[0]), copy.deepcopy(b_state[0])))
        return tmatch.head_to_head(actor, a_state, b_state, games_per_half,
                                   **kw)

    monkeypatch.setattr(mod, "head_to_head", recording)
    mod.main(["--device", "cpu", "--out",
              str(tmp_path / "demo"), "--iters", "14", "--blocks", "1",
              "--dim", "8", "--batch_boards", "32", "--rollouts", "8",
              "--train_bs", "32", "--minibatches_per_iter", "2",
              "--eval_games", "4", "--final_eval", "policy"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    steps = [l["step"] for l in lines if "iter" in l]
    assert steps[-1] > 0, "the demo never trained"
    assert all(np.isfinite(l["loss"]) for l in lines if "loss" in l)
    final = lines[-1]
    # head_to_head counts every game a call finishes, past the quota too
    w, n = map(int, final["policy_only_trained_vs_random"].split("/"))
    assert final["final"] and 0 <= w <= n and n >= 4
    assert final["policy_only_winrate"] == round(w / n, 3)

    init = Trainer(ModelConfig(board_size=9, num_block=1, dim=8),
                   TrainOptions(num_block=1, dim=8), device="cpu"
                   ).init_state(torch.Generator().manual_seed(0)).net
    (trained, random0), = played
    for (name, a), b in zip(init.state_dict().items(),
                            random0.state_dict().values()):
        assert torch.equal(a, b), name
    assert any(not torch.equal(a, b) for a, b in zip(
        init.state_dict().values(), trained.state_dict().values()))


def test_profile_script_keys_and_trace(tmp_path, capsys):
    mod = load_script("scripts/profile_mcts_torch.py")
    trace = tmp_path / "trace"
    assert mod.main(["--device", "cpu", "--B", "2", "--rollouts", "8",
                     "--m", "4", "--blocks", "1", "--dim", "8", "--iters",
                     "1", "--trace_dir", str(trace)]) == 0
    out, err = capsys.readouterr()
    row = json.loads(out)
    (jkeys,) = printed_keys("scripts/profile_mcts.py")
    assert list(row) == jkeys
    assert row["B"] == 2 and row["t_full_ms"] > 0 and row["nn_fraction"] > 0
    assert json.loads(err.strip().splitlines()[-1])["device"] == "cpu"
    assert [p.suffix for p in trace.iterdir()] == [".json"]


# ---------------------------------------------------------------------------
# the ladder scripts on a temporary suite
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Three golden 19x19 games as SGF and six probes."""
    import gzip

    root = tmp_path_factory.mktemp("suite")
    with gzip.open(os.path.join(REPO, "tests", "golden",
                                "ref_traj_19.jsonl.gz"), "rt") as f:
        games = [json.loads(l)["actions"] for l in f][:3]
    (root / "ladder").mkdir()
    for i, g in enumerate(games):
        (root / "ladder" / f"g{i}.sgf").write_text(
            serialize_sgf(game_from_moves([int(a) for a in g], 19)))
    (root / "ladder_list").write_text(
        "g0.sgf 10\ng0.sgf 22\ng1.sgf 15\ng1.sgf 1\ng2.sgf 8\ng2.sgf 30\n")
    return str(root)


def test_ladder_bench_script(suite, monkeypatch, capsys):
    """Random weights from seed 0, raw policy: the score equals the batched
    scorecard on the same net; with a search, one line of the same keys."""
    monkeypatch.setattr(tladder, "DEFAULT_SUITE", suite)
    mod = load_script("scripts/ladder_bench_torch.py")
    net = ["--device", "cpu", "--num_block", "1", "--dim", "8",
           "--use_bf16", "0"]
    mod.main(net)
    (row,) = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    (jkeys,) = printed_keys("scripts/ladder_bench.py")
    assert list(row) == jkeys
    assert (row["total"], row["mode"], row["weights"]) == \
        (6, "raw_policy", "random")
    cfg = ModelConfig(num_block=1, dim=8, use_bf16=False)
    model = Trainer(cfg, TrainOptions(num_block=1, dim=8), "cpu").init_state(
        torch.Generator().manual_seed(0)).net
    card = tladder.ladder_policy_scorecard(lambda f, tp: model(f),
                                           device="cpu")
    assert row["matched"] == card.matched

    mod.main([*net, "--num_rollouts", "8", "--limit", "2"])
    (row,) = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert (row["total"], row["mode"]) == (2, "mcts8")


def test_ladder_scorecard_doc_tool(suite, tmp_path, monkeypatch):
    """The same rows as the JAX tool on one suite and one run card."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "ladder_scorecard.jsonl").write_text(json.dumps(
        {"step": 0, "games": 0, "matched": 1, "total": 6,
         "accuracy": 0.1667, "weights": "init"}) + "\n")
    monkeypatch.setattr(tladder, "DEFAULT_SUITE", suite)
    monkeypatch.setattr(jladder, "classify_suite",
                        functools.partial(jladder.classify_suite, suite))
    outs = {}
    for rel in ("tools/ladder_scorecard_doc.py",
                "tools/ladder_scorecard_doc_torch.py"):
        outs[rel] = tmp_path / (os.path.basename(rel) + ".jsonl")
        assert load_script(rel).main(["--run", str(run), "--out",
                                      str(outs[rel])]) == 0
    j, t = (p.read_text() for p in outs.values())
    assert t == j and len(t.splitlines()) == 2
    assert json.loads(t.splitlines()[0])["total"] == 6
    # the default output lies under build/, not over the JAX tool's file
    dests = {a.dest: a.default for a in parser_actions(
        "tools/ladder_scorecard_doc_torch.py", monkeypatch)}
    assert dests["out"].startswith("build/")


@pytest.mark.timeout(400)
def test_prove_learning_ladder_init_row(suite, tmp_path, monkeypatch):
    from scripts.prove_learning_torch import main as prove_main

    monkeypatch.setattr(tladder, "DEFAULT_SUITE", suite)
    out = tmp_path / "run"
    rc = prove_main(["--device", "cpu", "--use_bf16", "0", "--out", str(out),
                     "--board_size", "19", "--blocks", "1", "--dim", "8",
                     "--batch_boards", "2", "--rollouts", "4",
                     "--rollouts_per_batch", "4", "--ladder_every", "1",
                     "--max_seconds", "1"])
    assert rc == 1                       # cut by --max_seconds
    (row,) = [json.loads(l) for l in open(out / "ladder_scorecard.jsonl")]
    assert (row["step"], row["games"], row["weights"], row["total"]) == \
        (0, 0, "init", 6)
    trainer = Trainer(ModelConfig(num_block=1, dim=8, use_bf16=False),
                      TrainOptions(num_block=1, dim=8), "cpu")
    init = load_checkpoint(str(out / "init.bin"), template=trainer.init_state(
        torch.Generator().manual_seed(5)))
    card = tladder.ladder_policy_scorecard(lambda f, tp: init.net(f),
                                           device="cpu")
    assert row["matched"] == card.matched
    assert row["accuracy"] == round(card.matched / 6, 4)
