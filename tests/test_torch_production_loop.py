"""The port's production control plane on the CPU: the twin of
tests/test_production_loop.py with scripts/prove_production_torch.py, the
command lines both proof scripts give their processes, the committed 9x9
and 13x13 inits the card runs start from, and the anchor tool's flags.

The twin runs 1 train_server_torch + 2 selfplay_client_torch processes
over TCP with no cheat flags, at the JAX test's arguments, from the JAX
package's own seed-11 learner state: the port draws another init from the
same seed (a seeded torch.Generator, not a PRNG key), and at this size
whether a candidate clears the gate turns on the init.  Its `--out` holds
that state as ckpt/save-0.bin, ckpt/latest and init.bin, so the script's
resume path loads it.  Every process runs one host thread: three torch
processes at the default thread count oversubscribe the cores and run
the protocol many times slower.

The init tests are exact: runs/prod9/init.bin and runs/prod13/init.bin
are, leaf for leaf and dtype for dtype, the states the JAX `LearnerRunner`
draws at seed 11 for the 9x9 4b64c protocol and the README's 13x13 10b128c
command (what the JAX server writes as save-0.bin)."""

import json
import os
import shutil
import subprocess

import flax
import numpy as np
import pytest
import torch

from elf_tpu.config import ReplayOptions as JReplayOptions
from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.registry import make_trainer as jmake_trainer
from elf_tpu.training.pipeline import TrainingPipeline as JTrainingPipeline
from elf_tpu.training.replay import ReplayBuffer as JReplayBuffer
from elf_tpu.training.runner import LearnerRunner as JLearnerRunner
from elf_tpu.training.trainer import save_checkpoint as jsave_checkpoint
from scripts import prove_production
from scripts import prove_production_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROD13_PROMOTED = os.path.join(REPO, "runs", "prod13", "promoted-160.bin")

# tests/test_production_loop.py's arguments, --device for --platform
CI5 = ["--board_size", "5", "--num_block", "1", "--dim", "16",
       "--num_games", "24", "--komi", "2.5",
       "--rollouts", "16", "--rollouts_per_batch", "8",
       "--eval_rollouts", "0", "--eval_num_games", "16",
       "--selfplay_init_num", "64", "--selfplay_update_num", "32",
       "--num_minibatch", "24", "--train_bs", "64",
       "--target_promotions", "1", "--final_games", "0",
       "--max_seconds", "1200"]
# the README's 13x13 command (README.md, "13x13, half-depth production net")
PROD13 = ["--board_size", "13", "--num_block", "10", "--dim", "128",
          "--num_games", "192", "--client1_num_games", "96",
          "--eval_num_games", "400", "--value_weight", "0.25",
          "--train_bs", "256", "--num_minibatch", "40",
          "--selfplay_init_num", "150", "--selfplay_update_num", "75"]


def jax_learner_state(argv, ckpt_dir):
    """The JAX server's initial learner state for the proof script's
    arguments `argv`: `LearnerRunner(..., seed)` as train_server.py builds
    it (an empty replay, so its save-0.bin has no cooldown pass)."""
    args = prove_production.parse_args(["--out", "unused", *argv])
    to = JTrainOptions(batchsize=args.train_bs, lr=args.lr,
                       num_block=args.num_block, dim=args.dim,
                       value_loss_weight=args.value_weight)
    trainer, _, _ = jmake_trainer("df_kl", args.board_size, to)
    pipeline = JTrainingPipeline(JReplayBuffer(JReplayOptions(),
                                               seed=args.seed),
                                 args.board_size, seed=args.seed)
    return JLearnerRunner(trainer, pipeline, ckpt_dir, to,
                          seed=args.seed).state


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# ------------------------------------------------------------ the init

@pytest.mark.parametrize("run, argv, n_params", [
    ("prod9", [], 341_824),
    ("prod13", PROD13, 3_079_720),
], ids=["prod9", "prod13"])
def test_prod9_init_is_the_jax_seed11_learner_state(run, argv, n_params,
                                                    tmp_path):
    """runs/<run>/init.bin is the JAX learner's seed-11 state at the
    proof's arguments, exactly: params, BN statistics, optimizer slots and
    step.  prod9: prove_production.py's defaults (9x9, 4 blocks x 64
    channels); prod13: the README's 13x13 command (10 blocks x 128
    channels), whose tree is also that of the JAX run's promoted ver 160."""
    state = jax_learner_state(argv, str(tmp_path))
    want = flax.serialization.to_state_dict(state)
    with open(os.path.join(REPO, "runs", run, "init.bin"), "rb") as f:
        got = flax.serialization.msgpack_restore(f.read())
    assert int(got["step"]) == 0 == int(want["step"])
    count = 0
    for tree in ("params", "batch_stats", "opt_state"):
        ours = dict(_leaves(want[tree]))
        ref = dict(_leaves(got[tree]))
        assert ours.keys() == ref.keys() and ref, tree
        for k, v in ref.items():
            assert v.dtype == ours[k].dtype and v.shape == ours[k].shape, k
            assert np.array_equal(v, ours[k]), k
            if tree == "params":
                count += v.size
    assert count == n_params
    if run == "prod13":
        with open(PROD13_PROMOTED, "rb") as f:
            promoted = flax.serialization.msgpack_restore(f.read())
        assert int(promoted["step"]) == 160
        assert promoted.keys() == got.keys()
        for tree in ("params", "batch_stats", "opt_state"):
            ours = dict(_leaves(got[tree]))
            theirs = dict(_leaves(promoted[tree]))
            assert ours.keys() == theirs.keys(), tree
            for k, v in theirs.items():
                assert (v.dtype, v.shape) == (ours[k].dtype, ours[k].shape), k


# ------------------------------------------------------------ the twin

@pytest.fixture
def one_thread(monkeypatch):
    """One host thread in this process and in every process it spawns."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.timeout(600)
def test_production_control_plane_promotes(tmp_path, one_thread):
    out = str(tmp_path / "prod5")
    ckpt = os.path.join(out, "ckpt")
    # the JAX run's starting point, as its server writes it
    jsave_checkpoint(ckpt, jax_learner_state(CI5, ckpt))
    shutil.copy(os.path.join(ckpt, "save-0.bin"),
                os.path.join(out, "init.bin"))
    assert os.readlink(os.path.join(ckpt, "latest")) == "save-0.bin"

    rc = prove_production_torch.main(["--out", out, "--device", "cpu",
                                      *CI5])
    with open(os.path.join(out, "server.log")) as f:
        server_log = f.read()
    assert "resumed from " + os.path.join(ckpt, "latest") + " at step 0" \
        in server_log, server_log[-4000:]
    assert rc == 0, "no real promotion within budget\n" + server_log[-4000:]

    # the promotion is real: against the version-0 baseline, and decided
    # soundly -- either the 16 requested games ran, or the win-rate
    # bound's early stop fired and the worst-case rate (every undone game
    # a loss) clears the threshold itself
    with open(os.path.join(ckpt, "promotions.jsonl")) as f:
        promos = [json.loads(line) for line in f if line.strip()]
    assert len(promos) >= 1
    ev = promos[0]["eval"]
    assert ev["baseline"] == 0
    assert ev["winrate"] >= 0.55
    lower = ev["n_win"] / max(1, 16 - ev["n_stuck"])
    assert ev["n_done"] + ev["n_stuck"] >= 16 or lower >= 0.55, ev
    with open(os.path.join(out, "eval_ladder.txt")) as f:
        ladder = f.read().splitlines()
    print("# eval ladder:", *ladder, sep="\n# ")
    assert ladder and ladder[-1].startswith(
        f"PROMOTE eval {promos[0]['ver']} vs 0:"), ladder

    # records really flowed over TCP: the server journaled them
    jdir = os.path.join(ckpt, "journal")
    journal_lines = sum(
        1
        for fn in os.listdir(jdir)
        for line in open(os.path.join(jdir, fn))
        if line.strip()
    )
    assert journal_lines >= 64  # at least the selfplay_init_num bar


# ------------------------------------------------------------ the commands

class Stop(Exception):
    pass


def commands_of(module, out, argv, monkeypatch):
    """Run `module.main` until its monitor starts, with every process it
    spawns stubbed; return the argv and environment of each process in
    spawn order.  A stub server logs its readiness at once, and a stub
    client 0 its registration."""
    spawned = []

    class Proc:
        def __init__(self, cmd, cwd=None, env=None, stdout=None, **kw):
            spawned.append((list(cmd), dict(env)))
            self.alive = True
            if "server" in os.path.basename(cmd[1]):
                ckpt = cmd[cmd.index("--ckpt_dir") + 1]
                open(os.path.join(ckpt, "save-0.bin"), "a").close()
                stdout.write("] server up on :1, initial version 0\n")
            elif len(spawned) == 2:
                with open(os.path.join(out, "server.log"), "a") as f:
                    f.write("] new client: eval_then_selfplay\n")
            stdout.flush()

        def poll(self):
            return None if self.alive else 0

        def send_signal(self, sig):
            self.alive = False

        def wait(self, timeout=None):
            return 0

    class Monitor:
        def __init__(self, *a, **k):
            pass

        def send(self, *a):
            raise Stop

        def close(self):
            pass

    import elf_tpu.control.transport as jtransport
    import elf_tpu_torch.control.transport as ttransport

    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(jtransport, "ControlClient", Monitor)
    monkeypatch.setattr(ttransport, "ControlClient", Monitor)
    with pytest.raises(Stop):
        module.main(["--out", out, *argv])
    return spawned


def _resumed(out):
    """An --out whose first run ended after 100 s."""
    os.makedirs(os.path.join(out, "ckpt"))
    open(os.path.join(out, "ckpt", "save-0.bin"), "w").close()
    os.symlink("save-0.bin", os.path.join(out, "ckpt", "latest"))
    open(os.path.join(out, "init.bin"), "w").close()
    with open(os.path.join(out, "progress.json"), "w") as f:
        json.dump({"wall": 100.0, "runs": 1}, f)


@pytest.mark.parametrize("argv, resumed", [
    ([], False),
    (CI5, False),
    (["--board_size", "19", "--num_clients", "3", "--num_games", "64",
      "--client1_num_games", "12", "--eval_num_threads", "64",
      "--seed", "3"], True),
    (PROD13, False),
], ids=["prod9_defaults", "ci5", "19x19_three_clients_resumed",
        "prod13_readme"])
def test_commands_match_the_jax_script(argv, resumed, tmp_path,
                                       monkeypatch):
    """The server's and each client's argv, flag for flag: the protocol
    (cutoff max(4, n2*30//361), pass ply max(6, n2*160//361), --q_min_size
    4, --num_reader 8, --load on a resume, the budget left), the client
    seeds seed + 100 + 37k + 1000 runs, and client 0 first.  The one
    difference: the port's processes get --device, the JAX ones their
    platform through the environment."""
    port = ["--port", "5999"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    if resumed:
        _resumed(jout)
        _resumed(tout)
    jcmds = commands_of(prove_production, jout,
                        [*argv, *port, "--platform", "cpu"], monkeypatch)
    tcmds = commands_of(prove_production_torch, tout,
                        [*argv, *port, "--device", "cpu"], monkeypatch)
    args = prove_production.parse_args(["--out", jout, *argv])
    assert len(jcmds) == len(tcmds) == 1 + args.num_clients
    for (jcmd, jenv), (tcmd, _) in zip(jcmds, tcmds):
        assert tcmd[0] == jcmd[0]
        assert tcmd[1] == jcmd[1].replace(".py", "_torch.py")
        i = tcmd.index("--device")
        assert tcmd[i + 1] == "cpu"
        theirs = [a.replace(jout, tout) for a in jcmd[2:]]
        assert tcmd[2:i] + tcmd[i + 2:] == theirs
        assert jenv["JAX_PLATFORMS"] == "cpu"

    # what the flags say, read from the port's commands
    n2 = args.board_size ** 2
    runs = 2 if resumed else 1
    server = tcmds[0][0]
    flag = lambda cmd, name: cmd[cmd.index(name) + 1]
    assert flag(server, "--q_min_size") == "4"
    assert flag(server, "--num_reader") == "8"
    assert ("--load" in server) == resumed
    if resumed:
        assert flag(server, "--load") == os.path.join(tout, "ckpt", "latest")
        assert float(flag(server, "--max_seconds")) == \
            args.max_seconds - 100.0
    for k, (cmd, _) in enumerate(tcmds[1:]):
        assert flag(cmd, "--policy_distri_cutoff") == str(
            max(4, n2 * 30 // 361))
        assert flag(cmd, "--ply_pass_enabled") == str(
            max(6, n2 * 160 // 361))
        assert flag(cmd, "--seed") == str(
            args.seed + 100 + 37 * k + 1000 * runs)
        boards = args.num_games if k == 0 else (
            args.client1_num_games if args.client1_num_games > 0
            else max(args.num_games // 2, 8))
        assert flag(cmd, "--num_games") == str(boards)


# ------------------------------------------------------------ the tools

def _tool(rel):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tool_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FakeActor:
    """Plays nothing: each call of `play_moves` finishes one game per
    board, the first board's won by black, the second's by white."""

    def __init__(self, batch, rec):
        self.batch, self.rec, self.completed_games = batch, rec, 0

    def reset_all(self):
        pass

    def play_moves(self, params, bstats, n):
        out = []
        for b in range(self.batch):
            r = self.rec.Record()
            r.result.reward = 1.0 if b == 0 else -1.0
            r.result.num_move = 100 + b
            out.append(r)
        self.completed_games += self.batch
        return out


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_anchor_tool_passes_the_proof_flags(package, monkeypatch, capsys):
    """tools/prod_anchor_parity.py hands the proof's own flags and the
    port's --device to the proof's parse_args (the JAX package keeps its
    CPU platform), patches the anchor's opening cutoff in, and counts the
    games the anchor's head_to_head plays."""
    if package == "jax":
        from elf_tpu.selfplay import actor as actor_mod
        from elf_tpu.selfplay import records as rec
        from elf_tpu.tools import match
        proof = prove_production
    else:
        from elf_tpu_torch.selfplay import actor as actor_mod
        from elf_tpu_torch.selfplay import records as rec
        from elf_tpu_torch.tools import match
        proof = prove_production_torch
    seen = {}

    def final_anchor_match(args, ver):
        seen.update(args=args, ver=ver, cutoff=actor_mod.ActorConfig(
            board_size=13, batch=2).policy_distri_cutoff)
        seen["actor"] = _FakeActor(2, rec)
        return match.head_to_head(seen["actor"], ("a", None), ("b", None), 2)

    monkeypatch.setattr(proof, "final_anchor_match", final_anchor_match)
    config = actor_mod.ActorConfig
    tool = _tool("tools/prod_anchor_parity.py")
    tool.main(["--package", package, "--out", "RUN", "--ver", "160",
               "--games", "4", "--cutoff", "3", "--device", "cpu",
               *PROD13, "--final_rollouts", "32"])
    line = json.loads(capsys.readouterr().out)
    args = seen["args"]
    want = prove_production.parse_args(["--out", "RUN", "--final_games", "4",
                                        *PROD13, "--final_rollouts", "32"])
    for k, v in vars(want).items():
        if k != "platform":
            assert getattr(args, k) == v, k
    if package == "jax":
        assert args.platform == "cpu"
    else:
        assert args.device == "cpu"
    assert seen["ver"] == 160 and seen["cutoff"] == 3
    assert actor_mod.ActorConfig is config          # the patch is undone
    # one call of 16 moves a half; black wins on the first board
    assert line == {
        "package": package, "ver": 160, "cutoff": 3, "board_size": 13,
        "rollouts": 32, "wins": 2, "n": 4, "as_black": 1, "as_white": 1,
        "first_k": 200, "first_k_wins": 2, "moves": [100, 100, 101, 101],
        "lockstep_moves": 32, "wall_s": line["wall_s"]}


def test_anchor_tool_defaults_the_port_to_cuda():
    tool = _tool("tools/prod_anchor_parity.py")
    args, rest = tool.parse_args(["--package", "torch", "--out", "R",
                                  "--ver", "1", "--board_size", "13"])
    assert args.device == "cuda" and rest == ["--board_size", "13"]


@pytest.mark.parametrize("limit_mb, kept", [(60.0, 40), (1.1, None)],
                         ids=["whole", "oldest_records_left_out"])
def test_run_carry_round_trip(limit_mb, kept, tmp_path):
    """tools/run_carry.py packs what the proof resumes from and unpacks
    it: the checkpoint `latest` names, bit for bit; promoted-<ver>.bin
    without its optimizer slots; the small files; the journal's records
    in order, the oldest left out when the limit is short."""
    from elf_tpu_torch.models import checkpoint

    carry = _tool("tools/run_carry.py")
    out = tmp_path / "run"
    jdir = out / "ckpt" / "journal"
    jdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = [json.dumps({"seq": i, "q": rng.integers(0, 255, 4000).tolist()})
             + "\n" for i in range(40)]
    (jdir / "records-0.jsonl").write_text("".join(lines[:25]))
    (jdir / "records-1.jsonl").write_text("".join(lines[25:]))
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32)},
            "batch_stats": {"m": torch.ones(2)},
            "opt_state": {"w": torch.full((6,), 2.0)}, "step": 40}
    blob = checkpoint.msgpack_serialize(tree)
    (out / "ckpt" / "save-40.bin").write_bytes(blob)
    os.symlink("save-40.bin", out / "ckpt" / "latest")
    (out / "promoted-40.bin").write_bytes(blob)
    (out / "progress.json").write_text('{"wall": 3200.0, "runs": 1}')
    (out / "server.log").write_text("] PROMOTE eval 40 vs 0: wr=0.6\n")
    (out / "client0.log").write_text("not carried\n")
    (out / "init.bin").write_bytes(blob)

    meta = carry.pack(str(out), str(tmp_path / "c.tar"), limit_mb)
    assert meta["records"] == 40
    back = tmp_path / "back"
    got = carry.unpack(str(tmp_path / "c.tar"), str(back))
    assert got["records_kept"] == meta["records_kept"]
    n = meta["records_kept"]
    if kept is not None:
        assert n == kept
    else:
        assert 0 < n < 40
        assert meta["archive_bytes"] <= limit_mb * 2 ** 20
    assert (back / "ckpt" / "journal" / "records-0.jsonl").read_text() == \
        "".join(lines[40 - n:])
    assert os.readlink(back / "ckpt" / "latest") == "save-40.bin"
    assert (back / "ckpt" / "save-40.bin").read_bytes() == blob
    promoted = checkpoint.read_checkpoint(str(back / "promoted-40.bin"))
    assert sorted(promoted) == ["batch_stats", "params", "step"]
    assert torch.equal(promoted["params"]["w"], tree["params"]["w"])
    assert (back / "progress.json").read_text() == \
        '{"wall": 3200.0, "runs": 1}'
    assert (back / "server.log").exists()
    assert not (back / "client0.log").exists()
    assert not (back / "init.bin").exists()
