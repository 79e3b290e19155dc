"""The port's deployment topology in real OS processes on the CPU: the twin
of tests/test_multiprocess.py::test_server_and_client_process_cheat_smoke
with the torch entry scripts (`--device cpu`).  One
scripts/train_server_torch.py and one scripts/selfplay_client_torch.py
drive a record -> replay -> train -> checkpoint cycle over TCP with cheat
modes.  The server drives the client's search (TSOptions in every
request), so it gets the small rollout budget here too.

The multi-process learner's twins of tests/test_multiprocess.py: two
processes in one gloo world take a dp-sharded step; two
`train_server_torch.py --dist_*` ranks fed by a client agree on every
loss and promote a candidate in cheat mode."""

import json
import os
import re
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


@pytest.mark.timeout(600)
def test_server_and_client_process_cheat_smoke(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    port = free_port()
    logs = {"server": str(tmp_path / "server.log"),
            "client0": str(tmp_path / "client0.log")}

    def dump_logs() -> str:
        parts = []
        for name, path in logs.items():
            try:
                with open(path) as f:
                    parts.append(f"----- {name} -----\n{f.read()[-4000:]}")
            except OSError:
                parts.append(f"----- {name}: <no log> -----")
        return "\n".join(parts)

    common = [
        "--board_size", "5", "--num_block", "1", "--dim", "8",
        "--port", str(port), "--komi", "5.5", "--device", "cpu",
        "--num_rollouts", "4", "--rollouts_per_batch", "2",
    ]
    server_log = open(logs["server"], "w")
    server = subprocess.Popen(
        [PY, os.path.join(REPO, "scripts/train_server_torch.py"),
         "--ckpt_dir", ckpt, "--batchsize", "4", "--num_minibatch", "2",
         "--num_episodes", "1", "--use_mesh", "0",
         "--expected_num_clients", "1", "--selfplay_init_num", "2",
         "--selfplay_update_num", "1", "--eval_num_games", "2",
         "--q_min_size", "1", "--q_max_size", "16", "--num_reader", "2",
         "--num_cooldown", "1",
         *common],
        cwd=REPO, env=_env(), stdout=server_log,
        stderr=subprocess.STDOUT, text=True,
    )
    clients = []
    client_logs = []
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if server.poll() is not None:
                pytest.fail(f"server died early:\n{dump_logs()}")
            try:
                with open(logs["server"]) as f:
                    if "server up on :" in f.read():
                        break
            except OSError:
                pass
            time.sleep(0.5)
        else:
            pytest.fail(f"server never became ready:\n{dump_logs()}")

        cl = open(logs["client0"], "w")
        client_logs.append(cl)
        clients.append(subprocess.Popen(
            [PY, os.path.join(REPO, "scripts/selfplay_client_torch.py"),
             "--ckpt_dir", ckpt, "--num_games", "2",
             "--move_cutoff", "6", "--moves_per_round", "6",
             "--seed", "100",
             "--cheat_selfplay_random_result", "1",
             "--cheat_eval_new_model_wins_half", "1",
             *common],
            cwd=REPO, env=_env(), stdout=cl,
            stderr=subprocess.STDOUT, text=True,
        ))

        # the client has no round/game limit: it works until the server
        # has finished its episode and exits (it is stopped in the finally)
        try:
            server.wait(timeout=300)
        except subprocess.TimeoutExpired:
            pytest.fail(f"server timed out:\n{dump_logs()}")
        with open(logs["server"]) as f:
            out = f.read()
        assert server.returncode == 0, (
            f"server rc={server.returncode}:\n{dump_logs()}"
        )
        saves = [f for f in os.listdir(ckpt)
                 if re.match(r"save-\d+\.bin$", f)]
        vers = sorted(int(re.match(r"save-(\d+)", f).group(1)) for f in saves)
        assert vers[0] == 0 and vers[-1] >= 1, saves
        assert "episode 1" in out
        assert "] summary {" in out
        jdir = os.path.join(ckpt, "journal")
        journal_lines = 0
        for f in os.listdir(jdir):
            with open(os.path.join(jdir, f)) as fh:
                journal_lines += sum(1 for line in fh if line.strip())
        assert journal_lines >= 2, f"no records journaled\n{dump_logs()}"
    finally:
        for c in clients:
            if c.poll() is None:
                c.terminate()
                try:
                    c.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    c.kill()
                    c.wait()
        if server.poll() is None:
            server.kill()
            server.wait()
        server_log.close()
        for cl in client_logs:
            cl.close()
    # SIGTERM ends the client's loop cleanly: it logs its summary, exit 0
    with open(logs["client0"]) as f:
        client_out = f.read()
    assert clients[0].returncode == 0, dump_logs()
    assert "] summary {" in client_out, dump_logs()


# ---------------------------------------------------------------------------
# the multi-process learner (twins of tests/test_multiprocess.py's
# jax.distributed tests): ranks over gloo on the CPU
# ---------------------------------------------------------------------------

def _read(path) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


@pytest.mark.timeout(300)
def test_two_process_torch_distributed_learner(tmp_path):
    """Two OS processes join one gloo world (`maybe_initialize_distributed`
    from the env fallbacks) and take a dp-sharded train step, each on its
    half of the batch; both report the same loss (the dp mean), which is
    the single-process step's."""
    port = free_port()
    script = tmp_path / "worker.py"
    script.write_text(f"""
import os, sys
sys.path.insert(0, {REPO!r})
import numpy as np
import torch
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.parallel.distributed import maybe_initialize_distributed
from elf_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh, make_sharded_train_step, shard_state)
from elf_tpu_torch.training.trainer import Trainer

cfg = ModelConfig(board_size=5, num_planes=18, num_block=1, dim=8,
                  use_bf16=False)
trainer = Trainer(cfg, TrainOptions(batchsize=8, num_block=1, dim=8),
                  device="cpu")
state = trainer.init_state(torch.Generator().manual_seed(0))
full = torch.from_numpy(np.linspace(0, 1, 8 * 5 * 5 * 18, dtype=np.float32
                                    ).reshape(8, 5, 5, 18))
pi = torch.full((8, 26), 1.0 / 26.0)
w = torch.ones(8)
if sys.argv[1] == "single":
    _, stats = trainer.make_train_step()(state, full, pi, w)
    print("WORKER_OK single", round(float(stats["loss/total"]), 6))
    sys.exit(0)
assert maybe_initialize_distributed(backend="gloo")
mesh = make_mesh(2, tp=1)
step, shardings = make_sharded_train_step(trainer, mesh, state)
rows = batch_sharding(mesh, 8)
_, stats = step(shard_state(state, shardings), full[rows], pi[rows], w[rows])
print("WORKER_OK", mesh.rank, round(float(stats["loss/total"]), 6))
""")
    procs = []
    for pid in ("0", "1", "single"):
        env = _env()
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=pid if pid != "single" else "")
        procs.append(subprocess.Popen(
            [PY, str(script), pid], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for out in outs:
        m = re.search(r"WORKER_OK \w+ ([\d.eE+-]+)", out)
        assert m, out[-2000:]
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1]
    assert losses[0] == pytest.approx(losses[2], rel=1e-5)


@pytest.fixture(scope="module")
def dist_fleet(tmp_path_factory):
    """Two `train_server_torch.py --device cpu --dist_*` ranks (gloo) and
    one `selfplay_client_torch.py` at 5x5, cheat modes on, until the first
    promotion: rank 0 hosts the control plane, rank 1 follows its
    broadcasts.  Returns (rank logs, client log, ckpt dir, return codes)."""
    tmp = tmp_path_factory.mktemp("dist_fleet")
    port, coord = free_port(), free_port()
    ckpt = str(tmp / "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    logs = {i: str(tmp / f"server{i}.log") for i in range(2)}
    logs["client"] = str(tmp / "client.log")
    common = ["--board_size", "5", "--num_block", "1", "--dim", "8",
              "--port", str(port), "--komi", "5.5", "--device", "cpu"]
    files, servers, client = [], [], None

    def dump_logs() -> str:
        return "\n".join(f"----- {n} -----\n{_read(p)[-4000:]}"
                         for n, p in logs.items())

    try:
        for pid in range(2):
            lf = open(logs[pid], "w")
            files.append(lf)
            servers.append(subprocess.Popen(
                [PY, os.path.join(REPO, "scripts/train_server_torch.py"),
                 "--ckpt_dir", ckpt, "--batchsize", "8",
                 "--num_minibatch", "4", "--num_episodes", "0",
                 "--target_promotions", "1", "--max_seconds", "150",
                 "--use_mesh", "1", "--ckpt_keep", "100",
                 "--dist_coordinator", f"127.0.0.1:{coord}",
                 "--dist_num_processes", "2", "--dist_process_id", str(pid),
                 # expected 2 so the first client is allocated eval duty
                 "--expected_num_clients", "2", "--selfplay_init_num", "4",
                 "--num_rollouts", "4", "--rollouts_per_batch", "2",
                 "--selfplay_update_num", "2", "--eval_num_games", "8",
                 "--eval_winrate_thres", "0.45",
                 "--q_min_size", "1", "--q_max_size", "16",
                 "--num_reader", "2", "--num_cooldown", "1", *common],
                cwd=REPO, env=_env(), stdout=lf, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.time() + 120
        while "server up on :" not in _read(logs[0]):
            for pid in range(2):
                if servers[pid].poll() is not None:
                    pytest.fail(f"server {pid} died early:\n{dump_logs()}")
            if time.time() > deadline:
                pytest.fail(f"server never became ready:\n{dump_logs()}")
            time.sleep(0.5)
        cl = open(logs["client"], "w")
        files.append(cl)
        client = subprocess.Popen(
            [PY, os.path.join(REPO, "scripts/selfplay_client_torch.py"),
             "--ckpt_dir", ckpt, "--num_games", "2",
             "--num_rollouts", "4", "--rollouts_per_batch", "2",
             "--move_cutoff", "6", "--moves_per_round", "6", "--seed", "42",
             "--cheat_eval_new_model_wins_half", "1",
             "--cheat_selfplay_random_result", "1", *common],
            cwd=REPO, env=_env(), stdout=cl, stderr=subprocess.STDOUT,
            text=True)
        # rank 0 exits once the promotion target is reached; rank 1
        # follows through the broadcast stop flag
        for pid in range(2):
            try:
                servers[pid].wait(timeout=200)
            except subprocess.TimeoutExpired:
                pytest.fail(f"server {pid} timed out:\n{dump_logs()}")
    finally:
        if client is not None and client.poll() is None:
            client.terminate()
            try:
                client.wait(timeout=60)
            except subprocess.TimeoutExpired:
                client.kill()
                client.wait()
        for s in servers:
            if s.poll() is None:
                s.kill()
                s.wait()
        for f in files:
            f.close()
    return ({i: _read(logs[i]) for i in range(2)}, ckpt,
            [s.returncode for s in servers], dump_logs())


@pytest.mark.timeout(300)
def test_distributed_learner_fed_by_control_plane(dist_fleet):
    """Both ranks train on batches of real client records (rank 0 samples
    its replay and broadcasts) and agree on every episode's losses."""
    outs, _, rcs, logs = dist_fleet
    assert rcs == [0, 0], logs
    assert "{'dp': 2, 'tp': 1}" in outs[0] and "(2 processes)" in outs[0]
    episodes = [re.findall(r"episode (\d+): ver (\d+), (\{.*?\}) \|",
                           outs[i]) for i in range(2)]
    assert episodes[0] and episodes[0] == episodes[1], logs
    assert "loss/total" in episodes[0][0][2]
    assert "worker 1" in outs[1]


@pytest.mark.timeout(300)
def test_distributed_learner_promotes(dist_fleet):
    """A candidate the two-rank learner trained is promoted by the
    production EvalSubCtrl in the same run (cheat eval: win rate 0.5
    against the lowered 0.45 threshold); rank 0 wrote its checkpoint."""
    _, ckpt, rcs, logs = dist_fleet
    assert rcs == [0, 0], logs
    with open(os.path.join(ckpt, "promotions.jsonl")) as f:
        promos = [json.loads(line) for line in f if line.strip()]
    assert len(promos) >= 1, logs
    ev = promos[0].get("eval")
    assert ev is not None and ev["baseline"] == 0
    assert ev["winrate"] >= 0.45
    assert os.path.exists(os.path.join(ckpt, f"save-{promos[0]['ver']}.bin"))
