"""The port's deployment topology in real OS processes on the CPU: the twin
of tests/test_multiprocess.py::test_server_and_client_process_cheat_smoke
with the torch entry scripts (`--device cpu`).  One
scripts/train_server_torch.py and one scripts/selfplay_client_torch.py
drive a record -> replay -> train -> checkpoint cycle over TCP with cheat
modes.  The server drives the client's search (TSOptions in every
request), so it gets the small rollout budget here too."""

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
