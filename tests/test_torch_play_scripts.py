"""The port's play scripts as processes on the CPU (`--device cpu`, 5x5, a
1-block 16-channel net): `scripts/gtp_console_torch.py` answers a piped GTP
script and `scripts/analysis_torch.py` analyses an SGF, each ending with
its JSON summary on stderr; both load a whole checkpoint and a params-only
export; without `--device` and without a card each refuses to start and
names `--device cpu`."""

import json
import os
import subprocess
import sys

import pytest
import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models.checkpoint import save_checkpoint, save_params_checkpoint
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.sgf import game_from_moves, serialize_sgf
from elf_tpu_torch.training.trainer import Trainer

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = ["--board_size", "5", "--num_block", "1", "--dim", "16"]
SEARCH = ["--num_rollouts", "16", "--rollouts_per_batch", "4"]
GTP = """protocol_version
boardsize 5
clear_board
komi 7.5
play B C3
genmove W
genmove B
play W A1
showboard
undo
final_score
elf-ladder B A2
quit
"""


def run(script, args, stdin="", timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), *args],
        input=stdin, capture_output=True, text=True, timeout=timeout,
        env=env, cwd=REPO)


def exit_summary(proc) -> dict:
    return json.loads(proc.stderr.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A whole checkpoint and a params-only export of one random net."""
    d = tmp_path_factory.mktemp("weights")
    to = TrainOptions(num_block=1, dim=16)
    trainer = Trainer(ModelConfig(board_size=5, num_block=1, dim=16), to,
                      device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(4))
    return {"save": save_checkpoint(str(d), state),
            "export": save_params_checkpoint(str(d / "export.bin"), state)}


@pytest.mark.parametrize("load", ["random", "save", "export"])
def test_gtp_console_script(load, weights):
    extra = [] if load == "random" else ["--load", weights[load]]
    proc = run("gtp_console_torch.py",
               ["--device", "cpu", *NET, *SEARCH, "--persistent_tree", "true",
                "--seed", "1", *extra], GTP)
    assert proc.returncode == 0, proc.stderr[-3000:]
    answers = [a for a in proc.stdout.split("\n\n") if a.strip()]
    assert len(answers) == GTP.count("\n")
    assert not any(a.startswith("?") for a in answers), proc.stdout
    assert answers[0] == "= 2"
    moves = [answers[5][2:], answers[6][2:]]
    assert all(m == "pass" or m[0] in "ABCDE" for m in moves), moves
    assert "X" in answers[8] and answers[10].startswith("= ")
    s = exit_summary(proc)
    assert s["device"] == "cpu" and s["genmoves"] == 2
    assert s["searches"] == 2 and s["rollouts_per_search"] == 16
    assert len(s["genmove_s"]) == 2 and all(t > 0 for t in s["genmove_s"])
    assert s["rollouts_per_s"] > 0
    assert s["root_reused"][0] is False and s["root_reused"][1] is True
    assert s["carried_visits"] == s["expected_carry"]
    # the plain versions ran: no kernel launch is counted on the CPU
    assert s["kernel_launches"] == {"analyze_libs": 0, "step_analysis": 0}
    assert s["peak_memory_bytes"] is None


def test_analysis_script(tmp_path, weights):
    sgf = tmp_path / "game.sgf"
    sgf.write_text(serialize_sgf(game_from_moves([12, 6, 18, 7, 13, 11, 16],
                                                 5)))
    prefix = tmp_path / "tree"
    proc = run("analysis_torch.py",
               ["--device", "cpu", *NET, *SEARCH, "--load", weights["export"],
                "--preload_sgf", str(sgf), "--preload_sgf_move_to", "3",
                "--follow_sgf", "--max_moves", "3", "--dump_record_prefix",
                str(prefix), "--verbose"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4 and lines[-1].startswith("final_score ")
    for ply, line in zip((3, 4, 5), lines):
        assert line.split()[0] == str(ply) and " suggest " in line
        text = (tmp_path / f"tree_0_{ply}.tree").read_text()
        assert "- Total visit: 16" in text
    s = exit_summary(proc)
    assert s["searches"] == 3 and s["preloaded_moves"] == 3
    assert len(s["position_s"]) == 3 and s["rollouts_per_s"] > 0


@pytest.mark.parametrize("script", ["gtp_console_torch.py",
                                    "analysis_torch.py"])
def test_play_scripts_need_a_card_unless_asked_for_the_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    proc = run(script, [*NET, *SEARCH], "quit\n", timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""
