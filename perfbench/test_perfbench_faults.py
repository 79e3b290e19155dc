"""The check against faults planted in the program, on the CPU at tiny
sizes, and the control on the card at the cells' own sizes.

    python -m pytest perfbench/test_perfbench_faults.py -q -n 0
    python -m pytest -o addopts= -m cuda perfbench/test_perfbench_faults.py

A fault test skips the look for a card and drives the rest of a run
(`core.run_cell`) of a tiny cell of each traffic kind, held to the limits
of that kind's cell in BENCHMARK.json, with the program broken underneath
as the builders' rule lists: a step that returns its state unchanged,
half of the batch left out with the mean taken over the rest, and an
answer altered where it is produced (one chip: no exchange between chips
to leave out).  The sound run must come out correct and each fault not.

The control test (marked `cuda`, skipped without a card) reads each cell
at its own size on three seeds through `control.readings` and asserts
that the control fails at least one of the cell's limits on every seed
while the program passes them all.
"""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402
from test_perfbench_cpu import tiny_run  # noqa: E402

LIMITS_OF = {"selfplay": "go13_10b128c.selfplay_b192_r96",
             "env": "go19_20b256c.env_b4096",
             "train": "go19_20b256c.train_b2048"}
TRAFFIC = {
    "selfplay": dict(kind="selfplay", boards=4, rollouts=16,
                     rollouts_per_batch=4, c_puct=1.5, virtual_loss=1,
                     root_epsilon=0.25, root_alpha=0.2, ply_pass_enabled=30,
                     rotation_flip=True, eval_chunk=0, batched_writes="auto",
                     max_batches_per_call=0, policy_distri_cutoff=4,
                     resign_thres=0.0, never_resign_prob=1.0, warm_moves=1,
                     trace_moves=2, check_boards=4, check_nodes=48),
    "env": dict(kind="env", boards=16, chunk=8, warm_chunks=1,
                trace_chunks=2, check_boards=16, max_checks=50),
    "train": dict(kind="train", batch=16, remat=True, games=10,
                  min_plies=12, max_plies=30, policy_moves=6,
                  checked_steps=3, trace_steps=2),
}


def limits(kind):
    return core.load_json(core.BENCH / "limits" / f"{LIMITS_OF[kind]}.json")


def plant(monkeypatch, kind, fault):
    from elf_tpu_torch.env.go import engine
    from elf_tpu_torch.search import mcts
    from elf_tpu_torch.training import pipeline, trainer

    step_core = engine.step_core
    if fault == "state_unchanged":
        if kind == "train":
            monkeypatch.setattr(trainer.Optimizer, "update",
                                lambda self, *a, **k: None)
        else:
            monkeypatch.setattr(engine, "step_core",
                                lambda c, a, s: (c, step_core(c, a, s)[1]))
    elif fault == "half_batch":
        if kind == "selfplay":
            ev = mcts._evaluate_states

            def half(*a, **k):
                prior, value = ev(*a, **k)
                h = max(1, prior.shape[0] // 2)
                prior, value = prior.clone(), value.clone()
                prior[h:] = prior[:h].mean(0)
                value[h:] = value[:h].mean()
                return prior, value

            monkeypatch.setattr(mcts, "_evaluate_states", half)
        elif kind == "env":
            def half_step(c, a, s):
                new, info = step_core(c, a, s)
                h = a.shape[0] // 2
                return engine.GoCore(*(torch.cat([n[:h], o[h:]])
                                       for n, o in zip(new, c))), info

            monkeypatch.setattr(engine, "step_core", half_step)
        else:
            loss = trainer.mcts_prediction_loss

            def half_loss(log_pi, value, pi, z, **k):
                h = log_pi.shape[0] // 2
                return loss(log_pi[:h], value[:h], pi[:h], z[:h], **k)

            monkeypatch.setattr(trainer, "mcts_prediction_loss", half_loss)
    elif fault == "answer_altered":
        if kind == "selfplay":
            fin = mcts.mcts_finalize

            def altered(*a, **k):
                res = fin(*a, **k)
                return res._replace(mcts_policy=res.mcts_policy.roll(1, 1))

            monkeypatch.setattr(mcts, "mcts_finalize", altered)
        elif kind == "env":
            def altered_step(c, a, s):
                new, info = step_core(c, a, s)
                legal = info.legal_next.clone()
                legal[:, 0] = ~legal[:, 0]
                return new, info._replace(legal_next=legal)

            monkeypatch.setattr(engine, "step_core", altered_step)
        else:
            tp = pipeline.transform_policy
            monkeypatch.setattr(pipeline, "transform_policy",
                                lambda pi, c, s: tp(pi, c, s).roll(1, 1))


@pytest.mark.parametrize("kind", ["selfplay", "env", "train"])
@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_makes_the_run_incorrect(monkeypatch, kind, fault):
    if fault:
        plant(monkeypatch, kind, fault)
    line, _ = tiny_run(kind, TRAFFIC[kind], limits(kind), seconds=0.5)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    "go19_20b256c.selfplay_b1024_r64", "go19_20b256c.train_b2048",
    "go13_10b128c.selfplay_b192_r96", "go19_20b256c.env_b4096"])
def test_control_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control

    for r in control.readings(workload, [11, 12, 13], 5.0):
        lim, num = r["limits"], r["numbers"]
        assert all(num[k] <= v for k, v in lim.items()), r
        over = [k for k, v in lim.items()
                if num.get(f"control.{k}", -1) > v]
        assert over, r
