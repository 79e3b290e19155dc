"""The port's spans and counters (`elf_tpu_torch.profiling`): off unless a
profiler session records, the same search with them on and off, the
search's phase spans and counters per simulation batch, host reads
counted in the search only, the actor's and the pipeline's spans, and
(marked `cuda`) no span around the liberty kernels' launches.  CPU, small boards; imports no JAX:

    python -m pytest tests/test_torch_tracing.py -q -n 0
    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_tracing.py
"""

import json
import os

import numpy as np
import pytest
import torch

from elf_tpu_torch import profiling
from elf_tpu_torch.config import ReplayOptions, TrainOptions
from elf_tpu_torch.env.go import engine, kernels
from elf_tpu_torch.models.resnet import ModelConfig
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts, total_batches
from elf_tpu_torch.selfplay import records
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.replay import ReplayBuffer
from elf_tpu_torch.training.runner import LearnerRunner
from elf_tpu_torch.training.trainer import Trainer

SIZE = 5
A = SIZE * SIZE + 1
SEARCH = MCTSConfig(num_rollouts=24, rollouts_per_batch=4, c_puct=1.5,
                    virtual_loss=1, root_epsilon=0.25, root_alpha=0.2,
                    rotation_flip=True, max_batches_per_call=2)
PHASES = ["elf.mcts.select_expand", "elf.mcts.evaluate", "elf.mcts.backprop"]


def evaluator(seed=5):
    """A fixed evaluator over the planes: seeded linear priors and values,
    so that the trees depend on the positions."""
    g = torch.Generator().manual_seed(seed)
    w_pi = torch.randn((SIZE * SIZE * 18, A), generator=g) * 0.3
    w_v = torch.randn((SIZE * SIZE * 18,), generator=g) * 0.1

    def eval_fn(feats, to_play):
        x = feats.reshape(feats.shape[0], -1).float()
        return torch.log_softmax(x @ w_pi, dim=1), torch.tanh(x @ w_v)

    return eval_fn


def search(seed=3, cfg=SEARCH):
    """A seeded search of 4 boards from a few random legal moves in."""
    g = torch.Generator().manual_seed(seed)
    core = engine.init_core(4, SIZE, "cpu")
    for _ in range(5):
        legal = engine.legal_moves(core, SIZE)
        u = torch.rand(legal.shape, generator=g)
        core, _ = engine.step_core(core, torch.argmax(
            torch.where(legal, u, -1.0), dim=1).to(torch.int32), SIZE)
    hist = torch.zeros((4, 8, SIZE * SIZE), dtype=torch.int8)
    hist[:, -1] = core.stones
    hlen = torch.ones((4,), dtype=torch.int32)
    gen = torch.Generator().manual_seed(seed)
    res, tree = run_mcts(core, hist, hlen, evaluator(), gen, cfg, SIZE,
                         device="cpu")
    return res, tree, gen.get_state()


def program_spans(trace_dir):
    """(start, end, name) of the program's spans in the one Chrome trace
    written into `trace_dir`, in start order."""
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("elf."))


def traced(tmp_path, fn):
    """fn() inside a profiler session of its own; returns (fn's result,
    the program's spans, the counters of the session)."""
    trace_dir = str(tmp_path / f"trace{len(os.listdir(tmp_path))}")
    profiling.reset()
    with profiling.Profiler(trace_dir).trace():
        out = fn()
    return out, program_spans(trace_dir), profiling.counters()


def test_off_records_nothing_and_searches_alike(tmp_path, monkeypatch):
    def no_range(name):
        raise AssertionError(f"span {name} recorded with tracing off")

    profiling.reset()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", no_range)
        res, tree, gen_state = search()
    assert profiling.counters() == {}
    assert profiling.span("elf.any") is profiling.span("elf.other")

    (res2, tree2, gen_state2), spans, counts = traced(tmp_path, search)
    assert spans and counts
    for a, b in zip(res, res2):
        assert torch.equal(a, b)
    for field, a, b in zip(tree._fields, tree, tree2):
        assert torch.equal(a, b), field
    assert torch.equal(gen_state, gen_state2)


def test_search_spans_and_counters_per_batch(tmp_path):
    _, spans, counts = traced(tmp_path, search)
    nb = total_batches(SEARCH)
    assert [n for _, _, n in spans] == ["elf.mcts.prepare"] + PHASES * nb
    ends = [e for _, e, _ in spans]
    assert all(e <= s for e, (s, _, _) in zip(ends, spans[1:]))
    assert counts["search.batches"] == nb == 6
    assert counts["search.host_reads"] > 0
    _, _, again = traced(tmp_path, search)
    assert again == counts


def test_host_reads_count_inside_the_search_only(tmp_path):
    """The engine's scoring fill reads through `profiling.read` wherever
    it is called; only the search's calls count."""
    core = engine.init_core(4, SIZE, "cpu")
    score, spans, counts = traced(
        tmp_path, lambda: engine.score_tromp_taylor(core, SIZE))
    assert torch.equal(score, engine.score_tromp_taylor(core, SIZE))
    assert (spans, counts) == ([], {})

    inner = profiling.reads_counted_as("inner")(
        lambda: profiling.read(torch.tensor(True)))
    outer = profiling.reads_counted_as("outer")(
        lambda: [profiling.read(torch.tensor(True)), inner(),
                 profiling.read(torch.tensor([0, 1]), torch.nonzero)])
    out, _, counts = traced(tmp_path, outer)
    assert out[0] is True and out[1] is True
    assert torch.equal(out[2], torch.tensor([[1]]))
    assert counts == {"outer": 2, "inner": 1}


def test_actor_move_spans(tmp_path):
    actor = SelfplayActor(
        ActorConfig(board_size=SIZE, batch=2),
        MCTSConfig(num_rollouts=4, rollouts_per_batch=2),
        lambda p, b: evaluator(), seed=1, device="cpu")
    _, spans, counts = traced(tmp_path,
                              lambda: actor.play_moves(None, None, 2))
    names = [n for _, _, n in spans]
    per_move = ["elf.mcts.prepare"] + PHASES * 2 + ["elf.actor.records"]
    assert names == per_move * 2
    assert counts["search.batches"] == 4


def test_learner_step_spans(tmp_path):
    pipe = TrainingPipeline(ReplayBuffer(ReplayOptions(num_reader=2,
                                                       q_min_size=1,
                                                       q_max_size=20)),
                            SIZE, seed=0)
    pi = np.zeros(A, np.float32)
    pi[3] = 1.0
    for k in range(4):
        pipe.insert_record(records.make_record(
            [3, 7], 1.0 if k % 2 else -1.0, [pi, pi], [0.0, 0.0], SIZE))
    opts = TrainOptions(batchsize=4, num_block=1, dim=8)
    net = ModelConfig(board_size=SIZE, num_block=1, dim=8, use_bf16=False)
    runner = LearnerRunner(Trainer(net, opts, device="cpu"), pipe,
                           str(tmp_path / "ckpt"), opts)
    stats, spans, _ = traced(tmp_path, runner.run_minibatch)
    assert stats is not None
    assert [n for _, _, n in spans] == ["elf.pipeline.sample",
                                        "elf.pipeline.features"]


@pytest.mark.cuda
def test_kernel_launches_stay_in_the_callers_range(tmp_path):
    """The liberty kernels' wrappers open no span: a launch stays in the
    range its caller opened (the benchmark's `step_core`), and the
    launches are counted as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stones = torch.randint(0, 3, (32, 19 * 19), generator=g,
                           dtype=torch.int8).to(dev)
    action = torch.randint(0, 19 * 19, (32,), generator=g,
                           dtype=torch.int32).to(dev)
    color = torch.ones((32,), dtype=torch.int32, device=dev)
    kernels.step_analysis_cuda(stones, action, color)      # built, warm
    before = kernels.launch_counts()
    path = str(tmp_path / "kernels.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("caller"):
            for _ in range(5):
                kernels.step_analysis_cuda(stones, action, color)
            kernels.analyze_libs_cuda(stones.view(32, 19, 19))
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    after = kernels.launch_counts()
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names == ["caller"]
    assert {k: after[k] - before[k] for k in after} == {
        "step_analysis": 5, "analyze_libs": 1}
