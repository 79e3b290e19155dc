"""CPU tests of the benchmark's harness and plain reference, at tiny sizes.

    python -m pytest perfbench/test_perfbench_cpu.py -q -n 0

The reference engine, planes and net against elf_tpu_torch on seeded
inputs; the yardstick's counts by hand; every piece BENCHMARK.json names
found by name; the result line's keys; and no module of the JAX package
(or of the program, for the reference) in the processes that run them.
"""

import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import core, weights, yardstick  # noqa: E402
from reference import agz, go, resnet_pv  # noqa: E402

TINY_NET = dict(name="tiny", reference="resnet_pv", board_size=9, komi=7.5,
                num_planes=18, num_block=2, dim=16, policy_planes=2,
                value_planes=1, value_hidden=32, conv_dtype="float32",
                bn_dtype="float32")


def random_positions(K, size, plies, seed):
    """Positions of random legal games (reference engine), each stopped at
    its own ply in [1, plies]."""
    g = torch.Generator().manual_seed(seed)
    stop = torch.randint(1, plies + 1, (K,), generator=g)
    pos = go.empty_position(K, size, "cpu")
    out = pos
    for t in range(plies):
        legal = go.legal_mask(pos, size)
        score = torch.where(legal[:, :-1], torch.rand(legal[:, :-1].shape,
                                                      generator=g), -1.0)
        a = torch.where(legal[:, :-1].any(1), score.argmax(1), size * size)
        pos, ok = go.step(pos, a, size, legal=legal)
        assert bool(ok.all())
        take = stop == t + 1
        out = {k: torch.where(take.view((-1,) + (1,) * (v.dim() - 1)),
                              pos[k], out[k]) for k, v in pos.items()}
    return out


def port_core(pos):
    from elf_tpu_torch.env.go import engine

    K = pos["stones"].shape[0]
    ko_on = pos["ko"] >= 0
    return engine.GoCore(
        stones=pos["stones"].clone(), to_play=pos["to_play"].clone(),
        ko_point=pos["ko"].to(torch.int32),
        ko_color=torch.where(ko_on, pos["to_play"], 0).to(torch.int8),
        ko_age=torch.where(ko_on, 0, 10_000).to(torch.int32),
        ply=pos["ply"].to(torch.int32), passes=pos["passes"].to(torch.int32),
        last_move=torch.full((K,), -1, dtype=torch.int32),
        hash_lo=torch.zeros(K, dtype=torch.int32),
        hash_hi=torch.zeros(K, dtype=torch.int32))


@pytest.mark.parametrize("size,plies", [(9, 60), (19, 160)])
def test_reference_engine_agrees_with_port(size, plies):
    from elf_tpu_torch.env.go import engine

    from harness.gocheck import program_position

    pos = random_positions(64, size, plies, seed=size)
    core_ = port_core(pos)
    legal = go.legal_mask(pos, size)
    assert torch.equal(engine.legal_moves(core_, size), legal)
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        score = torch.where(legal, torch.rand(legal.shape, generator=g), -1.0)
        a = score.argmax(1)
        nxt, ok = go.step(pos, a, size)
        new_core, info = engine.step_core(core_, a.to(torch.int32), size)
        assert bool(ok.all()) and not bool(info.illegal.any())
        assert bool(go.same_position(nxt, program_position(new_core)).all())
        assert torch.equal(go.legal_mask(nxt, size), info.legal_next)
        pos, core_, legal = nxt, new_core, info.legal_next
    # an illegal move: an occupied point
    occ = pos["stones"].long().argmax(1)
    has = pos["stones"].long().amax(1) > 0
    _, ok = go.step(pos, occ, size)
    _, info = engine.step_core(core_, occ.to(torch.int32), size)
    assert torch.equal(~ok & has, info.illegal & has)


def test_reference_planes_agree_with_port():
    from elf_tpu_torch.env.go.features import (extract_agz_from_snapshots,
                                               inv_transform_policy,
                                               transform_policy)

    size, K = 9, 40
    g = torch.Generator().manual_seed(2)
    hist = torch.randint(0, 3, (K, 8, size * size), generator=g,
                         dtype=torch.int8)
    valid = torch.rand((K, 8), generator=g) < 0.7
    to_play = torch.randint(1, 3, (K,), generator=g, dtype=torch.int8)
    codes = torch.arange(K) % 8
    mine = agz.planes(hist, valid, to_play, codes, size)
    port = extract_agz_from_snapshots(hist.flip(1), valid.flip(1), to_play,
                                      codes, size)
    assert torch.equal(mine, port)
    pi = torch.rand((K, size * size + 1), generator=g)
    assert torch.equal(agz.policy_to_frame(pi, codes, size),
                       transform_policy(pi, codes, size))
    assert torch.equal(agz.policy_from_frame(pi, codes, size),
                       inv_transform_policy(pi, codes, size))


def test_reference_records_agree_with_port():
    from elf_tpu_torch.native.sgf_codec import (moves_to_sgf_string,
                                                sgf_string_to_moves)
    from elf_tpu_torch.selfplay.records import (dequantize_policy,
                                                quantize_policy)

    moves = [0, 80, 81, 40, 81, 3]
    assert sgf_string_to_moves(agz.moves_to_sgf(moves, 9), 9) == moves
    assert agz.sgf_to_moves(moves_to_sgf_string(moves, 9), 9) == moves
    pi = np.random.default_rng(0).random(82).astype(np.float32)
    q = quantize_policy(pi)
    assert np.array_equal(agz.dequantize(q, 82), dequantize_policy(q, 82))


def test_reference_net_agrees_with_port():
    from harness.selfplay import port_net

    cfg = TINY_NET
    W = weights.draw(resnet_pv.weight_shapes(cfg), 5, "cpu")
    net = port_net(cfg, W, torch.device("cpu"))
    assert set(net.state_dict()) == set(W)
    x = (torch.rand((12, 9, 9, 18), generator=torch.Generator()
                    .manual_seed(3)) < 0.3).float()
    with torch.no_grad():
        lp, v = net(x)
    rlp, rv = resnet_pv.evaluate(W, x, cfg)
    assert torch.allclose(lp, rlp, atol=2e-5) and torch.allclose(v, rv,
                                                                 atol=2e-5)
    # training mode: the batch's statistics, remat or not
    with torch.no_grad():
        lp, v = net(x, train=True)
        rlp, rv = resnet_pv.forward(W, x, cfg, train=True, remat=True)
    assert torch.allclose(lp, rlp, atol=2e-5) and torch.allclose(v, rv,
                                                                 atol=2e-5)


def test_fp8_control_rounds_the_convolutions():
    cfg = TINY_NET
    W = weights.draw(resnet_pv.weight_shapes(cfg), 6, "cpu")
    x = (torch.rand((16, 9, 9, 18)) < 0.3).float()
    lp, _ = resnet_pv.evaluate(W, x, cfg, "fp32")
    lp8, _ = resnet_pv.evaluate(W, x, cfg, "fp8")
    gap = float((lp - lp8).abs().max())
    assert 1e-3 < gap < 1.0


@pytest.mark.parametrize("name,cfg", [
    ("go19_20b256c", dict(board_size=19, num_planes=18, num_block=20,
                          dim=256, policy_planes=2, value_planes=1,
                          value_hidden=256)),
    ("go13_10b128c", dict(board_size=13, num_planes=18, num_block=10,
                          dim=128, policy_planes=2, value_planes=1,
                          value_hidden=256))])
def test_flop_counter_by_hand(name, cfg):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        file_cfg = json.load(f)
    for k, v in cfg.items():
        assert file_cfg[k] == v
    n = cfg["board_size"]
    C, blocks = cfg["dim"], cfg["num_block"]
    macs = (n * n * 9 * 18 * C                   # input conv
            + 2 * blocks * n * n * 9 * C * C      # tower
            + n * n * C * 2 + 2 * n * n * (n * n + 1)   # policy head
            + n * n * C + n * n * 256 + 256)      # value head
    assert yardstick.resnet_forward_flops(file_cfg, 1) == 2 * macs
    assert yardstick.resnet_forward_flops(file_cfg, 7) == 14 * macs
    assert yardstick.train_step_flops(file_cfg, 3) == 18 * macs
    if name == "go19_20b256c":        # 17.06 GFLOP per evaluation
        assert abs(2 * macs / 1e9 - 17.06) < 0.01


@pytest.mark.parametrize("boards,bound_ms", [
    (1, 1.1877611940298509e-06), (32, 3.800835820895523e-05),
    (1024, 0.0012162674626865673), (4096, 0.004865069850746269)])
def test_step_analysis_bytes_match_the_kernel_table(boards, bound_ms):
    """The bound of PERF.md's kernel table (bytes over 3.35 TB/s)."""
    secs = yardstick.step_analysis_bytes(boards, 19) / yardstick.PEAK_HBM_BYTES
    assert secs * 1e3 == pytest.approx(bound_ms, rel=1e-12)


def test_union_of_intervals():
    assert yardstick.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_the_contract():
    spec = core.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] == 1
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in spec["workloads"]:
        assert len(core.cell_metrics(spec, w["name"], False)) >= 2
        assert len(core.cell_metrics(spec, w["name"], True)) >= 1
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_piece_is_found_by_name():
    spec = core.load_spec()
    for w in spec["workloads"]:
        for trace in (False, True):
            ctx = core.make_context(w["name"], 1, 1.0, trace, 0.0, spec=spec)
            assert ctx.config["name"] == w["config"]
            assert hasattr(core.generator(ctx), "run")
            assert hasattr(core.generator(ctx), "check")
            assert ctx.limits
            for m in core.cell_metrics(spec, w["name"], trace):
                assert callable(core.metric_reader(m["name"]))
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


TINY_ENV = dict(kind="env", boards=16, chunk=8, warm_chunks=1,
                trace_chunks=2, check_boards=8, max_checks=50)


def tiny_run(kind, traffic, limits, trace=False, seconds=1.0):
    """One run of a tiny cell on the CPU through `core.run_cell`: (the
    result line's dict, the text it printed)."""
    spec = core.load_spec()
    ctx = core.make_context(f"tiny.{kind}", 2**33 + 5, seconds, trace,
                            time.perf_counter(), device=torch.device("cpu"),
                            spec=spec, config=TINY_NET, traffic=traffic,
                            limits=limits)
    metrics = [m for m in spec["end_to_end"] + spec["per_layer"]
               if not trace or m in spec["per_layer"]]
    buf = io.StringIO()
    line = core.run_cell(ctx, spec, out=buf, err=io.StringIO(),
                         metrics_spec=metrics)
    return line, buf


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line, buf = tiny_run("env", TINY_ENV, {"engine_mismatches": 0},
                         trace=trace)
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(last)[:-1] == want and list(last)[-1] == "checks"
    assert last["correct"] is True
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs():
    a, _ = tiny_run("env", TINY_ENV, {"engine_mismatches": 0})
    W1 = weights.draw(resnet_pv.weight_shapes(TINY_NET), 9, "cpu")
    W2 = weights.draw(resnet_pv.weight_shapes(TINY_NET), 9, "cpu")
    assert all(torch.equal(W1[k], W2[k]) for k in W1)
    assert core.sub_seed(2**33, 1) == core.sub_seed(2**33, 1)
    assert core.sub_seed(2**33, 1) != core.sub_seed(2**33 + 1, 1)


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = (
        "import sys, json, time, io, torch\n"
        f"sys.path[:0] = [{HERE!r}, {ROOT!r}]\n"
        "import test_perfbench_cpu as t\n"
        "t.tiny_run('env', t.TINY_ENV, {'engine_mismatches': 0})\n"
        "from harness import selfplay, train, env, trace\n"
        "import elf_tpu_torch.training.runner, elf_tpu_torch.selfplay.actor\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "optax", "elf_tpu"}
    assert "elf_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{HERE!r}]\n"
        "import reference.go, reference.agz, reference.resnet_pv\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "optax", "elf_tpu",
                       "elf_tpu_torch", "harness"}


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "go19_20b256c.env_b4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
