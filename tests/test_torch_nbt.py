"""KataGo's nested-bottleneck net (`elf_tpu_torch/models/nbt.py`) and its
epilogue modes (`models/epilogue.py`) on the CPU, at a small size (9x9,
trunk 32, mid 16, pooling 8, one plain nested block and one pooled block,
heads of 8) and, for the counts, at `b18c384nbt`'s full size.

The forward against the plain float32 reference
(`models/nbt_reference.py`) and the benchmark's copy of it, the serving
copy's CPU path (the plain epilogues) against the modules, each plain
epilogue mode against the formula it implements, the state-dict names,
the counters, the registry and its learner, the training forward's
running statistics, the learner's checkpoint and the self-play client's
reader, and `SelfplayActor.play_moves` through the benchmark's
generator.  The kernels are held against the plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py` (phase 3c).

    python -m pytest tests/test_torch_nbt.py -q -n 0
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elf_tpu_torch import profiling
from elf_tpu_torch.config import GameOptions, TrainOptions
from elf_tpu_torch.models import epilogue as epi
from elf_tpu_torch.models import nbt, nbt_reference
from elf_tpu_torch.models.checkpoint import save_checkpoint
from elf_tpu_torch.models.registry import get_model_family, make_trainer
from elf_tpu_torch.models.resnet import BN_EPS, BatchNorm, serving_copy
from elf_tpu_torch.training.trainer import Trainer, TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")

SMALL = nbt.NbtConfig(board_size=9, trunk_channels=32, mid_channels=16,
                      gpool_channels=8, num_blocks=2, gpool_blocks=(2,),
                      p1_channels=8, g1_channels=8, v1_channels=8, v2_size=8,
                      use_bf16=False)
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


def _cfg_dict(cfg: nbt.NbtConfig) -> dict:
    return dataclasses.asdict(cfg)


def _random_net(cfg: nbt.NbtConfig, seed: int) -> nbt.NestedBottleneckNet:
    """Seeded weights, and norms away from the init (running statistics,
    scales and shifts drawn), so that the activations straddle 0."""
    net = nbt.build_model(cfg, "cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                C = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(C, generator=g) + 0.5)
                m.weight.copy_(torch.randn(C, generator=g) * 0.2 + 1.0)
                m.bias.copy_(torch.randn(C, generator=g) * 0.2)
        for name, p in net.named_parameters():
            if ".linear" in name and name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net


def _features(cfg: nbt.NbtConfig, B: int, seed: int) -> torch.Tensor:
    """0/1 planes in the search's layout: an NHWC view of NCHW planes."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(B, cfg.num_planes, cfg.board_size, cfg.board_size,
                    generator=g) < 0.3).float()
    x[:, 16] = 1.0
    x[:, 17] = 0.0
    return x.permute(0, 2, 3, 1)


def _bench_reference():
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_kata_nbt",
        os.path.join(BENCH, "reference", "kata_nbt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Tolerance of the port's fp32 forward against the reference's: the same
# arithmetic but for two orders of rounding, the port's mish in KataGo's
# form n / (n + 2) (a few ulps from F.mish) and its pooling's fixed order
# of summation (against torch's mean), carried through two blocks and the
# heads; measured at 5e-7 for log_pi and 3e-8 for the value.
FP32_TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_reference_in_fp32(seed):
    net = _random_net(SMALL, seed)
    x = _features(SMALL, 6, seed)
    W = dict(net.state_dict())
    with torch.no_grad():
        log_pi, value = net(x)
        ref_pi, ref_v = nbt_reference.forward(W, x, _cfg_dict(SMALL))
        frozen = serving_copy(net)
        assert frozen.serves and not frozen.takes_serving_path(x, False)
        s_pi, s_v = frozen.serve(x)
    assert log_pi.shape == (6, 82) and value.shape == (6,)
    assert torch.allclose(log_pi.exp().sum(1), torch.ones(6), atol=1e-5)
    assert (value.abs() <= 1).all()
    # the modules and the serving copy's CPU path (the plain epilogues;
    # the CPU's fp32 convolution takes another algorithm for NHWC input,
    # so the bits are held in bf16, below)
    for lp, v in ((log_pi, value), (s_pi, s_v)):
        assert float((lp - ref_pi).abs().max()) <= FP32_TOL
        assert float((v - ref_v).abs().max()) <= FP32_TOL


@pytest.mark.parametrize("act", ["mish", "relu"])
def test_bf16_serving_path_gives_the_modules_bits(act):
    cfg = dataclasses.replace(SMALL, use_bf16=True, activation=act)
    net = nbt.NestedBottleneckNet(cfg)
    net.load_state_dict(_random_net(SMALL, 3).state_dict())
    x = _features(cfg, 5, 4)
    with torch.no_grad():
        want = net(x)
        got = serving_copy(net).serve(x)
        ref = nbt_reference.forward(dict(net.state_dict()), x,
                                    _cfg_dict(cfg))
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    # bf16 against fp32: the rounding's own reach, well inside 0.1
    assert 0 < float((want[0] - ref[0]).abs().max()) < 0.1


def test_training_forward_moves_only_the_running_statistics():
    """A training forward (the learner's cooldown pass) normalises by the
    batch and moves each norm's running statistics by the momentum rule,
    once, and no parameter; the eval forward then reads the new
    statistics."""
    cfg = dataclasses.replace(SMALL, remat=True, bn_momentum=0.25)
    net = _random_net(cfg, 0)
    x = _features(cfg, 5, 0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    stats = {}
    with torch.no_grad():
        train_out = net(x, train=True)
        nbt_reference.forward(before, x, _cfg_dict(cfg), stats=stats)
    after = net.state_dict()
    assert len(stats) == len(net.serving_norms()) == 17
    for name, (mean, var) in stats.items():
        for field, batch_stat in (("running_mean", mean),
                                  ("running_var", var)):
            want = 0.75 * before[f"{name}.{field}"] + 0.25 * batch_stat
            assert torch.allclose(after[f"{name}.{field}"], want, rtol=0,
                                  atol=1e-6)
    for k, v in net.named_parameters():
        assert torch.equal(v, before[k])
    with torch.no_grad():
        eval_out = net(x)
        ref = nbt_reference.forward(dict(after), x, _cfg_dict(cfg))
    for a, b, t in zip(eval_out, ref, train_out):
        assert float((a - b).abs().max()) <= FP32_TOL
        assert not torch.equal(a, t)


def _bn(C: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C, generator=g) * 2.0 + 0.05)
        bn.weight.copy_(torch.randn(C, generator=g) * 0.5 + 1.0)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.3)
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    return bn, mul, g


@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["normact", "skip", "row"])
def test_plain_normact_is_the_formula(mode, dtype, act):
    """normact_ref against the modules' arithmetic: the residual add in
    the compute dtype, the row bias in fp32, BatchNorm, the activation,
    the cast; bit for bit, NaN and infinities included."""
    C = 32
    bn, mul, g = _bn(C, 7)
    v = (torch.randn(3, C, 9, 9, generator=g) * 2).to(dtype)
    v[0, :2, 0, :3] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf")], dtype=dtype)
    v = v.contiguous(memory_format=torch.channels_last)
    skip = torch.randn(3, C, 9, 9, generator=g).to(dtype)
    rb = torch.randn(3, C, generator=g)
    f = epi.activation(act)
    with torch.no_grad():
        if mode == "skip":
            s, got = epi.normact_ref(v, bn.running_mean, mul, bn.bias, act,
                                     skip=skip)
            assert _same_bits(s, skip + v)
            want = f(bn(skip + v)).to(dtype)
        elif mode == "row":
            got = epi.normact_ref(v, bn.running_mean, mul, bn.bias, act,
                                  rowbias=rb)
            want = f(bn(v.float() + rb[:, :, None, None])).to(dtype)
        else:
            got = epi.normact_ref(v, bn.running_mean, mul, bn.bias, act)
            want = f(bn(v)).to(dtype)
    assert _same_bits(got, want)
    assert 0.05 < float((want < 0).float().mean() + (want == 0).float().mean())
    assert torch.isnan(got).sum() >= 1


def test_mish_is_mish():
    """KataGo's form of mish against torch's x * tanh(softplus(x)) over
    the range the net sees: apart by the rounding of x log2 e, |x| 2^-24
    relative in exp(x) (under 2e-6 at |x| = 30), and a few ulps; the same
    at 0 and for large x."""
    x = torch.linspace(-30, 30, 200001)
    got, want = epi.mish(x), F.mish(x)
    assert torch.allclose(got, want, rtol=2e-6, atol=1e-30)
    assert float(epi.mish(torch.tensor(0.0))) == 0.0
    assert torch.equal(epi.mish(torch.tensor([50.0, 100.0, 1e30])),
                       torch.tensor([50.0, 100.0, 1e30]))


@pytest.mark.parametrize("size", [9, 19])
@pytest.mark.parametrize("kind", ["gpool", "value"])
def test_plain_pool_is_the_formula(kind, size):
    """pool_ref: the activation of the norm, then KataGo's pooling, against
    torch's mean and max; the scale factors at A = 81 (sqrt 9: -0.5 and
    0.15) and 361 (sqrt 19: 0.5 and 0.15)."""
    A = size * size
    inv, k1, k2 = epi.pool_scales(A)
    assert (inv, k1, k2) == pytest.approx(
        {81: (1 / 81, -0.5, 0.15), 361: (1 / 361, 0.5, 0.15)}[A], abs=1e-15)
    C = 16
    bn, mul, g = _bn(C, size)
    v = (torch.randn(4, C, size, size, generator=g) * 2).to(torch.bfloat16)
    with torch.no_grad():
        got = epi.pool_ref(v, bn.running_mean, mul, bn.bias, "mish", kind)
        y = epi.mish(bn(v))
    mean = y.mean(dim=(2, 3))
    third = y.amax(dim=(2, 3)) if kind == "gpool" else mean * 0.15
    want = torch.cat([mean, mean * (math.sqrt(A) - 14) / 10, third], 1)
    assert got.shape == (4, 3 * C) and got.dtype == torch.float32
    # the fixed order of summation against torch's: fp32 rounding
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    if kind == "gpool":
        assert torch.equal(got[:, 2 * C:], third)


def test_board_pool_sums_in_its_order():
    """The sum along each board row, then over the rows, left to right."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 5, 7, generator=g) * 1e3
    got = epi.board_pool(x, "value")[:, :3]
    s = torch.zeros(2, 3)
    for h in range(5):
        r = x[..., h, 0]
        for w in range(1, 7):
            r = r + x[..., h, w]
        s = r if h == 0 else s + r
    assert torch.equal(got, s * (1.0 / 35))


def test_kernel_wrappers_refuse_cpu_tensors():
    v = torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16)
    c = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        epi.normact_cuda(v, c, c, c, "mish")
    with pytest.raises(ValueError, match="CUDA"):
        epi.pool_cuda(v, c, c, c, "mish", "gpool")
    with pytest.raises(ValueError, match="activation"):
        epi.activation("gelu")


def test_state_dict_names_are_the_weight_shapes():
    for cfg in (SMALL, nbt.NbtConfig()):
        net = nbt.NestedBottleneckNet(cfg)
        shapes = {n: s for n, s, _ in nbt_reference.weight_shapes(
            _cfg_dict(cfg))}
        bench = {n: s for n, s, _ in _bench_reference().weight_shapes(
            _cfg_dict(cfg))}
        own = {n: tuple(t.shape) for n, t in net.state_dict().items()}
        assert own == shapes == bench
    # b18c384nbt: about 26 M parameters
    assert 25e6 < sum(p.numel() for p in net.parameters()) < 28e6


def test_benchmark_reference_equals_the_programs_in_fp32():
    net = _random_net(SMALL, 5)
    W = dict(net.state_dict())
    x = _features(SMALL, 4, 6).contiguous()
    ref = _bench_reference()
    with torch.no_grad():
        a = nbt_reference.forward(W, x, _cfg_dict(SMALL))
        b = ref.forward(W, x, _cfg_dict(SMALL))
        c = ref.evaluate(W, x, _cfg_dict(SMALL), "fp32", rows=3)
        d = ref.evaluate(W, x, _cfg_dict(SMALL), "bf16")
    for u, w in zip(a, b):
        assert torch.equal(u, w)
    for u, w in zip(a, c):
        assert torch.allclose(u, w, rtol=0, atol=1e-6)
    assert 0 < float((d[0] - a[0]).abs().max()) < 0.1


def test_references_import_torch_alone():
    for path in (os.path.join(ROOT, "elf_tpu_torch", "models",
                              "nbt_reference.py"),
                 os.path.join(BENCH, "reference", "kata_nbt.py")):
        tree = ast.parse(open(path).read())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add((node.module or "").split(".")[0])
        assert tops <= {"__future__", "math", "typing", "torch"}, path


@pytest.mark.parametrize("cfg,epilogues,gpools", [
    (SMALL, 17, 3), (nbt.NbtConfig(), 118, 8)])
def test_counters_count_epilogues_and_pools_per_forward(cfg, epilogues,
                                                        gpools):
    """One epilogue after every convolution but the policy's last: 1 + 6
    a plain nested block + 7 a pooled one + 3 in the heads; a pool in each
    pooled block and each head.  The benchmark's layer list agrees.  The
    counts depend on the blocks alone: the forward runs each net's blocks
    8 channels wide on a 5x5 board."""
    sys.path.insert(0, BENCH)
    try:
        from harness import yardstick_nbt
    finally:
        sys.path.remove(BENCH)
    bench_cfg = dict(_cfg_dict(cfg), conv_dtype="float32")
    eps = yardstick_nbt.epilogues(bench_cfg)
    assert len(eps) == epilogues
    assert sum(1 for m, _ in eps if m == "pool") == gpools
    narrow = dataclasses.replace(
        cfg, board_size=5, trunk_channels=16, mid_channels=16,
        gpool_channels=8, p1_channels=8, g1_channels=8, v1_channels=8,
        v2_size=8)
    frozen = serving_copy(nbt.NestedBottleneckNet(narrow))
    assert frozen.serves
    x = _features(narrow, 1, 0)
    profiling.reset()
    with torch.no_grad():
        frozen.serve(x)             # tracing off: nothing counted
        assert profiling.counters() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            frozen.serve(x)
            frozen.serve(x)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.forwards": 2, "net.epilogues": 2 * epilogues,
                 "net.gpools": 2 * gpools}


def test_make_trainer_builds_the_familys_learner():
    """`make_trainer("kata_nbt")`: the AlphaZero train mode on the AGZ
    planes and a Trainer of b18c384nbt at its published widths."""
    fam = get_model_family("kata_nbt")
    assert fam.model_cls is nbt.NestedBottleneckNet
    assert fam.config_cls is nbt.NbtConfig and fam.feature_set == "agz"
    assert fam.load_model is nbt.load_model
    trainer, mode, feature_set = make_trainer("kata_nbt", 19, TrainOptions(),
                                              device="cpu")
    assert (mode, feature_set) == ("mcts", "agz")
    assert trainer.cfg == nbt.NbtConfig()
    assert (trainer.cfg.trunk_channels, trainer.cfg.mid_channels,
            trainer.cfg.gpool_channels, trainer.cfg.num_blocks) == (
                384, 192, 64, 18)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    assert isinstance(state.net, nbt.NestedBottleneckNet)
    assert set(state.opt_state["1"]["0"]["trace"]) == {
        n for n, _ in state.net.named_parameters()}


def test_state_dict_checkpoint_and_the_clients_reader(tmp_path):
    """A learner's checkpoint holds the net under its own state-dict
    names; `nbt.load_model` and the client's reader read it back."""
    from scripts.selfplay_client_torch import net_reader

    def saved(path, net):
        return save_checkpoint(path, TrainState(
            net=net, opt_state=Trainer(net.cfg, TrainOptions(),
                                       "cpu").tx.init(net), step=7))

    net = _random_net(dataclasses.replace(SMALL, use_bf16=True), 2)
    path = saved(str(tmp_path / "small"), net)
    back = nbt.load_model(path, net.cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), back.state_dict().values()))
    g = GameOptions(model="kata_nbt", board_size=19)
    feature_set, eval_raw, read_net = net_reader(g, TrainOptions(), "cpu")
    assert feature_set == "agz"
    full = read_net(saved(str(tmp_path / "full"),
                          nbt.NestedBottleneckNet(nbt.NbtConfig())))
    assert isinstance(full, nbt.NestedBottleneckNet)
    assert full.cfg == nbt.NbtConfig()
    x = _features(SMALL, 2, 1)
    lp, v = eval_raw(serving_copy(back), None, x)
    assert lp.shape == (2, 82) and v.shape == (2,)


def test_play_moves_through_the_benchmarks_generator():
    """Two lockstep moves (after one warm-up move) of `SelfplayActor.
    play_moves` with the family on the CPU, built from a configuration
    through the registry by the benchmark's `selfplay_family` generator,
    and checked by its `check` against the reference: the engine and the
    search exact, the net within its limits."""
    sys.path[:0] = [BENCH, ROOT]
    try:
        from harness import core
        cfg = dict(_cfg_dict(dataclasses.replace(SMALL, use_bf16=True)),
                   name="small_nbt", reference="kata_nbt", family="kata_nbt",
                   komi=7.5, conv_dtype="bfloat16", bn_dtype="float32")
        cfg["gpool_blocks"] = list(cfg["gpool_blocks"])
        with open(os.path.join(BENCH, "traffic",
                               "selfplay_family_b1024_r64.json")) as f:
            traffic = json.load(f)
        traffic.update(boards=4, rollouts=16, eval_chunk=64, warm_moves=1,
                       trace_moves=2, check_boards=4, check_nodes=32)
        with open(os.path.join(BENCH, "limits", "go19_b18c384nbt."
                               "selfplay_family_b1024_r64.json")) as f:
            limits = json.load(f)
        ctx = core.make_context("small.selfplay_family", 2**33 + 1, 60.0,
                                True, time.perf_counter(),
                                device=torch.device("cpu"),
                                spec=core.load_spec(), config=cfg,
                                traffic=traffic, limits=limits)
        gen = core.generator(ctx)
        measured = gen.run(ctx)
        numbers = gen.check(ctx, measured)
    finally:
        del sys.path[:2]
    assert measured.units == 2 and measured.attempted == 2 * 4
    assert numbers.pop("_failed") == 0
    assert numbers["engine_mismatches"] == 0
    assert numbers["search_mismatches"] == 0
    correct, _ = core.judge(numbers, limits)
    assert correct
