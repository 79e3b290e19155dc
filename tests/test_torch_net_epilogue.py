"""The serving net's trunk epilogue (`elf_tpu_torch/models/epilogue.py`) and
the serving path of `PolicyValueNet` on the CPU.

The plain epilogue against the modules it replaces (BatchNorm with its
running statistics, ReLU, casts, the residual add), bit for bit; a
serving copy's `serve` against `net(x)` at the full-size 19x19 and 13x13
shapes, bit for bit; the counters while tracing is on and off; and which
forwards take the serving path.  The CUDA kernel is held against the plain
version on the card by `chip_smoke.py` (phase 3b) and
`tests/test_torch_cuda.py`.

    python -m pytest tests/test_torch_net_epilogue.py -q -n 0
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elf_tpu_torch import profiling
from elf_tpu_torch.models import epilogue as epi
from elf_tpu_torch.models.resnet import (BN_EPS, BatchNorm, ModelConfig,
                                         PolicyValueNet, build_model,
                                         serving_copy)

_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


def _random_bn(bn: BatchNorm, g: torch.Generator) -> None:
    """Running statistics and affine parameters away from the init, so that
    the normalised outputs straddle 0."""
    with torch.no_grad():
        C = bn.weight.shape[0]
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C, generator=g) * 2.0 + 0.05)
        bn.weight.copy_(torch.randn(C, generator=g) * 0.5 + 1.0)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.3)


@pytest.mark.parametrize("conv_bias", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [128, 256])
def test_plain_epilogue_equals_the_modules(C, dtype, skip, conv_bias):
    g = torch.Generator().manual_seed(C + 2 * skip + conv_bias)
    bn = BatchNorm(C)
    _random_bn(bn, g)
    v = (torch.randn(3, C, 7, 7, generator=g) * 1.5).to(dtype)
    v[0, :2, 0, :3] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf")], dtype=dtype)
    v = v.contiguous(memory_format=torch.channels_last)
    x = F.relu(torch.randn(3, C, 7, 7, generator=g)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    b = (torch.randn(C, generator=g) * 0.2).to(dtype) if conv_bias else None

    # the modules: the card's conv bias add, BatchNorm, ReLU, the casts and
    # ResBlock's skip add
    with torch.no_grad():
        u = v + b[:, None, None] if conv_bias else v
        y = F.relu(bn(u))
        want = F.relu(x + y.to(dtype)) if skip else y.to(dtype)
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        got = epi.epilogue_ref(v, bn.running_mean, mul, bn.bias,
                               x if skip else None, b)
    assert _same_bits(got, want)
    assert got.shape == v.shape
    zero = float((want == 0).float().mean())
    assert 0.1 < zero < 0.9                 # the outputs straddle 0
    assert torch.isnan(got).sum() == torch.isnan(want).sum() >= 1


FULL = {"19x19 20b256c": ModelConfig(),
        "13x13 10b128c": ModelConfig(board_size=13, num_block=10, dim=128)}


def _serving_pair(cfg: ModelConfig, seed: int):
    net = build_model(cfg, "cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    for bn in net.trunk_bns() + [net.pi_bn, net.v_bn]:
        _random_bn(bn, g)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv" in name and name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return net, serving_copy(net)


def _features(cfg: ModelConfig, B: int, seed: int, search_layout: bool):
    """0/1 planes; `search_layout`: the search's NHWC view of NCHW planes,
    else a contiguous NHWC tensor."""
    g = torch.Generator().manual_seed(seed)
    N, P = cfg.board_size, cfg.num_planes
    if search_layout:
        x = torch.rand(B, P, N, N, generator=g).round()
        return x.permute(0, 2, 3, 1)
    return torch.rand(B, N, N, P, generator=g).round()


@pytest.mark.parametrize("search_layout", [False, True])
@pytest.mark.parametrize("shape", sorted(FULL))
def test_serving_forward_equals_the_modules(shape, search_layout):
    cfg = FULL[shape]
    net, frozen = _serving_pair(cfg, seed=3)
    assert len(frozen.serving_muls) == 2 * cfg.num_block + 1
    x = _features(cfg, 4, seed=5, search_layout=search_layout)
    with torch.no_grad():
        want = net(x)
        got = frozen.serve(x)
        again = frozen(x)           # a CPU input: the modules' forward
    for a, b, c in zip(got, want, again):
        assert _same_bits(a, b) and _same_bits(c, b)


@pytest.mark.parametrize("shape", sorted(FULL))
def test_counters_count_epilogues_per_forward(shape):
    cfg = FULL[shape]
    _, frozen = _serving_pair(cfg, seed=1)
    x = _features(cfg, 2, seed=2, search_layout=True)
    profiling.reset()
    frozen.serve(x)                 # tracing off: nothing counted
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        frozen.serve(x)
        frozen.serve(x[:1])
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.forwards": 2,
                 "net.epilogues": 2 * (2 * cfg.num_block + 1)}
    assert c["net.epilogues"] / c["net.forwards"] == {
        "19x19 20b256c": 41.0, "13x13 10b128c": 21.0}[shape]


@pytest.fixture
def serves(monkeypatch):
    """Every input looks like a CUDA tensor to the selection, and `serve`
    only records that it was called: the list of its calls."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(PolicyValueNet, "serve",
                        lambda self, x: calls.append(self) or (x, x))
    return calls


def test_which_forwards_take_the_serving_path(serves):
    cfg = ModelConfig(board_size=9, num_block=2, dim=16)
    net = build_model(cfg, "cpu", seed=0)
    frozen = serving_copy(net)
    x = torch.rand(2, 9, 9, 18).round()
    frozen(x)
    assert serves == [frozen]
    # the learner's net: not frozen, no multipliers; its forward, and any
    # training forward, runs the modules
    assert net.serving_muls is None
    net(x)
    net(x, train=True)
    # a copy of a copy serves too, with its own multipliers
    again = serving_copy(frozen)
    assert again.serving_muls is not frozen.serving_muls
    assert all(torch.equal(a, b) for a, b in zip(again.serving_muls,
                                                 frozen.serving_muls))
    before = frozen.init_bn.running_mean.clone()
    frozen(x, train=True)
    assert serves == [frozen]
    assert not torch.equal(before, frozen.init_bn.running_mean)
    # channels that are no multiple of 8
    odd = serving_copy(build_model(ModelConfig(board_size=9, num_block=1,
                                               dim=12), "cpu", seed=0))
    assert odd.serving_muls is None
    odd(torch.rand(1, 9, 9, 18))
    assert serves == [frozen]


def test_a_cpu_input_runs_the_modules():
    frozen = serving_copy(build_model(ModelConfig(board_size=9, num_block=2,
                                                  dim=16), "cpu", seed=0))
    assert frozen.serving_muls is not None
    assert not frozen.takes_serving_path(torch.zeros(1, 9, 9, 18), False)


@pytest.mark.parametrize("attr", ["tp", "sync", "channels"])
def test_a_mesh_attribute_keeps_the_modules(attr, serves):
    net = build_model(ModelConfig(board_size=9, num_block=2, dim=16), "cpu",
                      seed=0)
    layer = net.blocks[1].conv2 if attr == "tp" else net.blocks[1].bn1
    setattr(layer, attr, object())
    frozen = serving_copy(net)
    assert frozen.serving_muls is None
    setattr(frozen.blocks[1].conv2 if attr == "tp" else frozen.blocks[1].bn1,
            attr, None)         # the plain forward, to run it here
    frozen(torch.rand(2, 9, 9, 18).round())
    assert serves == []


def test_kernel_wrapper_refuses_cpu_tensors():
    v = torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16)
    c = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        epi.epilogue_cuda(v, c, c, c)
