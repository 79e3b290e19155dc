"""The serving net's trunk epilogue (`elf_tpu_torch/models/epilogue.py`) and
the serving path of `PolicyValueNet` on the CPU.

The plain epilogue against the modules it replaces (BatchNorm with its
running statistics, ReLU, casts, the residual add), bit for bit; a
serving copy's `serve` against `net(x)` at the full-size 19x19 and 13x13
shapes, bit for bit; the counters while tracing is on and off; which
forwards of either serving net (`PolicyValueNet`, `NestedBottleneckNet`)
take the serving path; the state-dict names; and the build hash of the
epilogue libraries.  The CUDA kernel is held against the plain version on
the card by `chip_smoke.py` (phase 3b) and `tests/test_torch_cuda.py`.

    python -m pytest tests/test_torch_net_epilogue.py -q -n 0
"""

import copy
import dataclasses
import shutil

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elf_tpu_torch import _build, profiling
from elf_tpu_torch.models import epilogue as epi
from elf_tpu_torch.models import nbt
from elf_tpu_torch.models.resnet import (BN_EPS, BatchNorm, ModelConfig,
                                         PolicyValueNet, build_model,
                                         prepare_serving, serving_copy)

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
    assert frozen.serves
    assert len(frozen.serving_norms()) == 2 * cfg.num_block + 1
    for bn in frozen.serving_norms():
        assert torch.equal(bn.serving_mul,
                           torch.rsqrt(bn.running_var + BN_EPS) * bn.weight)
    assert frozen.pi_bn.serving_mul is None
    x = _features(cfg, 4, seed=5, search_layout=search_layout)
    with torch.no_grad():
        want = net(x)
        got = frozen.serve(x)
        again = frozen(x)           # a CPU input: the modules' forward
    for a, b, c in zip(got, want, again):
        assert _same_bits(a, b) and _same_bits(c, b)


@pytest.mark.parametrize("shape", sorted(FULL))
def test_counters_count_epilogues_per_forward(shape):
    """The counts depend on the depth alone: each net at its full depth,
    8 channels wide on a 5x5 board."""
    cfg = dataclasses.replace(FULL[shape], board_size=5, dim=8,
                              value_hidden=8)
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


NBT_SMALL = nbt.NbtConfig(board_size=5, trunk_channels=16, mid_channels=16,
                          gpool_channels=8, num_blocks=2, gpool_blocks=(2,),
                          p1_channels=8, g1_channels=8, v1_channels=8,
                          v2_size=8, use_bf16=False)

# Each serving net at a small size: the net, a layer that can take `tp`
# (a convolution), one that can take `sync` / `channels` (a norm), and a
# config with a norm whose width is no multiple of 8 (resnet: the trunk;
# nbt: the value head's, which `serve` hands to a pool).
SERVING_NETS = {
    "resnet": (lambda cfg: build_model(cfg, "cpu", seed=0),
               ModelConfig(board_size=9, num_block=2, dim=16),
               lambda n: n.blocks[1].conv2, lambda n: n.blocks[1].bn1,
               dict(dim=12)),
    "nbt": (lambda cfg: nbt.build_model(cfg, "cpu", seed=0), NBT_SMALL,
            lambda n: n.blocks[1].normactconvp.conv,
            lambda n: n.blocks[1].normactconvp.norm, dict(v1_channels=12)),
}


def _record_serves(monkeypatch) -> list:
    """Every input looks like a CUDA tensor to the selection, and `serve`
    only records that it was called: the list of its calls."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for cls in (PolicyValueNet, nbt.NestedBottleneckNet):
        monkeypatch.setattr(cls, "serve",
                            lambda self, x: calls.append(self) or (x, x))
    return calls


@pytest.mark.parametrize("case", ["served", "cpu input", "unfrozen",
                                  "odd width", "tp", "sync", "channels",
                                  "served copy with sync"])
@pytest.mark.parametrize("kind", sorted(SERVING_NETS))
def test_which_forwards_take_the_serving_path(kind, case, monkeypatch):
    """One rule for both nets: a copy serves where every parameter is
    frozen, no module has a mesh attribute and every norm `serve` hands to
    an epilogue has a multiple of 8 channels; its forward takes `serve` on
    a CUDA input with the running statistics, and only then."""
    build, cfg, conv_of, norm_of, odd = SERVING_NETS[kind]
    net = build(cfg)
    x = torch.rand(2, cfg.board_size, cfg.board_size, cfg.num_planes).round()
    if case == "cpu input":
        frozen = serving_copy(net)
        assert frozen.serves
        assert not frozen.takes_serving_path(torch.zeros_like(x), False)
        return
    calls = _record_serves(monkeypatch)
    if case == "served":
        frozen = serving_copy(net)
        frozen(x)
        assert frozen.serves and calls == [frozen]
        assert all(bn.serving_mul is not None
                   for bn in frozen.serving_norms())
        # the learner's net: not a serving copy; its forward, and any
        # training forward, runs the modules
        assert not net.serves
        net(x)
        net(x, train=True)
        # a copy of a copy serves too, with its own multipliers
        again = serving_copy(frozen)
        for a, b in zip(again.serving_norms(), frozen.serving_norms()):
            assert a.serving_mul is not b.serving_mul
            assert torch.equal(a.serving_mul, b.serving_mul)
        # a serving copy's training forward runs the modules, batch
        # statistics and all
        before = frozen.serving_norms()[0].running_mean.clone()
        frozen(x, train=True)
        assert calls == [frozen]
        assert not torch.equal(before,
                               frozen.serving_norms()[0].running_mean)
        return
    if case == "unfrozen":
        copy_ = copy.deepcopy(net)
        prepare_serving(copy_)
    elif case == "odd width":
        copy_ = serving_copy(build(dataclasses.replace(cfg, **odd)))
    elif case == "served copy with sync":
        # a copy of a serving copy that can no longer serve drops the
        # multipliers it was copied with
        served = serving_copy(net)
        norm_of(served).sync = object()
        copy_ = serving_copy(served)
        norm_of(copy_).sync = None
    else:
        layer = conv_of(net) if case == "tp" else norm_of(net)
        setattr(layer, case, object())
        copy_ = serving_copy(net)
        # the plain forward, to run it here
        setattr(conv_of(copy_) if case == "tp" else norm_of(copy_), case,
                None)
    assert not copy_.serves
    assert all(bn.serving_mul is None for bn in copy_.serving_norms())
    copy_(x)
    assert calls == []


RESNET_STATE = [
    *(f"init_conv.{k}" for k in ("weight", "bias")),
    *(f"init_bn.{k}" for k in ("weight", "bias", "running_mean",
                               "running_var")),
    *(f"blocks.{i}.{layer}.{k}" for i in range(2)
      for layer, keys in (("conv1", ("weight", "bias")),
                          ("bn1", ("weight", "bias", "running_mean",
                                   "running_var")),
                          ("conv2", ("weight", "bias")),
                          ("bn2", ("weight", "bias", "running_mean",
                                   "running_var")))
      for k in keys),
    "pi_conv.weight", "pi_conv.bias", "pi_bn.weight", "pi_bn.bias",
    "pi_bn.running_mean", "pi_bn.running_var", "pi_fc.weight", "pi_fc.bias",
    "v_conv.weight", "v_conv.bias", "v_bn.weight", "v_bn.bias",
    "v_bn.running_mean", "v_bn.running_var", "v_fc1.weight", "v_fc1.bias",
    "v_fc2.weight", "v_fc2.bias",
]


def test_state_dict_names_are_the_published_ones():
    """PolicyValueNet's state-dict names in order, as checkpoints and the
    benchmark's weights name them; a serving copy keeps them (nbt's are
    held to the reference's `weight_shapes` in tests/test_torch_nbt.py)."""
    net = build_model(ModelConfig(board_size=9, num_block=2, dim=16), "cpu")
    assert list(net.state_dict()) == RESNET_STATE
    assert list(serving_copy(net).state_dict()) == RESNET_STATE


def test_an_edited_header_changes_the_build_hash(tmp_path):
    """A library's build is named by its source, the headers beside it and
    the flags: editing the shared header rebuilds every library."""
    for name in ("net_epilogue.cu", "lanes.cuh"):
        shutil.copy(_build.CSRC / name, tmp_path / name)
    src, flags = tmp_path / "net_epilogue.cu", _build.NVCC_FLAGS
    before = _build.source_hash(src, flags)
    assert before == _build.source_hash(_build.CSRC / "net_epilogue.cu",
                                        flags)
    with open(tmp_path / "lanes.cuh", "a") as f:
        f.write("// edited\n")
    edited = _build.source_hash(src, flags)
    assert edited != before
    (tmp_path / "extra.h").write_text("// a new header\n")
    assert _build.source_hash(src, flags) not in (before, edited)
    assert _build.source_hash(src, ("-O2",)) != _build.source_hash(src,
                                                                   flags)


def test_kernel_wrapper_refuses_cpu_tensors():
    v = torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16)
    c = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        epi.epilogue_cuda(v, c, c, c)
