"""Tests of the port that need a CUDA card (marked `cuda`; each skips
without one).  This file imports torch, numpy and elf_tpu_torch only, so it
also runs where JAX is absent:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from elf_tpu_torch.env.go import engine, kernels
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(300)]

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_boards(B, size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=(B, size, size)).astype(np.int8)


@pytest.mark.parametrize("size", [5, 9, 13, 19])
def test_kernels_match_plain_versions(dev, size):
    """Both kernels exactly equal to their plain versions, at every board
    size the engine supports and at batch sizes that leave packed CTAs
    partly empty."""
    n2 = size * size
    for B in (1, 3, 5, 130):
        s = torch.from_numpy(_random_boards(B, size, seed=B)).to(dev)
        for a, b in zip(kernels.analyze_libs_cuda(s),
                        kernels.analyze_libs_ref(s)):
            assert torch.equal(a, b)
        g = torch.Generator(device=dev).manual_seed(B)
        act = torch.randint(-2, n2 + 2, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        col = torch.randint(1, 3, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        flat = s.reshape(B, n2)
        for a, b in zip(kernels.step_analysis_cuda(flat, act, col),
                        kernels.step_analysis_ref(flat, act, col)):
            assert torch.equal(a, b)


def _snake(size):
    """One serpentine chain covering the board (the longest chains)."""
    b = np.zeros((size, size), np.int8)
    b[0::2, :] = 1
    for r in range(1, size, 2):
        b[r, -1 if (r // 2) % 2 == 0 else 0] = 1
    return b


def _edge_boards(kind, B, size, seed):
    """B boards of one kind, with actions and colours to play that include
    the liberty of a one-liberty chain, occupied points, passes and
    negative actions."""
    rng = np.random.default_rng(seed)
    n = size
    s = np.zeros((B, n, n), np.int8)
    for i in range(B):
        if kind == "one_liberty":                # one chain, one liberty
            s[i] = 1 + i % 2
            s[i].flat[rng.integers(n * n)] = 0
        elif kind == "checkerboard":             # single-stone chains
            r, c = np.indices((n, n))
            s[i] = np.where((r + c) % 2 == 0, 1 + r % 2, 0)
        elif kind == "full":                     # no empty point
            s[i] = rng.integers(1, 3, (n, n))
        elif kind == "serpentine":               # in both colours
            s[i] = _snake(n) * (1 + i % 2)
        elif kind == "random":
            p_empty = (0.2, 0.5, 0.8)[i % 3]
            s[i] = rng.choice(3, (n, n), p=[p_empty, (1 - p_empty) / 2,
                                            (1 - p_empty) / 2])
    flat = s.reshape(B, n * n)
    action = np.empty(B, np.int32)
    color = np.empty(B, np.int32)
    for i in range(B):
        empty, occ = np.nonzero(flat[i] == 0)[0], np.nonzero(flat[i])[0]
        pick = i % 5
        if pick in (0, 1) and empty.size:
            action[i] = empty[rng.integers(empty.size)]
        elif pick == 2 and occ.size:
            action[i] = occ[rng.integers(occ.size)]
        else:
            action[i] = (n * n, -1, n * n + 3)[i % 3]
        # the opponent of the board's first stone, so that one-liberty
        # boards lose their whole chain
        color[i] = 3 - flat[i, occ[0]] if occ.size else 1 + i % 2
    return s, action, color


@pytest.mark.parametrize("B", [1, 32, 1024])
@pytest.mark.parametrize("size", [2, 5, 9, 13, 19, 32])
def test_union_find_kernels_match_plain_versions_on_edge_boards(dev, size,
                                                                B):
    """The union-find kernels, exactly equal to the plain versions on the
    boards that stress a labelling: one chain with one liberty,
    single-stone chains, empty and full boards, serpentine chains and
    random boards."""
    n2 = size * size
    for k, kind in enumerate(("one_liberty", "checkerboard", "empty", "full",
                              "serpentine", "random")):
        s_np, a_np, c_np = _edge_boards(kind, B, size, seed=size * 100 + k)
        s = torch.from_numpy(s_np).to(dev)
        flat = s.reshape(B, n2)
        act, col = torch.from_numpy(a_np).to(dev), torch.from_numpy(c_np).to(dev)
        ref = kernels.analyze_libs_ref(s)
        ref_step = kernels.step_analysis_ref(flat, act, col)
        for got, want in zip(kernels.analyze_libs_cuda(s), ref):
            assert torch.equal(got, want), ("analyze_libs", kind)
        for got, want in zip(kernels.step_analysis_cuda(flat, act, col),
                             ref_step):
            assert got.dtype == want.dtype and torch.equal(got, want), \
                ("step_analysis", kind)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [8, 128, 256, 1024])
def test_net_epilogue_matches_plain_version(dev, C, dtype):
    """The trunk epilogue kernel bit for bit equal to its plain version,
    with and without the conv bias and the skip, at batch sizes that leave
    the last block's rows partly empty; NaN and infinities included."""
    from elf_tpu_torch.models import epilogue as epi

    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    g = torch.Generator(device=dev).manual_seed(C)
    mean = torch.randn(C, generator=g, device=dev) * 0.5
    mul = torch.rand(C, generator=g, device=dev) * 2
    bias = torch.randn(C, generator=g, device=dev) * 0.3
    b = (torch.randn(C, generator=g, device=dev) * 0.2).to(dtype)
    for B, hw in ((1, 19), (3, 13), (5, 7)):
        shape = (B, C, hw, hw)
        v = (torch.randn(shape, generator=g, device=dev) * 1.5).to(dtype)
        v.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                       -float("inf")], dtype=dtype)
        v = v.contiguous(memory_format=torch.channels_last)
        x = torch.relu(torch.randn(shape, generator=g, device=dev)).to(
            dtype).contiguous(memory_format=torch.channels_last)
        for skip in (None, x):
            for cb in (None, b):
                got = epi.epilogue_cuda(v, mean, mul, bias, skip, cb)
                want = epi.epilogue_ref(v, mean, mul, bias, skip, cb)
                assert got.is_contiguous(memory_format=torch.channels_last)
                assert torch.equal(got.view(bits), want.view(bits))


TRAIN_SHAPES = {"19x19 C=256": (16, 256, 19), "13x13 C=128": (37, 128, 13)}


def _train_layer_inputs(dev, B, C, hw, dtype, seed):
    """A convolution's output (an offset, so that the mean is not 0), BN's
    weight and bias, a conv bias, a block input and an upstream gradient,
    channels_last."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    shape = (B, C, hw, hw)
    v = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(
        dtype).contiguous(memory_format=cl)
    weight = torch.randn(C, generator=g, device=dev) * 0.5 + 1.0
    bias = torch.randn(C, generator=g, device=dev) * 0.3
    cb = torch.randn(C, generator=g, device=dev) * 0.2
    x = torch.relu(torch.randn(shape, generator=g, device=dev)).to(
        dtype).contiguous(memory_format=cl)
    up = torch.randn(shape, generator=g, device=dev).to(dtype).contiguous(
        memory_format=cl)
    return v, weight, bias, cb, x, up


def _train_layer_run(fn, v, weight, bias, cb, x, up, skip, conv_bias):
    """y, mean, var and the gradients of v, weight, bias, conv bias and
    skip after backward(up)."""
    ins = [t.clone().requires_grad_(True) for t in (v, weight, bias, cb, x)]
    y, mean, var = fn(ins[0], ins[1], ins[2], ins[4] if skip else None,
                      ins[3] if conv_bias else None)
    y.backward(up)
    return dict(y=y.detach(), mean=mean, var=var, dv=ins[0].grad,
                dweight=ins[1].grad, dbias=ins[2].grad, dconv_bias=ins[3].grad,
                dskip=ins[4].grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(TRAIN_SHAPES))
def test_train_epilogue_matches_plain_chain(dev, shape, dtype):
    """The learner's epilogue kernels against the plain autograd chain, with
    and without the skip and the conv bias.  They differ only in the order
    of the fp32 sums (the kernels sum per thread, per block and in double
    across blocks; torch reduces in its own tree and differentiates E[x^2]
    - mean^2 term by term), so: mean within 1e-5 of the root mean square,
    var within 1e-5 of E[x^2] (the formula's own cancellation); y and the
    gradient of v, rounded to the compute dtype from fp32 values that
    differ in their last bits, within one rounding (2^-7 of the value) plus
    1e-3 of the largest (fp32: 1e-4 of the largest); the gradient of skip,
    the upstream gradient masked by the output, bit for bit; the weight and
    bias gradients, sums over the batch, within 1e-3 of the largest; the
    conv bias gradient, a sum of d v that cancels to its roundings, within
    2^-6 of the sum of |d v|; and in bf16 fewer than 1 % of y's elements
    apart (in fp32 every element carries the mean's last bits).  y itself
    is the plain apply (`epilogue_ref`) with the kernels' statistics, bit
    for bit."""
    from elf_tpu_torch.models import epilogue as epi

    B, C, hw = TRAIN_SHAPES[shape]
    tensors = _train_layer_inputs(dev, B, C, hw, dtype, seed=C + hw)
    for skip in (False, True):
        for conv_bias in (False, True):
            got = _train_layer_run(epi.train_epilogue_cuda, *tensors, skip,
                                   conv_bias)
            want = _train_layer_run(epi.train_epilogue_ref, *tensors, skip,
                                    conv_bias)
            torch.cuda.synchronize()
            where = (shape, skip, conv_bias)
            assert got["y"].is_contiguous(memory_format=torch.channels_last)
            assert got["dv"].is_contiguous(memory_format=torch.channels_last)
            # the forward is the plain apply with the kernels' own statistics
            cb = tensors[3].to(dtype) if conv_bias else None
            mean, _, mul, _ = epi.train_stats_cuda(tensors[0], tensors[1], cb)
            own = epi.epilogue_ref(tensors[0], mean, mul, tensors[2],
                                   tensors[4] if skip else None, cb)
            assert torch.equal(own, got["y"]), where
            u = tensors[0].float()
            if conv_bias:
                u = (tensors[0] + tensors[3].to(dtype)[:, None, None]).float()
            ex2 = (u * u).mean(dim=(0, 2, 3))
            dm = (got["mean"] - want["mean"].detach()).abs()
            dvar = (got["var"] - want["var"].detach()).abs()
            assert float((dm / ex2.sqrt()).max()) <= 1e-5, where
            assert float((dvar / ex2).max()) <= 1e-5, where
            if skip:
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                assert torch.equal(got["dskip"].view(bits),
                                   want["dskip"].view(bits)), where
            else:
                assert got["dskip"] is None and want["dskip"] is None
            for name in ("y", "dv"):
                a, b = got[name].double(), want[name].double()
                top = float(b.abs().max())
                tol = (1e-4 * top if dtype == torch.float32
                       else 2.0 ** -7 * b.abs() + 1e-3 * top)
                assert bool(((a - b).abs() <= tol).all()), (name, where)
            if dtype == torch.bfloat16:
                assert float((got["y"] != want["y"]).float().mean()) < 0.01
            for name in ("dweight", "dbias"):
                a, b = got[name], want[name]
                assert float((a - b).abs().max()) <= 1e-3 * float(
                    b.abs().max()), (name, where)
            if conv_bias:
                bound = 2.0 ** -6 * float(want["dv"].double().abs().sum(
                    (0, 2, 3)).max())
                assert float((got["dconv_bias"] - want["dconv_bias"]).abs()
                             .max()) <= bound, where
            else:
                assert got["dconv_bias"] is None


def test_train_epilogue_repeats_bit_for_bit(dev):
    """Two calls of the forward and of the backward on the same input give
    the same bits (the sums take a fixed order, with no atomics), at 19x19
    with 256 channels, with the skip and the conv bias and without."""
    from elf_tpu_torch.models import epilogue as epi

    tensors = _train_layer_inputs(dev, 64, 256, 19, torch.bfloat16, seed=5)
    for skip in (False, True):
        runs = [_train_layer_run(epi.train_epilogue_cuda, *tensors, skip,
                                 skip) for _ in range(2)]
        for name, a in runs[0].items():
            b = runs[1][name]
            assert (a is None) == (b is None), name
            if a is not None:
                bits = (torch.int16 if a.dtype == torch.bfloat16
                        else torch.int32)
                assert torch.equal(a.view(bits), b.view(bits)), (name, skip)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_remat_step_with_train_epilogues_bit_for_bit(dev, use_bf16,
                                                     monkeypatch):
    """A net the training epilogues take (32 channels): three remat steps
    from one state give the plain steps' parameters and BN statistics bit
    for bit, with cuDNN's deterministic algorithms: the recomputed blocks'
    kernels repeat the forward's bits."""
    import copy
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models import epilogue as epi
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = ModelConfig(board_size=9, num_block=2, dim=32, use_bf16=use_bf16)
    opts = TrainOptions(batchsize=8, lr=0.05)
    plain_tr = Trainer(cfg, opts, device=dev)
    remat_tr = Trainer(dataclasses.replace(cfg, remat=True), opts, device=dev)
    plain = plain_tr.init_state(torch.Generator().manual_seed(0))
    remat = copy.deepcopy(plain)
    remat.net.cfg = remat_tr.cfg
    assert plain.net.takes_train_epilogues(torch.zeros(1, device=dev), True)
    before = dict(epi.launches)
    for i in range(3):
        batch = [t.to(dev) for t in _train_batch(30 + i)]
        plain_tr.make_train_step()(plain, *batch)
        remat_tr.make_train_step()(remat, *batch)
        for (n, x), (_, y) in zip(
                list(plain.net.named_parameters())
                + list(plain.net.named_buffers()),
                list(remat.net.named_parameters())
                + list(remat.net.named_buffers())):
            assert torch.equal(x, y), (i, n)
    # 5 trunk layers a forward, 4 more recomputed by remat; 5 backwards each
    assert epi.launches["net_train_stats"] - before["net_train_stats"] == \
        3 * (5 + 9)
    assert epi.launches["net_train_grad"] - before["net_train_grad"] == \
        3 * (5 + 5)


NBT_MODES = [("normact", None), ("skip", None), ("row", None),
             ("pool", "gpool"), ("pool", "value")]


@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode,kind", NBT_MODES)
def test_nbt_epilogues_match_plain_versions(dev, mode, kind, dtype, act):
    """Each epilogue mode of the nested-bottleneck net bit for bit equal to
    its plain version at the widths b18c384nbt serves (384, 192, 128, 64,
    32 channels; the pools at those of at most 192) on 19x19 boards, and
    at 9x9 and 13x13, at batch sizes that leave the last block's rows
    partly empty; NaN and infinities included."""
    from elf_tpu_torch.models import epilogue as epi

    widths = (384, 192, 128, 64, 32)
    for C in widths[1:] if mode == "pool" else widths:
        g = torch.Generator(device=dev).manual_seed(C)
        mean = torch.randn(C, generator=g, device=dev) * 0.5
        mul = torch.rand(C, generator=g, device=dev) * 2
        bias = torch.randn(C, generator=g, device=dev) * 0.3
        for B, hw in ((1, 19), (3, 19), (37, 19), (5, 13), (2, 9)):
            shape = (B, C, hw, hw)
            v = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
            v.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                           -float("inf")], dtype=dtype)
            v = v.contiguous(memory_format=torch.channels_last)
            x = torch.randn(shape, generator=g, device=dev).to(
                dtype).contiguous(memory_format=torch.channels_last)
            rb = torch.randn((B, C), generator=g, device=dev)
            if mode == "pool":
                got = [epi.pool_cuda(v, mean, mul, bias, act, kind)]
                want = [epi.pool_ref(v, mean, mul, bias, act, kind)]
            else:
                kw = {"skip": {"skip": x},
                      "row": {"rowbias": rb}}.get(mode, {})
                got = epi.normact_cuda(v, mean, mul, bias, act, **kw)
                want = epi.normact_ref(v, mean, mul, bias, act, **kw)
                got, want = ((got, want) if mode == "skip"
                             else ([got], [want]))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                if a.dim() == 4:
                    assert a.is_contiguous(memory_format=torch.channels_last)
                bits = (torch.int32 if a.dtype == torch.float32
                        else torch.int16)
                assert torch.equal(a.view(bits), b.view(bits)), (C, B, hw)


def test_nbt_mish_kernel_at_every_fp32_input(dev):
    """The kernels' mish (its reciprocal taken branch-free) bit for bit
    equal to the plain version's at every one of the 2^32 fp32 bit
    patterns (NaN where the plain version gives NaN): the norm-act
    kernel on fp32 with mean 0, multiplier 1 and bias 0, which leave
    each input as it is."""
    from elf_tpu_torch.models import epilogue as epi

    C, chunk = 8, 1 << 26
    zero = torch.zeros(C, device=dev)
    one = torch.ones(C, device=dev)
    for start in range(0, 1 << 32, chunk):
        bits = torch.arange(start, start + chunk, dtype=torch.int64,
                            device=dev)
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
        v = bits.to(torch.int32).view(torch.float32).reshape(-1, C, 1, 1)
        got = epi.normact_cuda(v, zero, one, zero, "mish")
        want = epi.normact_ref(v, zero, one, zero, "mish")
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            got.isnan() & want.isnan())
        assert bool(same.all()), (start, v.flatten()[
            (~same).flatten().nonzero()[:4, 0]].tolist())


@pytest.mark.parametrize("B", [1, 32, 2048])
def test_nbt_serving_forward_close_to_the_modules(dev, B):
    """b18c384nbt's serving forward (NHWC, the epilogue kernels) against
    the modules' forward of the same weights at 19x19: bit for bit equal
    to the serving copy's own modules (its bf16 channels_last weights, no
    epilogue kernel), and against the modules of the fp32-master net,
    which cast their weights at each call, log_pi within 3e-2 and the
    value within 1e-2 (the bounds of the post-activation net's serving
    path: cuDNN may take another algorithm for such a weight, which moves
    bf16 convolutions' last bits, and 18 blocks carry them on)."""
    import copy

    from elf_tpu_torch.models import nbt
    from elf_tpu_torch.models.resnet import BatchNorm, serving_copy

    net = nbt.build_model(nbt.NbtConfig(), dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.rand((max(B, 64), 19, 19, 18), generator=g, device=dev)
         < 0.3).float()
    x[..., 16] = 1.0
    x[..., 17] = 0.0
    hooks = []

    def set_moments(bn, inputs):
        h = inputs[0].float()
        bn.running_mean.copy_(h.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(h.var(dim=(0, 2, 3), unbiased=False))

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                hooks.append(m.register_forward_pre_hook(set_moments))
        net(x[:64])
        for h in hooks:
            h.remove()
        frozen = serving_copy(net)
        assert frozen.serves and frozen.takes_serving_path(x, False)
        got = frozen(x[:B])
        want = net(x[:B])
        modules = copy.deepcopy(frozen)
        modules.serves = False
        own = modules(x[:B])
    assert all(torch.equal(a, b) for a, b in zip(got, own))
    assert float((got[0] - want[0]).abs().max()) <= 3e-2
    assert float((got[1] - want[1]).abs().max()) <= 1e-2
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


def test_nbt_train_step_on_card_close_to_the_fp32_reference(dev):
    """One b18c384nbt learner step with remat at batch 32 on the card
    (bf16 NHWC convolutions, fp32 norms) against the plain float32
    reference's gradient at the same weights, by the learner cell's gap
    measures (`perfbench/limits/go19_b18c384nbt_learner.
    train_family_b2048.json`: each leaf's gradient norm against the larger
    of its own and the median leaf's, and the norm over all leaves); the
    step counts 232 norm-and-activation calls and 14 poolings."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch import profiling
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models import nbt, nbt_reference
    from elf_tpu_torch.training.loss import mcts_prediction_loss
    from elf_tpu_torch.training.trainer import Trainer

    path = os.path.join(os.path.dirname(__file__), "..", "perfbench",
                        "limits",
                        "go19_b18c384nbt_learner.train_family_b2048.json")
    with open(path) as f:
        limits = json.load(f)
    cfg = nbt.NbtConfig(remat=True)
    trainer = Trainer(cfg, TrainOptions(batchsize=32), device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(2))
    W0 = {k: v.clone() for k, v in state.net.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.rand((32, 19, 19, 18), generator=g, device=dev)
         < 0.3).float()
    x[..., 16] = 1.0
    x[..., 17] = 0.0
    pi = torch.rand((32, 362), generator=g, device=dev) ** 4
    pi = pi / pi.sum(1, keepdim=True)
    z = torch.where(torch.rand(32, generator=g, device=dev) < 0.5, 1.0, -1.0)

    def grads(forward, params):
        log_pi, value = forward()
        loss, _ = mcts_prediction_loss(log_pi, value, pi, z)
        return [float(t.norm()) for t in torch.autograd.grad(loss, params)]

    got = grads(lambda: state.net(x, train=True),
                list(state.net.parameters()))
    W = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                     "running_var")))
         for k, v in W0.items()}
    names = [n for n, _ in state.net.named_parameters()]
    want = grads(lambda: nbt_reference.forward(
        W, x, dataclasses.asdict(cfg), stats={}), [W[n] for n in names])
    med = float(np.median(want))
    moved = [i for i, w in enumerate(want) if w >= 1e-3 * med]
    gap = max(abs(got[i] - want[i]) / max(want[i], med) for i in moved)
    glob = lambda v: float(np.sqrt(sum(v[i] ** 2 for i in moved)))  # noqa
    gap_global = abs(glob(got) - glob(want)) / glob(want)
    assert gap <= limits["grad_gap"], gap
    assert gap_global <= limits["grad_gap_global"], gap_global
    step = trainer.make_train_step()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, stats = step(state, x, pi, z)
    torch.cuda.synchronize(dev)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.train_normacts": 232, "net.train_gpools": 14}
    assert torch.isfinite(stats["loss/total"]) and state.step == 1


def test_step_core_on_card_matches_cpu(dev):
    """Random legal games: the engine on the card (kernels) and on the CPU
    (plain versions) agree on every field."""
    size, B = 19, 16
    rng = np.random.default_rng(0)
    cc = engine.init_core(B, size, "cpu")
    gc = engine.init_core(B, size, dev)
    legal = np.ones((B, size * size + 1), bool)
    for _ in range(150):
        p = legal / legal.sum(axis=1, keepdims=True)
        a = np.array([rng.choice(len(r), p=r) for r in p], np.int32)
        cc, ci = engine.step_core(cc, torch.from_numpy(a), size)
        gc, gi = engine.step_core(gc, torch.from_numpy(a).to(dev), size)
        for x, y in zip(tuple(cc) + tuple(ci), tuple(gc) + tuple(gi)):
            assert torch.equal(x, y.cpu())
        legal = ci.legal_next.numpy()


def test_golden_search_on_card(dev):
    """A virtual-loss batch config of the reference's golden searches on
    the card: identical root visit counts."""
    with gzip.open(os.path.join(GOLDEN_DIR, "ref_mcts_19.jsonl.gz"), "rt") as f:
        g = [json.loads(line) for line in f][1]
    size, n2 = 19, 361
    st = gostate.init_state(1, size, dev)
    for i in range(g["prefix"]):
        cand = np.nonzero(gostate.legal_moves(st, size).cpu().numpy()[0, :n2])[0]
        a = int(cand[(i * 37 + 11) % len(cand)])
        st, _ = gostate.step(st, torch.tensor([a], dtype=torch.int32,
                                               device=dev), size)
    perm = (np.arange(n2 + 1) * 37 + 13) % (n2 + 1)
    log_prior = torch.log(torch.from_numpy(
        ((1.0 + (perm % 64) / 64.0) * np.exp2(perm // 64)).astype(np.float32)
    )).to(dev)

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(dim=1)
        theirs = feats[..., 1].reshape(K, n2).sum(dim=1)
        black = torch.where(to_play == BLACK, mine, theirs)
        white = torch.where(to_play == BLACK, theirs, mine)
        return (log_prior[None].expand(K, n2 + 1),
                ((black - white) * 0.05).clamp(-1.0, 1.0))

    cfg = MCTSConfig(num_rollouts=g["rollouts"],
                     rollouts_per_batch=int(g["per_batch"]),
                     c_puct=g["c_puct"], virtual_loss=int(g["vl"]),
                     rotation_flip=False)
    _, tree = run_mcts(st.core, st.stone_hist, st.hist_len, eval_fn,
                       torch.Generator(device=dev).manual_seed(0), cfg, size,
                       game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi,
                                       st.nhash),
                       device=dev)
    child = tree.child[0, 0].long()
    ours = torch.where(child >= 0, tree.n[0, child.clamp(min=0)], 0).cpu()
    ref = np.zeros(n2 + 1, np.int64)
    for e in g["edges"]:
        ref[e["a"]] = e["n"]
    np.testing.assert_array_equal(ours.numpy(), ref)


def _learner_pair(use_bf16, dev, **opts):
    """The same freshly initialised TrainState on the CPU and on the card."""
    import copy

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer

    cfg = ModelConfig(board_size=9, num_block=2, dim=16, use_bf16=use_bf16)
    topts = TrainOptions(batchsize=8, lr=0.05, **opts)
    cpu = Trainer(cfg, topts, device="cpu")
    card = Trainer(cfg, topts, device=dev)
    state = cpu.init_state(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(state)
    on_card.net = on_card.net.to(dev)
    on_card.opt_state = card.tx.init(on_card.net)
    return cpu, state, card, on_card


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.random((8, 9, 9, 18)) < 0.3).astype(np.float32)
    pi = rng.dirichlet(np.full(82, 0.3), size=8).astype(np.float32)
    winner = rng.choice([-1.0, 1.0], size=8).astype(np.float32)
    return [torch.from_numpy(a) for a in (feats, pi, winner)]


@pytest.mark.parametrize("opt_method", ["sgd", "adam"])
def test_train_steps_on_card_match_cpu(dev, opt_method, monkeypatch):
    """Three fp32 train steps and a cooldown pass on the card against the
    same steps on the CPU: stats, parameters, BN statistics and optimizer
    slots within 1e-4 (cuDNN and the CPU sum in different orders).  TF32
    convolutions, cuDNN's default for fp32, are off for the comparison."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, a, card, b = _learner_pair(False, dev, opt_method=opt_method,
                                    grad_clip_norm=0.5)
    step_a, step_b = cpu.make_train_step(), card.make_train_step()
    for i in range(3):
        batch = _train_batch(i)
        a, sa = step_a(a, *batch)
        b, sb = step_b(b, *(t.to(dev) for t in batch))
        for k in sa:
            assert abs(float(sa[k]) - float(sb[k])) < 1e-4 * max(
                1.0, abs(float(sa[k]))), (i, k)
    feats = _train_batch(9)[0]
    cpu.make_cooldown_step()(a, feats)
    card.make_cooldown_step()(b, feats.to(dev))
    assert b.step == a.step == 3
    for (n, x), (_, y) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        assert y.device.type == "cuda"
        torch.testing.assert_close(y.cpu(), x, atol=1e-4, rtol=0, msg=n)
    inner = str(card.tx.index)
    for slot, tensors in a.opt_state[inner]["0"].items():
        if slot == "count":
            assert int(tensors) == int(b.opt_state[inner]["0"][slot]) == 3
            continue
        for n, x in tensors.items():
            torch.testing.assert_close(b.opt_state[inner]["0"][slot][n].cpu(),
                                       x, atol=1e-4, rtol=0, msg=f"{slot}/{n}")


def test_bf16_step_and_checkpoint_on_card(dev, tmp_path):
    """A bf16 train step on the card keeps fp32 masters, inference follows
    the updated weights, and a checkpoint written from the card loads back
    bit for bit onto the card and onto the CPU."""
    from elf_tpu_torch.training.trainer import load_checkpoint, save_checkpoint

    cpu, a, card, b = _learner_pair(True, dev)
    batch = [t.to(dev) for t in _train_batch(1)]
    with torch.inference_mode():
        before = b.net(batch[0])[0].clone()
    b, stats = card.make_train_step()(b, *batch)
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in b.net.parameters())
    with torch.inference_mode():
        after = b.net(batch[0])[0]
    assert not torch.allclose(before, after)
    save_checkpoint(str(tmp_path), b)
    for template in (b, a):
        back = load_checkpoint(str(tmp_path), template)
        assert back.step == 1
        for (n, x), (_, y) in zip(b.net.state_dict().items(),
                                  back.net.state_dict().items()):
            assert y.device == next(template.net.parameters()).device
            assert torch.equal(x.cpu(), y.cpu()), n


def test_device_batch_on_card_matches_cpu(dev):
    from elf_tpu_torch.config import ReplayOptions
    from elf_tpu_torch.selfplay.records import make_record
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer

    with gzip.open(os.path.join(GOLDEN_DIR, "ref_traj_9.jsonl.gz"), "rt") as f:
        games = [json.loads(line) for line in f][:6]
    tp = TrainingPipeline(ReplayBuffer(ReplayOptions(num_reader=2), seed=1),
                          9, seed=2, num_future_actions=2)
    rng = np.random.default_rng(0)
    for i, g in enumerate(games):
        moves = g["actions"][:40]
        pols = [rng.dirichlet(np.full(82, 0.1)).astype(np.float32)
                for _ in moves]
        tp.insert_record(make_record(moves, 1.0 if i % 2 else -1.0, pols,
                                     [0.0] * len(moves), 9))
    hb = tp.sample_host_batch(32)
    for on_card, on_cpu in zip(tp.device_batch(hb, dev) +
                               tp.device_batch_offline(hb, dev),
                               tp.device_batch(hb, "cpu") +
                               tp.device_batch_offline(hb, "cpu")):
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_remat_step_on_card_equals_plain_step(dev, use_bf16, monkeypatch):
    """Block remat on the card: three steps from one state give the plain
    steps' BN statistics bit for bit (each written once per step) and
    parameters within 1e-6, with cuDNN's deterministic algorithms."""
    import copy
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = ModelConfig(board_size=9, num_block=2, dim=16, use_bf16=use_bf16)
    opts = TrainOptions(batchsize=8, lr=0.05)
    plain_tr = Trainer(cfg, opts, device=dev)
    remat_tr = Trainer(dataclasses.replace(cfg, remat=True), opts, device=dev)
    plain = plain_tr.init_state(torch.Generator().manual_seed(0))
    remat = copy.deepcopy(plain)
    remat.net.cfg = remat_tr.cfg
    for i in range(3):
        batch = [t.to(dev) for t in _train_batch(20 + i)]
        plain_tr.make_train_step()(plain, *batch)
        remat_tr.make_train_step()(remat, *batch)
        for (n, x), (_, y) in zip(plain.net.named_buffers(),
                                  remat.net.named_buffers()):
            assert torch.equal(x, y), (i, n)
        for (n, x), (_, y) in zip(plain.net.named_parameters(),
                                  remat.net.named_parameters()):
            assert float((x - y).detach().abs().max()) <= 1e-6, (i, n)


def _exact_eval(size):
    """Equal priors on one action in eight, value (black - white) / 16."""
    n2 = size * size
    favored = (np.arange(n2 + 1) * 37 + 13) % 8 == 0

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        log_pi = torch.from_numpy(np.where(favored, 0.0, -1e4).astype(
            np.float32)).to(feats.device)
        mine = feats[..., 0].reshape(K, n2).sum(-1)
        theirs = feats[..., 1].reshape(K, n2).sum(-1)
        b = torch.where(to_play == BLACK, mine, theirs)
        w = torch.where(to_play == BLACK, theirs, mine)
        return (log_pi[None].expand(K, n2 + 1),
                ((b - w) / 16.0).clamp(-1.0, 1.0))

    return eval_fn


def test_chunked_search_on_card_equals_unchunked(dev):
    """On the card: a move searched in `max_batches_per_call` calls with
    `eval_chunk` forwards equals the move searched in one call with one
    forward per batch (19x19, B = 16, white budget twice black's)."""
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    size = 19
    acfg = ActorConfig(board_size=size, batch=16, never_resign_prob=1.0,
                       policy_distri_cutoff=2)
    base = dict(num_rollouts=16, white_num_rollouts=32, rollouts_per_batch=4,
                root_epsilon=0.25, batched_writes="on")
    actors = [SelfplayActor(acfg, MCTSConfig(**base, **extra),
                            lambda p, b: _exact_eval(size), seed=1,
                            device=dev)
              for extra in ({}, dict(max_batches_per_call=3, eval_chunk=16))]
    for _ in range(3):
        for a in actors:
            a.play_moves(None, None, 1)
        assert len(actors[0].simulate_s) == 1
        assert len(actors[1].simulate_s) == 3
        assert actors[0].moves == actors[1].moves
        assert actors[0].values == actors[1].values
        assert torch.equal(actors[0].state.core.stones,
                           actors[1].state.core.stones)


def test_graphed_descent_equals_eager_on_card(dev, monkeypatch):
    """The descent replayed from CUDA graphs equals the eager descent bit
    for bit over four moves of `SelfplayActor.play_moves` with a new tree
    a move (a capture each), two with persistent trees (`advance_tree`
    makes the second move's tree) and two of GTP's B = 1 `genmove`: every
    searched tree and result, the moves and the liberty kernels' launch
    counts.  The graphed runs are traced (captures happen while the
    profiler records), capture one graph set a tree, and the memory the
    card holds does not grow with the captures."""
    from elf_tpu_torch import profiling
    from elf_tpu_torch.console.gtp import GtpEngine
    from elf_tpu_torch.search import mcts
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    size = 9
    mcfg = MCTSConfig(num_rollouts=32, rollouts_per_batch=4, virtual_loss=2,
                      root_epsilon=0.25, root_alpha=0.3)

    def actor_moves(persistent, moves):
        actor = SelfplayActor(
            ActorConfig(board_size=size, batch=16, never_resign_prob=1.0,
                        policy_distri_cutoff=1, persistent_tree=persistent),
            mcfg, lambda p, b: _exact_eval(size), seed=3, device=dev)
        searched = []
        search = actor._search

        def keep(state, eval_fn):
            res, tree = search(state, eval_fn)
            searched.append((res, mcts.Tree(*(t.clone() for t in tree))))
            return res, tree

        actor._search = keep
        for _ in range(moves):
            actor.play_moves(None, None, 1)
            reserved.append(torch.cuda.memory_reserved(dev))
        return searched, actor.moves

    def gtp_moves():
        eng = GtpEngine(lambda p, b: _exact_eval(size), mcfg, size=size,
                        seed=3, resign_thres=0.0, device=dev)
        eng.set_model(None, None)
        moves = [eng.genmove("b"), eng.genmove("w")]
        return [(None, eng.tree)], (moves, [e["carried_visits"]
                                            for e in eng.searches])

    reserved = []

    def run():
        kernels.reset_launch_counts()
        reserved.clear()
        out = [actor_moves(False, 4), actor_moves(True, 2), gtp_moves()]
        return out, kernels.launch_counts()

    monkeypatch.setattr(mcts, "_GRAPHED", {})
    monkeypatch.setattr(mcts, "_WARM", set())
    with monkeypatch.context() as m:
        m.setattr(mcts, "_graphs_on", lambda tree: False)
        eager, eager_launches = run()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        graphed, graphed_launches = run()
    counts = profiling.counters()
    profiling.reset()

    assert graphed_launches == eager_launches
    assert eager_launches["step_analysis"] > 0
    for (e_searched, e_moves), (g_searched, g_moves) in zip(eager, graphed):
        assert e_moves == g_moves
        assert len(e_searched) == len(g_searched)
        for (e_res, e_tree), (g_res, g_tree) in zip(e_searched, g_searched):
            for field, a, b in zip(e_tree._fields, e_tree, g_tree):
                assert torch.equal(a, b), field
            if e_res is not None:
                for a, b in zip(e_res, g_res):
                    assert torch.equal(a, b)
    # eight searched trees, one capture each; the first descent of each of
    # the three layouts ran eagerly before it
    assert counts["search.descent_captures"] == 8
    assert counts["search.descents_replayed"] == counts["search.descents"] - 3
    assert len(mcts._GRAPHED) == 3
    assert reserved[3] <= reserved[1]


def test_offline_steps_on_card_match_cpu(dev, monkeypatch):
    """Three fp32 supervised (df_pred) steps on the card against the same
    steps on the CPU, on offline targets of two horizons: stats, parameters
    and BN statistics within 1e-4 (TF32 off, as above)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, a, card, b = _learner_pair(False, dev)
    step_a, step_b = cpu.make_offline_train_step(), card.make_offline_train_step()
    for i in range(3):
        feats, _, winner = _train_batch(i)
        target = torch.from_numpy(np.random.default_rng(i).integers(
            0, 82, size=(8, 2)).astype(np.int32))
        a, sa = step_a(a, feats, target, winner)
        b, sb = step_b(b, feats.to(dev), target.to(dev), winner.to(dev))
        assert "acc/top1" in sb
        for k in sa:
            assert abs(float(sa[k]) - float(sb[k])) < 1e-4 * max(
                1.0, abs(float(sa[k]))), (i, k)
    for (n, x), (_, y) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        torch.testing.assert_close(y.cpu(), x, atol=1e-4, rtol=0, msg=n)


def test_policy_net_bf16_on_card_close_to_fp32_cpu(dev):
    """PolicyNet (6 layers x 32, 19x19, T = 3) in bf16 on the card against
    the fp32 net from the same weights on the CPU: probabilities sum to 1
    within 1e-3, the top move agrees on at least 90 % of the rows, and no
    probability differs by more than 0.1."""
    from elf_tpu_torch.models.policy_net import (
        PolicyNetConfig,
        init_policy_net,
        policy_params_from_jax,
        policy_params_to_jax,
    )

    cfg = PolicyNetConfig(num_layer=6, dim=32, num_future_actions=3,
                          use_bf16=False)
    net32 = init_policy_net(cfg, torch.Generator().manual_seed(0), "cpu")
    net16 = policy_params_from_jax(
        *policy_params_to_jax(net32),
        PolicyNetConfig(num_layer=6, dim=32, num_future_actions=3), dev)
    x = (torch.rand((64, 19, 19, 25), generator=torch.Generator()
                    .manual_seed(1)) < 0.3).float()
    with torch.no_grad():
        ref = net32(x)
        out = net16(x.to(dev)).cpu()
    assert out.shape == (64, 3, 362) and out.dtype == torch.float32
    assert float((out.exp().sum(dim=2) - 1).abs().max()) < 1e-3
    assert (out.argmax(dim=2) == ref.argmax(dim=2)).float().mean() >= 0.9
    assert float((out.exp() - ref.exp()).abs().max()) < 0.1


def test_self_atari_and_eyes_on_card_equal_cpu(dev):
    """`self_atari_mask` on the card (both liberty kernels launch, once
    each, at B * 361 boards) and the eye masks equal the CPU path."""
    from elf_tpu_torch.env.go import tactics

    size, B = 19, 4
    core = engine.init_core(B, size, "cpu")
    rng = np.random.default_rng(3)
    legal = np.ones((B, size * size + 1), bool)
    for _ in range(60):
        w = legal.astype(float)
        w[:, -1] = 1e-3
        a = np.array([rng.choice(len(r), p=r / r.sum()) for r in w], np.int32)
        core, info = engine.step_core(core, torch.from_numpy(a), size)
        legal = info.legal_next.numpy()
    kernels.reset_launch_counts()
    on_card = tactics.self_atari_mask(
        engine.GoCore(*(f.to(dev) for f in core)), size)
    assert kernels.launch_counts() == {"analyze_libs": 1, "step_analysis": 1}
    assert torch.equal(on_card.cpu(), tactics.self_atari_mask(core, size))
    colors = core.to_play
    for fn in (tactics.eye_mask, tactics.fake_eye_mask,
               tactics.true_eye_mask):
        assert torch.equal(fn(core.stones.to(dev), colors.to(dev),
                              size).cpu(), fn(core.stones, colors, size))


def _dp2_rank(rank, world, port, out_path):
    """One of two ranks on cuda:0 over gloo: two dp = 2 fp32 steps of a
    9x9 net on its half of each batch; rank 0 writes the gathered state."""
    from elf_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from elf_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_state,
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 backend="gloo")
    _, state, card, on_card = _learner_pair(False, "cuda",
                                            grad_clip_norm=0.5)
    mesh = make_mesh(world, tp=1)
    step, shardings = make_sharded_train_step(card, mesh, on_card)
    shard = shard_state(on_card, shardings)
    rows = batch_sharding(mesh, 8)
    losses = []
    for i in range(2):
        feats, pi, winner = (t[rows].cuda() for t in _train_batch(i))
        shard, stats = step(shard, feats, pi, winner)
        losses.append(float(stats["loss/total"]))
    full = gather_state(shard, shardings)
    if rank == 0:
        torch.save({"losses": losses,
                    "sd": {k: v.cpu() for k, v in
                           full.net.state_dict().items()}}, out_path)
    torch.distributed.destroy_process_group()


def test_dp2_step_two_ranks_on_one_card_match_one_rank(dev, tmp_path,
                                                       monkeypatch):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card)
    take dp = 2 steps with the batch statistics of the whole batch; the
    losses, parameters and BN statistics hold the one-rank steps on the
    card within 1e-4 (fp32, TF32 off)."""
    import socket

    import torch.multiprocessing as mp

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = str(tmp_path / "dp2.pt")
    mp.start_processes(_dp2_rank, args=(2, port, out), nprocs=2,
                       start_method="spawn")
    res = torch.load(out, weights_only=False)
    _, _, card, b = _learner_pair(False, dev, grad_clip_norm=0.5)
    step = card.make_train_step()
    for i in range(2):
        b, stats = step(b, *(t.to(dev) for t in _train_batch(i)))
        assert abs(float(stats["loss/total"]) - res["losses"][i]) < 1e-4
    for n, x in b.net.state_dict().items():
        torch.testing.assert_close(res["sd"][n], x.cpu(), atol=1e-4, rtol=0,
                                   msg=n)


def test_batch_replay_on_card_equals_cpu(dev):
    """`tools.ladder.batch_replay` of the golden 19x19 games (one cut
    short, one with a stone on an occupied point) on the card: the illegal
    mask and every field of the final state equal the CPU's, exactly, and
    `step_analysis` launches once per ply of the longest game."""
    from elf_tpu_torch.tools.ladder import batch_replay

    with gzip.open(os.path.join(GOLDEN_DIR, "ref_traj_19.jsonl.gz"),
                   "rt") as f:
        games = [[int(a) for a in json.loads(line)["actions"]] for line in f
                 if set(json.loads(line)["start_stones"]) == {"0"}]
    games.append(games[0][:40])
    games.append(games[1][:30] + [games[1][0]] + games[1][30:50])
    kernels.reset_launch_counts()
    ill_card, st_card = batch_replay(games, 19, device=dev)
    assert kernels.launch_counts() == {
        "step_analysis": max(len(g) for g in games), "analyze_libs": 0}
    ill_cpu, st_cpu = batch_replay(games, 19, device="cpu")
    assert (ill_card == ill_cpu).all()
    assert np.argwhere(ill_card).tolist() == [[len(games) - 1, 30]]

    def leaves(st):
        return [t for x in st for t in (x if isinstance(x, tuple) else (x,))]

    for a, b in zip(leaves(st_card), leaves(st_cpu)):
        assert torch.equal(a.cpu(), b)


def test_bench_env_steps_on_card(dev):
    """`bench_torch.bench_env_steps` at B = 4096 with 8-step chunks (3
    warm-up and 1 timed): a positive rate, one `step_analysis` launch a
    step and no `analyze_libs` (the legal mask rides on the step)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_torch

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sps = bench_torch.bench_env_steps(B=4096, chunk=8, iters=1)
    assert sps > 0
    assert kernels.launch_counts() == {"step_analysis": 8 * 4,
                                       "analyze_libs": 0}


def test_actor_device_draws_follow_their_distributions(dev):
    """The draws the actor makes from its CUDA generator: D4 codes uniform
    over 8 (chi-square at 7 degrees of freedom, p > 1e-3 at 16,384 draws);
    Dirichlet noise at alpha 0.03 and 0.2 zero on illegal actions, each
    row summing to 1, each legal action's mean 1 / n_legal within 6
    standard errors; `gumbel_categorical` frequencies within 0.01 of the
    softmax at 10^5 draws."""
    from elf_tpu_torch.search import mcts

    gen = torch.Generator(device=dev).manual_seed(3)
    n = 16384
    codes = mcts._draw_codes(n, gen, MCTSConfig(), dev)
    assert codes.device.type == "cuda"
    counts = torch.bincount(codes, minlength=8).cpu().numpy()
    assert counts.shape == (8,) and counts.sum() == n
    chi2 = float(((counts - n / 8) ** 2 / (n / 8)).sum())
    assert chi2 < 24.322        # the 0.999 quantile at 7 degrees of freedom

    rows, A = 20000, 362
    for alpha in (0.03, 0.2):
        for n_legal in (7, 181):
            idx = torch.randperm(A, generator=gen, device=dev)[:n_legal]
            legal = torch.zeros(rows, A, dtype=torch.bool, device=dev)
            legal[:, idx] = True
            noise = mcts.dirichlet_noise(legal, alpha, gen)
            assert not noise[~legal].any()
            torch.testing.assert_close(noise.sum(1).cpu(),
                                       torch.ones(rows), atol=1e-5, rtol=0)
            mean = noise[:, idx].double().mean(0).cpu().numpy()
            var = (1 / n_legal) * (1 - 1 / n_legal) / (n_legal * alpha + 1)
            se = np.sqrt(var / rows)
            assert np.abs(mean - 1 / n_legal).max() < 6 * se, (alpha, n_legal)

    draws = 100_000
    logits = torch.log(torch.tensor(
        [0.4, 0.25, 0.15, 0.1, 0.06, 0.04], device=dev))
    logits = torch.cat([logits, torch.full((A - 6,), -1e9, device=dev)])
    picked = mcts.gumbel_categorical(logits.expand(draws, A).contiguous(),
                                     gen)
    freq = torch.bincount(picked, minlength=A).double().cpu() / draws
    want = torch.softmax(logits.double().cpu(), 0)
    assert float((freq - want).abs().max()) < 0.01
    assert not freq[6:].any()


@pytest.mark.timeout(900)
def test_pair_eval_search_on_card_matches_cpu(dev, monkeypatch):
    """The learning proof's eval actor (`make_eval_actor`: 64 rollouts,
    pass masked until ply 160) with the committed export against the
    committed init at 20b256c, fp32 with TF32 off, the symmetries fixed
    (no D4 draws) and argmax moves from ply 0: the card plays the CPU's
    first 8 moves."""
    import dataclasses
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint
    from scripts.prove_learning_torch import make_eval_actor, parse_args

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    runs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs", "prove19")
    args = parse_args(["--out", "unused", "--board_size", "19",
                       "--blocks", "20", "--dim", "256", "--eval_games", "2",
                       "--eval_rollouts", "64", "--use_bf16", "0"])
    moves = {}
    for d in ("cpu", dev):
        trainer = Trainer(ModelConfig(board_size=19, num_planes=18,
                                      num_block=20, dim=256, use_bf16=False),
                          TrainOptions(num_block=20, dim=256), device=d)
        template = trainer.init_state(torch.Generator().manual_seed(0))
        a = load_checkpoint(os.path.join(runs, "export-best.bin"),
                            template=template)
        b = load_checkpoint(os.path.join(runs, "init_params.bin"),
                            template=template)
        actor = make_eval_actor(args, 19, d, trainer.make_eval_fn())
        assert actor.mcts_cfg.ply_pass_enabled == 160
        actor.mcts_cfg = dataclasses.replace(actor.mcts_cfg,
                                             rotation_flip=False)
        actor.cfg = dataclasses.replace(actor.cfg, policy_distri_cutoff=-1)
        seq = []
        for _ in range(8):
            actor.play_moves((a.net, b.net), (None, None), 1)
            seq.append(int(actor.state.core.last_move[0]))
        moves[str(d)] = seq
    assert moves["cuda"] == moves["cpu"]
    assert all(0 <= m < 361 for m in moves["cpu"])
