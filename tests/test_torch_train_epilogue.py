"""The learner's trunk epilogue (`elf_tpu_torch/models/epilogue.py`'s
`train_epilogue`) and the training path of `PolicyValueNet`, on the CPU.

The plain version against the modules it stands for (BatchNorm with its
batch statistics, ReLU, casts, the residual add), bit for bit, and a CPU
training forward (the modules) against today's forward; the card's path
(`_train_layer` and the autograd function that joins the CUDA kernels),
run here with the kernels' arithmetic written in torch (the formula of
`csrc/net_train_epilogue.cu`): against the plain version's autograd, a
net's step against the modules', remat against no remat, the counters
per step; which forwards take the epilogues; and the benchmark's reader of
the counter.  The kernels themselves are held against the plain version
on the card by `tests/test_torch_cuda.py` and `chip_smoke.py --only
train_epilogue`.

    python -m pytest tests/test_torch_train_epilogue.py -q -n 0
"""

import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from elf_tpu_torch import profiling
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models import epilogue as epi
from elf_tpu_torch.models import resnet
from elf_tpu_torch.models.policy_net import PolicyNet, PolicyNetConfig
from elf_tpu_torch.models.resnet import (BN_EPS, BatchNorm, ModelConfig,
                                         build_model)
from elf_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
NET = dict(board_size=5, num_block=2, dim=8)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


def _random_bn(bn: BatchNorm, g: torch.Generator) -> None:
    with torch.no_grad():
        C = bn.weight.shape[0]
        bn.weight.copy_(torch.randn(C, generator=g) * 0.5 + 1.0)
        bn.bias.copy_(torch.randn(C, generator=g) * 0.3)


def _modules_layer(bn, v, skip, conv_bias):
    """Today's modules on a convolution's output: the card's conv bias add,
    `BatchNorm.batch_norm`, ReLU, the cast and `ResBlock`'s skip add."""
    dt = v.dtype
    u = v + conv_bias.to(dt)[:, None, None] if conv_bias is not None else v
    y, mean, var = bn.batch_norm(u)
    y = F.relu(y).to(dt)
    return (F.relu(skip + y) if skip is not None else y), mean, var


def _modules_forward(net, x):
    """Today's training forward of `PolicyValueNet`, written with its
    modules: (log_pi, value), the running statistics written once."""
    dt = net.cfg.compute_dtype
    stats = []

    def layer(conv, bn, h):
        y, mean, var = bn.batch_norm(conv(h))
        stats.extend([mean, var])
        return F.relu(y)

    def block(blk, h):
        y = layer(blk.conv1, blk.bn1, h)
        y = layer(blk.conv2, blk.bn2, y.to(dt))
        return F.relu(h + y.to(dt))

    h = x.permute(0, 3, 1, 2).to(dt)
    h = layer(net.init_conv, net.init_bn, h).to(dt)
    for blk in net.blocks:
        # a recomputed block appends its statistics again in the backward
        # pass, after the running statistics were written
        h = (checkpoint(block, blk, h, use_reentrant=False)
             if net.cfg.remat else block(blk, h))
    B = h.shape[0]
    p = layer(net.pi_conv, net.pi_bn, h)
    log_pi = F.log_softmax(net.pi_fc(p.permute(0, 2, 3, 1).reshape(B, -1)),
                           dim=-1)
    v = layer(net.v_conv, net.v_bn, h).reshape(B, -1)
    value = torch.tanh(net.v_fc2(F.relu(net.v_fc1(v)))[:, 0])
    bns = net.trunk_bns() + [net.pi_bn, net.v_bn]
    for bn, mean, var in zip(bns, stats[0::2], stats[1::2]):
        bn.update_running(mean, var)
    return log_pi, value


def _net_pair(dtype, remat, seed=0):
    cfg = ModelConfig(**NET, use_bf16=dtype == torch.bfloat16, remat=remat)
    net = build_model(cfg, "cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for bn in net.trunk_bns() + [net.pi_bn, net.v_bn]:
            _random_bn(bn, g)
        for name, p in net.named_parameters():
            if "conv" in name and name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    twin = build_model(cfg, "cpu", seed=seed)
    twin.load_state_dict(net.state_dict())
    return net, twin


def _planes(B, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(B, NET["board_size"], NET["board_size"], 18,
                      generator=g).round()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("conv_bias", [False, True])
@pytest.mark.parametrize("skip", [False, True])
def test_plain_version_equals_the_modules(skip, conv_bias, dtype, remat):
    """One layer, the plain version against the modules: y, mean, var and
    the gradients of v, weight, bias, skip and conv bias; one net on the
    CPU (the modules) against today's training forward: the outputs, the
    running statistics and every parameter gradient, with and without
    remat."""
    C = 16
    g = torch.Generator().manual_seed(3 * skip + 2 * conv_bias)
    bn = BatchNorm(C)
    _random_bn(bn, g)
    v0 = (torch.randn(4, C, 5, 5, generator=g) * 1.5 + 0.4).to(dtype)
    x0 = F.relu(torch.randn(4, C, 5, 5, generator=g)).to(dtype)
    cb0 = torch.randn(C, generator=g) * 0.2
    up = torch.randn(4, C, 5, 5, generator=g).to(dtype)

    def run(fn):
        v = v0.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(True) if skip else None
        cb = cb0.clone().requires_grad_(True) if conv_bias else None
        w = bn.weight.detach().clone().requires_grad_(True)
        b = bn.bias.detach().clone().requires_grad_(True)
        y, mean, var = fn(v, w, b, x, cb)
        (y.float() * up.float()).sum().backward()
        grads = [t.grad for t in (v, w, b, x, cb) if t is not None]
        return [y, mean, var] + grads

    got = run(epi.train_epilogue_ref)
    # the modules' parameters are bn's own: read their gradients there
    v = v0.clone().requires_grad_(True)
    x = x0.clone().requires_grad_(True) if skip else None
    cb = cb0.clone().requires_grad_(True) if conv_bias else None
    bn.weight.grad = bn.bias.grad = None
    y, mean, var = _modules_layer(bn, v, x, cb)
    (y.float() * up.float()).sum().backward()
    want = [y, mean, var, v.grad, bn.weight.grad, bn.bias.grad]
    want += [t.grad for t in (x, cb) if t is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    assert 0.1 < float((y == 0).float().mean()) < 0.9

    net, twin = _net_pair(dtype, remat)
    feats = _planes(6, seed=7)
    outs = []
    for which, fwd in ((net, lambda: net(feats, train=True)),
                       (twin, lambda: _modules_forward(twin, feats))):
        log_pi, value = fwd()
        loss = -log_pi[:, :5].mean() + (value ** 2).mean()
        grads = torch.autograd.grad(loss, list(which.parameters()))
        outs.append(([log_pi, value], grads,
                     [b.clone() for b in which.buffers()]))
    for a_list, b_list in zip(outs[0], outs[1]):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert _same_bits(a, b)


def _counted_forward(net, x):
    epi_before = dict(epi.launches)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = net(x, train=True)
        out[0].sum().backward()
    c = profiling.counters()
    profiling.reset()
    assert epi.launches == epi_before           # no kernel on the CPU
    return out, c


def test_which_forwards_take_the_epilogues():
    """A training forward on a CUDA input of a net without mesh attributes
    whose channels are a multiple of 8 takes the epilogues; a CPU input, a
    forward at inference, a mesh attribute, channels no multiple of 8 and
    `PolicyNet` keep the modules: on the CPU nothing is counted or
    launched, and the modules give today's bits whatever the mesh
    attribute."""
    card = types.SimpleNamespace(device=torch.device("cuda"))  # all it reads
    feats = _planes(3, seed=4)
    net, twin = _net_pair(torch.bfloat16, False)
    assert net.takes_train_epilogues(card, True)
    assert not net.takes_train_epilogues(card, False)
    assert not net.takes_train_epilogues(feats, True)
    out, c = _counted_forward(net, feats)
    assert c == {}
    # a mesh attribute: here a BN that normalises all its channels as a
    # slice, which the modules compute as the whole
    twin.blocks[1].bn2.channels = slice(None)
    assert not twin.takes_train_epilogues(card, True)
    got, c = _counted_forward(twin, feats)
    assert c == {}
    assert all(_same_bits(a, b) for a, b in zip(out, got))
    for attr, value in (("sync", object()), ("tp", object())):
        probe, _ = _net_pair(torch.bfloat16, False)
        target = probe.init_bn if attr == "sync" else probe.blocks[0].conv1
        setattr(target, attr, value)
        assert not probe.takes_train_epilogues(card, True)
    odd = build_model(ModelConfig(board_size=5, num_block=1, dim=12), "cpu")
    assert not odd.takes_train_epilogues(card, True)
    _, c = _counted_forward(odd, feats)
    assert c == {}
    pcfg = PolicyNetConfig(board_size=5, num_layer=2, dim=8)
    policy = PolicyNet(pcfg)
    assert not hasattr(policy, "takes_train_epilogues")
    _, c = _counted_forward(policy, torch.rand(2, 5, 5, pcfg.num_planes))
    assert c == {}
    with pytest.raises(ValueError, match="CUDA"):
        epi.train_epilogue(torch.zeros(1, 8, 2, 2), torch.ones(8),
                           torch.zeros(8))


# --------------------------------------------------- the autograd function


def _fake_stats(v, weight, cb=None):
    """The statistics kernels' arithmetic: sums in double, flax's variance,
    the gate of its clamp."""
    u = v if cb is None else v + cb[:, None, None]
    f = u.double()
    n = f.numel() // f.shape[1]
    m = f.sum((0, 2, 3)) / n
    raw = (f * f).sum((0, 2, 3)) / n - m * m
    var = raw.clamp(min=0.0).float()
    rstd = torch.rsqrt(var.double() + BN_EPS)
    return m.float(), var, (rstd * weight.double()).float(), \
        (raw >= 0).float()


def _fake_grad(v, cb, mean, var, mul, gate, bias, out, g):
    """The backward kernels' arithmetic (`csrc/net_train_epilogue.cu`)."""
    dt = v.dtype
    c = lambda t: t[:, None, None]  # noqa: E731
    u = (v if cb is None else v + c(cb)).float()
    d = u - c(mean)
    y = d * c(mul) + c(bias)
    gs = g if out is None else torch.where(out <= 0, torch.zeros_like(g), g)
    gy = torch.where(y <= 0, 0.0, gs.float())
    n = v.numel() // v.shape[1]
    s1 = gy.double().sum((0, 2, 3))
    s2 = (gy.double() * d.double()).sum((0, 2, 3))
    rstd = torch.rsqrt(var.double() + BN_EPS)
    k = mul.double()
    c1 = (-k * s1 / n).float()
    c2 = (-k * gate.double() * s2 * rstd * rstd / n).float()
    du = (c(mul) * gy + c(c2) * d + c(c1)).to(dt)
    dcb = None if cb is None else du.double().sum((0, 2, 3)).float()
    return (du, None if out is None else gs, (s2 * rstd).float(),
            s1.float(), dcb)


@pytest.fixture
def kernels_in_torch(monkeypatch):
    """The card's path on the CPU: a training forward takes the epilogues
    whatever its device, and the kernels are their arithmetic in torch."""
    monkeypatch.setattr(epi, "train_stats_cuda", _fake_stats)
    monkeypatch.setattr(epi, "train_grad_cuda", _fake_grad)
    monkeypatch.setattr(epi, "epilogue_cuda", epi.epilogue_ref)
    monkeypatch.setattr(epi, "_check_v", lambda v: tuple(v.shape))
    monkeypatch.setattr(resnet.PolicyValueNet, "takes_train_epilogues",
                        lambda self, x, train: train
                        and resnet._fits_epilogues(self, self.trunk_bns()))


def _step_grads(net, feats):
    log_pi, value = net(feats, train=True)
    loss = -log_pi[:, :5].mean() + (value ** 2).mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return [log_pi, value], grads, [b.clone() for b in net.buffers()]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_path_with_the_kernels_arithmetic(dtype, kernels_in_torch):
    """A net's training step through `_train_layer` (NHWC, the conv bias in
    the epilogue, the skip as the block input) with the kernels'
    arithmetic: with remat the same bits as without (the recomputed blocks
    repeat the forward); in fp32 the outputs, every parameter gradient and
    running statistic within 1e-4 of the larger of its largest and the
    median leaf's largest of the modules' (the order of the sums; the
    median for a gradient that is nought to rounding, a conv bias that a
    batch-statistics BN follows, as the benchmark's check scales it).  In
    bf16 roundings a layer apart compound through the net; the card tests
    hold that layer by layer."""
    feats = _planes(6, seed=9)
    steps = {}
    for remat in (False, True):
        net, twin = _net_pair(dtype, remat)
        steps[remat] = _step_grads(net, feats)
    for a_list, b_list in zip(steps[False], steps[True]):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert _same_bits(a, b)
    if dtype == torch.bfloat16:
        return
    want = [list(t) for t in _step_grads_modules(twin, feats)]
    med = float(torch.stack([g.abs().max() for g in want[1]]).median())
    for a_list, b_list in zip(steps[False], want):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            a, b = a.detach(), b.detach()
            if not b.is_floating_point():
                assert torch.equal(a, b)
                continue
            tol = 1e-4 * max(float(b.abs().max()), med)
            assert float((a - b).abs().max()) <= tol


def _step_grads_modules(net, feats):
    log_pi, value = _modules_forward(net, feats)
    loss = -log_pi[:, :5].mean() + (value ** 2).mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return [log_pi, value], grads, [b.clone() for b in net.buffers()]


@pytest.mark.parametrize("remat", [False, True])
def test_counters_per_step(remat, kernels_in_torch):
    """On the card's path: `net.train_epilogues` 1 + 2 x blocks a training
    forward, and 2 x blocks more with remat (the recomputed blocks); the
    grads 1 + 2 x blocks a step; nothing counted with tracing off, at
    inference, or by the cooldown step's backward-free forward beyond its
    epilogues."""
    cfg = ModelConfig(**NET, remat=remat)
    trainer = Trainer(cfg, TrainOptions(batchsize=4, num_block=2, dim=8),
                      device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.make_train_step()
    feats = _planes(4, seed=1)
    pi = torch.full((4, 26), 1.0 / 26)
    z = torch.tensor([1.0, -1.0, 1.0, -1.0])
    profiling.reset()
    step(state, feats, pi, z)
    assert profiling.counters() == {}
    blocks = NET["num_block"]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            step(state, feats, pi, z)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.train_epilogues": 2 * (1 + (4 if remat else 2) * blocks),
                 "net.train_epilogue_grads": 2 * (1 + 2 * blocks)}
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            state.net(feats)
        trainer.make_cooldown_step()(state, feats)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.train_epilogues": 1 + 2 * blocks}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("skip", [False, True])
def test_autograd_function_with_the_kernels_arithmetic(dtype, skip,
                                                       monkeypatch):
    """`_TrainEpilogue` with the kernels replaced by their arithmetic in
    torch, against the plain version's autograd: the forward as the plain
    version's up to the order of its sums, and every gradient within a
    tolerance set by that order (fp32: 1e-4 of the largest; bf16: one
    rounding of the compute dtype, 2^-7 of the value, and 1e-2 of the
    largest where a difference of two rounded terms nears 0)."""
    monkeypatch.setattr(epi, "train_stats_cuda", _fake_stats)
    monkeypatch.setattr(epi, "train_grad_cuda", _fake_grad)
    monkeypatch.setattr(epi, "epilogue_cuda", epi.epilogue_ref)
    C = 16
    g = torch.Generator().manual_seed(11 + skip)
    v0 = (torch.randn(6, C, 7, 7, generator=g) * 2 + 0.5).to(dtype)
    x0 = F.relu(torch.randn(6, C, 7, 7, generator=g)).to(dtype)
    cb0 = torch.randn(C, generator=g) * 0.2
    w0 = torch.randn(C, generator=g) * 0.5 + 1.0
    b0 = torch.randn(C, generator=g) * 0.3
    up = torch.randn(6, C, 7, 7, generator=g).to(dtype)
    res = []
    for fn in (epi.train_epilogue_ref, epi._TrainEpilogue.apply):
        ins = [t.clone().requires_grad_(True) for t in (v0, cb0, w0, b0)]
        x = x0.clone().requires_grad_(True) if skip else None
        if fn is epi.train_epilogue_ref:
            y, mean, var = fn(ins[0], ins[2], ins[3], x, ins[1])
        else:
            y, mean, var = fn(ins[0], ins[1], ins[2], ins[3], x)
        (y.float() * up.float()).sum().backward()
        res.append([y, mean, var] + [t.grad for t in ins]
                   + ([x.grad] if skip else []))
    names = ["y", "mean", "var", "dv", "dconv_bias", "dweight", "dbias",
             "dskip"]
    for name, a, b in zip(names, res[1], res[0]):
        a, b = a.detach().double(), b.detach().double()
        scale = float(b.abs().max())
        if name == "dconv_bias":
            # a sum of du that cancels to rounding: bound it by its terms
            bound = 2.0 ** -6 * float(res[0][3].double().abs().sum(
                (0, 2, 3)).max())
            assert float((a - b).abs().max()) <= bound, name
            continue
        if dtype == torch.float32:
            tol = 1e-4 * scale
        else:
            tol = 2.0 ** -7 * b.abs() + 1e-2 * scale
        assert bool(((a - b).abs() <= tol).all()), name


# ------------------------------------------------------- the benchmark's reader


def _reader():
    sys.path[:0] = [os.path.join(ROOT, "perfbench")]
    try:
        from harness import core, spans
    finally:
        del sys.path[0]
    return core.metric_reader("net.train_epilogues_per_step.train"), spans, core


def test_train_epilogues_per_step_reader(monkeypatch):
    read, spans, core = _reader()

    def ctx(trace, steps, counters):
        monkeypatch.setattr(spans, "counters", lambda: counters)
        return types.SimpleNamespace(trace=trace, counters={"steps": steps})

    c = {"net.train_epilogues": 4 * 81, "net.train_epilogue_grads": 4 * 41}
    assert read(ctx(object(), 4, c)) == 81.0
    assert read(ctx(None, 4, c)) is None                     # untraced
    assert read(ctx(object(), 0, c)) is None
    assert read(ctx(object(), 4, {})) is None                # the parent
    spec = {m["name"]: m for m in core.load_spec()["per_layer"]}
    m = spec["net.train_epilogues_per_step.train"]
    assert m["workloads"] == ["go19_20b256c.train_b2048"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "learner", "train_positions_per_s", "program_counter")

