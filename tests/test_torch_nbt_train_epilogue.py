"""The learner's norm kernels of the nested-bottleneck net
(`elf_tpu_torch/models/epilogue.py`'s `nbt_train_normact` and
`nbt_train_pool`, `csrc/nbt_train_epilogue.cu`).

On the CPU: the kernels' plain versions (`nbt_train_normact_ref`,
`nbt_train_pool_ref`: their arithmetic in torch, forward and backward)
against autograd through the training forward's own torch ops (`models/
nbt.py`'s `_Training` on a CPU tensor), per mode, activation and dtype: the
outputs and statistics, the gradients of v, the skip, the row bias, the
weight and the bias; the pool's gradient on tied maxima; the variance
clamp's gate; NaN as torch's; the statistics' order of summation against a
thread-by-thread walk; and a net's training step through the card's path
with the plain versions in the kernels' place: against the torch ops, remat
against no remat, the counters, a layer outside the kernels refused.

On the card (marked `cuda`, skipped without one): the kernels against the
plain versions at the net's widths, the statistics and the forward bit for
bit; two calls give the same bits; a b18c384nbt remat step on the kernels
against the torch ops' step (`train_kernels` off), and its counters; a
layer outside the kernels refused.

    python -m pytest tests/test_torch_nbt_train_epilogue.py -q -n 0
    python -m pytest -o addopts= --noconftest -m cuda \
        tests/test_torch_nbt_train_epilogue.py
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elf_tpu_torch import profiling
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models import epilogue as epi
from elf_tpu_torch.models import nbt
from elf_tpu_torch.models.resnet import BatchNorm
from elf_tpu_torch.training.loss import mcts_prediction_loss
from elf_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["normact", "skip", "row", "gpool", "value"]
CL = torch.channels_last


def _inputs(B, C, hw, dtype, seed, device="cpu"):
    """v (an offset, so that the mean is not 0), the skip, the row bias,
    the norm's weight and bias, channels_last."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (B, C, hw, hw)
    v = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(
        dtype).contiguous(memory_format=CL)
    skip = torch.randn(shape, generator=g, device=device).to(
        dtype).contiguous(memory_format=CL)
    rowbias = torch.randn(B, C, generator=g, device=device) * 0.5
    weight = torch.randn(C, generator=g, device=device) * 0.3 + 1.0
    bias = torch.randn(C, generator=g, device=device) * 0.3
    return v, skip, rowbias, weight, bias


def _run(fn, mode, act, v, skip, rowbias, weight, bias, seed=0):
    """(outputs, mean, var, grads) of a layer under a loss weighting each
    output elementwise: fn(v, weight, bias, skip, rowbias, mode) -> the
    layer's outputs, then mean and var."""
    leaves = {"v": v, "weight": weight, "bias": bias}
    if mode == "skip":
        leaves["skip"] = skip
    if mode == "row":
        leaves["rowbias"] = rowbias
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in leaves.items()}
    *outs, mean, var = fn(leaves["v"], leaves["weight"], leaves["bias"],
                          leaves.get("skip"), leaves.get("rowbias"), mode)
    g = torch.Generator(device=v.device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device=v.device)).sum()
               for o in outs)
    loss.backward()
    return ([o.detach() for o in outs], mean.detach(), var.detach(),
            {k: t.grad for k, t in leaves.items()})


def _plain(act):
    def fn(v, weight, bias, skip, rowbias, mode):
        if mode in ("gpool", "value"):
            return epi.nbt_train_pool_ref(v, weight, bias, act, mode)
        return epi.nbt_train_normact_ref(v, weight, bias, act, skip, rowbias)
    return fn


def _kernels(act):
    def fn(v, weight, bias, skip, rowbias, mode):
        if mode in ("gpool", "value"):
            return epi.nbt_train_pool(v, weight, bias, act, mode)
        return epi.nbt_train_normact(v, weight, bias, act, skip, rowbias)
    return fn


def _torch_ops(act):
    """The training forward's own torch ops (`nbt._Training` without the
    kernels), through a BatchNorm holding the given weight and bias."""
    def fn(v, weight, bias, skip, rowbias, mode):
        norm = BatchNorm(v.shape[1])
        del norm.weight, norm.bias          # the given tensors in their place
        norm.weight, norm.bias = weight, bias
        ep = nbt._Training(act, kernels=False)
        if mode in ("gpool", "value"):
            out = (ep.pool(v, norm, mode),)
        else:
            out = ep.normact(v, norm, skip, rowbias)
            out = out if skip is not None else (out,)
        return (*out, *ep.stats)
    return fn


def _close(a, b, tol_rel, tol_top, what):
    a, b = a.double(), b.double()
    top = float(b.abs().max())
    bound = tol_rel * b.abs() + tol_top * top
    assert bool(((a - b).abs() <= bound).all()), (
        what, float((a - b).abs().max()), top)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_against_the_torch_ops(mode, act, dtype):
    """The plain version against autograd through the torch ops: the
    statistics within 1e-6 of the root mean square (sums in double against
    torch's fp32), the outputs within one rounding of the compute dtype
    (fp32: 1e-5 of the largest; the two mish forms differ in their last
    bits), each gradient within 1e-4 (fp32) or one bf16 rounding plus 1e-2
    (bf16) of its largest, where torch's backward rounds d v once more and
    differentiates E[f^2] - mean^2 term by term."""
    v, skip, rowbias, weight, bias = _inputs(3, 16, 9, dtype, seed=7)
    got = _run(_plain(act), mode, act, v, skip, rowbias, weight, bias)
    want = _run(_torch_ops(act), mode, act, v, skip, rowbias, weight, bias)
    f = epi._layer_input(v, skip if mode == "skip" else None,
                         rowbias if mode == "row" else None)
    rms = f.double().pow(2).mean((0, 2, 3)).sqrt()
    assert float(((got[1] - want[1]).double().abs() / rms).max()) <= 1e-6
    assert float(((got[2] - want[2]).double().abs() / rms ** 2).max()) <= 1e-6
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        if dtype == torch.float32 or a.dtype == torch.float32:
            _close(a, b, 0, 1e-5, "output")
        else:
            _close(a, b, 2.0 ** -7, 1e-3, "output")
    if mode == "skip":     # the sum itself: the same bf16 add
        assert torch.equal(got[0][0], want[0][0])
    assert set(got[3]) == set(want[3])
    for name in got[3]:
        a, b = got[3][name], want[3][name]
        if dtype == torch.float32 or name in ("weight", "bias", "rowbias"):
            _close(a, b, 0, 1e-4 if dtype == torch.float32 else 2e-3, name)
        else:
            _close(a, b, 2.0 ** -7, 1e-2, name)


@pytest.mark.parametrize("act", ["mish", "relu"])
def test_pool_gradient_splits_evenly_among_tied_maxima(act):
    """Boards whose every point holds one value (the max tied at all 81,
    as near an empty board): the max's gradient goes to each point in equal
    shares, as `torch.amax`'s backward sends it, on the plain version and
    the torch ops alike."""
    B, C, hw = 4, 8, 9
    v, skip, rowbias, weight, bias = _inputs(B, C, hw, torch.float32, seed=3)
    v = v.clone()
    v[:2, :4] = torch.randn(2, 4, 1, 1) * 2      # flat boards
    v = v.contiguous(memory_format=CL)
    got = _run(_plain(act), "gpool", act, v, skip, rowbias, weight, bias)
    want = _run(_torch_ops(act), "gpool", act, v, skip, rowbias, weight, bias)
    _close(got[3]["v"], want[3]["v"], 0, 1e-4, "d v")
    # a flat board's gradient is flat (all to one point would not be)
    flat = got[3]["v"][:2, :4]
    assert torch.equal(flat, flat[..., :1, :1].expand_as(flat))


def test_variance_clamp_gate():
    """A channel whose E[f^2] - mean^2 falls below 0 in double (1296
    values of 2^23 + k, one of them 1 more) clamps the variance to 0 with
    the gate at 0, so that no gradient flows through the variance, as
    torch's clamp sends none: the plain version's d v against autograd
    through `BatchNorm.batch_norm`'s ops taken in double (fp32's own
    statistics are noise at 2^23), where the gate's term would move the
    odd point's gradient by 10^4 times its size."""
    B, C, hw = 16, 4, 9
    found = 0
    g = torch.Generator().manual_seed(0)
    for k in torch.randint(1, 2 ** 22, (400,), generator=g).tolist():
        v = torch.full((B, C, hw, hw), float(2 ** 23 + k))
        v[0, :, 0, 0] += 1.0
        v = v.contiguous(memory_format=CL)
        weight, bias = torch.ones(C), torch.zeros(C)
        mean, var, mul, gate = epi.nbt_train_stats_ref(v, weight)
        if float(gate[0]) != 0.0:
            continue
        assert float(var[0]) == 0.0 and bool(torch.isfinite(mul).all())
        got = _run(_plain("relu"), "normact", "relu", v, None, None, weight,
                   bias)
        x = v.double().requires_grad_(True)
        m = x.mean((0, 2, 3))
        var64 = ((x * x).mean((0, 2, 3)) - m * m).clamp(min=0.0)
        y = (x - m[:, None, None]) * (torch.rsqrt(var64 + 1e-5)
                                      * weight.double())[:, None, None]
        up = torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
        (torch.relu(y + bias.double()[:, None, None]) * up).sum().backward()
        assert float(var64[0]) == 0.0
        _close(got[3]["v"][:, 0], x.grad[:, 0], 0, 1e-4, "d v")
        found += 1
        if found == 3:
            break
    assert found == 3


@pytest.mark.parametrize("mode", MODES)
def test_nan_like_torch(mode):
    """A NaN in one element of v: the same outputs and gradients NaN as
    through torch's ops (a NaN channel's statistics poison its channel,
    on the board and through the batch statistics), the rest finite."""
    act = "mish"
    v, skip, rowbias, weight, bias = _inputs(3, 8, 9, torch.float32, seed=5)
    v = v.clone()
    v[1, 2, 4, 4] = float("nan")
    v = v.contiguous(memory_format=CL)
    got = _run(_plain(act), mode, act, v, skip, rowbias, weight, bias)
    want = _run(_torch_ops(act), mode, act, v, skip, rowbias, weight, bias)
    pairs = list(zip(got[0], want[0])) + [(got[1], want[1]),
                                          (got[2], want[2])]
    pairs += [(got[3][k], want[3][k]) for k in want[3]]
    for a, b in pairs:
        assert torch.equal(a.isnan(), b.isnan())
        assert bool(a.isnan().any()) and not bool(a.isnan().all())


@pytest.mark.parametrize("shape,board", [((3, 8, 5, 5), False),
                                         ((2, 16, 7, 7), True),
                                         ((1, 32, 9, 9), False)])
def test_ordered_sums_walk_the_kernels_order(shape, board):
    """`_ordered_sums` against a walk of the passes thread by thread
    (block i's chunks i, i + grid, ...; a thread row's pixels y, y + rows,
    ...), bit for bit, for grids that leave blocks idle or short."""
    B, C, H, W = shape
    g = torch.Generator().manual_seed(B + C)
    f = (torch.randn(shape, generator=g) * 3 + 1).contiguous(
        memory_format=CL)
    x = f.permute(0, 2, 3, 1).reshape(-1, C)
    P = x.shape[0]
    for rows, grid in ((4, 3), (8, 5), (2, 40)):
        span = H * W if board else 2 * rows
        got = epi._ordered_sums(f, rows, span, grid)
        part = torch.zeros(2, grid, C)
        for blk in range(grid):
            acc = torch.zeros(2, rows, C)
            u = blk
            while u * span < P:
                n = min(span, P - u * span)
                for y in range(rows):
                    for i in range(y, n, rows):
                        e = x[u * span + i]
                        acc[0, y] = acc[0, y] + e
                        acc[1, y] = acc[1, y] + e * e
                u += grid
            for y in range(rows):
                part[:, blk] = part[:, blk] + acc[:, y]
        runs = torch.zeros(2, 8, C, dtype=torch.float64)
        for blk in range(grid):
            runs[:, blk % 8] = runs[:, blk % 8] + part[:, blk].double()
        want = torch.zeros(2, C, dtype=torch.float64)
        for r in range(8):
            want = want + runs[:, r]
        assert torch.equal(got, want), (rows, grid)
        d = f.double()
        plain = torch.stack([d.sum((0, 2, 3)), (d * d).sum((0, 2, 3))])
        assert torch.allclose(got, plain, rtol=1e-6)


# ------------------------------------------------- the card's path, on the CPU

SMALL = nbt.NbtConfig(board_size=9, trunk_channels=32, mid_channels=16,
                      gpool_channels=8, num_blocks=2, gpool_blocks=(2,),
                      p1_channels=8, g1_channels=8, v1_channels=8, v2_size=8,
                      use_bf16=False)


def _fits_any_device(v, pool=False):
    lanes = 16 // v.element_size()
    return v.dim() == 4 and v.shape[1] % lanes == 0


@pytest.fixture
def plain_kernels(monkeypatch):
    """The card's path on the CPU: the training forward takes the learner's
    kernels on a CPU input (unless the net's `train_kernels` is off), the
    kernels take a layer whose channels fit and refuse any other, and they
    are their plain versions (counted as the kernels are)."""
    monkeypatch.setattr(nbt.NestedBottleneckNet, "takes_train_kernels",
                        lambda net, x: net.train_kernels)
    monkeypatch.setattr(epi, "nbt_train_fits", _fits_any_device)
    monkeypatch.setattr(epi, "_KERNELS", epi._PLAIN)
    monkeypatch.setattr(epi, "_check_v", lambda v: tuple(v.shape))


def _step(net, batch):
    log_pi, value = net(batch[0], train=True)
    loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2])
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return loss.detach(), grads, [b.clone() for b in net.buffers()]


def _batch(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    n2 = cfg.board_size ** 2
    x = (torch.rand(B, cfg.board_size, cfg.board_size, cfg.num_planes,
                    generator=g) < 0.3).float()
    pi = torch.rand(B, n2 + 1, generator=g) ** 4
    z = torch.where(torch.rand(B, generator=g) < 0.5, 1.0, -1.0)
    return x, pi / pi.sum(1, keepdim=True), z


def _net(cfg, seed):
    net = nbt.build_model(cfg, "cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.2
                               + 1.0)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
    return net


def test_card_path_step_against_the_torch_ops(plain_kernels):
    """A fp32 step of the small net through the card's path (every layer
    on the plain versions of the kernels) against the torch ops' step
    (the net's `train_kernels` off): the loss within 2e-6, each
    parameter's gradient within 2e-4 of the larger of its norm and the
    median leaf's, the running statistics within 2e-6 (the test of
    `test_torch_nbt_train.py`'s tolerances); with remat the same bits as
    without."""
    batch = _batch(SMALL, 6, 1)
    torch_net = _net(SMALL, 2)
    torch_net.train_kernels = False
    want = _step(torch_net, batch)
    steps = [_step(_net(dataclasses.replace(SMALL, remat=remat), 2), batch)
             for remat in (False, True)]
    for a, b in zip([*steps[0][1], *steps[0][2]],
                    [*steps[1][1], *steps[1][2]]):
        assert torch.equal(a, b)
    assert torch.equal(steps[0][0], steps[1][0])
    got = steps[0]
    assert abs(float(got[0] - want[0])) <= 2e-6 * abs(float(want[0]))
    norms = [float(g.norm()) for g in want[1]]
    med = float(np.median(norms))
    for a, b, nb in zip(got[1], want[1], norms):
        assert float((a - b).norm()) <= 2e-4 * max(nb, med)
    for a, b in zip(got[2], want[2]):
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 2e-6


@pytest.mark.parametrize("cfg,normacts", [
    (nbt.NbtConfig(board_size=9, remat=True), 232), (SMALL, 17)])
def test_card_path_counters(cfg, normacts, plain_kernels):
    """On the card's path a remat step of b18c384nbt counts 232
    norm-and-activation calls, all of them the kernels', 118 backward
    calls and 14 poolings (the small net without remat: 17, 17, 17 and
    3); nothing is counted with tracing off."""
    net = _net(cfg, 0)
    batch = _batch(cfg, 2, 0)
    _step(net, batch)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _step(net, batch)
    c = profiling.counters()
    profiling.reset()
    assert c["net.train_normacts"] == normacts
    assert c["net.train_normact_kernels"] == normacts
    assert c["net.train_normact_grads"] == (118 if cfg.remat else normacts)
    assert c["net.train_gpools"] == (14 if cfg.remat else 3)


def _refused(net, batch):
    """The training step refuses the net's layer outside the kernels."""
    with pytest.raises(ValueError, match="nbt_train_fits"):
        _step(net, batch)


def test_card_path_refuses_a_layer_outside_the_kernels(plain_kernels):
    """On the card's path a layer whose channels are no multiple of 16
    bytes' lanes (6 pooling channels) is refused, not run on torch's ops;
    with the net's `train_kernels` off the same step runs torch's ops and
    counts no kernel call."""
    cfg = dataclasses.replace(SMALL, gpool_channels=6)
    net, batch = _net(cfg, 0), _batch(cfg, 2, 0)
    _refused(net, batch)
    net.train_kernels = False
    with profile(activities=[ProfilerActivity.CPU]):
        _step(net, batch)
    c = profiling.counters()
    profiling.reset()
    assert c["net.train_normacts"] == 17
    assert "net.train_normact_kernels" not in c


def test_cpu_forward_keeps_the_torch_ops():
    """Without a card the training forward takes no kernel: nothing is
    launched or counted as the kernels'."""
    before = dict(epi.launches)
    net = _net(SMALL, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        _step(net, _batch(SMALL, 2, 0))
    c = profiling.counters()
    profiling.reset()
    assert epi.launches == before
    assert "net.train_normact_kernels" not in c
    assert "net.train_normact_grads" not in c
    assert c["net.train_normacts"] == 17


# ----------------------------------------------------------------- the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.timeout(600)
@pytest.mark.parametrize("B", [1, 2048])
@pytest.mark.parametrize("C", [32, 64, 128, 192, 384])
@pytest.mark.parametrize("mode", MODES)
def test_kernels_against_the_plain_version(dev, mode, C, B):
    """At 19x19, bf16 and fp32, mish and relu: the statistics bit for bit
    against the plain version summed in the kernels' order; the forward
    (the autograd function's) bit for bit against the plain apply with
    those statistics; the backward against the plain backward from the
    same statistics and gradients (its sums in double): d v (d s) within
    one rounding of the compute dtype (2^-7 of the value; fp32 2^-20)
    plus 1e-3 of the largest (fp32 1e-5), the weight's and bias's
    gradients (sums over the batch) within 1e-4 of the largest, the row
    bias's (sums over a board) within that plus 2^-20 of the sum of the
    board's |d v| at B = 2048; at B = 1, where the board is the whole batch
    and its sum of df cancels to its roundings, plus 2^-16 of the sum of
    the sizes of df's terms over the board (a fp32 sum of 361 terms in
    order may be off by (361 - 1) 2^-24 = 2^-15.5 of that)."""
    for dtype in (torch.bfloat16, torch.float32):
        for act in ("mish", "relu"):
            where = (dtype, act)
            v, skip, rowbias, weight, bias = _inputs(B, C, 19, dtype, C + B,
                                                     dev)
            skip = skip if mode == "skip" else None
            rowbias = rowbias if mode == "row" else None
            stats = epi.nbt_train_stats_cuda(v, weight, skip, rowbias)
            mean, var, mul, gate = stats
            want = epi.nbt_train_stats_ref(
                v, weight, skip, rowbias,
                epi.nbt_train_layout(v, rowbias is not None))
            assert all(torch.equal(a, b) for a, b in zip(stats, want)), where
            with torch.no_grad():
                *outs, m2, v2 = _kernels(act)(v, weight, bias, skip, rowbias,
                                              mode)
            assert torch.equal(m2, mean) and torch.equal(v2, var), where
            if mode in ("gpool", "value"):
                own = [epi.pool_ref(v, mean, mul, bias, act, mode)]
            else:
                own = epi.normact_ref(v, mean, mul, bias, act, skip, rowbias)
                own = list(own) if skip is not None else [own]
            assert all(torch.equal(a, b) for a, b in zip(outs, own)), where
            assert all(o.is_contiguous(memory_format=CL) for o in outs
                       if o.dim() == 4)
            g = torch.Generator(device=dev).manual_seed(B + C)
            up, ups = (torch.randn(v.shape, generator=g, device=dev).to(
                dtype).contiguous(memory_format=CL) for _ in range(2))
            dmean = dmax = None
            if mode in ("gpool", "value"):
                gp = torch.randn(B, 3 * C, generator=g, device=dev)
                dmean, dmax = epi.pooled_grads(gp, 19 * 19, mode)
                up = None
            x = outs[0] if mode == "skip" else v
            args = (mode, act, x, rowbias, mean, var, mul, gate, bias, up,
                    ups if mode == "skip" else None, dmean, dmax)
            got = epi.nbt_train_grad_cuda(*args)
            ref = epi.nbt_train_grad_ref(*args)
            assert got[0].is_contiguous(memory_format=CL)
            if dtype == torch.float32:
                _close(got[0], ref[0], 2.0 ** -20, 1e-5, ("d v", where))
            else:
                _close(got[0], ref[0], 2.0 ** -7, 1e-3, ("d v", where))
            for name, a, b in zip(("weight", "bias"), got[1:], ref[1:]):
                _close(a, b, 0, 1e-4, (name, where))
            assert (got[3] is None) == (ref[3] is None) == (mode != "row")
            if mode == "row" and B > 1:
                terms = ref[0].double().abs().sum((2, 3))
                bound = 1e-4 * float(ref[3].abs().max()) + 2.0 ** -20 * terms
                assert bool(((got[3] - ref[3]).abs() <= bound).all()), where
            elif mode == "row":
                # a board's sum of df = mul gy + c1 + c2 d, which cancels to
                # its roundings where the board is the whole batch: bound
                # it by the sum of its terms' sizes
                c = lambda t: t[:, None, None].double()  # noqa: E731
                d = (v.float() + rowbias[:, :, None, None]).double() - c(mean)
                y = d * c(mul) + c(bias)
                gy = up.double() * (epi.mish_grad(y) if act == "mish"
                                    else (y > 0).double())
                n = v.numel() // C
                rstd = torch.rsqrt(var.double() + epi.BN_EPS)
                c1 = -mul.double() * ref[2].double() / n
                c2 = -mul.double() * gate.double() * ref[1].double() * rstd / n
                terms = ((c(mul) * gy).abs() + c(c1).abs()
                         + (c(c2) * d).abs()).sum((2, 3))
                bound = 1e-4 * float(ref[3].abs().max()) + 2.0 ** -16 * terms
                assert bool(((got[3] - ref[3]).abs() <= bound).all()), where


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernels_repeat_bit_for_bit(dev, mode):
    """Two calls of the forward and the backward on the same input give
    the same bits (the sums take a fixed order, with no atomics), at
    19x19, B = 2048, 192 bf16 channels, mish."""
    v, skip, rowbias, weight, bias = _inputs(2048, 192, 19, torch.bfloat16,
                                             9, dev)
    runs = [_run(_kernels("mish"), mode, "mish", v, skip, rowbias, weight,
                 bias) for _ in range(2)]
    a, b = runs
    for x, y in zip(a[0] + [a[1], a[2]] + list(a[3].values()),
                    b[0] + [b[1], b[2]] + list(b[3].values())):
        assert torch.equal(x, y)


def _gaps(got, want):
    """The learner cell's gap measures of two gradient lists (norms by
    leaf): the worst leaf against the larger of its own and the median
    leaf's norm, and over all leaves."""
    med = float(np.median(want))
    moved = [i for i, w in enumerate(want) if w >= 1e-3 * med]
    gap = max(abs(got[i] - want[i]) / max(want[i], med) for i in moved)
    glob = lambda v: float(np.sqrt(sum(v[i] ** 2 for i in moved)))  # noqa
    return gap, abs(glob(got) - glob(want)) / glob(want)


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_remat_step_on_the_kernels_against_the_torch_ops(dev):
    """One b18c384nbt remat step at batch 32 on the kernels against the
    same step through the torch ops from the same weights and batch: the
    gradients' gaps under the learner cell's limits
    (`perfbench/limits/go19_b18c384nbt_learner.train_family_b2048.json`);
    every norm-and-activation call the kernels' (232), 118 backward
    calls, 14 poolings."""
    path = os.path.join(ROOT, "perfbench", "limits",
                        "go19_b18c384nbt_learner.train_family_b2048.json")
    with open(path) as f:
        limits = json.load(f)
    cfg = nbt.NbtConfig(remat=True)
    trainer = Trainer(cfg, TrainOptions(batchsize=32), device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(2))
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.rand((32, 19, 19, 18), generator=g, device=dev) < 0.3).float()
    pi = torch.rand((32, 362), generator=g, device=dev) ** 4
    pi = pi / pi.sum(1, keepdim=True)
    z = torch.where(torch.rand(32, generator=g, device=dev) < 0.5, 1.0, -1.0)
    params = list(state.net.parameters())

    def grads():
        log_pi, value = state.net(x, train=True)
        loss, _ = mcts_prediction_loss(log_pi, value, pi, z)
        return [float(t.norm()) for t in torch.autograd.grad(loss, params)]

    buffers = {k: b.clone() for k, b in state.net.named_buffers()}
    before = dict(epi.launches)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = grads()
        torch.cuda.synchronize(dev)
    c = profiling.counters()
    profiling.reset()
    assert c == {"net.train_normacts": 232, "net.train_normact_kernels": 232,
                 "net.train_normact_grads": 118, "net.train_gpools": 14}
    ran = {k: epi.launches[k] - before[k] for k in before}
    assert ran["nbt_train_stats"] == 232 and ran["nbt_train_grad"] == 118
    assert ran["nbt_normact"] == 232 - 14 and ran["nbt_pool"] == 14
    state.net.load_state_dict(buffers, strict=False)
    state.net.train_kernels = False
    want = grads()
    gap, gap_global = _gaps(got, want)
    assert gap <= limits["grad_gap"], gap
    assert gap_global <= limits["grad_gap_global"], gap_global


@pytest.mark.cuda
def test_training_forward_refuses_a_layer_outside_the_kernels(dev):
    """On the card a training forward whose net has a layer the kernels do
    not take (6 bf16 pooling channels) is refused before any backward;
    with `train_kernels` off it runs torch's ops there."""
    cfg = dataclasses.replace(SMALL, gpool_channels=6, use_bf16=True)
    net = _net(cfg, 0).to(dev)
    x, pi, z = (t.to(dev) for t in _batch(cfg, 2, 0))
    before = dict(epi.launches)
    with pytest.raises(ValueError, match="nbt_train_fits"):
        net(x, train=True)
    assert epi.launches["nbt_train_grad"] == before["nbt_train_grad"]
    net.train_kernels = False
    log_pi, value = net(x, train=True)
    loss, _ = mcts_prediction_loss(log_pi, value, pi, z)
    loss.backward()
    assert bool(torch.isfinite(loss))
