"""The plain policy-value ResNet of AlphaGo Zero (Silver et al., Nature
550:354, 2017, Methods) as ELF OpenGo runs it, in float32: the benchmark's
reference for the configurations `go19_20b256c` and `go13_10b128c`.

  trunk   3x3 conv (+bias) -> BN -> ReLU, then `num_block` residual blocks:
          conv-BN-ReLU, conv-BN-ReLU, add the block's input, ReLU
  policy  1x1 conv to 2 planes -> BN -> ReLU -> dense to n2 + 1 logits
          (the planes flattened point-major, channel-minor) -> log-softmax
  value   1x1 conv to 1 plane -> BN -> ReLU -> dense to `value_hidden` ->
          ReLU -> dense to 1 -> tanh

Departures from the paper, as the configuration states them: convolutions
carry a bias; BN normalises with eps 1e-5, by the running statistics to
evaluate and by the batch's (biased variance) to train; the tower input
has 18 planes (`agz.planes`).  Weights are a dict keyed by the names the
configuration's state dict uses (`weight_shapes`).

`conv_mode` selects the precision of the convolution path: its inputs,
weights, biases and outputs and the residual stream between blocks (BN,
the heads' dense layers and every accumulation stay float32).  "fp32" is
the reference (TF32 must be off, `exact_fp32`); "bf16" rounds that path to
bfloat16, as the configurations state it, and measures the rounding's own
reach; "fp8", the control, rounds it to float8 e4m3 with one scale per
tensor, and gradients (in training) to e5m2.  Imports torch alone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def exact_fp32() -> None:
    """Float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weight_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the net.  kind: "conv" and
    "dense" weights (fan-in scaled), "bias", "bn_w", "bn_b", "bn_mean",
    "bn_var"."""
    C, P, n = cfg["dim"], cfg["num_planes"], cfg["board_size"]
    n2 = n * n
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        out.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        for field, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                            ("running_mean", "bn_mean"),
                            ("running_var", "bn_var")):
            out.append((f"{name}.{field}", (c,), kind))

    def dense(name, cin, cout):
        out.append((f"{name}.weight", (cout, cin), "dense"))
        out.append((f"{name}.bias", (cout,), "bias"))

    conv("init_conv", P, C, 3)
    bn("init_bn", C)
    for i in range(cfg["num_block"]):
        for j in (1, 2):
            conv(f"blocks.{i}.conv{j}", C, C, 3)
            bn(f"blocks.{i}.bn{j}", C)
    conv("pi_conv", C, cfg["policy_planes"], 1)
    bn("pi_bn", cfg["policy_planes"])
    dense("pi_fc", cfg["policy_planes"] * n2, n2 + 1)
    conv("v_conv", C, cfg["value_planes"], 1)
    bn("v_bn", cfg["value_planes"])
    dense("v_fc1", cfg["value_planes"] * n2, cfg["value_hidden"])
    dense("v_fc2", cfg["value_hidden"], 1)
    return out


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


class _FakeQuant(torch.autograd.Function):
    """Round to float8 e4m3 forward and e5m2 backward, one scale each."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


def _round8(x, dtype, top):
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return ((x / scale).to(dtype).to(x.dtype)) * scale


def _round(x, mode):
    """x as the convolution path holds it in `mode`."""
    if mode == "fp8":
        return _FakeQuant.apply(x)
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    return x


def _conv(x, w, b, mode):
    y = F.conv2d(_round(x, mode), _round(w, mode), _round(b, mode),
                 padding=w.shape[-1] // 2)
    return _round(y, mode)


def _bn(x, W, name, train, stats):
    w, b = W[f"{name}.weight"], W[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    inv = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[:, None, None]) * inv[:, None, None] + b[:, None, None]


def forward(W: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            train: bool = False, conv_mode: str = "fp32",
            remat: bool = False, stats=None):
    """x: f32 [K, N, N, planes] -> (log_pi [K, n2 + 1], value [K]).  `train`
    normalises by the batch (writing each BN's batch moments into `stats`
    where given); `remat` recomputes each block in the backward pass to fit
    a large batch in memory (the same arithmetic)."""
    K = x.shape[0]

    def block(h, i):
        y = F.relu(_bn(_conv(h, W[f"blocks.{i}.conv1.weight"],
                             W[f"blocks.{i}.conv1.bias"], conv_mode),
                       W, f"blocks.{i}.bn1", train, stats))
        y = F.relu(_bn(_conv(y, W[f"blocks.{i}.conv2.weight"],
                             W[f"blocks.{i}.conv2.bias"], conv_mode),
                       W, f"blocks.{i}.bn2", train, stats))
        return _round(F.relu(h + _round(y, conv_mode)), conv_mode)

    h = x.permute(0, 3, 1, 2).float()
    h = _round(F.relu(_bn(_conv(h, W["init_conv.weight"], W["init_conv.bias"],
                                conv_mode), W, "init_bn", train, stats)),
               conv_mode)
    for i in range(cfg["num_block"]):
        if remat:
            h = checkpoint(block, h, i, use_reentrant=False)
        else:
            h = block(h, i)
    p = F.relu(_bn(_conv(h, W["pi_conv.weight"], W["pi_conv.bias"],
                         conv_mode), W, "pi_bn", train, stats))
    p = p.permute(0, 2, 3, 1).reshape(K, -1)
    log_pi = F.log_softmax(F.linear(p, W["pi_fc.weight"], W["pi_fc.bias"]),
                           dim=-1)
    v = F.relu(_bn(_conv(h, W["v_conv.weight"], W["v_conv.bias"], conv_mode),
                   W, "v_bn", train, stats)).reshape(K, -1)
    v = F.relu(F.linear(v, W["v_fc1.weight"], W["v_fc1.bias"]))
    v = F.linear(v, W["v_fc2.weight"], W["v_fc2.bias"])
    return log_pi, torch.tanh(v[:, 0])


def evaluate(W, x, cfg, conv_mode="fp32", rows=512):
    """The evaluation forward in blocks of `rows`: (log_pi, value)."""
    outs = []
    with torch.no_grad():
        for s in range(0, x.shape[0], rows):
            outs.append(forward(W, x[s:s + rows], cfg, conv_mode=conv_mode))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def az_loss(log_pi, value, pi_target, winner, value_weight=1.0):
    """AlphaZero's loss: cross-entropy to the visit distribution plus
    value_weight x the squared error to the game's result."""
    policy = -(pi_target * log_pi).sum(1).mean()
    return policy + value_weight * ((value - winner) ** 2).mean()


def sgd_steps(W0, batches, cfg, opts, conv_mode="fp32", half=False):
    """Follow `len(batches)` train steps from W0 in float32: the loss, its
    gradients, then L2 decay added to the gradient, a momentum trace and
    the step (t = momentum * t + g + wd * p; p -= lr * t).  Each batch is
    (features, pi_target, winner).  `half` takes the first half of every
    batch alone (a planted fault).  Returns (losses, the first step's
    gradient as the optimizer takes it and without the decay, per
    parameter, and the parameters after the last step)."""
    W = {k: v.clone().requires_grad_(is_param(k)) for k, v in W0.items()}
    names = [k for k in W if is_param(k)]
    trace = {k: torch.zeros_like(W[k]) for k in names}
    losses, first, first_raw = [], None, None
    for feats, pi, z in batches:
        if half:
            h = feats.shape[0] // 2
            feats, pi, z = feats[:h], pi[:h], z[:h]
        log_pi, v = forward(W, feats, cfg, train=True, conv_mode=conv_mode,
                            remat=True)
        loss = az_loss(log_pi, v, pi, z, opts["value_loss_weight"])
        grads = torch.autograd.grad(loss, [W[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            eff = {k: g + opts["weight_decay"] * W[k]
                   for k, g in zip(names, grads)}
            if first is None:
                first = {k: e.detach().clone() for k, e in eff.items()}
                first_raw = {k: g.detach().clone()
                             for k, g in zip(names, grads)}
            for k in names:
                trace[k].mul_(opts["momentum"]).add_(eff[k])
                W[k].sub_(opts["lr"] * trace[k])
        del grads, eff, log_pi, v, loss
    return losses, first, first_raw, {k: W[k].detach() for k in names}
