"""KataGo's nested-bottleneck net (`b18c384nbt`) trained in float32: the
benchmark's reference for the learner configuration
`go19_b18c384nbt_learner`.

The net is `kata_nbt.py`'s, built from its pieces (the state-dict names of
`weight_shapes`, KataGo's board pooling `_pool`, the norm's epsilon), in
training mode: every norm by the batch's mean and biased variance over
(K, N, N).  `remat` recomputes each nested block in the backward pass
(`torch.utils.checkpoint`; the same arithmetic), so that batch 2048 fits
in float32.  The loss is the learner's AlphaZero loss on the served value
P(win) - P(loss) (`resnet_pv.az_loss`; KataGo trains its three value
logits by cross-entropy against the outcome instead), and `sgd_steps`
follows the optimizer with `resnet_pv.sgd_steps`'s contract.

`conv_mode` as in `resnet_pv.py`: "fp32" is the reference (TF32 off,
`exact_fp32`); "bf16" rounds the convolution path (its inputs, weights and
outputs and the trunk and inner residual streams) to bfloat16, as the
configuration states it; "fp8", the control, rounds it to float8 e4m3
forward and its gradients to e5m2, one scale per tensor.  The norms, the
activations, the pooling and the dense layers stay float32.  Imports
torch alone.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import kata_nbt, resnet_pv
from reference.kata_nbt import exact_fp32, weight_shapes  # noqa: F401


def forward(W: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            conv_mode: str = "fp32", remat: bool = False, stats=None):
    """The training forward: x f32 [K, N, N, planes] -> (log_pi [K, N*N +
    1], value [K]), each norm's batch moments written into `stats` where
    given."""
    act = F.mish if cfg["activation"] == "mish" else F.relu
    rnd = lambda t: resnet_pv._round(t, conv_mode)  # noqa: E731

    def conv(name, h):
        w = W[f"{name}.weight"]
        return rnd(F.conv2d(rnd(h), rnd(w), None, padding=w.shape[-1] // 2))

    def bn(name, h):
        mean = h.mean(dim=(0, 2, 3))
        var = h.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
        inv = torch.rsqrt(var + kata_nbt.BN_EPS) * W[f"{name}.weight"]
        y = (h - mean[:, None, None]) * inv[:, None, None]
        return y + W[f"{name}.bias"][:, None, None]

    def nac(name, h):
        return conv(f"{name}.conv", act(bn(f"{name}.norm", h)))

    def pooled(name, h, value=False):
        return kata_nbt._pool(act(bn(name, h)), value)

    def block(h, i):
        b = f"blocks.{i}"
        r = nac(f"{b}.normactconvp", h)
        for j in range(cfg["inner_blocks"]):
            s = f"{b}.blockstack.{j}"
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                a = act(bn(f"{s}.norm1", r))
                g = pooled(f"{s}.normg", conv(f"{s}.conv1g", a))
                t = conv(f"{s}.conv1r", a) + F.linear(
                    g, W[f"{s}.linear_g.weight"])[:, :, None, None]
                r = rnd(r + conv(f"{s}.conv2", act(bn(f"{s}.norm2", t))))
            else:
                r = rnd(r + nac(f"{s}.normactconv2",
                                nac(f"{s}.normactconv1", r)))
        return rnd(h + nac(f"{b}.normactconvq", r))

    h = conv("conv_spatial", x.permute(0, 3, 1, 2).float())
    for i in range(cfg["num_blocks"]):
        h = (checkpoint(block, h, i, use_reentrant=False) if remat
             else block(h, i))
    h = act(bn("norm_trunkfinal", h))
    K = h.shape[0]
    g = pooled("policy_head.normg", conv("policy_head.conv1g", h))
    p = conv("policy_head.conv1p", h) + F.linear(
        g, W["policy_head.linear_g.weight"])[:, :, None, None]
    p = conv("policy_head.conv2p", act(bn("policy_head.norm2", p)))
    pass_ = F.linear(g, W["policy_head.linear_pass.weight"],
                     W["policy_head.linear_pass.bias"])
    log_pi = F.log_softmax(torch.cat([p.reshape(K, -1), pass_], 1), dim=-1)
    v = pooled("value_head.norm1", conv("value_head.conv1", h), value=True)
    v = act(F.linear(v, W["value_head.linear2.weight"],
                     W["value_head.linear2.bias"]))
    v = F.linear(v, W["value_head.linear3.weight"],
                 W["value_head.linear3.bias"])
    prob = torch.softmax(v, dim=-1)
    return log_pi, prob[:, 0] - prob[:, 1]


def sgd_steps(W0, batches, cfg, opts, conv_mode="fp32", half=False):
    """Follow `len(batches)` train steps from W0 in float32, with block
    remat: the loss, its gradients, then L2 decay added to the gradient, a
    momentum trace and the step (t = momentum * t + g + wd * p; p -= lr *
    t).  Each batch is (features, pi_target, winner).  `half` takes the
    first half of every batch alone (a planted fault).  Returns (losses,
    the first step's gradient as the optimizer takes it and without the
    decay, per parameter, and the parameters after the last step)."""
    W = {k: v.clone().requires_grad_(resnet_pv.is_param(k))
         for k, v in W0.items()}
    names = [k for k in W if resnet_pv.is_param(k)]
    trace = {k: torch.zeros_like(W[k]) for k in names}
    losses, first, first_raw = [], None, None
    for feats, pi, z in batches:
        if half:
            h = feats.shape[0] // 2
            feats, pi, z = feats[:h], pi[:h], z[:h]
        log_pi, v = forward(W, feats, cfg, conv_mode=conv_mode, remat=True)
        loss = resnet_pv.az_loss(log_pi, v, pi, z, opts["value_loss_weight"])
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
