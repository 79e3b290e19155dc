"""Plain float32 forward of KataGo's nested-bottleneck net (`b18c384nbt`;
KataGo's `python/katago/train/modelconfigs.py`, `docs/KataGoMethods.md`;
global pooling: Wu, arXiv:1902.10565, section 3 and appendix), the
reference `models/nbt.py` is held against.  Imports torch alone; no
kernels, no cache, no batching; `forward` sets TF32 off.

  trunk   conv_spatial (input_kernel x input_kernel, no bias) to the raw
          trunk stream x; `num_blocks` nested blocks
            x + NAC_q(inner blocks(NAC_p(x))), NAC(h) = conv(act(norm(h))),
          NAC_p 1x1 trunk -> mid, NAC_q 1x1 mid -> trunk, each inner block
          r + NAC(3x3)(NAC(3x3)(r)); in the blocks of `gpool_blocks`
          (1-based) the first inner block is the global-pooling block
            a = act(norm1(r)); t = conv1r(a); g = act(normg(conv1g(a)))
            t = t + linear_g(pool(g)); r + conv2(act(norm2(t)))
          then act(norm_trunkfinal(x))
  policy  P = conv1p(h), G = conv1g(h); g = pool(act(normg(G)));
          logits = conv2p(act(norm2(P + linear_g(g)))) at the N*N points,
          linear_pass(g) for the pass; log-softmax over N*N + 1
  value   v = valuepool(act(norm1(conv1(h)))); linear3(act(linear2(v)))
          = (win, loss, no result) logits; value = P(win) - P(loss)
  pool      [mean, mean (sqrt(A) - 14) / 10, max] over the A = N*N points
  valuepool [mean, mean (sqrt(A) - 14) / 10, mean ((sqrt(A) - 14)^2 / 100
            - 0.1)]
  act     mish (torch's F.mish) or relu; norm (x - mean) * (rsqrt(var +
          eps) * weight) + bias with the running statistics, eps 1e-5, or
          in the training forward (`forward(..., stats={})`) with the
          batch's mean and biased variance over (K, N, N), which it
          writes into `stats` by the norm's name; the learner moves the
          running statistics by them

Departures from KataGo, each as the configuration states it: the input is
the port's 18 AlphaGo Zero planes (no global input features, no ladder,
liberty or history-of-moves planes of KataGo's own), so no global input
vector is added to the trunk; the norms are plain batch norms with a
scale (KataGo's "fixscaleonenorm" and its masks are not modelled: every
point is on the board); the board is always full size, so the pooling's
area is N*N and its max needs no mask; the heads are cut to the policy
over N*N + 1 moves (no opponent policy, no second pass layer) and the
win/loss/no-result value (no ownership, score mean or belief, no
auxiliary value targets); head widths p1, g1, v1 and v2 as the
configuration assumes them.

Weights are a dict keyed by the net's state-dict names (`weight_shapes`),
`cfg` a dict with `models.nbt.NbtConfig`'s fields.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def exact_fp32() -> None:
    """Float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weight_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the net.  kind: "conv" and
    "dense" weights, "bias", "bn_w", "bn_b", "bn_mean", "bn_var"."""
    C, M, G = cfg["trunk_channels"], cfg["mid_channels"], cfg["gpool_channels"]
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c):
        for field, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                            ("running_mean", "bn_mean"),
                            ("running_var", "bn_var")):
            out.append((f"{name}.{field}", (c,), kind))

    def dense(name, cin, cout, bias=True):
        out.append((f"{name}.weight", (cout, cin), "dense"))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias"))

    def nac(name, cin, cout, k):
        bn(f"{name}.norm", cin)
        conv(f"{name}.conv", cin, cout, k)

    k0 = cfg["input_kernel"]
    conv("conv_spatial", cfg["num_planes"], C, k0)
    for i in range(cfg["num_blocks"]):
        b = f"blocks.{i}"
        nac(f"{b}.normactconvp", C, M, 1)
        for j in range(cfg["inner_blocks"]):
            s = f"{b}.blockstack.{j}"
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                bn(f"{s}.norm1", M)
                conv(f"{s}.conv1r", M, M - G, 3)
                conv(f"{s}.conv1g", M, G, 3)
                bn(f"{s}.normg", G)
                dense(f"{s}.linear_g", 3 * G, M - G, bias=False)
                bn(f"{s}.norm2", M - G)
                conv(f"{s}.conv2", M - G, M, 3)
            else:
                nac(f"{s}.normactconv1", M, M, 3)
                nac(f"{s}.normactconv2", M, M, 3)
        nac(f"{b}.normactconvq", M, C, 1)
    bn("norm_trunkfinal", C)
    p1, g1 = cfg["p1_channels"], cfg["g1_channels"]
    conv("policy_head.conv1p", C, p1, 1)
    conv("policy_head.conv1g", C, g1, 1)
    bn("policy_head.normg", g1)
    dense("policy_head.linear_g", 3 * g1, p1, bias=False)
    bn("policy_head.norm2", p1)
    conv("policy_head.conv2p", p1, 1, 1)
    dense("policy_head.linear_pass", 3 * g1, 1)
    v1 = cfg["v1_channels"]
    conv("value_head.conv1", C, v1, 1)
    bn("value_head.norm1", v1)
    dense("value_head.linear2", 3 * v1, cfg["v2_size"])
    dense("value_head.linear3", cfg["v2_size"], 3)
    return out


def _act(cfg: dict):
    return F.mish if cfg["activation"] == "mish" else F.relu


def _conv(W, name, x):
    w = W[f"{name}.weight"]
    return F.conv2d(x, w, None, padding=w.shape[-1] // 2)


def _bn(W, name, x, stats=None):
    if stats is None:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        stats[name] = (mean.detach(), var.detach())
    inv = torch.rsqrt(var + BN_EPS) * W[f"{name}.weight"]
    b = W[f"{name}.bias"]
    return (x - mean[:, None, None]) * inv[:, None, None] + b[:, None, None]


def _pool(g, value: bool):
    area = g.shape[2] * g.shape[3]
    root = math.sqrt(area) - 14.0
    mean = g.mean(dim=(2, 3))
    third = mean * (root * root / 100.0 - 0.1) if value else g.amax(dim=(2, 3))
    return torch.cat([mean, mean * (root / 10.0), third], 1)


def forward(W: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            stats=None):
    """x: f32 [K, N, N, planes] -> (log_pi [K, N*N + 1], value [K]).  With
    `stats` (a dict) the training forward: the batch statistics."""
    exact_fp32()
    act = _act(cfg)

    def bn(name, h):
        return _bn(W, name, h, stats)

    def nac(name, h):
        return _conv(W, f"{name}.conv", act(bn(f"{name}.norm", h)))

    h = _conv(W, "conv_spatial", x.permute(0, 3, 1, 2).float())
    for i in range(cfg["num_blocks"]):
        b = f"blocks.{i}"
        r = nac(f"{b}.normactconvp", h)
        for j in range(cfg["inner_blocks"]):
            s = f"{b}.blockstack.{j}"
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                a = act(bn(f"{s}.norm1", r))
                g = _conv(W, f"{s}.conv1g", a)
                g = _pool(act(bn(f"{s}.normg", g)), False)
                t = _conv(W, f"{s}.conv1r", a) + F.linear(
                    g, W[f"{s}.linear_g.weight"])[:, :, None, None]
                r = r + _conv(W, f"{s}.conv2", act(bn(f"{s}.norm2", t)))
            else:
                r = r + nac(f"{s}.normactconv2", nac(f"{s}.normactconv1", r))
        h = h + nac(f"{b}.normactconvq", r)
    h = act(bn("norm_trunkfinal", h))
    K = h.shape[0]
    g = _pool(act(bn("policy_head.normg",
                      _conv(W, "policy_head.conv1g", h))), False)
    p = _conv(W, "policy_head.conv1p", h) + F.linear(
        g, W["policy_head.linear_g.weight"])[:, :, None, None]
    p = _conv(W, "policy_head.conv2p", act(bn("policy_head.norm2", p)))
    pass_ = F.linear(g, W["policy_head.linear_pass.weight"],
                     W["policy_head.linear_pass.bias"])
    log_pi = F.log_softmax(torch.cat([p.reshape(K, -1), pass_], 1), dim=-1)
    v = _pool(act(bn("value_head.norm1",
                      _conv(W, "value_head.conv1", h))), True)
    v = act(F.linear(v, W["value_head.linear2.weight"],
                     W["value_head.linear2.bias"]))
    v = F.linear(v, W["value_head.linear3.weight"],
                 W["value_head.linear3.bias"])
    prob = torch.softmax(v, dim=-1)
    return log_pi, prob[:, 0] - prob[:, 1]
