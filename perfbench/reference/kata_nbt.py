"""KataGo's nested-bottleneck net (`b18c384nbt`; KataGo's
`python/katago/train/modelconfigs.py` and `docs/KataGoMethods.md`; global
pooling: Wu, arXiv:1902.10565, section 3 and appendix), in float32: the
benchmark's reference for the configuration `go19_b18c384nbt`.

  trunk   conv_spatial (5x5, no bias) to the raw trunk stream x, then
          `num_blocks` nested blocks x + NAC_q(inner blocks(NAC_p(x))),
          NAC(h) = conv(act(norm(h))), NAC_p 1x1 trunk -> mid, NAC_q 1x1
          mid -> trunk, each inner block r + NAC(3x3)(NAC(3x3)(r)); in the
          blocks of `gpool_blocks` (1-based) the first inner block pools:
            a = act(norm1(r)); t = conv1r(a); g = act(normg(conv1g(a)))
            t = t + linear_g(pool(g)); r + conv2(act(norm2(t)))
          then act(norm_trunkfinal(x))
  policy  P = conv1p(h), G = conv1g(h); g = pool(act(normg(G)));
          logits = conv2p(act(norm2(P + linear_g(g)))), the pass logit
          linear_pass(g); log-softmax over N*N + 1
  value   linear3(act(linear2(valuepool(act(norm1(conv1(h))))))) = (win,
          loss, no result) logits; value = P(win) - P(loss)
  pool      [mean, mean (sqrt(A) - 14) / 10, max] over the A = N*N points;
  valuepool [mean, mean (sqrt(A) - 14) / 10, mean ((sqrt(A) - 14)^2 / 100
            - 0.1)]; act mish; norm the affine batch norm, eps 1e-5, by
          the running statistics to evaluate, by the batch's (biased
          variance) in `forward(train=True)`, which `weights.calibrate` uses

Departures from KataGo, as the configuration lists them: the port's 18
AlphaGo Zero planes in place of KataGo's inputs (no global input vector),
plain batch norms with a scale and no masks (the board is full size),
heads cut to the policy and win/loss/no-result value, the head widths
assumed.  The same arithmetic in float32 as the program's own reference
(`elf_tpu_torch/models/nbt_reference.py`), which this file does not
import.

`conv_mode` selects the precision of the convolution path: its inputs,
weights and outputs and the trunk and inner residual streams (the norms,
the activations' fp32 values before the cast, the pooling and the dense
layers stay float32).  "fp32" is the reference (TF32 must be off,
`exact_fp32`); "bf16" rounds that path to bfloat16, as the configuration
states it; "fp8", the control, rounds it to float8 e4m3 with one scale per
tensor.  Imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
E4M3_MAX = 448.0


def exact_fp32() -> None:
    """Float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weight_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the net, in the program's
    state-dict names.  kind: "conv" and "dense" weights (fan-in scaled),
    "bias", "bn_w", "bn_b", "bn_mean", "bn_var"."""
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

    conv("conv_spatial", cfg["num_planes"], C, cfg["input_kernel"])
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


def _round8(x):
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round(x, mode):
    """x as the convolution path holds it in `mode`."""
    if mode == "fp8":
        return _round8(x)
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    return x


def _pool(g, value: bool):
    area = g.shape[2] * g.shape[3]
    root = math.sqrt(area) - 14.0
    mean = g.mean(dim=(2, 3))
    third = mean * (root * root / 100.0 - 0.1) if value else g.amax(dim=(2, 3))
    return torch.cat([mean, mean * (root / 10.0), third], 1)


def forward(W: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            train: bool = False, conv_mode: str = "fp32", stats=None):
    """x: f32 [K, N, N, planes] -> (log_pi [K, N*N + 1], value [K]).
    `train` normalises by the batch, writing each norm's batch moments
    into `stats` where given."""
    act = F.mish if cfg["activation"] == "mish" else F.relu
    rnd = lambda t: _round(t, conv_mode)  # noqa: E731

    def conv(name, h):
        w = W[f"{name}.weight"]
        return rnd(F.conv2d(rnd(h), rnd(w), None, padding=w.shape[-1] // 2))

    def bn(name, h):
        w, b = W[f"{name}.weight"], W[f"{name}.bias"]
        if train:
            mean = h.mean(dim=(0, 2, 3))
            var = h.var(dim=(0, 2, 3), unbiased=False)
            if stats is not None:
                stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
        inv = torch.rsqrt(var + BN_EPS) * w
        y = (h - mean[:, None, None]) * inv[:, None, None]
        return y + b[:, None, None]

    def nac(name, h):
        return conv(f"{name}.conv", act(bn(f"{name}.norm", h)))

    h = conv("conv_spatial", x.permute(0, 3, 1, 2).float())
    for i in range(cfg["num_blocks"]):
        b = f"blocks.{i}"
        r = nac(f"{b}.normactconvp", h)
        for j in range(cfg["inner_blocks"]):
            s = f"{b}.blockstack.{j}"
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                a = act(bn(f"{s}.norm1", r))
                g = _pool(act(bn(f"{s}.normg", conv(f"{s}.conv1g", a))), False)
                t = conv(f"{s}.conv1r", a) + F.linear(
                    g, W[f"{s}.linear_g.weight"])[:, :, None, None]
                r = rnd(r + conv(f"{s}.conv2", act(bn(f"{s}.norm2", t))))
            else:
                r = rnd(r + nac(f"{s}.normactconv2",
                                nac(f"{s}.normactconv1", r)))
        h = rnd(h + nac(f"{b}.normactconvq", r))
    h = act(bn("norm_trunkfinal", h))
    K = h.shape[0]
    g = _pool(act(bn("policy_head.normg", conv("policy_head.conv1g", h))),
              False)
    p = conv("policy_head.conv1p", h) + F.linear(
        g, W["policy_head.linear_g.weight"])[:, :, None, None]
    p = conv("policy_head.conv2p", act(bn("policy_head.norm2", p)))
    pass_ = F.linear(g, W["policy_head.linear_pass.weight"],
                     W["policy_head.linear_pass.bias"])
    log_pi = F.log_softmax(torch.cat([p.reshape(K, -1), pass_], 1), dim=-1)
    v = _pool(act(bn("value_head.norm1", conv("value_head.conv1", h))), True)
    v = act(F.linear(v, W["value_head.linear2.weight"],
                     W["value_head.linear2.bias"]))
    v = F.linear(v, W["value_head.linear3.weight"],
                 W["value_head.linear3.bias"])
    prob = torch.softmax(v, dim=-1)
    return log_pi, prob[:, 0] - prob[:, 1]


def evaluate(W, x, cfg, conv_mode="fp32", rows=256):
    """The evaluation forward in blocks of `rows`: (log_pi, value)."""
    outs = []
    with torch.no_grad():
        for s in range(0, x.shape[0], rows):
            outs.append(forward(W, x[s:s + rows], cfg, conv_mode=conv_mode))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
