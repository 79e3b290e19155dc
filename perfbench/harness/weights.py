"""Weights drawn on the device from the run's seed, in a few large calls.

Kernels and dense layers: a normal draw clipped to two standard
deviations, scaled by 1 / sqrt(fan_in); biases N(0, 0.05^2); BN scales
1 + N(0, 0.1^2) and shifts N(0, 0.1^2).  The BN running statistics are
then those of a batch of random positions (`calibrate`), as a trained
net's match its activations, so that the evaluation's BN normalises.  The
dict is keyed by the configuration's state-dict names (the reference's
`weight_shapes`), and is the benchmark's own: the program receives a copy
through its state-dict interface.
"""

from __future__ import annotations

import math

import torch


def draw(shapes, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    mats = [(n, s) for n, s, k in shapes if k in ("conv", "dense")]
    vecs = [(n, s, k) for n, s, k in shapes if k not in ("conv", "dense")]
    total = sum(math.prod(s) for _, s in mats)
    z = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    nv = sum(math.prod(s) for _, s, _ in vecs)
    zv = torch.randn(nv, generator=g, device=device)
    uv = torch.rand(nv, generator=g, device=device)
    out, at = {}, 0
    for n, s in mats:
        k = math.prod(s)
        fan_in = k // s[0]
        out[n] = (z[at:at + k] / math.sqrt(fan_in)).view(s)
        at += k
    at = 0
    for n, s, kind in vecs:
        k = math.prod(s)
        a, u = zv[at:at + k].view(s), uv[at:at + k].view(s)
        out[n] = {"bias": 0.05 * a, "bn_w": 1.0 + 0.1 * a, "bn_b": 0.1 * a,
                  "bn_mean": 0.1 * a, "bn_var": 0.5 + u}[kind]
        at += k
    return out


def calibrate(W: dict, cfg: dict, ref, seed: int, device, rows=256) -> dict:
    """Set every BN's running statistics to its batch moments over `rows`
    random positions (stones at random, a third of the points, in every
    history plane; either side to move), computed by the reference."""
    from reference import agz

    g = torch.Generator(device=device).manual_seed(seed)
    n2 = cfg["board_size"] ** 2
    u = torch.rand((rows, 8, n2), generator=g, device=device)
    hist = torch.where(u < 1 / 6, 1, torch.where(u < 1 / 3, 2, 0)).to(
        torch.int8)
    valid = torch.ones((rows, 8), dtype=torch.bool, device=device)
    to_play = (torch.rand(rows, generator=g, device=device) < 0.5) + 1
    codes = torch.zeros(rows, dtype=torch.long, device=device)
    x = agz.planes(hist, valid, to_play, codes, cfg["board_size"])
    stats = {}
    with torch.no_grad():
        ref.forward(W, x, cfg, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        W[f"{name}.running_mean"] = mean
        W[f"{name}.running_var"] = var
    return W


def make(cfg: dict, ref, seed: int, device) -> dict:
    """The cell's weights: drawn, then calibrated."""
    W = draw(ref.weight_shapes(cfg), seed, device)
    return calibrate(W, cfg, ref, seed + 1, device)
