"""The benchmark's yardstick: the card's peaks, the work of the net and of
the engine's kernel counted from their shapes, and the union of device
intervals.  Kept with the benchmark, so that a change to the program
cannot move it.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12      # HBM3


def resnet_forward_flops(cfg: dict, rows: int) -> int:
    """FLOPs (2 x multiply-adds) of one forward of the policy-value ResNet
    at `rows` positions: the 3x3 trunk (input conv and 2 per block), the
    1x1 head convolutions and the heads' dense layers.  BN, ReLU, the
    residual adds, the softmax and the tanh are left out (elementwise)."""
    n2 = cfg["board_size"] ** 2
    C, P = cfg["dim"], cfg["num_planes"]
    pp, vp, vh = cfg["policy_planes"], cfg["value_planes"], cfg["value_hidden"]
    f = n2 * 9 * P * C                          # input conv
    f += 2 * cfg["num_block"] * n2 * 9 * C * C  # residual tower
    f += n2 * C * pp + pp * n2 * (n2 + 1)       # policy head
    f += n2 * C * vp + vp * n2 * vh + vh        # value head
    return 2 * f * rows


def train_step_flops(cfg: dict, rows: int) -> int:
    """A train step's FLOPs: forward + backward = 3 x the forward.  Block
    remat's recomputed forward is overhead, not counted."""
    return 3 * resnet_forward_flops(cfg, rows)


def step_analysis_bytes(boards: int, size: int) -> int:
    """Bytes `step_analysis` has to move at B boards: it reads each board
    (int8 per point), the action and the colour (int32 each), and writes
    the board after captures (int8), lib_min and lib_max (int32) and the
    capture mask (bool) per point."""
    n2 = size * size
    return boards * ((n2 + 4 + 4) + n2 * (1 + 4 + 4 + 1))


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merge(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
