"""The yardstick of the nested-bottleneck net's learner step
(`go19_b18c384nbt_learner`): its FLOPs, and the bytes its norm,
activation, pooling and residual passes must move, counted from the
configuration's shapes.  Kept with the benchmark, so that a change to the program cannot
move it.  The card's peaks are `yardstick.py`'s.

The layers are the forward's norms as `yardstick_nbt.epilogues` lists
them, each with what surrounds it: "normact" (norm and activation),
"skip" (the residual add before them, whose sum is kept), "row" (a
per-row bias before them), "pool" (the board's pooling after them, no
activation kept).  Each pass reads each input and writes each output once,
in units of an activation element at `conv_dtype`'s size:

    mode     statistics  apply  backward reduce  backward apply  remat
    normact  1           2      2 (x, dy)        3 (x, dy; dx)   2
    skip     2           4      2 (s, dy)        3 (s, dy; ds)   4
    row      1           2      2                3               2
    pool     1           1      1                2               1

The backward reduce forms the statistics' gradients, the backward apply
the input's.  Remat's recompute re-runs each nested block's apply passes
(its statistics kept from the first pass): the norm of the block's input
(a "normact" of the trunk's width, its sum being stored) and the block's
own layers; the heads and the trunk's last norm are not recomputed.  Left
out, so that this is a floor: the per-channel statistics and constants,
the pooled values and row biases (under 2 % of a pooled layer), and the
sums of gradients that reach one tensor from several consumers.
"""

from __future__ import annotations

from harness import yardstick_nbt

# (statistics + apply, backward reduce + backward apply, remat) a mode
PASSES = {"normact": (3, 5, 2), "skip": (6, 5, 4), "row": (3, 5, 2),
          "pool": (2, 3, 1)}


def train_step_flops(cfg: dict, rows: int) -> int:
    """A train step's FLOPs: forward + backward = 3 x the forward
    (`yardstick_nbt.forward_flops`).  Remat's recomputed forward is
    overhead, not counted."""
    return 3 * yardstick_nbt.forward_flops(cfg, rows)


def _block(cfg: dict, i: int) -> list:
    """(mode, channels) of block i's own layers, as `epilogues` lists
    them: its first inner norm, then each inner block's."""
    M, G = cfg["mid_channels"], cfg["gpool_channels"]
    out = [("normact", M)]
    for j in range(cfg["inner_blocks"]):
        if j == 0 and i + 1 in cfg["gpool_blocks"]:
            out += [("pool", G), ("row", M - G), ("skip", M)]
        else:
            out += [("normact", M), ("skip", M)]
    return out


def normact_bytes(cfg: dict, rows: int, remat: bool) -> int:
    """Bytes the norm, activation, pooling and residual passes of one
    train step over `rows` positions must move (see the module)."""
    e = 2 if cfg["conv_dtype"] == "bfloat16" else 4
    A = cfg["board_size"] ** 2
    units = sum((PASSES[m][0] + PASSES[m][1]) * c
                for m, c in yardstick_nbt.epilogues(cfg))
    if remat:
        for i in range(cfg["num_blocks"]):
            units += PASSES["normact"][2] * cfg["trunk_channels"]
            units += sum(PASSES[m][2] * c for m, c in _block(cfg, i))
    return rows * e * A * units
