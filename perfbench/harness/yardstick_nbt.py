"""The yardstick of the nested-bottleneck net (`go19_b18c384nbt`): its
forward's FLOPs and its epilogues' bytes, counted from the configuration's
shapes.  Kept with the benchmark, so that a change to the program cannot
move it.  The card's peaks are `yardstick.py`'s.
"""

from __future__ import annotations

FLOAT = 4


def counts(cfg: dict) -> bool:
    """Whether the configuration is a nested-bottleneck net this file
    counts."""
    return "trunk_channels" in cfg


def _convs(cfg: dict) -> list:
    """(k, cin, cout) of every convolution of one forward."""
    C, M, G = cfg["trunk_channels"], cfg["mid_channels"], cfg["gpool_channels"]
    out = [(cfg["input_kernel"], cfg["num_planes"], C)]
    for i in range(cfg["num_blocks"]):
        out.append((1, C, M))
        for j in range(cfg["inner_blocks"]):
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                out += [(3, M, M - G), (3, M, G), (3, M - G, M)]
            else:
                out += [(3, M, M), (3, M, M)]
        out.append((1, M, C))
    p1, g1, v1 = cfg["p1_channels"], cfg["g1_channels"], cfg["v1_channels"]
    return out + [(1, C, p1), (1, C, g1), (1, p1, 1), (1, C, v1)]


def _denses(cfg: dict) -> list:
    """(fan_in, fan_out) of every dense layer of one forward."""
    M, G = cfg["mid_channels"], cfg["gpool_channels"]
    pooled = sum(1 for i in range(cfg["num_blocks"])
                 if i + 1 in cfg["gpool_blocks"])
    g1, v1 = cfg["g1_channels"], cfg["v1_channels"]
    return ([(3 * G, M - G)] * pooled
            + [(3 * g1, cfg["p1_channels"]), (3 * g1, 1),
               (3 * v1, cfg["v2_size"]), (cfg["v2_size"], 3)])


def forward_flops(cfg: dict, rows: int) -> int:
    """FLOPs (2 x multiply-adds) of the forward at `rows` positions: every
    convolution and dense layer.  Norms, activations, residual adds,
    pooling and the softmaxes are left out (elementwise)."""
    A = cfg["board_size"] ** 2
    f = sum(A * k * k * cin * cout for k, cin, cout in _convs(cfg))
    f += sum(i * o for i, o in _denses(cfg))
    return 2 * f * rows


def epilogues(cfg: dict) -> list:
    """(mode, channels) of every epilogue of one forward, in launch order:
    "normact" (norm and activation), "skip" (the residual add before
    them, writing the sum too), "row" (a per-row bias before them), "pool"
    (the board's pooling after them)."""
    C, M, G = cfg["trunk_channels"], cfg["mid_channels"], cfg["gpool_channels"]
    out = [("normact", C)]
    for i in range(cfg["num_blocks"]):
        out.append(("normact", M))
        for j in range(cfg["inner_blocks"]):
            if j == 0 and i + 1 in cfg["gpool_blocks"]:
                out += [("pool", G), ("row", M - G), ("skip", M)]
            else:
                out += [("normact", M), ("skip", M)]
        out.append(("skip", C))
    return out + [("pool", cfg["g1_channels"]), ("row", cfg["p1_channels"]),
                  ("pool", cfg["v1_channels"])]


def epilogue_bytes(cfg: dict, rows: int, forwards: int) -> int:
    """Bytes the epilogues of `forwards` forwards over `rows` positions in
    all must move: each input read once and each output written once, per
    launch.  An activation element is `conv_dtype`'s size; the row bias
    and the pooled output fp32; the norm's mean, multiplier and bias fp32
    per channel, per launch."""
    e = 2 if cfg["conv_dtype"] == "bfloat16" else 4
    A = cfg["board_size"] ** 2
    per_row = {"normact": lambda c: 2 * e * A * c,
               "skip": lambda c: 4 * e * A * c,
               "row": lambda c: 2 * e * A * c + FLOAT * c,
               "pool": lambda c: e * A * c + 3 * FLOAT * c}
    eps = epilogues(cfg)
    return (rows * sum(per_row[m](c) for m, c in eps)
            + forwards * sum(3 * FLOAT * c for _, c in eps))
