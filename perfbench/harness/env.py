"""Traffic kind "env": the engine alone, lockstep, through the program's
`engine.step_core`, with no net and no search.  Every board draws a
uniform move among the legal ones (the step's own `legal_next`), steps,
and restarts from the empty board when its game ends (two passes or the
move cap).  The unit of work is a chunk of `chunk` steps of all boards,
ended by one fetch to the host; the work is board-steps.

Traffic parameters: boards, chunk, warm_chunks (set-up), trace_chunks (the
traced window), check_boards (boards copied at one step of every chunk,
that step drawn from the seed), max_checks (chunks checked at most).

The check, after the window: at every copied step, the reference engine's
step of the copied boards: the move legal in the position before it, the
next position (stones, player, ko, ply, passes) and the next player's
legal points equal to the program's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import core
from harness.gocheck import program_position
from harness.trace import WINDOW, Tracer
from reference import go


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_legal(legal: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One uniform draw per row among its legal actions (Gumbel argmax)."""
    u = torch.rand(legal.shape, generator=gen, device=legal.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(torch.where(legal, 0.0, -1e9)
                        - torch.log(-torch.log(u)), dim=1).to(torch.int32)


def run(ctx) -> core.Measured:
    from elf_tpu_torch.env.go import engine

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    size, B, chunk = cfg["board_size"], tr["boards"], tr["chunk"]
    rng = np.random.default_rng([ctx.seed, 3])
    gen = torch.Generator(device=dev).manual_seed(core.sub_seed(ctx.seed, 2))
    fresh = engine.init_core(B, size, dev)
    st = {"core": engine.init_core(B, size, dev),
          "legal": torch.ones((B, size * size + 1), dtype=torch.bool,
                              device=dev)}
    illegal = torch.zeros((B,), dtype=torch.bool, device=dev)
    checks = []
    rows = torch.as_tensor(np.sort(rng.choice(B, tr["check_boards"],
                                              replace=False)), device=dev)

    def run_chunk(at_step):
        core_, legal = st["core"], st["legal"]
        for i in range(chunk):
            a = draw_legal(legal, gen)
            with ctx.spans("step_core"):
                nxt, info = engine.step_core(core_, a, size)
            illegal.logical_or_(info.illegal)
            if i == at_step:
                checks.append((program_position(core_, rows), a[rows].clone(),
                               program_position(nxt, rows),
                               info.legal_next[rows].clone()))
            done = engine.is_terminal_core(nxt, size)
            core_ = engine.GoCore(*(
                torch.where(done.view((-1,) + (1,) * (x.dim() - 1)), f, x)
                for f, x in zip(fresh, nxt)))
            legal = info.legal_next | done[:, None]
        st["core"], st["legal"] = core_, legal
        core_.ply[:1].cpu()

    for _ in range(tr["warm_chunks"]):
        run_chunk(-1)
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    tracer = Tracer() if ctx.trace else None
    limit = tr["trace_chunks"] if ctx.trace else None
    units = 0
    if tracer:
        tracer.start()
    ends = []
    t0 = time.perf_counter()
    with ctx.spans(WINDOW):
        while time.perf_counter() - t0 < ctx.seconds and (
                limit is None or units < limit):
            at = int(rng.integers(chunk)) if len(checks) < tr["max_checks"] \
                else -1
            with ctx.spans("chunk"):
                run_chunk(at)
            units += 1
            ends.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t0
    summary = tracer.stop() if tracer else None
    return core.Measured(
        setup_s=setup_s, window_s=window_s, units=units,
        work={"steps": units * chunk * B}, counters={"boards": B},
        attempted=units * chunk * B,
        payload={"checks": checks, "illegal": illegal}, trace=summary,
        unit_ends=ends)


def check(ctx, m: core.Measured) -> dict:
    size = ctx.config["board_size"]
    checks = m.payload["checks"]
    drew_illegal = int(m.payload["illegal"].sum())
    if not checks:
        return {"engine_mismatches": None, "_failed": drew_illegal}
    cat = lambda i: {k: torch.cat([c[i][k] for c in checks])
                     for k in checks[0][i]}
    before, after = cat(0), cat(2)
    a = torch.cat([c[1] for c in checks])
    legal_next = torch.cat([c[3] for c in checks])

    def mismatches(ko_rule):
        nxt, legal = go.step(before, a, size, ko_rule=ko_rule)
        same = go.same_position(nxt, after) & legal
        same &= (go.legal_mask(nxt, size) == legal_next).all(1)
        return int((~same).sum())

    bad = mismatches(True) + drew_illegal
    numbers = {"engine_mismatches": bad, "_failed": bad}
    if ctx.control:
        # the control: an engine that never makes a ko, in the program's
        # place
        numbers["control.engine_mismatches"] = mismatches(False)
    return numbers
