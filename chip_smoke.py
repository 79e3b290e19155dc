#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`elf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from `elf_tpu_torch/csrc/` with nvcc;
  3. kernels: both designs of each kernel (the union-find kernels the
     engine launches and the first port's round-based ones, kept as the
     yardstick) against the plain PyTorch version on the card (19x19 and
     9x9, B in {1, 5, 32, 130, 4096}, random boards, the serpentine chain,
     actions with passes, negatives and occupied points), exact; then at
     the timed 19x19 shapes (mid-game boards at B = 32, 1024 and 4096,
     serpentine chains at B = 1024) checked again and timed in turns
     (rounds, union-find, union-find, rounds): device time per launch by
     CUDA-graph replay, the profiler's kernel time beside it, the host
     cost of one wrapper call, the plain version's time and the byte
     bound;
  4. slice: the 19x19 20-block 256-channel net with the committed weights
     (runs/prove19/export-best.bin) drives SelfplayActor (B = 32, 64
     rollouts, 8 per batch, Dirichlet noise) for 6 moves, with the launch
     counts set to 0 just before; both kernels must have launched, and
     every move is replayed on the host (plain versions, not the kernels)
     to check it legal and the boards equal;
  5. records: 9x9 games with a seeded small net until move_cutoff = 20;
     every Record survives a JSON round trip and replays on the host to
     the boards the actor played;
  6. profile: one more slice move under torch.profiler, device time by
     kernel group, with its own launch counts.

Prints the card's nvidia-smi line, one JSON line describing the kernels,
and last `{"ok": true, "device": {...}}`.  Exits non-zero, before printing
any result, when CUDA is unavailable or the port is not beside this file.
A copy of the numbers goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SLICE_B, SLICE_ROLLOUTS, SLICE_PER_BATCH, SLICE_MOVES = 32, 64, 8, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def snake(size: int) -> np.ndarray:
    b = np.zeros((size, size), np.int8)
    for r in range(size):
        b[r, :] = 1
    for r in range(0, size - 1, 2):
        b[r + 1, :] = 0
        b[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return b


def test_boards(B: int, size: int, rng) -> np.ndarray:
    """Random boards at three densities, the empty board and the serpentine
    chain (in both colours)."""
    s = np.zeros((B, size, size), np.int8)
    for i in range(B):
        kind = i % 5
        if kind < 3:
            p_empty = (0.2, 0.5, 0.8)[kind]
            p = [p_empty, (1 - p_empty) / 2, (1 - p_empty) / 2]
            s[i] = rng.choice(3, size=(size, size), p=p)
        elif kind == 4:
            s[i] = snake(size) * (1 + (i // 5) % 2)
    return s


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of `fn` between CUDA events around `reps` calls, host
    syncs included (used for the plain versions, which sync on the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time of one launch of `fn`: `reps` launches captured into a
    CUDA graph, the graph replayed between two events; the median of
    `replays` replays, over `reps`.  The host enqueues one replay, so its
    cost per launch stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def host_ms(fn, calls: int) -> float:
    """Host cost of one wrapper call: a host clock over `calls` calls with
    no synchronisation inside (fewer calls than the launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def profiler_ms(fn, symbol: str, calls: int):
    """Mean device time of the kernel `symbol` under torch.profiler over
    `calls` launches of `fn` (None when the trace holds no such kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    name = re.compile(rf"\b{symbol}[<(]")       # plain or templated kernel
    for e in prof.key_averages():
        if name.search(e.key):
            total_us += getattr(e, "device_time_total", None) or \
                e.cuda_time_total
            count += e.count
    return total_us / count / 1e3 if count else None


def played_boards(B: int, size: int, plies: int, seed: int):
    """Boards after `plies` uniformly random legal moves (port's engine)."""
    from elf_tpu_torch.env.go import engine

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    core = engine.init_core(B, size, dev)
    legal = torch.ones((B, size * size + 1), dtype=torch.bool, device=dev)
    for _ in range(plies):
        w = legal.float()
        w[:, -1] = 1e-3                    # rarely pass
        a = torch.multinomial(w, 1, generator=g)[:, 0].to(torch.int32)
        core, info = engine.step_core(core, a, size)
        legal = info.legal_next
    return core


def designs():
    """Both designs' wrappers and CUDA symbols: the union-find kernels the
    engine launches, and the first port's round-based kernels, kept as the
    yardstick they are timed against."""
    from elf_tpu_torch.env.go import kernels

    return {
        "union-find": {
            "analyze_libs": (kernels.analyze_libs_cuda, "analyze_libs_kernel"),
            "step_analysis": (kernels.step_analysis_cuda,
                              "step_analysis_kernel"),
        },
        "rounds": {
            "analyze_libs": (kernels.analyze_libs_rounds_cuda,
                             "analyze_libs_rounds_kernel"),
            "step_analysis": (kernels.step_analysis_rounds_cuda,
                              "step_analysis_rounds_kernel"),
        },
    }


def bytes_moved(name: str, B: int, n2: int) -> int:
    """Each input read once, each output written once."""
    if name == "analyze_libs":
        return B * n2 + 2 * B * n2 * 4
    return B * (n2 + 8) + B * n2 * (1 + 4 + 4 + 1)


# The timed shapes, all 19x19: (boards, B).
TIMED = (("mid-game", SLICE_B), ("mid-game", 1024), ("mid-game", 4096),
         ("serpentine", 1024))


def kernel_phase(rng) -> dict:
    from elf_tpu_torch.env.go import kernels

    dev = torch.device("cuda")
    worst = {"analyze_libs": 0, "step_analysis": 0}
    both = designs()
    plain_of = {"analyze_libs": kernels.analyze_libs_ref,
                "step_analysis": kernels.step_analysis_ref}

    def check(name, args, where):
        """Every design of `name` equal to the plain version on `args`."""
        plain = plain_of[name](*args)
        for design, calls in both.items():
            got = calls[name][0](*args)
            torch.cuda.synchronize()
            for g_, r_ in zip(got, plain):
                if g_.dtype != r_.dtype or not torch.equal(g_, r_):
                    fail(f"{name} ({design}) differs from the plain version "
                         f"{where}")
                worst[name] = max(worst[name],
                                  int((g_.int() - r_.int()).abs().max()))

    for size in (9, 19):
        n2 = size * size
        for B in (1, 5, SLICE_B, 130, 4096):
            s = torch.from_numpy(test_boards(B, size, rng)).to(dev)
            if B == 1:
                s[0] = torch.from_numpy(snake(size)).to(dev)
            check("analyze_libs", (s,), f"at size {size} B {B}")
            act = torch.from_numpy(
                rng.integers(-3, n2 + 3, size=B).astype(np.int32)).to(dev)
            col = torch.from_numpy(
                rng.integers(1, 3, size=B).astype(np.int32)).to(dev)
            check("step_analysis", (s.reshape(B, n2).contiguous(), act, col),
                  f"at size {size} B {B}")
            log(f"kernels: size {size} B {B}: both designs of both kernels "
                "equal to their plain versions")

    # the timed shapes: checked against the plain versions, then timed in
    # turns (rounds, union-find, union-find, rounds) on this one card
    size, n2 = 19, 361
    timings = {}
    for boards, B in TIMED:
        if boards == "mid-game":
            core = played_boards(B, size, 120, seed=B)
            flat = core.stones
            color = core.to_play.to(torch.int32)
        else:
            flat = torch.from_numpy(np.stack([
                snake(size).reshape(n2) * (1 + i % 2) for i in range(B)
            ]).astype(np.int8)).to(dev)
            color = torch.from_numpy(
                rng.integers(1, 3, size=B).astype(np.int32)).to(dev)
        s2d = flat.reshape(B, size, size).contiguous()
        act = torch.from_numpy(
            rng.integers(0, n2 + 1, size=B).astype(np.int32)).to(dev)
        args = {"analyze_libs": (s2d,), "step_analysis": (flat, act, color)}
        where = f"on {boards} 19x19 boards at B {B}"
        reps = 200 if B <= 1024 else 100
        for name in ("step_analysis", "analyze_libs"):
            a = args[name]
            check(name, a, where)
            ms = {"rounds": [], "union-find": []}
            for design in ("rounds", "union-find", "union-find", "rounds"):
                fn = both[design][name][0]
                ms[design].append(graph_ms(lambda: fn(*a), reps))
            plain = plain_of[name]
            nbytes = bytes_moved(name, B, n2)
            t = dict(boards=boards, B=B, bytes=nbytes,
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     plain_ms=cuda_time_ms(lambda: plain(*a), 3))
            for design, (fn, symbol) in ((d, both[d][name]) for d in both):
                t[design] = dict(
                    ms=float(np.mean(ms[design])), ms_turns=ms[design],
                    profiler_ms=profiler_ms(lambda: fn(*a), symbol, 50),
                    host_ms=host_ms(lambda: fn(*a), 200))
            timings[(name, boards, B)] = t
            for design in ("union-find", "rounds"):
                d = t[design]
                prof = ("not found" if d["profiler_ms"] is None
                        else f"{d['profiler_ms']:.6f} ms")
                log(f"kernels: {name} 19x19 {boards} B {B}, {design}: device "
                    f"{d['ms']:.6f} ms/launch (graph replay; turns "
                    f"{', '.join(f'{x:.6f}' for x in d['ms_turns'])}), "
                    f"profiler {prof}, host cost {d['host_ms']:.6f} ms/call, "
                    f"bound {t['bound_ms']:.6f} ms (bytes), plain "
                    f"{t['plain_ms']:.4f} ms")
    ratios = {}
    for name in ("step_analysis", "analyze_libs"):
        for design in ("union-find", "rounds"):
            r = (timings[(name, "serpentine", 1024)][design]["ms"]
                 / timings[(name, "mid-game", 1024)][design]["ms"])
            ratios[f"{name}/{design}"] = r
            log(f"kernels: {name}, {design}: serpentine / mid-game device "
                f"time at B 1024 = {r:.3f}")
    return {"worst": worst, "timings": timings, "serpentine_ratio": ratios}


# ---------------------------------------------------------------------------
# phase 4: the self-play slice at full width
# ---------------------------------------------------------------------------


def replay_is_legal(moves_per_board, size: int, handicap: int = 0):
    """Replay each board's moves through the port's GoState on the host,
    where the engine takes the plain versions of the kernels, so the check
    does not rest on the kernels under test; fails on an illegal move;
    returns the final stones [B, N2] on the card."""
    from elf_tpu_torch.env.go import state as gostate

    dev = torch.device("cpu")
    B = len(moves_per_board)
    st = gostate.init_state(B, size, dev)
    if handicap:
        st = gostate.apply_handicap(st, handicap, size)
    n2 = size * size
    for i in range(max((len(m) for m in moves_per_board), default=0)):
        a = torch.tensor([m[i] if i < len(m) else n2 for m in moves_per_board],
                         dtype=torch.int32, device=dev)
        live = torch.tensor([i < len(m) for m in moves_per_board], device=dev)
        st, info = gostate.step(st, a, size)
        if bool((info.illegal & live).any()):
            fail(f"illegal move replayed at ply {i}")
    return st.core.stones.cuda()


def slice_phase(card: str):
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, eval_fn_builder, load_model
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    cfg = ModelConfig()          # 19x19, 20 blocks, 256 channels, bf16
    net = load_model(str(ROOT / "runs/prove19/export-best.bin"), cfg, "cuda")
    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=SLICE_B, never_resign_prob=1.0),
        MCTSConfig(num_rollouts=SLICE_ROLLOUTS,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.25),
        eval_fn_builder, seed=0, device="cuda",
    )
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    move_s = []
    for _ in range(SLICE_MOVES):
        t0 = time.perf_counter()
        records = actor.play_moves(net, None, 1)
        torch.cuda.synchronize()
        move_s.append(time.perf_counter() - t0)
        if records:
            fail("a game ended within the first moves")
    launches = kernels.launch_counts()

    per_move = {"step_analysis": SLICE_ROLLOUTS + 1, "analyze_libs": 1}
    for name, n in per_move.items():
        if launches[name] <= 0:
            fail(f"{name} was not launched on the main path")
        if launches[name] != n * SLICE_MOVES:
            fail(f"{name}: {launches[name]} launches, expected "
                 f"{n * SLICE_MOVES}")
    stones = replay_is_legal(actor.moves, 19)
    if not torch.equal(stones, actor.state.core.stones):
        fail("replayed boards differ from the actor's boards")

    steady = move_s[1:]
    mps = len(steady) / sum(steady)
    out = dict(
        card=card, boards=SLICE_B, rollouts=SLICE_ROLLOUTS,
        rollouts_per_batch=SLICE_PER_BATCH, moves=SLICE_MOVES,
        first_move_s=move_s[0], steady_move_s=steady,
        moves_per_s=mps * SLICE_B,
        rollouts_per_s=mps * SLICE_B * SLICE_ROLLOUTS,
        leaf_evals_per_s=mps * SLICE_B * (SLICE_ROLLOUTS + 1),
        launches=launches,
    )
    log(f"slice: 19x19 20b256c B {SLICE_B}, {SLICE_ROLLOUTS} rollouts: "
        f"first move {move_s[0]:.3f} s, then {mps * SLICE_B:.2f} moves/s, "
        f"{out['rollouts_per_s']:.1f} rollouts/s, "
        f"{out['leaf_evals_per_s']:.1f} leaf-evals/s on {card}")
    log(f"slice: launches {launches} (expected {SLICE_ROLLOUTS + 1} "
        "step_analysis + 1 analyze_libs per move)")
    return out, net


_NN_KERNEL_WORDS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90",
                    "wgrad", "dgrad", "fprop")


def profile_phase(card: str, net) -> dict:
    """Where one slice move spends its time, after the other phases.

    torch.profiler over one move at the slice's shape after a warm-up
    move; device kernels are grouped as the two liberty kernels, the
    convolutions and matrix products of the net, and everything else.
    The launch counts are reset just before the profiled move and
    reported as this phase's own."""
    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=SLICE_B, never_resign_prob=1.0),
        MCTSConfig(num_rollouts=SLICE_ROLLOUTS,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.25),
        eval_fn_builder, seed=0, device="cuda",
    )
    actor.play_moves(net, None, 1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        actor.play_moves(net, None, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()

    groups = {"liberty kernels": 0.0, "net conv/gemm": 0.0, "other": 0.0}
    by_name, n_kernels, syncs = {}, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
            low = e.name.lower()
            if "analyze_libs_kernel" in low or "step_analysis_kernel" in low:
                groups["liberty kernels"] += us / 1e3
            elif any(w in low for w in _NN_KERNEL_WORDS):
                groups["net conv/gemm"] += us / 1e3
            else:
                groups["other"] += us / 1e3
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpyAsync"):
            syncs += 1
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(card=card, wall_ms=wall_ms, device_busy_ms=busy,
               device_busy_share=busy / wall_ms, groups_ms=groups,
               device_kernels=n_kernels, host_copies_and_syncs=syncs,
               top_kernels_ms=top, launches=launches)
    log(f"profile: one move at 19x19 B {SLICE_B}, {SLICE_ROLLOUTS} rollouts: "
        f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {n_kernels} kernels, {syncs} "
        f"host copies/syncs, liberty-kernel launches {launches}, on {card}")
    for k, v in groups.items():
        log(f"profile:   {k}: {v:.2f} ms")
    for k, v in top:
        log(f"profile:   top {v:8.3f} ms  {k[:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 5: record emission
# ---------------------------------------------------------------------------


def record_phase() -> dict:
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import ModelConfig, build_model, eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
    from elf_tpu_torch.selfplay.records import Record

    size, B, cutoff = 9, 8, 20
    net = build_model(ModelConfig(board_size=size, num_block=2, dim=32),
                      "cuda", seed=1)
    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=B, never_resign_prob=1.0,
                    move_cutoff=cutoff),
        MCTSConfig(num_rollouts=16, rollouts_per_batch=4, root_epsilon=0.25,
                   root_alpha=0.3),
        eval_fn_builder, seed=2, device="cuda",
    )
    records = []
    for _ in range(cutoff):
        before = actor.state.core.stones.clone()
        new = actor.play_moves(net, None, 1)
        for r in new:
            d = json.loads(json.dumps(r.to_json()))
            if Record.from_json(d).to_json() != r.to_json():
                fail("a Record changed in its JSON round trip")
            moves = sgf_string_to_moves(r.result.content, size)
            if len(moves) != r.result.num_move or len(r.result.values) != len(moves):
                fail("a Record's move, value and move-count fields disagree")
            prefix = replay_is_legal([moves[:-1]], size)
            replay_is_legal([moves], size)
            if not torch.equal(prefix[0], before[r.thread_id]):
                fail("a Record does not replay to the board the actor played")
        records.extend(new)
    if len(records) < B:
        fail(f"only {len(records)} of {B} games emitted records")
    log(f"records: {len(records)} records at 9x9, each round-trips through "
        "JSON and replays to the actor's boards")
    return {"records": len(records)}


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "elf_tpu_torch" / "csrc" / "go_libs.cu").is_file():
        print("chip_smoke: the elf_tpu_torch package is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from elf_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    path, text = _build.build("go_libs")
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():      # registers, smem, spills per kernel
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            log(f"build: {line.strip()}")

    result = {"card": card, "kind": kind}
    result["kernels"] = kernel_phase(np.random.default_rng(0))
    result["slice"], net = slice_phase(card)
    result["records"] = record_phase()
    result["profile"] = profile_phase(card, net)

    rows = []
    replaces = {
        "analyze_libs": "elf_tpu/env/go/pallas_kernels.py:254",
        "step_analysis": "elf_tpu/env/go/pallas_kernels.py:202",
    }
    k = result["kernels"]
    for name in ("step_analysis", "analyze_libs"):
        t = k["timings"][(name, "mid-game", SLICE_B)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "elf_tpu_torch/csrc/go_libs.cu",
            "replaces": replaces[name],
            "launches": result["slice"]["launches"][name],
            "max_abs_err": k["worst"][name], "ms": t["union-find"]["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": f"19x19 mid-game B={SLICE_B}",
            "host_ms": t["union-find"]["host_ms"],
            "by_shape": {
                f"{boards} B={B}": {
                    "ms": v["union-find"]["ms"], "rounds_ms": v["rounds"]["ms"],
                    "bound_ms": v["bound_ms"]}
                for (n, boards, B), v in k["timings"].items() if n == name},
        })
    k["timings"] = {f"{n} {boards} B={B}": v
                    for (n, boards, B), v in k["timings"].items()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    result["kernel_rows"] = rows
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
