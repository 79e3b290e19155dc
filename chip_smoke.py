#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`elf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from `elf_tpu_torch/csrc/` with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card
     (19x19 and 9x9, B in {1, 5, 32, 130, 4096}, random boards, the
     serpentine chain, actions with passes, negatives and occupied
     points; then 19x19 mid-game boards at B = 32 and 4096), exact
     integers; times of kernel and plain version with CUDA events on the
     mid-game boards;
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


def kernel_phase(rng) -> dict:
    from elf_tpu_torch.env.go import kernels

    dev = torch.device("cuda")
    worst = {"analyze_libs": 0, "step_analysis": 0}
    for size in (9, 19):
        n2 = size * size
        for B in (1, 5, SLICE_B, 130, 4096):
            s = torch.from_numpy(test_boards(B, size, rng)).to(dev)
            if B == 1:
                s[0] = torch.from_numpy(snake(size)).to(dev)
            got = kernels.analyze_libs_cuda(s)
            ref = kernels.analyze_libs_ref(s)
            torch.cuda.synchronize()
            for g_, r_ in zip(got, ref):
                if not torch.equal(g_, r_):
                    fail(f"analyze_libs differs at size {size} B {B}")
                worst["analyze_libs"] = max(
                    worst["analyze_libs"], int((g_ - r_).abs().max()))
            flat = s.reshape(B, n2).contiguous()
            act = torch.from_numpy(
                rng.integers(-3, n2 + 3, size=B).astype(np.int32)).to(dev)
            col = torch.from_numpy(
                rng.integers(1, 3, size=B).astype(np.int32)).to(dev)
            got = kernels.step_analysis_cuda(flat, act, col)
            ref = kernels.step_analysis_ref(flat, act, col)
            torch.cuda.synchronize()
            for name, g_, r_ in zip(("s2", "lib_min", "lib_max", "captured"),
                                    got, ref):
                if g_.dtype != r_.dtype or not torch.equal(g_, r_):
                    fail(f"step_analysis {name} differs at size {size} B {B}")
                worst["step_analysis"] = max(
                    worst["step_analysis"],
                    int((g_.int() - r_.int()).abs().max()))
            log(f"kernels: size {size} B {B}: both kernels equal to their "
                "plain versions")

    # 19x19 mid-game boards, at the slice's batch and at 4096: checked
    # against the plain versions, then timed
    size, n2 = 19, 361
    timings = {}
    for B in (SLICE_B, 4096):
        core = played_boards(B, size, 120, seed=B)
        s2d = core.stones.reshape(B, size, size).contiguous()
        color = core.to_play.to(torch.int32)
        act = torch.from_numpy(
            rng.integers(0, n2 + 1, size=B).astype(np.int32)).to(dev)
        calls = {
            "analyze_libs": (lambda: kernels.analyze_libs_cuda(s2d),
                             lambda: kernels.analyze_libs_ref(s2d),
                             B * n2 + 2 * B * n2 * 4),
            "step_analysis": (
                lambda: kernels.step_analysis_cuda(core.stones, act, color),
                lambda: kernels.step_analysis_ref(core.stones, act, color),
                B * (n2 + 8) + B * n2 * (1 + 4 + 4 + 1)),
        }
        reps = 200 if B == SLICE_B else 50
        for name, (kern, plain, nbytes) in calls.items():
            for g_, r_ in zip(kern(), plain()):
                if g_.dtype != r_.dtype or not torch.equal(g_, r_):
                    fail(f"{name} differs on mid-game 19x19 boards at B {B}")
            # the byte term bounds the time: a chain's min and max need
            # O(1) integer operations per point, far below it
            timings[(name, B)] = dict(
                ms=cuda_time_ms(kern, reps), plain_ms=cuda_time_ms(plain, 5),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
            t = timings[(name, B)]
            log(f"kernels: {name} 19x19 mid-game B {B}: equal to the plain "
                f"version; kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
                "(bytes)")
    return {"worst": worst, "timings": timings}


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
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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
    for name in ("step_analysis", "analyze_libs"):
        k = result["kernels"]
        t = k["timings"][(name, SLICE_B)]
        t4 = k["timings"][(name, 4096)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "elf_tpu_torch/csrc/go_libs.cu",
            "replaces": replaces[name],
            "launches": result["slice"]["launches"][name],
            "max_abs_err": k["worst"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": f"19x19 B={SLICE_B}", "ms_b4096": t4["ms"],
            "plain_ms_b4096": t4["plain_ms"], "bound_ms_b4096": t4["bound_ms"],
        })
    result["kernels"]["timings"] = {
        f"{n}@B{b}": v for (n, b), v in result["kernels"]["timings"].items()
    }
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
