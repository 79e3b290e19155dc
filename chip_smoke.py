#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`elf_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from `elf_tpu_torch/csrc/` with nvcc, and the
     host C code there (the game replayer, the ladder reader, the SGF
     codec);
  3. kernels: the engine's two union-find liberty kernels against the
     plain PyTorch versions on the card (19x19 and 9x9, B in {1, 5, 32,
     130, 4096}, random boards, the serpentine chain, actions with passes,
     negatives and occupied points), exact; then at the timed 19x19
     shapes (mid-game boards at B = 1, 32, 1024 and 4096, serpentine
     chains at B = 1024) checked again and timed twice: device time per
     launch by CUDA-graph replay, the profiler's kernel time beside it,
     the host cost of one wrapper call, the plain version's time and the
     byte bound;
 3b. epilogue: the serving trunk's epilogue kernel
     (`csrc/net_epilogue.cu`) against its plain version, bit for bit, at
     every trunk layer of the committed 19x19 20b256c and 13x13 10b128c
     nets on mid-game positions (19x19 B = 1, 32, 2048; 13x13 B = 192,
     1536), both forms (without and with the skip); each serving forward
     against today's modules (max abs difference of log_pi and value,
     within tests/test_torch_resnet.py's bf16 bounds); the kernel timed
     at 19x19 B = 2048 and 13x13 B = 1536 by graph replay beside its byte
     bound (at least 60 % of it at B = 2048), its host cost and the plain
     version's time, and the serving forward against the modules';
 3c. nbt: KataGo's b18c384nbt (`elf_tpu_torch/models/nbt.py`) at its
     published widths, seeded weights, each norm's running statistics
     set to its batch moments over 256 mid-game positions: its epilogue
     kernels (`csrc/nbt_epilogue.cu`) against their plain versions, bit
     for bit, at every epilogue of the serving forward (each mode: norm
     and activation, with the residual add, with the pooled row bias,
     the pooling and the value pooling; C = 384, 192, 128, 64 and the
     heads' 32) at 19x19 B = 1, 32 and 2048; the serving forward bit for
     bit equal to the serving copy's own modules' forward (the same bf16
     channels_last weights), and against the modules of the fp32-master
     net (weights cast at each call) the first convolution at which the
     two part, which must be a convolution's output on equal inputs (B =
     1, 32); its counters (118 epilogues and 8 pools a forward) and
     launches (110 nbt_normact, 8 nbt_pool) and no cuDNN layout
     transpose in its trace; each mode timed at B = 2048 by graph replay
     beside its byte bound (70 % of it asked: a norm-act mode below
     fails; a pool, which mish's instructions hold under about 79 %, is
     logged as a MISS and kept in the result), its host cost and the
     plain version's time, and the serving forward against the modules'.
 3d. train epilogue (after 3b): the learner's epilogue kernels
     (`csrc/net_train_epilogue.cu` with the serving epilogue kernel,
     through `train_epilogue_cuda`) against the plain chain's autograd at
     19x19 C = 256 B = 2048 and 13x13 C = 128 B = 1536, with and without
     the skip (the card tests hold the tolerances), a second call bit for
     bit; the forward and backward pairs timed at 19x19 C = 256 B = 2048
     by graph replay beside their byte bounds, their host cost and the
     plain chain's time; the 20b256c remat step at batch 2048 with the
     kernels against the modules, in turns, with its peak memory, 81
     statistics and 41 backward launches, and no cuDNN layout transpose
     among its top kernels.  `python3 chip_smoke.py --only
     train_epilogue` runs phases 1 and 3d alone and prints their kernels
     line;
 3e. nbt train (after 3c): the nbt learner's norm kernels
     (`csrc/nbt_train_epilogue.cu` with the serving nbt kernels) at 19x19
     B = 2048, bf16, mish: each mode's forward and backward at 192 and 384
     channels by graph replay beside their byte bounds, their host cost
     and the torch ops' time; b18c384nbt's remat step at batch 2048 on
     the kernels against the torch ops, in turns, with its peak memory,
     232 statistics and 118 backward launches and its counters, one step
     profiled.  `python3 chip_smoke.py --only nbt_train` runs it alone
     (the card tests, `tests/test_torch_nbt_train_epilogue.py -m cuda`,
     hold the values);
 4b. nbt slice (after the slice): the same net drives SelfplayActor
     through `eval_fn_builder` as the slice does, with the launch counts
     set to 0 just before; nbt_normact must launch 110 times and nbt_pool
     8 times a forward of that run, the ResNet's kernel never, and every
     move is replayed on the host.  `python3 chip_smoke.py --only nbt`
     runs phases 1, 3c and 4b alone and prints their kernels line;
  4. slice: the 19x19 20-block 256-channel net with the committed weights
     (runs/prove19/export-best.bin) drives SelfplayActor (B = 32, 64
     rollouts, 8 per batch, Dirichlet noise) for 6 moves, with the launch
     counts set to 0 just before; both kernels must have launched, the
     epilogue kernel 41 times a forward, and every move is replayed on
     the host (plain versions, not the kernels) to check it legal and the
     boards equal;
  5. records: 9x9 games with a seeded small net until move_cutoff = 20;
     every Record survives a JSON round trip and replays on the host to
     the boards the actor played; then the same with persistent search
     trees, a 10-move SGF preload (the first golden 9x9 game) and SGF
     dumps, each dump parsed back to its record's moves;
  6. train: the learner at full width (19x19, 20 blocks, 256 channels, bf16
     compute, fp32 master weights), all on the card.  Self-play with the
     committed weights (B = 32, 16 rollouts, move_cutoff = 8, launch
     counts set to 0 just before; both kernels must have launched) emits
     32 Records; each goes through `TrainingPipeline.insert_record` (the C
     replayer, held against its plain version) into a ReplayBuffer; a
     Trainer at batch 256 loads the same file through `load_checkpoint`
     (bf16 export onto fp32 masters, fresh optimizer);
     `LearnerRunner.run_minibatch` steps, timed by CUDA events around the
     step with the host's batch assembly apart; steps on one fixed batch
     must lower the loss; `episode_summary` (2 cooldown passes) writes
     `save-<step>.bin`, which must read back bit for bit and, through
     `load_model`, play one more legal move; one step under
     torch.profiler gives the device's busy share;
  7. fleet: the production deployment, one `scripts/train_server_torch.py`
     and two `scripts/selfplay_client_torch.py` processes on this card at
     19x19 20b256c over TCP.  The server loads the committed weights onto
     fp32 masters (batch 256, 4 steps per episode, 2 cooldown passes) and
     drives the clients' search (16 rollouts); each client plays B = 32
     boards cut at 8 moves, 8 moves per round.  The server journals the
     records, trains, writes `save-<ver>.bin` and queues it; the first
     client plays colour-swapped candidate-vs-baseline games and
     `EvalSubCtrl` promotes or rejects the candidate.  The phase polls the
     server's `status` and its log, ends the fleet at the first decision
     (none within its deadline fails the run), and reads each process's
     exit summary: games, journaled records, stage timers, peak memory and,
     in each client, the liberty kernels' launch counts (set to 0 just
     before its play loop) which must both be positive;
  8. play: the play surface at B = 1 with the committed weights.
     `scripts/gtp_console_torch.py` (400 rollouts in batches of 8,
     persistent trees) answers a scripted game (play, genmove, the ladder
     extension, showboard, undo, final_score); no answer may be an error,
     the engine's moves must replay legally on the host, every search
     must start from exactly the visits the earlier tree held below the
     moves played since (the third genmove, after the engine's own move,
     from some), and both
     kernels' launch counts (set to 0 when the console starts) must be
     the counts the search implies.  `scripts/analysis_torch.py` (200
     rollouts) analyses four positions of a golden 19x19 game after a
     40-move preload, writing four tree dumps, with the same launch
     check.  Each process's exit summary gives seconds per genmove or
     position, rollouts/s, carried visits and peak memory;
  9. production: the JAX package's production self-play search
     (`scripts/production_selfplay_torch.py`: c_puct 0.85, virtual loss 5,
     root noise, passes from ply 160, a random symmetry per leaf,
     `eval_chunk` 2048, `batched_writes="on"`) on B = 1024 boards with the
     committed weights at a cut budget: 64 rollouts in batches of 8, so
     8192-leaf batches in 4 chunks, the search in 2 simulate calls of 4
     batches; a warm-up move, then a timed one; exact launch counts over
     both, every move legal on host replay; moves/s, rollouts/s, leaf
     evaluations/s, seconds per simulate call, peak memory; then a third
     move under torch.profiler (the device's busy share);
 10. remat: `ModelConfig(remat=True)` at 20b256c with the train phase's
     optimizer: the step at the production batch 2048 (median of 5 by
     CUDA events, positions/s, share of the bf16 bound of the useful
     work, peak memory), remat against the plain step at batch 256 on
     one batch, and one remat and one plain step from one state, which
     must leave equal BN statistics and parameters within 1e-5;
 11. df: `make_trainer("df_kl", use_df_feature=True)` (25 planes, random
     weights): 2 lockstep moves of B = 32 at 64 rollouts with df leaves
     (exact launch counts, legal on replay), then one train step at batch
     256 on a df batch from those games, with finite stats; then a fresh
     df actor's first move with the df planes, `analyze_libs3` and the
     leaf walk timed by synchronising wrappers, and its second move under
     torch.profiler;
 12. offline: the supervised path and the secondary modules.  256
     policy-only 19x19 games with the committed weights (B = 256, cut at
     160 plies, Tromp-Taylor results checked against the records) written
     as an SGF archive with the port's writer; `OfflineLoader` (16
     threads: the C SGF parser and replayer) loads it (files/s); the
     df_pred learner at 20b256c (`make_trainer("df_pred")`,
     `LearnerRunner(train_mode="offline")`, 3 future actions, batch 256,
     bf16 compute, fp32 masters): 20 steps, 10 of them timed by CUDA
     events (positions/s, share of the bf16 bound, peak memory),
     `loss/policy` falling over 20 steps on one fixed batch, one fp32 step
     on the card against the same step on the CPU, 3 steps on df planes;
     `scripts/demo_supervised_torch.py` on the archive and
     `scripts/train_server_torch.py --model df_pred` up to its first
     checkpoint, as processes; the 39 x 128 PolicyNet (25 planes, T = 3,
     bf16) timed at B = 256 on df planes of the archive, normalised, and
     in fp32 against the CPU; `tactics.self_atari_mask` on 8 boards of the
     archive at ply 80 (both kernels at B = 2888) and the eye masks on
     1024 boards equal to the CPU; the rl methods' values and gradients
     within 1e-5 of the CPU.  Launch counts over the whole phase;
 13. parallel: the mesh (`elf_tpu_torch/parallel/`), every rank a
     subprocess on this card.  (a) Rank 0 alone on NCCL:
     `LearnerRunner(mesh=make_mesh(1))` against the plain runner, one step
     of the committed export at batch 256 (bf16, fp32 masters) from one
     state and batch, bit for bit (deterministic cuDNN), then both timed
     in turns by CUDA events.  (b) Two ranks on cuda:0 over gloo (NCCL
     refuses two ranks on one device): dp = 2, then tp = 2, three fp32
     steps at global batch 256 held within 1e-4 (each tensor against its
     scale, the losses relative) of the same steps in one process, then
     bf16 steps timed per rank with their peak memory: two ranks on one
     card over gloo, host-staged all_reduce, not a multi-card figure.
     (c) `scripts/train_server_torch.py --dist_* --dist_num_processes 1
     --use_mesh 1` (NCCL, world 1) with one client, until the first
     checkpoint is written and the client loads it.  (d) The sharded
     actor, two ranks over gloo, B = 32 with the committed net: 2 moves
     at dp = 2 (the slice's search) and 2 at tp = 2 (16 rollouts), games
     cut at 2 moves; every move legal on host replay, every record on
     rank 0 in board order, each rank's launches those of an unsharded
     actor (the same calls over its boards);
 14. tools: the tools layer at 19x19 20b256c with the committed weights.
     (a) A ladder suite written from the four golden 19x19 games (32
     probes at moves 10-150), the ladder module pointed at it:
     `batch_replay` of the games (no illegal move, the C replayer's final
     boards, one `step_analysis` launch a ply), an oracle evaluator
     scoring every probe, the export's fp32 scorecard on the card picking
     the CPU's move wherever the top two legal log-probabilities differ by
     more than 1e-3, the bf16 scorecard timed, `ladder_bench_torch.main`
     raw and at 64 rollouts on 8 probes (exact launches),
     `classify_suite` equal to a classification from the plain replayer.
     (b) `scripts/eval_match_torch.py` (4 games) and
     `scripts/elo_progression_torch.py` (a `save-648.bin` link to the
     export, `--include_init` the init, 4 games; then `--pairs 648:0`) as
     processes side by side, policy-only whole games, both kernels
     launched in each;
     then `head_to_head` on a pair-eval search actor in this process (B =
     8, 16 rollouts, games cut at 24 moves): exact launches, every game
     legal on host replay.  (c) `scripts/demo_train_9x9_torch.py` at its
     default widths for 14 iterations (9x9 games end by ply 161, so it
     trains; 8 rollouts): JSON lines, finite losses, the init the final
     eval plays equal to the init as drawn.  (d)
     `scripts/profile_mcts_torch.py` at B = 16 (with a trace, kept
     gzipped), 1 and 32, 2 timed calls: full, net-only and tree-only
     times, exact launches;
 15. bench: `bench_torch.py`'s stages in this process, at its full sizes
     but for production self-play's budget.  Env: 19x19, B = 4096, 3
     warm-up and 4 timed 64-step chunks (exactly 448 `step_analysis`
     launches and no `analyze_libs`, no illegal draw), then one more chunk
     whose first 256 boards, replayed on the host through the plain
     versions with the chunk's reset, must end in the card's state bit for
     bit, and one more under torch.profiler (device ops per step, host
     copies and syncs per chunk, the card's busy share).  NN forwards at
     batch 128 and 1024 against their bf16 bound, and one at 1024 under
     torch.profiler; the B = 16 search at 64
     rollouts (exact launches); the remat train step at batch 2048 (no
     halving, finite stats, TFLOP/s as `bench.py` counts them, peak
     memory); production self-play at B = 1024 and 64 rollouts (exact
     launches, every move legal on host replay);
 16. profile: one more slice move under torch.profiler, device time by
     kernel group, with its own launch counts;
 17. prod13: the JAX run's two 13x13 10b128c checkpoints
     (runs/prod13/init.bin and promoted-160.bin).  A short anchor through
     `tools/prod_anchor_parity.py` (the proof's own `final_anchor_match`
     at the README's 13x13 flags): ver 160 against the init, 8 games (4 a
     colour) at 16 rollouts, capped at 2 * 169 - 1 plies as the protocol
     caps, with exact launch counts (16 + 1 `step_analysis` and 1
     `analyze_libs` a lockstep move); every game replayed on the host;
     both kernels on every position played against their plain versions,
     exact; both nets' fp32 forward on the card against the CPU's on
     positions played, within 1e-4.

The kernel phase times B = 1 too, the batch of the play surface.  Prints
the card's nvidia-smi line, one JSON line describing the kernels
(`launches` is the slice's count, `launches_train`, `launches_fleet`,
`launches_play`, `launches_production`, `launches_df`,
`launches_offline`, `launches_parallel`, `launches_tools`,
`launches_bench` and `launches_prod13` those of the train, fleet, play,
production, df, offline, parallel, tools, bench and prod13 phases),
and last
`{"ok": true, "device": {...}}`.  Exits non-zero, before printing any result, when CUDA is
unavailable or the port is not beside this file.
A copy of the numbers goes to chiprun_out/chip_smoke.json, the fleet's
logs to chiprun_out/fleet/, the play processes' output and tree dumps to
chiprun_out/play/, the offline phase's processes' output to
chiprun_out/offline/, the parallel phase's server and client logs to
chiprun_out/parallel/, the tools phase's output and trace to
chiprun_out/tools/.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 peak
SLICE_B, SLICE_ROLLOUTS, SLICE_PER_BATCH, SLICE_MOVES = 32, 64, 8, 6
# the train phase: self-play that feeds it, and the learner's batch
TRAIN_GAMES, TRAIN_ROLLOUTS, TRAIN_PER_BATCH, TRAIN_CUTOFF = 32, 16, 8, 8
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FIXED, TRAIN_COOLDOWN = \
    256, 3, 10, 6, 2
# the fleet: clients, boards per client, rollouts, train steps per episode,
# games before the first episode (and per later one), eval games per
# candidate, and the time the first eval decision may take
FLEET_CLIENTS, FLEET_B, FLEET_ROLLOUTS, FLEET_MINIBATCH = 2, 32, 16, 4
FLEET_INIT, FLEET_EVAL_GAMES, FLEET_DEADLINE_S = 32, 8, 600
# the play surface: rollouts per genmove and per analysed position
PLAY_ROLLOUTS, ANALYSIS_ROLLOUTS = 400, 200
# production self-play: boards, rollouts (cut from 1600), rollouts per
# batch, simulation batches per simulate call
PROD_B, PROD_ROLLOUTS, PROD_PER_BATCH, PROD_BATCHES_PER_CALL = 1024, 64, 8, 4
# block remat: the production batch and the timed steps per measurement
REMAT_BATCH, REMAT_TIMED = 2048, 5
# df-25: lockstep moves of the slice's shape
DF_MOVES = 2
# the offline (supervised) phase: archive games and their plies, the
# learner's width, batch, horizons and steps, rows of the card-vs-CPU fp32
# checks, the demo's steps, the PolicyNet (39 x 128, T = 3) forward's batch
# and repetitions, and the tactics' boards
OFFLINE_GAMES, OFFLINE_PLIES, OFFLINE_T = 256, 160, 3
OFFLINE_BLOCKS, OFFLINE_DIM, OFFLINE_BATCH = 20, 256, 256
OFFLINE_WARMUP, OFFLINE_TIMED, OFFLINE_STEPS, OFFLINE_DF_STEPS = 3, 10, 20, 3
OFFLINE_CPU_ROWS, DEMO_STEPS = 16, 30
PN_BATCH, PN_REPS, PN_CPU_ROWS = 256, 20, 64
# the PolicyNet's bf16 checks: the largest relative error one bf16 layer may
# add to the fp32 activations it is fed, the shallower depths whose bf16
# forward is held (the first) or reported beside its fp32 twin, and the
# share of rows whose top move the shallowest must keep
PN_LAYER_TOL, PN_DEPTHS, PN_SHALLOW_TOP = 1e-2, (5, 10, 20), 0.95
TACTICS_BOARDS, TACTICS_PLY, EYE_BOARDS = 8, 80, 1024
# the mesh: the learner's global batch, its fp32 steps checked and bf16
# steps timed, the tolerance against one process; the sharded actor's
# boards and moves, and the rollouts of its tp = 2 run (each leaf batch
# crosses the host 21 times there)
PAR_BATCH, PAR_STEPS, PAR_TIMED, PAR_TOL = 256, 3, 2, 1e-4
PAR_B, PAR_MOVES, PAR_TP_ROLLOUTS = 32, 2, 16
# the serving trunk's epilogue kernel: (board, net, batch, plies) of the
# checks (the go19 self-play cell's root and 2048-leaf evaluations, the
# slice's B; the go13 cell's root and 192 x 8-leaf evaluations), the
# shapes timed, and the serving forward's tolerance against the modules'
# (tests/test_torch_resnet.py's bf16 bounds on log_pi and value)
EPI_NETS = {19: ("runs/prove19/export-best.bin", 20, 256),
            13: ("runs/prod13/promoted-160.bin", 10, 128)}
EPI_SHAPES = ((19, 1, 120), (19, 32, 120), (19, 2048, 120),
              (13, 192, 60), (13, 1536, 60))
EPI_TIMED = ((19, 2048), (13, 1536))
EPI_TOL = (3e-2, 1e-2)
# the learner's epilogue kernels: (board, channels, batch) timed (the
# learner cell's layer) and checked (the 13x13 learner's at its batch), and
# the 20b256c remat step's batch
TRAIN_EPI_SHAPES = ((19, 256, 2048), (13, 128, 1536))


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


def bytes_moved(name: str, B: int, n2: int) -> int:
    """Each input read once, each output written once."""
    if name == "analyze_libs":
        return B * n2 + 2 * B * n2 * 4
    return B * (n2 + 8) + B * n2 * (1 + 4 + 4 + 1)


# The timed shapes, all 19x19: (boards, B).
TIMED = (("mid-game", 1), ("mid-game", SLICE_B), ("mid-game", 1024),
         ("mid-game", 4096), ("serpentine", 1024))


def kernel_phase(rng) -> dict:
    from elf_tpu_torch.env.go import kernels

    dev = torch.device("cuda")
    worst = {"analyze_libs": 0, "step_analysis": 0}
    calls = {"analyze_libs": (kernels.analyze_libs_cuda,
                              "analyze_libs_kernel"),
             "step_analysis": (kernels.step_analysis_cuda,
                               "step_analysis_kernel")}
    plain_of = {"analyze_libs": kernels.analyze_libs_ref,
                "step_analysis": kernels.step_analysis_ref}

    def check(name, args, where):
        """The kernel of `name` equal to the plain version on `args`."""
        plain = plain_of[name](*args)
        got = calls[name][0](*args)
        torch.cuda.synchronize()
        for g_, r_ in zip(got, plain):
            if g_.dtype != r_.dtype or not torch.equal(g_, r_):
                fail(f"{name} differs from the plain version {where}")
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
            log(f"kernels: size {size} B {B}: both kernels equal to their "
                "plain versions")

    # the timed shapes: checked against the plain versions, then timed twice
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
            fn, symbol = calls[name]
            turns = [graph_ms(lambda: fn(*a), reps) for _ in range(2)]
            plain = plain_of[name]
            nbytes = bytes_moved(name, B, n2)
            t = dict(boards=boards, B=B, bytes=nbytes,
                     bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     plain_ms=cuda_time_ms(lambda: plain(*a), 3),
                     ms=float(np.mean(turns)), ms_turns=turns,
                     profiler_ms=profiler_ms(lambda: fn(*a), symbol, 50),
                     host_ms=host_ms(lambda: fn(*a), 200))
            timings[(name, boards, B)] = t
            prof = ("not found" if t["profiler_ms"] is None
                    else f"{t['profiler_ms']:.6f} ms")
            log(f"kernels: {name} 19x19 {boards} B {B}: device "
                f"{t['ms']:.6f} ms/launch (graph replay; turns "
                f"{', '.join(f'{x:.6f}' for x in turns)}), "
                f"profiler {prof}, host cost {t['host_ms']:.6f} ms/call, "
                f"bound {t['bound_ms']:.6f} ms (bytes), plain "
                f"{t['plain_ms']:.4f} ms")
    ratios = {}
    for name in ("step_analysis", "analyze_libs"):
        r = (timings[(name, "serpentine", 1024)]["ms"]
             / timings[(name, "mid-game", 1024)]["ms"])
        ratios[name] = r
        log(f"kernels: {name}: serpentine / mid-game device time at B 1024 = "
            f"{r:.3f}")
    return {"worst": worst, "timings": timings, "serpentine_ratio": ratios}


# ---------------------------------------------------------------------------
# phase 3b: the serving trunk's epilogue kernel
# ---------------------------------------------------------------------------


def midgame_features(B: int, size: int, plies: int, seed: int):
    """The search's input layout (an NHWC view of NCHW planes) of boards
    after `plies` random legal moves, the position alone as history."""
    from elf_tpu_torch.env.go import features

    core = played_boards(B, size, plies, seed)
    snaps = core.stones[:, None, :].expand(B, 8, size * size)
    valid = torch.zeros((B, 8), dtype=torch.bool, device=core.stones.device)
    valid[:, -1] = True
    codes = torch.zeros(B, dtype=torch.int32, device=core.stones.device)
    return features.extract_agz_from_snapshots(snaps, valid, core.to_play,
                                               codes, size)


def epilogue_layers(frozen, x):
    """The inputs of each trunk epilogue of `frozen.serve(x)`, layer by
    layer (the next layer's input is the plain version's output): the
    convolution's output without its bias, the BN constants, the conv bias
    and, after a block's second convolution, the block's input."""
    import torch.nn.functional as F

    from elf_tpu_torch.models.epilogue import epilogue_ref

    h = x.permute(0, 3, 1, 2).to(frozen.cfg.compute_dtype,
                                  memory_format=torch.channels_last)
    seq = [(frozen.init_conv, frozen.init_bn, False)]
    for blk in frozen.blocks:
        seq += [(blk.conv1, blk.bn1, False), (blk.conv2, blk.bn2, True)]
    block_in = None
    for conv, bn, skips in seq:
        args = dict(v=F.conv2d(h, conv.weight, None, padding=conv.padding),
                    mean=bn.running_mean, mul=bn.serving_mul, bias=bn.bias,
                    skip=block_in if skips else None, conv_bias=conv.bias)
        yield args
        h = epilogue_ref(**args)
        if skips or block_in is None:
            block_in = h


def todays_serving_copy(net):
    """The serving copy as the modules serve it (no serving path)."""
    from elf_tpu_torch.models.resnet import Conv

    frozen = copy.deepcopy(net).requires_grad_(False)
    for m in frozen.modules():
        if isinstance(m, Conv):
            m.to(m.dtype)
    return frozen


def epilogue_phase(card: str) -> dict:
    """The epilogue kernel against its plain version, bit for bit, at every
    trunk layer of both committed nets on mid-game positions (both forms:
    without and with the skip); the serving forward against today's
    modules; the kernel timed by graph replay beside its byte bound, its
    host cost and the plain version."""
    from elf_tpu_torch.models import epilogue as epi
    from elf_tpu_torch.models.resnet import (ModelConfig, load_model,
                                             serving_copy)

    dev = torch.device("cuda")
    nets, checks, forward = {}, {}, {}
    for size, (path, blocks, dim) in EPI_NETS.items():
        cfg = ModelConfig(board_size=size, num_block=blocks, dim=dim)
        net = load_model(str(ROOT / path), cfg, "cuda")
        nets[size] = (serving_copy(net), todays_serving_copy(net))
        if not nets[size][0].serves:
            fail(f"epilogue: the {size}x{size} serving copy has no serving "
                 "path")
    for size, B, plies in EPI_SHAPES:
        frozen, today = nets[size]
        x = midgame_features(B, size, plies, seed=B)
        forms = {"plain": 0, "skip": 0}
        for args in epilogue_layers(frozen, x):
            got = epi.epilogue_cuda(**args)
            ref = epi.epilogue_ref(**args)
            torch.cuda.synchronize()
            dt = torch.int16        # compare bf16 bit patterns
            if got.dtype != ref.dtype or not got.is_contiguous(
                    memory_format=torch.channels_last) or not torch.equal(
                    got.view(dt), ref.view(dt)):
                fail(f"epilogue: the kernel differs from the plain version "
                     f"at {size}x{size} B {B}, layer "
                     f"{sum(forms.values())}")
            forms["skip" if args["skip"] is not None else "plain"] += 1
        checks[f"{size}x{size} B={B}"] = forms
        with torch.no_grad():
            new = frozen(x)
            old = today(x)
        torch.cuda.synchronize()
        err = [float((a - b).abs().max()) for a, b in zip(new, old)]
        same = all(torch.equal(a, b) for a, b in zip(new, old))
        forward[f"{size}x{size} B={B}"] = dict(
            log_pi_max_abs=err[0], value_max_abs=err[1], bitwise=same)
        if not (err[0] <= EPI_TOL[0] and err[1] <= EPI_TOL[1]):
            fail(f"epilogue: the serving forward at {size}x{size} B {B} "
                 f"differs from the modules' by {err} (tolerance {EPI_TOL})")
        log(f"epilogue: {size}x{size} B {B}: kernel equal to the plain "
            f"version bit for bit at {forms['plain']} layers without and "
            f"{forms['skip']} with the skip; serving forward against the "
            f"modules': log_pi {err[0]:.3g}, value {err[1]:.3g} max abs "
            f"({'bit for bit' if same else 'not bit for bit'})")

    timings = {}
    for size, B in EPI_TIMED:
        frozen, today = nets[size]
        x = midgame_features(B, size, 120 if size == 19 else 60, seed=B)
        gen = epilogue_layers(frozen, x)
        layers = [next(gen) for _ in range(3)]
        for form, args in (("plain", layers[1]), ("skip", layers[2])):
            n = args["v"].numel()
            C = args["v"].shape[1]
            nbytes = (n * (6 if form == "skip" else 4)
                      + C * (3 * 4 + args["v"].element_size()))
            ms = [graph_ms(lambda: epi.epilogue_cuda(**args), 50)
                  for _ in range(2)]
            t = dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     ms=float(np.mean(ms)), ms_turns=ms,
                     profiler_ms=profiler_ms(
                         lambda: epi.epilogue_cuda(**args), "epilogue_kernel",
                         50),
                     host_ms=host_ms(lambda: epi.epilogue_cuda(**args), 200),
                     plain_ms=cuda_time_ms(
                         lambda: epi.epilogue_ref(**args), 5))
            t["bound_share"] = t["bound_ms"] / t["ms"]
            timings[f"{size}x{size} B={B} {form}"] = t
            log(f"epilogue: {size}x{size} B {B} {form}: device {t['ms']:.6f} "
                f"ms/launch (graph replay; turns "
                f"{', '.join(f'{v:.6f}' for v in ms)}), bound "
                f"{t['bound_ms']:.6f} ms ({nbytes} bytes; "
                f"{100 * t['bound_share']:.1f} % of it), host "
                f"{t['host_ms']:.6f} ms/call, plain {t['plain_ms']:.4f} ms")
        with torch.no_grad():
            fwd = {"change": [], "today": []}
            for which in ("today", "change", "change", "today"):
                net = frozen if which == "change" else today
                fwd[which].append(cuda_time_ms(lambda: net(x), 5))
        timings[f"{size}x{size} B={B} forward"] = fwd
        log(f"epilogue: {size}x{size} B {B}: the serving forward "
            f"{np.mean(fwd['change']):.3f} ms, today's modules "
            f"{np.mean(fwd['today']):.3f} ms (CUDA events, in turns)")
    big = timings["19x19 B=2048 plain"]["bound_share"]
    if big < 0.6:
        fail(f"epilogue: {100 * big:.1f} % of the byte bound at B 2048")
    return {"checks": checks, "forward": forward, "timings": timings}


# ---------------------------------------------------------------------------
# phase 3d: the learner's epilogue kernels (batch statistics and a backward)
# ---------------------------------------------------------------------------


def train_epilogue_inputs(B: int, C: int, hw: int, seed: int) -> dict:
    """A trunk layer's inputs in bf16 channels_last from a seed: the
    convolution's output (an offset so that the mean is not 0), BN's weight
    and bias, the conv bias, a block input and an upstream gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    shape = (B, C, hw, hw)

    def act(scale, shift=0.0):
        t = torch.randn(shape, generator=g, device="cuda") * scale + shift
        return t.to(torch.bfloat16).contiguous(memory_format=cl)

    return dict(v=act(1.5, 0.3),
                weight=torch.randn(C, generator=g, device="cuda") * 0.5 + 1,
                bias=torch.randn(C, generator=g, device="cuda") * 0.3,
                conv_bias=torch.randn(C, generator=g, device="cuda") * 0.2,
                skip=torch.relu(act(1.0)), up=act(1.0))


def train_epilogue_errors(t: dict, skip: bool) -> tuple:
    """The kernels' forward and backward against the plain chain's
    autograd: (each output's largest difference relative to the plain
    output's largest value, for the log; each gate's (value, limit)).  The
    gates are the card tests' (`tests/test_torch_cuda.py`,
    `test_train_epilogue_matches_plain_chain`), set by the order of the
    fp32 sums: mean within 1e-5 of sqrt(E[u^2]) and var within 1e-5 of
    E[u^2], channel by channel; y equal bit for bit to the plain apply
    (`epilogue_ref`) with the kernels' own statistics, as its count of
    elements apart, so that y differs from the plain chain only through
    the statistics' last bits; then y against the plain chain, each
    element within one bf16 rounding (2^-7 of the value) a cast between
    them, plus 1e-3 of the largest, as a ratio to that tolerance: one
    cast, two on a skip layer (relu(skip + y) rounds again after the inner
    y, which the statistics' last bits can move by one rounding; among
    the 190 M elements at 19x19 C = 256 B = 2048 some land two roundings
    apart); d v the same with one rounding; fewer than 1 % of y's
    elements apart; d skip (a mask of g) bit for bit, as its count of
    elements apart; d weight and d bias within 1e-3 of their largest; d
    conv_bias within 2^-6 of the largest channel's sum of |d v|; and a
    second call equal to the first bit for bit, as its count of outputs
    apart."""
    from elf_tpu_torch.models import epilogue as epi

    def run(fn):
        ins = {k: t[k].clone().requires_grad_(True)
               for k in ("v", "weight", "bias", "conv_bias", "skip")}
        y, mean, var = fn(ins["v"], ins["weight"], ins["bias"],
                          ins["skip"] if skip else None, ins["conv_bias"])
        y.backward(t["up"])
        out = dict(y=y, mean=mean, var=var)
        out.update({f"d{k}": ins[k].grad for k in ins
                    if k != "skip" or skip})
        return {k: v.detach() for k, v in out.items()}

    got, again = run(epi.train_epilogue_cuda), run(epi.train_epilogue_cuda)
    want = run(epi.train_epilogue_ref)
    torch.cuda.synchronize()
    d = {k: (got[k].double() - want[k].double()).abs() for k in want}
    top = {k: float(want[k].double().abs().max()) for k in want}
    err = {k: float(d[k].max()) / max(top[k], 1e-30) for k in want}
    bits = lambda x: x.view(torch.int16 if x.dtype == torch.bfloat16  # noqa
                            else torch.int32)
    cb = t["conv_bias"].to(t["v"].dtype)
    with torch.no_grad():
        mean, _, mul, _ = epi.train_stats_cuda(t["v"], t["weight"], cb)
        own = epi.epilogue_ref(t["v"], mean, mul, t["bias"],
                               t["skip"] if skip else None, cb)
    own_apart = float((bits(own) != bits(got["y"])).sum())
    del own
    u = (t["v"] + cb[:, None, None]).double()
    ex2 = (u * u).mean(dim=(0, 2, 3))
    del u
    gates = {
        "y_own_statistics_apart": (own_apart, 0.0),
        "mean": (float((d["mean"] / ex2.sqrt()).max()), 1e-5),
        "var": (float((d["var"] / ex2).max()), 1e-5),
        "y_share_apart": (float((got["y"] != want["y"]).float().mean()),
                          0.01),
        "dweight": (err["dweight"], 1e-3),
        "dbias": (err["dbias"], 1e-3),
        "dconv_bias": (float(d["dconv_bias"].max()), 2.0 ** -6 * float(
            want["dv"].double().abs().sum((0, 2, 3)).max())),
        "calls_apart": (float(sum(not torch.equal(bits(got[k]),
                                                  bits(again[k]))
                                  for k in got)), 0.0),
    }
    for k, casts in (("y", 2 if skip else 1), ("dv", 1)):
        tol = casts * 2.0 ** -7 * want[k].double().abs() + 1e-3 * top[k]
        gates[k] = (float((d[k] / tol).max()), 1.0)
    if skip:
        gates["dskip"] = (float((bits(got["dskip"]) != bits(want["dskip"]))
                                .sum()), 0.0)
    err["y_share_apart"] = gates["y_share_apart"][0]
    return err, gates


def train_epilogue_rows(phase: dict) -> list:
    """The kernels line's rows of the learner's epilogue kernels: the
    forward pair and the backward pair at 19x19 C = 256 B = 2048."""
    hw, C, B = TRAIN_EPI_SHAPES[0]
    t = phase["timings"]
    rows = []
    for what in ("forward", "backward"):
        r = t[f"{hw}x{hw} B={B} plain {what}"]
        plain = t[f"{hw}x{hw} B={B} plain plain"]
        rows.append({
            "name": f"net_train_{what}", "route": "cuda",
            "source": "elf_tpu_torch/csrc/net_train_epilogue.cu"
                      + (" + net_epilogue.cu" if what == "forward" else ""),
            "replaces": None, "launches": phase["step"]["launches"],
            "ms": r["ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "plain_ms": plain["forward_ms"] if what == "forward"
            else plain["forward_backward_ms"] - plain["forward_ms"],
            "library_ms": None, "host_ms": r["host_ms"],
            "shape": f"{hw}x{hw} C={C} B={B}, no skip",
            "by_shape": {k: v for k, v in t.items() if what in k},
        })
    return rows


def train_epilogue_phase(card: str) -> dict:
    """The learner's epilogue kernels (`csrc/net_train_epilogue.cu` with
    the serving epilogue kernel, through `train_epilogue_cuda`) against
    the plain chain's autograd at 19x19 C = 256 B = 2048 and 13x13 C = 128
    B = 1536, with and without the skip (the card tests hold the
    tolerances); a second call equal bit for bit; then at 19x19 C = 256 B
    = 2048 the forward pair (statistics + apply) and the backward pair
    (reduce + apply) timed by graph replay beside their byte bounds (each
    input read and each output written once at 3.35 TB/s), their host cost
    per call and the plain chain's forward and forward + backward; last,
    the 20b256c remat step at batch 2048 with the kernels against the
    modules (selected by a BN that normalises its channels as a slice, a
    mesh attribute), in turns, with its peak memory and its top kernels."""
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models import epilogue as epi
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint

    checks, timings = {}, {}
    for hw, C, B in TRAIN_EPI_SHAPES:
        t = train_epilogue_inputs(B, C, hw, seed=C)
        for skip in (False, True):
            e, gates = train_epilogue_errors(t, skip)
            where = f"{hw}x{hw} C={C} B={B} {'skip' if skip else 'plain'}"
            checks[where] = dict(e, gates=gates)
            over = {k: v for k, v in gates.items() if not v[0] <= v[1]}
            if over:
                fail(f"train epilogue: the kernels differ from the plain "
                     f"chain at {where}: (value, limit) {over}")
            log(f"train epilogue: {where}: against the plain chain, largest "
                f"difference over the largest value: "
                + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                + "; gates (value / limit): "
                + ", ".join(f"{k} {v:.3g} / {lim:.3g}"
                            for k, (v, lim) in gates.items()))
        del t
        torch.cuda.empty_cache()

    hw, C, B = TRAIN_EPI_SHAPES[0]
    t = train_epilogue_inputs(B, C, hw, seed=1)
    n = t["v"].numel()
    vec = C * 4
    for skip in (False, True):
        args = (t["v"], t["weight"], t["bias"], t["skip"] if skip else None,
                t["conv_bias"])
        cb = t["conv_bias"].to(torch.bfloat16)
        with torch.no_grad():
            mean, var, mul, gate = epi.train_stats_cuda(t["v"], t["weight"],
                                                        cb)
            out = epi.epilogue_cuda(t["v"], mean, mul, t["bias"], args[3], cb)
        bargs = (t["v"], cb, mean, var, mul, gate, t["bias"],
                 out if skip else None, t["up"])

        def fwd():
            with torch.no_grad():
                epi.train_epilogue_cuda(*args)

        def bwd():
            epi.train_grad_cuda(*bargs)

        def plain_fwd():
            with torch.no_grad():
                epi.train_epilogue_ref(*args)

        def plain_both():
            ins = [a.detach().requires_grad_(True) if a is not None else None
                   for a in args]
            epi.train_epilogue_ref(*ins)[0].backward(t["up"])

        form = "skip" if skip else "plain"
        # forward: v, bias terms (and skip) read, y written; backward: v,
        # g (and the output) read, d v (and d skip) written; vectors aside
        nbytes = {"forward": n * 2 * (3 if skip else 2) + 4 * vec,
                  "backward": n * 2 * (5 if skip else 3) + 8 * vec}
        for what, fn in (("forward", fwd), ("backward", bwd)):
            ms = [graph_ms(fn, 20) for _ in range(2)]
            r = dict(bytes=nbytes[what],
                     bound_ms=nbytes[what] / HBM_BYTES_PER_S * 1e3,
                     ms=float(np.mean(ms)), ms_turns=ms,
                     host_ms=host_ms(fn, 100))
            r["bound_share"] = r["bound_ms"] / r["ms"]
            timings[f"{hw}x{hw} B={B} {form} {what}"] = r
            log(f"train epilogue: {hw}x{hw} C {C} B {B} {form} {what} pair: "
                f"device {r['ms']:.6f} ms (graph replay; turns "
                f"{', '.join(f'{v:.6f}' for v in ms)}), bound "
                f"{r['bound_ms']:.6f} ms ({r['bytes']} bytes; "
                f"{100 * r['bound_share']:.1f} % of it), host "
                f"{r['host_ms']:.6f} ms/call")
        plain = dict(forward_ms=cuda_time_ms(plain_fwd, 5),
                     forward_backward_ms=cuda_time_ms(plain_both, 5))
        timings[f"{hw}x{hw} B={B} {form} plain"] = plain
        log(f"train epilogue: {hw}x{hw} C {C} B {B} {form}: the plain chain "
            f"{plain['forward_ms']:.4f} ms forward, "
            f"{plain['forward_backward_ms']:.4f} ms forward + backward "
            "(CUDA events)")
    del t, args, bargs, out
    torch.cuda.empty_cache()

    # the remat step at batch 2048, kernels against the modules
    cfg = dataclasses.replace(ModelConfig(), remat=True)
    tr = Trainer(cfg, TrainOptions(batchsize=REMAT_BATCH), device="cuda")
    batch = synthetic_batch(REMAT_BATCH, 3)
    states = {}
    for kind in ("kernels", "modules"):
        st = load_checkpoint(str(ROOT / "runs/prove19/export-best.bin"),
                             tr.init_state(torch.Generator().manual_seed(0)))
        if kind == "modules":
            st.net.blocks[0].bn1.channels = slice(None)
        if st.net.takes_train_epilogues(batch[0], True) != (
                kind == "kernels"):
            fail(f"train epilogue: the {kind} state takes the wrong path")
        states[kind] = st
    step = {"kernels": [], "modules": []}
    peak = {}
    for kind in ("modules", "kernels", "kernels", "modules"):
        med, ms, pk, _ = time_steps(tr, states[kind], batch, 1, 3)
        step[kind].append(med)
        peak[kind] = max(peak.get(kind, 0), pk)
    launched = dict(epi.launches)
    prof = profile_call(lambda: tr.make_train_step()(states["kernels"],
                                                     *batch),
                        f"one remat step at B {REMAT_BATCH} with the "
                        "learner's epilogue kernels", card)
    ran = {k: epi.launches[k] - launched[k] for k in launched}
    if ran["net_train_stats"] != 81 or ran["net_train_grad"] != 41:
        fail(f"train epilogue: a remat step launched {ran}, expected 81 "
             "statistics and 41 backward launches")
    if any("nchwToNhwc" in k or "nhwcToNchw" in k
           for k, _ in prof["top_kernels_ms"]):
        fail("train epilogue: a cuDNN layout transpose among the step's "
             "top kernels")
    kern = float(np.mean(step["kernels"]))
    mods = float(np.mean(step["modules"]))
    log(f"train epilogue: the 20b256c remat step at B {REMAT_BATCH}: "
        f"kernels {kern:.2f} ms ({REMAT_BATCH / kern * 1e3:.1f} positions/s,"
        f" peak {peak['kernels'] / 2 ** 30:.2f} GiB), modules {mods:.2f} ms "
        f"({REMAT_BATCH / mods * 1e3:.1f} positions/s, peak "
        f"{peak['modules'] / 2 ** 30:.2f} GiB), x {mods / kern:.3f} "
        f"(CUDA events, medians of 3 in turns); launches a step {ran}, "
        f"on {card}")
    del tr, states, batch
    torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings,
            "step": dict(ms=step, peak_bytes=peak, launches=ran,
                         profile=prof)}


# ---------------------------------------------------------------------------
# phase 3b': the nested-bottleneck net's learner kernels
# ---------------------------------------------------------------------------

NBT_TRAIN_MODES = ("normact", "skip", "row", "gpool", "value")
NBT_TRAIN_WIDTHS = (192, 384)
# activation elements each pass must move once (the forward: statistics and
# apply as one pass; the backward: reduce and apply as one), by mode
NBT_TRAIN_UNITS = {"normact": (2, 3), "skip": (4, 4), "row": (2, 3),
                   "gpool": (1, 2), "value": (1, 2)}


def nbt_train_errors(mode: str, outs, stats, want_stats, own, got, ref,
                     x) -> dict:
    """The nbt learner's kernels against their plain versions on one
    layer: the statistics and the forward must agree bit for bit, the
    backward within the card tests' bf16 tolerances (d v: 2^-7 of the
    value plus 1e-3 of the largest; the weight's and bias's gradients 1e-4
    of the largest; the row bias's that plus 2^-20 of the sum of the
    board's |d v|); `fail` beyond them.  Returns the largest absolute
    differences."""
    where = f"nbt train: {mode} {tuple(x.shape)}"
    if not all(torch.equal(a, b) for a, b in zip(stats, want_stats)):
        fail(f"{where}: the statistics differ from the plain version's")
    if not all(torch.equal(a, b) for a, b in zip(outs, own)):
        fail(f"{where}: the forward differs from the plain apply's")

    def over(a, b, tol_rel, tol_top, extra=0.0):
        a, b = a.double(), b.double()
        bound = tol_rel * b.abs() + tol_top * float(b.abs().max()) + extra
        return float((a - b).abs().max()), bool(((a - b).abs() > bound).any())

    e = {"forward": max(float((a.double() - b.double()).abs().max())
                        for a, b in zip(outs, own))}
    e["d_v"], bad = over(got[0], ref[0], 2.0 ** -7, 1e-3)
    for name, a, b in zip(("d_weight", "d_bias"), got[1:3], ref[1:3]):
        e[name], worse = over(a, b, 0.0, 1e-4)
        bad |= worse
    if mode == "row":
        terms = ref[0].double().abs().sum((2, 3))
        e["d_rowbias"], worse = over(got[3], ref[3], 0.0, 1e-4,
                                     2.0 ** -20 * terms)
        bad |= worse
    if bad:
        fail(f"{where}: the backward differs from the plain version's "
             f"beyond the tolerances: largest differences {e}")
    return e


def nbt_step_grads(net, batch) -> list:
    """Each parameter's gradient norm of one training step's loss on
    `batch`; the net's running statistics are put back after it."""
    from elf_tpu_torch.training.loss import mcts_prediction_loss

    buffers = {k: b.clone() for k, b in net.named_buffers()}
    log_pi, value = net(batch[0], train=True)
    loss, _ = mcts_prediction_loss(log_pi, value, batch[1], batch[2])
    grads = torch.autograd.grad(loss, list(net.parameters()))
    net.load_state_dict(buffers, strict=False)
    return [float(g.norm()) for g in grads]


def nbt_grad_gaps(got: list, want: list) -> dict:
    """The learner cell's gradient gaps (`perfbench/harness/train.py`)
    between two steps' gradient norms by leaf: the worst leaf against the
    larger of its own and the median leaf's norm, and the norm over all
    leaves, leaves under a thousandth of the median left out."""
    med = float(np.median(want))
    moved = [i for i, w in enumerate(want) if w >= 1e-3 * med]

    def glob(norms):
        return float(np.sqrt(sum(norms[i] ** 2 for i in moved)))

    return {"grad_gap": max(abs(got[i] - want[i]) / max(want[i], med)
                            for i in moved),
            "grad_gap_global": abs(glob(got) - glob(want)) / glob(want)}


def nbt_train_phase(card: str) -> dict:
    """The nbt learner's norm kernels (`csrc/nbt_train_epilogue.cu`, the
    serving `nbt_normact_kernel` / `nbt_pool_kernel` for the apply pass)
    at 19x19 B = 2048, bf16, mish, each mode at 192 and 384 channels:
    first their values against the plain versions (`nbt_train_errors`:
    statistics and forward bit for bit, the backward within the card
    tests' tolerances); then the forward (statistics + apply) and the
    backward (reduce + apply) timed by graph replay beside their byte
    bounds (each activation read and written once a pair at 3.35 TB/s;
    the row bias and pooled vectors aside), their host cost per call, and
    the torch ops' forward and forward + backward (the training forward
    without the kernels, on the card); last, b18c384nbt's remat step at
    batch 2048 on the kernels against the torch ops (the net's
    `train_kernels` off), in turns, with its peak memory, launches and
    counters, its gradients against the torch ops' by the learner cell's
    gap limits, and one step profiled."""
    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch import profiling
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models import epilogue as epi
    from elf_tpu_torch.models import nbt
    from elf_tpu_torch.models.resnet import BatchNorm
    from elf_tpu_torch.training.trainer import Trainer

    timings, errors = {}, {}
    B, hw = REMAT_BATCH, 19
    for C in NBT_TRAIN_WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(C)
        shape = (B, C, hw, hw)

        def act_like():
            return torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)

        v, skip, up = act_like(), act_like(), act_like()
        rowbias = torch.randn(B, C, generator=g, device="cuda") * 0.3
        weight = torch.randn(C, generator=g, device="cuda") * 0.3 + 1.0
        bias = torch.randn(C, generator=g, device="cuda") * 0.3
        gp = torch.randn(B, 3 * C, generator=g, device="cuda")
        n = v.numel()
        for mode in NBT_TRAIN_MODES:
            pool = mode in ("gpool", "value")
            kw = dict(skip=skip if mode == "skip" else None,
                      rowbias=rowbias if mode == "row" else None)

            def fwd():
                with torch.no_grad():
                    if pool:
                        return epi.nbt_train_pool(v, weight, bias, "mish",
                                                  mode)
                    return epi.nbt_train_normact(v, weight, bias, "mish",
                                                 **kw)

            *outs, mean, var = fwd()
            stats = epi.nbt_train_stats_cuda(v, weight, kw["skip"],
                                             kw["rowbias"])
            _, _, mul, gate = stats
            want_stats = epi.nbt_train_stats_ref(
                v, weight, kw["skip"], kw["rowbias"],
                epi.nbt_train_layout(v, kw["rowbias"] is not None))
            if pool:
                own = [epi.pool_ref(v, mean, mul, bias, "mish", mode)]
            else:
                own = epi.normact_ref(v, mean, mul, bias, "mish",
                                      kw["skip"], kw["rowbias"])
                own = list(own) if mode == "skip" else [own]
            x = outs[0] if mode == "skip" else v
            if pool:
                dmean, dmax = epi.pooled_grads(gp, hw * hw, mode)
                gargs = (mode, "mish", x, None, mean, var, mul, gate, bias,
                         None, None, dmean, dmax)
            else:
                gargs = (mode, "mish", x, kw["rowbias"], mean, var, mul,
                         gate, bias, up, up if mode == "skip" else None,
                         None, None)

            e = nbt_train_errors(
                mode, [*outs, mean, var], stats, want_stats,
                [*own, stats[0], stats[1]], epi.nbt_train_grad_cuda(*gargs),
                epi.nbt_train_grad_ref(*gargs), x)
            errors[f"{mode} C={C}"] = e
            log(f"nbt train: {hw}x{hw} B {B} C {C} {mode}: against the plain "
                "version, statistics and forward bit for bit; largest "
                "differences " + ", ".join(f"{k} {val:.3g}"
                                           for k, val in e.items()))
            del stats, want_stats, own

            def bwd():
                epi.nbt_train_grad_cuda(*gargs)

            def torch_ops(backward: bool):
                norm = BatchNorm(C).cuda()
                ins = [t.detach().requires_grad_(backward) if t is not None
                       else None for t in (v, kw["skip"], kw["rowbias"])]
                with torch.set_grad_enabled(backward):
                    ep = nbt._Training("mish", kernels=False)
                    out = (ep.pool(ins[0], norm, mode) if pool else
                           ep.normact(ins[0], norm, ins[1], ins[2]))
                    if backward:
                        out = out[-1] if isinstance(out, tuple) else out
                        out.backward(gp if pool else up)

            units = NBT_TRAIN_UNITS[mode]
            extra = B * C * 4 if mode == "row" else 0
            nbytes = {"forward": n * 2 * units[0] + extra,
                      "backward": n * 2 * units[1] + 2 * extra}
            for what, fn in (("forward", fwd), ("backward", bwd)):
                ms = [graph_ms(fn, 10) for _ in range(2)]
                r = dict(bytes=nbytes[what],
                         bound_ms=nbytes[what] / HBM_BYTES_PER_S * 1e3,
                         ms=float(np.mean(ms)), ms_turns=ms,
                         host_ms=host_ms(fn, 50))
                r["bound_share"] = r["bound_ms"] / r["ms"]
                timings[f"{mode} C={C} {what}"] = r
                log(f"nbt train: {hw}x{hw} B {B} C {C} {mode} {what}: "
                    f"device {r['ms']:.6f} ms (graph replay; turns "
                    f"{', '.join(f'{t:.6f}' for t in ms)}), bound "
                    f"{r['bound_ms']:.6f} ms ({r['bytes']} bytes; "
                    f"{100 * r['bound_share']:.1f} % of it), host "
                    f"{r['host_ms']:.6f} ms/call")
            plain = dict(forward_ms=cuda_time_ms(lambda: torch_ops(False), 3),
                         forward_backward_ms=cuda_time_ms(
                             lambda: torch_ops(True), 3))
            timings[f"{mode} C={C} torch ops"] = plain
            log(f"nbt train: {hw}x{hw} B {B} C {C} {mode}: the torch ops "
                f"{plain['forward_ms']:.4f} ms forward, "
                f"{plain['forward_backward_ms']:.4f} ms forward + backward "
                "(CUDA events)")
        del v, skip, up, rowbias, gp, outs, gargs
        torch.cuda.empty_cache()

    # b18c384nbt's remat step at batch 2048, kernels against torch's ops
    cfg = nbt.NbtConfig(remat=True)
    tr = Trainer(cfg, TrainOptions(batchsize=B), device="cuda")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = synthetic_batch(B, 5)
    step = {"kernels": [], "torch ops": []}
    peak = {}
    for kind in ("torch ops", "kernels", "kernels", "torch ops"):
        state.net.train_kernels = kind == "kernels"
        med, ms, pk, _ = time_steps(tr, state, batch, 1, 3)
        step[kind].append(med)
        peak[kind] = max(peak.get(kind, 0), pk)
    with open(ROOT / "perfbench" / "limits"
              / "go19_b18c384nbt_learner.train_family_b2048.json") as f:
        limits = json.load(f)
    state.net.train_kernels = False
    want = nbt_step_grads(state.net, batch)
    state.net.train_kernels = True
    gaps = nbt_grad_gaps(nbt_step_grads(state.net, batch), want)
    over = {k: (g, limits[k]) for k, g in gaps.items() if not g <= limits[k]}
    if over:
        fail(f"nbt train: the remat step's gradients on the kernels differ "
             f"from the torch ops' beyond the learner cell's limits: (gap, "
             f"limit) {over}")
    log(f"nbt train: the b18c384nbt remat step at B {B}, kernels against "
        f"torch ops: grad_gap {gaps['grad_gap']:.6f} (limit "
        f"{limits['grad_gap']}), grad_gap_global "
        f"{gaps['grad_gap_global']:.6f} (limit {limits['grad_gap_global']})")
    launched = dict(epi.launches)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tr.make_train_step()(state, *batch)
        torch.cuda.synchronize()
    counters = profiling.counters()
    profiling.reset()
    ran = {k: epi.launches[k] - launched[k] for k in launched}
    want = {"net.train_normacts": 232, "net.train_normact_kernels": 232,
            "net.train_normact_grads": 118, "net.train_gpools": 14}
    if counters != want or ran["nbt_train_stats"] != 232 \
            or ran["nbt_train_grad"] != 118:
        fail(f"nbt train: a remat step counted {counters} and launched "
             f"{ran}, expected {want}")
    prof = profile_call(lambda: tr.make_train_step()(state, *batch),
                        f"one b18c384nbt remat step at B {B} on the "
                        "learner's kernels", card)
    kern = float(np.mean(step["kernels"]))
    ops = float(np.mean(step["torch ops"]))
    log(f"nbt train: the b18c384nbt remat step at B {B}: kernels "
        f"{kern:.2f} ms ({B / kern * 1e3:.1f} positions/s, peak "
        f"{peak['kernels'] / 2 ** 30:.2f} GiB), torch ops {ops:.2f} ms "
        f"({B / ops * 1e3:.1f} positions/s, peak "
        f"{peak['torch ops'] / 2 ** 30:.2f} GiB), x {ops / kern:.3f} (CUDA "
        f"events, medians of 3 in turns); launches a step {ran}, on {card}")
    del tr, state, batch
    torch.cuda.empty_cache()
    return {"timings": timings, "errors": errors,
            "step": dict(ms=step, peak_bytes=peak, launches=ran,
                         counters=counters, gaps=gaps, profile=prof)}


def nbt_train_rows(phase: dict) -> list:
    """The kernels line's rows of the nbt learner's kernels: each mode's
    forward and backward at 19x19 B = 2048, C = 192."""
    t, rows = phase["timings"], []
    for mode in NBT_TRAIN_MODES:
        ops = t[f"{mode} C=192 torch ops"]
        for what in ("forward", "backward"):
            r = t[f"{mode} C=192 {what}"]
            e = phase["errors"][f"{mode} C=192"]
            rows.append({
                "name": f"nbt_train_{mode}_{what}", "route": "cuda",
                "max_abs_err": e["forward"] if what == "forward"
                else max(v for k, v in e.items() if k != "forward"),
                "source": "elf_tpu_torch/csrc/nbt_train_epilogue.cu"
                          + (" + nbt_epilogue.cu" if what == "forward"
                             else ""),
                "replaces": None, "launches": phase["step"]["launches"],
                "ms": r["ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "plain_ms": ops["forward_ms"] if what == "forward"
                else ops["forward_backward_ms"] - ops["forward_ms"],
                "library_ms": None, "host_ms": r["host_ms"],
                "shape": f"19x19 C=192 B={REMAT_BATCH} bf16 mish"})
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the nested-bottleneck net's epilogue kernels
# ---------------------------------------------------------------------------

NBT_SHAPES = ((1, 120), (32, 120), (2048, 120))      # (B, plies)
NBT_CALIBRATE = 256
NBT_FLOOR = 0.7             # each mode's share of its byte bound at B = 2048


def nbt_calibrated_net():
    """b18c384nbt at 19x19 with seeded weights, each norm's running
    statistics set to the batch moments of its input over mid-game
    positions (forward pre-hooks on one module forward)."""
    from elf_tpu_torch.models import nbt
    from elf_tpu_torch.models.resnet import BatchNorm

    net = nbt.build_model(nbt.NbtConfig(), "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    hooks = []

    def set_moments(bn, inputs):
        x = inputs[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g,
                                                     device="cuda"))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g,
                                               device="cuda"))
                hooks.append(m.register_forward_pre_hook(set_moments))
        net(midgame_features(NBT_CALIBRATE, 19, 120, seed=7))
    for h in hooks:
        h.remove()
    return net


def nbt_mode(call: str, args: dict) -> str:
    if call == "pool":
        return f"pool {args['kind']}"
    if args.get("skip") is not None:
        return "skip"
    return "row" if args.get("rowbias") is not None else "normact"


def nbt_bytes(call: str, args: dict) -> int:
    """Each input read once, each output written once."""
    v = args["v"]
    n, C = v.numel(), v.shape[1]
    e = v.element_size()
    consts = 3 * 4 * C
    if call == "pool":
        return n * e + v.shape[0] * 3 * C * 4 + consts
    if args.get("skip") is not None:
        return 4 * n * e + consts
    row = 0 if args.get("rowbias") is None else args["rowbias"].numel() * 4
    return 2 * n * e + row + consts


def nbt_convs(net, x) -> list:
    """Each convolution of one forward of `net` on x, in call order:
    (module name, input, output)."""
    from elf_tpu_torch.models.resnet import Conv

    rec = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: rec.append((name, i[0], o)))
        for name, m in net.named_modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return rec


def nbt_first_divergence(a, b, x) -> dict:
    """Where forwards of two copies of one net on x first give other bits:
    the first convolution (in a's call order) whose input ("input": an
    epilogue, a pool or a cast before it) or, given equal inputs, whose
    output ("output": the convolution itself) differs; None where all
    agree."""
    ra, rb = nbt_convs(a, x), nbt_convs(b, x)
    by_name = {name: (i, o) for name, i, o in rb}
    for k, (name, i, o) in enumerate(ra):
        ib, ob = by_name[name]
        if not torch.equal(i, ib):
            return dict(conv=k, name=name, at="input")
        if not torch.equal(o, ob):
            return dict(conv=k, name=name, at="output",
                        max_abs=float((o.float() - ob.float()).abs().max()))
    return None


def nbt_phase(card: str) -> dict:
    """The nbt net's epilogue kernels against their plain versions at
    every epilogue of its serving forward; the serving forward against
    the modules'; each mode timed by graph replay beside its byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch import _build, profiling
    from elf_tpu_torch.models import epilogue as epi
    from elf_tpu_torch.models import nbt
    from elf_tpu_torch.models.resnet import serving_copy

    t0 = time.perf_counter()
    path, text = _build.build("nbt_epilogue")
    log(f"nbt: build {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            log(f"nbt: build: {line.strip()}")
    net = nbt_calibrated_net()
    frozen = serving_copy(net)
    today = copy.deepcopy(net).requires_grad_(False)
    # the serving copy's own modules: its bf16 channels_last weights and
    # the modules' forward, no epilogue
    modules = copy.deepcopy(frozen)
    modules.serves = False
    exact = nbt.NestedBottleneckNet(
        dataclasses.replace(net.cfg, use_bf16=False)).cuda()
    exact.load_state_dict(net.state_dict())
    exact.requires_grad_(False)
    if not frozen.serves:
        fail("nbt: the serving copy has no serving path")
    pairs = {"normact": (epi.normact_cuda, epi.normact_ref),
             "pool": (epi.pool_cuda, epi.pool_ref)}
    checks, forward, timed = {}, {}, {}

    def checker(call, B):
        kernel, plain = pairs[call]

        def run(*a, **kw):
            names = (["v", "mean", "mul", "bias", "act"]
                     + (["kind"] if call == "pool" else ["skip", "rowbias"]))
            args = dict(zip(names, a), **kw)
            got = kernel(**args)
            want = plain(**args)
            torch.cuda.synchronize()
            both = zip(got, want) if isinstance(got, tuple) else [
                (got, want)]
            for x, y in both:
                bits = torch.int16 if x.dtype == torch.bfloat16 else \
                    torch.int32
                if x.dtype != y.dtype or x.shape != y.shape or not \
                        torch.equal(x.view(bits), y.view(bits)):
                    fail(f"nbt: the {nbt_mode(call, args)} kernel differs "
                         f"from its plain version at B {B}, C "
                         f"{args['v'].shape[1]}")
                if x.dim() == 4 and not x.is_contiguous(
                        memory_format=torch.channels_last):
                    fail("nbt: a kernel output is not channels_last")
            key = f"{nbt_mode(call, args)} C={args['v'].shape[1]}"
            checks.setdefault(f"B={B}", {}).setdefault(key, 0)
            checks[f"B={B}"][key] += 1
            if B == NBT_SHAPES[-1][0] and key not in timed:
                timed[key] = (call, args)
            return want

        return run

    for B, plies in NBT_SHAPES:
        x = midgame_features(B, 19, plies, seed=B)
        saved = nbt.normact, nbt.pool
        nbt.normact, nbt.pool = checker("normact", B), checker("pool", B)
        try:
            with torch.no_grad():
                frozen.serve(x)
        finally:
            nbt.normact, nbt.pool = saved
        with torch.no_grad():
            new = frozen(x)
            own = modules(x)
            old = today(x)
            again = today(x)
            fp32 = exact(x)
        torch.cuda.synchronize()

        def gap(a, b):
            return [float((u - w).abs().max()) for u, w in zip(a, b)]

        def bitwise(a, b):
            return all(torch.equal(u, w) for u, w in zip(a, b))

        n = sum(checks[f"B={B}"].values())
        if n != 118:
            fail(f"nbt: {n} epilogues in a forward at B {B}, not 118")
        # the serving path is the modules' arithmetic: on the same bf16
        # channels_last weights the two forwards agree bit for bit
        if not bitwise(new, own):
            fail(f"nbt: the serving forward at B {B} differs from its own "
                 f"modules' by {gap(new, own)}; first divergence "
                 f"{nbt_first_divergence(modules, frozen, x[:32])}")
        # against the modules of the fp32-master net (weights cast to bf16
        # at each call, NCHW): where they part, a convolution given equal
        # inputs must be the first to give other bits
        where = None
        if B <= 32 and not bitwise(new, old):
            where = nbt_first_divergence(today, frozen, x)
            if not where or where["at"] != "output":
                fail(f"nbt: the serving forward at B {B} parts from the "
                     f"modules' other than at a convolution: {where}")
        err = gap(new, old)
        forward[f"B={B}"] = dict(
            log_pi_max_abs=err[0], value_max_abs=err[1],
            bitwise=bitwise(new, old), bitwise_own_modules=True,
            modules_repeat_bitwise=bitwise(old, again),
            first_divergence=where, serving_to_fp32=gap(new, fp32),
            modules_to_fp32=gap(old, fp32))
        log(f"nbt: B {B}: every kernel equal to its plain version bit for "
            f"bit ({checks[f'B={B}']}); serving forward bit for bit equal "
            f"to the serving copy's modules'; against the fp32-master "
            f"net's modules: log_pi {err[0]:.3g}, value {err[1]:.3g} max "
            f"abs ({'bit for bit' if bitwise(new, old) else 'not bit for bit'}"
            f"; first divergence {where}; those modules twice "
            f"{'bit for bit' if bitwise(old, again) else 'not bit for bit'})"
            f"; against the fp32 forward: serving {gap(new, fp32)}, modules "
            f"{gap(old, fp32)}")

    B = NBT_SHAPES[-1][0]
    x = midgame_features(B, 19, 120, seed=B)
    profiling.reset()
    launched = dict(epi.launches)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        frozen(x)
        torch.cuda.synchronize()
    counts = profiling.counters()
    profiling.reset()
    ran = {k: epi.launches[k] - launched[k] for k in launched}
    if counts != {"net.forwards": 1, "net.epilogues": 118, "net.gpools": 8} \
            or ran != {"net_epilogue": 0, "net_train_stats": 0,
                       "net_train_grad": 0, "nbt_normact": 110,
                       "nbt_pool": 8, "nbt_train_stats": 0,
                       "nbt_train_grad": 0}:
        fail(f"nbt: counters {counts}, kernel launches {ran} for one "
             "forward")
    kernels_ms = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and e.key.split(":")[0] not in ("aten", "cudaLaunchKernel"):
            kernels_ms[e.key[:90]] = t / 1e3
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:12]
    if any("nchwToNhwc" in k or "nhwcToNchw" in k for k in kernels_ms):
        fail("nbt: a cuDNN layout transpose in the serving forward")
    log(f"nbt: B {B} serving forward under the profiler, top device ms: "
        + "; ".join(f"{k} {v:.3f}" for k, v in top))

    timings = {}
    for key, (call, args) in sorted(timed.items()):
        kernel, plain = pairs[call]
        nbytes = nbt_bytes(call, args)
        ms = [graph_ms(lambda: kernel(**args), 50) for _ in range(2)]
        t = dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 ms=float(np.mean(ms)), ms_turns=ms,
                 profiler_ms=profiler_ms(
                     lambda: kernel(**args),
                     "nbt_pool_kernel" if call == "pool"
                     else "nbt_normact_kernel", 50),
                 host_ms=host_ms(lambda: kernel(**args), 200),
                 plain_ms=cuda_time_ms(lambda: plain(**args), 3))
        t["bound_share"] = t["bound_ms"] / t["ms"]
        timings[key] = t
        log(f"nbt: B {B} {key}: device {t['ms']:.6f} ms/launch (graph "
            f"replay; turns {', '.join(f'{v:.6f}' for v in ms)}), bound "
            f"{t['bound_ms']:.6f} ms ({nbytes} bytes; "
            f"{100 * t['bound_share']:.1f} % of it), host "
            f"{t['host_ms']:.6f} ms/call, plain {t['plain_ms']:.4f} ms")
    with torch.no_grad():
        fwd = {"change": [], "today": []}
        for which in ("today", "change", "change", "today"):
            m = frozen if which == "change" else today
            fwd[which].append(cuda_time_ms(lambda: m(x), 3))
    timings["forward"] = fwd
    log(f"nbt: B {B}: the serving forward {np.mean(fwd['change']):.3f} ms, "
        f"the modules' {np.mean(fwd['today']):.3f} ms (CUDA events, in "
        f"turns); peak memory {torch.cuda.max_memory_allocated()} bytes")
    # 70 % of the byte bound for every mode.  A pool's mish costs about 25
    # instructions an element on 2 bytes read, so the card's issue rate
    # holds it under about 79 % of its byte bound (csrc/nbt_epilogue.cu):
    # a pool below 70 % is kept as a miss, a norm-act mode fails
    misses = {k: t["bound_share"] for k, t in timings.items()
              if k != "forward" and t["bound_share"] < NBT_FLOOR}
    for key, share in sorted(misses.items()):
        log(f"nbt: MISS: {key} at {100 * share:.1f} % of its byte bound at "
            f"B {B}, below the {100 * NBT_FLOOR:.0f} % asked")
    if any(not key.startswith("pool") for key in misses):
        fail(f"nbt: norm-act modes below {100 * NBT_FLOOR:.0f} % of their "
             f"byte bound: {misses}")
    return {"checks": checks, "forward": forward, "timings": timings,
            "top_device_ms": top, "misses": misses}


def nbt_slice_phase(card: str) -> dict:
    """Phase 3c's calibrated b18c384nbt drives SelfplayActor through
    `eval_fn_builder` (the slice's B, rollouts and moves): the nbt kernels'
    launches of this run alone against its forwards (110 normact and 8
    pool launches each), the moves replayed on the host."""
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models import epilogue
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    net = nbt_calibrated_net()
    forwards = [0]

    def builder(params, batch_stats):
        fn = eval_fn_builder(params, batch_stats)

        def eval_fn(feats, to_play):
            forwards[0] += 1
            return fn(feats, to_play)

        return eval_fn

    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=SLICE_B, never_resign_prob=1.0),
        MCTSConfig(num_rollouts=SLICE_ROLLOUTS,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.25),
        builder, seed=0, device="cuda",
    )
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    epilogue.launches.update(dict.fromkeys(epilogue.launches, 0))
    move_s = []
    for _ in range(SLICE_MOVES):
        t0 = time.perf_counter()
        records = actor.play_moves(net, None, 1)
        torch.cuda.synchronize()
        move_s.append(time.perf_counter() - t0)
        if records:
            fail("nbt slice: a game ended within the first moves")
    launches = dict(kernels.launch_counts(), **epilogue.launches)
    n = forwards[0]
    want = {"net_epilogue": 0, "nbt_normact": 110 * n, "nbt_pool": 8 * n}
    if n <= 0 or any(launches[k] != v for k, v in want.items()):
        fail(f"nbt slice: launches {launches} for {n} forwards, expected "
             f"{want}")
    if launches["step_analysis"] != (SLICE_ROLLOUTS + 1) * SLICE_MOVES \
            or launches["analyze_libs"] != SLICE_MOVES:
        fail(f"nbt slice: liberty-kernel launches {launches}")
    stones = replay_is_legal(actor.moves, 19)
    if not torch.equal(stones, actor.state.core.stones):
        fail("nbt slice: replayed boards differ from the actor's boards")
    steady = move_s[1:]
    mps = len(steady) / sum(steady)
    out = dict(card=card, boards=SLICE_B, rollouts=SLICE_ROLLOUTS,
               rollouts_per_batch=SLICE_PER_BATCH, moves=SLICE_MOVES,
               forwards=n, first_move_s=move_s[0], steady_move_s=steady,
               rollouts_per_s=mps * SLICE_B * SLICE_ROLLOUTS,
               launches=launches)
    log(f"nbt slice: 19x19 b18c384nbt B {SLICE_B}, {SLICE_ROLLOUTS} "
        f"rollouts, {SLICE_MOVES} moves: {n} forwards, launches {launches} "
        f"(110 nbt_normact and 8 nbt_pool a forward); first move "
        f"{move_s[0]:.3f} s, then {out['rollouts_per_s']:.1f} rollouts/s "
        f"on {card}")
    return out


def nbt_kernel_rows(phase: dict, played: dict) -> list:
    """The kernels line's rows of the two nbt kernels: launches from the
    nbt slice, times at B = 2048 from phase 3c (the widest layer of each:
    normact at C = 192 with mish, the trunk's pool at C = 64)."""
    t = phase["timings"]
    rows = []
    for name, key, modes in (
            ("nbt_normact", "normact C=192", ("normact", "skip", "row")),
            ("nbt_pool", "pool gpool C=64", ("pool",))):
        rows.append({
            "name": name, "route": "cuda",
            "source": "elf_tpu_torch/csrc/nbt_epilogue.cu", "replaces": None,
            "launches": played["launches"][name], "max_abs_err": 0,
            "ms": t[key]["ms"], "plain_ms": t[key]["plain_ms"],
            "bound_ms": t[key]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": f"19x19 {key} B=2048, mish",
            "host_ms": t[key]["host_ms"],
            "by_shape": {k: v for k, v in t.items()
                         if k.startswith(modes)},
        })
    return rows


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
    from elf_tpu_torch.models import epilogue
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
    epilogue.launches.update(dict.fromkeys(epilogue.launches, 0))
    move_s = []
    for _ in range(SLICE_MOVES):
        t0 = time.perf_counter()
        records = actor.play_moves(net, None, 1)
        torch.cuda.synchronize()
        move_s.append(time.perf_counter() - t0)
        if records:
            fail("a game ended within the first moves")
    launches = kernels.launch_counts()
    # every serving forward: 41 trunk epilogues (the first layer, 2 a block)
    n = launches["net_epilogue"] = epilogue.launches["net_epilogue"]
    if n <= 0 or n % (2 * cfg.num_block + 1):
        fail(f"net_epilogue: {n} launches in the slice")

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
        "step_analysis + 1 analyze_libs per move, 41 net_epilogue a "
        "forward)")
    return out, net


_NN_KERNEL_WORDS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90",
                    "wgrad", "dgrad", "fprop")


def profile_move(actor, net, what: str, card: str) -> dict:
    """One more move of `actor` under torch.profiler (`profile_call`)."""
    return profile_call(lambda: actor.play_moves(net, None, 1), what, card)


def profile_call(fn, what: str, card: str) -> dict:
    """`fn()` under torch.profiler: wall time, the device's busy time and
    share, device time by kernel group (the two liberty kernels, the net's
    convolutions and matrix products, everything else), and the launch
    counts of that call alone."""
    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch.env.go import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()

    groups = {"liberty kernels": 0.0, "net conv/gemm": 0.0, "other": 0.0}
    by_name, n_kernels, syncs = {}, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            if e.name.startswith("elf."):
                fail(f"profile: the program's span {e.name} counted as a "
                     "device kernel")
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
    log(f"profile: {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {n_kernels} kernels, {syncs} "
        f"host copies/syncs, liberty-kernel launches {launches}, on {card}")
    for k, v in groups.items():
        log(f"profile:   {k}: {v:.2f} ms")
    for k, v in top:
        log(f"profile:   top {v:8.3f} ms  {k[:90]}")
    return out


def profile_phase(card: str, net) -> dict:
    """Where one slice move spends its time, after the other phases: a
    warm-up move, then one move under torch.profiler (`profile_move`)."""
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
    return profile_move(actor, net, f"one slice move at 19x19 B {SLICE_B}, "
                        f"{SLICE_ROLLOUTS} rollouts", card)


# ---------------------------------------------------------------------------
# phase 6: the learner at full width
# ---------------------------------------------------------------------------


def train_step_flops(cfg, batch: int) -> float:
    """Operations of one train step from the shapes: 2 per multiply-add of
    every convolution and dense layer in the forward pass, times 3 for
    forward, input gradients and weight gradients."""
    n2 = cfg.board_size ** 2
    conv3 = 9 * (cfg.num_planes * cfg.dim
                 + 2 * cfg.num_block * cfg.dim * cfg.dim)
    conv1 = 3 * cfg.dim
    dense = (2 * n2 * cfg.num_actions + n2 * cfg.value_hidden
             + cfg.value_hidden)
    return 3.0 * 2.0 * batch * (n2 * (conv3 + conv1) + dense)


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by name: parameters, BN statistics and
    optimizer slots."""
    out = {f"net/{k}": v for k, v in state.net.state_dict().items()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                out[f"{prefix}/{k}"] = v

    walk(state.opt_state, "opt")
    return out


def train_phase(card: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from elf_tpu_torch.config import ReplayOptions, TrainOptions
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, eval_fn_builder, load_model
    from elf_tpu_torch.native.replayer import (
        replay_to_snapshots,
        replay_to_snapshots_ref,
    )
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint

    size = 19
    weights = str(ROOT / "runs/prove19/export-best.bin")
    cfg = ModelConfig()          # 19x19, 20 blocks, 256 channels, bf16

    # 1. self-play feeds the learner: 32 games cut at 8 moves
    net = load_model(weights, cfg, "cuda")
    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=TRAIN_GAMES, never_resign_prob=1.0,
                    move_cutoff=TRAIN_CUTOFF),
        MCTSConfig(num_rollouts=TRAIN_ROLLOUTS,
                   rollouts_per_batch=TRAIN_PER_BATCH, root_epsilon=0.25),
        eval_fn_builder, seed=3, device="cuda",
    )
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    records = actor.play_moves(net, None, TRAIN_CUTOFF)
    torch.cuda.synchronize()
    selfplay_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = {"step_analysis": (TRAIN_ROLLOUTS + 1) * TRAIN_CUTOFF,
                "analyze_libs": TRAIN_CUTOFF}
    for name, n in expected.items():
        if launches[name] <= 0:
            fail(f"train: {name} was not launched by the self-play")
        if launches[name] != n:
            fail(f"train: {name}: {launches[name]} launches, expected {n}")
    if len(records) != TRAIN_GAMES:
        fail(f"train: {len(records)} records from {TRAIN_GAMES} games")
    log(f"train: self-play B {TRAIN_GAMES}, {TRAIN_ROLLOUTS} rollouts, "
        f"{TRAIN_CUTOFF} moves: {len(records)} records in {selfplay_s:.2f} s, "
        f"launches {launches}")
    del net

    # 2. records -> replay buffer through the C replayer
    pipeline = TrainingPipeline(
        ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                   q_max_size=1000), seed=0), size, seed=0)
    # the first call builds and loads the C replayer: keep that out of the
    # time per record
    t0 = time.perf_counter()
    replay_to_snapshots(np.zeros(1, np.int32), size)
    log(f"train: C replayer built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for r in records:
        pipeline.insert_record(r)
    insert_ms = (time.perf_counter() - t0) * 1e3 / len(records)
    items = [it for q in pipeline.replay.queues for it in q]
    if len(items) != len(records):
        fail("train: the replay buffer does not hold every record")
    for it in items:
        res = it.record.result
        plain = replay_to_snapshots_ref(it.moves, size, it.first_player,
                                        res.setup_black, res.setup_white)
        if len(it.moves) != TRAIN_CUTOFF or \
                not np.array_equal(it.snapshots, plain):
            fail("train: the C replayer differs from its plain version")

    # 3. the learner: committed export onto fp32 masters, fresh optimizer
    opts = TrainOptions(batchsize=TRAIN_BATCH, num_cooldown=TRAIN_COOLDOWN)
    trainer = Trainer(cfg, opts, device="cuda")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runner = LearnerRunner(trainer, pipeline, ckpt_dir, opts, seed=0)
    runner.state = load_checkpoint(weights, runner.state)
    step0 = runner.state.step
    if any(p.dtype != torch.float32 for p in runner.state.net.parameters()):
        fail("train: the master weights are not fp32")
    before = {k: v.clone() for k, v in state_tensors(runner.state).items()}

    def check_stats(stats, where):
        for k, v in stats.items():
            if not np.isfinite(v):
                fail(f"train: {k} = {v} {where}")

    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP):
        stats = runner.run_minibatch()
        if stats is None:
            fail("train: the replay buffer gave no batch")
        check_stats(stats, f"at warm-up step {i}")
    first_stats = stats

    # timed: host batch assembly, device batch, and the step apart
    sample_ms, device_batch_ms, step_ms = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        hb = runner.pipeline.sample_host_batch(opts.batchsize)
        t1 = time.perf_counter()
        batch = runner.pipeline.device_batch(hb, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start.record()
        runner.state, stats = runner._train_step(runner.state, *batch)
        end.record()
        torch.cuda.synchronize()
        sample_ms.append((t1 - t0) * 1e3)
        device_batch_ms.append((t2 - t1) * 1e3)
        step_ms.append(start.elapsed_time(end))
        check_stats({k: float(v) for k, v in stats.items()},
                    f"at timed step {i}")
    # and whole minibatches as the runner runs them, by the host's clock
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        check_stats(runner.run_minibatch(), f"at minibatch {i}")
    torch.cuda.synchronize()
    minibatch_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    peak_bytes = torch.cuda.max_memory_allocated()
    n_steps = TRAIN_WARMUP + 2 * TRAIN_TIMED
    if runner.state.step != step0 + n_steps:
        fail(f"train: step {runner.state.step} after {n_steps} steps from "
             f"{step0}")
    now = state_tensors(runner.state)
    unchanged = [k for k, v in before.items()
                 if k.startswith("net/") and torch.equal(v, now[k])]
    if unchanged:
        fail(f"train: {len(unchanged)} tensors of the net did not change, "
             f"e.g. {unchanged[0]}")

    # repeated steps on one fixed batch lower the loss
    fixed = runner.pipeline.device_batch(
        runner.pipeline.sample_host_batch(opts.batchsize), "cuda")
    fixed_loss = []
    for i in range(TRAIN_FIXED):
        runner.state, stats = runner._train_step(runner.state, *fixed)
        stats = {k: float(v) for k, v in stats.items()}
        check_stats(stats, f"at fixed-batch step {i}")
        fixed_loss.append(stats["loss/total"])
    if not fixed_loss[-1] < fixed_loss[0]:
        fail(f"train: the loss on one fixed batch did not fall: {fixed_loss}")

    # one step under the profiler: the device's busy share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.state, _ = runner._train_step(runner.state, *fixed)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"conv/gemm": 0.0, "other": 0.0}
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            if e.name.startswith("elf."):
                fail(f"profile: the program's span {e.name} counted as a "
                     "device kernel")
            us = e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
            is_nn = any(w in e.name.lower() for w in _NN_KERNEL_WORDS)
            groups["conv/gemm" if is_nn else "other"] += us / 1e3
    busy_ms = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # 4. cooldown + checkpoint
    pre = {k: v.clone() for k, v in state_tensors(runner.state).items()}
    cool0 = torch.cuda.Event(enable_timing=True)
    cool1 = torch.cuda.Event(enable_timing=True)
    feats = fixed[0]
    snapshot = copy.deepcopy(runner.state)
    cool0.record()
    for _ in range(TRAIN_COOLDOWN):
        runner._cooldown_step(snapshot, feats)
    cool1.record()
    torch.cuda.synchronize()
    cooldown_ms = cool0.elapsed_time(cool1) / TRAIN_COOLDOWN
    del snapshot
    version = runner.episode_summary()
    post = state_tensors(runner.state)
    moved = [k for k in pre if not torch.equal(pre[k], post[k])]
    if not moved or not all("running_" in k for k in moved):
        fail("train: the cooldown must change BN statistics and nothing "
             f"else; changed: {moved[:4]}")
    if len(moved) != 2 * (2 * cfg.num_block + 3):
        fail(f"train: the cooldown changed {len(moved)} BN statistics")
    path = Path(ckpt_dir) / f"save-{version}.bin"
    if version != runner.state.step or not path.is_file() or \
            (Path(ckpt_dir) / "latest").resolve() != path.resolve():
        fail(f"train: episode_summary did not write {path.name}")
    back = load_checkpoint(ckpt_dir, runner.state)
    back_t = state_tensors(back)
    if back.step != runner.state.step or back_t.keys() != post.keys():
        fail("train: the checkpoint's structure differs from the state's")
    for k, v in post.items():
        if v.dtype != back_t[k].dtype or not torch.equal(v, back_t[k].to(v.device)):
            fail(f"train: {k} read back from the checkpoint differs")
    ckpt_mb = path.stat().st_size / 1e6

    # the trained file serves: load_model -> one more legal move
    net2 = load_model(str(path), cfg, "cuda")
    actor.play_moves(net2, None, 1)
    stones = replay_is_legal(actor.moves, size)
    if not all(len(m) == 1 for m in actor.moves) or \
            not torch.equal(stones, actor.state.core.stones):
        fail("train: the trained net's move does not replay legally")

    flops = train_step_flops(cfg, TRAIN_BATCH)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    med = float(np.median(step_ms))
    out = dict(
        card=card, batch=TRAIN_BATCH, records=len(records),
        selfplay_s=selfplay_s, launches=launches,
        insert_ms_per_record=insert_ms,
        step_ms_median=med, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        step_ms=step_ms, positions_per_s=TRAIN_BATCH / med * 1e3,
        sample_host_batch_ms=float(np.median(sample_ms)),
        device_batch_ms=float(np.median(device_batch_ms)),
        run_minibatch_ms=minibatch_ms,
        run_minibatch_positions_per_s=TRAIN_BATCH / minibatch_ms * 1e3,
        cooldown_ms=cooldown_ms, peak_memory_bytes=peak_bytes,
        step_flops=flops, bound_ms=bound_ms, bound_share=bound_ms / med,
        profile=dict(wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
                     device_busy_share=busy_ms / prof_wall_ms,
                     groups_ms=groups, device_kernels=n_kernels,
                     top_kernels_ms=top),
        first_stats=first_stats, fixed_batch_loss=fixed_loss,
        checkpoint_mb=ckpt_mb, version=version,
    )
    log(f"train: 19x19 20b256c bf16, fp32 masters, B {TRAIN_BATCH}: step "
        f"{med:.2f} ms median ({min(step_ms):.2f}-{max(step_ms):.2f}, "
        f"{TRAIN_TIMED} steps, CUDA events), "
        f"{out['positions_per_s']:.1f} positions/s, on {card}")
    log(f"train: bound {bound_ms:.3f} ms ({flops / 1e12:.3f} TFLOP per step "
        f"at the dense bf16 peak): the step runs at "
        f"{100 * bound_ms / med:.1f}% of it, on {card}")
    log(f"train: host sample_host_batch {out['sample_host_batch_ms']:.2f} ms, "
        f"device_batch {out['device_batch_ms']:.2f} ms, whole run_minibatch "
        f"{minibatch_ms:.2f} ms ({out['run_minibatch_positions_per_s']:.1f} "
        f"positions/s), insert_record {insert_ms:.3f} ms/record, cooldown "
        f"pass {cooldown_ms:.2f} ms, on {card}")
    log(f"train: peak memory {peak_bytes / 2 ** 30:.2f} GiB "
        f"(max_memory_allocated over the steps), checkpoint "
        f"{ckpt_mb:.1f} MB, version {version}, on {card}")
    log(f"train: one step under the profiler: wall {prof_wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / prof_wall_ms:.1f}%), "
        f"{n_kernels} kernels; conv/gemm {groups['conv/gemm']:.2f} ms, other "
        f"{groups['other']:.2f} ms, on {card}")
    for k, v in top:
        log(f"train:   top {v:8.3f} ms  {k[:90]}")
    log(f"train: loss/total {first_stats['loss/total']:.4f} at warm-up, "
        f"fixed batch {fixed_loss[0]:.4f} -> {fixed_loss[-1]:.4f}; cooldown "
        "changed BN statistics only; checkpoint read back bit for bit; "
        "load_model on it played a legal move")
    for f in Path(ckpt_dir).iterdir():
        f.unlink()
    Path(ckpt_dir).rmdir()
    return out


# ---------------------------------------------------------------------------
# phase 7: the production fleet (train_server + selfplay_client over TCP)
# ---------------------------------------------------------------------------


_STAMP = re.compile(r"^\[(\d\d):(\d\d):(\d\d)\.(\d\d\d)\]")


def log_seconds(line: str) -> float:
    """Seconds since midnight of a log line's `[HH:MM:SS.mmm]` stamp."""
    h, m, s, ms = (int(x) for x in _STAMP.match(line).groups())
    return h * 3600 + m * 60 + s + ms / 1e3


def log_summary(path: Path):
    """The `summary {...}` JSON a fleet process logs at exit, or None."""
    for line in reversed(path.read_text().splitlines()):
        i = line.find("] summary {")
        if i >= 0:
            return json.loads(line[i + len("] summary "):])
    return None


def fleet_phase(card: str) -> dict:
    """One train_server and two selfplay_client processes on this card at
    19x19 20b256c, until EvalSubCtrl decides on the first candidate."""
    import shutil
    import signal

    from elf_tpu_torch.control.transport import ControlClient

    sys.path.append(str(ROOT / "scripts"))
    from prove_production_torch import free_port, stop_all, wait_in_log

    run_dir = ROOT / "build" / "chip_smoke_fleet"
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt = run_dir / "ckpt"
    ckpt.mkdir(parents=True)
    log_dir = ROOT / "chiprun_out" / "fleet"
    log_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    common = ["--board_size", "19", "--num_block", "20", "--dim", "256",
              "--port", str(port), "--num_rollouts", str(FLEET_ROLLOUTS),
              "--rollouts_per_batch", str(TRAIN_PER_BATCH),
              "--ckpt_dir", str(ckpt)]
    server_cmd = [
        sys.executable, str(ROOT / "scripts/train_server_torch.py"),
        "--load", str(ROOT / "runs/prove19/export-best.bin"),
        "--batchsize", str(TRAIN_BATCH), "--num_minibatch",
        str(FLEET_MINIBATCH), "--num_cooldown", str(TRAIN_COOLDOWN),
        "--expected_num_clients", str(FLEET_CLIENTS),
        "--selfplay_init_num", str(FLEET_INIT),
        "--selfplay_update_num", str(FLEET_INIT),
        "--eval_num_games", str(FLEET_EVAL_GAMES),
        "--num_reader", "2", "--q_min_size", "0", "--q_max_size", "1000",
        "--root_epsilon", "0.25", *common,
    ]
    procs, files = {}, []

    def spawn(name, cmd):
        f = open(log_dir / f"{name}.log", "w")
        files.append(f)
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                       stderr=subprocess.STDOUT, text=True)

    def logs(name) -> str:
        return (log_dir / f"{name}.log").read_text()

    def tails() -> str:
        return "\n".join(f"----- {n} -----\n{logs(n)[-3000:]}" for n in procs)

    def check_alive():
        for n, p in procs.items():
            if p.poll() is not None:
                fail(f"fleet: {n} exited with {p.returncode}\n{tails()}")

    # one clock for the whole phase: seconds since the server's launch, for
    # this process's reads and for the `[HH:MM:SS.mmm]` stamps of the logs
    t_start = time.time()
    lt = time.localtime(t_start)
    t_start_of_day = (lt.tm_hour * 3600 + lt.tm_min * 60 + lt.tm_sec
                      + t_start % 1)

    def stamp_s(line: str) -> float:
        return (log_seconds(line) - t_start_of_day) % 86400

    def server_line(needle: str) -> str:
        return next(l for l in logs("server").splitlines() if needle in l)

    decision = None
    try:
        spawn("server", server_cmd)
        deadline = t_start + FLEET_DEADLINE_S
        if not wait_in_log(str(log_dir / "server.log"), "server up on :",
                           procs["server"], deadline, "server ready"):
            fail(f"fleet: the server was not ready in time\n{tails()}")
        ready_s = stamp_s(server_line("] server up on :"))
        log(f"fleet: server ready in {ready_s:.1f} s (20b256c export loaded "
            "onto fp32 masters, initial checkpoint written)")
        for k in range(FLEET_CLIENTS):
            spawn(f"client{k}", [
                sys.executable, str(ROOT / "scripts/selfplay_client_torch.py"),
                "--num_games", str(FLEET_B),
                "--move_cutoff", str(TRAIN_CUTOFF),
                "--moves_per_round", str(TRAIN_CUTOFF),
                "--seed", str(100 + k), *common])
        poll = ControlClient("127.0.0.1", port, timeout=20.0)
        status, last_poll = [], 0.0
        while decision is None:
            check_alive()
            now = time.time()
            if now > deadline:
                fail(f"fleet: no eval decision in {FLEET_DEADLINE_S} s\n"
                     f"{tails()}")
            for line in logs("server").splitlines():
                if "] PROMOTE eval " in line or "] rejected eval " in line:
                    decision = line
                    break
            # a poll every 5 s, and one as soon as the decision is logged:
            # the games the server had received by then
            if decision is not None or now - last_poll > 5.0:
                last_poll = now
                st = poll.send("status", "")
                if not isinstance(st, dict):
                    fail(f"fleet: status answered {st!r}")
                status.append({"wall_s": time.time() - t_start, **st})
            time.sleep(0.5)
        poll.close()
    finally:
        # clients first (each ends its round and logs its summary), then
        # the server (SIGINT: it stops the control plane and logs its own)
        clean = stop_all([p for n, p in procs.items()
                          if n.startswith("client")], signal.SIGTERM, 60)
        if "server" in procs:
            clean &= stop_all([procs["server"]], signal.SIGINT, 60)
        for f in files:
            f.close()
    if not clean:
        fail(f"fleet: a process had to be killed\n{tails()}")
    for n, p in procs.items():
        if p.returncode != 0:
            fail(f"fleet: {n} exited with {p.returncode}\n{tails()}")

    queued = server_line("] queued candidate ")
    cand = int(queued.split("] queued candidate ")[1].split()[0])
    verdict = "PROMOTE" if "] PROMOTE eval " in decision else "rejected"
    dec_cand = int(decision.split(" eval ")[1].split()[0])
    if dec_cand != cand:
        fail(f"fleet: the first decision is on {dec_cand}, not on the first "
             f"candidate {cand}")
    decided_s = stamp_s(decision)
    notify_to_decision_s = decided_s - stamp_s(queued)
    server = log_summary(log_dir / "server.log")
    clients = {n: log_summary(log_dir / f"{n}.log") for n in procs
               if n.startswith("client")}
    if server is None or any(c is None for c in clients.values()):
        fail(f"fleet: a process logged no summary\n{tails()}")
    journaled = sum(
        sum(1 for line in f.read_text().splitlines() if line.strip())
        for f in (ckpt / "journal").glob("records-*.jsonl"))
    if journaled != server["num_selfplay_games"] or journaled < FLEET_INIT:
        fail(f"fleet: {journaled} records journaled, "
             f"{server['num_selfplay_games']} self-play games accepted")
    if server["num_eval_games"] <= 0:
        fail("fleet: the server received no eval games")
    for n, c in clients.items():
        for k, v in c["kernel_launches"].items():
            if v <= 0:
                fail(f"fleet: {k} was not launched in {n}")
    # the fleet's end-to-end rate: games the server received over the wall
    # window from the first job it handed out to the poll at the decision
    # (model loads, retries, idle polls and waits for the server included)
    first_job_s = stamp_s(server_line("] new client "))
    at_decision = status[-1]
    window_s = at_decision["wall_s"] - first_job_s
    games = at_decision["num_selfplay_games"] + at_decision["num_eval_games"]
    # each client's busy rate, a control-plane layer metric: its games over
    # the time of its rounds and shipping alone
    for c in clients.values():
        busy_s = sum(v["total_s"] for v in c["phases"].values())
        c["busy_games_per_s"] = (c["selfplay_games"] + c["eval_games"]) / busy_s
    eps = server["phases"]["train_episode"]
    cool = server["phases"]["cooldown_checkpoint"]
    out = dict(
        card=card, n_clients=FLEET_CLIENTS, boards=FLEET_B,
        rollouts=FLEET_ROLLOUTS, move_cutoff=TRAIN_CUTOFF,
        batch=TRAIN_BATCH, num_minibatch=FLEET_MINIBATCH,
        ready_s=ready_s, decided_s=decided_s,
        notify_to_decision_s=notify_to_decision_s,
        candidate=cand, decision=verdict, decision_line=decision,
        journaled=journaled,
        train_episode_ms=eps["total_s"] / eps["n"] * 1e3,
        ms_per_step=eps["total_s"] / (eps["n"] * FLEET_MINIBATCH) * 1e3,
        ms_per_step_min=eps["min_s"] / FLEET_MINIBATCH * 1e3,
        cooldown_checkpoint_ms=cool["total_s"] / cool["n"] * 1e3,
        server=server, clients=clients, status=status,
        launches={k: sum(c["kernel_launches"][k] for c in clients.values())
                  for k in ("step_analysis", "analyze_libs")},
        first_job_s=first_job_s, window_s=window_s,
        games_in_window=games, games_per_s=games / window_s,
    )
    log(f"fleet: 1 server + {FLEET_CLIENTS} clients, 19x19 20b256c, B "
        f"{FLEET_B}, {FLEET_ROLLOUTS} rollouts, move_cutoff {TRAIN_CUTOFF}, "
        f"batch {TRAIN_BATCH}, on {card}")
    log(f"fleet: {server['num_selfplay_games']} self-play and "
        f"{server['num_eval_games']} eval games received, {journaled} "
        f"records journaled, {eps['n']} episodes")
    log(f"fleet: server train_episode {out['train_episode_ms']:.1f} ms "
        f"({out['ms_per_step']:.1f} ms per step, host clock, "
        f"{FLEET_MINIBATCH} steps; fastest episode "
        f"{out['ms_per_step_min']:.1f} ms per step), cooldown + checkpoint "
        f"{out['cooldown_checkpoint_ms']:.1f} ms, peak memory "
        f"{server['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    for n, c in clients.items():
        ph = "; ".join(
            f"{k} {v['total_s']:.2f} s over {v.get('rounds', v.get('n'))}"
            + (f", {v['board_moves_per_s']:.2f} moves/s"
               if "board_moves_per_s" in v else "")
            for k, v in c["phases"].items())
        log(f"fleet: {n}: {ph}; {c['selfplay_games']} self-play + "
            f"{c['eval_games']} eval games ({c['busy_games_per_s']:.2f} games/s "
            f"of its rounds and shipping), launches {c['kernel_launches']}, "
            f"peak memory {c['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"fleet: {out['games_per_s']:.2f} games/s received by the server: "
        f"{games} games in {window_s:.1f} s from the first job handed out "
        f"({first_job_s:.1f} s after the server's launch) to the decision "
        f"({TRAIN_CUTOFF}-move games, {FLEET_ROLLOUTS} rollouts), on {card}")
    log(f"fleet: candidate {cand}: {verdict} "
        f"{notify_to_decision_s:.1f} s after notify_new_version "
        f"({decided_s:.1f} s after the server's launch)")
    shutil.rmtree(run_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: record emission
# ---------------------------------------------------------------------------


def golden_actions(name: str, n: int):
    """The first `n` actions of the first game of a golden trajectory."""
    import gzip

    with gzip.open(ROOT / "tests" / "golden" / f"{name}.jsonl.gz", "rt") as f:
        rec = json.loads(f.readline())
    actions = rec["actions"]
    if isinstance(actions, str):
        actions = json.loads(actions)
    return [int(a) for a in actions[:n]]


def record_run(net, size: int, B: int, cutoff: int, preload=(), **opts):
    """9x9 games to `move_cutoff`; every Record survives a JSON round trip
    and replays (after the preloaded moves) to the board the actor
    played.  Returns the records."""
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
    from elf_tpu_torch.selfplay.records import Record

    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=B, never_resign_prob=1.0,
                    move_cutoff=cutoff, **opts),
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
            prefix = replay_is_legal([list(preload) + moves[:-1]], size)
            replay_is_legal([list(preload) + moves], size)
            if not torch.equal(prefix[0], before[r.thread_id]):
                fail("a Record does not replay to the board the actor played")
        records.extend(new)
    if len(records) < B:
        fail(f"only {len(records)} of {B} games emitted records")
    return records


def record_phase() -> dict:
    """Records at 9x9, then the same with persistent trees, an SGF preload
    and SGF dumps: every dump parses back to its record's moves."""
    import shutil

    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import ModelConfig, build_model
    from elf_tpu_torch.sgf import game_from_moves, parse_sgf, serialize_sgf

    size, B, cutoff = 9, 8, 20
    net = build_model(ModelConfig(board_size=size, num_block=2, dim=32),
                      "cuda", seed=1)
    plain = record_run(net, size, B, cutoff)
    log(f"records: {len(plain)} records at 9x9, each round-trips through "
        "JSON and replays to the actor's boards")

    run_dir = ROOT / "build" / "chip_smoke_records"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    preload = golden_actions("ref_traj_9", 10)
    sgf = run_dir / "preload.sgf"
    sgf.write_text(serialize_sgf(game_from_moves(preload, size)))
    played = record_run(net, size, B, cutoff, preload=preload,
                        persistent_tree=True, preload_sgf=str(sgf),
                        dump_record_prefix=str(run_dir / "game"))
    for r in played:
        dumps = list(run_dir.glob(f"game-{r.thread_id}-{r.seq}-*.sgf"))
        if len(dumps) != 1:
            fail(f"{len(dumps)} SGF dumps for board {r.thread_id} game {r.seq}")
        game = parse_sgf(dumps[0].read_text())
        if [m for _, m in game.main_moves()] != sgf_string_to_moves(
                r.result.content, size):
            fail(f"the SGF dump {dumps[0].name} differs from its record")
    log(f"records: {len(played)} more with persistent trees, a 10-move SGF "
        "preload and SGF dumps: each replays after the preload, and each "
        "dump parses back to its record's moves")
    shutil.rmtree(run_dir, ignore_errors=True)
    return {"records": len(plain), "records_play_options": len(played)}


# ---------------------------------------------------------------------------
# phase 8: the play surface (GTP console and SGF analysis at B = 1)
# ---------------------------------------------------------------------------


def gtp_session(card: str) -> dict:
    """scripts/gtp_console_torch.py at 19x19 20b256c with persistent trees:
    a scripted game whose engine moves must replay legally."""
    from elf_tpu_torch.env.go.coords import gtp_to_flat

    commands = [
        "protocol_version", "boardsize 19", "clear_board", "komi 7.5",
        "play B Q16", "genmove W", "play B D4", "genmove W", "genmove B",
        "elf-ladder B C3", "showboard", "undo", "final_score", "quit",
    ]
    cmd = [sys.executable, str(ROOT / "scripts/gtp_console_torch.py"),
           "--load", str(ROOT / "runs/prove19/export-best.bin"),
           "--board_size", "19", "--num_block", "20", "--dim", "256",
           "--num_rollouts", str(PLAY_ROLLOUTS), "--rollouts_per_batch",
           str(SLICE_PER_BATCH), "--persistent_tree", "true", "--seed", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, input="\n".join(commands) + "\n", cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    (ROOT / "chiprun_out" / "play").mkdir(parents=True, exist_ok=True)
    (ROOT / "chiprun_out" / "play" / "gtp.log").write_text(
        proc.stdout + "\n----- stderr -----\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"play: the GTP console exited with {proc.returncode}\n"
             f"{proc.stderr[-3000:]}")
    answers = [a for a in proc.stdout.split("\n\n") if a.strip()]
    if len(answers) != len(commands):
        fail(f"play: {len(answers)} answers to {len(commands)} commands\n"
             f"{proc.stdout}")
    for c, a in zip(commands, answers):
        if a.startswith("?"):
            fail(f"play: '{c}' answered '{a}'")
    reply = dict(zip(commands, answers))
    engine_moves = [answers[i][2:] for i, c in enumerate(commands)
                    if c.startswith("genmove")]
    if "resign" in engine_moves:
        fail(f"play: the engine resigned in the opening: {engine_moves}")
    game = ["Q16", engine_moves[0], "D4", engine_moves[1], engine_moves[2]]
    replay_is_legal([[gtp_to_flat(v, 19) for v in game]], 19)
    summ = json.loads(proc.stderr.strip().splitlines()[-1])
    # tree reuse: every search finds on its root's edges exactly the visits
    # the earlier tree held below the move played into that root, and the
    # third genmove, which follows the engine's own move, starts from some
    # (the second follows the human's D4: its carry is what the first
    # search spent there, which the weights decide)
    carried, expect = summ["carried_visits"], summ["expected_carry"]
    if len(carried) != 3 or carried != expect:
        fail(f"play: carried-over root visits {carried}, the earlier trees "
             f"held {expect} below the played moves")
    if carried[2] <= 0:
        fail(f"play: carried-over root visits {carried}: the third genmove "
             "must start from the subtree of the engine's own move")
    # from the code: every rollout steps the engine once (step_analysis),
    # every played move once more; analyze_libs runs for each play's
    # legality check and for each search whose root is not expanded yet
    plays = sum(c.startswith("play") for c in commands)
    expected = {
        "step_analysis": (summ["rollouts_per_search"] * summ["searches"]
                          + plays + summ["genmoves"]),
        "analyze_libs": plays + sum(not r for r in summ["root_reused"]),
    }
    launches = summ["kernel_launches"]
    for name, n in expected.items():
        if launches[name] != n:
            fail(f"play: GTP {name}: {launches[name]} launches, expected {n}")
    genmove_s = summ["genmove_s"]
    log(f"play: GTP 19x19 20b256c, {PLAY_ROLLOUTS} rollouts in batches of "
        f"{SLICE_PER_BATCH}, persistent trees: moves {game}, score "
        f"{reply['final_score'][2:]}, ladder read {reply['elf-ladder B C3']!r}")
    log(f"play: genmove seconds: first (warm-up) {genmove_s[0]:.3f}, then "
        f"{', '.join(f'{t:.3f}' for t in genmove_s[1:])}; "
        f"{summ['rollouts_per_s']:.1f} rollouts/s after the first; carried "
        f"root visits {carried} (held below the played moves: {expect}); "
        f"root reused {summ['root_reused']}")
    log(f"play: GTP launches {launches} (expected {expected}), peak memory "
        f"{summ['peak_memory_bytes'] / 2 ** 30:.3f} GiB, process wall "
        f"{wall_s:.1f} s, on {card}")
    return dict(summ, commands=commands, answers=answers, game=game,
                wall_s=wall_s, expected_launches=expected)


def analysis_session(card: str) -> dict:
    """scripts/analysis_torch.py on a 19x19 SGF of a golden game: four
    positions after a 40-move preload, with tree dumps."""
    import shutil

    from elf_tpu_torch.sgf import game_from_moves, serialize_sgf

    play_dir = ROOT / "build" / "play"
    shutil.rmtree(play_dir, ignore_errors=True)
    play_dir.mkdir(parents=True)
    sgf = play_dir / "golden19.sgf"
    sgf.write_text(serialize_sgf(game_from_moves(
        golden_actions("ref_traj_19", 60), 19)))
    cmd = [sys.executable, str(ROOT / "scripts/analysis_torch.py"),
           "--load", str(ROOT / "runs/prove19/export-best.bin"),
           "--board_size", "19", "--num_block", "20", "--dim", "256",
           "--preload_sgf", str(sgf), "--preload_sgf_move_to", "40",
           "--follow_sgf", "--max_moves", "4", "--num_rollouts",
           str(ANALYSIS_ROLLOUTS), "--rollouts_per_batch",
           str(SLICE_PER_BATCH), "--dump_record_prefix",
           str(play_dir / "tree"), "--verbose", "--seed", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall_s = time.perf_counter() - t0
    (ROOT / "chiprun_out" / "play" / "analysis.log").write_text(
        proc.stdout + "\n----- stderr -----\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"play: the analysis exited with {proc.returncode}\n"
             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    reports = [l for l in lines if " suggest " in l]
    if len(reports) != 4 or not lines[-1].startswith("final_score "):
        fail(f"play: analysis printed\n{proc.stdout}")
    trees = sorted(play_dir.glob("tree_0_*.tree"))
    if [t.name for t in trees] != [f"tree_0_{p}.tree" for p in range(40, 44)] \
            or any(t.stat().st_size == 0 for t in trees):
        fail(f"play: tree dumps {[t.name for t in trees]}")
    for t in trees:
        shutil.copy(t, ROOT / "chiprun_out" / "play" / t.name)
    summ = json.loads(proc.stderr.strip().splitlines()[-1])
    expected = {
        "step_analysis": (summ["preloaded_moves"] + summ["searches"]
                          * (summ["rollouts_per_search"] + 1)),
        "analyze_libs": sum(not r for r in summ["root_reused"]),
    }
    launches = summ["kernel_launches"]
    for name, n in expected.items():
        if launches[name] <= 0 or launches[name] != n:
            fail(f"play: analysis {name}: {launches[name]} launches, "
                 f"expected {n}")
    pos_s = summ["position_s"]
    log(f"play: analysis 19x19 20b256c, {ANALYSIS_ROLLOUTS} rollouts: "
        f"seconds per position: first (warm-up) {pos_s[0]:.3f}, then "
        f"{', '.join(f'{t:.3f}' for t in pos_s[1:])}; "
        f"{summ['rollouts_per_s']:.1f} rollouts/s after the first; launches "
        f"{launches}; peak memory {summ['peak_memory_bytes'] / 2 ** 30:.3f} "
        f"GiB, on {card}")
    for l in lines:
        log(f"play:   {l[:150]}")
    shutil.rmtree(play_dir, ignore_errors=True)
    return dict(summ, reports=lines, wall_s=wall_s,
                expected_launches=expected)


def play_phase(card: str) -> dict:
    gtp = gtp_session(card)
    analysis = analysis_session(card)
    return {"gtp": gtp, "analysis": analysis, "launches": {
        k: gtp["kernel_launches"][k] + analysis["kernel_launches"][k]
        for k in ("step_analysis", "analyze_libs")}}


# ---------------------------------------------------------------------------
# phase 9: production self-play (B = 1024, the chunked production search)
# ---------------------------------------------------------------------------


def production_phase(card: str) -> dict:
    """The JAX package's production self-play configuration at a cut
    budget: 1024 boards, 64 rollouts in batches of 8 (8192-leaf batches
    evaluated in 4 chunks of 2048), the search in 2 calls of 4 batches,
    `batched_writes="on"`.  A warm-up move, then a timed one; the launch
    counts are set to 0 just before the warm-up and read after the timed
    move; every move replays legally on the host."""
    sys.path.append(str(ROOT / "scripts"))
    from production_selfplay_torch import production_actor, timed_move

    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, load_model

    net = load_model(str(ROOT / "runs/prove19/export-best.bin"),
                     ModelConfig(), "cuda")
    actor = production_actor(PROD_B, PROD_ROLLOUTS, PROD_PER_BATCH,
                             PROD_BATCHES_PER_CALL)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    warm_s, _ = timed_move(actor, net)
    torch.cuda.reset_peak_memory_stats()
    move_s, calls = timed_move(actor, net)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_move = {"step_analysis": PROD_ROLLOUTS + 1, "analyze_libs": 1}
    for name, n in per_move.items():
        if launches[name] != 2 * n:
            fail(f"production: {name}: {launches[name]} launches, expected "
                 f"{2 * n}")
    if len(calls) != 2:
        fail(f"production: {len(calls)} simulate calls per move, expected 2")
    stones = replay_is_legal(actor.moves, 19)
    if not torch.equal(stones, actor.state.core.stones):
        fail("production: replayed boards differ from the actor's boards")
    out = dict(
        card=card, boards=PROD_B, rollouts=PROD_ROLLOUTS,
        rollouts_per_batch=PROD_PER_BATCH, eval_chunk=2048,
        max_batches_per_call=PROD_BATCHES_PER_CALL, batched_writes="on",
        warmup_move_s=warm_s, move_s=move_s, simulate_s=calls,
        moves_per_s=PROD_B / move_s,
        rollouts_per_s=PROD_B * PROD_ROLLOUTS / move_s,
        leaf_evals_per_s=PROD_B * (PROD_ROLLOUTS + 1) / move_s,
        peak_memory_bytes=peak, launches=launches,
    )
    log(f"production: 19x19 20b256c B {PROD_B}, {PROD_ROLLOUTS} rollouts in "
        f"batches of {PROD_PER_BATCH}, eval_chunk 2048, "
        f"{len(calls)} simulate calls: warm-up move {warm_s:.3f} s, timed "
        f"move {move_s:.3f} s: "
        f"{out['moves_per_s']:.2f} moves/s, {out['rollouts_per_s']:.1f} "
        f"rollouts/s, {out['leaf_evals_per_s']:.1f} leaf-evals/s, simulate "
        f"calls {', '.join(f'{s:.3f}' for s in calls)} s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, on {card}")
    log(f"production: launches {launches} (expected "
        f"{PROD_ROLLOUTS + 1} step_analysis + 1 analyze_libs per move); "
        "every move replays legally")
    out["profile"] = profile_move(
        actor, net, f"a third production move at B {PROD_B}, "
        f"{PROD_ROLLOUTS} rollouts", card)
    return out


# ---------------------------------------------------------------------------
# phase 10: block remat at the production batch
# ---------------------------------------------------------------------------


def synthetic_batch(batch: int, seed: int):
    """(features, pi, winner) on the card from a seed: binary planes,
    Dirichlet-like policies, outcomes of +-1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = (torch.rand((batch, 19, 19, 18), generator=g, device="cuda")
             < 0.3).float()
    pi = torch.rand((batch, 362), generator=g, device="cuda") ** 8
    pi = pi / pi.sum(dim=1, keepdim=True)
    winner = torch.where(torch.rand((batch,), generator=g, device="cuda")
                         < 0.5, -1.0, 1.0)
    return feats, pi, winner


def time_steps(trainer, state, batch, warmup: int, timed: int):
    """Median ms per step by CUDA events over `timed` steps after
    `warmup`, the peak memory over them, and the last stats."""
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        state, stats = step(state, *batch)
    ms = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(timed):
        start.record()
        state, stats = step(state, *batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    stats = {k: float(v) for k, v in stats.items()}
    if not all(np.isfinite(v) for v in stats.values()):
        fail(f"remat: a stat is not finite: {stats}")
    return float(np.median(ms)), ms, torch.cuda.max_memory_allocated(), stats


def remat_phase(card: str) -> dict:
    """`ModelConfig(remat=True)` at 19x19 20b256c: the step at the
    production batch 2048, and at the train phase's 256 beside the plain
    step (one batch, in turns plain, remat, remat, plain); then one remat
    and one plain step from one state must leave equal BN statistics and
    parameters within 1e-5."""
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint

    weights = str(ROOT / "runs/prove19/export-best.bin")
    plain_cfg = ModelConfig()
    remat_cfg = dataclasses.replace(plain_cfg, remat=True)

    def trainer_state(cfg, batch):
        tr = Trainer(cfg, TrainOptions(batchsize=batch), device="cuda")
        return tr, load_checkpoint(
            weights, tr.init_state(torch.Generator().manual_seed(0)))

    tr, state = trainer_state(remat_cfg, REMAT_BATCH)
    big = synthetic_batch(REMAT_BATCH, 1)
    med, ms, peak, stats = time_steps(tr, state, big, 2, REMAT_TIMED)
    del tr, state, big
    torch.cuda.empty_cache()
    flops = train_step_flops(plain_cfg, REMAT_BATCH)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3

    small = synthetic_batch(TRAIN_BATCH, 2)
    at_256 = {"plain": [], "remat": []}
    for kind in ("plain", "remat", "remat", "plain"):
        tr, state = trainer_state(remat_cfg if kind == "remat" else plain_cfg,
                                  TRAIN_BATCH)
        m, _, p, _ = time_steps(tr, state, small, 2, REMAT_TIMED)
        at_256[kind].append((m, p))
        del tr, state
        torch.cuda.empty_cache()
    plain_ms = float(np.mean([m for m, _ in at_256["plain"]]))
    remat_ms = float(np.mean([m for m, _ in at_256["remat"]]))

    # one step each from one state: the statistics move once per step
    base_tr, base = trainer_state(plain_cfg, TRAIN_BATCH)
    other = copy.deepcopy(base)
    other.net.cfg = remat_cfg
    remat_tr = Trainer(remat_cfg, base_tr.opts, device="cuda")
    base_tr.make_train_step()(base, *small)
    remat_tr.make_train_step()(other, *small)
    for (n, a), (_, b) in zip(base.net.named_buffers(),
                              other.net.named_buffers()):
        if not torch.equal(a, b):
            fail(f"remat: BN statistic {n} differs from the plain step's")
    worst = max(float((a - b).detach().abs().max()) for a, b in
                zip(base.net.parameters(), other.net.parameters()))
    if worst > 1e-5:
        fail(f"remat: parameters differ from the plain step's by {worst}")
    del base_tr, base, other, remat_tr
    torch.cuda.empty_cache()

    out = dict(
        card=card, batch=REMAT_BATCH, step_ms_median=med, step_ms=ms,
        positions_per_s=REMAT_BATCH / med * 1e3, step_flops=flops,
        bound_ms=bound_ms, bound_share=bound_ms / med,
        peak_memory_bytes=peak, stats=stats,
        at_256=dict(plain_ms=plain_ms, remat_ms=remat_ms,
                    cost=remat_ms / plain_ms,
                    plain_peak_bytes=max(p for _, p in at_256["plain"]),
                    remat_peak_bytes=max(p for _, p in at_256["remat"]),
                    turns=at_256),
        max_param_diff=worst,
    )
    log(f"remat: 19x19 20b256c bf16, fp32 masters, remat, B {REMAT_BATCH}: "
        f"step {med:.2f} ms median of {REMAT_TIMED} (CUDA events), "
        f"{out['positions_per_s']:.1f} positions/s, "
        f"{100 * bound_ms / med:.2f}% of the {bound_ms:.3f} ms bf16 bound "
        f"({flops / 1e12:.3f} TFLOP of useful work), peak memory "
        f"{peak / 2 ** 30:.2f} GiB, on {card}")
    log(f"remat: B {TRAIN_BATCH}: plain {plain_ms:.2f} ms, remat "
        f"{remat_ms:.2f} ms ({remat_ms / plain_ms:.3f}x), peak "
        f"{out['at_256']['plain_peak_bytes'] / 2 ** 30:.2f} / "
        f"{out['at_256']['remat_peak_bytes'] / 2 ** 30:.2f} GiB; one step "
        "each from one state: BN statistics equal, parameters within "
        f"{worst:.2e}, on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 11: df-25 features through self-play and the learner
# ---------------------------------------------------------------------------


def df_phase(card: str) -> dict:
    """`make_trainer("df_kl", use_df_feature=True)` at 19x19 20b256c (25
    planes, random weights from a seed): DF_MOVES lockstep moves of B = 32
    at 64 rollouts with df leaves, with the launch counts set to 0 just
    before; the moves replay legally; the records feed a df pipeline and
    one train step at batch 256 gives finite losses.  Then a fresh df
    actor's first move with the df planes (`extract_df_parts`),
    `analyze_libs3` within them and the leaf walk timed by wrappers that
    synchronise the card around each call, and its second move under the
    profiler."""
    from elf_tpu_torch.config import ReplayOptions, TrainOptions
    from elf_tpu_torch.env.go import engine, kernels
    from elf_tpu_torch.models.registry import make_trainer
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search import mcts
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer

    to = TrainOptions(batchsize=TRAIN_BATCH)
    trainer, _, feature_set = make_trainer("df_kl", 19, to,
                                           use_df_feature=True, device="cuda")
    if feature_set != "df" or trainer.cfg.num_planes != 25:
        fail(f"df: make_trainer gave {feature_set}, "
             f"{trainer.cfg.num_planes} planes")
    state = trainer.init_state(torch.Generator().manual_seed(7))
    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=SLICE_B, never_resign_prob=1.0,
                    move_cutoff=DF_MOVES),
        MCTSConfig(num_rollouts=SLICE_ROLLOUTS,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.25,
                   feature_set="df"),
        eval_fn_builder, seed=0, device="cuda")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    move_s, records = [], []
    for _ in range(DF_MOVES):
        t0 = time.perf_counter()
        records += actor.play_moves(state.net, None, 1)
        torch.cuda.synchronize()
        move_s.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    per_move = {"step_analysis": SLICE_ROLLOUTS + 1, "analyze_libs": 1}
    for name, n in per_move.items():
        if launches[name] != DF_MOVES * n:
            fail(f"df: {name}: {launches[name]} launches, expected "
                 f"{DF_MOVES * n}")
    if len(records) != SLICE_B:
        fail(f"df: {len(records)} records from {SLICE_B} games")
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves

    games = [sgf_string_to_moves(r.result.content, 19) for r in records]
    if any(len(m) != DF_MOVES for m in games):
        fail("df: a game has not the moves it played")
    replay_is_legal(games, 19)

    pipeline = TrainingPipeline(
        ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=1,
                                   q_max_size=1000), seed=0), 19, seed=0,
        feature_set="df")
    for r in records:
        pipeline.insert_record(r)
    hb = pipeline.sample_host_batch(TRAIN_BATCH)
    if hb is None or hb.last_placed is None:
        fail("df: the pipeline gave no df batch")
    feats, pi, winner = pipeline.device_batch(hb, "cuda")
    if tuple(feats.shape) != (TRAIN_BATCH, 19, 19, 25):
        fail(f"df: batch planes of shape {tuple(feats.shape)}")
    state, stats = trainer.make_train_step()(state, feats, pi, winner)
    stats = {k: float(v) for k, v in stats.items()}
    if not all(np.isfinite(v) for v in stats.values()):
        fail(f"df: a stat of the train step is not finite: {stats}")
    steady = move_s[1:]
    mps = SLICE_B * len(steady) / sum(steady)

    # a fresh actor's first move again, with the df work timed by wrappers
    # that synchronise the card around each call (which slows the move),
    # then one move under the profiler
    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=SLICE_B, never_resign_prob=1.0),
        actor.mcts_cfg, eval_fn_builder, seed=0, device="cuda")
    spent = {"extract_df_parts": 0.0, "analyze_libs3": 0.0,
             "_leaf_last_placed": 0.0}
    originals = {}

    def timed(module, name):
        fn = originals[module, name] = getattr(module, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out

        setattr(module, name, wrapper)

    timed(mcts, "extract_df_parts")
    timed(engine, "analyze_libs3")
    timed(mcts, "_leaf_last_placed")
    try:
        t0 = time.perf_counter()
        actor.play_moves(state.net, None, 1)
        torch.cuda.synchronize()
        wrapped_move_s = time.perf_counter() - t0
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    profile = profile_move(actor, state.net, f"a second df move at B "
                           f"{SLICE_B}, {SLICE_ROLLOUTS} rollouts", card)
    out = dict(
        card=card, boards=SLICE_B, rollouts=SLICE_ROLLOUTS, moves=DF_MOVES,
        move_s=move_s, moves_per_s=mps, wrapped_move_s=wrapped_move_s,
        df_planes_ms=spent["extract_df_parts"] * 1e3,
        analyze_libs3_ms=spent["analyze_libs3"] * 1e3,
        leaf_walk_ms=spent["_leaf_last_placed"] * 1e3,
        launches=launches, train_stats=stats, records=len(records),
        profile=profile,
    )
    log(f"df: 19x19 20b256c, 25 planes, random weights, B {SLICE_B}, "
        f"{SLICE_ROLLOUTS} rollouts: moves {', '.join(f'{s:.3f}' for s in move_s)}"
        f" s, {mps:.2f} moves/s after the first, on {card}")
    log(f"df: a first move with synchronised wrappers {wrapped_move_s:.3f} "
        f"s: df planes {out['df_planes_ms']:.1f} ms (analyze_libs3 "
        f"{out['analyze_libs3_ms']:.1f} ms of it), the leaf walk "
        f"{out['leaf_walk_ms']:.1f} ms")
    log(f"df: launches {launches}; every move replays legally; train step "
        f"at batch {TRAIN_BATCH} on the df batch: loss/total "
        f"{stats['loss/total']:.4f}, all stats finite")
    return out


# ---------------------------------------------------------------------------
# phase 12: the supervised path and the secondary modules
# ---------------------------------------------------------------------------


def calibrate_bn(net, x) -> None:
    """Set every BN layer's running statistics to those of `x` (one
    training-mode pass with momentum 1), so that an inference forward of a
    randomly initialised net normalises its activations."""
    from elf_tpu_torch.models.resnet import BatchNorm

    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    kept = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        net(x, train=True)
    for bn, m in zip(bns, kept):
        bn.momentum = m


def prob_agreement(a: torch.Tensor, b: torch.Tensor):
    """(share of rows with the same top move, largest absolute probability
    difference) of two log-probability tensors [..., A]."""
    top = (a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean()
    return float(top), float((a.exp() - b.exp()).abs().max())


def layer_errors(net16, net32, x: torch.Tensor) -> list:
    """Relative error (Frobenius) of each bf16 layer of the PolicyNet
    `net16` against the same layer of its fp32 twin `net32`, both fed the
    fp32 twin's activations of the layer before: the error that one bf16
    layer adds, apart from the error it inherits."""
    import torch.nn.functional as F

    errs = []
    with torch.no_grad():
        h = x.permute(0, 3, 1, 2)
        for c16, b16, c32, b32 in zip(net16.convs, net16.bns, net32.convs,
                                      net32.bns):
            y32 = b32(F.leaky_relu(c32(h), 0.1), False)
            y16 = b16(F.leaky_relu(c16(h.bfloat16()), 0.1), False)
            errs.append(float((y16.bfloat16().float() - y32).norm()
                              / y32.norm()))
            h = y32
    return errs


def rl_outputs(dev) -> dict:
    """Every value, stat and gradient of the `rl` methods on seeded inputs
    on `dev`, by name, on the host."""
    from elf_tpu_torch.rl import methods, rnn

    rng = np.random.default_rng(0)
    T, B, A, D, H = 6, 32, 9, 5, 8

    def t(a, grad=False):
        return torch.tensor(a, device=dev, requires_grad=grad)

    out = {}
    logits = t(rng.normal(size=(T, B, A)).astype(np.float32), True)
    values = t(rng.normal(size=(T + 1, B)).astype(np.float32), True)
    acts = t(rng.integers(0, A, size=(T, B)).astype(np.int32))
    rew = t(rng.normal(size=(T, B)).astype(np.float32))
    term = t(rng.random((T, B)) < 0.25)
    old = t(rng.dirichlet(np.ones(A), size=T * B).astype(np.float32))
    out["returns"] = methods.discounted_returns(rew, term, values[-1].detach(),
                                                0.9)
    pi = torch.softmax(logits, dim=2)
    losses = {
        "pg": methods.policy_gradient_loss(
            pi.reshape(T * B, A), acts.reshape(-1), rew.reshape(-1),
            old_pi=old, ratio_clamp=2.0),
        "ac": methods.actor_critic_loss(pi, values, acts, rew, term, 0.9),
        "q": methods.q_learning_loss(logits, acts[:-1], rew[:-1], term[:-1]),
    }
    w = t((rng.normal(size=(D, H)) * 0.3).astype(np.float32), True)
    xs = t(rng.normal(size=(T + 1, B, D)).astype(np.float32))

    def cell(p, carry, x):
        carry = torch.tanh(carry + x @ p["w"])
        return carry, (torch.softmax(carry[:, :2], dim=1), carry[:, 2])

    losses["rnn"] = rnn.rnn_actor_critic_loss(
        cell, {"w": w}, torch.zeros(B, H, device=dev), xs, acts % 2, rew, term)
    for name, (loss, stats) in losses.items():
        for k, v in stats.items():
            out[f"{name}/{k}"] = v
        grads = torch.autograd.grad(loss, [logits, values, w],
                                    retain_graph=True, allow_unused=True)
        for gname, g in zip(("logits", "values", "w"), grads):
            if g is not None:
                out[f"{name}/grad_{gname}"] = g
    return {k: v.detach().cpu() for k, v in out.items()}


def offline_phase(card: str) -> dict:
    """The supervised path at 19x19 and the secondary modules, on the card:
    an SGF archive of policy-only self-play games (committed weights,
    Tromp-Taylor results), the offline loader, the df_pred learner at
    20b256c (AGZ and df planes), the supervised entry points as processes,
    the 39 x 128 PolicyNet, the tactics and the rl methods.  The launch
    counts are set to 0 at the start and read at the end."""
    import dataclasses
    import shutil

    from elf_tpu_torch.config import ReplayOptions, TrainOptions
    from elf_tpu_torch.env.go import engine, kernels, tactics
    from elf_tpu_torch.models.policy_net import (
        PolicyNetConfig,
        init_policy_net,
        policy_params_from_jax,
        policy_params_to_jax,
    )
    from elf_tpu_torch.models.registry import make_trainer
    from elf_tpu_torch.models.resnet import (
        ModelConfig,
        PolicyValueNet,
        eval_fn_builder,
        load_model,
    )
    from elf_tpu_torch.native.replayer import replay_to_snapshots
    from elf_tpu_torch.native.sgf_codec import sgf_string_to_moves
    from elf_tpu_torch.rl.sampler import Sampler, SamplerOptions
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor
    from elf_tpu_torch.sgf import game_from_moves, serialize_sgf
    from elf_tpu_torch.training.offline import OfflineLoader
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner
    from elf_tpu_torch.training.trainer import Trainer, TrainState

    size, komi = 19, 7.5
    out_dir = ROOT / "chiprun_out" / "offline"
    out_dir.mkdir(parents=True, exist_ok=True)
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # 1. the archive: policy-only games with the committed weights
    net = load_model(str(ROOT / "runs/prove19/export-best.bin"),
                     ModelConfig(), "cuda")
    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=OFFLINE_GAMES, komi=komi,
                    never_resign_prob=1.0, move_cutoff=OFFLINE_PLIES),
        MCTSConfig(num_rollouts=0), eval_fn_builder, seed=5, device="cuda")
    t0 = time.perf_counter()
    records = actor.play_moves(net, None, OFFLINE_PLIES)
    torch.cuda.synchronize()
    selfplay_s = time.perf_counter() - t0
    selfplay_launches = kernels.launch_counts()
    del net, actor
    if len(records) < OFFLINE_GAMES:
        fail(f"offline: {len(records)} records from {OFFLINE_GAMES} games")
    records = records[:OFFLINE_GAMES]
    games = [sgf_string_to_moves(r.result.content, size) for r in records]
    if any(not 0 < len(m) <= OFFLINE_PLIES for m in games):
        fail("offline: a game is empty or longer than the cut")
    finals = np.stack([replay_to_snapshots(m, size)[-1] for m in games])
    core = engine.init_core(len(games), size, "cuda")._replace(
        stones=torch.from_numpy(finals).cuda())
    score = (engine.score_tromp_taylor(core, size).float() - komi).cpu()
    score = score.numpy()
    rewards = np.array([r.result.reward for r in records])
    if not np.array_equal(np.where(score > 0, 1.0, -1.0), rewards):
        fail("offline: a record's reward is not its Tromp-Taylor result")
    archive = Path(tempfile.mkdtemp(prefix="chip_smoke_sgf_"))
    for i, (moves, s) in enumerate(zip(games, score)):
        result = f"B+{s:g}" if s > 0 else f"W+{-s:g}"
        game = game_from_moves(moves, size, komi=komi, result=result)
        (archive / f"game{i:04d}.sgf").write_text(serialize_sgf(game))
    log(f"offline: {OFFLINE_GAMES} policy-only games of <= {OFFLINE_PLIES} "
        f"plies in {selfplay_s:.2f} s (B {OFFLINE_GAMES}, committed weights), "
        f"black won {int((score > 0).sum())}; launches {selfplay_launches}")

    # 2. the offline loader: C parser + C replayer on 16 threads
    def pipeline(feature_set):
        return TrainingPipeline(
            ReplayBuffer(ReplayOptions(num_reader=2, q_min_size=0,
                                       q_max_size=1000), seed=0),
            size, seed=0, num_future_actions=OFFLINE_T,
            feature_set=feature_set)

    pipe = pipeline("agz")
    t0 = time.perf_counter()
    loaded = OfflineLoader(pipe, num_threads=16).load_dir(str(archive))
    load_s = time.perf_counter() - t0
    if loaded != OFFLINE_GAMES:
        fail(f"offline: the loader gave {loaded} of {OFFLINE_GAMES} records")
    items = [it for q in pipe.replay.queues for it in q]
    if sorted(list(map(len, (it.moves for it in items)))) != \
            sorted(map(len, games)) or not all(it.record.offline
                                               for it in items):
        fail("offline: the loaded records are not the archive's games")
    n_plies = sum(map(len, games))
    log(f"offline: OfflineLoader(num_threads=16) loaded {loaded} files in "
        f"{load_s * 1e3:.1f} ms: {loaded / load_s:.1f} files/s, "
        f"{n_plies / load_s:.0f} positions/s, on {card}")

    # 3. the df_pred learner: 20b256c, bf16 compute, fp32 masters
    def check_stats(stats, where):
        bad = {k: v for k, v in stats.items() if not np.isfinite(v)}
        if bad:
            fail(f"offline: stats not finite {where}: {bad}")

    opts = TrainOptions(batchsize=OFFLINE_BATCH, num_block=OFFLINE_BLOCKS,
                        dim=OFFLINE_DIM)
    trainer, mode, feature_set = make_trainer("df_pred", size, opts,
                                              device="cuda")
    if (mode, feature_set) != ("offline", "agz"):
        fail(f"offline: make_trainer('df_pred') gave {mode}, {feature_set}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    runner = LearnerRunner(trainer, pipe, ckpt_dir, opts, seed=0,
                           train_mode="offline")
    if any(p.dtype != torch.float32 for p in runner.state.net.parameters()):
        fail("offline: the master weights are not fp32")
    torch.cuda.reset_peak_memory_stats()
    for i in range(OFFLINE_WARMUP):
        check_stats(runner.run_minibatch(), f"at warm-up step {i}")
    step_ms, sample_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(OFFLINE_TIMED):
        t0 = time.perf_counter()
        hb = pipe.sample_host_batch(OFFLINE_BATCH)
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        batch = pipe.device_batch_offline(hb, "cuda")
        start.record()
        runner.state, stats = runner._train_step(runner.state, *batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        check_stats({k: float(v) for k, v in stats.items()},
                    f"at timed step {i}")
    t0 = time.perf_counter()
    rest = OFFLINE_STEPS - OFFLINE_WARMUP - OFFLINE_TIMED
    for i in range(rest):
        check_stats(runner.run_minibatch(), f"at minibatch {i}")
    torch.cuda.synchronize()
    minibatch_ms = (time.perf_counter() - t0) * 1e3 / max(rest, 1)
    if runner.version() != OFFLINE_STEPS:
        fail(f"offline: step {runner.version()} after {OFFLINE_STEPS} steps")
    fixed = pipe.device_batch_offline(pipe.sample_host_batch(OFFLINE_BATCH),
                                      "cuda")
    fixed_policy = []
    for i in range(OFFLINE_STEPS):
        runner.state, stats = runner._train_step(runner.state, *fixed)
        stats = {k: float(v) for k, v in stats.items()}
        check_stats(stats, f"at fixed-batch step {i}")
        fixed_policy.append(stats["loss/policy"])
    if not fixed_policy[-1] < fixed_policy[0]:
        fail(f"offline: loss/policy on one fixed batch did not fall: "
             f"{fixed_policy}")
    peak_bytes = torch.cuda.max_memory_allocated()

    # one fp32 step on the card and on the CPU from one state and batch
    cfg32 = dataclasses.replace(trainer.cfg, use_bf16=False)

    def fp32_twin(device):
        twin = PolicyValueNet(cfg32)
        twin.load_state_dict(runner.state.net.state_dict())
        twin = twin.to(device)
        tr = Trainer(cfg32, opts, device=device)
        return tr, TrainState(net=twin, opt_state=tr.tx.init(twin), step=0)

    rows = tuple(t[:OFFLINE_CPU_ROWS] for t in fixed)
    (tr_c, st_c), (tr_h, st_h) = fp32_twin("cuda"), fp32_twin("cpu")
    st_c, sc = tr_c.make_offline_train_step()(st_c, *rows)
    st_h, sh = tr_h.make_offline_train_step()(st_h, *(t.cpu() for t in rows))
    stat_err = max(abs(float(sc[k]) - float(sh[k])) / max(1.0, abs(float(sh[k])))
                   for k in sh)
    tensor_err = max(
        float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
        for a, b in zip(st_c.net.state_dict().values(),
                        st_h.net.state_dict().values()))
    if stat_err > 1e-3 or tensor_err > 1e-4:
        fail(f"offline: the fp32 step on the card differs from the CPU's: "
             f"stats {stat_err:.2e}, parameters and BN statistics "
             f"{tensor_err:.2e}")
    del tr_c, st_c, tr_h, st_h

    # df planes: the same archive through a 25-plane learner
    trainer_df, mode, feature_set = make_trainer(
        "df_pred", size, opts, use_df_feature=True, device="cuda")
    if (mode, feature_set, trainer_df.cfg.num_planes) != ("offline", "df", 25):
        fail(f"offline: df_pred with df planes gave {mode}, {feature_set}")
    pipe_df = pipeline("df")
    t0 = time.perf_counter()
    if OfflineLoader(pipe_df, num_threads=16).load_dir(str(archive)) != \
            OFFLINE_GAMES:
        fail("offline: the df pipeline did not load every game")
    load_df_s = time.perf_counter() - t0
    runner_df = LearnerRunner(trainer_df, pipe_df, ckpt_dir, opts, seed=1,
                              train_mode="offline")
    df_stats = []
    for i in range(OFFLINE_DF_STEPS):
        df_stats.append(runner_df.run_minibatch())
        check_stats(df_stats[-1], f"at df step {i}")
    df_feats = pipe_df.device_batch_offline(
        pipe_df.sample_host_batch(PN_BATCH), "cuda")[0]
    del runner, runner_df, trainer, trainer_df, fixed, rows
    torch.cuda.empty_cache()
    flops = train_step_flops(ModelConfig(num_block=OFFLINE_BLOCKS,
                                         dim=OFFLINE_DIM), OFFLINE_BATCH)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    med = float(np.median(step_ms))
    log(f"offline: df_pred {OFFLINE_BLOCKS}b{OFFLINE_DIM}c bf16, fp32 masters,"
        f" B {OFFLINE_BATCH}, T {OFFLINE_T}: step {med:.2f} ms median "
        f"({min(step_ms):.2f}-{max(step_ms):.2f}, {OFFLINE_TIMED} steps, CUDA "
        f"events), {OFFLINE_BATCH / med * 1e3:.1f} positions/s, "
        f"{100 * bound_ms / med:.2f}% of the {bound_ms:.3f} ms bf16 bound, "
        f"peak {peak_bytes / 2 ** 30:.2f} GiB, on {card}")
    log(f"offline: sample_host_batch {np.median(sample_ms):.2f} ms, "
        f"run_minibatch {minibatch_ms:.2f} ms; loss/policy on one fixed batch "
        f"{fixed_policy[0]:.4f} -> {fixed_policy[-1]:.4f} over "
        f"{OFFLINE_STEPS} steps; fp32 step card vs CPU ({OFFLINE_CPU_ROWS} "
        f"rows): stats {stat_err:.2e}, tensors {tensor_err:.2e}; df planes: "
        f"{OFFLINE_DF_STEPS} steps, loss/total "
        f"{df_stats[-1]['loss/total']:.4f}, loader {load_df_s * 1e3:.1f} ms")

    # 4. the entry points as processes
    sys.path.append(str(ROOT / "scripts"))
    from prove_production_torch import free_port, stop_all, wait_in_log

    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, str(ROOT / "scripts/demo_supervised_torch.py"),
         "--sgf_dir", str(archive), "--blocks", str(OFFLINE_BLOCKS),
         "--dim", str(OFFLINE_DIM), "--batch", str(OFFLINE_BATCH),
         "--steps", str(DEMO_STEPS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    demo_s = time.perf_counter() - t0
    (out_dir / "demo_supervised.log").write_text(demo.stdout + demo.stderr)
    if demo.returncode != 0:
        fail(f"offline: demo_supervised_torch.py exited {demo.returncode}:\n"
             f"{demo.stderr[-3000:]}")
    demo_lines = [json.loads(x) for x in demo.stdout.strip().splitlines()]
    demo_final = demo_lines[-1]
    if demo_lines[0].get("loaded_games") != OFFLINE_GAMES or \
            not demo_final.get("final") or \
            demo_lines[0].get("train_mode") != "offline":
        fail(f"offline: the demo's lines: {demo_lines[0]} ... {demo_final}")
    log(f"offline: demo_supervised_torch.py {DEMO_STEPS} steps in "
        f"{demo_s:.1f} s: {json.dumps(demo_final)}")

    server_log = out_dir / "train_server.log"
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_df_pred_"))
    with open(server_log, "w") as f:
        server = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts/train_server_torch.py"),
             "--model", "df_pred", "--board_size", str(size),
             "--num_block", str(OFFLINE_BLOCKS), "--dim", str(OFFLINE_DIM),
             "--batchsize", str(OFFLINE_BATCH), "--port", str(free_port()),
             "--num_reader", "2", "--q_min_size", "0", "--ckpt_dir",
             str(ckpt)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            text=True)
        try:
            up = wait_in_log(str(server_log), "server up on :", server,
                             time.time() + 300, "the df_pred server")
        finally:
            stop_all([server], grace=30.0)
    text = server_log.read_text()
    if not up or "learner: model df_pred, train mode offline" not in text:
        fail(f"offline: train_server_torch.py --model df_pred did not build "
             f"its offline learner:\n{text[-3000:]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log("offline: train_server_torch.py --model df_pred built its offline "
        "learner, wrote its first checkpoint and served")

    # 5. PolicyNet at the reference width (39 x 128, 25 planes, T = 3, bf16)
    pcfg = PolicyNetConfig(num_future_actions=OFFLINE_T)
    pnet = init_policy_net(pcfg, torch.Generator().manual_seed(11), "cuda")
    calibrate_bn(pnet, df_feats)
    with torch.no_grad():
        log_pis = pnet(df_feats)
        pn_ms = cuda_time_ms(lambda: pnet(df_feats), PN_REPS)
    if tuple(log_pis.shape) != (PN_BATCH, OFFLINE_T, size * size + 1) or \
            not bool(torch.isfinite(log_pis).all()):
        fail(f"offline: PolicyNet gave {tuple(log_pis.shape)} or non-finite")
    sum_err = float((log_pis.exp().sum(dim=2) - 1.0).abs().max())
    if sum_err > 1e-3:
        fail(f"offline: PolicyNet probabilities sum to 1 within {sum_err}")
    cfg32 = dataclasses.replace(pcfg, use_bf16=False)
    trees = policy_params_to_jax(pnet)
    x = df_feats[:PN_CPU_ROWS]
    net32 = policy_params_from_jax(*trees, cfg32, "cuda")
    with torch.no_grad():
        on_cpu = policy_params_from_jax(*trees, cfg32, "cpu")(x.cpu())
        on_card = net32(x).cpu()
    top32, diff32 = prob_agreement(on_card, on_cpu)
    top16, diff16 = prob_agreement(log_pis[:PN_CPU_ROWS].cpu(), on_cpu)
    if top32 < 0.95 or diff32 > 1e-3:
        fail(f"offline: PolicyNet fp32 on the card against the CPU: top move "
             f"{top32:.3f}, probabilities within {diff32:.2e}")
    # Where the bf16 forward parts from its fp32 twin: the error one bf16
    # layer adds (held), the top move by depth (the shallowest held), and,
    # at full depth on the rows without the df planes' 1e4 sentinel (BN
    # statistics from those rows), bf16 against fp32 and the fp32 net with
    # its kernels rounded to bf16 (fp32 arithmetic) against the exact one.
    local = layer_errors(pnet, net32, x)
    if max(local) > PN_LAYER_TOL:
        fail(f"offline: a bf16 PolicyNet layer adds {max(local):.2e} "
             f"(layer {int(np.argmax(local))}), over {PN_LAYER_TOL}")
    by_depth = {}
    for depth in PN_DEPTHS:
        dcfg = dataclasses.replace(pcfg, num_layer=depth)
        d16 = init_policy_net(dcfg, torch.Generator().manual_seed(11), "cuda")
        calibrate_bn(d16, df_feats)
        d32 = policy_params_from_jax(*policy_params_to_jax(d16),
                                     dataclasses.replace(dcfg, use_bf16=False),
                                     "cuda")
        with torch.no_grad():
            by_depth[depth] = prob_agreement(d16(x), d32(x))
    by_depth[pcfg.num_layer] = (top16, diff16)
    if by_depth[PN_DEPTHS[0]][0] < PN_SHALLOW_TOP:
        fail(f"offline: the {PN_DEPTHS[0]}-layer PolicyNet's bf16 forward "
             f"keeps the fp32 top move on {by_depth[PN_DEPTHS[0]][0]:.3f} "
             f"of the rows, under {PN_SHALLOW_TOP}")
    sentinel = (df_feats[..., 14:16] >= 5000).flatten(1).any(1)
    clean = df_feats[~sentinel]
    c16 = init_policy_net(pcfg, torch.Generator().manual_seed(11), "cuda")
    calibrate_bn(c16, clean)
    params, stats = policy_params_to_jax(c16)
    rounded = {k: ({**v, "kernel": torch.from_numpy(v["kernel"]).bfloat16()
                    .float().numpy()} if k.startswith("conv") else v)
               for k, v in params.items()}
    xc = clean[:PN_CPU_ROWS]
    with torch.no_grad():
        exact = policy_params_from_jax(params, stats, cfg32, "cuda")(xc)
        clean16 = prob_agreement(c16(xc), exact)
        rounded32 = prob_agreement(
            policy_params_from_jax(rounded, stats, cfg32, "cuda")(xc), exact)
    n2 = size * size
    pn_flops = 2.0 * PN_BATCH * n2 * 9 * pcfg.dim * (
        pcfg.num_planes + (pcfg.num_layer - 1) * pcfg.dim + OFFLINE_T)
    pn_bound_ms = pn_flops / BF16_FLOPS_PER_S * 1e3
    log(f"offline: PolicyNet 39x128 bf16 T {OFFLINE_T}, B {PN_BATCH}: forward "
        f"{pn_ms:.3f} ms (CUDA events, {PN_REPS} calls), "
        f"{pn_flops / 1e12:.3f} TFLOP, {100 * pn_bound_ms / pn_ms:.1f}% of the "
        f"{pn_bound_ms:.3f} ms bf16 bound; sums to 1 within {sum_err:.1e}; "
        f"fp32 card vs CPU ({PN_CPU_ROWS} rows): top move {top32:.3f}, "
        f"probabilities within {diff32:.2e}; bf16 vs fp32: top move "
        f"{top16:.3f}, probabilities within {diff16:.2e}, on {card}")
    log(f"offline: PolicyNet bf16 vs fp32: one layer adds at most "
        f"{max(local):.2e} (layer {int(np.argmax(local))}; first "
        f"{local[0]:.2e}); top move by depth "
        + ", ".join(f"{d}: {a:.3f} (within {m:.2e})"
                    for d, (a, m) in by_depth.items())
        + f"; {int(sentinel.sum())} of {PN_BATCH} rows hold the 1e4 sentinel;"
        f" without them ({len(xc)} rows, BN from {len(clean)}) at "
        f"{pcfg.num_layer} layers: bf16 top move {clean16[0]:.3f}, fp32 with "
        f"bf16-rounded kernels {rounded32[0]:.3f}")
    del pnet, log_pis, df_feats
    torch.cuda.empty_cache()

    # 6. tactics and rl on the card against the CPU
    playable = [m for m in games if len(m) >= TACTICS_PLY][:TACTICS_BOARDS]
    if len(playable) < TACTICS_BOARDS:
        fail(f"offline: fewer than {TACTICS_BOARDS} games reach ply "
             f"{TACTICS_PLY}")
    host_core = engine.init_core(TACTICS_BOARDS, size, "cpu")
    for ply in range(TACTICS_PLY):
        a = torch.tensor([m[ply] for m in playable], dtype=torch.int32)
        host_core, info = engine.step_core(host_core, a, size)
        if bool(info.illegal.any()):
            fail("offline: an archive move is illegal on replay")
    card_core = engine.GoCore(*(f.cuda() for f in host_core))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa_card = tactics.self_atari_mask(card_core, size)
    torch.cuda.synchronize()
    sa_ms = (time.perf_counter() - t0) * 1e3
    after = kernels.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    if delta != {"analyze_libs": 1, "step_analysis": 1}:
        fail(f"offline: self_atari_mask launched {delta}")
    if not torch.equal(sa_card.cpu(), tactics.self_atari_mask(host_core, size)):
        fail("offline: self_atari_mask on the card differs from the CPU's")
    rng = np.random.default_rng(3)
    eye_boards = np.stack([
        replay_to_snapshots(games[i % len(games)], size)[
            rng.integers(len(games[i % len(games)]))]
        for i in range(EYE_BOARDS)])
    colors = torch.from_numpy(rng.integers(1, 3, EYE_BOARDS).astype(np.int8))
    stones = torch.from_numpy(eye_boards)
    for fn in (tactics.eye_mask, tactics.fake_eye_mask, tactics.true_eye_mask,
               tactics.semi_eye):
        a, b = fn(stones.cuda(), colors.cuda(), size), fn(stones, colors, size)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(x.cpu(), y):
                fail(f"offline: {fn.__name__} on the card differs")
    rl_card, rl_cpu = rl_outputs("cuda"), rl_outputs("cpu")
    rl_err = max(float((rl_card[k] - rl_cpu[k]).abs().max()) for k in rl_cpu)
    if rl_card.keys() != rl_cpu.keys() or rl_err > 1e-5:
        fail(f"offline: rl on the card differs from the CPU by {rl_err}")
    pi = torch.softmax(torch.from_numpy(rng.normal(size=(64, 9))), 1).float()
    greedy = Sampler(SamplerOptions())
    if not torch.equal(greedy.sample(pi.cuda(), None).cpu(),
                       greedy.sample(pi, None)):
        fail("offline: the greedy sampler differs on the card")
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n <= 0:
            fail(f"offline: {name} was not launched in the phase")
    log(f"offline: self_atari_mask on {TACTICS_BOARDS} boards at ply "
        f"{TACTICS_PLY} ({TACTICS_BOARDS * n2} boards per launch) "
        f"{sa_ms:.2f} ms, {int(sa_card.sum())} self-atari points, equal to "
        f"the CPU; eye masks on {EYE_BOARDS} boards equal; rl values and "
        f"gradients within {rl_err:.1e} of the CPU; launches {launches}")
    shutil.rmtree(archive, ignore_errors=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase_s = time.perf_counter() - phase_t0
    log(f"offline: the phase's wall time {phase_s:.1f} s (host clock), on "
        f"{card}")
    return dict(
        card=card, phase_s=phase_s, games=OFFLINE_GAMES, plies=n_plies,
        selfplay_s=selfplay_s,
        black_wins=int((score > 0).sum()), load_s=load_s,
        files_per_s=loaded / load_s, positions_per_s_loaded=n_plies / load_s,
        load_df_s=load_df_s, batch=OFFLINE_BATCH, horizons=OFFLINE_T,
        step_ms_median=med, step_ms=step_ms,
        positions_per_s=OFFLINE_BATCH / med * 1e3, step_flops=flops,
        bound_ms=bound_ms, bound_share=bound_ms / med,
        peak_memory_bytes=peak_bytes,
        sample_host_batch_ms=float(np.median(sample_ms)),
        run_minibatch_ms=minibatch_ms, fixed_batch_policy_loss=fixed_policy,
        fp32_card_vs_cpu=dict(rows=OFFLINE_CPU_ROWS, stats_rel=stat_err,
                              tensors_rel=tensor_err),
        df_stats=df_stats, demo=dict(seconds=demo_s, final=demo_final),
        policy_net=dict(batch=PN_BATCH, ms=pn_ms, flops=pn_flops,
                        bound_ms=pn_bound_ms, bound_share=pn_bound_ms / pn_ms,
                        sum_err=sum_err, fp32_top1=top32, fp32_max_diff=diff32,
                        bf16_top1=top16, bf16_max_diff=diff16,
                        layer_errors=local, by_depth=by_depth,
                        sentinel_rows=int(sentinel.sum()),
                        clean_bf16=clean16, clean_rounded_fp32=rounded32),
        self_atari_ms=sa_ms, rl_max_err=rl_err, launches=launches,
        selfplay_launches=selfplay_launches,
    )


# ---------------------------------------------------------------------------
# phase 13: the mesh (parallel/): ranks in subprocesses on this card
# ---------------------------------------------------------------------------


def run_ranks(fn, world: int, *args, timeout_s: float = 300.0) -> None:
    """fn(rank, world, port, *args) in `world` spawned processes on this
    card; fails the run if a rank fails or outlives `timeout_s`, and
    leaves no rank running."""
    import torch.multiprocessing as mp

    sys.path.append(str(ROOT / "scripts"))
    from prove_production_torch import free_port

    ctx = mp.start_processes(fn, args=(world, free_port(), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                fail(f"parallel: {fn.__name__} ranks still running after "
                     f"{timeout_s:.0f} s")
    except Exception as e:      # a rank raised: its traceback is in `e`
        fail(f"parallel: {fn.__name__}: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _rank_init(rank: int, world: int, port: int, backend: str) -> None:
    """Join the world as `rank` on cuda:0 (TF32 off, as in this process)."""
    from elf_tpu_torch.parallel.distributed import maybe_initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 backend=backend)


def _par_trainer(use_bf16: bool):
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint

    cfg = dataclasses.replace(ModelConfig(), use_bf16=use_bf16)
    tr = Trainer(cfg, TrainOptions(batchsize=PAR_BATCH), device="cuda")
    state = load_checkpoint(str(ROOT / "runs/prove19/export-best.bin"),
                            tr.init_state(torch.Generator().manual_seed(0)))
    return tr, state


def _timed_steps(step, state, batches, n: int):
    """ms per step by CUDA events of `n` steps (cycling `batches`)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for i in range(n):
        start.record()
        state, _ = step(state, *batches[i % len(batches)])
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return state, ms


def _par_world1(rank, world, port, out):
    """(a) rank 0 alone on NCCL: LearnerRunner(mesh=make_mesh(1)) against
    the plain runner, one step from one state and batch, bit for bit
    (deterministic cuDNN); then both timed in turns."""
    from elf_tpu_torch.config import ReplayOptions
    from elf_tpu_torch.parallel import make_mesh
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer
    from elf_tpu_torch.training.runner import LearnerRunner

    _rank_init(rank, world, port, "nccl")
    torch.backends.cudnn.deterministic = True
    trainer, state = _par_trainer(True)
    mesh = make_mesh(1)
    runners = {}
    for kind, m in (("plain", None), ("mesh", mesh)):
        pipeline = TrainingPipeline(ReplayBuffer(ReplayOptions()), 19)
        runners[kind] = LearnerRunner(trainer, pipeline, "unused",
                                      trainer.opts, mesh=m)
        runners[kind].load_state(copy.deepcopy(state))
    batch = synthetic_batch(PAR_BATCH, 5)
    stats = {}
    for kind, r in runners.items():
        r.state, s = r._train_step(r.state, *batch)
        stats[kind] = {k: v.clone() for k, v in s.items()}
    torch.cuda.synchronize()
    equal = all(torch.equal(stats["plain"][k], stats["mesh"][k])
                for k in stats["plain"])
    sd = [r.full_state().net.state_dict() for r in runners.values()]
    equal &= all(torch.equal(sd[0][k], sd[1][k]) for k in sd[0])
    ms = {"plain": [], "mesh": []}
    for kind in ("plain", "mesh", "mesh", "plain"):
        r = runners[kind]
        r.state, t = _timed_steps(r._train_step, r.state, [batch],
                                  PAR_TIMED + 1)
        ms[kind] += t[1:]
    Path(out).write_text(json.dumps({
        "equal": bool(equal), "ms": ms, "shape": mesh.shape,
        "backend": torch.distributed.get_backend()}))
    torch.distributed.destroy_process_group()


def _par_steps(rank, world, port, data_path, out_dir):
    """(b) two ranks on cuda:0 over gloo: PAR_STEPS fp32 steps of the
    committed export at dp = 2, then at tp = 2, each held against the
    single-process steps by the caller (rank 0 writes the gathered
    states); then bf16 steps timed per rank, with its peak memory."""
    from elf_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_state,
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )

    _rank_init(rank, world, port, "gloo")
    batches = torch.load(data_path, weights_only=False)
    timing = {}
    for name, tp in (("dp2", 1), ("tp2", 2)):
        mesh = make_mesh(world, tp=tp)
        rows = batch_sharding(mesh, PAR_BATCH)
        mine = [tuple(t[rows].cuda() for t in b) for b in batches]
        trainer, state = _par_trainer(False)
        step, shardings = make_sharded_train_step(trainer, mesh, state)
        shard = shard_state(state, shardings)
        del state
        losses = []
        for b in mine:
            shard, s = step(shard, *b)
            losses.append(float(s["loss/total"]))
        full = gather_state(shard, shardings)
        if rank == 0:
            torch.save({"losses": losses,
                        "sd": {k: v.cpu() for k, v in
                               full.net.state_dict().items()}},
                       Path(out_dir, f"{name}.pt"))
        del full, shard
        trainer, state = _par_trainer(True)
        step, shardings = make_sharded_train_step(trainer, mesh, state)
        shard = shard_state(state, shardings)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shard, ms = _timed_steps(step, shard, mine, PAR_TIMED + 1)
        timing[name] = {"ms": ms[1:], "first_ms": ms[0],
                        "peak_bytes": torch.cuda.max_memory_allocated()}
        del shard
        torch.cuda.empty_cache()
    Path(out_dir, f"timing{rank}.json").write_text(json.dumps(timing))
    torch.distributed.destroy_process_group()


def _par_actor(rank, world, port, out_dir):
    """(d) two ranks on cuda:0 over gloo: the sharded actor at the slice's
    search with the committed net, PAR_MOVES moves at dp = 2, then at
    tp = 2 (the net tp-split); launch counts set to 0 just before each."""
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, load_model
    from elf_tpu_torch.parallel.mesh import (
        StateShardings,
        make_mesh,
        param_shardings,
        shard_state,
    )
    from elf_tpu_torch.training.trainer import TrainState

    _rank_init(rank, world, port, "gloo")
    net = load_model(str(ROOT / "runs/prove19/export-best.bin"),
                     ModelConfig(), "cuda")
    out = {}
    for name, tp in (("dp2", 1), ("tp2", 2)):
        mesh = make_mesh(world, tp=tp)
        params = net
        if tp > 1:
            params = shard_state(
                TrainState(net=net, opt_state={}, step=0),
                StateShardings(mesh, param_shardings(mesh, net))).net
        actor = par_actor(mesh, SLICE_ROLLOUTS if tp == 1
                          else PAR_TP_ROLLOUTS)
        torch.distributed.barrier()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        records = actor.play_moves(params, None, PAR_MOVES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[name] = {
            "launches": kernels.launch_counts(), "seconds": seconds,
            "boards": [actor.rows.start, actor.rows.stop],
            "records": [[r.thread_id, r.result.content] for r in records],
            "completed": actor.completed_games}
    Path(out_dir, f"actor{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def par_actor(mesh=None, rollouts: int = SLICE_ROLLOUTS):
    """The sharded actor's configuration: the slice's search (at `rollouts`)
    on PAR_B boards, games cut at PAR_MOVES moves so that every board's
    record comes back."""
    from elf_tpu_torch.models.resnet import eval_fn_builder
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    return SelfplayActor(
        ActorConfig(board_size=19, batch=PAR_B, never_resign_prob=1.0,
                    move_cutoff=PAR_MOVES),
        MCTSConfig(num_rollouts=rollouts,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.25),
        lambda params, batch_stats: eval_fn_builder(params), seed=11,
        device="cuda", mesh=mesh)


def parallel_phase(card: str) -> dict:
    """The mesh path at 19x19 20b256c, every rank a subprocess on this
    card (no process group is left in this process): (a) the world-1 mesh
    step on NCCL against the plain step, bit for bit, and its cost; (b)
    dp = 2 and tp = 2 steps of two ranks over gloo against the
    single-process steps, then their bf16 step time and peak memory; (c)
    `train_server_torch.py --dist_*` at world 1 with one client, to its
    first checkpoint and the client's load; (d) the sharded actor, dp = 2
    and tp = 2, moves legal on host replay."""
    import shutil
    import signal

    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import ModelConfig, load_model

    sys.path.append(str(ROOT / "scripts"))
    from prove_production_torch import free_port, stop_all, wait_in_log

    phase_t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    log_dir = ROOT / "chiprun_out" / "parallel"
    log_dir.mkdir(parents=True, exist_ok=True)
    out = {"card": card}

    # (a) the mesh path at world 1
    t0 = time.perf_counter()
    run_ranks(_par_world1, 1, str(work / "world1.json"))
    w1 = json.loads((work / "world1.json").read_text())
    if not w1["equal"]:
        fail("parallel: the world-1 mesh step is not the plain step bit "
             "for bit")
    plain_ms = float(np.median(w1["ms"]["plain"]))
    mesh_ms = float(np.median(w1["ms"]["mesh"]))
    out["world1"] = dict(w1, plain_ms=plain_ms, mesh_ms=mesh_ms,
                         wall_s=time.perf_counter() - t0)
    log(f"parallel: (a) world 1 ({w1['backend']}), mesh {w1['shape']}: the "
        f"step equals the plain step bit for bit; batch {PAR_BATCH} bf16, "
        f"fp32 masters: plain {plain_ms:.2f} ms, mesh {mesh_ms:.2f} ms "
        f"(median of {2 * PAR_TIMED} each by CUDA events, in turns), on "
        f"{card}")

    # (b) dp = 2 and tp = 2, two ranks over gloo, against one process
    t0 = time.perf_counter()
    batches = [tuple(t.cpu() for t in synthetic_batch(PAR_BATCH, 20 + i))
               for i in range(PAR_STEPS)]
    torch.save(batches, work / "batches.pt")
    trainer, state = _par_trainer(False)
    step = trainer.make_train_step()
    ref_losses = []
    for b in batches:
        state, s = step(state, *(t.cuda() for t in b))
        ref_losses.append(float(s["loss/total"]))
    ref = {k: v.cpu() for k, v in state.net.state_dict().items()}
    del trainer, state, step
    torch.cuda.empty_cache()
    run_ranks(_par_steps, 2, str(work / "batches.pt"), str(work))
    out["steps"] = {"reference_losses": ref_losses}
    for name in ("dp2", "tp2"):
        got = torch.load(work / f"{name}.pt", weights_only=False)
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], ref_losses))
        # each tensor relative to its largest value (at least 1): a BN
        # variance of 1e3 carries fp32 rounding of 1e-4 by itself
        err, worst = max(
            (float((got["sd"][k] - ref[k]).abs().max())
             / max(1.0, float(ref[k].abs().max())), k) for k in ref)
        if loss_err > PAR_TOL or err > PAR_TOL:
            fail(f"parallel: {name}: losses within {loss_err:.2e}, "
                 f"parameters and BN statistics within {err:.2e} ({worst}) "
                 f"of the single-process steps (tolerance {PAR_TOL})")
        timing = [json.loads((work / f"timing{r}.json").read_text())[name]
                  for r in range(2)]
        out["steps"][name] = dict(
            loss_rel_err=loss_err, state_rel_err=err, worst_tensor=worst,
            losses=got["losses"],
            bf16_ms_per_rank=[float(np.median(t["ms"])) for t in timing],
            bf16_ms=[t["ms"] for t in timing],
            first_step_ms=[t["first_ms"] for t in timing],
            peak_bytes_per_rank=[t["peak_bytes"] for t in timing])
        s = out["steps"][name]
        log(f"parallel: (b) {name}, 2 ranks on one card over gloo, global "
            f"batch {PAR_BATCH}: {PAR_STEPS} fp32 steps of the committed "
            f"export hold the single-process steps (losses within "
            f"{loss_err:.2e}, parameters and BN statistics within "
            f"{err:.2e} of each tensor's scale, worst {worst}); bf16 step "
            + " / ".join(f"{m:.1f}" for m in s["bf16_ms_per_rank"])
            + " ms per rank (median of {}, CUDA events), peak ".format(
                PAR_TIMED)
            + " / ".join(f"{p / 2 ** 30:.2f}" for p in
                         s["peak_bytes_per_rank"])
            + f" GiB per rank: two ranks on one card over gloo, host-staged "
            f"all_reduce: not a multi-card figure; on {card}")
    out["steps"]["wall_s"] = time.perf_counter() - t0

    # (c) the multi-process server at world 1, with one client
    t0 = time.time()
    ckpt = work / "ckpt"
    ckpt.mkdir()
    port = free_port()
    common = ["--board_size", "19", "--num_block", "20", "--dim", "256",
              "--port", str(port), "--num_rollouts", str(FLEET_ROLLOUTS),
              "--rollouts_per_batch", str(TRAIN_PER_BATCH),
              "--ckpt_dir", str(ckpt)]
    procs, files = {}, []

    def spawn(name, cmd):
        f = open(log_dir / f"{name}.log", "w")
        files.append(f)
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                       stderr=subprocess.STDOUT, text=True)

    def tails() -> str:
        return "\n".join(f"----- {n} -----\n"
                         f"{(log_dir / f'{n}.log').read_text()[-3000:]}"
                         for n in procs)

    try:
        spawn("server", [
            sys.executable, str(ROOT / "scripts/train_server_torch.py"),
            "--dist_coordinator", f"127.0.0.1:{free_port()}",
            "--dist_num_processes", "1", "--dist_process_id", "0",
            "--use_mesh", "1",
            "--load", str(ROOT / "runs/prove19/export-best.bin"),
            "--batchsize", str(TRAIN_BATCH), "--num_minibatch",
            str(FLEET_MINIBATCH), "--num_cooldown", str(TRAIN_COOLDOWN),
            "--expected_num_clients", "1",
            "--selfplay_init_num", str(FLEET_INIT),
            "--num_reader", "2", "--q_min_size", "0", *common])
        deadline = t0 + FLEET_DEADLINE_S
        if not wait_in_log(str(log_dir / "server.log"), "server up on :",
                           procs["server"], deadline, "server ready"):
            fail(f"parallel: the --dist_* server was not ready\n{tails()}")
        ready_s = time.time() - t0
        saved = sorted(p.name for p in ckpt.glob("save-*.bin"))
        spawn("client", [
            sys.executable, str(ROOT / "scripts/selfplay_client_torch.py"),
            "--num_games", str(FLEET_B), "--move_cutoff", str(TRAIN_CUTOFF),
            "--moves_per_round", str(TRAIN_CUTOFF), "--seed", "7", *common])
        if not wait_in_log(str(log_dir / "client.log"),
                           "loaded model version", procs["client"], deadline,
                           "client load"):
            fail(f"parallel: the client did not load the checkpoint\n"
                 f"{tails()}")
        loaded_s = time.time() - t0
    finally:
        clean = stop_all([p for n, p in procs.items() if n == "client"],
                         signal.SIGTERM, 60)
        if "server" in procs:
            clean &= stop_all([procs["server"]], signal.SIGINT, 60)
        for f in files:
            f.close()
    if not clean:
        fail(f"parallel: a server or client process had to be killed\n"
             f"{tails()}")
    server_log = (log_dir / "server.log").read_text()
    if ("training on mesh {'dp': 1, 'tp': 1} (1 processes)" not in server_log
            or "(nccl)" not in server_log):
        fail(f"parallel: the server did not train on the NCCL world-1 mesh\n"
             f"{tails()}")
    client = log_summary(log_dir / "client.log")
    if client is None:
        fail(f"parallel: the client logged no summary\n{tails()}")
    out["server"] = dict(ready_s=ready_s, first_checkpoints=saved,
                         client_loaded_s=loaded_s,
                         client_launches=client["kernel_launches"])
    log(f"parallel: (c) train_server_torch.py --dist_* at world 1 (NCCL): "
        f"{saved} written and the server up {ready_s:.1f} s after its "
        f"launch (20b256c export loaded onto fp32 masters); the client "
        f"loaded it {loaded_s:.1f} s after the server's launch; on {card}")

    # (d) the sharded actor, against an unsharded one's launch counts
    t0 = time.perf_counter()
    net = load_model(str(ROOT / "runs/prove19/export-best.bin"),
                     ModelConfig(), "cuda")
    actor = par_actor()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    plain_records = actor.play_moves(net, None, PAR_MOVES)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    plain_launches = kernels.launch_counts()
    del net, actor
    torch.cuda.empty_cache()
    run_ranks(_par_actor, 2, str(work))
    ranks = [json.loads((work / f"actor{r}.json").read_text())
             for r in range(2)]
    launches = {k: client["kernel_launches"][k] for k in plain_launches}
    out["actor"] = {"unsharded": dict(launches=plain_launches,
                                      seconds=plain_s)}
    for name, rollouts in (("dp2", SLICE_ROLLOUTS), ("tp2", PAR_TP_ROLLOUTS)):
        r0, r1 = ranks[0][name], ranks[1][name]
        # the unsharded actor's calls over a rank's boards: one step per
        # rollout and per move, one legal mask per move
        expected = {"step_analysis": (rollouts + 1) * PAR_MOVES,
                    "analyze_libs": PAR_MOVES}
        if name == "dp2" and plain_launches != expected:
            fail(f"parallel: the unsharded actor launched {plain_launches}, "
                 f"expected {expected}")
        for r in (r0, r1):
            for k, n in r["launches"].items():
                launches[k] += n
                if n <= 0:
                    fail(f"parallel: {name}: {k} was not launched on a rank")
                if n != expected[k]:
                    fail(f"parallel: {name}: {k} launched {n} times on a "
                         f"rank, the unsharded actor {expected[k]}")
        if r1["records"] or r0["completed"] != PAR_B \
                or [t for t, _ in r0["records"]] != list(range(PAR_B)):
            fail(f"parallel: {name}: rank 0 did not return every record in "
                 "board order, or rank 1 returned some")
        moves = [sgf_string_to_moves(c, 19) for _, c in r0["records"]]
        replay_is_legal(moves, 19)
        seconds = max(r0["seconds"], r1["seconds"])
        out["actor"][name] = dict(
            rollouts=rollouts,
            launches_per_rank=[r0["launches"], r1["launches"]],
            seconds=seconds, moves_per_s=PAR_B * PAR_MOVES / seconds,
            boards=[r0["boards"], r1["boards"]])
        same = ""
        if name == "dp2":
            share = float(np.mean([a == b for a, b in zip(
                moves, [sgf_string_to_moves(r.result.content, 19)
                        for r in plain_records])]))
            out["actor"][name]["games_equal_to_unsharded"] = share
            same = (f"; {100 * share:.0f} % of the games equal the unsharded "
                    "actor's (bf16 leaves at another batch)")
        log(f"parallel: (d) actor {name}, 2 ranks on one card over gloo, B "
            f"{PAR_B} ({r0['boards']} and {r1['boards']}), {rollouts} "
            f"rollouts: {PAR_MOVES} moves in {seconds:.2f} s "
            f"({PAR_B * PAR_MOVES / seconds:.2f} moves/s, first moves "
            f"included), legal on host replay, every record on rank 0; "
            f"launches per rank {r0['launches']}, the unsharded actor's "
            f"over all {PAR_B} boards{same}; on {card}")
    out["actor"]["wall_s"] = time.perf_counter() - t0
    out["launches"] = launches
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"parallel: launches {launches} (client and ranks); the phase's "
        f"wall time {out['phase_s']:.1f} s (host clock), on {card}")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 14: the tools layer (ladder suite, match, Elo, demo, search profile)
# ---------------------------------------------------------------------------

# the tools phase: the probes' move numbers in each golden game, the match
# and Elo processes' games, the in-process search match (boards, rollouts,
# move cutoff), the demo's iterations and rollouts (9x9 games end by ply
# 161, so 14 iterations of 12 moves train at least once; rollouts cut from
# 48), the profile's batches and timed calls, and the top-two
# log-probability gap above which the card's fp32 scorecard must pick the
# CPU's move
TOOLS_PROBE_MOVES = (10, 20, 35, 50, 70, 90, 120, 150)
TOOLS_GAMES = 4
TOOLS_H2H_B, TOOLS_H2H_ROLLOUTS, TOOLS_H2H_CUTOFF = 8, 16, 24
TOOLS_DEMO_ITERS, TOOLS_DEMO_ROLLOUTS = 14, 8
TOOLS_PROFILE_B, TOOLS_PROFILE_ITERS = (16, 1, 32), 2
TOOLS_GAP = 1e-3


def run_scripts(runs, timeout_s: float = 900):
    """`python <rel> args` for each (rel, args, log_name) of `runs`, all
    started together from the repository root; each one's output goes to
    chiprun_out/tools/<log_name>.  Fails the run when one exits non-zero
    or runs past `timeout_s` (every process is stopped first).  Returns
    [(stdout, stderr, wall seconds)] in the order of `runs`."""
    logs = ROOT / "chiprun_out" / "tools"
    procs, files = [], []
    try:
        t0 = time.perf_counter()
        for rel, args, log_name in runs:
            files += [open(logs / f"{log_name}.out", "w"),
                      open(logs / f"{log_name}.err", "w")]
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / rel), *args], cwd=ROOT,
                stdout=files[-2], stderr=files[-1]))
        walls = [None] * len(procs)
        while None in walls:
            time.sleep(0.2)
            for i, proc in enumerate(procs):
                if walls[i] is None and proc.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout_s:
                fail(f"tools: {[r[0] for r in runs]} ran past {timeout_s} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
    out = []
    for (rel, _, log_name), proc, wall in zip(runs, procs, walls):
        stdout = (logs / f"{log_name}.out").read_text()
        stderr = (logs / f"{log_name}.err").read_text()
        if proc.returncode != 0:
            fail(f"tools: {rel} exited with {proc.returncode}\n"
                 f"{stderr[-3000:]}")
        out.append((stdout, stderr, wall))
    return out


def load_script_module(rel: str):
    """A script of the repository as a module, its `main` not run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "tools_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(rel: str, argv):
    """`main(argv)` of a script of the repository in this process, its
    standard output and error captured.  Returns (return value, stdout,
    stderr)."""
    import contextlib
    import io

    mod = load_script_module(rel)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def build_ladder_suite(root: Path):
    """A suite in `root` from the golden 19x19 games without start
    stones: ladder/g<i>.sgf and a ladder_list of probes at
    TOOLS_PROBE_MOVES.  Returns the games' move lists."""
    import gzip

    from elf_tpu_torch.sgf import game_from_moves, serialize_sgf

    with gzip.open(ROOT / "tests" / "golden" / "ref_traj_19.jsonl.gz",
                   "rt") as f:
        rows = [json.loads(line) for line in f]
    games = [[int(a) for a in r["actions"]] for r in rows
             if set(r["start_stones"]) == {"0"}]
    (root / "ladder").mkdir(parents=True)
    lines = []
    for i, moves in enumerate(games):
        (root / "ladder" / f"g{i}.sgf").write_text(
            serialize_sgf(game_from_moves(moves, 19)))
        lines += [f"g{i}.sgf {n}\n" for n in TOOLS_PROBE_MOVES]
    (root / "ladder_list").write_text("".join(lines))
    return games


def probe_moves(res, probes):
    """The move a LadderResult picked at each (sgf_path, n, expected)
    probe, in GTP: the expected move unless it is among the failures."""
    from elf_tpu_torch.env.go.coords import flat_to_gtp

    missed = {(f[0], f[1]): f[3] for f in res.failures}
    return [missed.get((Path(p).name, n), flat_to_gtp(e, 19))
            for p, n, e in probes]


def tools_ladder(card: str, suite: Path, games) -> dict:
    """(a) The ladder tools at 19x19 20b256c on the card, on the suite the
    phase built from the golden games."""
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.env.go import state as gostate
    from elf_tpu_torch.models.resnet import (
        ModelConfig,
        eval_fn_builder,
        load_model,
    )
    from elf_tpu_torch.native.ladder import read_ladder
    from elf_tpu_torch.native.replayer import (
        replay_to_snapshots,
        replay_to_snapshots_ref,
    )
    from elf_tpu_torch.tools import ladder

    export = str(ROOT / "runs/prove19/export-best.bin")
    out = {}
    launches = {"step_analysis": 0, "analyze_libs": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # batch_replay of every game: legal, the C replayer's boards, L launches
    L = max(len(g) for g in games)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    illegal, st = ladder.batch_replay(games, 19, device="cuda")
    torch.cuda.synchronize()
    out["batch_replay_s"] = time.perf_counter() - t0
    got = kernels.launch_counts()
    add(got)
    if illegal.any():
        fail(f"tools: batch_replay found illegal golden moves at "
             f"{np.argwhere(illegal).tolist()}")
    for i, moves in enumerate(games):
        ref = torch.from_numpy(replay_to_snapshots(moves, 19)[-1])
        if not torch.equal(st.core.stones[i].cpu(), ref):
            fail(f"tools: batch_replay's final board {i} differs from the "
                 "C replayer's")
    if got != {"step_analysis": L, "analyze_libs": 0}:
        fail(f"tools: batch_replay launched {got}, expected {L} "
             "step_analysis")

    old_suite = ladder.DEFAULT_SUITE
    ladder.DEFAULT_SUITE = str(suite)
    try:
        entries = ladder.load_suite()
        moves_of = {p: ladder.load_moves(p)[0] for p, _ in entries}
        probes = [(p, n, moves_of[p][n]) for p, n in entries
                  if n < len(moves_of[p])]
        P = len(probes)
        L_probe = max(n for _, n, _ in probes)

        # the oracle evaluator scores every probe
        expected = torch.tensor([e for _, _, e in probes], device="cuda")

        def oracle(feats, to_play):
            lp = torch.full((feats.shape[0], 362), -1e6, device=feats.device)
            lp[torch.arange(P, device=feats.device), expected] = 0.0
            return lp, torch.zeros(feats.shape[0], device=feats.device)

        kernels.reset_launch_counts()
        res = ladder.ladder_policy_scorecard(oracle, device="cuda")
        got = kernels.launch_counts()
        add(got)
        if (res.matched, res.total) != (P, P):
            fail(f"tools: the oracle scored {res.matched}/{res.total} of {P}")
        if got != {"step_analysis": L_probe, "analyze_libs": 1}:
            fail(f"tools: the scorecard launched {got}, expected "
                 f"{L_probe} step_analysis + 1 analyze_libs")

        # the export in fp32 on the card against the CPU
        cfg32 = ModelConfig(use_bf16=False)
        seen = {}

        def capture(net, key):
            def eval_fn(feats, to_play):
                lp, v = net(feats)
                seen[key] = lp.float().cpu()
                return lp, v
            return eval_fn

        kernels.reset_launch_counts()
        card32 = ladder.ladder_policy_scorecard(
            capture(load_model(export, cfg32, "cuda"), "cuda"), device="cuda")
        add(kernels.launch_counts())
        cpu32 = ladder.ladder_policy_scorecard(
            capture(load_model(export, cfg32, "cpu"), "cpu"), device="cpu")
        _, st_cpu = ladder.batch_replay([moves_of[p][:n] for p, n, _ in probes],
                                        19, device="cpu")
        lm = gostate.legal_moves(st_cpu, 19)
        top2 = torch.where(lm, seen["cpu"], -float("inf")).topk(2, dim=1)[0]
        clear = (top2[:, 0] - top2[:, 1] > TOOLS_GAP).tolist()
        a, b = probe_moves(card32, probes), probe_moves(cpu32, probes)
        differ = [i for i in range(P) if clear[i] and a[i] != b[i]]
        if differ or sum(clear) == 0:
            fail(f"tools: the fp32 scorecard on the card picks other moves "
                 f"than the CPU at probes {differ} ({sum(clear)} of {P} "
                 f"have a top-two gap > {TOOLS_GAP})")
        out["fp32"] = dict(matched=card32.matched, total=card32.total,
                           cpu_matched=cpu32.matched, compared=sum(clear),
                           max_abs_log_pi_diff=float(
                               (seen["cuda"] - seen["cpu"]).abs().max()))

        # bf16, timed (host clock up to a synchronise, after a warm-up)
        eval16 = eval_fn_builder(load_model(export, ModelConfig(), "cuda"))
        kernels.reset_launch_counts()
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            card16 = ladder.ladder_policy_scorecard(eval16, device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        add(kernels.launch_counts())
        out["bf16"] = dict(matched=card16.matched, total=card16.total,
                           scorecard_ms=[t * 1e3 for t in times[1:]],
                           first_ms=times[0] * 1e3)

        # ladder_bench_torch in this process, raw policy then a search
        bench = {}
        for mode, extra, n_probes in (
                ("raw_policy", [], P),
                (f"mcts{SLICE_ROLLOUTS}",
                 ["--num_rollouts", str(SLICE_ROLLOUTS), "--limit", "8"], 8)):
            kernels.reset_launch_counts()
            _, stdout, stderr = run_main(
                "scripts/ladder_bench_torch.py",
                ["--load", export, "--num_block", "20", "--dim", "256",
                 *extra])
            got = kernels.launch_counts()
            add(got)
            (ROOT / "chiprun_out" / "tools" / f"ladder_bench_{mode}.log"
             ).write_text(stdout + "\n----- stderr -----\n" + stderr)
            row = json.loads(stdout.strip().splitlines()[-1])
            if (row["total"], row["mode"], row["weights"]) != (
                    n_probes, mode, "ckpt"):
                fail(f"tools: ladder_bench printed {row}")
            replayed = sum(n for _, n, _ in probes[:n_probes])
            rollouts = SLICE_ROLLOUTS if extra else 0
            want = {"step_analysis": replayed + n_probes * rollouts,
                    "analyze_libs": n_probes}
            if got != want:
                fail(f"tools: ladder_bench {mode} launched {got}, expected "
                     f"{want}")
            bench[mode] = dict(row, launches=got)
        out["ladder_bench"] = bench

        # classify_suite (host ladder reader) against a classification from
        # the plain replayer
        t = ladder.classify_suite()
        ref = []
        for p, n in entries:
            moves = moves_of[p]
            board = (replay_to_snapshots_ref(moves[:n - 1], 19)[-1]
                     if n > 1 else np.zeros(361, np.int8))
            ref.append((Path(p).name, n, moves[n - 1]) + read_ladder(
                board, moves[n - 1], 1 if (n - 1) % 2 == 0 else 2, 19))
        mine = [(r.sgf, r.move_number, r.played, r.classification, r.depth)
                for r in t]
        if mine != ref:
            fail("tools: classify_suite differs from the plain replayer's "
                 "classification")
        out["classify"] = {c: sum(r.classification == c for r in t)
                           for c in ("capture", "doomed_escape", "none")}
    finally:
        ladder.DEFAULT_SUITE = old_suite
    out.update(probes=P, launches=launches)
    log(f"tools: ladder suite of {len(games)} golden games, {P} probes: "
        f"batch_replay {out['batch_replay_s'] * 1e3:.1f} ms for {L} plies; "
        f"export fp32 {card32.matched}/{P} on the card, {cpu32.matched}/{P} "
        f"on the CPU ({sum(clear)} probes compared, max |dlog_pi| "
        f"{out['fp32']['max_abs_log_pi_diff']:.2e}); bf16 {card16.matched}/"
        f"{P}, scorecard {np.median(times[1:]) * 1e3:.1f} ms; ladder_bench "
        f"raw {bench['raw_policy']['matched']}/{P} in "
        f"{bench['raw_policy']['wall_s']} s, mcts "
        f"{bench[f'mcts{SLICE_ROLLOUTS}']['matched']}/8 in "
        f"{bench[f'mcts{SLICE_ROLLOUTS}']['wall_s']} s; classify "
        f"{out['classify']}, on {card}")
    return out


def tools_match(card: str, work: Path) -> dict:
    """(b) The match and Elo scripts as processes side by side (the
    committed export against its random init, policy-only, whole games),
    then `head_to_head` on a pair-eval search actor in this process."""
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import ModelConfig, load_model
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import (
        ActorConfig,
        SelfplayActor,
        make_pair_eval_builder,
    )
    from elf_tpu_torch.tools.match import elo_diff, head_to_head

    export = str(ROOT / "runs/prove19/export-best.bin")
    init = str(ROOT / "runs/prove19/init_params.bin")
    width = ["--board_size", "19", "--num_block", "20", "--dim", "256"]
    out = {}
    launches = {"step_analysis": 0, "analyze_libs": 0}

    def add(counts, what):
        if min(counts.values()) <= 0:
            fail(f"tools: {what} launched {counts}")
        for k in launches:
            launches[k] += counts[k]

    ckpts = work / "ckpts"
    ckpts.mkdir()
    (ckpts / "save-648.bin").symlink_to(export)
    elo_args = ["--ckpt_dir", str(ckpts), "--include_init", init,
                "--board_size", "19", "--blocks", "20", "--dim", "256",
                "--games_per_pair", str(TOOLS_GAMES), "--num_rollouts", "0"]
    # the three processes side by side (each is host-bound on its own core)
    match, elo, pairs = run_scripts([
        ("scripts/eval_match_torch.py",
         ["--a", export, "--b", init, *width, "--num_eval_games",
          str(TOOLS_GAMES), "--num_rollouts", "0"], "eval_match"),
        ("scripts/elo_progression_torch.py", elo_args, "elo_progression"),
        ("scripts/elo_progression_torch.py", [*elo_args, "--pairs", "648:0"],
         "elo_pairs")])

    stdout, stderr, wall = match
    m = re.fullmatch(r"A=export-best\.bin vs B=init_params\.bin: (\d+)/(\d+) "
                     r"= (\d\.\d{3})  elo_diff=([+-]\d+\.\d)  \(.*\)\n", stdout)
    lines = stderr.strip().splitlines()
    games = [l for l in lines if l.startswith("game ")]
    if not m or int(m.group(2)) != TOOLS_GAMES or len(games) != TOOLS_GAMES:
        fail(f"tools: eval_match printed {stdout!r}")
    summ = json.loads(lines[-1])
    add(summ["kernel_launches"], "eval_match")
    out["eval_match"] = dict(line=stdout.strip(), games=games, wall_s=wall,
                             launches=summ["kernel_launches"])

    stdout, stderr, wall = elo
    rows = [json.loads(l) for l in stdout.splitlines()]
    if (len(rows) != 2 or rows[0] != {"step": 0, "elo": 0.0, "anchor": True}
            or (rows[1]["step"], rows[1]["vs_step"], rows[1]["n"])
            != (648, 0, TOOLS_GAMES)
            or rows[1]["elo_delta"] != round(elo_diff(
                rows[1]["wins"] / TOOLS_GAMES), 1)):
        fail(f"tools: elo_progression printed {stdout!r}")
    summ = json.loads(stderr.strip().splitlines()[-1])
    add(summ["kernel_launches"], "elo_progression")
    out["elo_progression"] = dict(rows=rows, wall_s=wall,
                                  launches=summ["kernel_launches"])

    stdout, stderr, wall = pairs
    (row,) = [json.loads(l) for l in stdout.splitlines()]
    if (row["n"] != TOOLS_GAMES or not row["direct"]
            or row["wins_as_black"] + row["wins_as_white"] != row["wins"]):
        fail(f"tools: elo_progression --pairs printed {stdout!r}")
    summ = json.loads(stderr.strip().splitlines()[-1])
    add(summ["kernel_launches"], "elo_progression --pairs")
    out["elo_pairs"] = dict(row=row, wall_s=wall,
                            launches=summ["kernel_launches"])

    # the search path in this process: B boards, games cut at
    # TOOLS_H2H_CUTOFF moves, each half played in calls of 16 moves
    cfg = ModelConfig()
    a_net = load_model(export, cfg, "cuda")
    b_net = load_model(init, cfg, "cuda")
    actor = SelfplayActor(
        ActorConfig(board_size=19, batch=TOOLS_H2H_B, policy_distri_cutoff=0,
                    resign_thres=0.0, never_resign_prob=1.0,
                    move_cutoff=TOOLS_H2H_CUTOFF),
        MCTSConfig(num_rollouts=TOOLS_H2H_ROLLOUTS,
                   rollouts_per_batch=SLICE_PER_BATCH, root_epsilon=0.0),
        make_pair_eval_builder(lambda net, bs, feats: net(feats)), seed=5,
        device="cuda")
    sink = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    wins, total = head_to_head(actor, (a_net, None), (b_net, None),
                               TOOLS_H2H_B, record_sink=sink)
    torch.cuda.synchronize()
    h2h_s = time.perf_counter() - t0
    got = kernels.launch_counts()
    add(got, "head_to_head")
    # every half plays whole calls of 16 moves until its games are cut
    moves = 2 * 16 * -(-TOOLS_H2H_CUTOFF // 16)
    want = {"step_analysis": moves * (TOOLS_H2H_ROLLOUTS + 1),
            "analyze_libs": moves}
    if total != 2 * TOOLS_H2H_B or got != want:
        fail(f"tools: head_to_head played {total} games with launches "
             f"{got}, expected {2 * TOOLS_H2H_B} and {want}")
    played = [sgf_string_to_moves(r.result.content, 19) for r, _ in sink]
    if any(len(p) != TOOLS_H2H_CUTOFF for p in played):
        fail(f"tools: head_to_head games of {[len(p) for p in played]} moves")
    replay_is_legal(played, 19)
    out["head_to_head"] = dict(wins=wins, total=total, seconds=h2h_s,
                               moves=moves, launches=got)
    out["launches"] = launches
    log(f"tools: eval_match {out['eval_match']['line']} "
        f"({out['eval_match']['wall_s']:.1f} s process wall); elo "
        f"{rows[1]} ({out['elo_progression']['wall_s']:.1f} s); --pairs "
        f"{row} ({out['elo_pairs']['wall_s']:.1f} s; the three side by "
        f"side); head_to_head B "
        f"{TOOLS_H2H_B}, {TOOLS_H2H_ROLLOUTS} rollouts, cut at "
        f"{TOOLS_H2H_CUTOFF}: {wins}/{total} in {h2h_s:.1f} s, launches "
        f"{got}; on {card}")
    return out


def tools_demo(card: str, work: Path) -> dict:
    """(c) demo_train_9x9_torch in this process at its default widths (3
    blocks, 48 channels, 96 boards; TOOLS_DEMO_ROLLOUTS rollouts): its
    JSON lines, a finite loss, and the random init the final eval plays
    against equal to the init as drawn."""
    import contextlib
    import io

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.tools import match
    from elf_tpu_torch.training.trainer import Trainer

    mod = load_script_module("scripts/demo_train_9x9_torch.py")
    played = []

    def recording(actor, a_state, b_state, games_per_half, **kw):
        played.append((copy.deepcopy(a_state[0]), copy.deepcopy(b_state[0])))
        return match.head_to_head(actor, a_state, b_state, games_per_half,
                                  **kw)

    mod.head_to_head = recording
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(["--iters", str(TOOLS_DEMO_ITERS), "--rollouts",
                  str(TOOLS_DEMO_ROLLOUTS), "--final_eval", "policy",
                  "--out", str(work / "demo9")])
    wall = time.perf_counter() - t0
    got = kernels.launch_counts()
    text = buf.getvalue()
    (ROOT / "chiprun_out" / "tools" / "demo_train_9x9.log").write_text(text)
    try:
        lines = [json.loads(l) for l in text.splitlines()]
    except ValueError:
        fail(f"tools: the demo printed a line that is not JSON:\n{text}")
    losses = [l["loss"] for l in lines if "loss" in l]
    if not losses or not all(np.isfinite(losses)):
        fail(f"tools: the demo's losses {losses}")
    final = lines[-1]
    if not final.get("final") or "policy_only_winrate" not in final:
        fail(f"tools: the demo's summary {final}")
    init = Trainer(ModelConfig(board_size=9, num_block=3, dim=48),
                   TrainOptions(num_block=3, dim=48), device="cuda"
                   ).init_state(torch.Generator().manual_seed(0)).net
    (trained, random0), = played
    for (name, x), y in zip(init.state_dict().items(),
                            random0.state_dict().values()):
        if not torch.equal(x, y):
            fail(f"tools: the demo's init snapshot changed at {name}")
    if all(torch.equal(x, y) for x, y in zip(
            init.state_dict().values(), trained.state_dict().values())):
        fail("tools: the demo's trained net equals its init")
    if min(got.values()) <= 0:
        fail(f"tools: the demo launched {got}")
    log(f"tools: demo_train_9x9 {TOOLS_DEMO_ITERS} iterations at "
        f"{TOOLS_DEMO_ROLLOUTS} rollouts: "
        f"{lines[-2]['games']} games, step {lines[-2]['step']}, last loss "
        f"{losses[-1]}, final {final}, {wall:.1f} s, launches {got}, on "
        f"{card}")
    return dict(lines=lines, wall_s=wall, launches=got)


def tools_profile(card: str) -> dict:
    """(d) profile_mcts_torch in this process at B = 16 (its default, with
    a trace, kept gzipped in chiprun_out/tools/), 1 and 32: the three
    variants' times and the launch counts the code fixes."""
    import gzip
    import shutil

    out = {"runs": []}
    launches = {"step_analysis": 0, "analyze_libs": 0}
    trace_dir = ROOT / "build" / "tools_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    for B in TOOLS_PROFILE_B:
        argv = ["--B", str(B), "--iters", str(TOOLS_PROFILE_ITERS)]
        traced = B == TOOLS_PROFILE_B[0]
        if traced:
            argv += ["--trace_dir", str(trace_dir)]
        rc, stdout, stderr = run_main("scripts/profile_mcts_torch.py", argv)
        row = json.loads(stdout)
        got = json.loads(stderr.strip().splitlines()[-1])["kernel_launches"]
        calls = TOOLS_PROFILE_ITERS + 1
        want = {
            "full": {"step_analysis": (calls + traced) * SLICE_ROLLOUTS,
                     "analyze_libs": calls + traced},
            "nn_only": {"step_analysis": 0, "analyze_libs": 0},
            "tree_only": {"step_analysis": calls * SLICE_ROLLOUTS,
                          "analyze_libs": calls},
        }
        if rc != 0 or got != want or row["B"] != B:
            fail(f"tools: profile_mcts B {B}: rc {rc}, launches {got}, "
                 f"expected {want}")
        for v in got.values():
            for k in launches:
                launches[k] += v[k]
        out["runs"].append(dict(row, launches=got))
        log(f"tools: profile_mcts B {B}: full {row['t_full_ms']} ms, "
            f"nn_only {row['t_nn_only_ms']} ms, tree_only "
            f"{row['t_tree_only_ms']} ms, nn_fraction {row['nn_fraction']}, "
            f"{row['rollouts_per_s_full']} rollouts/s, on {card}")
    traces = sorted(trace_dir.glob("*.json"))
    if len(traces) != 1 or traces[0].stat().st_size == 0:
        fail(f"tools: profile_mcts wrote traces {traces}")
    kept = ROOT / "chiprun_out" / "tools" / (traces[0].name + ".gz")
    with open(traces[0], "rb") as f, gzip.open(kept, "wb") as g:
        shutil.copyfileobj(f, g)
    log(f"tools: profile_mcts trace {traces[0].stat().st_size} bytes, kept "
        f"as {kept.relative_to(ROOT)} ({kept.stat().st_size} bytes)")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out.update(trace=str(kept.relative_to(ROOT)), launches=launches)
    return out


def tools_phase(card: str) -> dict:
    """The tools layer at 19x19 20b256c with the committed weights: (a)
    the ladder tools on a suite built from the golden games, (b) the match
    and Elo scripts as processes and a search match in this process, (c)
    the 9x9 learning demo, (d) the search profile at B = 16, 1 and 32.
    Launch counts: the sum of the parts' (this process's and the
    processes' exit summaries)."""
    import shutil

    phase_t0 = time.perf_counter()
    shutil.rmtree(ROOT / "chiprun_out" / "tools", ignore_errors=True)
    (ROOT / "chiprun_out" / "tools").mkdir(parents=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        games = build_ladder_suite(work / "suite")
        out = {"card": card,
               "ladder": tools_ladder(card, work / "suite", games),
               "match": tools_match(card, work),
               "demo": tools_demo(card, work),
               "profile": tools_profile(card)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {k: sum(out[p]["launches"][k] for p in
                              ("ladder", "match", "demo", "profile"))
                       for k in ("step_analysis", "analyze_libs")}
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"tools: launches {out['launches']}; the phase's wall time "
        f"{out['phase_s']:.1f} s (host clock), on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 15: bench_torch.py's stages in this process
# ---------------------------------------------------------------------------

# the env chunk's boards replayed on the host, and the production stage's
# rollouts (cut from 1600: the full run is `python3 bench_torch.py`)
BENCH_REPLAY_B, BENCH_PROD_ROLLOUTS = 256, 64


def bench_env(bt, card: str, kernel_ms: float, counted) -> dict:
    """The env stage at full size (B = 4096, 64-step chunks, 4 timed after
    3 warm-up): exact launches; one more chunk with its actions, the first
    `BENCH_REPLAY_B` boards replayed on the host through the plain
    versions with the chunk's reset must end in the card's state bit for
    bit; one more chunk under torch.profiler."""
    from elf_tpu_torch.env.go import engine

    B, size, chunk, iters = 4096, 19, 64, 4      # bench_torch's defaults
    env = {}
    sps = counted("env", lambda: bt.bench_env_steps(B, size, chunk, iters,
                                                    out=env),
                  {"step_analysis": chunk * (3 + iters), "analyze_libs": 0})
    step_ms = B / sps * 1e3

    actions = []
    start = env["core"]
    core, legal, illegal = bt.rollout_chunk(env["fresh"], start, env["legal"],
                                            env["gen"], size, chunk, actions)
    if bool(illegal.any()):
        fail("bench: env: the replayed chunk drew an illegal action")

    def host(c):
        return engine.GoCore(*(t[:BENCH_REPLAY_B].cpu() for t in c))

    fresh_h, core_h, resets = host(env["fresh"]), host(start), 0
    for a in actions:
        core_h, info = engine.step_core(core_h, a[:BENCH_REPLAY_B].cpu(),
                                        size)
        if bool(info.illegal.any()):
            fail("bench: env: an action is illegal on host replay")
        done = engine.is_terminal_core(core_h, size)
        resets += int(done.sum())
        core_h = bt.reset_finished(fresh_h, core_h, done)
        legal_h = info.legal_next | done[:, None]
    for name, h, c in zip(engine.GoCore._fields, core_h, host(core)):
        if not torch.equal(h, c):
            fail(f"bench: env: {name} after host replay differs from the "
                 "card's")
    if not torch.equal(legal_h, legal[:BENCH_REPLAY_B].cpu()):
        fail("bench: env: the legal mask after host replay differs")

    prof = profile_call(
        lambda: bt.rollout_chunk(env["fresh"], core, legal, env["gen"], size,
                                 chunk),
        f"one env chunk ({chunk} steps) at 19x19 B {B}", card)
    if prof["launches"] != {"step_analysis": chunk, "analyze_libs": 0}:
        fail(f"bench: env: the profiled chunk launched {prof['launches']}")
    out = dict(
        boards=B, chunk=chunk, iters=iters, env_steps_per_s=sps,
        step_ms=step_ms, replay_boards=BENCH_REPLAY_B, replay_resets=resets,
        kernel_ms_graph=kernel_ms,
        kernels_per_step=prof["device_kernels"] / chunk,
        host_copies_and_syncs_per_chunk=prof["host_copies_and_syncs"],
        busy_share=prof["device_busy_share"],
        liberty_kernel_ms_per_step=prof["groups_ms"]["liberty kernels"]
        / chunk,
        profile=prof)
    log(f"bench: env 19x19 B {B}: {sps:,.0f} env steps/s, "
        f"{step_ms:.4f} ms a lockstep step; step_analysis "
        f"{kernel_ms:.6f} ms a launch by graph replay "
        f"({100 * kernel_ms / step_ms:.2f}% of a step); profiled chunk: "
        f"{out['kernels_per_step']:.1f} device ops a step, "
        f"{out['host_copies_and_syncs_per_chunk']} host copies/syncs a "
        f"chunk, card {100 * out['busy_share']:.1f}% busy; the first "
        f"{BENCH_REPLAY_B} boards of one more chunk equal on host replay "
        f"({resets} resets), on {card}")
    return out


def bench_phase(card: str, kernel_ms_4096: float) -> dict:
    """`bench_torch.py`'s stages called in this process at the sizes its
    `main` runs, but production self-play at `BENCH_PROD_ROLLOUTS`
    rollouts: env (`bench_env`), NN forwards at 128 and 1024 (and one at
    1024 under torch.profiler), the B = 16 search, the remat train step at
    2048 (no halving, finite stats) and production self-play at B = 1024
    (legal on host replay).  The launch counts are set to 0 before each
    stage and read after it; where the code fixes them they must be
    exact."""
    import bench_torch as bt

    from elf_tpu_torch.env.go import kernels
    from elf_tpu_torch.models.resnet import ModelConfig, build_model

    phase_t0 = time.perf_counter()
    launches = {"step_analysis": 0, "analyze_libs": 0}
    per_stage = {}

    def counted(stage, fn, want):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        n = kernels.launch_counts()
        if n != want:
            fail(f"bench: {stage}: launches {n}, expected {want}")
        per_stage[stage] = n
        for k in launches:
            launches[k] += n[k]
        bt._release()
        return got

    none = {"step_analysis": 0, "analyze_libs": 0}
    out = {"card": card, "env": bench_env(bt, card, kernel_ms_4096, counted)}

    nn = {}
    for batch in (128, 1024):
        evals = counted(f"nn {batch}", lambda: bt.bench_nn_forward(
            batch=batch), none)
        ms = batch / evals * 1e3
        bound_ms = bt._fwd_flops(batch) / BF16_FLOPS_PER_S * 1e3
        nn[batch] = dict(evals_per_s=evals, forward_ms=ms, bound_ms=bound_ms,
                         bound_share=bound_ms / ms)
        log(f"bench: NN 20b256c bf16 batch {batch}: {evals:,.0f} evals/s, "
            f"{ms:.3f} ms a forward, {100 * bound_ms / ms:.1f}% of its "
            f"{bound_ms:.3f} ms bf16 bound, on {card}")
    # where a forward at 1024 spends its device time: the stage's net
    net = build_model(ModelConfig(), "cuda", seed=0).eval()
    x = torch.zeros((1024, 19, 19, 18), device="cuda")

    def forward():
        with torch.inference_mode():
            net(x)

    forward()
    nn["profile_1024"] = profile_call(forward, "one NN forward at batch 1024",
                                      card)
    del net, x
    out["nn"] = nn

    searches, rollouts = 4, 64
    rps = counted("mcts", bt.bench_mcts_rollouts,
                  {"step_analysis": searches * rollouts,
                   "analyze_libs": searches})
    out["mcts"] = dict(B=16, rollouts=rollouts, rollouts_per_s=rps)
    log(f"bench: MCTS 20b256c B 16, {rollouts} rollouts: {rps:,.0f} "
        f"rollouts/s, on {card}")

    torch.cuda.reset_peak_memory_stats()
    st = {}
    bs, sps, tflops = counted("train", lambda: bt.bench_train_step(out=st),
                              none)
    peak = torch.cuda.max_memory_allocated()
    if bs != 2048:
        fail(f"bench: train: ran at batch {bs}, not 2048")
    if not all(np.isfinite(v) for v in st["stats"].values()):
        fail(f"bench: train: a stat is not finite: {st['stats']}")
    out["train"] = dict(batch=bs, steps_per_s=sps, tflops=tflops,
                        positions_per_s=sps * bs, peak_memory_bytes=peak,
                        stats=st["stats"])
    log(f"bench: train 20b256c remat batch {bs}: {sps:.3f} steps/s "
        f"({1e3 / sps:.1f} ms a step), {sps * bs:,.0f} positions/s, "
        f"{tflops:.1f} TFLOP/s by bench.py's 4x count, loss "
        f"{st['stats']['loss/total']:.4f}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, on {card}")

    torch.cuda.reset_peak_memory_stats()
    p = {}
    boards = 1024
    mps, rps, gph = counted(
        "production",
        lambda: bt.bench_selfplay_prod(rollouts=BENCH_PROD_ROLLOUTS, out=p),
        {"step_analysis": 2 * (BENCH_PROD_ROLLOUTS + 1), "analyze_libs": 2})
    peak = torch.cuda.max_memory_allocated()
    actor = p.pop("actor")
    if actor.cfg.batch != boards:
        fail(f"bench: production ran at B {actor.cfg.batch}")
    stones = replay_is_legal(actor.moves, 19)
    if not torch.equal(stones, actor.state.core.stones):
        fail("bench: production: replayed boards differ from the actor's")
    del actor
    bt._release()
    out["production"] = dict(boards=boards, rollouts=BENCH_PROD_ROLLOUTS,
                             moves_per_s=mps, rollouts_per_s=rps,
                             games_per_hour=gph, peak_memory_bytes=peak)
    log(f"bench: production 19x19 20b256c B {boards}, "
        f"{BENCH_PROD_ROLLOUTS} rollouts: {mps:.2f} moves/s, {rps:,.0f} "
        f"rollouts/s, ~{gph:,.0f} games/hour, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; every move legal on host replay, on "
        f"{card}")

    out.update(launches=launches, launches_by_stage=per_stage,
               phase_s=time.perf_counter() - phase_t0)
    log(f"bench: launches {per_stage}; the phase's wall time "
        f"{out['phase_s']:.1f} s (host clock), on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the 13x13 production protocol's two checkpoints
# ---------------------------------------------------------------------------

# The README's 13x13 command (scripts/prod13_card_torch.sh), and the
# phase's short anchor: games (half a colour), rollouts, the rows of the
# card-against-CPU forward and its tolerance: that of the 19x19 export's
# fp32 forward against flax (tests/test_torch_resnet.py), as cuDNN and the
# CPU sum the 21 convolutions in different orders (2.3e-5 on |log_pi| up
# to 8 was seen on an H100)
PROD13_FLAGS = ["--board_size", "13", "--num_block", "10", "--dim", "128",
                "--num_games", "192", "--client1_num_games", "96",
                "--eval_num_games", "400", "--value_weight", "0.25",
                "--train_bs", "256", "--num_minibatch", "40",
                "--selfplay_init_num", "150", "--selfplay_update_num", "75"]
PROD13_GAMES, PROD13_ROLLOUTS, PROD13_ROWS, PROD13_TOL = 8, 16, 256, 1e-4


def replay_positions(moves_per_board, size: int):
    """Replay each board's moves on the host (plain versions) as
    `replay_is_legal` does, and keep every position before a move: the
    GoState rows, the stones [P, N2] and the colour to play [P] at each,
    and the move played from it [P]."""
    from elf_tpu_torch.env.go import state as gostate

    B, n2 = len(moves_per_board), size * size
    st = gostate.init_state(B, size, "cpu")
    rows, stones, colors, actions = [], [], [], []
    for i in range(max((len(m) for m in moves_per_board), default=0)):
        live = torch.tensor([i < len(m) for m in moves_per_board])
        a = torch.tensor([m[i] if i < len(m) else n2 for m in moves_per_board],
                         dtype=torch.int32)
        rows.append((st, live))
        stones.append(st.core.stones[live])
        colors.append(st.core.to_play[live].to(torch.int32))
        actions.append(a[live])
        st, info = gostate.step(st, a, size)
        if bool((info.illegal & live).any()):
            fail(f"illegal move replayed at ply {i}")
    return rows, torch.cat(stones), torch.cat(colors), torch.cat(actions)


def prod13_phase(card: str) -> dict:
    """The JAX run's two 13x13 10b128c checkpoints (its frozen init and its
    promoted ver 160) on the card: a short anchor through the proof's own
    `final_anchor_match` (tools/prod_anchor_parity.py), every game replayed
    on the host, both kernels held against their plain versions on the
    boards played, and both nets' fp32 forward against the CPU's."""
    from argparse import Namespace

    from elf_tpu_torch.env.go import features, kernels
    from elf_tpu_torch.env.go.coords import sgf_string_to_moves
    from elf_tpu_torch.models.resnet import ModelConfig, load_model

    prod_anchor_parity = load_script_module("tools/prod_anchor_parity.py")
    phase_t0 = time.perf_counter()
    size, n2 = 13, 169
    run = ROOT / "runs" / "prod13"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    line, sink = prod_anchor_parity.anchor(
        Namespace(package="torch", out=str(run), ver=160,
                  games=PROD13_GAMES, cutoff=0, device="cuda"),
        [*PROD13_FLAGS, "--final_rollouts", str(PROD13_ROLLOUTS)])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    m = line["lockstep_moves"]
    want = {"step_analysis": m * (PROD13_ROLLOUTS + 1), "analyze_libs": m}
    if line["n"] != PROD13_GAMES or launches != want:
        fail(f"prod13: the anchor played {line['n']} games with launches "
             f"{launches}, expected {PROD13_GAMES} and {want}")
    played = [sgf_string_to_moves(r.result.content, size) for r, _ in sink]
    if [len(p) for p in played] != [int(r.result.num_move) for r, _ in sink] \
            or max(map(len, played)) > 2 * n2 - 1:
        fail(f"prod13: games of {[len(p) for p in played]} moves")
    rows, stones, colors, actions = replay_positions(played, size)
    log(f"prod13: the anchor, ver 160 against the init, {PROD13_GAMES} games "
        f"at {PROD13_ROLLOUTS} rollouts: {line['wins']}/{line['n']} "
        f"({line['as_black']} as black, {line['as_white']} as white), "
        f"moves {line['moves']}, {m} lockstep moves in {line['wall_s']} s, "
        f"launches {launches}; every move legal on host replay, on {card}")

    # both kernels on every position played, against the plain versions
    dev = torch.device("cuda")
    s_cpu = stones.contiguous()
    worst = {}
    for name, args in (
            ("analyze_libs", (s_cpu.reshape(-1, size, size).contiguous(),)),
            ("step_analysis", (s_cpu, actions, colors))):
        plain = getattr(kernels, f"{name}_ref")(*(a.to(dev) for a in args))
        got = getattr(kernels, f"{name}_cuda")(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        for g_, r_ in zip(got, plain):
            if g_.dtype != r_.dtype or not torch.equal(g_, r_):
                fail(f"prod13: {name} differs from the plain version on the "
                     "13x13 boards played")
        worst[name] = max(int((g_.int() - r_.int()).abs().max())
                          for g_, r_ in zip(got, plain))
    log(f"prod13: both kernels equal to their plain versions on the "
        f"{len(s_cpu)} 13x13 positions played (B = {len(s_cpu)})")

    # both nets' fp32 forward, card against CPU, on positions played
    x = torch.cat([features.extract_agz(
        st, torch.zeros(len(played), dtype=torch.int32), size)[live]
        for st, live in rows])
    x = x[np.sort(np.random.default_rng(13).choice(
        len(x), size=min(len(x), PROD13_ROWS), replace=False))]
    cfg = ModelConfig(board_size=size, num_block=10, dim=128, use_bf16=False)
    errs = {}
    for name in ("init", "promoted-160"):
        path = str(run / f"{name}.bin")
        with torch.no_grad():
            ref = load_model(path, cfg, "cpu")(x)
            got = load_model(path, cfg, "cuda")(x.to(dev))
        errs[name] = max(float((g_.cpu() - r_).abs().max())
                         for g_, r_ in zip(got, ref))
        if not errs[name] <= PROD13_TOL:
            fail(f"prod13: {name} fp32 forward on the card differs from the "
                 f"CPU's by {errs[name]} (tolerance {PROD13_TOL})")
    log(f"prod13: fp32 forward of init / promoted-160 at 13x13 10b128c on "
        f"{len(x)} positions played, card against CPU: max abs error "
        f"{errs['init']:.3g} / {errs['promoted-160']:.3g} (tolerance "
        f"{PROD13_TOL}); the phase's wall time "
        f"{time.perf_counter() - phase_t0:.1f} s, on {card}")
    return dict(anchor=line, launches=launches, positions=len(s_cpu),
                kernel_worst=worst, forward_err=errs, rows=len(x),
                phase_s=time.perf_counter() - phase_t0)


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

    if sys.argv[1:] in (["--only", "nbt"], ["--only", "train_epilogue"],
                        ["--only", "nbt_train"]):
        only = sys.argv[2]
        if only == "nbt":
            result = {"card": card, "kind": kind, "nbt": nbt_phase(card),
                      "nbt_slice": nbt_slice_phase(card)}
            rows = nbt_kernel_rows(result["nbt"], result["nbt_slice"])
        elif only == "nbt_train":
            for line in _build.build("nbt_train_epilogue")[1].splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill", "smem")):
                    log(f"build: {line.strip()}")
            result = {"card": card, "kind": kind,
                      "nbt_train": nbt_train_phase(card)}
            rows = nbt_train_rows(result["nbt_train"])
        else:
            for name in ("net_epilogue", "net_train_epilogue"):
                for line in _build.build(name)[1].splitlines():
                    if any(w in line for w in ("entry function", "registers",
                                               "spill", "smem")):
                        log(f"build: {line.strip()}")
            result = {"card": card, "kind": kind,
                      "train_epilogue": train_epilogue_phase(card)}
            rows = train_epilogue_rows(result["train_epilogue"])
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"chip_smoke_{only}.json").write_text(
            json.dumps(result, indent=1))
        print(card, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    for name in ("go_libs", "net_epilogue", "net_train_epilogue"):
        t0 = time.perf_counter()
        path, text = _build.build(name)
        log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
        for line in text.splitlines():  # registers, smem, spills per kernel
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"build: {line.strip()}")
    for name in ("replayer", "ladder", "sgf_codec"):    # the host C code
        t0 = time.perf_counter()
        path, _ = _build.build(name)
        log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    result = {"card": card, "kind": kind}
    result["kernels"] = kernel_phase(np.random.default_rng(0))
    result["epilogue"] = epilogue_phase(card)
    result["train_epilogue"] = train_epilogue_phase(card)
    result["nbt"] = nbt_phase(card)
    result["nbt_train"] = nbt_train_phase(card)
    result["slice"], net = slice_phase(card)
    result["nbt_slice"] = nbt_slice_phase(card)
    result["records"] = record_phase()
    result["train"] = train_phase(card)
    result["fleet"] = fleet_phase(card)
    result["play"] = play_phase(card)
    result["production"] = production_phase(card)
    result["remat"] = remat_phase(card)
    result["df"] = df_phase(card)
    result["offline"] = offline_phase(card)
    result["parallel"] = parallel_phase(card)
    result["tools"] = tools_phase(card)
    result["bench"] = bench_phase(card, result["kernels"]["timings"][
        ("step_analysis", "mid-game", 4096)]["ms"])
    result["profile"] = profile_phase(card, net)
    result["prod13"] = prod13_phase(card)

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
            "launches_train": result["train"]["launches"][name],
            "launches_fleet": result["fleet"]["launches"][name],
            "launches_play": result["play"]["launches"][name],
            "launches_production": result["production"]["launches"][name],
            "launches_df": result["df"]["launches"][name],
            "launches_offline": result["offline"]["launches"][name],
            "launches_parallel": result["parallel"]["launches"][name],
            "launches_tools": result["tools"]["launches"][name],
            "launches_bench": result["bench"]["launches"][name],
            "launches_prod13": result["prod13"]["launches"][name],
            "max_abs_err": k["worst"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": f"19x19 mid-game B={SLICE_B}",
            "host_ms": t["host_ms"],
            "by_shape": {
                f"{boards} B={B}": {
                    "ms": v["ms"], "host_ms": v["host_ms"],
                    "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"]}
                for (n, boards, B), v in k["timings"].items() if n == name},
        })
    e = result["epilogue"]["timings"]
    rows.append({
        "name": "net_epilogue", "route": "cuda",
        "source": "elf_tpu_torch/csrc/net_epilogue.cu", "replaces": None,
        "launches": result["slice"]["launches"]["net_epilogue"],
        "max_abs_err": 0, "ms": e["19x19 B=2048 plain"]["ms"],
        "plain_ms": e["19x19 B=2048 plain"]["plain_ms"],
        "bound_ms": e["19x19 B=2048 plain"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": "19x19 C=256 B=2048, no skip",
        "host_ms": e["19x19 B=2048 plain"]["host_ms"],
        "by_shape": {k_: v for k_, v in e.items()
                     if not k_.endswith("forward")},
    })
    rows.extend(train_epilogue_rows(result["train_epilogue"]))
    rows.extend(nbt_kernel_rows(result["nbt"], result["nbt_slice"]))
    rows.extend(nbt_train_rows(result["nbt_train"]))
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
