#!/usr/bin/env python
"""Prove learning through the port's production control plane.

Twin of `scripts/prove_production.py` on `elf_tpu_torch`: it launches

  - 1 x `scripts/train_server_torch.py`  (learner + TCP control plane), and
  - N x `scripts/selfplay_client_torch.py` (real-MCTS self-play; the first
    client is allocated eval duty, client_manager.h:215),

with no cheat flags.  Records flow over TCP, the server trains, queues
each episode's checkpoint as a candidate (`ThreadedCtrl::
addNewModelForEvaluation`, game_ctrl.h:118), the eval client plays
colour-swapped candidate-vs-baseline games with noise-free search
(fair_pick.h:248), and the server promotes candidates whose win-rate bound
clears `--eval_winrate_thres` (ctrl_eval.h:240, game_ctrl.h:202-232) until
`--target_promotions` promotions happened.  Afterwards the script plays a
final fixed-rollout anchor match: last promoted checkpoint vs the frozen
random init.  The outcome is decided by searched evals against the
current baseline, not by one policy-only match against one init.

Same options, protocol, output files and return code as the JAX script,
with `--device` (default `cuda`; `cpu` runs every process on the CPU) in
place of `--platform`.  Besides the promotions, the verdict prints every
accept/reject decision the server logged (`eval_ladder.txt` under --out).

Artifacts under --out:
  ckpt/promotions.jsonl   the server's promotion audit log
  eval_ladder.txt         every PROMOTE / rejected decision with its win rate
  status_curve.jsonl      polls of the server `status` endpoint
  final.json              the anchor match result
  init.bin                frozen random-init snapshot
  promoted-<ver>.bin      every promoted checkpoint (survives keep-k)

Resumable: re-running with the same --out restarts the server with
--load latest + journal-rebuilt replay; --max_seconds is a CUMULATIVE
wall budget across resumes (progress.json).

The README's 9x9 protocol on one GPU (all three processes share it):

  python scripts/prove_production_torch.py --out build/prod9_torch \
      --target_promotions 3 --eval_num_threads 64

CI-scale variant (5x5, CPU):

  python scripts/prove_production_torch.py --out build/prod5_torch \
      --device cpu --board_size 5 --num_block 1 --dim 16 --num_games 32 \
      --rollouts 16 --eval_rollouts 0 --eval_num_games 20 \
      --selfplay_init_num 80 --selfplay_update_num 40 \
      --num_minibatch 25 --train_bs 64 --target_promotions 1 \
      --final_games 0 --max_seconds 900
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True,
                    help="run directory; a run resumes from what it holds")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of every process: cuda (default) or cpu")
    ap.add_argument("--port", type=int, default=0, help="0 = pick free")
    ap.add_argument("--board_size", type=int, default=9)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--num_block", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--num_clients", type=int, default=2)
    ap.add_argument("--num_games", type=int, default=256,
                    help="lockstep boards on the first (eval-capable) client")
    ap.add_argument("--client1_num_games", type=int, default=-1,
                    help="boards on the other clients (-1 = num_games/2)")
    ap.add_argument("--rollouts", type=int, default=96)
    ap.add_argument("--rollouts_per_batch", type=int, default=8)
    ap.add_argument("--c_puct", type=float, default=1.5)
    ap.add_argument("--root_epsilon", type=float, default=0.25)
    ap.add_argument("--root_alpha", type=float, default=0.2)
    ap.add_argument("--eval_rollouts", type=int, default=64)
    ap.add_argument("--eval_num_games", type=int, default=50)
    ap.add_argument("--eval_num_threads", type=int, default=-1,
                    help="boards an eval client may dedicate to an eval "
                         "job (server-driven ClientCtrl cap; -1 = all)")
    ap.add_argument("--eval_winrate_thres", type=float, default=0.55)
    ap.add_argument("--train_bs", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--value_weight", type=float, default=1.0,
                    help="server-side value-loss weight (0.25 tames the "
                         "small-replay value-overfit dip — the recipe "
                         "that carried the 19x19 learning proof)")
    ap.add_argument("--num_minibatch", type=int, default=50,
                    help="train minibatches per episode/candidate")
    ap.add_argument("--selfplay_init_num", type=int, default=300)
    ap.add_argument("--selfplay_update_num", type=int, default=150)
    ap.add_argument("--replay_games", type=int, default=6000)
    ap.add_argument("--target_promotions", type=int, default=3)
    ap.add_argument("--max_seconds", type=float, default=4 * 3600,
                    help="CUMULATIVE wall budget across resumes")
    ap.add_argument("--final_games", type=int, default=200,
                    help="anchor match games (0 = skip the anchor match)")
    ap.add_argument("--final_rollouts", type=int, default=64)
    ap.add_argument("--final_target", type=float, default=0.60)
    ap.add_argument("--moves_per_round", type=int, default=16)
    ap.add_argument("--use_mesh", type=int, default=1,
                    help="the server's --use_mesh (one device: the plain "
                         "step)")
    ap.add_argument("--seed", type=int, default=11)
    return ap.parse_args(argv)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    return env


def wait_in_log(path: str, needle: str, proc, deadline: float,
                what: str) -> bool:
    """Poll the log at `path` until it holds `needle`; False if `proc`
    exits or `deadline` (time.time()) passes first."""
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        try:
            with open(path) as f:
                if needle in f.read():
                    return True
        except OSError:
            pass
        time.sleep(0.2)
    print(f"# TIMEOUT waiting for {what}", flush=True)
    return False


def stop_all(procs, sig=signal.SIGINT, grace: float = 45.0) -> bool:
    """Send `sig` to every live process in `procs`, again to those still
    running after `grace` s (a client ends its round on the first signal
    and a second one interrupts it; train_server closes its control socket
    and journal on SIGINT), and kill what is left 30 s later.  False if
    one had to be killed."""
    for wait_s in (grace, 30.0):
        live = [p for p in procs if p.poll() is None]
        for p in live:
            p.send_signal(sig)
        end = time.time() + wait_s
        for p in live:
            try:
                p.wait(timeout=max(0.0, end - time.time()))
            except subprocess.TimeoutExpired:
                pass
    clean = True
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
            clean = False
    return clean


def final_anchor_match(args, last_ver: int):
    """Last promoted checkpoint vs the frozen init at fixed rollouts
    (colour-swapped halves), run in this process after the fleet shut
    down."""
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig, load_model, serving_copy
    from elf_tpu_torch.search.mcts import MCTSConfig
    from elf_tpu_torch.selfplay.actor import (
        ActorConfig,
        SelfplayActor,
        make_pair_eval_builder,
    )
    from elf_tpu_torch.tools.match import head_to_head
    from elf_tpu_torch.training.trainer import Trainer

    size = args.board_size
    n2 = size * size
    cfg = ModelConfig(board_size=size, num_planes=18,
                      num_block=args.num_block, dim=args.dim, use_bf16=True)
    to = TrainOptions(batchsize=args.train_bs, num_block=args.num_block,
                      dim=args.dim, lr=args.lr)
    trainer = Trainer(cfg, to, device=args.device)
    eval_raw = trainer.make_eval_fn()

    def net_of(path):
        return serving_copy(load_model(path, cfg, args.device))

    init = net_of(os.path.join(args.out, "init.bin"))
    cand_path = os.path.join(args.out, f"promoted-{last_ver}.bin")
    if not os.path.exists(cand_path):
        cand_path = os.path.join(args.out, "ckpt", f"save-{last_ver}.bin")
    cand = net_of(cand_path)

    actor = SelfplayActor(
        ActorConfig(board_size=size, batch=max(args.final_games // 2, 1),
                    komi=args.komi, policy_distri_cutoff=0,
                    resign_thres=0.0, never_resign_prob=1.0),
        MCTSConfig(num_rollouts=args.final_rollouts,
                   rollouts_per_batch=args.rollouts_per_batch,
                   c_puct=args.c_puct, root_epsilon=0.0, komi=args.komi,
                   ply_pass_enabled=max(6, n2 * 160 // 361)),
        make_pair_eval_builder(eval_raw), seed=args.seed + 99,
        device=args.device,
    )
    return head_to_head(actor, (cand, None), (init, None),
                        max(args.final_games // 2, 1))


def main(argv=None):
    args = parse_args(argv)
    out = args.out
    ckpt = os.path.join(out, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    progress_path = os.path.join(out, "progress.json")
    curve_path = os.path.join(out, "status_curve.jsonl")
    promo_path = os.path.join(ckpt, "promotions.jsonl")
    init_path = os.path.join(out, "init.bin")

    progress = {"wall": 0.0, "runs": 0}
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            progress.update(json.load(f))
    progress["runs"] += 1
    resume = os.path.exists(os.path.join(ckpt, "latest"))
    t0 = time.time() - progress["wall"]
    budget_left = args.max_seconds - progress["wall"]
    if budget_left <= 60:
        print("# no wall budget left; skipping fleet, going to verdict",
              flush=True)
        budget_left = 0

    size = args.board_size
    n2 = size * size
    cutoff = max(4, n2 * 30 // 361)
    pass_ply = max(6, n2 * 160 // 361)
    port = args.port or free_port()
    env = _env()

    common = [
        "--board_size", str(size), "--komi", str(args.komi),
        "--num_block", str(args.num_block), "--dim", str(args.dim),
        "--port", str(port), "--device", args.device,
    ]
    logs = {}
    procs = {}

    def spawn(name, cmd):
        logs[name] = os.path.join(out, f"{name}.log")
        lf = open(logs[name], "a")
        lf.write(f"\n==== run {progress['runs']} ====\n")
        lf.flush()
        procs[name] = subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=lf, stderr=subprocess.STDOUT,
            text=True,
        )
        return procs[name]

    server = None
    status_client = None
    last_promos = 0
    try:
        if budget_left > 0:
            server_cmd = [
                PY, os.path.join(REPO, "scripts/train_server_torch.py"),
                "--ckpt_dir", ckpt,
                "--batchsize", str(args.train_bs), "--lr", str(args.lr),
                "--value_loss_weight", str(args.value_weight),
                "--num_minibatch", str(args.num_minibatch),
                "--num_episodes", "0",
                "--target_promotions", str(args.target_promotions),
                "--max_seconds", str(max(60.0, budget_left)),
                "--use_mesh", str(args.use_mesh), "--ckpt_keep", "40",
                "--expected_num_clients", str(args.num_clients),
                "--selfplay_init_num", str(args.selfplay_init_num),
                "--selfplay_update_num", str(args.selfplay_update_num),
                "--eval_num_games", str(args.eval_num_games),
                "--eval_num_threads", str(args.eval_num_threads),
                "--eval_num_rollouts", str(args.eval_rollouts),
                "--eval_winrate_thres", str(args.eval_winrate_thres),
                "--num_rollouts", str(args.rollouts),
                "--rollouts_per_batch", str(args.rollouts_per_batch),
                "--c_puct", str(args.c_puct),
                "--root_epsilon", str(args.root_epsilon),
                "--root_alpha", str(args.root_alpha),
                "--resign_thres", "0.0", "--never_resign_prob", "1.0",
                "--num_reader", "8", "--q_min_size", "4",
                "--q_max_size", str(max(1, args.replay_games // 8)),
                "--seed", str(args.seed),
                *common,
            ]
            if resume:
                server_cmd += ["--load", os.path.join(ckpt, "latest")]
            server = spawn("server", server_cmd)
            if not wait_in_log(logs["server"], "server up on :", server,
                                time.time() + 900, "server ready"):
                raise RuntimeError("server never became ready")
            if not os.path.exists(init_path):
                import shutil

                shutil.copy(os.path.join(ckpt, "save-0.bin"), init_path)

            def client_cmd(k, boards):
                return [
                    PY, os.path.join(REPO, "scripts/selfplay_client_torch.py"),
                    "--ckpt_dir", ckpt, "--num_games", str(boards),
                    "--num_rollouts", str(args.rollouts),
                    "--rollouts_per_batch", str(args.rollouts_per_batch),
                    "--c_puct", str(args.c_puct),
                    "--policy_distri_cutoff", str(cutoff),
                    "--ply_pass_enabled", str(pass_ply),
                    "--moves_per_round", str(args.moves_per_round),
                    "--seed", str(args.seed + 100 + 37 * k
                                  + 1000 * progress["runs"]),
                    *common,
                ]

            # client0 first: the first identity the server sees is
            # allocated eval duty (client_manager.h:215) — it must be the
            # big/fast shard so evals settle quickly
            spawn("client0", client_cmd(0, args.num_games))
            if not wait_in_log(logs["server"], "eval_then_selfplay",
                                procs["client0"], time.time() + 600,
                                "client0 registration"):
                raise RuntimeError("client0 never registered")
            b1 = (args.client1_num_games if args.client1_num_games > 0
                  else max(args.num_games // 2, 8))
            for k in range(1, args.num_clients):
                spawn(f"client{k}", client_cmd(k, b1))

            # ---- monitor ------------------------------------------------
            from elf_tpu_torch.control.transport import ControlClient

            status_client = ControlClient("127.0.0.1", port, timeout=20.0)
            last_beat = 0.0
            while True:
                if server.poll() is not None:
                    print(f"# server exited rc={server.returncode}",
                          flush=True)
                    break
                wall = time.time() - t0
                if wall > args.max_seconds:
                    print("# wall budget exhausted; stopping fleet",
                          flush=True)
                    break
                st = status_client.send("status", "")
                if isinstance(st, dict) and time.time() - last_beat > 14:
                    last_beat = time.time()
                    point = {"wall_s": round(wall, 1), **st}
                    with open(curve_path, "a") as f:
                        f.write(json.dumps(point) + "\n")
                    print(json.dumps(point), flush=True)
                    if st.get("num_promotions", 0) > last_promos:
                        last_promos = st["num_promotions"]
                        ver = st.get("last_promoted", -1)
                        src = os.path.join(ckpt, f"save-{ver}.bin")
                        if ver >= 0 and os.path.exists(src):
                            import shutil

                            shutil.copy(
                                src, os.path.join(out, f"promoted-{ver}.bin")
                            )
                    progress["wall"] = wall
                    with open(progress_path, "w") as f:
                        json.dump(progress, f)
                time.sleep(5.0)
    finally:
        if status_client is not None:
            status_client.close()
        clients = [p for n, p in procs.items() if n.startswith("client")]
        if not stop_all(clients):
            print("# a client had to be killed", flush=True)
        if server is not None and not stop_all([server]):
            print("# the server had to be killed", flush=True)
        progress["wall"] = time.time() - t0
        with open(progress_path, "w") as f:
            json.dump(progress, f)

    # ---- verdict -------------------------------------------------------
    # every accept/reject decision the server logged, with its win rate
    server_log = os.path.join(out, "server.log")
    ladder = []
    if os.path.exists(server_log):
        with open(server_log) as f:
            ladder = [line.strip().split("] ")[-1] for line in f
                      if "] PROMOTE eval " in line
                      or "] rejected eval " in line]
    with open(os.path.join(out, "eval_ladder.txt"), "w") as f:
        f.writelines(line + "\n" for line in ladder)
    for line in ladder:
        print(f"# {line}", flush=True)
    promotions = []
    if os.path.exists(promo_path):
        with open(promo_path) as f:
            promotions = [json.loads(l) for l in f if l.strip()]
    n_promos = len(promotions)
    print(f"# promotions so far: {n_promos}/{args.target_promotions}",
          flush=True)
    for p in promotions:
        print(json.dumps(p), flush=True)
    if n_promos < args.target_promotions:
        print("INCOMPLETE: re-run with the same --out to continue "
              f"({progress['wall']:.0f}s of {args.max_seconds:.0f}s used)",
              flush=True)
        return 1

    if args.final_games <= 0:
        print(f"PRODUCTION LOOP PROVEN: {n_promos} eval-gated promotions "
              "through the distributed control plane (anchor match skipped)",
              flush=True)
        return 0

    last_ver = promotions[-1]["ver"]
    wins, total = final_anchor_match(args, last_ver)
    wr = wins / max(total, 1)
    final = {
        "final": True, "candidate_ver": last_ver, "wins": wins, "n": total,
        "winrate": round(wr, 4), "rollouts": args.final_rollouts,
        "target": args.final_target, "num_promotions": n_promos,
        "passed": wr >= args.final_target,
    }
    with open(os.path.join(out, "final.json"), "w") as f:
        json.dump(final, f, indent=1)
    print(json.dumps(final), flush=True)
    if final["passed"]:
        print("PRODUCTION LEARNING PROVEN: promoted chain beats the random "
              f"init {wins}/{total} (winrate {wr:.3f} >= "
              f"{args.final_target}) after {n_promos} eval-gated "
              "promotions over TCP", flush=True)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
