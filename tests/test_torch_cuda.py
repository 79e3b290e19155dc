"""Tests of the port that need a CUDA card (marked `cuda`; each skips
without one).  This file imports torch, numpy and elf_tpu_torch only, so it
also runs where JAX is absent:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from elf_tpu_torch.env.go import engine, kernels
from elf_tpu_torch.env.go import state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(300)]

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_boards(B, size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=(B, size, size)).astype(np.int8)


@pytest.mark.parametrize("size", [5, 9, 13, 19])
def test_kernels_match_plain_versions(dev, size):
    """Both kernels exactly equal to their plain versions, at every board
    size the engine supports and at batch sizes that leave packed CTAs
    partly empty."""
    n2 = size * size
    for B in (1, 3, 5, 130):
        s = torch.from_numpy(_random_boards(B, size, seed=B)).to(dev)
        for a, b in zip(kernels.analyze_libs_cuda(s),
                        kernels.analyze_libs_ref(s)):
            assert torch.equal(a, b)
        g = torch.Generator(device=dev).manual_seed(B)
        act = torch.randint(-2, n2 + 2, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        col = torch.randint(1, 3, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        flat = s.reshape(B, n2)
        for a, b in zip(kernels.step_analysis_cuda(flat, act, col),
                        kernels.step_analysis_ref(flat, act, col)):
            assert torch.equal(a, b)


def _snake(size):
    """One serpentine chain covering the board (the longest chains)."""
    b = np.zeros((size, size), np.int8)
    b[0::2, :] = 1
    for r in range(1, size, 2):
        b[r, -1 if (r // 2) % 2 == 0 else 0] = 1
    return b


def _edge_boards(kind, B, size, seed):
    """B boards of one kind, with actions and colours to play that include
    the liberty of a one-liberty chain, occupied points, passes and
    negative actions."""
    rng = np.random.default_rng(seed)
    n = size
    s = np.zeros((B, n, n), np.int8)
    for i in range(B):
        if kind == "one_liberty":                # one chain, one liberty
            s[i] = 1 + i % 2
            s[i].flat[rng.integers(n * n)] = 0
        elif kind == "checkerboard":             # single-stone chains
            r, c = np.indices((n, n))
            s[i] = np.where((r + c) % 2 == 0, 1 + r % 2, 0)
        elif kind == "full":                     # no empty point
            s[i] = rng.integers(1, 3, (n, n))
        elif kind == "serpentine":               # in both colours
            s[i] = _snake(n) * (1 + i % 2)
        elif kind == "random":
            p_empty = (0.2, 0.5, 0.8)[i % 3]
            s[i] = rng.choice(3, (n, n), p=[p_empty, (1 - p_empty) / 2,
                                            (1 - p_empty) / 2])
    flat = s.reshape(B, n * n)
    action = np.empty(B, np.int32)
    color = np.empty(B, np.int32)
    for i in range(B):
        empty, occ = np.nonzero(flat[i] == 0)[0], np.nonzero(flat[i])[0]
        pick = i % 5
        if pick in (0, 1) and empty.size:
            action[i] = empty[rng.integers(empty.size)]
        elif pick == 2 and occ.size:
            action[i] = occ[rng.integers(occ.size)]
        else:
            action[i] = (n * n, -1, n * n + 3)[i % 3]
        # the opponent of the board's first stone, so that one-liberty
        # boards lose their whole chain
        color[i] = 3 - flat[i, occ[0]] if occ.size else 1 + i % 2
    return s, action, color


@pytest.mark.parametrize("B", [1, 32, 1024])
@pytest.mark.parametrize("size", [2, 5, 9, 13, 19, 32])
def test_both_designs_match_plain_versions_on_edge_boards(dev, size, B):
    """The union-find kernels and the round-based ones, exactly equal to the
    plain versions on the boards that stress a labelling: one chain with
    one liberty, single-stone chains, empty and full boards, serpentine
    chains and random boards."""
    n2 = size * size
    libs = (kernels.analyze_libs_cuda, kernels.analyze_libs_rounds_cuda)
    steps = (kernels.step_analysis_cuda, kernels.step_analysis_rounds_cuda)
    for k, kind in enumerate(("one_liberty", "checkerboard", "empty", "full",
                              "serpentine", "random")):
        s_np, a_np, c_np = _edge_boards(kind, B, size, seed=size * 100 + k)
        s = torch.from_numpy(s_np).to(dev)
        flat = s.reshape(B, n2)
        act, col = torch.from_numpy(a_np).to(dev), torch.from_numpy(c_np).to(dev)
        ref = kernels.analyze_libs_ref(s)
        ref_step = kernels.step_analysis_ref(flat, act, col)
        for fn in libs:
            for got, want in zip(fn(s), ref):
                assert torch.equal(got, want), (fn.__name__, kind)
        for fn in steps:
            for got, want in zip(fn(flat, act, col), ref_step):
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (fn.__name__, kind)


def test_step_core_on_card_matches_cpu(dev):
    """Random legal games: the engine on the card (kernels) and on the CPU
    (plain versions) agree on every field."""
    size, B = 19, 16
    rng = np.random.default_rng(0)
    cc = engine.init_core(B, size, "cpu")
    gc = engine.init_core(B, size, dev)
    legal = np.ones((B, size * size + 1), bool)
    for _ in range(150):
        p = legal / legal.sum(axis=1, keepdims=True)
        a = np.array([rng.choice(len(r), p=r) for r in p], np.int32)
        cc, ci = engine.step_core(cc, torch.from_numpy(a), size)
        gc, gi = engine.step_core(gc, torch.from_numpy(a).to(dev), size)
        for x, y in zip(tuple(cc) + tuple(ci), tuple(gc) + tuple(gi)):
            assert torch.equal(x, y.cpu())
        legal = ci.legal_next.numpy()


def test_golden_search_on_card(dev):
    """A virtual-loss batch config of the reference's golden searches on
    the card: identical root visit counts."""
    with gzip.open(os.path.join(GOLDEN_DIR, "ref_mcts_19.jsonl.gz"), "rt") as f:
        g = [json.loads(line) for line in f][1]
    size, n2 = 19, 361
    st = gostate.init_state(1, size, dev)
    for i in range(g["prefix"]):
        cand = np.nonzero(gostate.legal_moves(st, size).cpu().numpy()[0, :n2])[0]
        a = int(cand[(i * 37 + 11) % len(cand)])
        st, _ = gostate.step(st, torch.tensor([a], dtype=torch.int32,
                                               device=dev), size)
    perm = (np.arange(n2 + 1) * 37 + 13) % (n2 + 1)
    log_prior = torch.log(torch.from_numpy(
        ((1.0 + (perm % 64) / 64.0) * np.exp2(perm // 64)).astype(np.float32)
    )).to(dev)

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(dim=1)
        theirs = feats[..., 1].reshape(K, n2).sum(dim=1)
        black = torch.where(to_play == BLACK, mine, theirs)
        white = torch.where(to_play == BLACK, theirs, mine)
        return (log_prior[None].expand(K, n2 + 1),
                ((black - white) * 0.05).clamp(-1.0, 1.0))

    cfg = MCTSConfig(num_rollouts=g["rollouts"],
                     rollouts_per_batch=int(g["per_batch"]),
                     c_puct=g["c_puct"], virtual_loss=int(g["vl"]),
                     rotation_flip=False)
    _, tree = run_mcts(st.core, st.stone_hist, st.hist_len, eval_fn,
                       torch.Generator(device=dev).manual_seed(0), cfg, size,
                       game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi,
                                       st.nhash),
                       device=dev)
    child = tree.child[0, 0].long()
    ours = torch.where(child >= 0, tree.n[0, child.clamp(min=0)], 0).cpu()
    ref = np.zeros(n2 + 1, np.int64)
    for e in g["edges"]:
        ref[e["a"]] = e["n"]
    np.testing.assert_array_equal(ours.numpy(), ref)


def _learner_pair(use_bf16, dev, **opts):
    """The same freshly initialised TrainState on the CPU and on the card."""
    import copy

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer

    cfg = ModelConfig(board_size=9, num_block=2, dim=16, use_bf16=use_bf16)
    topts = TrainOptions(batchsize=8, lr=0.05, **opts)
    cpu = Trainer(cfg, topts, device="cpu")
    card = Trainer(cfg, topts, device=dev)
    state = cpu.init_state(torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(state)
    on_card.net = on_card.net.to(dev)
    on_card.opt_state = card.tx.init(on_card.net)
    return cpu, state, card, on_card


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.random((8, 9, 9, 18)) < 0.3).astype(np.float32)
    pi = rng.dirichlet(np.full(82, 0.3), size=8).astype(np.float32)
    winner = rng.choice([-1.0, 1.0], size=8).astype(np.float32)
    return [torch.from_numpy(a) for a in (feats, pi, winner)]


@pytest.mark.parametrize("opt_method", ["sgd", "adam"])
def test_train_steps_on_card_match_cpu(dev, opt_method, monkeypatch):
    """Three fp32 train steps and a cooldown pass on the card against the
    same steps on the CPU: stats, parameters, BN statistics and optimizer
    slots within 1e-4 (cuDNN and the CPU sum in different orders).  TF32
    convolutions, cuDNN's default for fp32, are off for the comparison."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, a, card, b = _learner_pair(False, dev, opt_method=opt_method,
                                    grad_clip_norm=0.5)
    step_a, step_b = cpu.make_train_step(), card.make_train_step()
    for i in range(3):
        batch = _train_batch(i)
        a, sa = step_a(a, *batch)
        b, sb = step_b(b, *(t.to(dev) for t in batch))
        for k in sa:
            assert abs(float(sa[k]) - float(sb[k])) < 1e-4 * max(
                1.0, abs(float(sa[k]))), (i, k)
    feats = _train_batch(9)[0]
    cpu.make_cooldown_step()(a, feats)
    card.make_cooldown_step()(b, feats.to(dev))
    assert b.step == a.step == 3
    for (n, x), (_, y) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        assert y.device.type == "cuda"
        torch.testing.assert_close(y.cpu(), x, atol=1e-4, rtol=0, msg=n)
    inner = str(card.tx.index)
    for slot, tensors in a.opt_state[inner]["0"].items():
        if slot == "count":
            assert int(tensors) == int(b.opt_state[inner]["0"][slot]) == 3
            continue
        for n, x in tensors.items():
            torch.testing.assert_close(b.opt_state[inner]["0"][slot][n].cpu(),
                                       x, atol=1e-4, rtol=0, msg=f"{slot}/{n}")


def test_bf16_step_and_checkpoint_on_card(dev, tmp_path):
    """A bf16 train step on the card keeps fp32 masters, inference follows
    the updated weights, and a checkpoint written from the card loads back
    bit for bit onto the card and onto the CPU."""
    from elf_tpu_torch.training.trainer import load_checkpoint, save_checkpoint

    cpu, a, card, b = _learner_pair(True, dev)
    batch = [t.to(dev) for t in _train_batch(1)]
    with torch.inference_mode():
        before = b.net(batch[0])[0].clone()
    b, stats = card.make_train_step()(b, *batch)
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in b.net.parameters())
    with torch.inference_mode():
        after = b.net(batch[0])[0]
    assert not torch.allclose(before, after)
    save_checkpoint(str(tmp_path), b)
    for template in (b, a):
        back = load_checkpoint(str(tmp_path), template)
        assert back.step == 1
        for (n, x), (_, y) in zip(b.net.state_dict().items(),
                                  back.net.state_dict().items()):
            assert y.device == next(template.net.parameters()).device
            assert torch.equal(x.cpu(), y.cpu()), n


def test_device_batch_on_card_matches_cpu(dev):
    from elf_tpu_torch.config import ReplayOptions
    from elf_tpu_torch.selfplay.records import make_record
    from elf_tpu_torch.training.pipeline import TrainingPipeline
    from elf_tpu_torch.training.replay import ReplayBuffer

    with gzip.open(os.path.join(GOLDEN_DIR, "ref_traj_9.jsonl.gz"), "rt") as f:
        games = [json.loads(line) for line in f][:6]
    tp = TrainingPipeline(ReplayBuffer(ReplayOptions(num_reader=2), seed=1),
                          9, seed=2, num_future_actions=2)
    rng = np.random.default_rng(0)
    for i, g in enumerate(games):
        moves = g["actions"][:40]
        pols = [rng.dirichlet(np.full(82, 0.1)).astype(np.float32)
                for _ in moves]
        tp.insert_record(make_record(moves, 1.0 if i % 2 else -1.0, pols,
                                     [0.0] * len(moves), 9))
    hb = tp.sample_host_batch(32)
    for on_card, on_cpu in zip(tp.device_batch(hb, dev) +
                               tp.device_batch_offline(hb, dev),
                               tp.device_batch(hb, "cpu") +
                               tp.device_batch_offline(hb, "cpu")):
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_remat_step_on_card_equals_plain_step(dev, use_bf16, monkeypatch):
    """Block remat on the card: three steps from one state give the plain
    steps' BN statistics bit for bit (each written once per step) and
    parameters within 1e-6, with cuDNN's deterministic algorithms."""
    import copy
    import dataclasses

    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = ModelConfig(board_size=9, num_block=2, dim=16, use_bf16=use_bf16)
    opts = TrainOptions(batchsize=8, lr=0.05)
    plain_tr = Trainer(cfg, opts, device=dev)
    remat_tr = Trainer(dataclasses.replace(cfg, remat=True), opts, device=dev)
    plain = plain_tr.init_state(torch.Generator().manual_seed(0))
    remat = copy.deepcopy(plain)
    remat.net.cfg = remat_tr.cfg
    for i in range(3):
        batch = [t.to(dev) for t in _train_batch(20 + i)]
        plain_tr.make_train_step()(plain, *batch)
        remat_tr.make_train_step()(remat, *batch)
        for (n, x), (_, y) in zip(plain.net.named_buffers(),
                                  remat.net.named_buffers()):
            assert torch.equal(x, y), (i, n)
        for (n, x), (_, y) in zip(plain.net.named_parameters(),
                                  remat.net.named_parameters()):
            assert float((x - y).detach().abs().max()) <= 1e-6, (i, n)


def _exact_eval(size):
    """Equal priors on one action in eight, value (black - white) / 16."""
    n2 = size * size
    favored = (np.arange(n2 + 1) * 37 + 13) % 8 == 0

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        log_pi = torch.from_numpy(np.where(favored, 0.0, -1e4).astype(
            np.float32)).to(feats.device)
        mine = feats[..., 0].reshape(K, n2).sum(-1)
        theirs = feats[..., 1].reshape(K, n2).sum(-1)
        b = torch.where(to_play == BLACK, mine, theirs)
        w = torch.where(to_play == BLACK, theirs, mine)
        return (log_pi[None].expand(K, n2 + 1),
                ((b - w) / 16.0).clamp(-1.0, 1.0))

    return eval_fn


def test_chunked_search_on_card_equals_unchunked(dev):
    """On the card: a move searched in `max_batches_per_call` calls with
    `eval_chunk` forwards equals the move searched in one call with one
    forward per batch (19x19, B = 16, white budget twice black's)."""
    from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

    size = 19
    acfg = ActorConfig(board_size=size, batch=16, never_resign_prob=1.0,
                       policy_distri_cutoff=2)
    base = dict(num_rollouts=16, white_num_rollouts=32, rollouts_per_batch=4,
                root_epsilon=0.25, batched_writes="on")
    actors = [SelfplayActor(acfg, MCTSConfig(**base, **extra),
                            lambda p, b: _exact_eval(size), seed=1,
                            device=dev)
              for extra in ({}, dict(max_batches_per_call=3, eval_chunk=16))]
    for _ in range(3):
        for a in actors:
            a.play_moves(None, None, 1)
        assert len(actors[0].simulate_s) == 1
        assert len(actors[1].simulate_s) == 3
        assert actors[0].moves == actors[1].moves
        assert actors[0].values == actors[1].values
        assert torch.equal(actors[0].state.core.stones,
                           actors[1].state.core.stones)


def test_offline_steps_on_card_match_cpu(dev, monkeypatch):
    """Three fp32 supervised (df_pred) steps on the card against the same
    steps on the CPU, on offline targets of two horizons: stats, parameters
    and BN statistics within 1e-4 (TF32 off, as above)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, a, card, b = _learner_pair(False, dev)
    step_a, step_b = cpu.make_offline_train_step(), card.make_offline_train_step()
    for i in range(3):
        feats, _, winner = _train_batch(i)
        target = torch.from_numpy(np.random.default_rng(i).integers(
            0, 82, size=(8, 2)).astype(np.int32))
        a, sa = step_a(a, feats, target, winner)
        b, sb = step_b(b, feats.to(dev), target.to(dev), winner.to(dev))
        assert "acc/top1" in sb
        for k in sa:
            assert abs(float(sa[k]) - float(sb[k])) < 1e-4 * max(
                1.0, abs(float(sa[k]))), (i, k)
    for (n, x), (_, y) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        torch.testing.assert_close(y.cpu(), x, atol=1e-4, rtol=0, msg=n)


def test_policy_net_bf16_on_card_close_to_fp32_cpu(dev):
    """PolicyNet (6 layers x 32, 19x19, T = 3) in bf16 on the card against
    the fp32 net from the same weights on the CPU: probabilities sum to 1
    within 1e-3, the top move agrees on at least 90 % of the rows, and no
    probability differs by more than 0.1."""
    from elf_tpu_torch.models.policy_net import (
        PolicyNetConfig,
        init_policy_net,
        policy_params_from_jax,
        policy_params_to_jax,
    )

    cfg = PolicyNetConfig(num_layer=6, dim=32, num_future_actions=3,
                          use_bf16=False)
    net32 = init_policy_net(cfg, torch.Generator().manual_seed(0), "cpu")
    net16 = policy_params_from_jax(
        *policy_params_to_jax(net32),
        PolicyNetConfig(num_layer=6, dim=32, num_future_actions=3), dev)
    x = (torch.rand((64, 19, 19, 25), generator=torch.Generator()
                    .manual_seed(1)) < 0.3).float()
    with torch.no_grad():
        ref = net32(x)
        out = net16(x.to(dev)).cpu()
    assert out.shape == (64, 3, 362) and out.dtype == torch.float32
    assert float((out.exp().sum(dim=2) - 1).abs().max()) < 1e-3
    assert (out.argmax(dim=2) == ref.argmax(dim=2)).float().mean() >= 0.9
    assert float((out.exp() - ref.exp()).abs().max()) < 0.1


def test_self_atari_and_eyes_on_card_equal_cpu(dev):
    """`self_atari_mask` on the card (both liberty kernels launch, once
    each, at B * 361 boards) and the eye masks equal the CPU path."""
    from elf_tpu_torch.env.go import tactics

    size, B = 19, 4
    core = engine.init_core(B, size, "cpu")
    rng = np.random.default_rng(3)
    legal = np.ones((B, size * size + 1), bool)
    for _ in range(60):
        w = legal.astype(float)
        w[:, -1] = 1e-3
        a = np.array([rng.choice(len(r), p=r / r.sum()) for r in w], np.int32)
        core, info = engine.step_core(core, torch.from_numpy(a), size)
        legal = info.legal_next.numpy()
    kernels.reset_launch_counts()
    on_card = tactics.self_atari_mask(
        engine.GoCore(*(f.to(dev) for f in core)), size)
    assert kernels.launch_counts() == {"analyze_libs": 1, "step_analysis": 1}
    assert torch.equal(on_card.cpu(), tactics.self_atari_mask(core, size))
    colors = core.to_play
    for fn in (tactics.eye_mask, tactics.fake_eye_mask,
               tactics.true_eye_mask):
        assert torch.equal(fn(core.stones.to(dev), colors.to(dev),
                              size).cpu(), fn(core.stones, colors, size))


def _dp2_rank(rank, world, port, out_path):
    """One of two ranks on cuda:0 over gloo: two dp = 2 fp32 steps of a
    9x9 net on its half of each batch; rank 0 writes the gathered state."""
    from elf_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from elf_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_state,
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 backend="gloo")
    _, state, card, on_card = _learner_pair(False, "cuda",
                                            grad_clip_norm=0.5)
    mesh = make_mesh(world, tp=1)
    step, shardings = make_sharded_train_step(card, mesh, on_card)
    shard = shard_state(on_card, shardings)
    rows = batch_sharding(mesh, 8)
    losses = []
    for i in range(2):
        feats, pi, winner = (t[rows].cuda() for t in _train_batch(i))
        shard, stats = step(shard, feats, pi, winner)
        losses.append(float(stats["loss/total"]))
    full = gather_state(shard, shardings)
    if rank == 0:
        torch.save({"losses": losses,
                    "sd": {k: v.cpu() for k, v in
                           full.net.state_dict().items()}}, out_path)
    torch.distributed.destroy_process_group()


def test_dp2_step_two_ranks_on_one_card_match_one_rank(dev, tmp_path,
                                                       monkeypatch):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card)
    take dp = 2 steps with the batch statistics of the whole batch; the
    losses, parameters and BN statistics hold the one-rank steps on the
    card within 1e-4 (fp32, TF32 off)."""
    import socket

    import torch.multiprocessing as mp

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = str(tmp_path / "dp2.pt")
    mp.start_processes(_dp2_rank, args=(2, port, out), nprocs=2,
                       start_method="spawn")
    res = torch.load(out, weights_only=False)
    _, _, card, b = _learner_pair(False, dev, grad_clip_norm=0.5)
    step = card.make_train_step()
    for i in range(2):
        b, stats = step(b, *(t.to(dev) for t in _train_batch(i)))
        assert abs(float(stats["loss/total"]) - res["losses"][i]) < 1e-4
    for n, x in b.net.state_dict().items():
        torch.testing.assert_close(res["sd"][n], x.cpu(), atol=1e-4, rtol=0,
                                   msg=n)


def test_batch_replay_on_card_equals_cpu(dev):
    """`tools.ladder.batch_replay` of the golden 19x19 games (one cut
    short, one with a stone on an occupied point) on the card: the illegal
    mask and every field of the final state equal the CPU's, exactly, and
    `step_analysis` launches once per ply of the longest game."""
    from elf_tpu_torch.tools.ladder import batch_replay

    with gzip.open(os.path.join(GOLDEN_DIR, "ref_traj_19.jsonl.gz"),
                   "rt") as f:
        games = [[int(a) for a in json.loads(line)["actions"]] for line in f
                 if set(json.loads(line)["start_stones"]) == {"0"}]
    games.append(games[0][:40])
    games.append(games[1][:30] + [games[1][0]] + games[1][30:50])
    kernels.reset_launch_counts()
    ill_card, st_card = batch_replay(games, 19, device=dev)
    assert kernels.launch_counts() == {
        "step_analysis": max(len(g) for g in games), "analyze_libs": 0}
    ill_cpu, st_cpu = batch_replay(games, 19, device="cpu")
    assert (ill_card == ill_cpu).all()
    assert np.argwhere(ill_card).tolist() == [[len(games) - 1, 30]]

    def leaves(st):
        return [t for x in st for t in (x if isinstance(x, tuple) else (x,))]

    for a, b in zip(leaves(st_card), leaves(st_cpu)):
        assert torch.equal(a.cpu(), b)


def test_bench_env_steps_on_card(dev):
    """`bench_torch.bench_env_steps` at B = 4096 with 8-step chunks (3
    warm-up and 1 timed): a positive rate, one `step_analysis` launch a
    step and no `analyze_libs` (the legal mask rides on the step)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_torch

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sps = bench_torch.bench_env_steps(B=4096, chunk=8, iters=1)
    assert sps > 0
    assert kernels.launch_counts() == {"step_analysis": 8 * 4,
                                       "analyze_libs": 0}


def test_actor_device_draws_follow_their_distributions(dev):
    """The draws the actor makes from its CUDA generator: D4 codes uniform
    over 8 (chi-square at 7 degrees of freedom, p > 1e-3 at 16,384 draws);
    Dirichlet noise at alpha 0.03 and 0.2 zero on illegal actions, each
    row summing to 1, each legal action's mean 1 / n_legal within 6
    standard errors; `gumbel_categorical` frequencies within 0.01 of the
    softmax at 10^5 draws."""
    from elf_tpu_torch.search import mcts

    gen = torch.Generator(device=dev).manual_seed(3)
    n = 16384
    codes = mcts._draw_codes(n, gen, MCTSConfig(), dev)
    assert codes.device.type == "cuda"
    counts = torch.bincount(codes, minlength=8).cpu().numpy()
    assert counts.shape == (8,) and counts.sum() == n
    chi2 = float(((counts - n / 8) ** 2 / (n / 8)).sum())
    assert chi2 < 24.322        # the 0.999 quantile at 7 degrees of freedom

    rows, A = 20000, 362
    for alpha in (0.03, 0.2):
        for n_legal in (7, 181):
            idx = torch.randperm(A, generator=gen, device=dev)[:n_legal]
            legal = torch.zeros(rows, A, dtype=torch.bool, device=dev)
            legal[:, idx] = True
            noise = mcts.dirichlet_noise(legal, alpha, gen)
            assert not noise[~legal].any()
            torch.testing.assert_close(noise.sum(1).cpu(),
                                       torch.ones(rows), atol=1e-5, rtol=0)
            mean = noise[:, idx].double().mean(0).cpu().numpy()
            var = (1 / n_legal) * (1 - 1 / n_legal) / (n_legal * alpha + 1)
            se = np.sqrt(var / rows)
            assert np.abs(mean - 1 / n_legal).max() < 6 * se, (alpha, n_legal)

    draws = 100_000
    logits = torch.log(torch.tensor(
        [0.4, 0.25, 0.15, 0.1, 0.06, 0.04], device=dev))
    logits = torch.cat([logits, torch.full((A - 6,), -1e9, device=dev)])
    picked = mcts.gumbel_categorical(logits.expand(draws, A).contiguous(),
                                     gen)
    freq = torch.bincount(picked, minlength=A).double().cpu() / draws
    want = torch.softmax(logits.double().cpu(), 0)
    assert float((freq - want).abs().max()) < 0.01
    assert not freq[6:].any()


@pytest.mark.timeout(900)
def test_pair_eval_search_on_card_matches_cpu(dev, monkeypatch):
    """The learning proof's eval actor (`make_eval_actor`: 64 rollouts,
    pass masked until ply 160) with the committed export against the
    committed init at 20b256c, fp32 with TF32 off, the symmetries fixed
    (no D4 draws) and argmax moves from ply 0: the card plays the CPU's
    first 8 moves."""
    import dataclasses
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.resnet import ModelConfig
    from elf_tpu_torch.training.trainer import Trainer, load_checkpoint
    from scripts.prove_learning_torch import make_eval_actor, parse_args

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    runs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs", "prove19")
    args = parse_args(["--out", "unused", "--board_size", "19",
                       "--blocks", "20", "--dim", "256", "--eval_games", "2",
                       "--eval_rollouts", "64", "--use_bf16", "0"])
    moves = {}
    for d in ("cpu", dev):
        trainer = Trainer(ModelConfig(board_size=19, num_planes=18,
                                      num_block=20, dim=256, use_bf16=False),
                          TrainOptions(num_block=20, dim=256), device=d)
        template = trainer.init_state(torch.Generator().manual_seed(0))
        a = load_checkpoint(os.path.join(runs, "export-best.bin"),
                            template=template)
        b = load_checkpoint(os.path.join(runs, "init_params.bin"),
                            template=template)
        actor = make_eval_actor(args, 19, d, trainer.make_eval_fn())
        assert actor.mcts_cfg.ply_pass_enabled == 160
        actor.mcts_cfg = dataclasses.replace(actor.mcts_cfg,
                                             rotation_flip=False)
        actor.cfg = dataclasses.replace(actor.cfg, policy_distri_cutoff=-1)
        seq = []
        for _ in range(8):
            actor.play_moves((a.net, b.net), (None, None), 1)
            seq.append(int(actor.state.core.last_move[0]))
        moves[str(d)] = seq
    assert moves["cuda"] == moves["cpu"]
    assert all(0 <= m < 361 for m in moves["cpu"])
