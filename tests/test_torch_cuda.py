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
