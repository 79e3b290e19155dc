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
