"""The port against the golden fixtures generated from the reference C++:

 - trajectories (tests/golden/ref_traj_{9,19}): legal masks, stones,
   players, terminal flags, Tromp-Taylor evaluation and AGZ-18 planes
   under D4 codes, bit-exact, and the df-25 planes within atol 2e-6,
   rtol 1e-6 (as tests/test_golden_ref_trajectories.py);
 - search (tests/golden/ref_mcts_{9,19}): root visit counts of all 11
   configs exactly and root w within 5e-4 (as tests/test_golden_mcts.py);
 - the record wire codec (tests/golden/ref_sgf_codec_19).
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from elf_tpu_torch.env.go import coords, features, state as gostate
from elf_tpu_torch.env.go.engine import BLACK
from elf_tpu_torch.search.mcts import MCTSConfig, run_mcts

pytestmark = pytest.mark.timeout(240)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    with gzip.open(os.path.join(GOLDEN_DIR, name), "rt") as f:
        return [json.loads(line) for line in f]


def _hex_to_mask(hexstr, n2):
    return np.array([bool(int(hexstr[i // 4], 16) & (1 << (i % 4)))
                     for i in range(n2)])


def _stones_to_arr(s):
    return np.frombuffer(s.encode(), np.uint8) - ord("0")


def _replay_group(games, size, df=False):
    n2 = size * size
    B = len(games)
    st = gostate.init_state(B, size, "cpu")
    if games[0]["handicap"]:
        st = gostate.apply_handicap(st, games[0]["handicap"], size)
    for b, g in enumerate(games):
        np.testing.assert_array_equal(st.core.stones[b].numpy(),
                                      _stones_to_arr(g["start_stones"]))
        assert int(st.core.to_play[b]) == g["start_player"], g["seed"]

    probes = [(p["ply"], b, p) for b, g in enumerate(games)
              for p in g["features"]]
    for i in range(max(len(g["actions"]) for g in games)):
        legal = gostate.legal_moves(st, size).numpy()
        to_play = st.core.to_play.numpy()
        for b, g in enumerate(games):
            if i >= len(g["actions"]):
                continue
            assert to_play[b] == g["players"][i], (g["seed"], i)
            np.testing.assert_array_equal(
                legal[b, :n2], _hex_to_mask(g["legal"][i], n2),
                err_msg=f"legal mask seed {g['seed']} ply {i}")
        actions = torch.tensor(
            [g["actions"][i] if i < len(g["actions"]) else n2 for g in games],
            dtype=torch.int32)
        st, _ = gostate.step(st, actions, size)
        stones = st.core.stones.numpy()
        term = st.terminated.numpy()
        for b, g in enumerate(games):
            if i >= len(g["actions"]):
                continue
            np.testing.assert_array_equal(
                stones[b], _stones_to_arr(g["stones"][i]),
                err_msg=f"stones seed {g['seed']} ply {i}")
            assert bool(term[b]) == bool(g["terminal"][i]), (g["seed"], i)
        due = [pr for pr in probes if pr[0] == i + 1]
        for code in sorted({p["d4"] for _, _, p in due}):
            codes = torch.full((B,), code, dtype=torch.int64)
            if df:
                planes = features.extract_df(st, codes, size).numpy()
            else:
                planes = features.extract_agz(st, codes, size).numpy()
            key, C = ("df", 25) if df else ("agz", 18)
            for ply, b, probe in due:
                if probe["d4"] != code:
                    continue
                # reference layout [plane, x (col), y (row)]
                ref = (np.array(probe[key], np.float32)
                       .reshape(C, size, size).transpose(2, 1, 0))
                what = f"{key} seed {games[b]['seed']} ply {ply} d4 {code}"
                if df:
                    np.testing.assert_allclose(planes[b], ref, atol=2e-6,
                                               rtol=1e-6, err_msg=what)
                else:
                    np.testing.assert_array_equal(planes[b], ref,
                                                  err_msg=what)

    ev = gostate.evaluate(st, size, komi=7.5).numpy()
    for b, g in enumerate(games):
        assert ev[b] == pytest.approx(g["eval_komi7.5"], abs=1e-5), g["seed"]
        assert bool(st.terminated[b]) == bool(g["terminated"]), g["seed"]


@pytest.mark.parametrize("size", [9, 19])
def test_reference_trajectories(size):
    groups = {}
    for g in _load(f"ref_traj_{size}.jsonl.gz"):
        groups.setdefault(g["handicap"], []).append(g)
    for _, group in sorted(groups.items()):
        _replay_group(group, size)


@pytest.mark.parametrize("size", [9, 19])
def test_reference_df_planes(size):
    groups = {}
    for g in _load(f"ref_traj_{size}.jsonl.gz"):
        groups.setdefault(g["handicap"], []).append(g)
    for _, group in sorted(groups.items()):
        _replay_group(group, size, df=True)


# ---------------------------------------------------------------------------
# search parity
# ---------------------------------------------------------------------------


def _play_prefix(k, size):
    """Deterministic prefix mirroring gen_mcts_golden.cc play_prefix."""
    n2 = size * size
    st = gostate.init_state(1, size, "cpu")
    for i in range(k):
        cand = np.nonzero(gostate.legal_moves(st, size).numpy()[0, :n2])[0]
        if len(cand) == 0:
            break
        a = int(cand[(i * 37 + 11) % len(cand)])
        st, _ = gostate.step(st, torch.tensor([a], dtype=torch.int32), size)
    return st


def _raw_priors(A):
    perm = (np.arange(A, dtype=np.int64) * 37 + 13) % A
    return ((1.0 + (perm % 64) / 64.0) * np.exp2(perm // 64)).astype(np.float32)


def _make_eval_fn(size):
    """Pseudo-NN of gen_mcts_golden.cc: fixed priors, value =
    clip(0.05 * (black_stones - white_stones), -1, 1)."""
    n2 = size * size
    log_prior = torch.log(torch.from_numpy(_raw_priors(n2 + 1)))

    def eval_fn(feats, to_play):
        K = feats.shape[0]
        mine = feats[..., 0].reshape(K, n2).sum(dim=1)
        theirs = feats[..., 1].reshape(K, n2).sum(dim=1)
        black = torch.where(to_play == BLACK, mine, theirs)
        white = torch.where(to_play == BLACK, theirs, mine)
        v = ((black - white) * 0.05).clamp(-1.0, 1.0)
        return log_prior[None, :].expand(K, n2 + 1), v

    return eval_fn


def _run_case(g, size):
    A = size * size + 1
    st = _play_prefix(g["prefix"], size)
    cfg = MCTSConfig(
        num_rollouts=g["rollouts"],
        rollouts_per_batch=int(g.get("per_batch", 1)),
        c_puct=g["c_puct"],
        virtual_loss=int(g["vl"]),
        root_epsilon=0.0,
        komi=7.5,
        rotation_flip=False,
        unexplored_q_zero=bool(g["uqz"]),
        root_unexplored_q_zero=bool(g["ruqz"]),
    )
    res, tree = run_mcts(
        st.core, st.stone_hist, st.hist_len, _make_eval_fn(size),
        torch.Generator().manual_seed(0), cfg, size,
        game_hash_hist=(st.hash_hist_lo, st.hash_hist_hi, st.nhash),
        device="cpu",
    )
    ref_n = np.zeros(A, np.int64)
    ref_w = np.zeros(A, np.float64)
    for e in g["edges"]:
        ref_n[e["a"]] = e["n"]
        ref_w[e["a"]] = e["w"]
    child = tree.child[0, 0].long()
    has = child >= 0
    cs = child.clamp(min=0)
    ours_n = torch.where(has, tree.n[0, cs], 0).numpy()
    ours_w = torch.where(has, tree.w[0, cs], 0.0).numpy()
    label = f"size {size} prefix {g['prefix']} m {g.get('per_batch', 1)}"
    assert int(ours_n.sum()) == g["root_n"], label
    np.testing.assert_array_equal(ours_n, ref_n, err_msg=f"visits ({label})")
    np.testing.assert_allclose(ours_w, ref_w, atol=5e-4,
                               err_msg=f"w ({label})")
    assert float(res.root_value[0]) == pytest.approx(g["root_value"],
                                                     abs=1e-6)


@pytest.mark.parametrize("size,idx", [(9, i) for i in range(9)]
                         + [(19, i) for i in range(2)])
def test_mcts_visit_parity(size, idx):
    games = _load(f"ref_mcts_{size}.jsonl.gz")
    assert idx < len(games)
    _run_case(games[idx], size)


def test_sgf_codec_matches_reference():
    for g in _load("ref_sgf_codec_19.jsonl.gz"):
        assert coords.moves_to_sgf_string(g["moves"], 19) == g["sgf"]
        assert coords.sgf_string_to_moves(g["sgf"], 19) == g["moves"]

