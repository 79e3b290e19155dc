"""The port's ladder tools (`elf_tpu_torch/tools/ladder.py`) against
`elf_tpu.tools.ladder` on the CPU, on a suite built in a temporary
directory: the four 19x19 golden games without start stones
(tests/golden/ref_traj_19) written as SGF, one more game with a stone
spliced onto an occupied point, and a `ladder_list` of probes at several
move numbers (one past the end of its game, one at move 1).

Every comparison is exact (tolerance 0): probe lists, illegal masks,
final states field by field, LadderResults (totals, matches, failures in
order) and classifications row by row.  The policy scorecard uses one
1-block 8-channel fp32 net, the port's weights made from the JAX ones; the
scorecard's argmax is compared on probes whose top two legal
log-probabilities differ by more than 1e-4 in the JAX net (a gap the two
fp32 forwards cannot cross), and every probe is checked to have one.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from elf_tpu.env.go import state as jstate
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.models.resnet import apply_fn, init_params
from elf_tpu.tools import ladder as jladder
from elf_tpu_torch.env.go import state as tstate
from elf_tpu_torch.models.resnet import ModelConfig, params_from_jax
from elf_tpu_torch.sgf import game_from_moves, serialize_sgf
from elf_tpu_torch.tools import ladder as tladder

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the nets are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "ref_traj_19.jsonl.gz")
# (game, move number) probes; g4 carries the illegal move at index 30
PROBES = [("g0.sgf", 12), ("g0.sgf", 41), ("g1.sgf", 30), ("g1.sgf", 1),
          ("g2.sgf", 25), ("g3.sgf", 500), ("g3.sgf", 18), ("g4.sgf", 20),
          ("g4.sgf", 34)]
ILLEGAL_AT = 30


def golden_games():
    """Move lists of the golden 19x19 games that start from an empty
    board."""
    with gzip.open(GOLDEN, "rt") as f:
        rows = [json.loads(line) for line in f]
    return [[int(a) for a in r["actions"]] for r in rows
            if set(r["start_stones"]) == {"0"}]


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    root = tmp_path_factory.mktemp("suite")
    games = golden_games()[:4]
    # a stone on a point that is occupied at that ply (black's first stone,
    # still on the board at ply 30), then the game goes on
    bad = games[0][:ILLEGAL_AT] + [games[0][0]] + games[0][ILLEGAL_AT:60]
    games.append(bad)
    (root / "ladder").mkdir()
    for i, moves in enumerate(games):
        (root / "ladder" / f"g{i}.sgf").write_text(
            serialize_sgf(game_from_moves(moves, 19)))
    (root / "ladder_list").write_text(
        "".join(f"{name} {n}\n" for name, n in PROBES) + "# comment line\n")
    return str(root)


def _eq_state(t, j):
    """A port GoState equals a JAX GoState field by field (hashes: the
    port keeps the u32 bits in int32)."""
    for name, a, b in zip(t._fields, t, j):
        if isinstance(a, tuple):
            _eq_state(a, b)
        else:
            b = np.asarray(b)
            np.testing.assert_array_equal(a.cpu().numpy().astype(b.dtype), b,
                                          err_msg=name)


def test_load_suite_and_moves_equal(suite):
    t = tladder.load_suite(suite)
    assert t == jladder.load_suite(suite)
    assert len(t) == len(PROBES)
    for path, _ in t:
        assert tladder.load_moves(path) == jladder.load_moves(path)


def test_default_suite_is_read_at_call_time(suite, monkeypatch):
    monkeypatch.setattr(tladder, "DEFAULT_SUITE", suite)
    assert tladder.load_suite() == jladder.load_suite(suite)
    assert [c.sgf for c in tladder.classify_suite(limit=2)] == \
        ["g0.sgf", "g0.sgf"]


def test_missing_suite_raises_the_same(tmp_path):
    missing = str(tmp_path / "nothing")
    for m, kw in ((jladder, {}), (tladder, {"device": "cpu"})):
        with pytest.raises(FileNotFoundError):
            m.load_suite(missing)
        with pytest.raises(FileNotFoundError):
            m.classify_suite(missing)
        with pytest.raises(FileNotFoundError):
            m.run_ladder_suite(lambda st, size: 0, missing, **kw)
        with pytest.raises(FileNotFoundError):
            m.ladder_policy_scorecard(lambda f, tp: None, missing, **kw)


def test_batch_replay_equal(suite):
    move_lists = [tladder.load_moves(os.path.join(suite, "ladder", f"g{i}.sgf"))
                  [0] for i in range(5)]
    jill, jst = jladder.batch_replay(move_lists, 19)
    till, tst = tladder.batch_replay(move_lists, 19, device="cpu")
    assert till.dtype == bool and till.shape == jill.shape
    np.testing.assert_array_equal(till, jill)
    # only the spliced stone is illegal
    assert np.argwhere(till).tolist() == [[4, ILLEGAL_AT]]
    _eq_state(tst, jst)


def test_run_ladder_suite_equal(suite):
    """A deterministic move generator that reads the state (the lowest
    legal point after an offset set by the ply), with and without
    `limit`."""
    def gen_from(lm, ply):
        legal = np.flatnonzero(np.asarray(lm)[0, :-1])
        return int(legal[(7 * int(ply)) % len(legal)])

    def jgen(st, size):
        return gen_from(jstate.legal_moves(st, size), st.core.ply[0])

    def tgen(st, size):
        return gen_from(tstate.legal_moves(st, size).numpy(),
                        st.core.ply[0])

    for limit in (None, 4):
        j = jladder.run_ladder_suite(jgen, suite, limit=limit)
        t = tladder.run_ladder_suite(tgen, suite, limit=limit, device="cpu")
        assert (t.total, t.matched, t.failures) == \
            (j.total, j.matched, j.failures)
        assert t.accuracy == j.accuracy
    assert t.total == 4 and j.total == 4


def test_policy_scorecard_equal(suite):
    jcfg = JModelConfig(board_size=19, num_block=1, dim=8, use_bf16=False)
    params, stats = init_params(jcfg, jax.random.PRNGKey(3))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), stats)
    fwd = jax.jit(apply_fn(jcfg))
    net = params_from_jax(params, stats, ModelConfig(
        board_size=19, num_block=1, dim=8, use_bf16=False), "cpu")

    seen = {}

    def jeval(feats, to_play):
        out = fwd(params, stats, feats)
        seen["log_pi"] = np.asarray(out[0])
        return out

    j = jladder.ladder_policy_scorecard(jeval, suite)
    t = tladder.ladder_policy_scorecard(lambda f, tp: net(f), suite,
                                        device="cpu")
    # every probe's top two legal moves stand apart in the JAX net
    moves = [tladder.load_moves(p) for p, _ in tladder.load_suite(suite)]
    prefixes = [m[:n] for (m, _), (_, n) in zip(moves, PROBES)
                if n < len(m)]
    _, jst = jladder.batch_replay(prefixes, 19)
    lm = np.asarray(jstate.legal_moves(jst, 19))
    top2 = np.sort(np.where(lm, seen["log_pi"], -np.inf), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all()
    assert (t.total, t.matched, t.failures) == (j.total, j.matched, j.failures)
    assert t.total == len(PROBES) - 1

    # an oracle evaluator, one-hot at each probe's move, scores 100 %
    expected = torch.tensor([m[n] for (m, _), (_, n) in zip(moves, PROBES)
                             if n < len(m)])

    def oracle(feats, to_play):
        lp = torch.full((feats.shape[0], 362), -1e6)
        lp[torch.arange(len(expected)), expected] = 0.0
        return lp, torch.zeros(feats.shape[0])

    o = tladder.ladder_policy_scorecard(oracle, suite, device="cpu")
    assert o.matched == o.total == len(PROBES) - 1 and o.accuracy == 1.0


def test_empty_scorecard_equal(suite, tmp_path):
    """Every probe past its game's end: an empty result in both."""
    (tmp_path / "ladder").mkdir()
    (tmp_path / "ladder" / "g.sgf").write_text(
        open(os.path.join(suite, "ladder", "g1.sgf")).read())
    (tmp_path / "ladder_list").write_text("g.sgf 400\n")
    j = jladder.ladder_policy_scorecard(None, str(tmp_path))
    t = tladder.ladder_policy_scorecard(None, str(tmp_path), device="cpu")
    assert (t.total, t.matched, t.failures, t.accuracy) == \
        (j.total, j.matched, j.failures, j.accuracy) == (0, 0, [], 0.0)


def test_classify_suite_equal(suite):
    j = jladder.classify_suite(suite)
    t = tladder.classify_suite(suite)
    assert [vars(r) for r in t] == [vars(r) for r in j]
    assert len(t) == len(PROBES) - 1          # g3 500 is past the end
    assert tladder.classify_suite(suite, limit=3) == t[:3]
