"""The port's play surface against the JAX package: the GTP console, the SGF
analysis driver, the SGF parser and writer, the tree dump, the ladder
reader, and the actor's persistent trees, SGF preload and SGF dumps.

The same GTP script goes through the JAX `GtpConsole` and the port's, each
with persistent trees on and off, and must give the same answers byte for
byte; so must the analysis drivers' reports, printed lines and tree files.
The searches use an evaluator whose priors and values are exact in float32
(equal priors on a fixed eighth of the moves, value (black - white
stones) / 16, or a fixed winning value), so both packages store the same bits and print the same digits.
The ladder reader must reproduce every depth of the golden fixtures."""

import gzip
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.console.analysis import AnalysisConfig as JAnalysisConfig
from elf_tpu.console.analysis import AnalysisDriver as JAnalysisDriver
from elf_tpu.console.gtp import GtpConsole as JGtpConsole
from elf_tpu.console.gtp import GtpEngine as JGtpEngine
from elf_tpu.env.go import state as jgostate
from elf_tpu.native import ladder as jladder
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.selfplay.actor import ActorConfig as JActorConfig
from elf_tpu.selfplay.actor import SelfplayActor as JSelfplayActor
from elf_tpu.sgf import sgf as jsgf
from elf_tpu_torch import sgf as tsgf
from elf_tpu_torch.console.analysis import AnalysisConfig, AnalysisDriver
from elf_tpu_torch.console.gtp import GtpConsole, GtpEngine
from elf_tpu_torch.env.go import state as tgostate
from elf_tpu_torch.native import ladder
from elf_tpu_torch.search.mcts import MCTSConfig
from elf_tpu_torch.selfplay.actor import ActorConfig, SelfplayActor

pytestmark = pytest.mark.timeout(600)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def golden(name):
    with gzip.open(os.path.join(GOLDEN, name), "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def exact_eval(xp, where, value=None):
    """Equal priors on one action in eight (zero on the rest, so the search
    goes deep) and value (black - white stones) / 16, or a constant
    black-perspective `value`: every sum the search makes is exact."""

    def eval_fn(feats, to_play):
        K, n = feats.shape[0], feats.shape[1]
        A = n * n + 1
        favored = (np.arange(A) * 37 + 13) % 8 == 0
        log_pi = xp.broadcast_to(xp.asarray(
            np.where(favored, 0.0, -1e4).astype(np.float32))[None], (K, A))
        if value is not None:
            return log_pi, xp.full((K,), value)
        mine = feats[..., 0].reshape(K, n * n).sum(-1)
        theirs = feats[..., 1].reshape(K, n * n).sum(-1)
        b = where(to_play == 1, mine, theirs)
        w = where(to_play == 1, theirs, mine)
        return log_pi, xp.clip((b - w) / 16.0, -1.0, 1.0)

    return lambda params, batch_stats: eval_fn


def search_cfg(**over):
    kw = dict(num_rollouts=16, rollouts_per_batch=4, rotation_flip=False,
              remove_pass_if_dangerous=False)
    kw.update(over)
    return JMCTSConfig(**kw), MCTSConfig(**kw)


# ---------------------------------------------------------------------------
# SGF
# ---------------------------------------------------------------------------

SGF_TEXTS = [
    "(;GM[1]FF[4]SZ[9]KM[5.5]RE[W+3.5]PB[x]PW[y]"
    ";B[dd];W[ee](;B[ff];W[gg])(;B[hh]))",
    "(;SZ[9]C[bracket \\] inside (parens)];B[];W[ab];B[tt])",
    "(;SZ[19]HA[2]AB[dd][pp];W[cc])",
    "(;SZ[9];B[aa];W[bb](;B[cc];W[dd](;B[ee])(;B[ff]))(;B[gg]))",
    "(;GM[1]SZ[5]KM[7.5];B[cc];W[bb];B[dd];W[cb];B[db];W[dc])",
    "junk before (;SZ[9]KM[x]HA[y];B[ee]) after",
]


def sgf_view(game):
    """Everything an SgfGame answers, as plain data."""

    def node(n):
        return (dict(n.props), [node(c) for c in n.children])

    return dict(
        tree=node(game.root), size=game.board_size, komi=game.komi,
        result=game.result, handicap=game.handicap,
        setup=game.setup_stones(), main=list(game.main_moves()),
        variations=game.variations(),
        along=[list(game.moves_along(v)) for v in game.variations()],
    )


def golden_games():
    games = []
    for name in ("ref_traj_9.jsonl.gz", "ref_traj_19.jsonl.gz"):
        for rec in golden(name):
            actions = rec["actions"]
            if isinstance(actions, str):
                actions = json.loads(actions)
            games.append((int(rec["size"]), [int(a) for a in actions]))
    return games


@pytest.mark.parametrize("text", SGF_TEXTS)
def test_sgf_parse_and_serialize_match_jax(text):
    tg, jg = tsgf.parse_sgf(text), jsgf.parse_sgf(text)
    assert sgf_view(tg) == sgf_view(jg)
    out = tsgf.serialize_sgf(tg)
    assert out == jsgf.serialize_sgf(jg)
    assert sgf_view(tsgf.parse_sgf(out)) == sgf_view(tg)


def test_sgf_golden_games_match_jax():
    for size, moves in golden_games():
        kw = dict(komi=7.5, result="B+R", extra_root_props={"PB": ["x]y"]})
        text = tsgf.serialize_sgf(tsgf.game_from_moves(moves, size, **kw))
        assert text == jsgf.serialize_sgf(jsgf.game_from_moves(moves, size,
                                                               **kw))
        back = tsgf.parse_sgf(text)
        assert [m for _, m in back.main_moves()] == moves
        assert sgf_view(back) == sgf_view(jsgf.parse_sgf(text))
    with pytest.raises(ValueError, match="no SGF game tree"):
        tsgf.parse_sgf("no tree here")


# ---------------------------------------------------------------------------
# ladder reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["ref_ladder_rand_9", "ref_ladder_rand_19",
                                     "ref_ladder_suite_19"])
def test_ladder_depths_match_golden(fixture):
    n_moves = n_nonzero = 0
    for rec in golden(f"{fixture}.jsonl.gz"):
        stones = np.frombuffer(rec["stones"].encode(), np.uint8).astype(
            np.int8) - ord("0")
        size = int(np.sqrt(stones.size))
        for move, want in rec["depths"]:
            got = ladder.ladder_escape_depth(
                stones, move, rec["player"], size,
                ko_point=rec["ko_point"], ko_color=rec["ko_color"])
            assert got == want, (fixture, move, rec["player"])
            n_moves += 1
            n_nonzero += want > 0
    assert n_moves > 400 and n_nonzero > 0


def test_ladder_reads_match_jax():
    """capture / doomed_escape / none with depths, on random 9x9 boards
    around a working ladder and its breakers, against the JAX reader."""
    size = 9

    def pt(r, c):
        return r * size + c

    base = np.zeros(size * size, np.int8)
    base[pt(4, 4)] = 2
    for p in (pt(3, 4), pt(4, 3), pt(5, 4), pt(4, 6)):
        base[p] = 1
    rng = np.random.default_rng(0)
    boards = [base, base.copy(), base.copy()]
    boards[1][pt(7, 7)] = 2
    boards[2][pt(4, 5)] = 2
    for _ in range(20):
        b = base.copy()
        extra = rng.choice(size * size, 6, replace=False)
        b[extra] = np.where(b[extra] == 0, rng.integers(1, 3, 6), b[extra])
        boards.append(b)
    n_ladders = 0
    for b in boards:
        for move in range(size * size):
            for player in (1, 2):
                got = ladder.read_ladder(b, move, player, size)
                assert got == jladder.read_ladder(b, move, player, size)
                assert ladder.classify_ladder_move(b, move, player) == got[0]
                n_ladders += got[0] != "none"
    assert n_ladders > 0


# ---------------------------------------------------------------------------
# GTP
# ---------------------------------------------------------------------------

# 9x9: every command of the console, illegal and out-of-turn moves, undo
# past a search, the ladder extension on a ladder shape
SCRIPT_9 = """protocol_version
name
7 version
known_command genmove
known_command bogus
list_commands
bogus_cmd
boardsize 9
clear_board
komi 7.5
play B E5
genmove W
play B C3
genmove W
genmove B
showboard
play W E5
play X Z9
play B
genmove B
play B D6
genmove W
undo
undo
genmove W
showboard
final_score
final_status_list alive
final_status_list dead
final_status_list seki
final_status_list nonsense
time_settings 600 30 5
kgs-time_settings byoyomi 600 30 5
time_left B 120 3
kgs-game_over
elf-ladder B A1
elf-ladder B pass
clear_board
play b E6
play b D5
play b E4
play b G5
play w E5
elf-ladder w F5
elf-ladder b F5
genmove w
play w pass
genmove b
undo
undo
undo
final_score
boardsize 4
quit
name
"""

# 5x5 with a constant winning value for black: white resigns, black follows
# white's pass (following_pass), the finished game answers pass
SCRIPT_5 = """boardsize 5
clear_board
komi 0.5
play B C3
genmove W
play W pass
genmove B
genmove W
showboard
final_score
undo
genmove B
"""

SCRIPTS = {"9x9": (SCRIPT_9, 9, None, False),
           "5x5-winning": (SCRIPT_5, 5, 127 / 128, True)}


def consoles(script, persistent):
    _, size, value, following = SCRIPTS[script]
    jcfg, tcfg = search_cfg()
    kw = dict(size=size, komi=7.5, seed=3, persistent_tree=persistent,
              following_pass=following)
    jeng = JGtpEngine(exact_eval(jnp, jnp.where, value), jcfg, **kw)
    teng = GtpEngine(exact_eval(torch, torch.where, value), tcfg, **kw,
                     device="cpu")
    jeng.set_model(None, None)
    teng.set_model(None, None)
    return JGtpConsole(jeng), GtpConsole(teng)


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_gtp_transcript_matches_jax(script, persistent):
    jcon, tcon = consoles(script, persistent)
    jout, tout = io.StringIO(), io.StringIO()
    text = SCRIPTS[script][0]
    jcon.run(stdin=io.StringIO(text), stdout=jout)
    tcon.run(stdin=io.StringIO(text), stdout=tout)
    assert tout.getvalue() == jout.getvalue()
    answers = tout.getvalue()
    if script == "9x9":
        assert "= doomed_escape" in answers and "? illegal move" in answers
        # every command answered, none after quit
        assert answers.count("\n\n") == SCRIPT_9.count("\n") - 1
        assert answers.count("elf_tpu") == 1 and answers.endswith("=\n\n")
    else:
        assert "= resign" in answers and "= pass" in answers
    searches = tcon.engine.searches
    assert searches and all(s["search_s"] > 0 for s in searches)
    # each search finds on its root's edges the visits that the tree held
    # below the move played into that root
    assert all(s["carried_visits"] == s["expected_carry"] for s in searches)
    if persistent and script == "9x9":
        # genmove B right after genmove W starts from the carried subtree
        assert searches[2]["carried_visits"] > 0
    if not persistent:
        assert all(s["carried_visits"] == 0 for s in searches)


def test_gtp_fault_answers_and_the_console_goes_on(capsys):
    """A handler that raises anything answers `? <message>` in both
    consoles (the port logs the traceback on stderr) and the port's console
    answers the commands after it."""
    jcon, tcon = consoles("9x9", persistent=False)

    def boom(color):
        raise RuntimeError("the search failed")

    for con in (jcon, tcon):
        con.engine.genmove = boom
    script = "1 genmove b\nplay b E5\n2 genmove w\nname\nshowboard\n"
    jout, tout = io.StringIO(), io.StringIO()
    jcon.run(stdin=io.StringIO(script), stdout=jout)
    tcon.run(stdin=io.StringIO(script), stdout=tout)
    assert tout.getvalue() == jout.getvalue()
    answers = tout.getvalue().split("\n\n")
    assert answers[:4] == ["?1 the search failed", "=",
                           "?2 the search failed", "= elf_tpu"]
    assert not tcon.done
    assert "RuntimeError: the search failed" in capsys.readouterr().err


def test_undo_restores_the_exact_position():
    """The history holds states that no later step or search changes: undo
    after a search gives back the earlier position bit for bit."""
    _, tcon = consoles("9x9", True)
    eng = tcon.engine

    def snapshot():
        return [t.clone() for t in torch.utils._pytree.tree_leaves(eng.state)]

    tcon.handle("play B E5")
    before = snapshot()
    tcon.handle("genmove W")
    tcon.handle("play B C3")
    tcon.handle("genmove W")
    assert tcon.handle("undo") == "=\n"
    assert tcon.handle("undo") == "=\n"
    assert tcon.handle("undo") == "=\n"
    after = snapshot()
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert eng.tree is None


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["follow", "selfplay"])
def test_analysis_matches_jax(mode, tmp_path):
    size = 9
    moves = golden_games()[0][1][:14]
    sgf_path = tmp_path / "game.sgf"
    sgf_path.write_text(tsgf.serialize_sgf(tsgf.game_from_moves(moves, size)))
    kw = dict(preload_sgf=str(sgf_path), verbose=True, top_k=4)
    if mode == "follow":
        kw.update(preload_sgf_move_to=8, follow_sgf=True)
    else:
        kw.update(preload_sgf_move_to=12, max_moves=4, persistent_tree=False)
    jcfg, tcfg = search_cfg()
    reports, outs, dirs = [], [], []
    for side, (Driver, Config, xp, where, extra) in {
        "jax": (JAnalysisDriver, JAnalysisConfig, jnp, jnp.where, {}),
        "torch": (AnalysisDriver, AnalysisConfig, torch, torch.where,
                  {"device": "cpu"}),
    }.items():
        d = tmp_path / side
        d.mkdir()
        cfg = Config(dump_record_prefix=str(d / "tree"), **kw)
        drv = Driver(exact_eval(xp, where), jcfg if side == "jax" else tcfg,
                     cfg, size=size, seed=5, **extra)
        drv.set_model(None, None)
        out = io.StringIO()
        reports.append(drv.run(out=out))
        outs.append(out.getvalue())
        dirs.append(d)
    jrep, trep = reports
    assert outs[1] == outs[0]
    assert len(trep) == (6 if mode == "follow" else 4)
    for j, t in zip(jrep, trep):
        jf, tf = j.pop("tree_file"), t.pop("tree_file")
        assert t == j
        assert os.path.basename(tf) == os.path.basename(jf)
        content = open(tf).read()
        assert content == open(jf).read()
        assert "- Total visit:" in content and "[n:" in content
    assert outs[1].splitlines()[-1].startswith("final_score ")


# ---------------------------------------------------------------------------
# the actor's persistent trees, SGF preload and SGF dumps
# ---------------------------------------------------------------------------


def test_actor_play_options_match_jax(tmp_path):
    """persistent_tree + preload_sgf + dump_record_prefix: the same moves,
    Records and SGF files as the JAX actor, through a game restart (the
    trees of finished boards start afresh)."""
    size, B, cutoff = 9, 3, 6
    moves = golden_games()[0][1]
    sgf_path = tmp_path / "preload.sgf"
    sgf_path.write_text(tsgf.serialize_sgf(tsgf.game_from_moves(moves, size)))
    common = dict(board_size=size, batch=B, policy_distri_cutoff=-1,
                  never_resign_prob=1.0, move_cutoff=cutoff,
                  persistent_tree=True, preload_sgf=str(sgf_path),
                  preload_sgf_move_to=10)
    jcfg, tcfg = search_cfg()
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jactor = JSelfplayActor(
        JActorConfig(**common, dump_record_prefix=str(tmp_path / "jax/g")),
        jcfg, exact_eval(jnp, jnp.where), seed=0)
    tactor = SelfplayActor(
        ActorConfig(**common, dump_record_prefix=str(tmp_path / "torch/g")),
        tcfg, exact_eval(torch, torch.where), seed=0, device="cpu")
    np.testing.assert_array_equal(tactor.state.core.stones.numpy(),
                                  np.asarray(jactor.state.core.stones))
    assert int(tactor.state.core.ply[0]) == 10
    # each board its own opening after the preload
    rng = np.random.default_rng(5)
    for _ in range(2):
        legal = tgostate.legal_moves(tactor.state, size).numpy()[:, :-1]
        a = np.array([rng.choice(np.nonzero(m)[0]) for m in legal], np.int32)
        tactor.state, _ = tgostate.step(tactor.state, torch.from_numpy(a), size)
        jactor.state, _ = jgostate.step(jactor.state, jnp.asarray(a), size)

    n_records = 0
    for ply in range(cutoff + 3):
        jrec = jactor.play_moves(None, None, 1)
        trec = tactor.play_moves(None, None, 1)
        assert tactor.moves == jactor.moves, f"ply {ply}"
        assert len(trec) == len(jrec)
        for t, j in zip(trec, jrec):
            td, jd = t.to_json(), j.to_json()
            td.pop("timestamp")
            jd.pop("timestamp")
            assert td == jd
        n_records += len(trec)
        # the played moves' subtrees carried over; a restarted board's tree
        # is a fresh one-node tree
        carried = tactor.tree.n[:, 0] > 0
        assert bool(carried.any()) if not trec else not bool(carried.any())
    assert n_records == B
    # the restarted boards' trees are fresh trees at the preloaded position
    np.testing.assert_array_equal(tactor.state.core.stones.numpy(),
                                  np.asarray(jactor.state.core.stones))
    tfiles = sorted(os.listdir(tmp_path / "torch"))
    assert tfiles == sorted(os.listdir(tmp_path / "jax")) and len(tfiles) == B
    for name in tfiles:
        text = (tmp_path / "torch" / name).read_text()
        assert text == (tmp_path / "jax" / name).read_text()
        b = int(name.split("-")[1])
        game = tsgf.parse_sgf(text)
        assert len(list(game.main_moves())) == cutoff and game.board_size == size
        assert b < B
