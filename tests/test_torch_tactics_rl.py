"""The port's board tactics and generic RL methods against the JAX package
on the CPU.

Tactics (`env/go/tactics.py`): every mask equal to the JAX one exactly,
on random boards at 5x5 and 9x9 (colours per board and as one scalar), on
positions of random legal games (`self_atari_mask`), and on the go_test
positions of `tests/test_reference_golden.py::TestEyeish`.

RL (`rl/`): values and gradients (torch.autograd against jax.grad, so a
misplaced `.detach()` shows) within 1e-6 on seeded inputs.  The sampler's
greedy path equals the JAX one; its random draws cannot (a torch generator
against a JAX key), so they are held by legality and by frequencies over
4,000 draws from a fixed seed, within 0.03 of the target probabilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elf_tpu.env.go import engine as jengine
from elf_tpu.env.go import tactics as jtac
from elf_tpu.rl import methods as jm
from elf_tpu.rl import rnn as jrnn
from elf_tpu.rl.sampler import Sampler as JSampler
from elf_tpu.rl.sampler import SamplerOptions as JSamplerOptions
from elf_tpu_torch.env.go import engine as tengine
from elf_tpu_torch.env.go import tactics as ttac
from elf_tpu_torch.rl import methods as tm
from elf_tpu_torch.rl import rnn as trnn
from elf_tpu_torch.rl.sampler import Sampler, SamplerOptions

pytestmark = pytest.mark.timeout(300)

BLACK, WHITE = 1, 2


def _to_torch_core(jc):
    vals = []
    for name in jengine.GoCore._fields:
        a = np.array(getattr(jc, name))
        if name.startswith("hash"):
            a = a.view(np.int32)
        vals.append(torch.from_numpy(a))
    return tengine.GoCore(*vals)


def _random_boards(B, size, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((B, size * size), np.int8)
    for i in range(B):
        p_empty = (0.2, 0.45, 0.7)[i % 3]
        out[i] = rng.choice(3, size=size * size,
                            p=[p_empty, (1 - p_empty) / 2, (1 - p_empty) / 2])
    return out


def _assert_masks_equal(stones, color, size):
    jc = jnp.asarray(color, jnp.int8)
    tc = torch.as_tensor(np.asarray(color), dtype=torch.int8)
    js, ts = jnp.asarray(stones), torch.from_numpy(stones)
    for name in ("eye_mask", "fake_eye_mask", "true_eye_mask"):
        j = np.asarray(getattr(jtac, name)(js, jc, size))
        t = getattr(ttac, name)(ts, tc, size)
        assert t.dtype == torch.bool and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    jm_, jmove = jtac.semi_eye(js, jc, size)
    tm_, tmove = ttac.semi_eye(ts, tc, size)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    assert tmove.dtype == torch.int32
    np.testing.assert_array_equal(tmove.numpy(), np.asarray(jmove))


@pytest.mark.parametrize("size", [5, 9])
def test_eye_masks_match_jax_on_random_boards(size):
    stones = _random_boards(48, size, seed=size)
    colors = np.where(np.arange(48) % 2 == 0, BLACK, WHITE).astype(np.int8)
    _assert_masks_equal(stones, colors, size)
    _assert_masks_equal(stones, np.int8(WHITE), size)


def _random_game_cores(B, size, plies, seed):
    """JAX GoCores after `plies` random legal moves (a few passes)."""
    rng = np.random.default_rng(seed)
    n2 = size * size
    core = jengine.init_core(B, size)
    legal = np.ones((B, n2 + 1), bool)
    out = []
    for ply in range(plies):
        w = legal.astype(float)
        w[:, n2] = 0.03
        a = np.array([rng.choice(n2 + 1, p=r / r.sum()) for r in w], np.int32)
        core, info = jengine.step_core(core, jnp.asarray(a), size)
        legal = np.asarray(info.legal_next)
        if ply % 7 == 6:
            out.append(core)
    return out


@pytest.mark.parametrize("size,plies", [(5, 21), (9, 56)])
def test_self_atari_mask_matches_jax(size, plies):
    """Whole games' positions: the [B * n2] expansion through the port's
    step and liberty analysis gives the JAX mask exactly."""
    seen = 0
    for jc in _random_game_cores(4, size, plies, seed=plies):
        j = np.asarray(jtac.self_atari_mask(jc, size))
        t = ttac.self_atari_mask(_to_torch_core(jc), size)
        assert t.dtype == torch.bool
        np.testing.assert_array_equal(t.numpy(), j)
        seen += int(j.sum())
    assert seen > 0          # the positions hold self-atari points


# ---------------------------------------------- the go_test eye positions

SIZE = 9


def _s2c(s):
    return (ord(s[1]) - ord("a")) * SIZE + ord(s[0]) - ord("a")


def _stones(*rows):
    s = "".join(rows)
    assert len(s) == SIZE * SIZE
    return np.array([{"X": BLACK, "O": WHITE}.get(ch, 0) for ch in s],
                    np.int8)[None]


def _load_board(stones, to_play):
    """The position played stone by stone through the JAX engine (passing
    when the stone's colour is not on turn), as the golden test loads it."""
    core = jengine.init_core(1, SIZE)
    pass_ = np.array([SIZE * SIZE])
    for i, c in enumerate(stones[0]):
        if c == 0:
            continue
        if int(core.to_play[0]) != c:
            core, _ = jengine.step_core(core, pass_, SIZE)
        core, info = jengine.step_core(core, np.array([i]), SIZE)
        assert not bool(info.illegal[0])
    if int(core.to_play[0]) != to_play:
        core, _ = jengine.step_core(core, pass_, SIZE)
    return core


EYEISH = _stones(".XX...XXX", "X.X...X.X", "XX.....X.", "........X",
                 "XXXX.....", "OOOX....O", "X.OXX.OO.", ".XO.X.O.O",
                 "XXO.X.OO.")
CORNER = _stones(".X.......", "XX.......", *["........."] * 7)
EDGE = _stones("...X.X...", "...OXX...", *["........."] * 7)
ENCLOSED = _stones("..X......", "XXX......", *["........."] * 7)
ZERO_LIB = _stones(".X.......", "X........", *["........."] * 7)


def test_eyeish_positions_match_jax():
    """go_test.cc:42 testEyeish and the fake-eye and self-atari cases of
    TestEyeish: the port's masks equal the JAX ones and give the golden
    answers."""
    for stones in (EYEISH, CORNER, EDGE, ENCLOSED, ZERO_LIB):
        for color in (BLACK, WHITE):
            _assert_masks_equal(stones, np.int8(color), SIZE)
    ts = torch.from_numpy(EYEISH)
    b_eyes = ttac.eye_mask(ts, BLACK, SIZE)[0]
    w_eyes = ttac.eye_mask(ts, WHITE, SIZE)[0]
    for mv in ("aa", "bb", "ah", "hb", "ic"):
        assert b_eyes[_s2c(mv)], mv
    for mv in ("ii", "hh", "ig"):
        assert w_eyes[_s2c(mv)], mv
    for mv in ("bg", "ee"):
        assert not b_eyes[_s2c(mv)] and not w_eyes[_s2c(mv)], mv
    assert ttac.true_eye_mask(torch.from_numpy(CORNER), BLACK, SIZE)[0, 0]
    assert ttac.fake_eye_mask(torch.from_numpy(EDGE), BLACK,
                              SIZE)[0, _s2c("ea")]

    for stones, yes, no in ((ENCLOSED, ("aa", "ba"), ("ee", "ai")),
                            (ZERO_LIB, (), ("aa",))):
        jc = _load_board(stones, WHITE)
        t = ttac.self_atari_mask(_to_torch_core(jc), SIZE)[0]
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jtac.self_atari_mask(jc, SIZE))[0])
        assert all(t[_s2c(m)] for m in yes) and not any(t[_s2c(m)] for m in no)


# ------------------------------------------------------------------- rl

def _grads_close(tgrads, jgrads):
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-6)


def _stats_close(ts, js):
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def _softmax_np(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def test_discounted_returns_match_jax():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(6, 4)).astype(np.float32)
    term = rng.random((6, 4)) < 0.3
    boot = rng.normal(size=4).astype(np.float32)
    j = jm.discounted_returns(jnp.asarray(r), jnp.asarray(term),
                              jnp.asarray(boot), gamma=0.9)
    t = tm.discounted_returns(torch.from_numpy(r), torch.from_numpy(term),
                              torch.from_numpy(boot), gamma=0.9)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("with_old", [False, True])
def test_policy_gradient_matches_jax(with_old):
    """Value and gradient with respect to the logits and the advantages
    (whose gradient is 0: they are detached), with and without the clamped
    importance ratio."""
    rng = np.random.default_rng(1)
    N, A = 12, 7
    logits = rng.normal(size=(N, A)).astype(np.float32)
    adv = rng.normal(size=N).astype(np.float32)
    acts = rng.integers(0, A, size=N).astype(np.int32)
    old = _softmax_np(rng.normal(size=(N, A)) * 3).astype(np.float32)
    kw = dict(entropy_ratio=0.05, ratio_clamp=2.0)

    def jloss(lg, ad):
        return jm.policy_gradient_loss(
            jax.nn.softmax(lg), jnp.asarray(acts), ad,
            old_pi=jnp.asarray(old) if with_old else None, **kw)

    (jl, js), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(adv))
    lg = torch.tensor(logits, requires_grad=True)
    ad = torch.tensor(adv, requires_grad=True)
    tl, ts = tm.policy_gradient_loss(
        torch.softmax(lg, dim=1), torch.from_numpy(acts), ad,
        old_pi=torch.from_numpy(old) if with_old else None, **kw)
    tg = torch.autograd.grad(tl, [lg, ad], allow_unused=True)
    assert abs(float(tl.detach()) - float(jl)) < 1e-6
    _stats_close(ts, js)
    _grads_close([tg[0], torch.zeros(N) if tg[1] is None else tg[1]], jg)


def test_actor_critic_and_value_matcher_match_jax():
    """The advantage detaches V; the value loss detaches only its target
    R, so V gets the gradient of (V - R)^2 and the bootstrap value none."""
    rng = np.random.default_rng(2)
    T, B, A = 5, 3, 4
    logits = rng.normal(size=(T, B, A)).astype(np.float32)
    values = rng.normal(size=(T + 1, B)).astype(np.float32)
    acts = rng.integers(0, A, size=(T, B)).astype(np.int32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    term = rng.random((T, B)) < 0.25

    def jloss(lg, v):
        return jm.actor_critic_loss(jax.nn.softmax(lg), v, jnp.asarray(acts),
                                    jnp.asarray(rew), jnp.asarray(term),
                                    gamma=0.9, entropy_ratio=0.02)

    (jl, js), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(values))
    lg = torch.tensor(logits, requires_grad=True)
    v = torch.tensor(values, requires_grad=True)
    tl, ts = tm.actor_critic_loss(torch.softmax(lg, dim=2), v,
                                  torch.from_numpy(acts),
                                  torch.from_numpy(rew),
                                  torch.from_numpy(term), gamma=0.9,
                                  entropy_ratio=0.02)
    tg = torch.autograd.grad(tl, [lg, v])
    assert abs(float(tl.detach()) - float(jl)) < 1e-6
    _stats_close(ts, js)
    _grads_close(tg, jg)
    assert float(tg[1][-1].abs().max()) == 0.0

    tgt = rng.normal(size=(T, B)).astype(np.float32)
    jv, jvg = jax.value_and_grad(jm.value_matcher_loss, argnums=(0, 1))(
        jnp.asarray(values[:-1]), jnp.asarray(tgt))
    vv = torch.tensor(values[:-1], requires_grad=True)
    tt = torch.tensor(tgt, requires_grad=True)
    tv = tm.value_matcher_loss(vv, tt)
    tvg = torch.autograd.grad(tv, [vv, tt], allow_unused=True)
    assert abs(float(tv.detach()) - float(jv)) < 1e-6
    _grads_close([tvg[0], torch.zeros(T, B) if tvg[1] is None else tvg[1]],
                 jvg)


def test_q_learning_matches_jax():
    rng = np.random.default_rng(3)
    T, B, A = 4, 3, 5
    q = rng.normal(size=(T, B, A)).astype(np.float32)
    acts = rng.integers(0, A, size=(T - 1, B)).astype(np.int32)
    rew = rng.normal(size=(T - 1, B)).astype(np.float32)
    term = rng.random((T - 1, B)) < 0.3

    def jloss(qq):
        return jm.q_learning_loss(qq, jnp.asarray(acts), jnp.asarray(rew),
                                  jnp.asarray(term), gamma=0.8)

    (jl, js), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    tl, ts = tm.q_learning_loss(qt, torch.from_numpy(acts),
                                torch.from_numpy(rew), torch.from_numpy(term),
                                gamma=0.8)
    (tg,) = torch.autograd.grad(tl, [qt])
    assert abs(float(tl.detach()) - float(jl)) < 1e-6
    _stats_close(ts, js)
    _grads_close([tg], [jg])


def test_rnn_unroll_loss_and_hist_state_match_jax():
    T, B, D, H = 4, 3, 5, 8
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(D, H)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(T + 1, B, D)).astype(np.float32)
    acts = rng.integers(0, 2, size=(T, B)).astype(np.int32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    term = rng.random((T, B)) < 0.3

    def jcell(p, carry, x):
        carry = jnp.tanh(carry + x @ p["w"])
        return carry, (jax.nn.softmax(carry[:, :2]), carry[:, 2])

    def tcell(p, carry, x):
        carry = torch.tanh(carry + x @ p["w"])
        return carry, (torch.softmax(carry[:, :2], dim=1), carry[:, 2])

    jcarry, jpis, jvs = jrnn.unroll(jcell, {"w": jnp.asarray(w)},
                                    jnp.zeros((B, H)), jnp.asarray(xs))
    tcarry, tpis, tvs = trnn.unroll(tcell, {"w": torch.from_numpy(w)},
                                    torch.zeros(B, H), torch.from_numpy(xs))
    for t, j in ((tcarry, jcarry), (tpis, jpis), (tvs, jvs)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)

    def jloss(wv):
        return jrnn.rnn_actor_critic_loss(
            jcell, {"w": wv}, jnp.zeros((B, H)), jnp.asarray(xs),
            jnp.asarray(acts), jnp.asarray(rew), jnp.asarray(term))

    (jl, js), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    tl, ts = trnn.rnn_actor_critic_loss(
        tcell, {"w": wt}, torch.zeros(B, H), torch.from_numpy(xs),
        torch.from_numpy(acts), torch.from_numpy(rew), torch.from_numpy(term))
    (tg,) = torch.autograd.grad(tl, [wt])
    assert abs(float(tl.detach()) - float(jl)) < 1e-6
    _stats_close(ts, js)
    _grads_close([tg], [jg])

    jh, th = jrnn.HistState(3, 2, (4,)), trnn.HistState(3, 2, (4,))
    for k in range(4):
        obs = np.full((2, 4), k + 1.0, np.float32)
        jh, th2 = jh.push(jnp.asarray(obs)), th.push(torch.from_numpy(obs))
        assert float(th.hist(2)[0, 0]) == (k if k else 0.0)  # th unchanged
        th = th2
        for t in range(3):
            np.testing.assert_array_equal(th.hist(t).numpy(),
                                          np.asarray(jh.hist(t)))


# -------------------------------------------------------------- sampler

def _policies(B, A, seed):
    rng = np.random.default_rng(seed)
    pi = _softmax_np(rng.normal(size=(B, A)) * 2).astype(np.float32)
    legal = rng.random((B, A)) < 0.6
    legal[:, 0] = True
    return pi, legal


@pytest.mark.parametrize("opts", [
    dict(sample_policy="epsilon-greedy"),
    dict(sample_policy="multinomial", greedy=True),
    dict(sample_policy="uniform", greedy=True, epsilon=0.0),
])
def test_sampler_greedy_matches_jax(opts):
    pi, legal = _policies(64, 9, seed=5)
    j, t = JSampler(JSamplerOptions(**opts)), Sampler(SamplerOptions(**opts))
    gen = torch.Generator().manual_seed(0)
    for lg in (None, legal):
        ja = j.sample(jnp.asarray(pi), jax.random.PRNGKey(0),
                      None if lg is None else jnp.asarray(lg))
        ta = t.sample(torch.from_numpy(pi), gen,
                      None if lg is None else torch.from_numpy(lg))
        assert ta.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("opts,target", [
    (dict(sample_policy="multinomial"), "pi"),
    (dict(sample_policy="epsilon-greedy", epsilon=0.3), "eps"),
    (dict(sample_policy="multinomial", epsilon=1.0), "uniform"),
])
def test_sampler_draws_are_legal_with_the_target_frequencies(opts, target):
    """4,000 draws of one row from a fixed seed: only legal actions, each
    at the probability the options give it (within 0.03), as the JAX
    sampler's frequencies are (within 0.03 too)."""
    A, n = 6, 4000
    pi = np.array([[0.05, 0.4, 0.1, 0.3, 0.05, 0.1]], np.float32)
    legal = np.array([[True, True, False, True, True, True]])
    masked = np.where(legal[0], pi[0], 0.0)
    masked = masked / masked.sum()
    uni = legal[0] / legal[0].sum()
    greedy = np.eye(A)[masked.argmax()]
    expect = {"pi": masked, "uniform": uni,
              "eps": 0.7 * greedy + 0.3 * uni}[target]

    gen = torch.Generator().manual_seed(7)
    acts = Sampler(SamplerOptions(**opts)).sample(
        torch.from_numpy(np.repeat(pi, n, 0)), gen,
        torch.from_numpy(np.repeat(legal, n, 0))).numpy()
    assert legal[0][acts].all()
    freq = np.bincount(acts, minlength=A) / n
    np.testing.assert_allclose(freq, expect, atol=0.03)

    jacts = np.asarray(JSampler(JSamplerOptions(**opts)).sample(
        jnp.asarray(np.repeat(pi, n, 0)), jax.random.PRNGKey(7),
        jnp.asarray(np.repeat(legal, n, 0))))
    np.testing.assert_allclose(np.bincount(jacts, minlength=A) / n, expect,
                               atol=0.03)
