"""The port's plain liberty-kernel versions against the JAX package's Pallas
kernels (interpret mode on the CPU) and XLA fixpoint.  All exact.

`elf_tpu_torch/env/go/kernels.py` holds the plain PyTorch versions that the
CUDA kernels are compared with on the card (`chip_smoke.py`); here they
are pinned to the TPU kernels' semantics, following tests/test_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from scipy import ndimage

from elf_tpu.env.go import engine as jengine
from elf_tpu.env.go.pallas_kernels import analyze_libs_pallas, step_analysis_pallas
from elf_tpu_torch.env.go import kernels

pytestmark = pytest.mark.timeout(120)


def _random_boards(B, size, seed, density=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, density, size=(B, size, size)).astype(np.int8)


def _snake(size):
    """One serpentine chain covering the board (worst-case convergence)."""
    b = np.zeros((size, size), np.int8)
    for r in range(size):
        b[r, :] = 1
    for r in range(0, size - 1, 2):
        b[r + 1, :] = 0
        b[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return b[None]


def _check_libs(s):
    size = s.shape[-1]
    lm_t, lx_t = kernels.analyze_libs_ref(torch.from_numpy(s))
    lm_p, lx_p = analyze_libs_pallas(jnp.asarray(s), size, True)
    lm_n, lx_n = jengine._analyze_libs_neighbor(jnp.asarray(s), size)
    for ref in (lm_p, lm_n):
        np.testing.assert_array_equal(lm_t.numpy(), np.asarray(ref))
    for ref in (lx_p, lx_n):
        np.testing.assert_array_equal(lx_t.numpy(), np.asarray(ref))
    assert lm_t.dtype == torch.int32 and lm_t.shape == s.shape


@pytest.mark.parametrize("size", [9, 19])
@pytest.mark.parametrize("B", [1, 5, 130])
def test_analyze_libs_random_boards(size, B):
    _check_libs(_random_boards(B, size, seed=size * 1000 + B))


@pytest.mark.parametrize("size", [9, 19])
def test_analyze_libs_snake(size):
    _check_libs(_snake(size))


def _played_boards(B, size, plies, seed):
    """Boards reached by uniform legal play through the JAX engine."""
    core = jengine.init_core(B, size)
    key = jax.random.PRNGKey(seed)
    legal = jnp.ones((B, size * size + 1), jnp.bool_)
    for _ in range(plies):
        key, k = jax.random.split(key)
        a = jax.random.categorical(k, jnp.where(legal, 0.0, -1e9), axis=1)
        core, info = jengine.step_core(core, a.astype(jnp.int32), size)
        legal = info.legal_next
    return core, legal, key


@pytest.mark.parametrize("size", [9, 19])
def test_step_analysis_matches_pallas(size):
    """Placement -> capture -> analysis on positions from legal play, with
    passes, negative actions and occupied points among the actions."""
    B = 16
    n2 = size * size
    core, legal, key = _played_boards(B, size, 30 if size == 9 else 50, 7)
    a = jax.random.categorical(key, jnp.where(legal, 0.0, -1e9), axis=1)
    action = np.asarray(a, np.int32).copy()
    stones = np.array(core.stones)
    action[:3] = n2                                   # passes
    action[3] = -1                                    # negative: no placement
    action[4] = n2 + 7                                # past the board: pass
    occ = np.nonzero(stones[5])[0]
    if occ.size:
        action[5] = occ[0]                            # occupied: overwritten
    color = np.asarray(core.to_play).astype(np.int32)

    ref = step_analysis_pallas(jnp.asarray(stones), jnp.asarray(action),
                               jnp.asarray(color), size, True)
    ours = kernels.step_analysis_ref(torch.from_numpy(stones),
                                     torch.from_numpy(action),
                                     torch.from_numpy(color))
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
    assert [o.dtype for o in ours] == [torch.int8, torch.int32, torch.int32,
                                       torch.bool]


def test_step_analysis_random_boards_with_captures():
    """Dense random boards: most placements capture or are suicidal."""
    B, size = 130, 9
    n2 = size * size
    rng = np.random.default_rng(3)
    stones = _random_boards(B, size, seed=5).reshape(B, n2)
    action = rng.integers(-2, n2 + 2, size=B).astype(np.int32)
    color = rng.integers(1, 3, size=B).astype(np.int32)
    ref = step_analysis_pallas(jnp.asarray(stones), jnp.asarray(action),
                               jnp.asarray(color), size, True)
    ours = kernels.step_analysis_ref(torch.from_numpy(stones),
                                     torch.from_numpy(action),
                                     torch.from_numpy(color))
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


def test_dispatch_takes_plain_version_on_cpu():
    """CPU tensors go to the plain version and launch nothing."""
    kernels.reset_launch_counts()
    s = torch.from_numpy(_random_boards(3, 9, seed=1))
    lm, lx = kernels.analyze_libs(s)
    lm_r, lx_r = kernels.analyze_libs_ref(s)
    assert torch.equal(lm, lm_r) and torch.equal(lx, lx_r)
    kernels.step_analysis(s.reshape(3, 81), torch.zeros(3, dtype=torch.int32),
                          torch.ones(3, dtype=torch.int32))
    assert kernels.launch_counts() == {"analyze_libs": 0, "step_analysis": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch on CUDA tensors or raise; never a fall back."""
    s = torch.zeros((2, 9, 9), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.analyze_libs_cuda(s)
    with pytest.raises(ValueError):
        kernels.step_analysis_cuda(s.reshape(2, 81),
                                   torch.zeros(2, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))



# ---------------------------------------------------------------------------
# The CUDA kernels' formulation (union-find labelling, liberties reduced at
# each chain's root, one labelling for the whole step), as a plain numpy
# model held against the JAX package and the port's plain versions.
# ---------------------------------------------------------------------------

INF = kernels.INF


def _label_chains(s):
    """Chain id of every stone (4-connectivity per colour), 0 on empty
    points; ids are unique across both colours.  [N, N] -> [N, N] int."""
    labels = np.zeros(s.shape, np.int64)
    n_chains = 0
    for colour in (1, 2):
        lab, k = ndimage.label(s == colour)
        labels[lab > 0] = lab[lab > 0] + n_chains
        n_chains += k
    return labels, n_chains


def _chain_libs(s, labels, n_chains):
    """Min and max flat index of the empty points next to each chain of
    `labels` (stones of `s` only), read back on each stone; INF / -1 on
    empty points and on chains with no liberty."""
    n = s.shape[-1]
    idx = np.arange(n * n).reshape(n, n)
    lm = np.full(n_chains + 1, INF, np.int64)
    lx = np.full(n_chains + 1, -1, np.int64)
    stone = s != 0
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        r0, r1 = max(-dr, 0), n - max(dr, 0)
        c0, c1 = max(-dc, 0), n - max(dc, 0)
        here = (slice(r0, r1), slice(c0, c1))
        there = (slice(r0 + dr, r1 + dr), slice(c0 + dc, c1 + dc))
        hit = stone[here] & (s[there] == 0)
        np.minimum.at(lm, labels[here][hit], idx[there][hit])
        np.maximum.at(lx, labels[here][hit], idx[there][hit])
    lm[0], lx[0] = INF, -1
    out_lm = np.where(stone, lm[labels], INF).astype(np.int32)
    out_lx = np.where(stone, lx[labels], -1).astype(np.int32)
    return out_lm, out_lx


def _model_analyze(stones2d):
    out = [_chain_libs(s, *_label_chains(s)) for s in stones2d]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


def _model_step(stones, action, color):
    """Place, label s1 once, drop the opponent chains with no liberty, and
    take the liberties of s2 on the SAME labels (no second labelling)."""
    B, n2 = stones.shape
    n = int(round(n2 ** 0.5))
    s2s, lms, lxs, caps = [], [], [], []
    for s, a, c in zip(stones, action, color):
        s1 = s.copy()
        if 0 <= a < n2:
            s1[a] = c
        s1 = s1.reshape(n, n)
        labels, k = _label_chains(s1)
        lm1, _ = _chain_libs(s1, labels, k)
        cap = (lm1 == INF) & (s1 == 3 - c)
        s2 = np.where(cap, 0, s1).astype(np.int8)
        lm, lx = _chain_libs(s2, np.where(cap, 0, labels), k)
        s2s.append(s2.reshape(n2))
        lms.append(lm)
        lxs.append(lx)
        caps.append(cap.reshape(n2))
    return np.stack(s2s), np.stack(lms), np.stack(lxs), np.stack(caps)


def _drawn_case(size, density, seed, B=6):
    """B boards of `size` with stones on `density` of the points, random
    colours; actions with a pass, a negative, an occupied point and
    empty points; random colours to play.  Board 0 is the serpentine chain
    in a colour chosen by the seed."""
    rng = np.random.default_rng(seed)
    n2 = size * size
    stone = rng.random((B, size, size)) < density
    s = np.where(stone, rng.integers(1, 3, (B, size, size)), 0).astype(np.int8)
    s[0] = _snake(size)[0] * rng.integers(1, 3)
    flat = s.reshape(B, n2)
    action = rng.integers(0, n2, B).astype(np.int32)
    action[1] = n2                                    # pass
    action[2] = -int(rng.integers(1, 4))              # negative: nothing placed
    occ = np.nonzero(flat[3])[0]
    if occ.size:
        action[3] = occ[rng.integers(occ.size)]       # occupied: overwritten
    for i in range(4, B):
        empty = np.nonzero(flat[i] == 0)[0]
        if empty.size:
            action[i] = empty[rng.integers(empty.size)]
    color = rng.integers(1, 3, B).astype(np.int32)
    return s, action, color


def _multi_capture_case():
    """Black at 2 captures three separate white chains at once."""
    size = 5
    s = np.zeros((size, size), np.int8)
    # white stones at 1, 3 (row 0) and 7 (row 1), each walled in by black
    s[0, 1] = s[0, 3] = s[1, 2] = 2
    s[0, 0] = s[1, 1] = s[2, 2] = s[1, 3] = s[0, 4] = 1
    return s[None], np.array([2], np.int32), np.array([1], np.int32)


def _check_union_find_model(s, action, color):
    size = s.shape[-1]
    B, n2 = s.shape[0], size * size
    flat = s.reshape(B, n2)
    lm, lx = _model_analyze(s)
    for ref in (jengine.analyze_libs(jnp.asarray(s), size),
                kernels.analyze_libs_ref(torch.from_numpy(s))):
        np.testing.assert_array_equal(lm, np.asarray(ref[0]))
        np.testing.assert_array_equal(lx, np.asarray(ref[1]))
    model = _model_step(flat, action, color)
    pallas = step_analysis_pallas(jnp.asarray(flat), jnp.asarray(action),
                                  jnp.asarray(color), size, True)
    plain = kernels.step_analysis_ref(torch.from_numpy(flat),
                                      torch.from_numpy(action),
                                      torch.from_numpy(color))
    for name, m, p, t in zip(("s2", "lib_min", "lib_max", "captured"),
                             model, pallas, plain):
        np.testing.assert_array_equal(m, np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(m, t.numpy(), err_msg=name)


@pytest.mark.parametrize("size", [5, 9, 19])
@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(density=st.floats(0.2, 0.8), seed=st.integers(0, 2**31 - 1))
def test_union_find_model_matches_jax_and_plain(size, density, seed):
    """Labelling once and recomputing only the liberties after captures
    gives exactly what the JAX fixpoint, the Pallas step kernel
    (interpret mode) and the port's plain versions give."""
    _check_union_find_model(*_drawn_case(size, density, seed))


def test_union_find_model_multi_chain_capture():
    s, action, color = _multi_capture_case()
    _check_union_find_model(s, action, color)
    s2, _, _, cap = _model_step(s.reshape(1, -1), action, color)
    assert cap.sum() == 3 and s2[0, 2] == 1
