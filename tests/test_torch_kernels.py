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

