"""Recurrent actor-critic utilities: counterpart of `elf_tpu/rl/rnn.py`
(the reference's `methods/rnn_actor_critic.py:16` RNNActorCritic,
`trainer/lstm_trainer.py:18` hidden-state threading and
`utils/hist_states.py:10` HistState).  The recurrence is a loop over T
(the JAX package's `lax.scan`), and the loss reuses `actor_critic_loss`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from elf_tpu_torch.rl.methods import actor_critic_loss

# cell(params, carry, x_t) -> (carry, (pi_t [B, A], v_t [B]))
RecurrentCell = Callable


def unroll(cell: RecurrentCell, params, carry0, xs: torch.Tensor):
    """Run the cell over a [T, B, ...] input; returns (carry, pi [T, B, A],
    v [T, B])."""
    carry, pis, vs = carry0, [], []
    for x in xs:
        carry, (pi, v) = cell(params, carry, x)
        pis.append(pi)
        vs.append(v)
    return carry, torch.stack(pis), torch.stack(vs)


def rnn_actor_critic_loss(
    cell: RecurrentCell,
    params,
    carry0,
    xs: torch.Tensor,          # [T+1, B, ...] observations (last = bootstrap)
    actions: torch.Tensor,     # i32 [T, B]
    rewards: torch.Tensor,     # f32 [T, B]
    terminals: torch.Tensor,   # bool [T, B]
    gamma: float = 0.99,
    entropy_ratio: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _, pis, vs = unroll(cell, params, carry0, xs)
    return actor_critic_loss(
        pis[:-1], vs, actions, rewards, terminals,
        gamma=gamma, entropy_ratio=entropy_ratio,
    )


class HistState:
    """Rolling T-step history of observations per environment slot
    (utils/hist_states.py:10, base/hist.h:20 HistT), a [T, B, ...] tensor
    whose last entry is the newest; `push` returns a new HistState and
    leaves this one as it is."""

    def __init__(self, T: int, batch: int, obs_shape,
                 dtype: torch.dtype = torch.float32, device=None):
        self.T = T
        self.buf = torch.zeros((T, batch) + tuple(obs_shape), dtype=dtype,
                               device=device)

    def push(self, obs: torch.Tensor) -> "HistState":
        new = HistState.__new__(HistState)
        new.T = self.T
        new.buf = torch.cat([self.buf[1:], obs[None].to(self.buf.dtype)],
                            dim=0)
        return new

    def hist(self, t: int) -> torch.Tensor:
        """t-th oldest entry (t = T-1 is the most recent)."""
        return self.buf[t]
