"""Generic RL loss methods: counterpart of `elf_tpu/rl/methods.py` (the
reference's `rlpytorch/methods/`).

The reference implements these as stateful "Method" objects that walk a
T-step history batch backwards and accumulate autograd errors; here, as in
the JAX package, each is a function over `[T, B, ...]` trajectory tensors
returning (loss, stats).  Every `lax.stop_gradient` of the JAX functions
is a `.detach()` at the same place, so the gradients agree as well as the
values.

 - `discounted_returns` (discounted_reward.py:10): R_T bootstrapped from
   the last value; R_t = gamma * R_{t+1} + r_t, reset to r_t at terminals.
 - `policy_gradient_loss` (policy_gradient.py:15): advantage-weighted NLL
   with log(pi + min_prob), entropy regularization `entropy_ratio`, and an
   importance-ratio clamp pi/old_pi <= ratio_clamp applied to the gradient
   weight.
 - `actor_critic_loss` (actor_critic.py:14): T-step PG with advantage
   (R - V) + value-matching MSE to R.
 - `value_matcher_loss` (value_matcher.py:15): MSE(V, target).
 - `q_learning_loss` (q_learning.py:15): 1-step TD: Q(s_t, a_t) vs
   r_t + gamma * max_a Q(s_{t+1}, a), target detached, terminal-gated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def discounted_returns(
    rewards: torch.Tensor,     # f32 [T, B]
    terminals: torch.Tensor,   # bool [T, B]
    bootstrap: torch.Tensor,   # f32 [B]   V at the step after the window
    gamma: float = 0.99,
) -> torch.Tensor:
    """R [T, B] computed backwards with terminal resets (the reverse
    `lax.scan` of the JAX function as a loop over T)."""
    R = bootstrap
    out = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        R = gamma * R + rewards[t]
        R = torch.where(terminals[t], rewards[t], R)
        out[t] = R
    return torch.stack(out)


def _take(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """x[n, actions[n]] for x [N, A]."""
    return torch.gather(x, 1, actions.long()[:, None])[:, 0]


def policy_gradient_loss(
    pi: torch.Tensor,             # f32 [N, A] action probabilities
    actions: torch.Tensor,        # i32 [N]
    advantages: torch.Tensor,     # f32 [N]  (detached inside)
    entropy_ratio: float = 0.01,
    min_prob: float = 1e-6,
    old_pi: Optional[torch.Tensor] = None,
    ratio_clamp: float = 10.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    log_pi = torch.log(pi + min_prob)
    nll = -_take(log_pi, actions)

    w = advantages.detach()
    if old_pi is not None:
        # importance ratio, clamped (policy_gradient.py ratio_clamp)
        pa = _take(pi, actions)
        oa = _take(old_pi, actions)
        ratio = (pa / torch.clamp(oa, min=min_prob)).detach()
        w = w * torch.clamp(ratio, 0.0, ratio_clamp)

    policy_err = (nll * w).mean()
    entropy_err = (log_pi * pi).sum(dim=1).mean()  # negative entropy
    loss = policy_err + entropy_ratio * entropy_err
    return loss, {
        "pg/policy_err": policy_err,
        "pg/entropy": -entropy_err,
    }


def value_matcher_loss(value: torch.Tensor, target: torch.Tensor
                       ) -> torch.Tensor:
    return torch.mean((value - target.detach()) ** 2)


def actor_critic_loss(
    pi: torch.Tensor,          # f32 [T, B, A]
    values: torch.Tensor,      # f32 [T+1, B]   (V at each step + bootstrap)
    actions: torch.Tensor,     # i32 [T, B]
    rewards: torch.Tensor,     # f32 [T, B]
    terminals: torch.Tensor,   # bool [T, B]
    gamma: float = 0.99,
    entropy_ratio: float = 0.01,
    min_prob: float = 1e-6,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    T, B, A = pi.shape
    R = discounted_returns(rewards, terminals, values[-1], gamma)  # [T, B]
    V = values[:-1]
    adv = R - V.detach()
    pg_loss, pg_stats = policy_gradient_loss(
        pi.reshape(T * B, A),
        actions.reshape(T * B),
        adv.reshape(T * B),
        entropy_ratio=entropy_ratio,
        min_prob=min_prob,
    )
    v_loss = value_matcher_loss(V, R)
    loss = pg_loss + v_loss
    stats = {
        **pg_stats,
        "ac/value_loss": v_loss,
        "ac/mean_return": R.mean(),
        "ac/total": loss,
    }
    return loss, stats


def q_learning_loss(
    q: torch.Tensor,           # f32 [T, B, A]
    actions: torch.Tensor,     # i32 [T-1, B]
    rewards: torch.Tensor,     # f32 [T-1, B]
    terminals: torch.Tensor,   # bool [T-1, B]
    gamma: float = 0.99,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    q_sa = torch.gather(q[:-1], 2, actions.long()[..., None])[..., 0]
    q_next = q[1:].max(dim=2).values.detach()
    target = rewards + gamma * torch.where(terminals, 0.0, q_next)
    loss = torch.mean((q_sa - target) ** 2)
    return loss, {"q/td_loss": loss, "q/mean_q": q_sa.mean()}
