"""Training losses: counterpart of `elf_tpu/training/loss.py`.

 - `mcts_prediction_loss`: the AlphaZero loss of `df_kl` (reference
   `mcts_prediction.py:33-88`): policy = -(mcts_scores * log_pi).sum(1)
   .mean(), value = MSE(V, winner).
 - `multiple_prediction_loss`: supervised future-action NLL of `df_pred`
   (`multiple_prediction.py:30`): NLL of the next action(s), weighted
   1/(i+1) per horizon, + value MSE, with top-1/top-5 accuracy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def mcts_prediction_loss(
    log_pi: torch.Tensor,       # [B, A]
    value: torch.Tensor,        # [B]
    mcts_scores: torch.Tensor,  # [B, A] normalized visit distribution
    winner: torch.Tensor,       # [B] in {-1, +1} (black perspective)
    value_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """value_weight scales the MSE term (reference parity = 1.0)."""
    policy_loss = -(mcts_scores * log_pi).sum(dim=1).mean()
    value_loss = ((value - winner) ** 2).mean()
    entropy = -(torch.exp(log_pi) * log_pi).sum(dim=1).mean()
    total = policy_loss + value_weight * value_loss
    stats = {
        "loss/policy": policy_loss,
        "loss/value": value_loss,
        "loss/total": total,
        "entropy": entropy,
        "blackwin": (winner > 0).float().mean(),
    }
    return total, stats


def multiple_prediction_loss(
    log_pi: torch.Tensor,     # [B, A]
    value: torch.Tensor,      # [B]
    offline_a: torch.Tensor,  # [B, T] future actions (T horizons)
    winner: torch.Tensor,     # [B]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    offline_a = offline_a.long()
    # the single policy head predicts each future horizon, weighted 1/(i+1)
    total_policy = 0.0
    for i in range(offline_a.shape[1]):
        nll = -torch.gather(log_pi, 1, offline_a[:, i:i + 1])[:, 0]
        total_policy = total_policy + nll.mean() / (i + 1)
    value_loss = ((value - winner) ** 2).mean()
    pred = torch.argmax(log_pi, dim=1)
    top1 = (pred == offline_a[:, 0]).float().mean()
    top5_idx = torch.topk(log_pi, 5, dim=1).indices
    top5 = (top5_idx == offline_a[:, 0:1]).any(dim=1).float().mean()
    total = total_policy + value_loss
    stats = {
        "loss/policy": total_policy,
        "loss/value": value_loss,
        "loss/total": total,
        "acc/top1": top1,
        "acc/top5": top5,
    }
    return total, stats
