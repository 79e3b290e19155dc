"""Action sampling from policies: counterpart of `elf_tpu/rl/sampler.py`
(the reference's `rlpytorch/sampler/`: `sampler.py:11` Sampler,
`sample_methods.py:94` sample_multinomial, `:128` epsilon_greedy).

Multinomial or greedy selection over a policy head, with epsilon-uniform
exploration mixed in, over the whole batch at once.  The draws come from an
explicit `torch.Generator` where the JAX sampler takes a PRNG key, so the
two packages draw different samples from their seeds: the greedy path
(and so `epsilon = 0` with it) gives the same actions, and the random
paths the same distributions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    sample_policy: str = "epsilon-greedy"  # epsilon-greedy | multinomial | uniform
    greedy: bool = False                   # --store_greedy
    epsilon: float = 0.0


def _categorical(logits: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max, as
    `jax.random.categorical` draws)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


class Sampler:
    def __init__(self, opts: SamplerOptions):
        self.opts = opts

    def sample(self, pi: torch.Tensor, generator: torch.Generator,
               legal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pi [B, A] probabilities -> actions [B] (int32).  `generator`
        lives on pi's device."""
        opts = self.opts
        if legal is not None:
            pi = torch.where(legal, pi, 0.0)
            pi = pi / pi.sum(dim=1, keepdim=True).clamp(min=1e-10)
        B, A = pi.shape

        greedy = opts.greedy or opts.sample_policy == "epsilon-greedy"
        if greedy:
            base = torch.argmax(pi, dim=1)
        else:
            logits = torch.log(pi.clamp(min=1e-10))
            if legal is not None:
                logits = torch.where(legal, logits, -1e9)
            base = _categorical(logits, generator)

        if opts.epsilon > 0:
            # epsilon-mix with uniform (sample_eps_with_check)
            explore = torch.rand((B,), generator=generator,
                                 device=pi.device) < opts.epsilon
            uni_logits = (torch.where(legal, 0.0, -1e9) if legal is not None
                          else torch.zeros((B, A), device=pi.device))
            uniform = _categorical(uni_logits, generator)
            base = torch.where(explore, uniform, base)
        return base.to(torch.int32)
