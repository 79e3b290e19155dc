from elf_tpu_torch.rl.sampler import Sampler, SamplerOptions  # noqa: F401
from elf_tpu_torch.rl.methods import (  # noqa: F401
    actor_critic_loss,
    discounted_returns,
    policy_gradient_loss,
    q_learning_loss,
    value_matcher_loss,
)
