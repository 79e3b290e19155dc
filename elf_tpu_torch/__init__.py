"""elf_tpu_torch: the PyTorch/CUDA port of `elf_tpu`, for one NVIDIA H100.

Mirrors the JAX package's layout; each module is held against its JAX
counterpart by the `tests/test_torch_*.py` suite:

  env/go     engine, state, AGZ-18 features, the liberty kernels' wrappers
  models     policy/value ResNet (inference and training), flax-msgpack
             checkpoints both ways
  search     array-of-trees MCTS
  selfplay   lockstep actor, pair evaluator, records
  training   loss, trainer (optimizer, train / cooldown steps), replay
             buffer, batch pipeline, learner runner
  native     host-side C helpers (game replayer)
  tools      head-to-head matches
  config, logging_utils, stats   option groups, loggers, win rates

The two TPU kernels of the Go engine are hand-written CUDA here
(`csrc/go_libs.cu`, wrapped by `env/go/kernels.py`); `_build.py` builds
them, and the host C code in `csrc/`, at first use.  Imports torch and
numpy only.
"""

from elf_tpu_torch.device import require_cuda, resolve_device

__all__ = ["require_cuda", "resolve_device"]
