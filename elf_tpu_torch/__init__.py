"""elf_tpu_torch: the PyTorch/CUDA port of `elf_tpu`, for one NVIDIA H100.

Mirrors the JAX package's layout; each module is held against its JAX
counterpart by the `tests/test_torch_*.py` suite:

  env/go     engine, state, AGZ-18 features, the liberty kernels' wrappers
  models     policy/value ResNet (inference and training), flax-msgpack
             checkpoints both ways, the model-family registry
  search     array-of-trees MCTS with tree reuse, the tree dump
  selfplay   lockstep actor, pair evaluator, records and wire types
  training   loss, trainer (optimizer, train / cooldown steps), replay
             buffer, batch pipeline, learner runner
  control    the TCP control plane: transport, record journal, client
             manager, self-play and eval controllers, training server,
             self-play client (scripts/train_server_torch.py and
             scripts/selfplay_client_torch.py run them)
  console    the play surface: GTP console, SGF analysis driver
             (scripts/gtp_console_torch.py, scripts/analysis_torch.py)
  sgf        SGF parser and writer
  native     host-side C helpers (game replayer, ladder reader)
  tools      head-to-head matches
  config, logging_utils, stats, profiling
             option groups and argparse registry, loggers, counters and
             timers, torch.profiler traces with stage timers

The two TPU kernels of the Go engine are hand-written CUDA here
(`csrc/go_libs.cu`, wrapped by `env/go/kernels.py`); `_build.py` builds
them, and the host C code in `csrc/`, at first use.  Imports torch and
numpy only.
"""

from elf_tpu_torch.device import require_cuda, resolve_device

__all__ = ["require_cuda", "resolve_device"]
