"""elf_tpu_torch: the PyTorch/CUDA port of `elf_tpu`, for one NVIDIA H100.

Mirrors the JAX package's layout (`env/go`, `models`, `search`,
`selfplay`); each module is held against its JAX counterpart by the
`tests/test_torch_*.py` suite.  The two TPU kernels of the Go engine are
hand-written CUDA here (`csrc/go_libs.cu`, wrapped by
`env/go/kernels.py`).  Imports torch and numpy only.
"""

from elf_tpu_torch.device import require_cuda, resolve_device

__all__ = ["require_cuda", "resolve_device"]
