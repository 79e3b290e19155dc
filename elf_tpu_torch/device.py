"""Device resolution for the port's entry points.

Every entry point (`SelfplayActor`, `run_mcts`, the model builders) takes a
`device` that defaults to ``"cuda"``.  The CPU runs only when a caller asks
for it by name, as the tests do; a missing card is an error, never a silent
fall back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def require_cuda() -> None:
    """Raise unless a CUDA device is usable in this process."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "elf_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device`; raises for a CUDA device without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
