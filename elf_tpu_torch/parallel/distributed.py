"""Multi-process runtime initialization: counterpart of
`elf_tpu/parallel/distributed.py` (reference `df_model3.py:213-247`:
`--dist_url/rank/world_size` or SLURM env).

The JAX package runs one process per host and drives every local chip
from it; PyTorch runs one process per card, so here a rank is a process
and a device: `maybe_initialize_distributed` joins this process to a
`torch.distributed` world (NCCL on the card, gloo on the CPU) on
`cuda:<local rank>`, after which `parallel.mesh` arranges the world's
ranks as a ("dp", "tp") mesh.

`HostSync` is the rank-0-authoritative lockstep of the multi-process
learner, over a CPU gloo group: flags and host batches decided on rank 0
reach every rank.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from elf_tpu_torch.logging_utils import get_indexed_logger


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def maybe_initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join a torch.distributed world when multi-process args or env are
    present; returns False when nothing asks for one.

    `coordinator` "host:port" is rank 0's rendezvous address (the
    `init_method` tcp://host:port).  Env fallbacks: COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID; torchrun's WORLD_SIZE > 1 (with its RANK,
    LOCAL_RANK and MASTER_ADDR/PORT) stands where the JAX module detects a
    TPU pod.  `backend` defaults to NCCL with a card, gloo without; a
    caller may pass gloo to put several ranks on one card.  With a card,
    the rank's device (`cuda:<local rank>`, the process id modulo the
    visible cards) is made current before the group starts."""
    logger = get_indexed_logger("parallel.distributed-")
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = (process_id if process_id is not None and process_id >= 0
                  else _int_env("PROCESS_ID"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")

    if coordinator is None and num_processes is None:
        if (_int_env("WORLD_SIZE") or 1) > 1:
            _set_device(_int_env("LOCAL_RANK") or 0, backend)
            dist.init_process_group(backend, init_method="env://")
            logger.info("torch.distributed initialized from torchrun: "
                        "rank %d/%d (%s)", dist.get_rank(),
                        dist.get_world_size(), backend)
            return True
        return False
    if not coordinator or not num_processes or process_id is None:
        raise ValueError(
            "a multi-process learner needs the coordinator address, the "
            "number of processes and this process's id (--dist_coordinator "
            "--dist_num_processes --dist_process_id, or COORDINATOR_ADDRESS "
            "NUM_PROCESSES PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    if torch.cuda.is_available():
        _set_device(process_id % torch.cuda.device_count(), backend)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    logger.info("torch.distributed initialized: process %d/%d (%s)",
                process_id, num_processes, backend)
    return True


def _set_device(local_rank: int, backend: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    elif backend == "nccl":
        raise RuntimeError("the NCCL backend needs a CUDA device")


def host_group():
    """A CPU (gloo) process group over the whole world: the world group
    itself (None) where it is gloo, else a new one (collective: every rank
    calls it in the same order)."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


class HostSync:
    """Rank-0-authoritative lockstep helpers for the multi-process learner.

    The control state of the training server (does a sampled batch exist?
    keep looping?) lives only on rank 0, which hosts the TCP control plane
    and the replay buffer.  Every rank runs the same loop and agrees on
    rank 0's decisions through broadcasts over a CPU gloo group (`group`,
    by default one made here).  All methods are collective: every rank
    calls them in the same order, or the world deadlocks, as in the JAX
    class and the reference's DistributedDataParallel."""

    def __init__(self, group=None):
        self.group = group if group is not None else host_group()
        self.rank0 = dist.get_rank() == 0
        self.process_count = dist.get_world_size()

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0, group=self.group)
        return t

    def flag(self, value: Any = False) -> int:
        """Broadcast an int decided on rank 0 (others pass anything)."""
        v = torch.tensor([int(value) if self.rank0 else 0], dtype=torch.int64)
        return int(self._broadcast(v)[0])

    def tree(self, tree_or_template):
        """Broadcast rank 0's tuple of host (numpy) arrays; the other ranks
        pass a tuple of the same structure, shapes and dtypes (e.g.
        `TrainingPipeline.zero_host_batch`).  None entries stay None."""
        out = []
        for a in tree_or_template:
            if a is None:
                out.append(None)
                continue
            a = np.ascontiguousarray(a)
            t = torch.from_numpy(a.copy() if self.rank0 else np.zeros_like(a))
            out.append(self._broadcast(t).numpy())
        return tuple(out)
