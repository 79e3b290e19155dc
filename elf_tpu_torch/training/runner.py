"""Learner runner: the training server's main loop, in one process.
Counterpart of `elf_tpu/training/runner.py` (reference
`scripts/elfgames/go/train.py` + `rlpytorch/runner/single_process.py`):
 - episodes of `num_minibatch` train steps sampling from the replay
   pipeline (single_process.py:57);
 - `num_cooldown` BN re-estimation passes before each checkpoint
   (single_process.py:101);
 - save `save-<step>.bin`; the step is the new model version
   (train.py:122 episode_summary -> notifyNewVersion).

The steps update `self.state` in place (the JAX runner donates its state
to the step instead), so a caller that needs a frozen copy of the state
takes `copy.deepcopy(runner.state)`.

The mesh path: pass a `parallel.mesh.Mesh` to run the step over the ranks
of a torch.distributed world (dp batch rows, tp channels).  With more
than one rank, rank 0 hosts the replay and the control plane and
broadcasts each sampled host batch (`HostSync`); every rank extracts the
features of its dp rows and takes the sharded step; rank 0 writes the
checkpoint from the gathered full state.  Unlike the JAX runner, tp may
span processes: the checkpoint gathers the shards first.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.device import DeviceLike
from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.training.pipeline import TrainingPipeline
from elf_tpu_torch.training.trainer import Trainer, save_checkpoint


class LearnerRunner:
    def __init__(
        self,
        trainer: Trainer,
        pipeline: TrainingPipeline,
        ckpt_dir: str,
        opts: TrainOptions,
        mesh=None,
        seed: int = 0,
        train_mode: str = "mcts",
    ):
        """train_mode: "mcts" (df_kl: AlphaZero MCTSPrediction on visit
        distributions) or "offline" (df_pred: supervised
        MultiplePrediction on the `offline_a` future-action targets).  The
        state lives on the trainer's device."""
        if train_mode not in ("mcts", "offline"):
            raise ValueError(f"train_mode={train_mode!r}")
        self.trainer = trainer
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.opts = opts
        self.train_mode = train_mode
        self.device: DeviceLike = trainer.device
        self.logger = get_indexed_logger("training.LearnerRunner-")
        # learner<->selfplay coupling (train.py:70-78): when set, batches
        # containing records of a different selfplay version are skipped
        # (unless keep_prev_selfplay)
        self.version_provider = None       # () -> current selfplay version
        self.keep_prev_selfplay = True
        self.skipped_stale_batches = 0
        self.ckpt_keep = 10                # keep-last-k checkpoint cleanup
        self.mesh = mesh
        # multi-process learner (train_server_torch.py --dist_*, or one
        # rank per card): rank 0 hosts the replay + control plane and
        # broadcasts each sampled host batch; every rank extracts features
        # for its dp rows and takes the sharded step (the
        # DistributedDataParallel counterpart, df_model3.py:213-247)
        self.sync = None
        self.save_enabled = True
        if mesh is not None and mesh.size > 1:
            from elf_tpu_torch.parallel.distributed import HostSync

            self.sync = HostSync(mesh.host_group)
            self.save_enabled = self.sync.rank0
        self.state = trainer.init_state(torch.Generator().manual_seed(seed))
        self._shardings = None
        if mesh is not None:
            from elf_tpu_torch.parallel.mesh import (
                make_sharded_train_step,
                shard_state,
            )

            self._train_step, self._shardings = make_sharded_train_step(
                trainer, mesh, self.state, train_mode=train_mode)
            self.state = shard_state(self.state, self._shardings)
        else:
            self._train_step = (trainer.make_offline_train_step()
                                if train_mode == "offline"
                                else trainer.make_train_step())
        self._cooldown_step = trainer.make_cooldown_step()

    def _sample_checked(self, checked: bool = True):
        hb = self.pipeline.sample_host_batch(self.opts.batchsize)
        if hb is None:
            return None
        if (checked and self.version_provider is not None
                and not self.keep_prev_selfplay):
            cur = int(self.version_provider())
            if (hb.selfplay_ver != cur).any():
                # stale in-flight batch after a promotion (train.py:72)
                self.skipped_stale_batches += 1
                self.logger.info(
                    "skipping batch with selfplay_ver != %d", cur
                )
                return None
        return hb

    def _multihost_batch(self, checked: bool = True):
        """Collective: rank 0 samples (and stale-checks); every rank gets
        the whole host batch, or None if rank 0 had nothing."""
        from elf_tpu_torch.training.pipeline import HostBatch

        hb = self._sample_checked(checked) if self.sync.rank0 else None
        if not self.sync.flag(hb is not None):
            return None
        if hb is None:
            hb = self.pipeline.zero_host_batch(self.opts.batchsize)
        return HostBatch(*self.sync.tree(tuple(hb)))

    def _local_slice(self, hb):
        """This rank's dp-contiguous rows of the global batch (the tp ranks
        of one dp index take the same rows)."""
        from elf_tpu_torch.parallel.mesh import batch_sharding
        from elf_tpu_torch.training.pipeline import HostBatch

        rows = batch_sharding(self.mesh, self.opts.batchsize)
        return HostBatch(*[None if a is None else a[rows] for a in hb])

    def _next_batch(self, checked: bool = True):
        """The host batch this rank trains on (its dp rows under a
        multi-rank mesh), or None."""
        if self.sync is None:
            if checked:
                return self._sample_checked()
            return self.pipeline.sample_host_batch(self.opts.batchsize)
        hb = self._multihost_batch(checked)
        return None if hb is None else self._local_slice(hb)

    def run_minibatch(self) -> Optional[Dict[str, float]]:
        hb = self._next_batch()
        if hb is None:
            return None
        batch = (self.pipeline.device_batch_offline
                 if self.train_mode == "offline"
                 else self.pipeline.device_batch)
        feats, target, winner = batch(hb, self.device)
        self.state, stats = self._train_step(self.state, feats, target, winner)
        return {k: float(v) for k, v in stats.items()}

    def run_cooldown(self) -> int:
        """BN re-estimation passes before checkpointing."""
        n = 0
        for _ in range(self.opts.num_cooldown):
            hb = self._next_batch(checked=False)
            if hb is None:
                break
            feats, _, _ = self.pipeline.device_batch(hb, self.device)
            self.state = self._cooldown_step(self.state, feats)
            n += 1
        return n

    def episode(self, num_minibatch: int) -> Dict[str, float]:
        """One training episode; returns averaged stats."""
        agg: Dict[str, list] = {}
        done = 0
        while done < num_minibatch:
            stats = self.run_minibatch()
            if stats is None:
                time.sleep(0.5)
                continue
            done += 1
            for k, v in stats.items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def version(self) -> int:
        """Current model version (= train step)."""
        return int(self.state.step)

    def full_state(self):
        """The whole TrainState: the state itself, or on a mesh the shards
        gathered (collective under tp: every rank calls it)."""
        if self._shardings is None:
            return self.state
        from elf_tpu_torch.parallel.mesh import gather_state

        return gather_state(self.state, self._shardings)

    def load_state(self, state) -> None:
        """Take a whole TrainState (e.g. `load_checkpoint`'s) as the
        runner's state; on a mesh, this rank's shard of it."""
        if self._shardings is not None:
            from elf_tpu_torch.parallel.mesh import shard_state

            state = shard_state(state, self._shardings)
        self.state = state

    def episode_summary(self) -> int:
        """Cooldown + checkpoint; returns the new model version (= step).
        On a multi-rank mesh every rank runs the (collective) cooldown and
        gather, and rank 0 writes the checkpoint."""
        self.run_cooldown()
        ver = self.version()
        state = self.full_state()
        if self.save_enabled:
            path = save_checkpoint(self.ckpt_dir, state, keep=self.ckpt_keep)
            self.logger.info("saved %s (version %d)", path, ver)
        return ver
