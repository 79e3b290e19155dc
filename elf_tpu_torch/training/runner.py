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
takes `copy.deepcopy(runner.state)`.  Training over several devices
(`mesh`) is not ported yet.
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
        if mesh is not None:
            raise NotImplementedError("LearnerRunner(mesh=...)")
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
        self.save_enabled = True
        self.state = trainer.init_state(torch.Generator().manual_seed(seed))
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

    def run_minibatch(self) -> Optional[Dict[str, float]]:
        hb = self._sample_checked()
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
            hb = self.pipeline.sample_host_batch(self.opts.batchsize)
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

    def episode_summary(self) -> int:
        """Cooldown + checkpoint; returns the new model version (= step)."""
        self.run_cooldown()
        ver = self.version()
        if self.save_enabled:
            path = save_checkpoint(self.ckpt_dir, self.state,
                                   keep=self.ckpt_keep)
            self.logger.info("saved %s (version %d)", path, ver)
        return ver
