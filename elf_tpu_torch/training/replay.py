"""Sharded replay buffer with outcome-parity balancing: counterpart of
`elf_tpu/training/replay.py` (reference `ReaderQueuesT<Record>`,
`shared_reader.h:160`).  The host draws come from
`np.random.RandomState(seed)` in the JAX package's order, so the same seed
and the same inserts give the same samples in both packages.

 - N (even) shards; black-win records go to odd shards, losses to even
   (parity insert, shared_reader.h:213) so sampling stays label-balanced;
 - FIFO eviction at `q_max_size` per shard;
 - sampling blocks until every shard holds >= `q_min_size`
   (shared_reader.h:329 waits, here `ready()` + `wait_ready`);
 - uniform sampling over a shard chosen uniformly (Sampler,
   shared_reader.h:40), deterministic under a seeded RNG.

This is a host-side structure: records are compact (move strings +
quantized policies).  `sample_training_batch` draws records and a random
ply for each (game_train.cc:23 GoGameTrain::act); the learner's own path
is `training/pipeline.py`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from elf_tpu_torch.config import ReplayOptions
from elf_tpu_torch.native.sgf_codec import sgf_string_to_moves
from elf_tpu_torch.selfplay.records import Record, dequantize_policy


class ReplayBuffer:
    def __init__(self, opts: ReplayOptions, seed: int = 0):
        assert opts.num_reader % 2 == 0, "num_reader must be even (parity insert)"
        self.opts = opts
        self.queues: List[deque] = [deque() for _ in range(opts.num_reader)]
        self.rng = np.random.RandomState(seed)
        self.lock = threading.Lock()
        self.total_inserted = 0
        self.total_sampled = 0

    # -- insertion ----------------------------------------------------------

    def insert(self, record: Record) -> None:
        """Parity insert: black wins -> odd queues, else even
        (shared_reader.h:213 getSamplerWithParity dual)."""
        n = self.opts.num_reader
        base = self.rng.randint(n // 2) * 2
        qid = base + (1 if record.black_win else 0)
        with self.lock:
            q = self.queues[qid]
            q.append(record)
            while len(q) > self.opts.q_max_size:
                q.popleft()
            self.total_inserted += 1

    def extend(self, records) -> None:
        for r in records:
            self.insert(r)

    # -- sampling -----------------------------------------------------------

    def ready(self) -> bool:
        with self.lock:
            return all(len(q) >= self.opts.q_min_size for q in self.queues)

    def wait_ready(self, timeout: float = 60.0, poll: float = 0.5) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.ready():
                return True
            time.sleep(poll)
        return self.ready()

    def sample(self) -> Optional[Record]:
        with self.lock:
            nonempty = [q for q in self.queues if q]
            if not nonempty:
                return None
            q = nonempty[self.rng.randint(len(nonempty))]
            self.total_sampled += 1
            return q[self.rng.randint(len(q))]

    def sample_many(self, k: int) -> List[Record]:
        out = []
        for _ in range(k):
            r = self.sample()
            if r is not None:
                out.append(r)
        return out

    def size(self) -> int:
        with self.lock:
            return sum(len(q) for q in self.queues)

    def clear(self) -> None:
        with self.lock:
            for q in self.queues:
                q.clear()

    def info(self) -> str:
        with self.lock:
            sizes = [len(q) for q in self.queues]
        return (
            f"ReplayBuffer[{len(sizes)} shards] total={sum(sizes)} "
            f"min={min(sizes)} max={max(sizes)} inserted={self.total_inserted} "
            f"sampled={self.total_sampled}"
        )


def sample_training_batch(
    buffer: ReplayBuffer, batch_size: int, size: int, rng: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Sample records, replay each to a uniformly random ply, and return
    (moves_prefix [B, <=ply], chosen ply indices, mcts policy targets
    [B, A], winners [B]) as host arrays ready for feature building.

    Mirrors GoGameTrain::act (game_train.cc:23): sample with parity,
    `switchRandomMove` to a random ply, `generateD4Code` handled downstream
    during feature extraction.
    """
    records = buffer.sample_many(batch_size)
    if len(records) < batch_size:
        return None
    A = size * size + 1
    all_moves, plies, targets, winners = [], [], [], []
    for r in records:
        moves = sgf_string_to_moves(r.result.content, size)
        n = max(1, len(moves))
        ply = int(rng.randint(n))  # replay to this ply; predict move at ply
        all_moves.append(moves)
        plies.append(ply)
        if ply < len(r.result.policies):
            targets.append(dequantize_policy(r.result.policies[ply], A))
        else:
            t = np.zeros((A,), np.float32)
            if ply < len(moves):
                t[moves[ply]] = 1.0
            targets.append(t)
        winners.append(1.0 if r.result.reward > 0 else -1.0)
    return all_moves, np.asarray(plies), np.stack(targets), np.asarray(
        winners, np.float32
    )
