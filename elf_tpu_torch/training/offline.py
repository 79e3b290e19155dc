"""Offline data loading: bulk SGF / record-JSON files -> the training
pipeline.  Counterpart of `elf_tpu/training/offline.py` (reference
`distri_server.h:74` DataOfflineLoaderJSON: list the files, load them on 16
threads; and the `offline_train` mode that replays SGF archives).

Loads record-JSON lines or SGF game files concurrently into a
TrainingPipeline for supervised training (`df_pred`: predict the played
move; the value target is the game's result).  Records enter the replay
buffer in path order, whatever order the threads finish in, as in the JAX
loader, so equal seeds give equal batches in both packages.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Iterable, List, Optional

import numpy as np

from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.native.sgf_codec import parse_sgf_main
from elf_tpu_torch.selfplay.records import Record, make_record
from elf_tpu_torch.sgf import parse_sgf
from elf_tpu_torch.training.pipeline import TrainingPipeline


def record_from_sgf(text: str, expected_size: Optional[int] = None
                    ) -> Optional[Record]:
    """One SGF game -> a Record with one-hot per-move policies and the
    game result as reward (+1 where RE starts with B, else -1).  None for
    an unparseable game, a game of another size than `expected_size`, or
    one without moves.  The C main-line parser goes first; where it refuses
    the text, the Python parser tries."""
    parsed = parse_sgf_main(text)
    if parsed is not None:
        moves, size, _komi, _handicap, result_str = parsed
    else:
        try:
            game = parse_sgf(text)
        except ValueError:
            return None
        size = game.board_size
        moves = [m for _, m in game.main_moves()]
        result_str = game.result
    if expected_size and size != expected_size:
        return None
    if not moves:
        return None
    A = size * size + 1
    policies = []
    for m in moves:
        p = np.zeros((A,), np.float32)
        p[m] = 1.0
        policies.append(p)
    reward = 1.0 if result_str.upper().startswith("B") else -1.0
    rec = make_record(moves, reward, policies, [0.0] * len(moves), size)
    rec.offline = True
    return rec


def iter_record_json(path: str) -> Iterable[Record]:
    """Record-JSON file: one JSON object per line, or a JSON list."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            for d in json.load(f):
                yield Record.from_json(d)
        else:
            for line in f:
                line = line.strip()
                if line:
                    yield Record.from_json(json.loads(line))


class OfflineLoader:
    """Concurrent bulk loader (DataOfflineLoaderJSON's 16-thread load)."""

    def __init__(self, pipeline: TrainingPipeline, num_threads: int = 16):
        self.pipeline = pipeline
        self.num_threads = num_threads
        self.logger = get_indexed_logger("training.OfflineLoader-")

    def _load_one(self, path: str) -> List[Record]:
        if path.endswith(".sgf"):
            with open(path) as f:
                rec = record_from_sgf(f.read(), self.pipeline.size)
            return [rec] if rec is not None else []
        try:
            return list(iter_record_json(path))
        except (OSError, ValueError) as e:     # JSONDecodeError included
            self.logger.warning("skipping %s: %s", path, e)
            return []

    def load_paths(self, paths: List[str]) -> int:
        """Parse the files on the thread pool and insert their records in
        path order; returns the number of records loaded."""
        loaded = 0
        with concurrent.futures.ThreadPoolExecutor(self.num_threads) as ex:
            for recs in ex.map(self._load_one, paths):    # path order
                for r in recs:
                    self.pipeline.insert_record(r)
                    loaded += 1
        self.logger.info("loaded %d records from %d files", loaded, len(paths))
        return loaded

    def load_dir(self, directory: str) -> int:
        """Every .sgf, .json and .jsonl file of `directory`, sorted by
        name."""
        return self.load_paths(sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.endswith((".sgf", ".json", ".jsonl"))
        ))
