"""On-disk record journaling for the training server.

The port's copy of `elf_tpu/control/journal.py`, same behaviour.

Reference behavior: accepted self-play records are additionally journaled
to disk in chunks of ~1000 games so a restarted server can rebuild its
replay buffer (`RecordBuffer::saveCurrent`, ctrl_selfplay.h:233, invoked
from the data plane at game_ctrl.h:313-314).  Here: accepted records
append to `records-<chunk>.jsonl` under the journal directory, rotating
every `rotate_every` records; `replay_into` refills a record sink (the
replay buffer / training pipeline) from all journal files on resume —
closing the reference's "replay buffer is not checkpointed" gap.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, List

from elf_tpu_torch.selfplay.records import Record


class RecordJournal:
    def __init__(self, directory: str, rotate_every: int = 1000):
        self.directory = directory
        self.rotate_every = rotate_every
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        # resume numbering after existing chunks
        existing = self._chunks()
        self._chunk = (max(existing) + 1) if existing else 0
        self._count = 0
        self._fh = None

    def _chunks(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("records-") and f.endswith(".jsonl"):
                try:
                    out.append(int(f[len("records-"):-len(".jsonl")]))
                except ValueError:
                    pass
        return out

    def _path(self, chunk: int) -> str:
        return os.path.join(self.directory, f"records-{chunk}.jsonl")

    def append(self, record: Record) -> None:
        with self._lock:
            if self._fh is None:
                self._fh = open(self._path(self._chunk), "a")
            self._fh.write(json.dumps(record.to_json()) + "\n")
            # One line per finished game (seconds apart) — flush every
            # append so a crash loses at most the torn trailing line.
            self._fh.flush()
            self._count += 1
            if self._count >= self.rotate_every:
                self._fh.close()
                self._fh = None
                self._chunk += 1
                self._count = 0

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def replay_into(self, sink: Callable[[Record], None],
                    limit: int | None = None) -> int:
        """Feed journaled records to `sink` (resume path), newest chunks
        first but in chronological order within the selection, keeping at
        most `limit` records (pass the replay-buffer capacity so startup
        cost is O(capacity), not O(all games ever)).  Torn/corrupt lines
        (a crash mid-append) are skipped, not fatal.  Returns the number
        of records replayed."""
        selected: List[Record] = []
        for chunk in sorted(self._chunks(), reverse=True):
            path = self._path(chunk)
            chunk_records: List[Record] = []
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            chunk_records.append(
                                Record.from_json(json.loads(line)))
                        except (json.JSONDecodeError, KeyError, TypeError,
                                ValueError):
                            import logging
                            logging.getLogger(__name__).warning(
                                "journal %s: skipping corrupt line", path)
            except OSError:
                continue
            selected = chunk_records + selected
            if limit is not None and len(selected) >= limit:
                break
        if limit is not None:
            selected = selected[-limit:]
        for rec in selected:
            sink(rec)
        return len(selected)
