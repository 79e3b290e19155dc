"""Index-suffixed loggers: the port's copy of `elf_tpu/logging_utils.py`
(reference `IndexedLoggerFactory.h:56`).  Every subsystem instance gets a
logger named `<base><index>` under one root with one level switch.
"""

from __future__ import annotations

import itertools
import logging
import sys
import threading
from collections import defaultdict

_ROOT = "elf_tpu_torch"
_counters = defaultdict(itertools.count)
_lock = threading.Lock()
_configured = False


def configure(level: str = "info") -> None:
    global _configured
    with _lock:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter(
                "[%(asctime)s.%(msecs)03d] [%(name)s] [%(levelname)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root = logging.getLogger(_ROOT)
        root.handlers[:] = [h]
        root.setLevel(getattr(logging, level.upper(), logging.INFO))
        _configured = True


def get_indexed_logger(base: str) -> logging.Logger:
    """`getIndexedLogger`: append a per-base instance counter to the name."""
    if not _configured:
        configure()
    with _lock:
        idx = next(_counters[base])
    return logging.getLogger(f"{_ROOT}.{base}{idx}")
