"""ctypes wrapper of the C ladder reader (`csrc/ladder.c`), the port's copy
of `elf_tpu/native/ladder.py` (reference `checkLadder` /
`checkLadderUseSearch`, `board.cc:300-521`, `board.h:392`): host-side
recursive capture/escape reading.

`ladder_escape_depth(stones, move, victim)` - would the victim's escape
move run into a working ladder?  The capture depth (> 0), else 0.
`ladder_capture_depth(stones, move, capturer)` - does the capturer's move
start a working ladder on an adjacent group?

The library is built at first use with the host C compiler; a failed
build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from elf_tpu_torch import _build

_lib = None
_lib_lock = threading.Lock()


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("ladder")
            for fn in ("ladder_escape_depth", "ladder_capture_depth"):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = [
                    ctypes.c_int,
                    np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
            _lib = lib
    return _lib


def _prep(stones, size: Optional[int]) -> Tuple[np.ndarray, int]:
    s = np.ascontiguousarray(np.asarray(stones, np.int8).reshape(-1))
    size = size or int(np.sqrt(s.size))
    if size * size != s.size:      # the C code reads size * size points
        raise ValueError(f"ladder: {s.size} points for a board of size {size}")
    return s, size


def ladder_escape_depth(stones, move: int, victim_color: int,
                        size: Optional[int] = None, ko_point: int = -1,
                        ko_color: int = 0) -> int:
    """checkLadder semantics: depth > 0 iff `victim_color` playing `move`
    (rescuing its atari'd group onto 2 liberties beside one strong enemy
    group) gets ladder-captured."""
    s, size = _prep(stones, size)
    return int(_get_lib().ladder_escape_depth(
        size, s, int(ko_point), int(ko_color), int(move), int(victim_color)))


def ladder_capture_depth(stones, move: int, capturer_color: int,
                         size: Optional[int] = None, ko_point: int = -1,
                         ko_color: int = 0) -> int:
    """depth > 0 iff `capturer_color` playing `move` ataris an adjacent
    group whose escape is ladder-doomed."""
    s, size = _prep(stones, size)
    return int(_get_lib().ladder_capture_depth(
        size, s, int(ko_point), int(ko_color), int(move), int(capturer_color)))


def read_ladder(stones, move: int, player: int,
                size: Optional[int] = None, ko_point: int = -1,
                ko_color: int = 0) -> Tuple[str, int]:
    """Model-free classification of `move` by `player` with its depth:
    ('capture', d) starts a working ladder; ('doomed_escape', d) flees into
    one; ('none', 0)."""
    d = ladder_capture_depth(stones, move, player, size, ko_point, ko_color)
    if d > 0:
        return "capture", d
    d = ladder_escape_depth(stones, move, player, size, ko_point, ko_color)
    if d > 0:
        return "doomed_escape", d
    return "none", 0


def classify_ladder_move(stones, move: int, player: int,
                         size: Optional[int] = None, ko_point: int = -1,
                         ko_color: int = 0) -> str:
    """The class alone; see `read_ladder`."""
    return read_ladder(stones, move, player, size, ko_point, ko_color)[0]
