"""ctypes wrapper of the C game replayer (`csrc/replayer.c`), the port's
copy of `elf_tpu/native/replayer.py`.

Record replay is the host-side hot path of training-batch assembly (the
counterpart of the reference's C++ GoStateExtOffline replay,
go_state_ext.h:259).  The library is built at first use with the host C
compiler; a failed build raises.  `replay_to_snapshots_ref` is the plain
Python version of the same function, for the tests.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from elf_tpu_torch import _build

_lib = None
_lib_lock = threading.Lock()


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("replayer")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.replay_game_ex.restype = ctypes.c_int
            lib.replay_game_ex.argtypes = [
                ctypes.c_int, i32, ctypes.c_int, ctypes.c_int,
                i32, ctypes.c_int, i32, ctypes.c_int,
                np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            ]
            _lib = lib
    return _lib


def replay_to_snapshots(moves, size: int, first_player: int = 1,
                        setup_black=(), setup_white=()) -> np.ndarray:
    """[n_moves, size*size] int8 boards after each move (pass = n2).

    `first_player` (1 black / 2 white) and the setup stones serve handicap
    records, whose colors do not start black-on-even-ply from an empty
    board."""
    mv = np.ascontiguousarray(np.asarray(moves, np.int32))
    sb = np.ascontiguousarray(np.asarray(setup_black, np.int32))
    sw = np.ascontiguousarray(np.asarray(setup_white, np.int32))
    out = np.zeros((len(mv), size * size), np.int8)
    if len(mv) == 0:
        return out
    rc = _get_lib().replay_game_ex(
        size, mv, len(mv), int(first_player), sb, len(sb), sw, len(sw), out)
    if rc != 0:
        raise ValueError("replay_to_snapshots: bad size, player, stone or "
                         "move in the record")
    return out


def replay_to_snapshots_ref(moves, size: int, first_player: int = 1,
                            setup_black=(), setup_white=()) -> np.ndarray:
    """Plain Python version of `replay_to_snapshots`: placement, capture
    of adjacent opponent chains without liberties, then the mover's own
    chain if it has none; no legality checks."""
    n2 = size * size
    board = [0] * n2
    for p in setup_black:
        board[int(p)] = 1
    for p in setup_white:
        board[int(p)] = 2

    def neighbors(p):
        r, c = divmod(p, size)
        if r > 0:
            yield p - size
        if r < size - 1:
            yield p + size
        if c > 0:
            yield p - 1
        if c < size - 1:
            yield p + 1

    def remove_if_dead(start):
        color = board[start]
        chain, stack = {start}, [start]
        while stack:
            for q in neighbors(stack.pop()):
                if board[q] == 0:
                    return
                if board[q] == color and q not in chain:
                    chain.add(q)
                    stack.append(q)
        for q in chain:
            board[q] = 0

    out = np.zeros((len(moves), n2), np.int8)
    for k, a in enumerate(moves):
        a = int(a)
        color = first_player if k % 2 == 0 else 3 - first_player
        if a < n2:
            board[a] = color
            for q in neighbors(a):
                if board[q] == 3 - color:
                    remove_if_dead(q)
            remove_if_dead(a)
        out[k] = board
    return out
