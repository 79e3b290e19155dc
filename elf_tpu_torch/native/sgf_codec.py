"""ctypes wrapper of the C SGF / move-string codec (`csrc/sgf_codec.c`),
the port's copy of `elf_tpu/native/sgf_codec.py`.

The compact move-string codec (`coords2sgfstr` / `sgfstr2coords`,
reference sgf.h:87/:97) runs on the training server for every record it
receives, and the main-line parser backs bulk offline SGF loading: the
host-side hot paths the reference keeps in C++ (sgf/sgf.cc).

The library is built at first use with the host C compiler, and a failed
build raises: no path quietly takes Python in its place.  Where the C call
itself refuses its input (malformed text, or a buffer too small), the
functions keep the JAX wrapper's answers: the two move-string functions
give the Python codec's (`env/go/coords.py`), and `parse_sgf_main`
returns None, so that its callers take the Python SGF parser.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from elf_tpu_torch import _build
from elf_tpu_torch.env.go import coords

RESULT_CAP = 64         # bytes for RE[...], as in the JAX wrapper

_lib = None
_lib_lock = threading.Lock()


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("sgf_codec")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.moves_to_sgfstr.restype = ctypes.c_int
            lib.moves_to_sgfstr.argtypes = [
                ctypes.c_int, i32, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int,
            ]
            lib.sgfstr_to_moves.restype = ctypes.c_int
            lib.sgfstr_to_moves.argtypes = [
                ctypes.c_char_p, ctypes.c_int, i32, ctypes.c_int,
            ]
            lib.parse_sgf_main.restype = ctypes.c_int
            lib.parse_sgf_main.argtypes = [
                ctypes.c_char_p, i32, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int,
            ]
            _lib = lib
    return _lib


def moves_to_sgf_string(moves, size: int) -> str:
    """Compact move-list wire format "(;B[ab];W[cd];...)" (coords2sgfstr)."""
    lib = _get_lib()
    mv = np.ascontiguousarray(np.asarray(list(moves), np.int32))
    cap = 8 * len(mv) + 16
    buf = ctypes.create_string_buffer(cap)
    rc = lib.moves_to_sgfstr(size, mv, len(mv), buf, cap)
    if rc >= 0:
        return buf.value.decode("ascii")
    return coords.moves_to_sgf_string(mv, size)


def sgf_string_to_moves(s: str, size: int) -> List[int]:
    """Inverse of moves_to_sgf_string (sgfstr2coords)."""
    lib = _get_lib()
    cap = max(len(s) // 4 + 4, 8)
    out = np.zeros(cap, np.int32)
    rc = lib.sgfstr_to_moves(s.encode("ascii", "replace"), size, out, cap)
    if rc >= 0:
        return [int(x) for x in out[:rc]]
    return coords.sgf_string_to_moves(s, size)


def parse_sgf_main(
    text: str, max_moves: int = 2048
) -> Optional[Tuple[List[int], int, float, int, str]]:
    """Main-line parse of a full SGF: (moves, size, komi, handicap, result).

    None when the text is malformed or holds more than `max_moves` moves:
    callers then take the Python parser (`sgf/sgf.py`)."""
    lib = _get_lib()
    out = np.zeros(max_moves, np.int32)
    size = ctypes.c_int(19)
    komi = ctypes.c_double(0.0)
    handicap = ctypes.c_int(0)
    result = ctypes.create_string_buffer(RESULT_CAP)
    rc = lib.parse_sgf_main(
        text.encode("utf-8", "replace"), out, max_moves,
        ctypes.byref(size), ctypes.byref(komi), ctypes.byref(handicap),
        result, RESULT_CAP,
    )
    if rc < 0:
        return None
    return (
        [int(x) for x in out[:rc]],
        int(size.value),
        float(komi.value),
        int(handicap.value),
        result.value.decode("ascii", "replace"),
    )
