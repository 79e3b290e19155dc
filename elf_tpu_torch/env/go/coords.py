"""Coordinate codecs between flat actions, GTP strings, and SGF strings.

A copy of `elf_tpu/env/go/coords.py`; counterpart of the reference codecs
(`src_cpp/elfgames/go/sgf/sgf.h:22` `str2coord` / `coord2str` /
`coord2str2`).  `moves_to_sgf_string` is the record wire codec here (the
JAX package calls a native C codec with the same bytes).

Internal representation: flat action p = row * size + col, row 0 = top (SGF
row 'a'), plus PASS == size*size.  GTP columns skip 'I'; GTP row 1 is the
*bottom* of the board.
"""

from __future__ import annotations

GTP_COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # no I
SGF_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def flat_to_gtp(p: int, size: int) -> str:
    if p < 0 or p >= size * size:
        return "pass"
    r, c = divmod(p, size)
    return f"{GTP_COLS[c]}{size - r}"


def gtp_to_flat(s: str, size: int) -> int:
    s = s.strip().upper()
    if s in ("PASS", ""):
        return size * size
    col = GTP_COLS.index(s[0])
    row = size - int(s[1:])
    if not (0 <= row < size and 0 <= col < size):
        raise ValueError(f"bad GTP coord {s}")
    return row * size + col


def flat_to_sgf(p: int, size: int) -> str:
    """SGF two-letter coord; pass encodes as '' (empty property)."""
    if p < 0 or p >= size * size:
        return ""
    r, c = divmod(p, size)
    return SGF_LETTERS[c] + SGF_LETTERS[r]


def sgf_to_flat(s: str, size: int) -> int:
    if s == "" or (len(s) == 2 and s == "tt" and size <= 19):
        return size * size  # pass ('tt' is the legacy pass encoding)
    c = SGF_LETTERS.index(s[0])
    r = SGF_LETTERS.index(s[1])
    return r * size + c


def moves_to_sgf_string(moves, size: int) -> str:
    """Compact move-list wire format (`coords2sgfstr`, sgf.h:87):
    "(;B[ab];W[cd];...)" with alternating colors and pass as "[]"."""
    parts = []
    for i, m in enumerate(moves):
        color = "B" if i % 2 == 0 else "W"
        parts.append(f";{color}[{flat_to_sgf(int(m), size)}]")
    return "(" + "".join(parts) + ")"


def sgf_string_to_moves(s: str, size: int):
    """Inverse of moves_to_sgf_string (`sgfstr2coords`, sgf.h:97)."""
    moves = []
    if not s.startswith("("):
        return moves
    i = 1
    while i < len(s) and s[i] == ";":
        j = s.find("[", i)
        if j < 0:
            break
        k = s.find("]", j)
        moves.append(sgf_to_flat(s[j + 1 : k], size))
        i = k + 1
    return moves
