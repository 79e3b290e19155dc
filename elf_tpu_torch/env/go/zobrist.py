"""Zobrist hash tables for positional (super)ko detection.

A copy of `elf_tpu/env/go/zobrist.py` (the port imports nothing of the JAX
package), so both packages hash every position to the same bits.  The
reference hashing (`src_cpp/elfgames/go/base/board.cc` + `hash_num.h`)
uses one table of 64-bit constants; here two independent 32-bit tables
(lo / hi) give 64 bits of hash state.

Tables are generated deterministically from a fixed seed so hashes are
reproducible across processes and hosts.
"""

import numpy as np

_SEED = 0x5EED_60


def zobrist_tables(size: int):
    """Return (lo, hi) uint32 arrays of shape [size*size, 3].

    Index [p, color] with color in {1 black, 2 white}; column 0 is zeros so
    XOR with an "empty" color is a no-op.
    """
    rng = np.random.RandomState(_SEED + size)
    n2 = size * size
    lo = rng.randint(0, 2**32, size=(n2, 3), dtype=np.uint64).astype(np.uint32)
    hi = rng.randint(0, 2**32, size=(n2, 3), dtype=np.uint64).astype(np.uint32)
    lo[:, 0] = 0
    hi[:, 0] = 0
    return lo, hi
