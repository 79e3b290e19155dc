"""Reader for the JAX package's flax-msgpack checkpoints (load side of
`elf_tpu/training/trainer.py:231-290`).

A self-contained msgpack decoder, so the port needs neither `msgpack` nor
`flax`.  flax stores each array as msgpack extension type 1 holding the
packed triple (shape, dtype name, C-order bytes); `bfloat16` arrays are
read as uint16 and viewed as `torch.bfloat16`.  Arrays come back as CPU
tensors inside the same nested dicts flax restores.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array(shape, dtype_name: str, buf: bytes) -> torch.Tensor:
    if dtype_name == "bfloat16":
        a = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    a = np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(a.copy())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        scalars = {
            0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked arrays (> 1 GiB leaves) are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = _Reader(self.take(n)).obj()
        if code == _EXT_NDARRAY:
            shape, dtype_name, buf = payload
            return _array(tuple(shape), dtype_name, buf)
        if code == _EXT_NPSCALAR:
            dtype_name, buf = payload
            return _array((), dtype_name, buf)
        raise ValueError(f"unsupported msgpack extension type {code}")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax `msgpack_serialize` output into nested dicts of tensors."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_checkpoint(path: str) -> Tuple[dict, dict, int]:
    """(params, batch_stats, step) of a params export or full TrainState
    checkpoint written by the JAX trainer."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return payload["params"], payload["batch_stats"], int(payload["step"])
