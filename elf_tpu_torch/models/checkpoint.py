"""Checkpoints in the JAX package's flax-msgpack format, both ways
(counterpart of `elf_tpu/training/trainer.py:185-311`): either package
loads the other's files.

A self-contained msgpack decoder and encoder, so the port needs neither
`msgpack` nor `flax`.  flax stores each array as msgpack extension type 1
holding the packed triple (shape, dtype name, C-order bytes); `bfloat16`
arrays are read as uint16 and viewed as `torch.bfloat16`.  Arrays come
back as CPU tensors inside the same nested dicts flax restores.

A file holds `params`, `batch_stats`, `opt_state` (left out of a
params-only export) and `step`, in the trees the JAX trainer writes: the
flax layouts of `models/resnet.py` and the optax chain's state dict that
`training/trainer.py` `Optimizer` keeps.

A net with no JAX twin (`models/nbt.py`) is saved in the same format,
its trees (parameters, BN statistics, each optimizer slot) flat dicts of
CPU tensors under the net's own state-dict names.
"""

from __future__ import annotations

import copy
import os
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

from elf_tpu_torch.models.resnet import (
    ModelConfig,
    flax_to_tensors,
    load_flax_trees,
    tensors_to_flax,
)

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


# --------------------------------------------------------------------------
# encoder (the subset of msgpack that flax's `msgpack_serialize` emits)
# --------------------------------------------------------------------------

def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    for lim, code, fmt in ((0xFF, 0xCC, "B"), (0xFFFF, 0xCD, "H"),
                           (0xFFFFFFFF, 0xCE, "I"), (2 ** 64 - 1, 0xCF, "Q")):
        if 0 <= n <= lim:
            return struct.pack(">B" + fmt, code, n)
    for lim, code, fmt in ((0x80, 0xD0, "b"), (0x8000, 0xD1, "h"),
                           (0x80000000, 0xD2, "i"), (2 ** 63, 0xD3, "q")):
        if -lim <= n < 0:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"integer out of msgpack range: {n}")


def _pack_head(n: int, fix: Optional[tuple], codes) -> bytes:
    """Length header: the fix form when it fits, else the 8/16/32-bit one."""
    if fix is not None and n <= fix[1]:
        return struct.pack("B", fix[0] | n)
    for code, fmt, lim in codes:
        if n <= lim:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError("object too large for msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = struct.pack("B", fixext[n])
    else:
        head = _pack_head(n, None, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                                    (0xC9, "I", 0xFFFFFFFF)))
    return head + struct.pack("b", code) + payload


def _pack_array(a) -> bytes:
    """(shape, dtype name, C-order bytes), flax's `_ndarray_to_bytes`."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            name, buf = "bfloat16", a.view(torch.int16).numpy().tobytes()
        else:
            name, buf = a.numpy().dtype.name, a.numpy().tobytes()
        shape = tuple(a.shape)
    else:
        a = np.asarray(a)
        name, buf, shape = a.dtype.name, a.tobytes("C"), a.shape
    if len(buf) > 2 ** 30:
        raise ValueError("chunked arrays (> 1 GiB leaves) are not supported")
    return _pack([list(shape), name, buf])


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return struct.pack(">Bd", 0xCB, obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return _pack_head(len(raw), (0xA0, 31), (
            (0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF),
        )) + raw
    if isinstance(obj, bytes):
        return _pack_head(len(obj), None, (
            (0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF),
        )) + obj
    if isinstance(obj, dict):
        head = _pack_head(len(obj), (0x80, 15), (
            (0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF)))
        # sorted keys, as flax writes them (its tree_map sorts dict keys)
        return head + b"".join(_pack(k) + _pack(obj[k]) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        head = _pack_head(len(obj), (0x90, 15), (
            (0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)))
        return head + b"".join(_pack(v) for v in obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return _pack_ext(_EXT_NDARRAY, _pack_array(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_array(obj))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dicts with tensor / numpy leaves -> the bytes flax's
    `msgpack_serialize` gives the same tree."""
    return _pack(tree)


# --------------------------------------------------------------------------
# checkpoints (ModelSaver parity: save-<step>.bin + latest symlink)
# --------------------------------------------------------------------------

_CKPT_RE = re.compile(r"save-(\d+)\.bin$")
_SLOTS = ("trace", "mu", "nu")     # optimizer slots shaped like the params


def read_checkpoint(path: str) -> dict:
    """The decoded payload of a checkpoint file (a directory stands for
    its `latest` link)."""
    if os.path.isdir(path):
        path = os.path.join(path, "latest")
    with open(os.path.realpath(path), "rb") as f:
        return msgpack_restore(f.read())


def _tree(cfg, named: dict, stats: bool = False) -> dict:
    """The file's tree of `named` (tensors under the net's names): flax's
    layouts for a net with a JAX twin (a `ModelConfig`), else flat."""
    if isinstance(cfg, ModelConfig):
        return tensors_to_flax(cfg, named, stats)
    return {k: v.detach().cpu().contiguous() for k, v in named.items()}


def _tensors(cfg, tree: dict) -> dict:
    """Inverse of `_tree` for the parameters and their optimizer slots."""
    return flax_to_tensors(cfg, tree) if isinstance(cfg, ModelConfig) else tree


def _load_trees(net, params: dict, batch_stats: dict) -> None:
    if isinstance(net.cfg, ModelConfig):
        load_flax_trees(net, params, batch_stats)
    else:
        net.load_state_dict({**params, **batch_stats})


def _model_trees(net, dtype: Optional[torch.dtype] = None):
    def cast(tree):
        if dtype is None:
            return tree
        return {k: cast(v) if isinstance(v, dict)
                else (v.to(dtype) if v.is_floating_point() else v)
                for k, v in tree.items()}

    params = _tree(net.cfg, dict(net.named_parameters()))
    stats = _tree(net.cfg, dict(net.named_buffers()), stats=True)
    return cast(params), cast(stats)


def _opt_tree(cfg, opt_state: dict) -> dict:
    return {
        k: _tree(cfg, v) if k in _SLOTS
        else _opt_tree(cfg, v) if isinstance(v, dict) else v
        for k, v in opt_state.items()
    }


def _write(path: str, payload: dict) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(path + ".tmp", path)


def save_checkpoint(directory: str, state, keep: int = 10) -> str:
    """Write the whole TrainState as `save-<step>.bin`, repoint `latest`
    and keep the last `keep` files."""
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    path = os.path.join(directory, f"save-{step}.bin")
    params, stats = _model_trees(state.net)
    _write(path, {
        "params": params,
        "batch_stats": stats,
        "opt_state": _opt_tree(state.net.cfg, state.opt_state),
        "step": step,
    })

    latest = os.path.join(directory, "latest")
    tmp_link = latest + ".tmp"
    try:
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(os.path.basename(path), tmp_link)
        os.replace(tmp_link, latest)
    except OSError:
        pass

    ckpts = sorted(
        (int(m.group(1)), os.path.join(directory, f))
        for f in os.listdir(directory)
        if (m := _CKPT_RE.search(f))
    )
    for _, old in ckpts[:-keep]:
        try:
            os.remove(old)
        except OSError:
            pass
    return path


def save_params_checkpoint(path: str, state,
                           dtype: torch.dtype = torch.bfloat16) -> str:
    """Params-only export: params and batch_stats downcast to `dtype` and
    the step, without optimizer state.  `load_checkpoint` restores it onto
    a template, whose optimizer starts fresh."""
    params, stats = _model_trees(state.net, dtype)
    _write(path, {"params": params, "batch_stats": stats,
                  "step": int(state.step)})
    return path


def _restore_opt(cfg, own: dict, tree: dict) -> None:
    for k, v in own.items():
        if k in _SLOTS:
            for name, t in _tensors(cfg, tree[k]).items():
                if t.shape != v[name].shape:
                    raise ValueError(
                        f"checkpoint shape mismatch at {k}/{name}: "
                        f"{tuple(t.shape)} vs {tuple(v[name].shape)}")
                v[name].copy_(t)
        elif isinstance(v, dict):
            _restore_opt(cfg, v, tree[k])
        else:
            v.copy_(tree[k])


def load_checkpoint(path: str, template=None):
    """Load a whole TrainState checkpoint or a params-only export.

    Without a `template`: (params, batch_stats, step), the flax trees as
    the file holds them.  With a template TrainState: a new state of the
    template's structure, device and dtypes (fp32 masters even from a bf16
    export), shapes checked; a params-only file keeps the template's
    optimizer state.  The template itself is left as it was."""
    payload = read_checkpoint(path)
    if template is None:
        return payload["params"], payload["batch_stats"], int(payload["step"])
    state = copy.deepcopy(template)
    _load_trees(state.net, payload["params"], payload["batch_stats"])
    if "opt_state" in payload:
        with torch.no_grad():
            _restore_opt(state.net.cfg, state.opt_state, payload["opt_state"])
    state.step = int(payload["step"])
    return state


def version_from_path(path: str) -> int:
    """The model version in `save-<step>.bin` (train.py:20), else -1."""
    m = _CKPT_RE.search(os.path.basename(os.path.realpath(path)))
    return int(m.group(1)) if m else -1
