"""Read the JAX package's parameter files into the port's modules.

Two parts:

* :func:`msgpack_restore` / :func:`read_msgpack` — a reader of flax's
  msgpack format that needs only the standard library and numpy (no
  ``msgpack``, no ``flax``).  Flax writes maps with str keys, lists as
  maps keyed ``"0"``, ``"1"``, …, and each array as msgpack ext type 1
  holding the array ``[shape, dtype name, raw bytes]`` (ext type 3 is a
  numpy scalar in the same form, ext type 2 a complex ``[real, imag]``).  The result equals
  ``flax.serialization.msgpack_restore`` on the same bytes.
* :func:`params_from_jax` — loads such a tree (numpy arrays) into a
  hashing module.  JAX keeps ``w`` as ``(fan_in, fan_out)`` and
  ``nn.Linear`` as ``(out, in)``, so it transposes.
  :func:`stacked_params_from_jax` does the same for an ensemble's
  stacked tree (every leaf with a leading ``(L, ...)`` table axis), one
  module per table.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

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
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {
            0xC0: None, 0xC2: False, 0xC3: True,
        }
        if b in fixed:
            return fixed[b]
        sized = {  # head byte -> (struct format of the length, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        numbers = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = _Reader(bytes(self.take(n)))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = payload.obj()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = payload.obj()
            return complex(real, imag)
        raise ValueError(f"unsupported flax msgpack ext type {code}")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-serialised msgpack bytes into nested dicts of numpy
    arrays (lists stay maps keyed ``"0"``, ``"1"``, …, as in flax)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read_msgpack(path) -> Any:
    return msgpack_restore(Path(path).read_bytes())


def _layer_list(tree) -> list:
    """Flax stores a list as a map keyed "0", "1", …; accept either."""
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def params_from_jax(hashing: nn.Module, tree: dict) -> nn.Module:
    """Load JAX ``MultivariateBernoulli`` params (``{"encoder": {"layers":
    [...]}, "out": {...}}``, numpy leaves) into ``hashing`` in place,
    transposing each ``w``.  Raises on any missing, extra or mis-shaped
    entry."""
    state = {}

    def put(prefix: str, layer: dict):
        state[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
        if "b" in layer:
            state[f"{prefix}.bias"] = torch.from_numpy(
                np.array(layer["b"], np.float32))

    for i, layer in enumerate(_layer_list(tree["encoder"]["layers"])):
        put(f"encoder.layers.{i}", layer)
    put("out", tree["out"])
    own = hashing.state_dict()
    for name, value in state.items():
        if name in own and own[name].shape != value.shape:
            raise ValueError(
                f"{name}: checkpoint shape {tuple(value.shape)} != "
                f"module shape {tuple(own[name].shape)}")
    hashing.load_state_dict(state, strict=True)
    return hashing


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _table_slice(tree, t: int):
    if isinstance(tree, dict):
        return {key: _table_slice(v, t) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_table_slice(v, t) for v in tree]
    return tree[t]


def stacked_params_from_jax(make_hashing: Callable[[], nn.Module],
                            tree: dict) -> list[nn.Module]:
    """Load an ensemble's stacked params (the JAX package's
    ``init_multi_table`` / multi-table trainer output: every leaf has a
    leading table axis ``L``) into ``L`` fresh modules from
    ``make_hashing()``, one :func:`params_from_jax` per table.  Raises if
    the leaves disagree on ``L``."""
    sizes = {np.shape(leaf)[0] if np.ndim(leaf) else None
             for leaf in _leaves(tree)}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"stacked params disagree on the table axis: {sizes}")
    (n_tables,) = sizes
    return [params_from_jax(make_hashing(), _table_slice(tree, t))
            for t in range(n_tables)]
