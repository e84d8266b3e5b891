"""A reader of flax's msgpack parameter files: the standard library and
numpy only.

A frozen copy of the reader the program carries, kept here so that the
reference reads the committed params by itself.  Flax writes maps with
str keys, lists as maps keyed ``"0"``, ``"1"``, ..., and each array as
msgpack ext type 1 holding ``[shape, dtype name, raw bytes]`` (ext type
3 a numpy scalar in the same form, ext type 2 a complex ``[real,
imag]``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

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
