"""The JAX package's parameter files and model artifacts, read and written.

Four parts:

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
  module per table; :func:`params_to_jax` and
  :func:`stacked_params_to_jax` go the other way.
* :func:`msgpack_serialize` / :func:`write_msgpack` — the matching
  writer: the bytes ``flax.serialization.to_bytes`` gives for the same
  tree of numpy arrays.
* :func:`save_model` / :func:`load_model` — the inference artifact of
  :mod:`nlsh_tpu.utils.checkpoint`: ``<base>.json`` (the architecture,
  :func:`hashing_config`) next to ``<base>.msgpack`` (the params), so an
  artifact written by either package loads in the other.
"""

from __future__ import annotations

import json
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


# --- the writer: msgpack as ``msgpack.packb(..., use_bin_type=True)`` packs
# it (always the shortest head), which is what flax calls ---

def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    for limit, head, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                             (0xFFFFFFFF, 0xCE, ">I"),
                             (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
        if 0 <= n <= limit:
            return bytes([head]) + struct.pack(fmt, n)
    for limit, head, fmt in ((0x80, 0xD0, ">b"), (0x8000, 0xD1, ">h"),
                             (0x80000000, 0xD2, ">i"),
                             (0x8000000000000000, 0xD3, ">q")):
        if -limit <= n < 0:
            return bytes([head]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_head(n: int, fix: tuple[int, int] | None, sized: tuple) -> bytes:
    """The head of a str, bin, array, map or ext of length ``n``: the
    one-byte ``fix`` form ``(base, max)`` where it fits, else the first
    ``(head byte, struct format)`` of ``sized`` that holds ``n``."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for head, fmt in sized:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([head]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + n.bit_length() - 1])
    else:
        head = _pack_head(n, None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    return head + struct.pack(">b", code) + payload


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if isinstance(obj, (bool, np.bool_)):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_head(len(raw), (0xA0, 31), ((0xD9, ">B"), (0xDA, ">H"),
                                                 (0xDB, ">I"))) + raw
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _pack_head(len(obj), None, ((0xC4, ">B"), (0xC5, ">H"),
                                           (0xC6, ">I"))) + bytes(obj)
    if isinstance(obj, dict):
        out = _pack_head(len(obj), (0x80, 15), ((0xDE, ">H"), (0xDF, ">I")))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise ValueError(f"flax state dicts have str keys, got {key!r}")
            out += _pack(key) + _pack(value)
        return out
    if isinstance(obj, (list, tuple)):
        # flax's state dict of a list: a map keyed "0", "1", ...
        return _pack({str(i): v for i, v in enumerate(obj)})
    if torch.is_tensor(obj):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError("object arrays cannot be serialised")
        shape = b"".join(_pack_int(int(n)) for n in arr.shape)
        payload = (_pack_head(3, (0x90, 15), ()) +
                   _pack_head(arr.ndim, (0x90, 15), ((0xDC, ">H"),)) + shape +
                   _pack(arr.dtype.name) + _pack(arr.tobytes("C")))
        return _pack_ext(_EXT_NDARRAY if isinstance(obj, np.ndarray)
                         else _EXT_NPSCALAR, payload)
    raise ValueError(f"cannot serialise {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dicts (str keys) and lists of numpy arrays or tensors as
    flax's msgpack bytes: what ``flax.serialization.to_bytes`` gives for
    the same tree, and what :func:`msgpack_restore` reads back."""
    return _pack(tree)


def write_msgpack(path, tree: Any) -> None:
    Path(path).write_bytes(msgpack_serialize(tree))


def _layer_list(tree) -> list:
    """Flax stores a list as a map keyed "0", "1", …; accept either."""
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def params_from_jax(hashing: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX hashing's params (``{"encoder": {"layers": [...]},
    "out": {...}}``, numpy leaves; the same tree for every head type)
    into ``hashing`` in place, transposing each ``w``.  Raises on any
    missing, extra or mis-shaped entry."""
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


def params_to_jax(hashing: nn.Module) -> dict:
    """The JAX package's param tree of ``hashing`` (numpy f32 leaves,
    ``w`` as ``(fan_in, fan_out)``): the inverse of
    :func:`params_from_jax`."""

    def layer(linear: nn.Linear) -> dict:
        # keys in sorted order, as a jax tree map leaves them: the bytes
        # of the file are then the JAX package's for the same params
        out = {}
        if linear.bias is not None:
            out["b"] = linear.bias.detach().cpu().numpy().astype(np.float32)
        out["w"] = np.ascontiguousarray(
            linear.weight.detach().cpu().numpy().T, np.float32)
        return out

    return {"encoder": {"layers": [layer(m) for m in hashing.encoder.layers]},
            "out": layer(hashing.out)}


def stacked_params_to_jax(hashings: list[nn.Module]) -> dict:
    """The stacked tree (a leading table axis on every leaf) of an
    ensemble's modules: the inverse of :func:`stacked_params_from_jax`."""
    trees = [params_to_jax(h) for h in hashings]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {key: stack([p[key] for p in parts]) for key in parts[0]}
        if isinstance(parts[0], list):
            return [stack(list(col)) for col in zip(*parts)]
        return np.stack(parts)

    return stack(trees)


# ---------------------------------------------------------------------------
# the inference artifact: architecture (json) + params (msgpack)
# ---------------------------------------------------------------------------

# the JAX package's default code distance of each head: written into the
# JSON so its loader builds what it would have built; the port does not
# use it until training is ported
_DEFAULT_DISTANCE = {"MultivariateBernoulli": "L2", "Categorical":
                     "CategoricalL2", "ProductQuantization": "CategoricalL2"}


def hashing_config(hashing: nn.Module, code_distance: str | None = None) -> dict:
    """A hashing module's architecture as plain JSON, in the JAX
    package's schema.  ``code_distance`` is written as given (default:
    the head's default name)."""
    from nlsh_tpu_torch.models.encoders import MLPEncoder
    from nlsh_tpu_torch.models.hashings import (
        MultivariateBernoulli,
        ProductQuantization,
    )

    enc = hashing.encoder
    enc_cfg = {"type": type(enc).__name__, "input_dim": enc.input_dim,
               "hidden_dims": list(enc.hidden_dims)}
    if isinstance(enc, MLPEncoder):
        enc_cfg.update(with_bias=enc.with_bias,
                       with_layernorm=enc.with_layernorm)
    else:
        enc_cfg.update(w0=enc.w0, w0_initial=enc.w0_initial)
    kind = type(hashing).__name__
    if code_distance is None:
        code_distance = "Cosine" if getattr(hashing, "tanh_output", False) \
            else _DEFAULT_DISTANCE[kind]
    cfg = {"type": kind, "hash_size": hashing.hash_size, "encoder": enc_cfg,
           "code_distance": code_distance}
    if isinstance(hashing, MultivariateBernoulli):
        cfg["tanh_output"] = hashing.tanh_output
    if isinstance(hashing, ProductQuantization):
        cfg["n_bands"] = hashing.n_bands
        cfg["bits_per_band"] = hashing.bits_per_band
    return cfg


def build_hashing(cfg: dict) -> nn.Module:
    """Rebuild a hashing module (fresh weights) from
    :func:`hashing_config` output; ``code_distance`` is ignored."""
    from nlsh_tpu_torch.models import encoders, hashings

    ec = dict(cfg["encoder"])
    enc_cls = {"MLPEncoder": encoders.MLPEncoder,
               "SirenEncoder": encoders.SirenEncoder}[ec.pop("type")]
    ec["hidden_dims"] = tuple(ec["hidden_dims"])
    enc = enc_cls(**ec)
    if cfg["type"] == "ProductQuantization":
        return hashings.ProductQuantization(enc, cfg["n_bands"],
                                            cfg["bits_per_band"])
    if cfg["type"] == "MultivariateBernoulli":
        return hashings.MultivariateBernoulli(
            enc, cfg["hash_size"], tanh_output=cfg.get("tanh_output", False))
    if cfg["type"] == "Categorical":
        return hashings.Categorical(enc, cfg["hash_size"])
    raise ValueError(f"unknown hashing type {cfg['type']!r}")


def _artifact_base(base_path) -> str:
    base = str(base_path)
    for suffix in (".json", ".msgpack"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base


def save_model(base_path, hashing, code_distance: str | None = None) -> None:
    """Export ``<base>.json`` + ``<base>.msgpack``.  ``hashing`` is one
    module, or a list of modules of one architecture (an ensemble): the
    params are then stacked on a leading table axis and the JSON carries
    ``n_tables``.  The suffixes are appended, never substituted: base
    names may contain dots (``run_300_0.6528``)."""
    base = Path(base_path)
    base.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(hashing, (list, tuple)):
        cfg = hashing_config(hashing[0], code_distance)
        cfg["n_tables"] = len(hashing)
        tree = stacked_params_to_jax(list(hashing))
    else:
        cfg = hashing_config(hashing, code_distance)
        tree = params_to_jax(hashing)
    Path(str(base) + ".json").write_text(json.dumps(cfg, indent=2))
    write_msgpack(str(base) + ".msgpack", tree)


def model_config(base_path) -> dict:
    """The JSON half of an artifact."""
    return json.loads(Path(_artifact_base(base_path) + ".json").read_text())


def load_model(base_path, *, device):
    """Load an inference artifact onto ``device``: one hashing module,
    or a list of ``n_tables`` modules when the JSON has ``n_tables``."""
    base = _artifact_base(base_path)
    cfg = model_config(base)
    tree = read_msgpack(base + ".msgpack")
    if cfg.get("n_tables"):
        hashings = stacked_params_from_jax(lambda: build_hashing(cfg), tree)
        if len(hashings) != cfg["n_tables"]:
            raise ValueError(f"the artifact says {cfg['n_tables']} tables, "
                             f"its params hold {len(hashings)}")
        return [h.to(device).eval() for h in hashings]
    return params_from_jax(build_hashing(cfg), tree).to(device).eval()
