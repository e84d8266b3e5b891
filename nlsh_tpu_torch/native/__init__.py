"""Native host kernels over ctypes: code packing, the CSR table build and
the HNSW baseline's graph.

Port of :mod:`nlsh_tpu.native`'s ctypes path.  Two C++ sources with no
framework in them (``nlsh_native.cpp``: ``pack_codes``, ``pack_dedupe``,
``build_csr``; ``hnsw.cpp``: the HNSW graph) are compiled on first use
with ``g++ -O3 -shared -fPIC -std=c++17``, the JAX package's flags (no
``-march=native``, no ``-ffast-math``, so distances and graphs are those
of the JAX package's build), into ``build/nlsh_tpu_torch/`` beside the
package, as one library named by a hash of its sources, flags and
compiler.  The JAX package's XLA FFI path (``pack_dedupe_ffi``,
``build_csr_ffi``) belongs to JAX alone and is not ported.

There is no silent fallback: a failed build raises with the compiler's
output.  The numpy versions stay beside the wrappers as ``*_plain``
functions, the reference the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from nlsh_tpu_torch.ops.cuda.build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
SOURCES = ("nlsh_native.cpp", "hnsw.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# entry point -> (argtypes, restype)
_ENTRY_POINTS = {
    "nlsh_pack_codes": ([_P, _I64, _I64, _P], None),
    "nlsh_pack_dedupe": ([_P, _I64, _I64, _I64, _P, _P], None),
    "nlsh_build_csr": ([_P, _I64, _I64, _P, _P, _P], None),
    # dim, space (0 cosine, 1 l2), max_elements, M, ef_construction, seed
    "nlsh_hnsw_create": ([_I32, _I32, _I64, _I32, _I32, ctypes.c_uint64], _P),
    "nlsh_hnsw_free": ([_P], None),
    "nlsh_hnsw_add": ([_P, _P, _I64], _I64),
    "nlsh_hnsw_count": ([_P], _I64),
    # handle, queries, nq, k, ef, out ids, out dists, out counts
    "nlsh_hnsw_search": ([_P, _P, _I64, _I32, _I32, _P, _P, _P], None),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path(build_dir: Path | None = None,
                 cxx: str | None = None) -> Path:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((_DIR / s).read_bytes())
    h.update(" ".join((cxx or _cxx(),) + CXX_FLAGS).encode())
    name = f"libnlsh_native_{h.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir: Path | None = None, cxx: str | None = None) -> Path:
    """Compile the library unless one of the same hash exists; returns
    its path.  Raises ``RuntimeError`` with the compiler's output when
    the build fails."""
    cxx = cxx or _cxx()
    out = library_path(build_dir, cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, *(str(_DIR / s) for s in SOURCES), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") \
                from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The library, built if needed, with its entry points' types set.
    Its own ``ctypes.CDLL`` handle (``RTLD_LOCAL``), so the JAX
    package's library of the same symbols can be loaded beside it."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ---------------------------------------------------------------------------
# packing and the CSR build (numpy in, numpy out)
# ---------------------------------------------------------------------------

def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack ``(..., bits)`` {0,1} int32 codes into ``(...,)`` int32 ids,
    MSB-first."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    bits = codes.shape[-1]
    flat = codes.reshape(-1, bits)
    out = np.empty((flat.shape[0],), dtype=np.int32)
    load_library().nlsh_pack_codes(_ptr(flat), flat.shape[0], bits, _ptr(out))
    return out.reshape(codes.shape[:-1])


def hash_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack and dedupe ``(n, p, bits)`` codes: ``(ids (n, p) int32 sorted
    per row, valid (n, p) bool)``, ``valid`` False on repeats, as
    :func:`nlsh_tpu_torch.ops.packing.hash_codes`."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n, p, bits = codes.shape
    ids = np.empty((n, p), dtype=np.int32)
    valid = np.empty((n, p), dtype=np.uint8)
    load_library().nlsh_pack_dedupe(_ptr(codes), n, p, bits, _ptr(ids),
                                    _ptr(valid))
    return ids, valid.astype(bool)


def build_csr(bucket_ids: np.ndarray, n_buckets: int):
    """Host CSR table of per-row bucket ids: ``(row_ids, starts, counts)``
    int32, as :func:`nlsh_tpu_torch.index.bucket_table.build_bucket_table`;
    ids outside ``[0, n_buckets)`` count in no bucket and sort last."""
    bucket_ids = np.ascontiguousarray(bucket_ids, dtype=np.int32)
    n = bucket_ids.shape[0]
    row_ids = np.empty((n,), dtype=np.int32)
    starts = np.empty((n_buckets,), dtype=np.int32)
    counts = np.empty((n_buckets,), dtype=np.int32)
    load_library().nlsh_build_csr(_ptr(bucket_ids), n, n_buckets,
                                  _ptr(row_ids), _ptr(starts), _ptr(counts))
    return row_ids, starts, counts


def pack_codes_plain(codes: np.ndarray) -> np.ndarray:
    """Numpy :func:`pack_codes`."""
    codes = np.asarray(codes, dtype=np.int32)
    bits = codes.shape[-1]
    w = (2 ** np.arange(bits - 1, -1, -1, dtype=np.int64)).astype(np.int32)
    return (codes * w).sum(-1).astype(np.int32)


def hash_codes_plain(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy :func:`hash_codes`."""
    ids = np.sort(pack_codes_plain(codes), axis=-1)
    valid = np.concatenate(
        [np.ones((ids.shape[0], 1), bool), ids[:, 1:] != ids[:, :-1]], axis=1)
    return ids, valid


def build_csr_plain(bucket_ids: np.ndarray, n_buckets: int):
    """Numpy :func:`build_csr`."""
    bucket_ids = np.asarray(bucket_ids, dtype=np.int32)
    in_range = (bucket_ids >= 0) & (bucket_ids < n_buckets)
    counts = np.bincount(bucket_ids[in_range],
                         minlength=n_buckets).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    keys = np.where(in_range, bucket_ids, n_buckets)
    return np.argsort(keys, kind="stable").astype(np.int32), starts, counts


# ---------------------------------------------------------------------------
# the HNSW graph (hnsw.cpp), with hnswlib's interface
# ---------------------------------------------------------------------------

class NativeHNSW:
    """The HNSW graph of ``hnsw.cpp`` behind the part of hnswlib's
    interface the baseline uses: ``init_index`` / ``set_ef`` /
    ``add_items`` / ``get_current_count`` / ``knn_query``.  ``knn_query``
    returns ``(ids, dists, counts)``: ``counts`` are each query's
    distance evaluations (``hnsw.cpp``'s ``visit_count``), the
    ``query_size`` of the baseline.  External labels map through an
    internal dense id space (insertion order), as hnswlib's do."""

    def __init__(self, space: str, dim: int):
        if space not in ("cosine", "l2"):
            raise ValueError(f"unknown space {space!r}")
        self.space = space
        self.dim = dim
        self._lib = None  # the library frees the graph, so hold it
        self._h = None
        self._labels: np.ndarray | None = None
        self._n = 0
        self.ef = 10

    def init_index(self, max_elements: int, M: int = 10,
                   ef_construction: int = 500, seed: int = 100):
        self._lib = load_library()
        self._free()  # re-init drops the old graph and its labels
        self._n = 0
        self.ef = 10  # as hnswlib: init_index resets ef to its default
        self._h = self._lib.nlsh_hnsw_create(
            self.dim, 0 if self.space == "cosine" else 1,
            int(max_elements), int(M), int(ef_construction), int(seed))
        if self._h is None:  # the C side refuses what uint32 ids can't hold
            raise ValueError(
                f"max_elements must be in [1, 2**32 - 1), got {max_elements}")
        self._labels = np.empty(int(max_elements), dtype=np.int64)

    def set_ef(self, ef: int):
        self.ef = int(ef)

    def _check_rows(self, x, what: str) -> np.ndarray:
        if self._h is None:
            raise RuntimeError("init_index first")
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) {what}, got {x.shape}")
        return x

    def add_items(self, data, labels=None):
        data = self._check_rows(data, "data")
        n = data.shape[0]
        if labels is None:
            labels = np.arange(self._n, self._n + n, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        if labels.shape != (n,):
            raise ValueError(f"expected {n} labels, got {labels.shape}")
        new_n = self._lib.nlsh_hnsw_add(self._h, _ptr(data), n)
        if new_n < 0:
            raise RuntimeError("index full (max_elements exceeded)")
        self._labels[self._n:self._n + n] = labels
        self._n = int(new_n)

    def get_current_count(self) -> int:
        return self._n

    def knn_query(self, queries, k: int = 10):
        queries = self._check_rows(queries, "queries")
        nq = queries.shape[0]
        ids = np.empty((nq, k), dtype=np.int64)
        dists = np.empty((nq, k), dtype=np.float32)
        counts = np.empty((nq,), dtype=np.int64)
        self._lib.nlsh_hnsw_search(self._h, _ptr(queries), nq, int(k),
                                   int(self.ef), _ptr(ids), _ptr(dists),
                                   _ptr(counts))
        found = ids >= 0
        ids[found] = self._labels[ids[found]]
        return ids, dists, counts

    def _free(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.nlsh_hnsw_free(h)

    def __del__(self):
        self._free()
