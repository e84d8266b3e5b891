"""The port's native host library (``nlsh_tpu_torch.native``, ctypes)
against the JAX package's (``nlsh_tpu.native``) and against the port's
own torch ops, on seeded codes drawn by hypothesis: ``pack_codes``,
``hash_codes`` and ``build_csr`` bit for bit, the out-of-range sentinel
included; the numpy ``*_plain`` versions equal to the library; a failed
build raises with the compiler's output instead of falling back; the two
libraries are separate files loaded side by side, and the port's
sources hold no XLA header."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nlsh_tpu import native as jnative
from nlsh_tpu_torch import native
from nlsh_tpu_torch.index.bucket_table import build_bucket_table
from nlsh_tpu_torch.ops import packing

SETTINGS = settings(max_examples=25, deadline=None, database=None)


@st.composite
def codes(draw):
    n = draw(st.integers(1, 40))
    p = draw(st.integers(1, 12))
    bits = draw(st.integers(1, 30))
    seed = draw(st.integers(0, 2**32 - 1))
    return np.random.default_rng(seed).integers(0, 2, (n, p, bits),
                                                dtype=np.int32)


@st.composite
def bucket_ids(draw):
    n_buckets = draw(st.integers(1, 64))
    n = draw(st.integers(0, 500))
    seed = draw(st.integers(0, 2**32 - 1))
    # a few ids out of range on either side: the deleted-row sentinel
    ids = np.random.default_rng(seed).integers(-2, n_buckets + 2, n)
    return ids.astype(np.int32), n_buckets


@SETTINGS
@given(codes())
def test_pack_codes(c):
    got = native.pack_codes(c)
    assert got.dtype == np.int32 and got.shape == c.shape[:-1]
    np.testing.assert_array_equal(got, jnative.pack_codes(c))
    np.testing.assert_array_equal(got, native.pack_codes_plain(c))
    np.testing.assert_array_equal(
        got, packing.pack_bits(torch.from_numpy(c)).numpy())


@SETTINGS
@given(codes())
def test_hash_codes(c):
    ids, valid = native.hash_codes(c)
    assert ids.dtype == np.int32 and valid.dtype == bool
    for want in (jnative.hash_codes(c), native.hash_codes_plain(c),
                 [t.numpy() for t in packing.hash_codes(torch.from_numpy(c))]):
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(valid, want[1])


@SETTINGS
@given(bucket_ids())
def test_build_csr(case):
    ids, n_buckets = case
    got = native.build_csr(ids, n_buckets)
    for want in (jnative.build_csr(ids, n_buckets),
                 native.build_csr_plain(ids, n_buckets)):
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    # the torch build sorts rows by their raw ids (as the JAX package's
    # jitted build does), so it agrees where every out-of-range id is the
    # sentinel n_buckets, which sorts last
    sentinel = np.where((ids >= 0) & (ids < n_buckets), ids,
                        n_buckets).astype(np.int32)
    table = build_bucket_table(torch.from_numpy(sentinel), n_buckets)
    for g, w in zip(native.build_csr(sentinel, n_buckets), table):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got[1:], [t.numpy() for t in table[1:]])


def test_build_csr_drops_the_sentinel_and_sorts_it_last():
    row_ids, starts, counts = native.build_csr(
        np.array([3, 8, 0, 8, 3], np.int32), 8)   # 8 = n_buckets: dropped
    assert counts.sum() == 3 and counts[3] == 2 and counts[0] == 1
    assert row_ids.tolist() == [2, 0, 4, 1, 3]
    assert starts[3] == 1 and starts[4] == 3


def test_a_failed_build_raises_with_the_compiler_s_output(tmp_path,
                                                           monkeypatch):
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(tmp_path, cxx="false")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(tmp_path, cxx=str(tmp_path / "no-such-compiler"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (str(bad),))
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(tmp_path)
    assert not list(tmp_path.glob("*.so"))
    # the wrappers raise too: no numpy fallback
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.pack_codes(np.zeros((2, 3), np.int32))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.NativeHNSW("l2", 4).init_index(8)


def test_the_port_s_library_is_its_own_file(tmp_path):
    path = native.build()
    assert path.parent.name == "nlsh_tpu_torch" and path.parent.parent.name \
        == "build"
    assert path.name.startswith("libnlsh_native_")
    jnative._get_lib()
    theirs = Path(jnative._LIB_DIR) / "libnlsh_native.so"
    assert path.resolve() != theirs.resolve()
    # both loaded in this process, each through its own handle
    assert isinstance(native.load_library(), ctypes.CDLL)
    # the name follows the sources, flags and compiler
    assert native.library_path(tmp_path, cxx="g++") != \
        native.library_path(tmp_path, cxx="clang++")
    assert native.library_path(tmp_path) == tmp_path / path.name


def test_the_sources_hold_no_xla():
    here = Path(native.__file__).parent
    for name in native.SOURCES:
        text = (here / name).read_text()
        assert '#include "xla' not in text and "ffi::" not in text
    assert (here / "hnsw.cpp").read_bytes() == \
        (Path(jnative.__file__).parent / "hnsw.cpp").read_bytes()
