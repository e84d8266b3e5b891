"""The layer metrics (``hash_ms``, ``prep_ms``, ``score_ms``,
``merge_ms``, ``launch_ms``, ``guard_fallback_share``) on hand-made
chrome traces: marks at known times read the kernel time between them, a
trace without the program's marks and spans reads None."""

import json
from types import SimpleNamespace

import pytest

from portbench.manifest import Manifest
from portbench.tests import toy
from portbench.trace import Trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def _batch(t, bound=False):
    """One serve of 100 us from ``t``: its marks (1 us each), its kernels
    and its host spans."""
    k = "kernel"
    out = [
        _x("portbench.batch", "user_annotation", t, 100),
        _x("nlsh.query", "user_annotation", t, 10),
        _x("nlsh.replay", "user_annotation", t + 2, 6 if bound else 4),
        _x("cudaGraphLaunch", "cuda_runtime", t + 3, 2),
        _x("nlsh_span_hash", k, t + 10, 1),
        _x("gemm", k, t + 11, 5),
        _x("nlsh_span_prep", k, t + 20, 1),
        _x("sort", k, t + 21, 8),
        _x("cummax", k, t + 30, 4),
        _x("nlsh_span_score", k, t + 40, 1),
        _x("grouped_topk_kernel", k, t + 41, 20),
        _x("nlsh_span_merge", k, t + 70, 1),
        _x("Memcpy DtoD", "gpu_memcpy", t + 71, 3),     # a copy: left out
        _x("topk", k, t + 75, 6),
        _x("nlsh_span_end", k, t + 85, 1),
        _x("clone", k, t + 87, 2),                       # after the end
    ]
    if bound:
        out.append(_x("nlsh_span_bound", k, t + 35, 1))
    return out


def _ctx(tmp_path, events, n_batches):
    events = [_x("portbench.window", "user_annotation", 0, 1000), *events]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=Trace(str(path)), n_batches=n_batches)


def _read(name, ctx):
    return Manifest(toy.REPO).metric_module(name).read(ctx)


def test_layer_metrics_read_the_marks(tmp_path):
    ctx = _ctx(tmp_path, _batch(100) + _batch(300, bound=True) + _batch(500),
               n_batches=3)
    # each layer: its mark's 1 us and its kernels, a batch, in ms
    assert _read("hash_ms", ctx) == pytest.approx((1 + 5) / 1e3)
    assert _read("prep_ms", ctx) == pytest.approx((1 + 8 + 4 + 1 / 3) / 1e3)
    assert _read("score_ms", ctx) == pytest.approx((1 + 20) / 1e3)
    assert _read("merge_ms", ctx) == pytest.approx((1 + 6) / 1e3)
    assert _read("launch_ms", ctx) == pytest.approx(4 / 1e3)
    assert _read("guard_fallback_share", ctx) == pytest.approx(100 / 3)


def test_a_trace_without_the_programs_marks_reads_none(tmp_path):
    events = [e for e in _batch(100) if not e["name"].startswith("nlsh")]
    ctx = _ctx(tmp_path, events, n_batches=1)
    for name in ("hash_ms", "prep_ms", "score_ms", "merge_ms", "launch_ms",
                 "guard_fallback_share"):
        assert _read(name, ctx) is None, name


def test_a_serve_without_a_guard_reads_no_fallback(tmp_path):
    ctx = _ctx(tmp_path, _batch(100), n_batches=1)
    assert _read("guard_fallback_share", ctx) == 0.0
