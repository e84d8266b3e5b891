"""What the metrics read from a trace file, on a hand-made chrome trace:
the window, the device's busy union, kernel time by name, launches, the
costliest operations and the idle time by what the host was doing."""

import json

import pytest

from portbench.trace import Trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def test_trace_by_hand(tmp_path):
    events = [
        _x("before", "kernel", 0, 50),                  # outside the window
        _x("portbench.window", "user_annotation", 100, 100),
        _x("portbench.batch", "user_annotation", 100, 60),
        _x("portbench.submit", "user_annotation", 100, 20),
        _x("cudaGraphLaunch", "cuda_runtime", 105, 5),
        _x("cudaMemcpyAsync", "cuda_runtime", 110, 5),
        _x("cudaStreamSynchronize", "cuda_runtime", 125, 30),
        _x("void grouped_topk_kernel<float, false>", "kernel", 110, 20),
        _x("sort", "kernel", 125, 10),                  # overlaps the first
        _x("Memcpy DtoH", "gpu_memcpy", 150, 5),
        _x("host gap", "cpu_op", 165, 30),
        _x("ProfilerStep#3", "user_annotation", 160, 40),
        {"ph": "i", "name": "marker", "ts": 120},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = Trace(str(path))
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_intervals() == [(110.0, 135.0), (150.0, 155.0)]
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.kernel_s() == pytest.approx(30e-6)
    assert t.kernel_s(["grouped_topk_kernel"]) == pytest.approx(20e-6)
    assert t.launches() == 2
    assert t.device_ops()[0] == ["void grouped_topk_kernel<float, false>",
                                 pytest.approx(20e-6)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"submit:cudaGraphLaunch": pytest.approx(10e-6),
                    "batch:cudaStreamSynchronize": pytest.approx(15e-6),
                    "window:host gap": pytest.approx(45e-6)}


def test_a_trace_without_its_window_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("k", "kernel", 0, 1)]}))
    with pytest.raises(ValueError, match="portbench.window"):
        Trace(str(path))
