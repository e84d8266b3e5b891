"""The port's phase timer and trace (``nlsh_tpu_torch.utils.profiling``)
on the CPU: ``PhaseTimer`` accumulates, summarises and reports as the
JAX package's does; ``trace(None)`` does nothing; ``trace(dir)`` writes
a ``torch.profiler`` trace file there."""

import json
import os

import torch

from nlsh_tpu_torch.utils.profiling import PhaseTimer, trace


def test_phase_timer_accumulates_and_reports():
    for sync in (True, False):
        timer = PhaseTimer(sync=sync)
        with timer("a"):
            torch.ones((8, 8)).sum()
        with timer("a"):
            pass
        with timer("b"):
            pass
        s = timer.summary()
        assert set(s) == {"a", "b"}
        assert s["a"]["count"] == 2 and s["b"]["count"] == 1
        assert s["a"]["total_s"] >= 0
        assert s["a"]["mean_s"] == s["a"]["total_s"] / 2
        lines = timer.report().splitlines()
        assert [line.split()[0] for line in lines] == ["a", "b"]
        assert "x2" in lines[0] and lines[0].rstrip().endswith("ms")


def test_a_phase_that_raises_is_still_timed():
    timer = PhaseTimer()
    try:
        with timer("fails"):
            raise ValueError("inside")
    except ValueError:
        pass
    assert timer.summary()["fails"]["count"] == 1


def test_trace_without_a_directory_does_nothing(tmp_path):
    before = set(os.listdir(tmp_path))
    with trace(None):
        torch.ones(4) + 1
    assert set(os.listdir(tmp_path)) == before


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "tb")):
        (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    files = [f for f in os.listdir(tmp_path / "tb")
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / "tb" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
