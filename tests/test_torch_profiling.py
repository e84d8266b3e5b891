"""The port's phase timer (``nlsh_tpu_torch.utils.profiling``) on the
CPU: ``PhaseTimer`` accumulates, summarises and reports as the JAX
package's does.  The serve's layer marks and host spans, the module's
other part, are ``tests/test_torch_spans.py``'s."""

import torch

from nlsh_tpu_torch.utils.profiling import PhaseTimer


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
