"""Per-phase timing and tracing (port of :mod:`nlsh_tpu.utils.profiling`).

* :class:`PhaseTimer`: named wall-clock phases that synchronise the card
  on entry and exit, so a phase means "work finished", not "launches
  returned".
* :func:`trace`: ``torch.profiler`` over a block, writing a trace that
  TensorBoard loads into a directory (nothing when it is None).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named timers: ``with timer("build"): ...``."""

    def __init__(self, sync: bool = True):
        self._sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self._sync:
            _synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                _synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        return "\n".join(
            f"{name:24s} total {v['total_s']:9.3f}s  "
            f"x{v['count']:<5d} mean {v['mean_s'] * 1e3:9.2f}ms"
            for name, v in sorted(self.summary().items()))


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` (CPU, and CUDA where there is a card) over the
    block, its trace written into ``log_dir`` for TensorBoard; does
    nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
