"""The traced window: ``torch.profiler`` over the window, its chrome trace
written to a file, and what the metrics read from that file.

Times in the file are microseconds.  Device operations are the events
of the categories in :data:`DEVICE_CATS`; the host's CUDA calls are
those of :data:`RUNTIME_CATS`.  The harness marks the window and each
batch with ``record_function`` spans named ``portbench.*``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + RUNTIME_CATS
# host calls that put work on the device: launches (of a kernel or a
# graph), copies and fills
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
WINDOW = "portbench.window"
BATCH = "portbench.batch"
SUBMIT = "portbench.submit"
SCAN_BACK = 64  # host events searched back for one that spans a gap
PROFILER_STEP = "ProfilerStep#"  # the profiler's own marks, left out


def profiler(**kw):
    """The profiler the traced window runs under: host and device
    activity."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, **kw)


class Trace:
    """The events of a chrome trace inside its ``portbench.window``
    span."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        windows = [e for e in spans if e["name"] == WINDOW
                   and e.get("cat") == "user_annotation"]
        if not windows:
            raise ValueError(f"{path} holds no {WINDOW} span")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])

        def inside(e):
            return self.t0 <= float(e["ts"]) < self.t1

        self.device = sorted(
            (float(e["ts"]), float(e["dur"]), e["name"], e["cat"])
            for e in spans if e.get("cat") in DEVICE_CATS and inside(e))
        # by start, the longer first: an event nested in one that starts
        # with it comes after it
        self.host = sorted(
            ((float(e["ts"]), float(e["dur"]), e["name"]) for e in spans
             if e.get("cat") in HOST_CATS and inside(e)
             and not e["name"].startswith(PROFILER_STEP)),
            key=lambda h: (h[0], -h[1]))
        self.runtime = [e["name"] for e in spans
                        if e.get("cat") in RUNTIME_CATS and inside(e)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        out = []
        for ts, dur, _, _ in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, names=None) -> float:
        """Summed device time of the kernels whose name holds one of
        ``names`` (every kernel if None); copies and fills left out."""
        return sum(dur for _, dur, name, cat in self.device
                   if cat == "kernel" and (
                       names is None or any(n in name for n in names))) / 1e6

    def launches(self) -> int:
        return sum(any(w in name for w in LAUNCH_WORDS)
                   for name in self.runtime)

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: ``[name,
        seconds]``."""
        tot = defaultdict(float)
        for _, dur, name, _ in self.device:
            tot[name] += dur / 1e6
        return [[n, s] for n, s in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:top]]

    def _spanning(self, events, starts, t: float):
        """The innermost of ``events`` (sorted by start) that spans
        ``t``, searching back :data:`SCAN_BACK` events."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 1 - SCAN_BACK, -1), -1):
            ts, dur, name = events[j]
            if ts + dur > t:
                return name
        return None

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time inside the window by what the host was
        doing at each gap's middle: ``[label, seconds]``, the label the
        innermost ``portbench.*`` span and the innermost host event."""
        marks = [h for h in self.host if h[2].startswith("portbench.")]
        mark_starts = [h[0] for h in marks]
        starts = [h[0] for h in self.host]
        tot = defaultdict(float)
        edge = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > edge:
                mid = (edge + a) / 2
                span = self._spanning(marks, mark_starts, mid) or WINDOW
                what = self._spanning(self.host, starts, mid) or "none"
                tot[f"{span.removeprefix('portbench.')}:{what}"] += \
                    (a - edge) / 1e6
            edge = max(edge, b)
        return [[n, s] for n, s in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:top]]
