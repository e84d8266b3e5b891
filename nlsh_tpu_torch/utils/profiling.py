"""Per-phase timing, a serve's layer marks and its host spans.

* :class:`PhaseTimer`: named wall-clock phases that synchronise the card
  on entry and exit, so a phase means "work finished", not "launches
  returned" (port of :mod:`nlsh_tpu.utils.profiling`'s).
* :func:`mark`: a layer boundary of a serve body (``hash``, ``prep``,
  ``score``, ``merge``, ``end``, and the count-only ``bound`` of the
  ensemble guard's static branch).  On the card it launches the
  one-thread kernel ``nlsh_span_<name>`` (``csrc/spans.cu``) on the
  current stream, so a captured graph holds it and every replay runs it;
  the kernel adds the time since the last mark to the open layer of the
  device's accumulator on the card's clock.  On the CPU the same
  accounting runs on the host clock (and, while a profiler records, a
  ``record_function`` range of the kernel's name marks the place).
  :func:`span_stats` reads a device's accumulator with one copy.
* :func:`span`: a ``torch.profiler.record_function`` range for the host
  side of a serve (``nlsh.query``, ``nlsh.upload``, ``nlsh.uniforms``,
  ``nlsh.fetch``, ``nlsh.replay``, ``nlsh.capture``), entered only while
  a profiler records: an untraced run pays one check per span.

The accumulators are per device and shared by every index on it.  A
capture's warm-up marks a scratch accumulator of its own, so the counts
are of batches served: eager serves and replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import defaultdict

import torch

# the layout of an accumulator (``csrc/spans.cu``)
SPAN_LAYERS = ("hash", "prep", "score", "merge")
SPAN_SLOTS = 16
_LAST, _OPEN, _NS, _COUNT, _BOUND = 0, 1, 2, 6, 10
_HASH, _END = 1, 5
MARKS = {"hash": 1, "prep": 2, "score": 3, "merge": 4, "end": _END,
         "bound": 6}

# device -> (accumulator, the warm-up's scratch): int64 tensors on a card,
# lists of ints on the CPU
_ACCUMULATORS: dict = {}
_NO_SPAN = contextlib.nullcontext()


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


def _recording() -> bool:
    """Whether a profiler records on this thread now."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a context that does nothing."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _accumulators(device: torch.device):
    """``device``'s accumulator and warm-up scratch, made on first use.
    A card's are made outside any capture (a capture's warm-up makes
    them), since a graph keeps their address."""
    pair = _ACCUMULATORS.get(device)
    if pair is None:
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a layer mark's first use on a card is outside a "
                    "capture (utils.graphs.capture warms up first)")
            pair = tuple(torch.zeros(SPAN_SLOTS, dtype=torch.int64,
                                     device=device) for _ in range(2))
        else:
            pair = ([0] * SPAN_SLOTS, [0] * SPAN_SLOTS)
        _ACCUMULATORS[device] = pair
    return pair


def _boundary(acc: list, which: int, now: int) -> None:
    """The accounting of ``csrc/spans.cu``'s marks on a host list."""
    if which == MARKS["bound"]:
        acc[_BOUND] += 1
        return
    opened = acc[_OPEN]
    if which == _HASH:
        acc[_COUNT] += 1
    else:
        if not opened:
            return
        acc[_NS + opened - 1] += now - acc[_LAST]
        if which != _END and which != opened:
            acc[_COUNT + which - 1] += 1
    acc[_OPEN] = 0 if which == _END else which
    acc[_LAST] = now


def mark(name: str, like: torch.Tensor) -> None:
    """The layer mark ``name`` (a key of :data:`MARKS`) on ``like``'s
    device: on a card, ``nlsh_span_<name>`` launched on the current
    stream; on the CPU, the same accounting on the host clock."""
    which = MARKS[name]
    device = like.device
    if device.type != "cuda":
        if _recording():
            with torch.profiler.record_function(f"nlsh_span_{name}"):
                pass
        _boundary(_accumulators(device)[0], which, time.perf_counter_ns())
        return
    from nlsh_tpu_torch.ops.cuda.build import load_library
    from nlsh_tpu_torch.ops.cuda.query_kernel import _raise_on
    from nlsh_tpu_torch.utils import graphs

    acc, scratch = _accumulators(device)
    target = scratch if graphs.warming() else acc
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(load_library().nlsh_span(
            which, ctypes.c_void_p(target.data_ptr()),
            ctypes.c_void_p(stream)), "nlsh_span")


def span_stats(device) -> dict:
    """``device``'s layer marks so far, read with one copy: the batches
    served (``hash`` marks), per layer of :data:`SPAN_LAYERS` the
    milliseconds spent in it, the times it was opened (a batch served in
    several query chunks opens prep, score and merge once a chunk) and
    the milliseconds a batch, and the guard's fallbacks to its static
    bound (``bound`` marks).  On a card the read waits for the work queued
    before it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    acc = _ACCUMULATORS.get(device)
    acc = [0] * SPAN_SLOTS if acc is None else (
        acc[0].tolist() if device.type == "cuda" else list(acc[0]))
    batches = acc[_COUNT]
    ms = [acc[_NS + i] / 1e6 for i in range(len(SPAN_LAYERS))]
    return {
        "batches": batches,
        "layers": {name: {"ms": ms[i], "count": acc[_COUNT + i],
                          "ms_per_batch": ms[i] / max(batches, 1)}
                   for i, name in enumerate(SPAN_LAYERS)},
        "guard_fallbacks": acc[_BOUND],
    }
