"""Captured CUDA graphs: the port's one-dispatch serve and training step.

The JAX package compiles a serve (hash, probe, score, merge, pack) into
one program with ``jax.jit`` and dispatches it once per batch
(``_fused_serve`` and its kin), and scans a whole segment of optimiser
steps inside one program (``Trainer._build_segment_runner``).  PyTorch's
counterpart of "one compiled program, one dispatch" is a CUDA graph
captured once and replayed.  :func:`capture` is the one capture helper:
:class:`GraphCache` plays the role of ``jit``'s cache for the serves,
and the training step (:mod:`nlsh_tpu_torch.train.base`) captures its
body with autograd on and replays it once per step.

* :meth:`GraphCache.run` takes a key (everything ``jit`` would make
  static: the module, the layout object, ``k``, the probe count and
  mode, the engine, the repeats), a body and the body's tensor inputs.
  On a key's first call it runs the body once on a side stream (the
  warm-up: kernels build and load, their shared-memory attribute and
  occupancy are set and cached, cuBLAS finds its workspace), then
  captures it into a graph with static copies of the inputs.  Every call
  copies its inputs into the static ones, replays the graph and returns
  clones of the static outputs, so a later replay cannot overwrite a
  result the caller still holds.
* A capture that fails raises; it never falls back to running the body
  eagerly.  A host sync inside the body (a ``.item()``, a ``bincount``
  sizing its output, a ``nonzero``) is what such a failure reports, so
  the capture itself checks that the path reads nothing on the host.
* Inputs on the CPU run the body eagerly: there are no CPU graphs.  That
  is the only case in which the body runs without a graph.
* Entries hold what their graph reads by address (the module, the
  layout, the counts) until they are dropped: an owner drops its
  entries when it replaces its layout (:meth:`GraphCache.clear`), and a
  cache past :data:`MAX_GRAPHS` entries drops its least recently used
  one, so a caller that meets many query shapes does not keep a memory
  pool for each.
* Launch counts: the kernels' wrappers count a launch when Python calls
  them, which a replay does not.  The capture's counts are taken off the
  tallies (the capture ran nothing) and every replay adds them, so
  ``query_kernel.KERNEL_LAUNCHES`` counts what the card ran.
* The warm-up is a real run of the body on the tensors it is given: a
  serve runs it on its static copies and drops the result; the training
  step runs it on its own inputs, so it is the segment's first step.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch

from nlsh_tpu_torch.ops.cuda.query_kernel import KERNEL_LAUNCHES

MAX_GRAPHS = 16  # entries a cache keeps, the most recently used


class Graph:
    """A captured graph over its static inputs and outputs, with the
    kernel launches a replay makes, its memory pool's bytes and the host
    seconds its warm-up and capture took."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "pool_bytes",
                 "holds", "capture_s")

    def __init__(self, graph, inputs, outputs, launches, pool_bytes, holds,
                 capture_s):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.holds = holds
        self.capture_s = capture_s

    def replay(self) -> None:
        """One replay on the current stream, its launches counted."""
        self.graph.replay()
        for name, n in self.launches.items():
            KERNEL_LAUNCHES[name] += n


def _signature(inputs) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in inputs)


class GraphCache:
    """Captured graphs by key; see the module docstring."""

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry (and with it its graph's memory pool)."""
        self._entries.clear()

    def pool_bytes(self) -> list[int]:
        """Each entry's memory pool in bytes, least recently used first
        (the last is the entry just run): the allocator's segments of the
        graph's private pool after its capture."""
        return [e.pool_bytes for e in self._entries.values()]

    def run(self, key, body: Callable, inputs: tuple, holds: tuple = ()):
        """``body(*inputs)`` (a tensor or a tuple of tensors; ``None``
        inputs pass through) as a replay of the graph captured for ``key``
        and the inputs' shapes and dtypes; eagerly for CPU inputs.
        ``holds`` are the objects the graph reads by address, kept alive
        with it."""
        device = next(t.device for t in inputs if t is not None)
        if device.type != "cuda":
            with torch.no_grad():
                return body(*inputs)
        full_key = (key, device, _signature(inputs))
        entry = self._entries.get(full_key)
        if entry is None:
            with torch.cuda.device(device):
                static = tuple(None if t is None else t.detach().clone()
                               for t in inputs)
            entry = capture(body, static, device, holds)
            self._entries[full_key] = entry
            while len(self._entries) > MAX_GRAPHS:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(full_key)
        with torch.cuda.device(device):
            for static, t in zip(entry.inputs, inputs):
                if static is not None:
                    static.copy_(t)
            entry.replay()
            out = tuple(o.clone() for o in entry.outputs)
        return out if len(out) > 1 else out[0]


def capture(body: Callable, static: tuple, device: torch.device,
            holds: tuple = (), grad: bool = False) -> Graph:
    """Run ``body(*static)`` once on a side stream (the warm-up), then
    capture it into a graph over the same ``static`` tensors, which the
    caller fills before each replay; a failed capture raises.  Both run
    under ``no_grad``, or with autograd on where ``grad`` (a training
    step)."""
    t0 = time.perf_counter()
    with torch.cuda.device(device), torch.set_grad_enabled(grad):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        counted = dict(KERNEL_LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = body(*static)
        finally:
            launches = {name: KERNEL_LAUNCHES[name] - n
                        for name, n in counted.items()
                        if KERNEL_LAUNCHES[name] != n}
            KERNEL_LAUNCHES.update(counted)  # the capture ran nothing
        pool, index = tuple(graph.pool()), torch.cuda.current_device()
        pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if seg["device"] == index
            and tuple(seg.get("segment_pool_id", ())) == pool)
        torch.cuda.synchronize(device)
    outputs = out if isinstance(out, tuple) else (out,)
    return Graph(graph, static, outputs, launches, pool_bytes, holds,
                 time.perf_counter() - t0)


#: the graphs of the fused serves called without a cache of their own
DEFAULT = GraphCache()
