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
* :func:`cond` is ``jax.lax.cond`` inside a body: under a capture it
  records the two branches as two CUDA-graph conditional (if) nodes, so
  a replay decides on the card; in the warm-up both branches run (the
  one not taken needs its kernels loaded too); elsewhere ``pred`` is
  read on the host and one branch runs.
* Counters: a :class:`GraphCache` counts its captures, replays and
  evictions (an evicted key's next call captures again), and each entry
  keeps its graph's node count, counted at capture through CUDA's own
  API (``csrc/graph_cond.cu``): a replay's host launch time grows with
  it.  While a profiler records, :meth:`GraphCache.run` marks its replay
  (the static copy-in, the replay, the clone-out) and a capture with the
  host spans ``nlsh.replay`` and ``nlsh.capture``
  (:func:`nlsh_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

import ctypes
import time
from collections import OrderedDict
from typing import Callable

import torch

from nlsh_tpu_torch.ops.cuda.query_kernel import KERNEL_LAUNCHES
from nlsh_tpu_torch.utils.profiling import span

MAX_GRAPHS = 16  # entries a cache keeps, the most recently used

# the memory pool of the graph :func:`capture` is capturing, whether it runs
# its warm-up, whether a :func:`cond` routed this thread to that pool, and
# the nodes of the conditional bodies it captured
_capturing_pool: tuple | None = None
_warming = False
_rerouted = False
_body_nodes = 0


def warming() -> bool:
    """Whether :func:`capture` is running its warm-up."""
    return _warming


def _leaves(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _route_thread_to_pool(device: torch.device) -> None:
    """Route this thread's allocations, on any stream, to the capturing
    graph's private pool, once per capture.  The capture routes only its
    own stream's; a conditional node's body is captured on another
    stream, in a capture sequence of its own, and its tensors must live
    in the graph's pool too.  :func:`capture` takes the route down."""
    global _rerouted
    if _rerouted:
        return
    if _capturing_pool is None:
        raise RuntimeError("cond on the card runs inside utils.graphs.capture")
    # torch 2.11 has no thread route; its route takes every stream's
    route = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool",
                    torch._C._cuda_beginAllocateToPool)
    torch._C._cuda_endAllocateToPool(device.index, _capturing_pool)
    route(device.index, _capturing_pool)
    _rerouted = True


def _take_route_down(pool: tuple, ended: bool) -> None:
    """Undo :func:`_route_thread_to_pool` after a capture: the capture's
    end takes the route itself unless the capture failed (an
    invalidated capture raises first), and the pool's extra reference
    goes."""
    index = torch.cuda.current_device()
    if not ended:
        try:
            torch._C._cuda_endAllocateToPool(index, pool)
        except RuntimeError:  # the failed capture's end took it after all
            pass
    torch._C._cuda_releasePool(index, pool)


_BODY_STREAMS: dict = {}  # device index -> the bodies' stream


def _body_stream(device: torch.device, lib) -> torch.cuda.ExternalStream:
    """The stream a conditional body is captured on, one per device made
    by ``nlsh_cond_stream``: torch's stream pool hands its streams round,
    so a pool stream could be the capturing stream itself."""
    from nlsh_tpu_torch.ops.cuda.query_kernel import _raise_on

    if device.index not in _BODY_STREAMS:
        raw = ctypes.c_void_p()
        with torch.cuda.device(device):
            _raise_on(lib.nlsh_cond_stream(ctypes.byref(raw)),
                      "nlsh_cond_stream")
        _BODY_STREAMS[device.index] = torch.cuda.ExternalStream(
            raw.value, device=device)
    return _BODY_STREAMS[device.index]


def _cond_nodes(pred: torch.Tensor, branches, operands) -> tuple:
    """The branches captured as two IF nodes of the graph being captured
    (``csrc/graph_cond.cu``: handles set on the card from ``pred`` and
    ``~pred``, each body captured on a stream of its own); the second
    branch copies its outputs into the first one's buffers."""
    from nlsh_tpu_torch.ops.cuda.build import load_library
    from nlsh_tpu_torch.ops.cuda.query_kernel import _raise_on

    global _body_nodes
    lib = load_library()
    device = pred.device
    _route_thread_to_pool(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    handles = (ctypes.c_ulonglong * 2)()
    _raise_on(lib.nlsh_cond_handles(ctypes.c_void_p(stream),
                                    ctypes.c_void_p(pred.data_ptr()),
                                    handles), "nlsh_cond_handles")
    body = _body_stream(device, lib)
    outs, first = [], None
    for handle, fn in zip(handles, branches):
        counted = dict(KERNEL_LAUNCHES)
        _raise_on(lib.nlsh_cond_begin(ctypes.c_void_p(stream), handle,
                                      ctypes.c_void_p(body.cuda_stream)),
                  "nlsh_cond_begin")
        try:
            with torch.cuda.stream(body):
                out = _leaves(fn(*operands))
                for dst, src in zip(outs[0] if outs else (), out):
                    dst.copy_(src)
        finally:
            nodes = ctypes.c_ulonglong()
            ended = lib.nlsh_cond_end(ctypes.c_void_p(body.cuda_stream),
                                      ctypes.byref(nodes))
        _raise_on(ended, "nlsh_cond_end")
        _body_nodes += nodes.value
        outs.append(out)
        if first is None:
            first = {name: n - counted.get(name, 0)
                     for name, n in KERNEL_LAUNCHES.items()}
        else:  # a replay runs one branch: keep the larger count
            for name, n in KERNEL_LAUNCHES.items():
                extra = n - counted.get(name, 0)
                KERNEL_LAUNCHES[name] = n - min(extra, first.get(name, 0))
    return outs[0]


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         *operands):
    """``true_fn(*operands)`` where the 0-d bool ``pred`` holds, else
    ``false_fn(*operands)``: the counterpart of ``jax.lax.cond``.  Both
    branches return tensors (or tuples of tensors) of the same shapes and
    dtypes.

    * Under :func:`capture` on the card the branches become two CUDA-graph
      conditional IF nodes, one on ``pred`` and one on ``~pred`` (CUDA's
      IF-ELSE node needs 12.8), built through CUDA's own API
      (``csrc/graph_cond.cu``; the card's torch has no
      ``CUDAGraph.begin_capture_to_if_node``).  Each body is captured on
      a stream of its own made current for it, so the kernels' wrappers,
      which launch on the current stream, land in it; its tensors go to
      the graph's pool.  The second branch copies its outputs into the first
      one's buffers, which the rest of the graph reads.  A replay counts,
      per kernel, the larger of the two branches' launches (one of them
      runs; the callers' branches launch the same kernels).
    * In :func:`capture`'s warm-up both branches run and their outputs
      are merged with ``torch.where`` on the card: no host read, and the
      branch not taken has its kernels built, loaded and their attributes
      set before the capture.
    * Otherwise (CPU tensors, eager runs) ``pred`` is read on the host
      and one branch runs."""
    pred = pred.reshape(()).to(torch.bool)
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        out = _cond_nodes(pred.contiguous(), (true_fn, false_fn), operands)
    elif pred.is_cuda and _warming:
        a, b = _leaves(true_fn(*operands)), _leaves(false_fn(*operands))
        out = tuple(torch.where(pred, x, y) for x, y in zip(a, b))
    else:
        out = _leaves(true_fn(*operands) if bool(pred)
                      else false_fn(*operands))
    return out if len(out) > 1 else out[0]


class Graph:
    """A captured graph over its static inputs and outputs, with the
    kernel launches a replay makes, its memory pool's bytes, the host
    seconds its warm-up and capture took and its nodes (the conditional
    bodies' included)."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "pool_bytes",
                 "holds", "capture_s", "nodes")

    def __init__(self, graph, inputs, outputs, launches, pool_bytes, holds,
                 capture_s, nodes):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.holds = holds
        self.capture_s = capture_s
        self.nodes = nodes

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
        self.captures = 0   # graphs captured (an evicted key's again)
        self.replays = 0
        self.evictions = 0  # entries dropped past MAX_GRAPHS

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

    def capture_s(self) -> list[float]:
        """Each entry's host seconds of warm-up and capture, in the order
        of :meth:`pool_bytes`."""
        return [e.capture_s for e in self._entries.values()]

    def nodes(self) -> list[int]:
        """Each entry's graph nodes, conditional bodies' included, in the
        order of :meth:`pool_bytes`."""
        return [e.nodes for e in self._entries.values()]

    def stats(self) -> dict:
        """The counters: captures, replays, evictions and each entry's
        nodes."""
        return {"captures": self.captures, "replays": self.replays,
                "evictions": self.evictions, "nodes": self.nodes()}

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
            with span("nlsh.capture"), torch.cuda.device(device):
                static = tuple(None if t is None else t.detach().clone()
                               for t in inputs)
                entry = capture(body, static, device, holds)
            self.captures += 1
            self._entries[full_key] = entry
            while len(self._entries) > MAX_GRAPHS:
                self._entries.popitem(last=False)
                self.evictions += 1
        else:
            self._entries.move_to_end(full_key)
        with span("nlsh.replay"), torch.cuda.device(device):
            for static, t in zip(entry.inputs, inputs):
                if static is not None:
                    static.copy_(t)
            entry.replay()
            out = tuple(o.clone() for o in entry.outputs)
        self.replays += 1
        return out if len(out) > 1 else out[0]


def capture(body: Callable, static: tuple, device: torch.device,
            holds: tuple = (), grad: bool = False) -> Graph:
    """Run ``body(*static)`` once on a side stream (the warm-up, both
    branches of every :func:`cond`), then capture it into a graph over
    the same ``static`` tensors, which the caller fills before each
    replay; a failed capture raises.  Both run under ``no_grad``, or with
    autograd on where ``grad`` (a training step).  The graph's nodes are
    counted as the capture's last step."""
    global _capturing_pool, _warming, _rerouted, _body_nodes
    from nlsh_tpu_torch.ops.cuda.build import load_library
    from nlsh_tpu_torch.ops.cuda.query_kernel import _raise_on

    t0 = time.perf_counter()
    lib = load_library()  # loaded before the capture, which counts with it
    with torch.cuda.device(device), torch.set_grad_enabled(grad):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _warming = True
            try:
                body(*static)
            finally:
                _warming = False
        torch.cuda.current_stream(device).wait_stream(side)
        counted = dict(KERNEL_LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # the graph's private pool, by a handle a cond can name mid-capture
        pool = torch.cuda.graph_pool_handle()
        ended = False
        nodes = ctypes.c_ulonglong()
        _body_nodes = 0
        try:
            with torch.cuda.graph(graph, pool=pool):
                _capturing_pool = pool
                out = body(*static)
                stream = torch.cuda.current_stream(device).cuda_stream
                _raise_on(lib.nlsh_graph_nodes(ctypes.c_void_p(stream),
                                               ctypes.byref(nodes)),
                          "nlsh_graph_nodes")
            ended = True
        finally:
            _capturing_pool = None
            if _rerouted:  # a cond routed this thread to the graph's pool
                _rerouted = False
                _take_route_down(pool, ended)
            launches = {name: KERNEL_LAUNCHES[name] - n
                        for name, n in counted.items()
                        if KERNEL_LAUNCHES[name] != n}
            KERNEL_LAUNCHES.update(counted)  # the capture ran nothing
        index = torch.cuda.current_device()
        pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if seg["device"] == index
            and tuple(seg.get("segment_pool_id", ())) == tuple(pool))
        torch.cuda.synchronize(device)
    outputs = out if isinstance(out, tuple) else (out,)
    return Graph(graph, static, outputs, launches, pool_bytes, holds,
                 time.perf_counter() - t0, nodes.value + _body_nodes)


#: the graphs of the fused serves called without a cache of their own
DEFAULT = GraphCache()
