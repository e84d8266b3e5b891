"""A serve's layer marks, host spans and counters
(``nlsh_tpu_torch.utils.profiling``, ``utils.graphs.GraphCache``).

On the CPU (a graph's body runs eagerly there): the fused serves of both
indexers mark hash, prep, score, merge and end in that order inside the
host span ``nlsh.query``; no ``record_function`` is entered without a
profiler; ``serve_stats()`` counts every layer once a batch on every
fused engine and the guard's fallbacks; the accounting itself on a
scripted sequence of marks; ``GraphCache``'s captures, replays and
evictions with the capture stubbed; the serve loop's ``stats`` line.

On the card (``cuda`` marker, skipped without one) a replayed grouped
serve and a guarded ensemble serve fill the device's accumulator and
answer as their eager bodies do, bit for bit.  The module imports no JAX,
so its card test runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import io
import json

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.cli import serve as tserve
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.index.indexer import _serve_body
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.parallel.multitable import _mt_serve_body, init_multi_table
from nlsh_tpu_torch.utils import graphs, profiling

DIM = 16
KW = dict(k=5, hash_times=3, probe_mode="flip")
ORDER = ["hash", "prep", "score", "merge", "end"]


def _data(seed=0, n=1500, nq=48):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, DIM))
    pts = centers[rng.integers(0, 20, n + 3 * nq)] + 0.4 * rng.normal(
        size=(n + 3 * nq, DIM))
    pts = pts.astype(np.float32)
    return pts[:n], pts[n:].reshape(3, nq, DIM)


def _head(seed=0, bits=6):
    return get_hashing("MultivariateBernoulli",
                       get_encoder("siren", DIM, [32]),
                       bits).init(torch.Generator().manual_seed(seed))


def _index(kind, device="cpu"):
    """An index of ``kind`` (an engine of the single table, or the
    windowed ensemble calibrated on its batches or starved) and its three
    query batches."""
    corpus, qs = _data()
    if not kind.startswith("ensemble"):
        return Indexer(_head(), corpus, device=device, engine=kind,
                       block_rows=128), qs
    heads = init_multi_table(_head(), 3, torch.Generator().manual_seed(1))
    idx = MultiTableIndexer(heads, corpus, device=device, engine="windowed",
                            block_rows=128)
    if kind == "ensemble":
        idx.calibrate(qs.reshape(-1, DIM), hash_times=3, probe_mode="flip")
    else:  # starved: every batch needs more groups than calibrated
        idx.calibrate(qs[0, :2], hash_times=1, probe_mode="flip")
    return idx, qs


def _diff(after, before):
    return {name: {key: after["layers"][name][key] - v[key]
                   for key in ("ms", "count")}
            for name, v in before["layers"].items()}


@pytest.mark.parametrize("kind", ["grouped", "ensemble"])
def test_marks_lie_in_the_query_span_in_layer_order(kind):
    """Under a CPU profiler one ``query`` is the host span ``nlsh.query``
    holding ``nlsh.upload`` and the body's marks, in the order hash,
    prep, score, merge, end (the guarded ensemble marks prep twice: its
    group count, then the engine's prep), then ``nlsh.fetch``."""
    idx, qs = _index(kind)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        idx.query(qs[0], **KW)
    events = sorted((e for e in prof.events() if e.name.startswith("nlsh")),
                    key=lambda e: e.time_range.start)
    (query,) = [e for e in events if e.name == "nlsh.query"]
    marks = [e for e in events if e.name.startswith("nlsh_span_")]
    assert all(query.time_range.start <= e.time_range.start
               and e.time_range.end <= query.time_range.end for e in marks)
    names = [e.name.removeprefix("nlsh_span_") for e in marks]
    assert [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]] \
        == ORDER
    assert names.count("prep") == (2 if kind == "ensemble" else 1)
    assert [e.name for e in events if not e.name.startswith("nlsh_span_")] \
        == ["nlsh.query", "nlsh.upload", "nlsh.uniforms", "nlsh.fetch"]


def test_no_record_function_is_entered_without_a_profiler(monkeypatch):
    """The host spans and the CPU marks enter ``record_function`` only
    while a profiler records: none without one, each with one."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    served = [_index(kind) for kind in ("grouped", "ensemble")]
    for idx, qs in served:
        idx.query(qs[0], **KW)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for idx, qs in served:
            idx.query(qs[0], **KW)
    assert entered.count("nlsh.query") == entered.count("nlsh.fetch") == 2
    assert entered.count("nlsh_span_hash") == 2


@pytest.mark.parametrize("kind", ["grouped", "windowed", "fixed", "ensemble",
                                  "ensemble_starved"])
def test_serve_stats_count_every_layer_once_a_batch(kind):
    """Three batches: every layer opened three times with a time of at
    least 0, three batches, and the guard's fallbacks one a batch where
    the calibration is starved, none elsewhere; the ids are the plain
    serve's."""
    idx, qs = _index(kind)
    before = idx.serve_stats()
    for q in qs:
        ids, n_cand = idx.query(q, **KW)
        want, want_cand = idx.query(q, plain=True, **KW)
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(n_cand, want_cand)
    after = idx.serve_stats()
    # the plain serves mark too: the single table's through the body, the
    # ensemble's not (it serves outside the fused body)
    n = 6 if not kind.startswith("ensemble") else 3
    assert after["batches"] - before["batches"] == n
    for name, d in _diff(after, before).items():
        assert d["count"] == n, name
        assert d["ms"] >= 0 and after["layers"][name]["ms"] >= 0
    fell_back = after["guard_fallbacks"] - before["guard_fallbacks"]
    assert fell_back == (3 if kind == "ensemble_starved" else 0)
    assert after["graphs"] == {"captures": 0, "replays": 0, "evictions": 0,
                               "nodes": []}


def test_the_accounting_of_a_scripted_sequence():
    """The host mirror of ``csrc/spans.cu`` on a clock the test sets:
    each boundary charges the time since the last one to the open layer;
    reopening the open layer continues it uncounted; a second query chunk
    reopens prep, score and merge; marks outside a serve (no hash) and
    ``bound`` open nothing; a hash after a serve left open charges
    nothing."""
    acc = [0] * profiling.SPAN_SLOTS
    script = [("prep", 0), ("merge", 1),                # outside: ignored
              ("hash", 10), ("prep", 13), ("prep", 14), ("bound", 15),
              ("score", 20), ("merge", 30), ("prep", 31), ("score", 33),
              ("merge", 40), ("end", 44),
              ("score", 50),                              # ignored
              ("hash", 60), ("prep", 61),                 # left open
              ("hash", 100), ("end", 101)]
    for name, t in script:
        profiling._boundary(acc, profiling.MARKS[name], t)
    ns = dict(zip(profiling.SPAN_LAYERS,
                  acc[profiling._NS:profiling._NS + 4]))
    counts = dict(zip(profiling.SPAN_LAYERS,
                      acc[profiling._COUNT:profiling._COUNT + 4]))
    assert ns == {"hash": 3 + 1 + 1, "prep": 7 + 2, "score": 10 + 7,
                  "merge": 1 + 4}
    assert counts == {"hash": 3, "prep": 3, "score": 2, "merge": 2}
    assert acc[profiling._BOUND] == 1 and acc[profiling._OPEN] == 0


class _Fake:
    """What ``GraphCache.run`` reads of a card tensor: device, shape,
    dtype, a copy and a clone."""

    def __init__(self, n):
        self.shape, self.dtype = (n,), torch.float32
        self.device = torch.device("cuda", 0)

    def detach(self):
        return self

    def clone(self):
        return self

    def copy_(self, other):
        return self


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeGraph:
    def replay(self):
        pass


def test_graph_cache_counts_captures_replays_and_evictions(monkeypatch):
    """With the capture stubbed: a key's first call captures, every call
    replays, a cache past ``MAX_GRAPHS`` evicts its least recently used
    entry, whose key then captures again; each entry keeps its nodes."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NoDevice())

    def capture(body, static, device, holds=()):
        return graphs.Graph(_FakeGraph(), static, (_Fake(1),), {}, 0, holds,
                            0.0, 10 + static[0].shape[0])

    monkeypatch.setattr(graphs, "capture", capture)
    cache = graphs.GraphCache()
    n = graphs.MAX_GRAPHS + 3
    for size in range(n):
        cache.run("k", None, (_Fake(size),))
    cache.run("k", None, (_Fake(n - 1),))
    cache.run("k", None, (_Fake(0),))  # evicted: captured again
    stats = cache.stats()
    assert stats["captures"] == n + 1 and stats["replays"] == n + 2
    assert stats["evictions"] == 4 and len(cache) == graphs.MAX_GRAPHS
    assert stats["nodes"][-1] == 10 and stats["nodes"][-2] == 10 + n - 1


def test_serve_loop_stats_line_reads_serve_stats():
    """The loop's final ``stats`` line carries the index's
    ``serve_stats()``: one batch a request, each layer counted."""
    idx, qs = _index("grouped")
    args = tserve.nlsh_serve_argparse().parse_args(
        ["--model_path", "x", "--data_id", "synthetic", "--device", "cpu",
         "--hash_times", "3", "-k", "5"])
    before = idx.serve_stats()
    text = "".join(json.dumps({"id": i, "queries": q.tolist()}) + "\n"
                   for i, q in enumerate(qs))
    out = io.StringIO()
    stats = tserve.serve_loop(args, idx, {"probe_mode": "flip"}, DIM,
                              stdin=io.StringIO(text), stdout=out)
    line = json.loads(out.getvalue().splitlines()[-1])["stats"]
    assert line == stats
    serve = stats["serve"]
    assert serve["batches"] - before["batches"] == 3
    assert all(d["count"] == 3 for d in _diff(serve, before).values())
    assert set(serve) == {"batches", "layers", "guard_fallbacks", "graphs"}
    assert set(serve["layers"]["prep"]) == {"ms", "count", "ms_per_batch"}


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a captured graph has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replays_fill_the_accumulator_and_answer_as_before(cuda_device):
    """A replayed grouped serve and a guarded ensemble serve (calibrated,
    then starved): each replay answers as its eager body bit for bit,
    every layer's count grows by the replays and its time by more than
    0, the starved replays count their fallbacks, the warm-up counts
    nothing, and each graph has its nodes."""
    for kind in ("grouped", "ensemble", "ensemble_starved"):
        idx, qs = _index(kind, device=cuda_device)
        qs = torch.from_numpy(qs).to(cuda_device)
        before = idx.serve_stats()
        got = [idx.query_async(q, **KW) for q in qs]
        after = idx.serve_stats()
        if kind == "grouped":
            body = _serve_body(idx.hashing, idx.layout, idx.table.counts,
                               grouped="grouped", **KW)
        else:
            body = _mt_serve_body(
                idx.hashings, idx._serving_layout(), k=5, hash_times=3,
                engine="windowed", n_rows=idx.n_rows, g_override=idx._g_cal,
                probe_mode="flip")
        with torch.no_grad():
            for q, packed in zip(qs, got):
                assert torch.equal(packed, body(q, None)), kind
        assert after["batches"] - before["batches"] == 3, kind
        for name, d in _diff(after, before).items():
            assert d["count"] == 3 and d["ms"] > 0, (kind, name)
        assert after["guard_fallbacks"] - before["guard_fallbacks"] == (
            3 if kind == "ensemble_starved" else 0)
        g = after["graphs"]
        assert g["captures"] == 1 and g["replays"] == 3, kind
        assert g["nodes"][0] > 20, kind
