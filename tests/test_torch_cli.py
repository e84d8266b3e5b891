"""The port's serving CLI against ``nlsh_tpu.cli.serve`` on the synthetic
dataset.

Both CLIs get one model artifact and one dataset cache.  Compared: the
result line's keys; ``n_queries``, ``k``, ``hash_times`` and ``query_size``
exactly; recall within 0.005 and ids on at least 0.98 of slots (f32
summation order may swap near-tied neighbours); an index file saved by
either CLI restored by the other; ``serve_loop`` on an in-memory stream
(answers in order, the error answers in stream position, padding to a
power of two with a floor of 8, the ``stats`` keys).
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from nlsh_tpu.cli import serve as jserve
from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu.utils import checkpoint as jckpt
from nlsh_tpu_torch.cli import serve as tserve
from nlsh_tpu_torch.data import get_data_by_id
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils import checkpoint as tckpt

RESULT_KEYS = {"n_queries", "qps", "query_size", "build_s", "engine", "k",
               "hash_times", "recall_at_k"}
STATS_KEYS = {"batches", "n_queries", "wall_s", "qps", "latency_ms_p50",
              "latency_ms_p95", "latency_ms_max", "engine"}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """One dataset cache for both packages, and a model artifact."""
    monkeypatch.setenv("NLSH_SYNTH_CACHE_DIR", str(tmp_path / "cache"))
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", 32, [32]), 6)
    jckpt.save_model(str(tmp_path / "model"), jh,
                     jh.init(jax.random.PRNGKey(0)))
    return tmp_path


def _run(mod, argv, capsys):
    capsys.readouterr()
    result = mod.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result       # one JSON line, returned too
    return result


def test_result_line_matches_the_jax_cli(workdir, capsys):
    common = ["--model_path", str(workdir / "model"), "--data_id", "synthetic",
              "--probe_mode", "flip", "--hash_times", "6", "--batch", "100"]
    want = _run(jserve, common + ["--engine", "xla",
                                  "--output", str(workdir / "j.npz")], capsys)
    got = _run(tserve, common + ["--device", "cpu", "--engine", "gather",
                                 "--output", str(workdir / "t.npz")], capsys)
    assert set(got) == set(want) == RESULT_KEYS | {"output"}
    for key in ("n_queries", "k", "hash_times", "query_size"):
        assert got[key] == want[key], key
    assert (got["engine"], want["engine"]) == ("gather", "xla")
    assert abs(got["recall_at_k"] - want["recall_at_k"]) <= 0.005
    with np.load(workdir / "t.npz") as t, np.load(workdir / "j.npz") as j:
        assert t["topk_ids"].shape == j["topk_ids"].shape == (256, 10)
        np.testing.assert_array_equal(t["n_candidates"], j["n_candidates"])
        assert (t["topk_ids"] == j["topk_ids"]).mean() >= 0.98


@pytest.mark.parametrize("engine", ["grouped", "pallas-windowed", "fixed"])
def test_index_path_builds_then_restores(workdir, capsys, engine):
    """The first run builds and saves (``np.savez`` appends ``.npz``), the
    second restores: the same answers.  Engine names of the JAX package
    are aliases."""
    path = str(workdir / "idx.npz")
    argv = ["--model_path", str(workdir / "model"), "--data_id", "synthetic",
            "--device", "cpu", "--probe_mode", "flip", "--engine", engine,
            "--index_path", path, "--output", str(workdir / "out.npz")]
    first = _run(tserve, argv, capsys)
    assert (workdir / "idx.npz").exists()
    with np.load(workdir / "out.npz") as z:
        first_ids = z["topk_ids"]
    # another engine on the command line: the restored index keeps its own
    second = _run(tserve, argv[:-6] + ["--engine", "gather"] + argv[-4:],
                  capsys)
    with np.load(workdir / "out.npz") as z:
        np.testing.assert_array_equal(z["topk_ids"], first_ids)
    assert first["engine"] == second["engine"] == \
        engine.replace("pallas-", "")
    assert first["query_size"] == second["query_size"]
    assert first["recall_at_k"] == second["recall_at_k"]


def test_an_index_saved_by_either_cli_restores_in_the_other(workdir, capsys):
    common = ["--model_path", str(workdir / "model"), "--data_id", "synthetic",
              "--probe_mode", "flip"]
    j_first = _run(jserve, common + ["--engine", "xla", "--index_path",
                                     str(workdir / "j.npz")], capsys)
    t_back = _run(tserve, common + ["--device", "cpu", "--index_path",
                                    str(workdir / "j.npz")], capsys)
    assert t_back["engine"] == "gather"
    assert t_back["query_size"] == j_first["query_size"]
    assert abs(t_back["recall_at_k"] - j_first["recall_at_k"]) <= 0.005
    t_first = _run(tserve, common + ["--device", "cpu", "--engine", "gather",
                                     "--index_path", str(workdir / "t.npz")],
                   capsys)
    j_back = _run(jserve, common + ["--index_path", str(workdir / "t.npz")],
                  capsys)
    assert j_back["engine"] == "xla"
    assert j_back["query_size"] == t_first["query_size"]


def test_ensemble_is_detected_from_the_artifact(workdir, capsys):
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", 32, [32]), 6)
    jckpt.save_model(str(workdir / "ens"), jh,
                     init_multi_table(jh, 3, jax.random.PRNGKey(1)),
                     n_tables=3)
    argv = ["--model_path", str(workdir / "ens.json"), "--data_id",
            "synthetic", "--probe_mode", "flip", "--hash_times", "2",
            "--index_path", str(workdir / "ens_idx")]
    want = _run(jserve, argv[:-2] + ["--engine", "pallas-windowed"], capsys)
    got = _run(tserve, argv + ["--device", "cpu"], capsys)
    assert (workdir / "ens_idx.npz").exists()
    assert got["engine"] == "windowed" and set(got) == RESULT_KEYS
    assert got["query_size"] == want["query_size"]
    assert abs(got["recall_at_k"] - want["recall_at_k"]) <= 0.005
    hashings = tckpt.load_model(str(workdir / "ens"), device="cpu")
    data = get_data_by_id("synthetic", device="cpu").load()
    back = MultiTableIndexer.load(str(workdir / "ens_idx.npz"), hashings,
                                  data.training, device="cpu")
    assert back.n_tables == 3 and back.engine == "windowed"


def test_queries_file_and_sampled_probes(workdir, capsys):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(37, 32)).astype(np.float32)
    np.save(workdir / "q.npy", q)
    np.savez(workdir / "q.npz", anything=q)
    argv = ["--model_path", str(workdir / "model"), "--data_id", "synthetic",
            "--device", "cpu", "--batch", "16", "--seed", "3"]
    a = _run(tserve, argv + ["--queries", str(workdir / "q.npy")], capsys)
    b = _run(tserve, argv + ["--queries", str(workdir / "q.npz")], capsys)
    assert set(a) == RESULT_KEYS - {"recall_at_k"}     # no ground truth
    assert a["n_queries"] == 37 and a["query_size"] == b["query_size"]


def test_shards_is_refused_not_ignored(workdir, capsys):
    """``--shards 2 --device cpu`` serves a ShardedIndexer over a 2-entry
    CPU mesh and prints the JAX package's line (its run over 2 of the
    conftest's virtual devices): the same keys, ``n_queries``, ``k``,
    ``hash_times`` and ``query_size``, recall within 0.005, ids on >=
    0.98 of the slots; the index file it saves restores in both CLIs
    (the JAX one reads the port's engine name); an ensemble artifact is
    refused; bad engines and the parser's defaults as before."""
    common = ["--model_path", str(workdir / "model"), "--data_id",
              "synthetic", "--probe_mode", "flip", "--hash_times", "6",
              "--shards", "2"]
    want = _run(jserve, common + ["--engine", "xla",
                                  "--output", str(workdir / "j.npz")], capsys)
    got = _run(tserve, common + ["--device", "cpu", "--engine", "gather",
                                 "--index_path", str(workdir / "idx.npz"),
                                 "--output", str(workdir / "t.npz")], capsys)
    assert set(got) == set(want) == RESULT_KEYS | {"output"}
    for key in ("n_queries", "k", "hash_times", "query_size"):
        assert got[key] == want[key], key
    assert abs(got["recall_at_k"] - want["recall_at_k"]) <= 0.005
    with np.load(workdir / "t.npz") as t, np.load(workdir / "j.npz") as j:
        np.testing.assert_array_equal(t["n_candidates"], j["n_candidates"])
        assert (t["topk_ids"] == j["topk_ids"]).mean() >= 0.98
    back = _run(tserve, common + ["--device", "cpu", "--engine", "grouped",
                                  "--index_path", str(workdir / "idx.npz")],
                capsys)
    assert back["engine"] == "gather" and back["query_size"] == \
        got["query_size"]
    j_back = _run(jserve, common + ["--index_path", str(workdir / "idx.npz")],
                  capsys)
    assert j_back["engine"] == "xla"
    assert j_back["query_size"] == want["query_size"]
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", 32, [32]), 6)
    jckpt.save_model(str(workdir / "ens"), jh,
                     init_multi_table(jh, 2, jax.random.PRNGKey(1)),
                     n_tables=2)
    with pytest.raises(ValueError, match="ensemble"):
        tserve.main(["--model_path", str(workdir / "ens.json"), "--data_id",
                     "synthetic", "--device", "cpu", "--shards", "2"])
    with pytest.raises(SystemExit):
        tserve.main(["--model_path", "x", "--data_id", "synthetic",
                     "--engine", "pallas-dense"])
    args = tserve.nlsh_serve_argparse().parse_args(
        ["--model_path", "x", "--data_id", "y"])
    assert args.device == "cuda" and args.engine == "auto"
    assert args.pipeline == 4 and args.hash_times == 10 and args.k == 10
    j_args = jserve.nlsh_serve_argparse().parse_args(
        ["--model_path", "x", "--data_id", "y"])
    assert set(vars(args)) == set(vars(j_args)) | {"device"}


# -- the request loop ---------------------------------------------------------

def _stream(rng, dim, sizes):
    lines, batches = [], {}
    for rid, n in enumerate(sizes):
        q = rng.normal(size=(n, dim)).astype(np.float32)
        batches[rid] = q
        lines.append(json.dumps({"id": rid, "queries": q.tolist()}))
    lines.insert(2, "this is not json")
    lines.insert(4, json.dumps({"id": "narrow", "queries": [[1.0, 2.0]]}))
    lines.insert(5, "")                                  # blank: skipped
    lines.insert(6, json.dumps({"id": "nokey"}))
    return "\n".join(lines) + "\n", batches


def test_serve_loop_matches_the_jax_loop(workdir):
    data = get_data_by_id("synthetic", device="cpu").load()
    jh, params = jckpt.load_model(str(workdir / "model"))
    th = tckpt.load_model(str(workdir / "model"), device="cpu")
    from nlsh_tpu.index import Indexer as JIndexer

    ji = JIndexer(jh, params, jax.numpy.asarray(data.training), engine="xla")
    ti = Indexer(th, data.training, device="cpu", engine="gather")
    sizes = [1, 3, 8, 9, 17, 5, 64, 2]
    text, batches = _stream(np.random.default_rng(1), 32, sizes)
    args = tserve.nlsh_serve_argparse().parse_args(
        ["--model_path", "x", "--data_id", "synthetic", "--device", "cpu",
         "--hash_times", "6", "--pipeline", "2"])
    extra = {"probe_mode": "flip"}

    shapes = []
    real_async = ti.query_async

    def spy(q, **kw):
        shapes.append(q.shape[0])
        return real_async(q, **kw)

    ti.query_async = spy
    t_out, j_out = io.StringIO(), io.StringIO()
    t_stats = tserve.serve_loop(args, ti, extra, 32, stdin=io.StringIO(text),
                                stdout=t_out)
    j_stats = jserve.serve_loop(args, ji, jax.random.PRNGKey(0), extra, 32,
                                stdin=io.StringIO(text), stdout=j_out)
    # every request padded to a power of two, at least 8
    assert shapes == [8, 8, 8, 16, 32, 8, 64, 8]

    t_lines = [json.loads(line) for line in t_out.getvalue().splitlines()]
    j_lines = [json.loads(line) for line in j_out.getvalue().splitlines()]
    assert len(t_lines) == len(j_lines) == len(sizes) + 3 + 1
    assert [a.get("id") for a in t_lines[:-1]] == \
        [a.get("id") for a in j_lines[:-1]] == \
        [0, 1, None, 2, "narrow", "nokey", 3, 4, 5, 6, 7]
    for got, want in zip(t_lines[:-1], j_lines[:-1]):
        assert set(got) == set(want)
        if "error" in want:
            assert set(got) == {"id", "error"}
            continue
        assert set(got) == {"id", "topk_ids", "n_candidates", "latency_ms"}
        n = sizes[got["id"]]
        ids = np.asarray(got["topk_ids"])
        assert ids.shape == (n, 10) and len(got["n_candidates"]) == n
        assert got["n_candidates"] == want["n_candidates"]
        assert (ids == np.asarray(want["topk_ids"])).mean() >= 0.98
        # ... and each answer is what the index says of the same rows
        direct, cand = ti.query(batches[got["id"]], k=10, hash_times=6,
                                probe_mode="flip")
        np.testing.assert_array_equal(ids, direct)
        assert got["n_candidates"] == cand.tolist()
    assert "expected (n, 32) queries" in t_lines[4]["error"]
    assert t_lines[4]["error"] == j_lines[4]["error"]
    assert t_lines[5]["error"] == j_lines[5]["error"]

    assert set(t_lines[-1]) == {"stats"}
    assert t_lines[-1]["stats"] == t_stats
    assert set(j_stats) == STATS_KEYS
    assert set(t_stats) == STATS_KEYS | {"serve"}  # the index's serve_stats
    assert t_stats["serve"]["graphs"]["captures"] == 0  # on the CPU
    assert t_stats["batches"] == j_stats["batches"] == len(sizes)
    assert t_stats["n_queries"] == j_stats["n_queries"] == sum(sizes)
    assert t_stats["engine"] == "gather"
    assert t_stats["latency_ms_p50"] <= t_stats["latency_ms_p95"] \
        <= t_stats["latency_ms_max"]


def test_serve_loop_sampled_probes_do_not_depend_on_what_came_before(workdir):
    """One seed serves every request (as one PRNG key does in the JAX
    package): a request's answer is the same wherever it stands in the
    stream."""
    data = get_data_by_id("synthetic", device="cpu").load()
    th = tckpt.load_model(str(workdir / "model"), device="cpu")
    ti = Indexer(th, data.training, device="cpu", engine="gather")
    args = tserve.nlsh_serve_argparse().parse_args(
        ["--model_path", "x", "--data_id", "synthetic", "--device", "cpu",
         "--seed", "7"])
    q = np.random.default_rng(2).normal(size=(8, 32)).astype(np.float32)
    req = json.dumps({"id": "a", "queries": q.tolist()})
    other = json.dumps({"id": "b", "queries": (q[::-1] * 2).tolist()})
    out1, out2 = io.StringIO(), io.StringIO()
    tserve.serve_loop(args, ti, {"probe_mode": "sample"}, 32,
                      stdin=io.StringIO(req + "\n"), stdout=out1)
    tserve.serve_loop(args, ti, {"probe_mode": "sample"}, 32,
                      stdin=io.StringIO(other + "\n" + req + "\n"),
                      stdout=out2)
    first = json.loads(out1.getvalue().splitlines()[0])
    later = json.loads(out2.getvalue().splitlines()[1])
    assert first["id"] == later["id"] == "a"
    assert first["topk_ids"] == later["topk_ids"]
    assert first["n_candidates"] == later["n_candidates"]


def test_loop_flag_reads_stdin_and_ends_with_stats(workdir, capsys,
                                                   monkeypatch):
    q = np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        json.dumps({"id": 1, "queries": q.tolist()}) + "\nnot json\n"))
    capsys.readouterr()
    stats = tserve.main(["--model_path", str(workdir / "model"), "--data_id",
                         "synthetic", "--device", "cpu", "--loop",
                         "--probe_mode", "flip"])
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    assert [set(line) for line in lines] == [
        {"id", "topk_ids", "n_candidates", "latency_ms"}, {"id", "error"},
        {"stats"}]
    assert lines[-1]["stats"] == stats and stats["n_queries"] == 3
    assert torch.tensor(lines[0]["topk_ids"]).shape == (3, 10)
