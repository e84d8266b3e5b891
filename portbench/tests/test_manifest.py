"""``BENCHMARK.json`` against the benchmark's contract, the files it
names, the committed params' copies, and the data-driven harness: a
configuration, a traffic mix and a per-layer metric added as new files
only."""

import hashlib
import json
import os
import re
import shutil

import pytest

from portbench import run
from portbench.manifest import Manifest
from portbench.tests import toy

REPO = toy.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_contract_keys_names_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    assert all(_text(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["why"]) \
            and _text(c["source"]) and c["reduced"] == []
        assert c["file"].startswith(b["paths"][0] + "/")
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _text(w["why"])
        used.add(w["config"])
    assert used == names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and _text(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # a metric's cells report the end-to-end metric it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = {n for n, m in e2e.items()
                    if cell in m.get("workloads", [cell])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in b[k]]
    assert len(all_names) == len(set(all_names))


def test_every_cell_finds_its_files():
    m = Manifest(REPO)
    for w in m.data["workloads"]:
        cfg = m.config(w["config"])
        traffic = m.traffic(w["traffic"])
        limits = m.limits(w["name"])
        assert traffic["loop"] == "closed" and traffic["clients"] == 1
        assert set(limits["numbers"]) <= set(run.NUMBERS)
        assert limits["judged_queries"] <= \
            limits["judged_batches"] * traffic["batch"]
        assert os.path.exists(m.path(cfg["params"]["file"]))
        assert cfg["scoring_kernels"]
        assert m.per_layer(w["name"]) and m.end_to_end(w["name"])
    for entry in m.data["per_layer"]:
        meta = m.metric_module(entry["name"]).META
        assert meta == {k: entry[k] for k in meta}, entry["name"]


def test_params_copies_are_the_committed_files():
    m = Manifest(REPO)
    for c in m.data["configs"]:
        p = m.config(c["name"])["params"]
        digests = {hashlib.sha256(open(m.path(f), "rb").read()).hexdigest()
                   for f in (p["file"], p["copied_from"])}
        assert digests == {p["sha256"]}


def test_a_run_refuses_other_params(tmp_path):
    root = toy.make_root(str(tmp_path))
    with open(tmp_path / "portbench" / "data" / "toy.msgpack", "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="sha256"):
        run.run_cell(root, toy.CELL, 1, 0.1, False, device="cpu",
                     cache_dir=None)


METRIC = '''"""toy: the traced batches."""

META = {"unit": "count", "better": "higher", "source": "device_trace",
        "layer": "device", "moves": "qps"}


def read(ctx):
    return ctx.n_batches
'''


def test_new_entries_are_new_files_only(tmp_path):
    root = toy.make_root(str(tmp_path))
    bench = tmp_path / "portbench"
    before = {p: open(p, "rb").read() for p in (
        str(x) for x in bench.rglob("*") if x.is_file())}
    # a second configuration (an ensemble), a second mix, a new metric
    cfg = toy.config(n_tables=2, hash_times=2)
    cfg["params"] = dict(cfg["params"], file="portbench/data/toy2.msgpack")
    sub = toy.make_root(str(tmp_path / "scratch"), cfg)
    shutil.copy(os.path.join(sub, cfg["params"]["file"]),
                bench / "data" / "toy2.msgpack")
    shutil.copy(os.path.join(sub, "portbench", "configs", "toy.json"),
                bench / "configs" / "toy2.json")
    (bench / "traffic" / "toy-k20.json").write_text(json.dumps(
        dict(toy.TRAFFIC, k=20, batch=32)))
    (bench / "limits" / "toy2.k20.json").write_text(json.dumps(
        dict(toy.LIMITS, judged_queries=64)))
    (bench / "metrics" / "toy_batches.py").write_text(METRIC)
    assert all(open(p, "rb").read() == data for p, data in before.items())
    with open(tmp_path / "BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": "toy2", "source": "toy",
                         "file": "portbench/configs/toy2.json",
                         "reduced": [], "why": "toy"})
    b["workloads"].append({"name": "toy2.k20", "config": "toy2",
                           "traffic": "toy-k20", "chips": 1, "why": "toy"})
    b["per_layer"].append({"name": "toy_batches", "unit": "count",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "qps",
                           "workloads": ["toy2.k20"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    res = run.run_cell(root, "toy2.k20", 3, 0.4, True, device="cpu",
                       cache_dir=None)
    assert res["correct"]
    assert res["metrics"]["toy_batches"]["value"] > 0
    res = run.run_cell(root, "toy2.k20", 3, 0.2, False, device="cpu",
                       cache_dir=None)
    assert set(res["metrics"]) == {"qps", "batch_p95_ms", "device_mem_gib",
                                   "setup_s"}
    assert res["correct"]


NOTHING = '''"""toy: a reader that finds nothing."""

META = {"unit": "count", "better": "higher", "source": "device_trace",
        "layer": "device", "moves": "qps"}


def read(ctx):
    return None
'''


def test_a_listed_metric_that_reads_nothing_fails_the_run(tmp_path):
    root = toy.make_root(str(tmp_path))
    (tmp_path / "portbench" / "metrics" / "toy_nothing.py").write_text(
        NOTHING)
    with open(tmp_path / "BENCHMARK.json") as f:
        b = json.load(f)
    b["per_layer"] = [{"name": "toy_nothing", "unit": "count",
                       "better": "higher", "source": "device_trace",
                       "layer": "device", "moves": "qps",
                       "workloads": [toy.CELL]}]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    with pytest.raises(RuntimeError, match="toy_nothing"):
        run.run_cell(root, toy.CELL, 2, 0.2, True, device="cpu",
                     cache_dir=None)
