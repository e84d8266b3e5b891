"""A toy benchmark root for the CPU tests: a small deployment of the
same cluster model, random SIREN heads written as flax msgpack, and a
manifest naming one configuration, one traffic mix and one cell, with
the real per-layer metric files beside them."""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
CELL = "toy.cell"

DEPLOYMENT = {"n_corpus": 3000, "dim": 100, "n_test": 256,
              "n_clusters": 64, "cluster_noise": 0.35, "seed": 0,
              "metric": "cosine"}


def siren_tree(rng, dim: int, hidden, bits: int, n_tables: int = 1):
    """Random SIREN-head params in the JAX layout (``w`` as ``(fan_in,
    fan_out)``), stacked on a leading table axis when ``n_tables > 1``."""
    widths = [dim, *hidden]

    def u(bound, shape):
        lead = () if n_tables == 1 else (n_tables,)
        return rng.uniform(-bound, bound, lead + shape).astype(np.float32)

    layers = {}
    for i, (fi, fo) in enumerate(zip(widths, widths[1:])):
        bound = 1.0 / fi if i == 0 else math.sqrt(6.0 / fi)
        layers[str(i)] = {"b": u(bound, (fo,)), "w": u(bound, (fi, fo))}
    bound = 1.0 / math.sqrt(widths[-1])
    return {"encoder": {"layers": layers},
            "out": {"b": u(bound, (bits,)), "w": u(bound, (widths[-1], bits))}}


def config(n_tables: int = 1, hash_times: int = 4, budget=None,
           engine: str | None = None) -> dict:
    return {
        "name": "toy", "reduced": [], "deployment": dict(DEPLOYMENT),
        "hashing": {"head": "MultivariateBernoulli", "encoder": "siren",
                    "hidden": [32, 32], "w0": 1.0, "w0_initial": 30.0,
                    "hash_size": 6, "n_tables": n_tables,
                    "params_key": None if n_tables == 1 else "hashing"},
        "params": {"file": "portbench/data/toy.msgpack"},
        "serving": {"engine": engine or ("grouped" if n_tables == 1
                                         else "windowed"),
                    "probe_budget": budget, "serving_dtype": "float32",
                    "hash_times": hash_times, "probe_mode": "flip",
                    "calibrate": n_tables > 1},
        "system": "nlsh_index", "reference": "lsh",
        "scoring_kernels": ["grouped_topk_kernel", "panel_kernel"],
    }


TRAFFIC = {"loop": "closed", "clients": 1, "batch": 64, "k": 10,
           "pool_batches": 3}
# the real cells' limits on the numbers compared, judged over fewer
# queries
with open(os.path.join(BENCH, "limits", "glove100-mvb12.b10k.json")) as _f:
    LIMITS = {"judged_batches": 2, "judged_queries": 128,
              "numbers": json.load(_f)["numbers"]}


def make_root(root: str, cfg: dict | None = None,
              traffic: dict | None = None, limits: dict | None = None,
              seed: int = 0) -> str:
    """Write a toy benchmark under ``root``; returns ``root``."""
    from nlsh_tpu_torch.utils.checkpoint import write_msgpack

    cfg = cfg or config()
    bench = os.path.join(root, "portbench")
    for sub in ("configs", "traffic", "limits", "data"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    h = cfg["hashing"]
    tree = siren_tree(np.random.default_rng(seed), cfg["deployment"]["dim"],
                      h["hidden"], h["hash_size"], h["n_tables"])
    params = os.path.join(root, cfg["params"]["file"])
    write_msgpack(params, tree if h["params_key"] is None
                  else {"hashing": tree})
    with open(params, "rb") as f:
        cfg = dict(cfg, params=dict(
            cfg["params"], sha256=hashlib.sha256(f.read()).hexdigest()))
    with open(os.path.join(bench, "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "toy.json"), "w") as f:
        json.dump(traffic or TRAFFIC, f)
    with open(os.path.join(bench, "limits", f"{CELL}.json"), "w") as f:
        json.dump(limits or LIMITS, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    manifest = {
        "command": real["command"], "paths": ["portbench"],
        "run_seconds": real["run_seconds"],
        "configs": [{"name": "toy", "source": "toy",
                     "file": "portbench/configs/toy.json", "reduced": [],
                     "why": "toy"}],
        "workloads": [{"name": CELL, "config": "toy", "traffic": "toy",
                       "chips": 1, "why": "toy"}],
        "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=[CELL]) for m in real["per_layer"]],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root
