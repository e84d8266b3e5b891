"""Child process of the port's multi-process test (run by
``tests/test_torch_multihost.py``; not a test module).

Joins a 2-process ``torch.distributed`` group (gloo) through
:func:`nlsh_tpu_torch.parallel.multihost.initialize_from_env` (the
environment variables the train CLI reads), then over a mesh of 2 CPU
entries per process (4 global entries):

* the JAX package's multi-host check: each entry's gradient of a toy
  quadratic loss on its local rows, ``psum``-ed across all entries, and
  the ``psum`` of the rows;
* a ``ShardedIndexer`` across the 4 global shards against the
  single-table ``Indexer`` built in the process;
* 6 data-parallel triplet steps (:func:`dp_losses`), which the parent
  holds to the same run on a 4-entry mesh in one process.

Results go to a JSON file for the parent to assert on.
"""

import json
import sys

import numpy as np
import torch

DIM, N = 8, 1021


def _head():
    from nlsh_tpu_torch.models import get_encoder, get_hashing

    h = get_hashing("MultivariateBernoulli", get_encoder("mlp", DIM, [16]), 5)
    return h.init(torch.Generator().manual_seed(0))


def _corpus():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(32, DIM))
    pts = centers[rng.integers(0, 32, N + 64)] + 0.3 * rng.normal(
        size=(N + 64, DIM))
    return pts[:N].astype(np.float32), pts[N:].astype(np.float32)


class _Data:
    def __init__(self):
        corpus, queries = _corpus()
        self.training, self.testing = corpus[:512], queries
        sim = self.training @ self.training.T
        np.fill_diagonal(sim, -np.inf)
        self.training_self_knn = np.argsort(-sim, axis=1, kind="stable")[
            :, :10].astype(np.int64)
        self.metric, self.prepared, self.dim = "cosine", True, DIM


def dp_losses(mesh, n_steps: int = 6) -> list[float]:
    """``n_steps`` data-parallel triplet steps (batch 64) on ``mesh`` from
    seeded params and arrays: the losses."""
    from nlsh_tpu_torch.parallel.dp import build_dp_segment_runner
    from nlsh_tpu_torch.train import TripletTrainer
    from nlsh_tpu_torch.train.base import extra_to

    data = _Data()
    tr = TripletTrainer(_head(), data, positive_k=5)
    state = tr.make_state({"hashing": tr.hashing, "extra": extra_to({}, "cpu")},
                          3e-3)
    rng = np.random.default_rng(1)
    n = n_steps * 64
    arrays = {"anchor": torch.from_numpy(rng.integers(0, 512, n)),
              "col": torch.from_numpy(rng.integers(0, 5, n)),
              "neg": torch.from_numpy(rng.integers(0, 512, n))}
    run = build_dp_segment_runner(tr, 64, mesh)
    _, losses = run(state, torch.from_numpy(data.training),
                    torch.from_numpy(data.training_self_knn), arrays, 0,
                    n_steps)
    return [float(x) for x in losses]


def main() -> None:
    out_path = sys.argv[1]
    torch.set_num_threads(1)
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh
    from nlsh_tpu_torch.parallel.mesh import (
        all_gather,
        process_count,
        process_index,
        psum,
    )
    from nlsh_tpu_torch.parallel.multihost import initialize_from_env

    initialized = initialize_from_env(platform="cpu")
    mesh = make_mesh(2, axis="data", platform="cpu")
    rank = process_index()
    # each entry's 4 local rows, all of value rank + 1
    local = [torch.full((4, 2), float(rank + 1)) for _ in mesh.devices]
    w = torch.tensor([2.0, -1.0], requires_grad=True)
    grads = [torch.autograd.grad(torch.sum((x @ w) ** 2) / x.shape[0], w)[0]
             for x in local]
    grad = psum(grads)
    total = psum([x.sum() for x in local])
    ranks = all_gather([torch.tensor(mesh.global_index(i))
                        for i in range(mesh.size)])

    corpus, queries = _corpus()
    kw = dict(k=5, hash_times=4, probe_mode="flip")
    single = Indexer(_head(), corpus, device="cpu", engine="gather")
    s_ids, s_cand = single.query(queries, **kw)
    sharded = {}
    for engine in ("grouped", "gather"):
        idx = ShardedIndexer(_head(), corpus,
                             make_mesh(2, "shard", platform="cpu"),
                             engine=engine)
        ids, cand = idx.query(queries, **kw)
        sharded[engine] = {
            "n_shards": idx.n_shards, "n_local": idx.n_local,
            "ids_equal": float((ids == s_ids).mean()),
            "cand_equal": bool(np.array_equal(cand, s_cand)),
            "buckets_used": idx.n_buckets_used()}

    result = {
        "initialized": bool(initialized),
        "process_index": rank,
        "n_processes": process_count(),
        "n_global_devices": mesh.global_size(),
        "global_entries": ranks.tolist(),
        "grad": grad.tolist(),
        "psum": float(total),
        "sharded": sharded,
        "dp_losses": dp_losses(mesh),
    }
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
