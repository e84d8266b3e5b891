"""What the tools and ``chip_smoke.py`` share: the bench's committed
hashing heads, their flip probes on the card, and CUDA-event timing.

The params are read from the repository's committed artifacts
(:mod:`nlsh_tpu_torch.data.workloads` names them).
"""

from __future__ import annotations

import os

import numpy as np

from nlsh_tpu_torch.data import workloads as wl

# the repository's root: the committed artifacts lie under it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARAMS = wl.artifact_path(wl.params_file(), ROOT)
GT = wl.artifact_path(wl.gt_file(), ROOT)
ENSEMBLE_PARAMS = wl.artifact_path(wl.ensemble_params_file(), ROOT)
# the committed artifacts: the bench's params and exact GT, the L=8 params
ARTIFACTS = (PARAMS, GT, ENSEMBLE_PARAMS)


def bench_head():
    """A fresh head of the bench's shape: 12-bit MultivariateBernoulli on
    a SIREN 100-256-256 trunk."""
    from nlsh_tpu_torch.models import get_encoder, get_hashing

    return get_hashing("MultivariateBernoulli",
                       get_encoder(wl.TRAIN_CFG["encoder"], wl.DIM,
                                   list(wl.TRAIN_CFG["hidden"])),
                       wl.HASH_SIZE)


def load_hashing():
    """The bench's head with its committed trained params."""
    from nlsh_tpu_torch.utils.checkpoint import params_from_jax, read_msgpack

    return params_from_jax(bench_head(), read_msgpack(PARAMS))


def load_ensemble():
    """The L=8 ensemble's eight heads with their committed params."""
    from nlsh_tpu_torch.utils.checkpoint import (
        read_msgpack,
        stacked_params_from_jax,
    )

    return stacked_params_from_jax(
        bench_head, read_msgpack(ENSEMBLE_PARAMS)["hashing"])


def bench_index(corpus: np.ndarray):
    """The bench's single table on the card: an ``Indexer`` of ``corpus``
    under the committed head, cosine, probe budget ``wl.CAP``."""
    from nlsh_tpu_torch.index import Indexer

    return Indexer(load_hashing(), corpus, device="cuda", metric="cosine",
                   probe_budget=wl.CAP)


def flip_probes(idx, queries: np.ndarray):
    """``(q, probe ids, probe valid)``: the single table's queries on its
    device and their flip probes."""
    import torch

    q = torch.as_tensor(queries, device=idx.device)
    with torch.no_grad():
        pid, pv = idx.hashing.hash(q, n_probes=wl.HASH_TIMES,
                                   probe_mode="flip")
    return q, pid, pv


def flat_flip_probes(midx, queries: np.ndarray):
    """The ensemble's flip probes as ids into its flat layout."""
    import torch

    q = torch.as_tensor(queries, device=midx.device)
    with torch.no_grad():
        return midx._flat_probes(*midx._probes(q, wl.ENSEMBLE_HASH_TIMES,
                                               probe_mode="flip"))


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs, after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
