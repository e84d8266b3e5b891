"""Multi-process initialisation from environment variables.

Port of :mod:`nlsh_tpu.parallel.multihost`.  One process per host (or
per group of cards) needs nothing: :func:`~nlsh_tpu_torch.parallel.mesh.
make_mesh` sees the local cards.  Across processes,
:func:`initialize_from_env` joins them in one ``torch.distributed``
process group; afterwards the mesh collectives
(:mod:`nlsh_tpu_torch.parallel.mesh`) reduce over every process's entries
and the same indexer and trainer code runs unchanged.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def initialize_from_env(platform: str = "cuda") -> bool:
    """Join a ``torch.distributed`` process group when the JAX package's
    environment variables ask for one.

    ``NLSH_COORDINATOR`` (``host:port`` of process 0),
    ``NLSH_NUM_PROCESSES`` and ``NLSH_PROCESS_ID`` give the rendezvous
    (``tcp://host:port``, the world size, this rank); with
    ``NLSH_AUTO_DISTRIBUTED=1`` instead, ``init_method="env://"`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The
    backend is ``nccl`` for a CUDA mesh and ``gloo`` for a CPU one
    (``platform``).  Returns True only when it initialised the group."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r} (cuda|cpu)")
    backend = "nccl" if platform == "cuda" else "gloo"
    coordinator = os.environ.get("NLSH_COORDINATOR")
    n_proc = os.environ.get("NLSH_NUM_PROCESSES")
    proc_id = os.environ.get("NLSH_PROCESS_ID")
    if coordinator and n_proc and proc_id:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(n_proc), rank=int(proc_id))
        return True
    if os.environ.get("NLSH_AUTO_DISTRIBUTED") == "1":
        dist.init_process_group(backend, init_method="env://")
        return True
    return False
