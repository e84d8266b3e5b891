"""Device meshes and the collectives the multi-device paths use.

Port of :mod:`nlsh_tpu.parallel.mesh`.  A :class:`Mesh` is a 1-D tuple of
``torch.device`` entries under one axis name:

* ``"data"``  — batch sharding for data-parallel training,
* ``"shard"`` — corpus / bucket-table sharding for the index,
* ``"table"`` — multi-table ensemble sharding.

The JAX package shards with ``shard_map`` and reduces with XLA
collectives.  Here every per-entry computation is an ordinary torch call
on the entry's device, and the three collectives the JAX code uses are
plain functions of the per-entry tensors (:func:`all_gather`,
:func:`psum`, :func:`pmean`).  They reduce the process's own entries in
entry order on the first entry's device; when a ``torch.distributed``
process group is initialised (:mod:`nlsh_tpu_torch.parallel.multihost`)
they then call ``torch.distributed.all_gather`` / ``all_reduce`` across
the processes.  Entry ``i`` of process ``r`` is global entry ``r *
mesh.size + i`` (:meth:`Mesh.global_index`).

On a mesh whose entries all name one device, in a single process
(:meth:`Mesh.on_one_device`), the three collectives are plain ops on
that device, so a whole D-entry program can be captured as one CUDA
graph: the data-parallel step (:mod:`~nlsh_tpu_torch.parallel.dp`), the
sharded serve (:mod:`~nlsh_tpu_torch.parallel.sharded_index`) and the
table-sharded ensemble's serve (:mod:`~nlsh_tpu_torch.parallel.
multitable`) replay one on such a CUDA mesh.  Meshes over several
devices or processes (whose ``gloo`` collectives a graph cannot capture)
run those programs eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def process_count() -> int:
    """Processes in the initialised process group, else 1."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the initialised process group, else 0."""
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Mesh:
    """A 1-D mesh: the devices of this process's entries and an axis name.

    Built by hand, a mesh may name one device more than once: each entry
    then computes on that device in turn, as distinct devices would, and
    the collectives combine the entries as they would across devices.
    That is how a single card runs the 4-shard index and its cross-shard
    merge (``Mesh(["cuda:0"] * 4, "shard")``), and how the CPU tests run
    2-8 entries (:func:`make_mesh` with ``platform="cpu"``).
    """

    def __init__(self, devices, axis: str = "data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices share one platform, got {kinds}")
        self.axis = axis

    @property
    def size(self) -> int:
        """Entries of this process."""
        return len(self.devices)

    @property
    def platform(self) -> str:
        return self.devices[0].type

    def global_size(self) -> int:
        """Entries over every process of the process group."""
        return self.size * process_count()

    def on_one_device(self) -> bool:
        """Whether every entry names the same device and this is the only
        process: the collectives are then ops on that one device, and a
        D-entry program can be captured whole."""
        return len(set(self.devices)) == 1 and process_count() == 1

    def global_index(self, i: int) -> int:
        """The global index of this process's entry ``i``."""
        return process_index() * self.size + i

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: int | None = None, axis: str = "data",
              platform: str = "cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` entries named ``axis``.

    ``platform="cuda"`` takes the first ``n_devices`` distinct cards
    (default: every visible card) and raises when more are asked for than
    ``torch.cuda.device_count()`` gives (several processes on one host
    each see their own cards through ``CUDA_VISIBLE_DEVICES``).
    ``platform="cpu"`` gives ``n_devices`` (default 1) entries of the CPU
    device: the counterpart of the JAX tests' virtual CPU devices."""
    if platform == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"requested {n} devices")
        return Mesh([torch.device("cpu")] * n, axis)
    if platform != "cuda":
        raise ValueError(f"unknown platform {platform!r} (cuda|cpu)")
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = available if n_devices is None else int(n_devices)
    if n < 1 or n > available:
        raise ValueError(
            f"requested {n} devices but only {available} available")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def all_gather(xs) -> torch.Tensor:
    """The entries' equal-shape tensors stacked in global entry order on
    the first entry's device: ``(global entries, ...)``."""
    out = torch.stack([x.to(xs[0].device) for x in xs])
    world = process_count()
    if world > 1:
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous())
        out = torch.cat(parts)
    return out


def psum(xs) -> torch.Tensor:
    """The sum of the entries' tensors, added in entry order on the first
    entry's device, then over the processes."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    if process_count() > 1:
        dist.all_reduce(acc)
    return acc


def pmean(xs) -> torch.Tensor:
    """:func:`psum` over the number of global entries, divided by a
    tensor filled on the device (a Python divisor is a reciprocal product
    on the card, a copied host tensor waits for the stream)."""
    total = psum(xs)
    n = torch.full((), float(len(xs) * process_count()), dtype=total.dtype,
                   device=total.device)
    return total / n
