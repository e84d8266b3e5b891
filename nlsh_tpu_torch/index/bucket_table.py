"""Dense CSR bucket table — the inverted-list index.

Port of :mod:`nlsh_tpu.index.bucket_table`: a bucket's members are
``row_ids[starts[b] : starts[b] + counts[b]]``, with ``row_ids`` the
corpus rows in bucket order from a **stable** argsort (rows within a
bucket keep corpus order) and ``counts`` from a ``bincount``.  All three
arrays are int32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BucketTable(NamedTuple):
    row_ids: torch.Tensor  # (n,) int32 corpus rows sorted by bucket id
    starts: torch.Tensor   # (n_buckets,) int32
    counts: torch.Tensor   # (n_buckets,) int32

    @property
    def n_rows(self) -> int:
        return self.row_ids.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.starts.shape[0]

    def max_count(self) -> int:
        return int(self.counts.max())

    def n_nonempty(self) -> int:
        return int((self.counts > 0).sum())

    def occupancy_std(self) -> float:
        """Std of the occupied buckets' sizes."""
        c = self.counts[self.counts > 0].to(torch.float32)
        if c.numel() == 0:
            return 0.0
        return float(torch.sqrt(torch.mean((c - c.mean()) ** 2)))


def build_bucket_table(bucket_ids: torch.Tensor, n_buckets: int,
                       device=None) -> BucketTable:
    """CSR table from per-row hard bucket ids.  Ids outside
    ``[0, n_buckets)`` (the sentinel of a deleted row) are left out of
    every bucket, like the JAX package's ``mode="drop"`` scatter."""
    ids = bucket_ids.to(device=device, dtype=torch.int64)
    in_range = (ids >= 0) & (ids < n_buckets)
    counts = torch.bincount(torch.where(in_range, ids, n_buckets),
                            minlength=n_buckets + 1)[:n_buckets]
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(ids, stable=True)
    return BucketTable(row_ids=order.to(torch.int32),
                       starts=starts.to(torch.int32),
                       counts=counts.to(torch.int32))
