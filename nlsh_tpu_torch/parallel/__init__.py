"""Multi-table ensembles (L learned hash tables over one corpus)."""

from nlsh_tpu_torch.parallel.multitable import MultiTableIndexer  # noqa: F401
