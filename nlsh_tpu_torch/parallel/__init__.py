"""Multi-table ensembles (L learned hash tables over one corpus)."""

from nlsh_tpu_torch.parallel.multitable import (  # noqa: F401
    MultiTableIndexer,
    init_multi_table,
)
