"""Multi-device layer: meshes and their collectives, the corpus-sharded
index, multi-table ensembles (plain or table-sharded); data-parallel
training is :mod:`nlsh_tpu_torch.parallel.dp` and multi-process
initialisation :mod:`nlsh_tpu_torch.parallel.multihost`."""

from nlsh_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from nlsh_tpu_torch.parallel.multitable import (  # noqa: F401
    MultiTableIndexer,
    init_multi_table,
)
from nlsh_tpu_torch.parallel.sharded_index import ShardedIndexer  # noqa: F401
