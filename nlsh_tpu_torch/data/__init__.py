"""Datasets: ann-benchmarks hdf5 readers, big-ann binary readers and
synthetic data."""

from nlsh_tpu_torch.data.binformats import (  # noqa: F401
    BigBinaryDataset,
    read_bin,
    read_bin_header,
    read_gt_bin,
    write_bin,
    write_gt_bin,
)
from nlsh_tpu_torch.data.datasets import (  # noqa: F401
    Dataset,
    Glove,
    SIFT,
    SyntheticDataset,
    get_data_by_id,
)
