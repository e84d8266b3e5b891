"""Inverted-list index: CSR bucket table, gather and grouped engines."""

from nlsh_tpu_torch.index.bucket_table import BucketTable, build_bucket_table  # noqa: F401
from nlsh_tpu_torch.index.query import query_bucket_table  # noqa: F401
from nlsh_tpu_torch.index.indexer import Indexer, hash_corpus  # noqa: F401
