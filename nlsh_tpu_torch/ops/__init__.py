"""Tensor ops of the port: bit packing, data metrics and the serving kernels."""

from nlsh_tpu_torch.ops import distances, code_distances, packing, knn  # noqa: F401
