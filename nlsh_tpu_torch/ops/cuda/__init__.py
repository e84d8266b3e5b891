"""The serving path's layout, grouped prep and CUDA kernels."""

from nlsh_tpu_torch.ops.cuda.query_kernel import (  # noqa: F401
    bucket_scores,
    serving_layout,
    ServingLayout,
)
