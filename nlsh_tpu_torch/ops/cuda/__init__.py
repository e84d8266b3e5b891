"""The serving path's layout, grouped prep and CUDA kernels."""
