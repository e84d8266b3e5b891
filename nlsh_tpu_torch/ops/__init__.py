"""Tensor ops of the port: bit packing, data metrics and the serving kernels."""
