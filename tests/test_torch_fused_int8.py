"""Port parity of the one-dispatch serve on a per-row int8 layout:
``_fused_serve`` of the port against the JAX package's, bitwise at flip
probes, on the grouped, windowed and fixed-cap engines (euclidean, so
the per-row scales and the norms both apply; the layouts' bytes equal
first).  The f32 cases and the helpers are in
``tests/test_torch_fused.py``."""

import pytest

from torch_fused_common import check_fused_serve_matches_jax


@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed"])
def test_fused_serve_matches_jax_bitwise_int8(engine):
    check_fused_serve_matches_jax(engine, int8=True)
