"""nlsh_tpu_torch — the PyTorch + CUDA port of :mod:`nlsh_tpu`.

The JAX package stays the reference; this package mirrors its module
names (``ops``, ``models``, ``index``, ``parallel``, ``data``, ``utils``,
``cli``) so each counterpart is
easy to find, and is held to it by the ``tests/test_torch_*.py`` parity
tests.  It imports ``torch`` and never ``jax`` or ``nlsh_tpu``.

The serving path's Pallas kernels become hand-written CUDA C++ for
Hopper (``csrc/``), built on first use by :mod:`nlsh_tpu_torch.ops.cuda.build`
and called through :mod:`nlsh_tpu_torch.ops.cuda.query_kernel`.  Each
kernel keeps a plain PyTorch version beside it, which runs for tensors
on the CPU.
"""

__version__ = "0.1.0"

from nlsh_tpu_torch import ops, models, index, data, utils  # noqa: F401,E402
