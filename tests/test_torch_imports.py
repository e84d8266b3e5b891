"""The port stands alone: importing every ``nlsh_tpu_torch`` module, in
a fresh interpreter, pulls in neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import nlsh_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nlsh_tpu_torch.__path__,
                                               "nlsh_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "nlsh_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("ops.packing", "ops.distances", "ops.cuda.query_kernel",
                 "ops.cuda.build", "ops.cuda.bounds", "models.encoders",
                 "models.hashings",
                 "index.bucket_table", "index.indexer", "index.query",
                 "index.serving", "parallel", "parallel.multitable",
                 "parallel.mesh", "parallel.multihost", "parallel.dp",
                 "parallel.sharded_index",
                 "utils.checkpoint", "utils.metrics", "utils.fingerprint",
                 "utils.env", "ops.knn", "data", "data.datasets",
                 "data.binformats", "data.configs", "cli", "cli.serve",
                 "tools.topk_phases",
                 "tools.panel_variants", "tools.fixed_events",
                 "ops.code_distances", "utils.loggers", "train", "train.base",
                 "train.triplet", "train.siamese", "train.proposed",
                 "train.ae", "train.vqvae", "train.multitable", "cli.train",
                 "cli.precompute", "cli.evaluate", "native", "train.hnsw",
                 "utils.profiling"):
        assert f"nlsh_tpu_torch.{name}" in report["modules"]


def test_last_public_names_exist():
    """The names that came last, beside the JAX package's."""
    from nlsh_tpu_torch.models import TwoLayer256Relu
    from nlsh_tpu_torch.ops.code_distances import (
        cross_entropy_multivariate_bernoulli, hellinger_categorical)

    assert TwoLayer256Relu(25).output_dim == 256
    for fn in (hellinger_categorical, cross_entropy_multivariate_bernoulli):
        assert callable(fn)
