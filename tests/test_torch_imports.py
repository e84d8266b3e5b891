"""The port stands alone: importing every ``nlsh_tpu_torch`` module, in
a fresh interpreter, pulls in neither JAX nor the JAX package nor its
bench; no file of the port imports them, at any depth; and the port has
every public name of the JAX package."""

import ast
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch is imported first; from then on every process started and every
# shared library loaded is recorded: a kernel build runs a compiler, and
# a built kernel or the native library is loaded with ctypes
_PROBE = """
import ctypes, importlib, json, pkgutil, subprocess, sys
import torch
spawned, loaded = [], []
_popen, _cdll = subprocess.Popen.__init__, ctypes.CDLL.__init__
def popen(self, args, *a, **kw):
    spawned.append(str(args))
    return _popen(self, args, *a, **kw)
def cdll(self, name, *a, **kw):
    loaded.append(str(name))
    return _cdll(self, name, *a, **kw)
subprocess.Popen.__init__, ctypes.CDLL.__init__ = popen, cdll
import nlsh_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nlsh_tpu_torch.__path__,
                                               "nlsh_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "nlsh_tpu", "bench", "benchmarks"))
print(json.dumps({"modules": names, "bad": bad, "spawned": spawned,
                  "loaded": loaded,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    # importing the port builds nothing, loads no library and leaves CUDA
    # uninitialised (forked CLI and gloo children start cleanly)
    assert report["spawned"] == []
    assert report["loaded"] == []
    assert report["cuda_initialized"] is False
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
                 "data.workloads", "tools.common", "tools.topk_phases",
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


# every module the port may never import, at any depth: JAX and its
# libraries, and every top-level module of the repository but the port
_JAX_LIBS = {"jax", "jaxlib", "flax", "optax"}


def _root_modules() -> set:
    names = set()
    for entry in os.listdir(_ROOT):
        path = os.path.join(_ROOT, entry)
        if entry.endswith(".py"):
            names.add(entry[:-3])
        elif os.path.isfile(os.path.join(path, "__init__.py")):
            names.add(entry)
    return names - {"nlsh_tpu_torch"}


def _imported_roots(path: str) -> set:
    """The top-level module of every absolute import in ``path``, at any
    depth (inside functions too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files() -> list:
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(_ROOT, "nlsh_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_files_import_nothing_outside_the_port():
    forbidden = _JAX_LIBS | _root_modules()
    assert {"nlsh_tpu", "bench", "benchmarks", "train_anchor", "eval_anchor",
            "main", "serve", "eval", "precompute"} <= forbidden
    files = _port_files()
    assert len(files) > 50
    bad = {os.path.relpath(p, _ROOT): sorted(_imported_roots(p) & forbidden)
           for p in files}
    assert {p: r for p, r in bad.items() if r} == {}


# the JAX package's public names the port leaves out, one reason each
_NOT_PORTED = {
    "Array": "a JAX typing alias",
    "Params": "a JAX typing alias",
    "shard_map": "JAX's own",
    "PACK_W": "ROADMAP 'Not to port': the TPU's panel packing",
    "windowed_exact_bound": "ROADMAP 'Not to port': counted on the device",
    "HAVE_NATIVE": "ROADMAP 'Not to port': the native fallback flag",
    "build_csr_ffi": "ROADMAP 'Not to port': the XLA FFI half of native",
    "pack_dedupe_ffi": "ROADMAP 'Not to port': the XLA FFI half of native",
    "trace": "utils.profiling: the callers run torch.profiler themselves; "
             "the serve marks its layers and host spans instead",
}
_NOT_PORTED_MODULES = {
    "index/canary.py": "ROADMAP 'Not to port': an XLA-TPU miscompile guard",
}


def _public_names(path: str) -> set:
    """The module's top-level public names, read with ``ast``: its
    functions, classes and assignments (under a top-level ``if`` or
    ``try`` too) and, in a package's ``__init__``, what it re-exports
    from the package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    init = os.path.basename(path) == "__init__.py"
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names.update(n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif (init and isinstance(node, ast.ImportFrom)
                  and (node.level > 0 or node.module.split(".")[0]
                       == "nlsh_tpu")):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, *(h.body for h in node.handlers),
                             node.orelse, node.finalbody):
                    visit(part)

    visit(tree.body)
    return {n for n in names if not n.startswith("_")}


def _counterparts() -> list:
    """``(JAX package file, its counterpart module in the port)``."""
    pkg = os.path.join(_ROOT, "nlsh_tpu")
    out = []
    for dirpath, _, names in os.walk(pkg):
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), pkg)
            if rel in _NOT_PORTED_MODULES:
                continue
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            parts = ["cuda" if p == "pallas" else p for p in parts]
            out.append((rel, ".".join(["nlsh_tpu_torch", *parts])))
    return sorted(out)


def test_port_has_every_public_name_of_the_jax_package():
    import importlib

    pairs = _counterparts()
    assert len(pairs) >= 45
    missing = {}
    for rel, module in pairs:
        port = importlib.import_module(module)
        want = _public_names(os.path.join(_ROOT, "nlsh_tpu", rel))
        lost = sorted(n for n in want - set(_NOT_PORTED)
                      if not hasattr(port, n))
        if lost:
            missing[module] = lost
    assert missing == {}
    # the exclusions stay live: each is still a name of the JAX package
    everywhere = set().union(*(_public_names(os.path.join(
        _ROOT, "nlsh_tpu", rel)) for rel, _ in pairs))
    assert set(_NOT_PORTED) <= everywhere
    for rel in _NOT_PORTED_MODULES:
        assert os.path.isfile(os.path.join(_ROOT, "nlsh_tpu", rel))
