"""What the benchmark's modules import, read from their source with
``ast``, each import's top-level name compared whole: no module imports
JAX or the JAX package, the reference imports nothing of the program,
and nothing imports the JAX package's bench (``bench``,
``benchmarks``).  Also: a run's process holds none of them once its
window has closed."""

import ast
import os
import sys

from portbench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "optax", "nlsh_tpu"}
JAX_BENCH = {"bench", "benchmarks"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


def test_no_module_imports_jax_or_the_jax_bench():
    paths = list(_modules())
    assert len(paths) > 20
    for path in paths:
        names = set(_top_names(path))
        assert not names & JAX, (path, names & JAX)
        assert not names & JAX_BENCH, (path, names & JAX_BENCH)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            names = set(_top_names(os.path.join(ref, name)))
            assert names <= {"__future__", "math", "struct", "pathlib",
                             "typing", "numpy", "torch", "portbench"}, names


def test_the_names_are_compared_whole():
    assert "nlsh_tpu_torch".split(".")[0] not in JAX
    saved = dict(sys.modules)
    try:
        sys.modules["nlsh_tpu_torch_fake.x"] = sys
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        sys.modules["nlsh_tpu.index"] = sys
        assert run.forbidden_modules() == ["jax", "nlsh_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
