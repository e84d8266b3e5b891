"""The port's evaluation CLI (``python3 -m nlsh_tpu_torch.cli.evaluate``)
and ensemble sweep against ``nlsh_tpu.cli.evaluate`` on the CPU.

The parser has the JAX package's dests and defaults plus ``--device``,
and takes either package's engine names.  ``main`` on one model
artifact and one synthetic-dataset cache, in flip mode: the printed
``avg_n_candidates recall`` lines and the ``--json_out`` file are the
JAX ``main``'s, byte for byte, for a single-table and an ``n_tables``
artifact (the JAX package's ``auto`` engine off its accelerator is
``xla``, the port's is ``gather``)."""

import json

import jax
import pytest
import torch

from nlsh_tpu.cli import evaluate as jeval
from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu.utils import checkpoint as jckpt
from nlsh_tpu_torch.cli import evaluate as teval
from torch_eval_common import ENGINES


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A single-table artifact and a 2-table one, saved by the JAX
    package (MLP (32) heads of 8 bits)."""
    path = tmp_path_factory.mktemp("artifacts")
    jh = j_hashing("MultivariateBernoulli", j_encoder("mlp", 32, [32]), 8)
    jckpt.save_model(str(path / "single"), jh, jh.init(jax.random.PRNGKey(1)))
    jckpt.save_model(str(path / "ens"), jh,
                     init_multi_table(jh, 2, jax.random.PRNGKey(2)),
                     n_tables=2)
    return path


@pytest.fixture
def workdir(artifacts, monkeypatch):
    """The artifacts, and one dataset cache for both packages."""
    monkeypatch.setenv("NLSH_SYNTH_CACHE_DIR", str(artifacts / "cache"))
    return artifacts


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_package_s_dests_and_defaults():
    ours = _defaults(teval.nlsh_eval_argparse())
    assert ours.pop("device") == "cuda"
    assert ours == _defaults(jeval.nlsh_eval_argparse())
    base = ["--model_path", "m", "--data_id", "synthetic"]
    for theirs, port in ENGINES.items():
        for name in (theirs, port):
            args = teval.nlsh_eval_argparse().parse_args(
                base + ["--engine", name])
            assert args.engine == port
    assert teval.nlsh_eval_argparse().parse_args(base).engine == "auto"


def _run(mod, argv, capsys):
    capsys.readouterr()
    results = mod.main(argv)
    return results, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("artifact, max_probes", [("single", 4), ("ens", 6)])
def test_main_prints_and_writes_what_the_jax_main_does(workdir, capsys,
                                                       artifact, max_probes):
    common = ["--model_path", str(workdir / artifact), "--data_id",
              "synthetic", "--probe_mode", "flip", "--max_probes",
              str(max_probes)]
    want, want_lines = _run(
        jeval, common + ["--json_out", str(workdir / "j.jsonl")], capsys)
    got, got_lines = _run(
        teval, common + ["--device", "cpu", "--json_out",
                         str(workdir / "t.jsonl")], capsys)
    n_rows = max_probes // 2 if artifact == "ens" else max_probes
    assert len(got) == n_rows and got == want
    assert got_lines[-n_rows:] == want_lines[-n_rows:]
    assert got_lines[-1] == f"{got[-1]['avg_n_candidates']} {got[-1]['recall']}"
    assert (workdir / "t.jsonl").read_bytes() == \
        (workdir / "j.jsonl").read_bytes()
    first = json.loads((workdir / "t.jsonl").read_text().splitlines()[0])
    assert first["n_probes"] == (2 if artifact == "ens" else 1)


def test_main_resolves_the_model_path_in_the_save_dir(workdir, capsys,
                                                      monkeypatch):
    monkeypatch.setenv("NLSH_MODEL_SAVE_DIR", str(workdir))
    got, _ = _run(teval, ["--model_path", "single.json", "--data_id",
                          "synthetic", "--probe_mode", "flip",
                          "--max_probes", "2", "--device", "cpu"], capsys)
    assert [r["n_probes"] for r in got] == [1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            teval.main(["--model_path", "single", "--data_id", "synthetic"])
