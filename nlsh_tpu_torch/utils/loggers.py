"""Experiment loggers behind one duck-typed interface.

Own copy of :mod:`nlsh_tpu.utils.loggers` (the port imports nothing of
the JAX package): ``NullLogger``, ``JSONLLogger`` (one JSON object per
metric, no SDK needed) and three SDK adapters (``TensorboardX``,
``CometML``, ``WandB``) sharing one :class:`_SDKLogger` base that
imports its SDK lazily, at construction.  Every logger exposes
``meta(params) / log(name, value, step) / args(text) / run_name``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class NullLogger:
    """Print-only logger, throttled to every 100 steps for scalar spam
    (reference ``loggers.py:6-24``)."""

    def __init__(self, every: int = 100):
        self._every = every

    @property
    def run_name(self) -> str:
        return "Null"

    def meta(self, params=None, **kwargs):
        if params:
            print(params)
        if kwargs:
            print(kwargs)

    def log(self, name, value, step):
        if step % self._every == 0:
            print(f"Step {step} {name}: {value}")

    def args(self, arg_text):
        print(arg_text)


class JSONLLogger:
    """Structured metrics to a .jsonl file — no external SDK needed.

    Usable as a context manager; the file handle is closed on
    ``close()``/``__exit__`` (and flushed after every record, so an
    unclosed logger still leaves a complete file).
    """

    def __init__(self, path: str, run_name: str | None = None, echo: bool = False):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._run_name = run_name or self._path.stem
        self._echo = echo
        self._fh = self._path.open("a")

    @property
    def run_name(self) -> str:
        return self._run_name

    def _write(self, rec: dict):
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def meta(self, params=None, **kwargs):
        self._write({"kind": "meta", "params": params or kwargs,
                     "time": time.time()})

    def log(self, name, value, step):
        self._write({"kind": "metric", "name": name, "value": float(value),
                     "step": int(step)})
        if self._echo and step % 100 == 0:
            print(f"Step {step} {name}: {value}")

    def args(self, arg_text):
        self._write({"kind": "args", "args": arg_text})

    def close(self):
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _SDKLogger:
    """Common shape of the third-party adapters.

    Subclasses define ``_connect(**kwargs) -> handle`` (doing the lazy
    SDK import so the dependency stays optional) plus the three emit
    hooks; this base provides the uniform public interface the trainers
    consume (reference interface at ``loggers.py:27-97``).
    """

    def __init__(self, **kwargs):
        self._h = self._connect(**kwargs)

    # -- subclass hooks --------------------------------------------------
    def _connect(self, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def _emit_metric(self, h, name, value, step):  # pragma: no cover
        raise NotImplementedError

    def _emit_params(self, h, params):  # pragma: no cover
        raise NotImplementedError

    def _emit_args(self, h, arg_text):  # pragma: no cover
        raise NotImplementedError

    def _name(self, h) -> str:
        return type(self).__name__

    # -- uniform surface ---------------------------------------------------
    @property
    def run_name(self) -> str:
        return self._name(self._h)

    def log(self, name, value, step):
        self._emit_metric(self._h, name, value, step)

    def meta(self, params):
        self._emit_params(self._h, params)

    def args(self, arg_text):
        self._emit_args(self._h, arg_text)


class TensorboardX(_SDKLogger):
    """tensorboardX backend (reference ``loggers.py:27-41``)."""

    def __init__(self, logdir: str, run_name: str):
        self._run = run_name
        super().__init__(logdir=logdir)

    def _connect(self, logdir):
        from tensorboardX import SummaryWriter  # optional dep

        return SummaryWriter(logdir=logdir)

    def _name(self, h):
        return self._run

    def _emit_metric(self, h, name, value, step):
        h.add_scalar(name, value, step)

    def _emit_params(self, h, params):
        h.add_hparams(hparam_dict=params, metric_dict={})

    def _emit_args(self, h, arg_text):
        h.add_text("args", arg_text)


class CometML(_SDKLogger):
    """Comet ML backend (reference ``loggers.py:44-75``): refuses to
    run against a dead connection unless debugging, and disables the
    SDK's multiprocessing hooks."""

    def __init__(self, api_key, project_name, workspace, debug=True, tags=None):
        super().__init__(api_key=api_key, project_name=project_name,
                         workspace=workspace, debug=debug, tags=tags)

    def _connect(self, api_key, project_name, workspace, debug, tags):
        from comet_ml import Experiment  # optional dep

        exp = Experiment(api_key=api_key, project_name=project_name,
                         workspace=workspace, disabled=debug)
        if not (exp.alive or debug):
            raise RuntimeError("Cannot connect to Comet ML")
        exp.disable_mp()
        if tags:
            exp.add_tags(tags)
        return exp

    def _name(self, h):
        return h.get_key()

    def _emit_metric(self, h, name, value, step):
        h.log_metric(name=name, value=value, step=step)

    def _emit_params(self, h, params):
        h.log_parameters(params)

    def _emit_args(self, h, arg_text):
        h.log_parameter("cmd args", arg_text)


class WandB(_SDKLogger):
    """Weights & Biases backend (reference ``loggers.py:78-97``)."""

    def __init__(self, tags):
        super().__init__(tags=tags)

    def _connect(self, tags):
        import wandb  # optional dep

        return wandb.init(tags=tags, job_type="training")

    def _name(self, h):
        return h.id

    def _emit_metric(self, h, name, value, step):
        h.log({name: value}, step=step)

    def _emit_params(self, h, params):
        h.config.update(params)

    def _emit_args(self, h, arg_text):
        h.config.update({"cmd args": arg_text})
