"""Utilities: checkpoints and model artifacts, corpus fingerprints,
environment config and evaluation metrics."""

from nlsh_tpu_torch.utils import metrics  # noqa: F401
