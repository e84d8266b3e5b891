"""Utilities: checkpoints and model artifacts, corpus fingerprints,
environment config and evaluation metrics."""
