"""Utilities: checkpoint reading and evaluation metrics."""
