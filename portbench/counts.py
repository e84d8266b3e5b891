"""The work a batch requires, counted from the reference's candidates,
and the least time the card could take for it.

The counts do not depend on how the program groups its work: a
candidate row is read once, each distinct (query, candidate) pair is
scored once, whatever a kernel reads again.
"""

from __future__ import annotations

import json
import os

FLOAT_BYTES = 4
ID_BYTES = 4

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peak_of(device_name: str) -> dict | None:
    """The published peaks of a card by its name, None if unlisted."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def scoring_work(pairs: int, rows: int, n_queries: int, dim: int,
                 k: int) -> tuple[int, int]:
    """``(operations, bytes)`` of scoring a batch: ``2 * dim`` per
    distinct (query, candidate) pair; each distinct candidate row, each
    query and each returned id once."""
    ops = 2 * dim * pairs
    nbytes = (rows + n_queries) * dim * FLOAT_BYTES + n_queries * k * ID_BYTES
    return ops, nbytes


def mlp_work(n_queries: int, n_tables: int,
             layers: list[tuple[int, int]]) -> tuple[int, int]:
    """``(operations, bytes)`` of hashing a batch through ``n_tables``
    heads of the dense ``(fan_in, fan_out)`` layers: ``2 * fan_in *
    fan_out`` per query, table and layer; each weight and bias once."""
    per = sum(fi * fo for fi, fo in layers)
    ops = 2 * n_queries * n_tables * per
    nbytes = n_tables * sum((fi + 1) * fo for fi, fo in layers) * FLOAT_BYTES
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The larger of ``ops`` at the float32 peak and ``nbytes`` at the
    memory's."""
    return max(ops / peak["float32_flops"], nbytes / peak["bytes_per_s"])
