"""``guard_fallback_share``: the share of the traced batches whose serve
fell back from the calibrated group table to the static bound: the
program's ``nlsh_span_bound`` marks (the head of the ensemble guard's
static-bound branch) over its ``nlsh_span_hash`` marks (one a batch).
A serve without a guard reads 0 (``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "%", "better": "lower", "source": "program_counter",
        "layer": "guard", "moves": "qps"}


def read(ctx):
    seen = layers.marks(ctx.trace)
    if "hash" not in seen:
        return None
    return 100.0 * seen.count("bound") / seen.count("hash")
