"""``scoring_roofline``: the least time the scoring of the traced
batches needs over the device time of the scoring kernels that served
them (the configuration's ``scoring_kernels``, matched by name in the
trace).  The least time is the larger of the operations at the card's
float32 peak and the bytes at its memory's (``portbench/counts.py``,
``portbench/peaks.json``), counted from the reference's candidates: 2 d
per distinct (query, candidate) pair; each distinct candidate row, each
query and each id once."""

from portbench import counts

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "scoring kernels", "moves": "qps"}


def read(ctx):
    if ctx.peak is None:
        return None
    t = ctx.trace.kernel_s(ctx.config["scoring_kernels"])
    if t <= 0:
        return None
    least = sum(n * counts.least_seconds(
        *counts.scoring_work(pairs, rows, ctx.batch, ctx.dim, ctx.k),
        ctx.peak) for (pairs, rows), n in ctx.pool_work())
    return 100.0 * least / t
