"""``submit_ms``: the host's time in the index's ``query_async`` call,
the median over the traced window's batches (host clock around the
harness's own call; the upload of the batch and the replay's launch
happen in it)."""

import statistics

META = {"unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "entry", "moves": "qps"}


def read(ctx):
    if not ctx.submit_s:
        return None
    return statistics.median(ctx.submit_s) * 1e3
