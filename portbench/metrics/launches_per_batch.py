"""``launches_per_batch``: the host's CUDA calls that put work on the
card (kernel and graph launches, copies, fills) in the traced window,
per batch, counted in the ``torch.profiler`` trace."""

META = {"unit": "count", "better": "lower", "source": "device_trace",
        "layer": "one-dispatch serve", "moves": "qps"}


def read(ctx):
    if not ctx.n_batches or not ctx.trace.device:
        return None
    return ctx.trace.launches() / ctx.n_batches
