"""``device_ms_per_batch``: the device time of every kernel in the traced
window, summed, per batch (``torch.profiler`` trace; copies and fills
left out)."""

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "device", "moves": "qps"}


def read(ctx):
    t = ctx.trace.kernel_s()
    if not ctx.n_batches or t <= 0:
        return None
    return 1e3 * t / ctx.n_batches
