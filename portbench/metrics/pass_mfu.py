"""``pass_mfu``: the least time of the traced batches' whole serve, over
the traced window's wall time.  The least time is the larger of the
operations at the card's float32 peak and the bytes at its memory's: the
scoring's (as ``scoring_roofline`` counts them) and each query's
hash through every table's dense layers (``2 fan_in fan_out`` per query,
table and layer; each weight and bias once per batch)."""

from portbench import counts

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "whole serve", "moves": "qps"}


def _layers(cfg, dim):
    h = cfg["hashing"]
    widths = [dim, *h["hidden"], h["hash_size"]]
    return list(zip(widths, widths[1:]))


def read(ctx):
    if ctx.peak is None or not ctx.n_batches:
        return None
    m_ops, m_bytes = counts.mlp_work(ctx.batch,
                                     ctx.config["hashing"]["n_tables"],
                                     _layers(ctx.config, ctx.dim))
    least = 0.0
    for (pairs, rows), n in ctx.pool_work():
        ops, nbytes = counts.scoring_work(pairs, rows, ctx.batch, ctx.dim,
                                          ctx.k)
        least += n * counts.least_seconds(ops + m_ops, nbytes + m_bytes,
                                          ctx.peak)
    return 100.0 * least / ctx.trace.window_s
