"""``score_ms``: the device time of the serve's ``score`` layer a batch:
the scoring kernel (K1, K2 or K3). The kernels the trace shows from each
``nlsh_span_score`` mark of the program to its next mark, summed over
the traced window, over its batches (``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "scoring kernels", "moves": "qps"}


def read(ctx):
    return layers.layer_ms(ctx, "score")
