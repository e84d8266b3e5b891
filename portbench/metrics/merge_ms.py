"""``merge_ms``: the device time of the serve's ``merge`` layer a batch:
the panels' top-k, the merge into each query's top k, the ensemble's
duplicate collapse and the pack. The kernels the trace shows from each
``nlsh_span_merge`` mark of the program to its next mark, summed over
the traced window, over its batches (``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "merge", "moves": "qps"}


def read(ctx):
    return layers.layer_ms(ctx, "merge")
