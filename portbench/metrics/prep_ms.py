"""``prep_ms``: the device time of the serve's ``prep`` layer a batch: the
queries' extension, the grouped or windowed prep (sorts, scans, the
group table) and the ensemble guard's group count. The kernels the trace
shows from each ``nlsh_span_prep`` mark of the program to its next mark,
summed over the traced window, over its batches
(``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "prep", "moves": "qps"}


def read(ctx):
    return layers.layer_ms(ctx, "prep")
