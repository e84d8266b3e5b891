"""``hash_ms``: the device time of the serve's ``hash`` layer a batch: the
probe hash of every table (the SIREN trunk, the code, the flip probes)
and the flat probes. The kernels the trace shows from each
``nlsh_span_hash`` mark of the program to its next mark, summed over the
traced window, over its batches (``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "ms", "better": "lower", "source": "device_trace",
        "layer": "hash + probes", "moves": "qps"}


def read(ctx):
    return layers.layer_ms(ctx, "hash")
