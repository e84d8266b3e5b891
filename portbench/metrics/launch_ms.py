"""``launch_ms``: the host's time in a replay of the serve's captured
graph, the median over the traced window's batches of the program's
``nlsh.replay`` span (the inputs' copy into the graph's static ones, the
graph's launch, the result's clone): what a graph's nodes cost the host
(``portbench/layers.py``)."""

from portbench import layers

META = {"unit": "ms", "better": "lower", "source": "program_span",
        "layer": "one-dispatch serve", "moves": "qps"}


def read(ctx):
    return layers.host_span_ms(ctx, "nlsh.replay")
