"""The benchmark of ``nlsh_tpu_torch``: batched top-k search over a
learned-LSH index on one card.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Configurations, traffic mixes, limits and per-layer metrics are
files found by the names ``BENCHMARK.json`` gives them.
"""
