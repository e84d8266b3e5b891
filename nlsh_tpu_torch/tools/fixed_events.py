"""Event tables of the fixed-cap kernel (K5, K6), and K5's time on them.

    python3 -m nlsh_tpu_torch.tools.fixed_events   # from the repo root, one GPU

The kernel sorts its (query, probe) events by the rows they read and
cuts the sorted order into chunks of 32, so what it has to get right
depends on how events share rows.  :func:`synthetic_events` makes the
hard cases of that schedule from a seed (``chip_smoke.py`` and the
tests hold the kernel to its plain version on each), and
:func:`random_bucket_probes` a probe table in which every query probes
distinct random buckets: the same events per bucket on average as the
serve's, without its hot buckets.

Run as a program it prints one JSON line per (layout, table) with the
time of the whole ``bucket_scores_auto`` call (mean of 20 after a
warm-up, CUDA events) on the bench workload's cap-aligned layouts, f32
and per-row int8: the serve's own events (16 flip probes of 10,000
queries), the random-bucket table, and a sparse one (the random probes
of the first 256 queries: about one event per bucket).  It calls only
the wrapper, so a copy of this file runs unchanged in a checkout of an
earlier commit and times that commit's kernel on the same tables.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np


def synthetic_events(seed: int, n_blocks: int, cap: int) -> list[dict]:
    """Hard cases of the sorted-chunk schedule over a layout of
    ``n_blocks * cap`` rows: dicts of ``name``, ``stride`` (``cap``: the
    index is a block id, K5; ``1``: a row offset, K6), ``index`` and
    ``counts`` ``(nq, P)`` int32."""
    rng = np.random.default_rng(seed)
    n_rows = n_blocks * cap

    def counts(shape):
        return rng.integers(1, cap + 1, shape).astype(np.int32)

    def case(name, stride, index, cnt):
        return {"name": name, "stride": stride,
                "index": np.ascontiguousarray(index, dtype=np.int32),
                "counts": np.ascontiguousarray(cnt, dtype=np.int32)}

    out = []
    # counts of 0 (invalid probes), of cap and between; the layout's tail
    idx = rng.integers(0, n_blocks, (40, 5))
    idx[:, 0] = n_blocks - 1
    cnt = counts((40, 5))
    cnt[::5] = cap
    cnt[1::7, 3:] = 0
    out.append(case("mixed", cap, idx, cnt))
    # duplicate (query, probe) events: a query probing one block P times
    idx = np.repeat(rng.integers(0, n_blocks, (24, 1)), 4, axis=1)
    cnt = np.repeat(counts((24, 1)), 4, axis=1)
    out.append(case("duplicates", cap, idx, cnt))
    # one key longer than several chunks, different counts inside it
    idx = np.full((50, 3), n_blocks // 2)
    cnt = counts((50, 3))
    cnt[3] = 0
    out.append(case("long_run", cap, idx, cnt))
    # nothing to score
    cnt = np.zeros((9, 4), np.int32)
    cnt[::2] = -3
    out.append(case("all_dead", cap, rng.integers(0, n_blocks, (9, 4)), cnt))
    out.append(case("one_event", cap, [[n_blocks // 3]], [[max(cap // 2, 1)]]))
    # n_events not a multiple of the chunk, a few events per block
    out.append(case("ragged", cap, rng.integers(0, n_blocks, (37, 3)),
                    counts((37, 3))))
    # indices below 0 and past the layout: both clamps, several raw
    # indices on one clamped block
    idx = rng.integers(-5, n_blocks + 5, (21, 4))
    idx[0] = [-7, -1, n_blocks, n_blocks + 9]
    out.append(case("out_of_range", cap, idx, counts((21, 4))))
    # K6: starts that are multiples of 8, not of cap, whose ranges overlap
    # without being equal, and some that are equal
    span = max((min(2 * cap, n_rows - cap)) // 8, 1)
    idx = rng.integers(0, span + 1, (30, 4)) * 8
    idx[:, 3] = idx[:, 2]
    idx[0, 0] = n_rows - cap
    idx[1, 0] = n_rows - cap + 8       # past the last start: clamped
    out.append(case("overlap", 1, idx, counts((30, 4))))
    # K6 at block-exact starts: the same rows as K5 reads
    idx = rng.integers(0, n_blocks, (19, 3)) * cap
    out.append(case("block_exact", 1, idx, counts((19, 3))))
    return out


def random_bucket_probes(n_buckets: int, nq: int, n_probes: int, seed: int):
    """``(probe_ids (nq, n_probes) i32, probe_valid)``: every query probes
    ``n_probes`` distinct buckets drawn uniformly."""
    rng = np.random.default_rng(seed)
    pid = np.stack([rng.choice(n_buckets, n_probes, replace=False)
                    for _ in range(nq)]).astype(np.int32)
    return pid, np.ones_like(pid, dtype=bool)


def fixed_events(lay, pid, pv):
    """The fixed-cap serve's events of probes ``(pid, pv)`` on the
    cap-aligned layout ``lay``, as ``bucket_scores`` makes them:
    ``(block_idx, starts, counts)``, each ``(nq, P)`` i32."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    safe, counts = qk._probe_counts(lay.counts, pid, pv, lay.cap)
    starts = torch.clamp(lay.starts[safe], max=lay.n_rows - lay.cap)
    starts = starts.to(torch.int32)
    return starts // lay.cap, starts, counts.to(torch.int32)


def schedule_stats(order, first, counts, cap: int) -> dict:
    """What the kernel's schedule makes of sorted events (the output of
    ``_bucket_event_order``): its runs by length class, and the (slot,
    row) pairs its warps multiply against the live ones.  A run of more
    than 16 events costs 32 slots, of 9 to 16 events 16, of at most 8
    events 8; a tile's 32-row groups are dealt between 2 warps (wide
    runs) or 4, and the tile takes as long as its busiest warp."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    G = qk._BUCKET_G
    cnt = counts.long().clamp(0, cap)
    live = cnt > 0
    pos = torch.arange(cnt.numel(), device=cnt.device)
    prev_live = torch.roll(live, 1)
    prev_first = torch.roll(first, 1)
    head = live & ((pos % G == 0) | ~prev_live | (prev_first != first))
    run = torch.cumsum(head, 0) - 1
    n_runs = int(head.sum())
    length = torch.bincount(run[live], minlength=n_runs)
    rows = torch.zeros(n_runs, dtype=torch.int64, device=cnt.device)
    rows.scatter_reduce_(0, run[live], cnt[live], "amax")
    wide, mid = length > 16, (length > 8) & (length <= 16)
    slots = torch.where(wide, 32, torch.where(mid, 16, 8))
    deal = torch.where(wide, 2, 4)
    full, tail = rows // 256, -(-(rows % 256) // 32)
    warp_groups = full * (8 // deal) + -(-tail // deal)  # per warp, of 32 rows
    issued = slots * warp_groups * deal * 32   # pairs all the warps multiply
    out = {"events": int(cnt.numel()), "live_events": int(live.sum()),
           "items": qk.bucket_work_items(cnt.numel()), "runs": n_runs,
           "live_pairs": int(cnt.sum()), "issued_pairs": int(issued.sum())}
    for name, m in (("wide", wide), ("mid", mid), ("narrow", ~wide & ~mid)):
        out[name] = {"runs": int(m.sum()), "events": int(length[m].sum()),
                     "issued_pairs": int(issued[m].sum())}
    return out


def mode_times(lay, run_len: int, rows: int | None = None,
               n_events: int = 131072) -> dict:
    """The kernel alone on a made-up table in which every run has exactly
    ``run_len`` events (a divisor of 32) on a random block of ``lay``,
    every count ``rows`` (``cap`` if None: full tiles only, nothing to
    fill with -inf): the time and the (slot, row) pairs per second of one
    register-tile mode."""
    import torch

    import chip_smoke as cs
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    dev = lay.data.device
    gen = torch.Generator(device="cpu").manual_seed(run_len)
    n_runs = n_events // run_len
    n_blocks = lay.n_rows // lay.cap - 1
    # a random block per run, sorted; every other run starts 8 rows in, so
    # neighbouring runs on one block do not merge into one
    blocks = torch.randint(0, n_blocks, (n_runs,), generator=gen).sort().values
    first = blocks * lay.cap + (torch.arange(n_runs) % 2) * 8
    first = first.to(torch.int32).repeat_interleave(run_len).to(dev)
    rows = lay.cap if rows is None else rows
    counts = torch.full((n_events,), rows, dtype=torch.int32, device=dev)
    order = torch.arange(n_events, dtype=torch.int32, device=dev)
    q = torch.randn((n_events, lay.d_pad), generator=gen).to(dev)
    ms = cs.cuda_ms(lambda: qk._launch_bucket_sorted(
        lay.data, q, order, first, counts, lay.cap, "bucket_scores_impl"), 10)
    pairs = n_events * rows
    return {"run_len": run_len, "rows": rows, "n_events": n_events,
            "kernel_ms": ms,
            "pairs_per_ns": pairs / ms / 1e6,
            "f32_tflops_over_d_pad": 2 * lay.d_pad * pairs / ms / 1e9}


def main() -> int:
    import torch

    import bench
    import chip_smoke as cs
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    if not torch.cuda.is_available():
        raise SystemExit("fixed_events: needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    idx = cs.phase_index(corpus)
    q, pid, pv = cs._probes(idx, queries)
    rid, rv = (torch.from_numpy(a).to(pid.device) for a in random_bucket_probes(
        idx.table.n_buckets, queries.shape[0], cs.HASH_TIMES, 0))
    tables = {"serve": (q, pid, pv), "random_buckets": (q, rid.to(pid.dtype), rv),
              "sparse": (q[:256], rid[:256].to(pid.dtype), rv[:256])}
    for dtype in (torch.float32, torch.int8):
        idx.serving_dtype = dtype
        lay = idx.layout
        for name, (tq, tp, tv) in tables.items():
            qe = qk.extend_queries(lay, tq)
            block_idx, _, counts = fixed_events(lay, tp, tv)
            ms = cs.cuda_ms(lambda: qk.bucket_scores_auto(
                lay.data, qe, block_idx, counts, lay.cap), 20)
            row = {"table": name, "dtype": str(dtype), "n_events": tp.numel(),
                   "live_rows": int(counts.sum()),
                   "probed_blocks": int(torch.unique(
                       block_idx[counts > 0]).numel()),
                   "bucket_scores_auto_ms": ms}
            if hasattr(qk, "_bucket_event_order"):  # the sorted schedule
                row["schedule"] = schedule_stats(*qk._bucket_event_order(
                    block_idx, counts, lay.cap, lay.cap, lay.n_rows), lay.cap)
            print(json.dumps(row), flush=True)
        if hasattr(qk, "_launch_bucket_sorted"):
            for run_len, rows in ((1, None), (4, None), (8, None),
                                  (16, None), (32, None), (32, 288),
                                  (32, 256), (32, 96), (16, 288), (8, 288)):
                print(json.dumps({"dtype": str(dtype),
                                  **mode_times(lay, run_len, rows)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
