"""Run one cell of the benchmark and print one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  In order: set-up (the deployment's data,
the traffic pool of the seed, the index through the program's public
constructor, one warm-up of the cell's batch shape, which captures its
graph and builds the kernels under ``build/`` of the checkout), the
window (one client, closed loop: a batch is sent once the previous
batch's ids are on the host), the comparison of a seeded sample of the
window's answers with the plain reference, and the result line.  With
``--trace 1`` a slice of the window runs under ``torch.profiler``, its
trace is written to ``.portbench/runs/<cell>/trace.json`` and the cell's
per-layer metrics read it (one that lists the cell and finds nothing to
read fails the run); with ``--trace 0`` the line holds the cell's
end-to-end metrics, and a record of the host beside the window, once a
second, goes to standard error.  A machine without the card the cell asks for exits
with code 2 and prints no result; a run that loaded JAX or the JAX
package exits with code 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from portbench import manifest as mf  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench import workload as wl  # noqa: E402

# top-level module names that may not be loaded in a run: JAX and the
# JAX package (``nlsh_tpu_torch`` is the port, a different name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nlsh_tpu")
WARM_BATCHES = 2   # replays of the captured graph after the warm-up
TRACE_LEAD = 8     # untraced batches of a traced window before its slice
TRACE_BATCHES = 128  # batches in the traced slice
STATE_DIR = ".portbench"
NAME_CHARS = 160   # of a breakdown entry's name
GIB = 2 ** 30


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``size`` of the window's answers, drawn from
    the run's seed as they come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2 ** 63, 1])
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


class HostLog:
    """The host beside the window, once a second (nothing inside a
    batch): batches done, their submit's and their whole seconds, and
    the process's involuntary context switches, to tell a slow phase of
    the host's submit from one of the card or a preemption."""

    def __init__(self):
        self.rows = []
        self.submit = self.total = 0.0
        self.n = 0
        self.next = 0.0

    def mark(self, now: float) -> None:
        import resource

        if now < self.next:
            return
        self.next = now + 1.0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.rows.append((now, self.n, self.submit, self.total,
                          ru.ru_nivcsw))

    def add(self, submit_s: float, total_s: float) -> None:
        self.n += 1
        self.submit += submit_s
        self.total += total_s

    def per_second(self) -> dict:
        """Each second's batches, mean submit and batch ms, and
        involuntary switches."""
        out = {k: [] for k in ("batches_per_s", "submit_ms", "batch_ms",
                               "nivcsw")}
        for a, b in zip(self.rows, self.rows[1:]):
            dt, n = b[0] - a[0], max(b[1] - a[1], 1)
            out["batches_per_s"].append(round((b[1] - a[1]) / dt, 1))
            out["submit_ms"].append(round((b[2] - a[2]) / n * 1e3, 4))
            out["batch_ms"].append(round((b[3] - a[3]) / n * 1e3, 4))
            out["nivcsw"].append(b[4] - a[4])
        return out


class TracedSlice:
    """The traced part of a ``--trace 1`` window: ``torch.profiler``
    started before the window (its set-up outside the window), warming up
    over the window's first :data:`TRACE_LEAD` batches and recording the
    :data:`TRACE_BATCHES` after them, inside a ``portbench.window`` span,
    each batch in a ``portbench.batch`` span and its submit in a
    ``portbench.submit`` span.  The trace file is written when the slice
    ends.  A slice keeps the file small."""

    def __init__(self, path: str):
        import torch

        self.submit_s: list[float] = []
        self.pool_index: list[int] = []
        self.prof = tr.profiler(
            schedule=torch.profiler.schedule(
                wait=0, warmup=TRACE_LEAD, active=TRACE_BATCHES, repeat=1),
            on_trace_ready=lambda prof: prof.export_chrome_trace(path))
        self.prof.start()
        self.span = None

    def query(self, system, batch, k: int, i: int, p: int):
        """Batch ``i`` of the window (pool batch ``p``), traced when it
        falls in the slice: ``(ids, n_candidates, submit s)``."""
        import torch

        if not TRACE_LEAD <= i < TRACE_LEAD + TRACE_BATCHES:
            out = serve(system, batch, k)
            if i < TRACE_LEAD:
                self.prof.step()
            return out
        mark = torch.profiler.record_function
        if i == TRACE_LEAD:
            self.span = mark(tr.WINDOW)
            self.span.__enter__()
        self.pool_index.append(p)
        with mark(tr.BATCH):
            with mark(tr.SUBMIT):
                t = time.perf_counter()
                pending = system.submit(batch, k)
                submit_s = time.perf_counter() - t
            ids, n_cand = system.fetch(pending)
        self.submit_s.append(submit_s)
        if i == TRACE_LEAD + TRACE_BATCHES - 1:
            self.close()
        else:
            self.prof.step()
        return ids, n_cand, submit_s

    def close(self) -> None:
        """End the slice (at its last batch or the window's end): the
        span, the profiler, which writes the file."""
        if self.prof is None:
            return
        if self.span is not None:
            self.span.__exit__(None, None, None)
        self.prof.step()
        self.prof.stop()
        self.prof = None


def serve(system, batch, k: int):
    """One batch through the system: ``(ids, n_candidates, submit s)``,
    the submit timed on the host clock around the system's own call."""
    t = time.perf_counter()
    pending = system.submit(batch, k)
    submit_s = time.perf_counter() - t
    ids, n_cand = system.fetch(pending)
    return ids, n_cand, submit_s


def window(system, pool: np.ndarray, k: int, seconds: float,
           sample: Reservoir, traced: TracedSlice | None = None,
           host: HostLog | None = None):
    """The closed loop: ``(latencies s, window s)``; every answer is
    offered to ``sample`` as ``(pool index, ids, n_candidates)``.  With
    ``traced`` a slice of the window's batches runs under the
    profiler; ``host`` logs the host once a second."""
    lat = []
    n_pool = pool.shape[0]
    start = time.perf_counter()
    end = start
    i = 0
    try:
        while end - start < seconds:
            if host is not None:
                host.mark(end)
            p = i % n_pool
            t = time.perf_counter()
            if traced is not None:
                ids, n_cand, submit_s = traced.query(system, pool[p], k, i, p)
            else:
                ids, n_cand, submit_s = serve(system, pool[p], k)
            end = time.perf_counter()
            lat.append(end - t)
            if host is not None:
                host.add(submit_s, end - t)
            sample.offer((p, ids, n_cand))
            i += 1
    finally:
        if traced is not None:
            traced.close()
    return lat, end - start


def _device(cell: dict, device):
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell["chips"]:
        raise NoCard(f"the cell asks for {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def reference(cfg: dict, params_path: str, corpus, device,
              precision: str = "float32"):
    """The configuration's plain reference over ``corpus``."""
    mod = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    h, s = cfg["hashing"], cfg["serving"]
    return mod.Reference(
        params_path, corpus, n_tables=h["n_tables"],
        budget=s["probe_budget"], n_probes=s["hash_times"], w0=h["w0"],
        w0_initial=h["w0_initial"], device=device, precision=precision)


NUMBERS = ("cand_mismatch_share", "foreign_id_share", "max_score_gap")


def judge(ref, answers, pool: np.ndarray) -> dict:
    """Every number the comparison reads, over the sampled answers
    ``(pool index, ids, n_candidates)``: the queries judged, the share
    whose ``n_candidates`` differs from the reference's, and, over the
    queries whose count agrees (their candidates are the reference's),
    the share of returned ids that are no candidate of their query (or
    repeat one) and the widest score gap below the reference's top
    ``k``."""
    count_ok, foreign, gaps, n_ids = [], 0, [], 0
    for p, ids, n_cand in answers:
        res = ref.judge(pool[p], ids, n_cand)
        ok = res["count_ok"]
        count_ok.append(ok)
        foreign += int(res["foreign"][ok].sum())
        n_ids += int(ok.sum()) * ids.shape[1]
        gaps.append(res["gap"][ok])
    count_ok = np.concatenate(count_ok) if count_ok else np.zeros(0, bool)
    gap = np.concatenate(gaps) if gaps else np.zeros(0)
    return {
        "judged_queries": float(count_ok.size),
        "cand_mismatch_share": float((~count_ok).sum()
                                     / max(count_ok.size, 1)),
        "foreign_id_share": float(foreign / max(n_ids, 1)),
        "max_score_gap": float(gap.max()) if gap.size else 0.0,
    }


def checks_of(values: dict, limits: dict) -> dict:
    """The numbers the cell's limits file compares, each ``{"value",
    "limit"}``: ``judged_queries`` against its least count, the others
    against their largest value."""
    out = {"judged_queries": {"value": values["judged_queries"],
                              "limit": float(limits["judged_queries"])}}
    for name, limit in limits["numbers"].items():
        out[name] = {"value": values[name], "limit": float(limit)}
    return out


def passed(checks: dict) -> bool:
    """At least as many queries judged as the limit asks, and every
    other number at or under its limit."""
    return all(c["value"] >= c["limit"] if n == "judged_queries"
               else c["value"] <= c["limit"] for n, c in checks.items())


def _device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def _card_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, device=None, cache_dir: str | None = "auto",
             log=sys.stderr, system_factory=None) -> dict:
    """One run of ``workload``; returns the result object.  ``device``
    None takes the card the cell asks for and raises :class:`NoCard`
    without it; a test passes a device.  ``system_factory`` builds the
    system in the program's place (the control, a planted fault), with
    the arguments of the configuration's ``System``."""
    m = mf.Manifest(root)
    cell = m.workload(workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the harness drives one client in a closed loop")
    limits = m.limits(workload)
    params = m.path(cfg["params"]["file"])
    with open(params, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cfg["params"]["sha256"]:
        raise ValueError(f"{params}: sha256 {digest}, the configuration "
                         f"states {cfg['params']['sha256']}")
    dev = _device(cell, device)

    import torch

    # the configuration states float32 matrix products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if system_factory is None:
        system_factory = importlib.import_module(
            f"portbench.systems.{cfg['system']}").System
    if cache_dir == "auto":
        cache_dir = os.path.join(m.root, STATE_DIR, "cache")
    dep = wl.deployment(cfg["deployment"], cache_dir)
    pool = wl.query_pool(cfg["deployment"], traffic, seed, dep.centers)
    batch, k = traffic["batch"], traffic["k"]

    system = system_factory(cfg, params, dep.corpus, dep.queries, dev)
    warm_ids, _, _ = serve(system, dep.queries[:batch], k)
    cuda = dev.type == "cuda"
    if cuda:
        # what set-up freed goes back to the card (the graphs' pools
        # stay); the warm batches then reserve what a batch needs
        peak_setup = torch.cuda.max_memory_reserved(dev)
        torch.cuda.empty_cache()
    for i in range(WARM_BATCHES):
        serve(system, pool[i % pool.shape[0]], k)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - _T0
    print(f"setup done in {setup_s:.3f} s; card: "
          f"{_card_power() if cuda else dev}", file=log)

    sample = Reservoir(int(limits["judged_batches"]), seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        trace_dir = os.path.join(m.root, STATE_DIR, "runs", workload)
        os.makedirs(trace_dir, exist_ok=True)
        trace_path = os.path.join(trace_dir, "trace.json")
        if os.path.exists(trace_path):
            os.unlink(trace_path)
        traced = TracedSlice(trace_path)
        lat, window_s = window(system, pool, k, seconds, sample, traced)
    else:
        host = HostLog()
        lat, window_s = window(system, pool, k, seconds, sample, host=host)
    peak_window = torch.cuda.max_memory_reserved(dev) if cuda else 0
    n_batches = len(lat)

    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = reference(cfg, params, dep.corpus, dev)
    t = time.perf_counter()
    values = judge(ref, sample.kept, pool)
    checks = checks_of(values, limits)
    judge_s = time.perf_counter() - t
    exact = ref.exact_topk(dep.queries[:batch], min(k, 10))
    recall = float(np.mean([len(set(a) & set(b[b >= 0])) / len(a)
                            for a, b in zip(exact, warm_ids[:, :10])]))
    tenths = [len(part) / sum(part) * batch
              for part in np.array_split(np.asarray(lat), 10) if len(part)]
    print(f"record: recall@{exact.shape[1]} of the warm-up batch (the "
          f"deployment's test queries) {recall}; {n_batches} batches in "
          f"{window_s:.3f} s, median {np.median(lat) * 1e3:.4f} ms, queries/s "
          f"by tenths of the window {[round(q) for q in tenths]}; judged "
          f"{len(sample.kept)} batches in {judge_s:.3f} s: {values}", file=log)
    if not trace:
        print(f"record: host by second {json.dumps(host.per_second())}",
              file=log)

    if trace:
        tt = tr.Trace(trace_path)
        metrics = _per_layer(m, workload, cfg, traffic, ref, pool, tt,
                             traced, dev)
    else:
        metrics = _end_to_end(m, workload, lat, window_s, batch, setup_s,
                              peak_window)
    info = _device_info(dev)
    info["memory_peak_bytes"] = int(max(peak_setup, peak_window)) if cuda \
        else 0
    result = {"correct": passed(checks), "attempted": n_batches,
              "failed": 0, "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = tt.busy_s()
        info["window_s"] = tt.window_s
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], v] for n, v in tt.device_ops()],
            "idle_gaps": [[n[:NAME_CHARS], v] for n, v in tt.idle_gaps()]}
    result["checks"] = checks
    return result


def _end_to_end(m, workload, lat, window_s, batch, setup_s, peak_window):
    values = {
        "qps": len(lat) * batch / window_s,
        "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "device_mem_gib": peak_window / GIB,
        "setup_s": setup_s,
    }
    return {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
            for e in m.end_to_end(workload)}


def _per_layer(m, workload, cfg, traffic, ref, pool, tt: tr.Trace,
               traced: TracedSlice, dev) -> dict:
    from collections import Counter

    from portbench import counts

    cache = {}

    def pool_work():
        """The reference's ``(pairs, rows)`` of each pool batch the
        traced slice sent, and how many times it sent it."""
        if "work" not in cache:
            sent = Counter(traced.pool_index)
            cache["work"] = [(ref.work(pool[p]), n)
                             for p, n in sorted(sent.items())]
        return cache["work"]

    peak = None
    if dev.type == "cuda":
        import torch

        peak = counts.peak_of(torch.cuda.get_device_name(dev))
    ctx = SimpleNamespace(
        trace=tt, n_batches=len(traced.pool_index),
        submit_s=traced.submit_s, config=cfg,
        traffic=traffic, pool_work=pool_work, peak=peak,
        dim=pool.shape[2], batch=traffic["batch"], k=traffic["k"])
    out = {}
    for entry in m.per_layer(workload):
        value = m.metric_module(entry["name"]).read(ctx)
        if value is None:
            if workload in entry.get("workloads", ()):
                raise RuntimeError(
                    f"per-layer metric {entry['name']} lists {workload} "
                    "but found nothing to read in its trace")
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def _checks_text(checks: dict) -> str:
    return "\n".join(f"check {n}: {c['value']!r} limit {c['limit']!r}"
                     for n, c in checks.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    # the program's build and kernel caches stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", sub)
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(_checks_text(result["checks"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
