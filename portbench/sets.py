"""Run sets of benchmark runs, each a process of its own, and summarise
their spreads: the measurement behind the bounds in ``BENCHMARK.json``.

    python3 -m portbench.sets --out <dir> --seconds <s> \
        --run <cell>:<seed>:<trace> [--run ...]

Each run's standard output and error go to ``<dir>/<i>-<cell>-<seed>-
<trace>.{out,err}``; ``<dir>/summary.json`` holds every result line and,
per cell and metric, the values, median, quartiles
(``statistics.quantiles(values, n=4)``) and the spread: the distance
between the quartiles as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict


def spread(values: list[float]) -> dict:
    med = statistics.median(values)
    out = {"values": values, "median": med}
    if len(values) >= 2:
        q1, _, q3 = statistics.quantiles(values, n=4)
        out.update(q1=q1, q3=q3, spread=(q3 - q1) / med if med else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--run", action="append", required=True,
                    help="<cell>:<seed>:<trace>")
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    results = []
    for i, spec in enumerate(args.run):
        cell, seed, trace = spec.rsplit(":", 2)
        base = os.path.join(args.out, f"{i:02d}-{cell}-{seed}-{trace}")
        cmd = [sys.executable, "-m", "portbench.run", "--workload", cell,
               "--seed", seed, "--seconds", str(args.seconds),
               "--trace", trace]
        t = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out = out if isinstance(out, str) else out.decode()
            err = err if isinstance(err, str) else err.decode()
        wall = time.perf_counter() - t
        with open(base + ".out", "w") as f:
            f.write(out)
        with open(base + ".err", "w") as f:
            f.write(err)
        lines = out.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        results.append({"cell": cell, "seed": int(seed),
                        "trace": int(trace), "rc": rc, "wall_s": wall,
                        "result": res})
        checks = res.get("checks") if res else None
        print(f"{spec}: rc {rc}, {wall:.1f} s, correct "
              f"{res and res['correct']}, metrics "
              f"{res and {k: v['value'] for k, v in res['metrics'].items()}}"
              f", checks {checks and {k: v['value'] for k, v in checks.items()}}",
              flush=True)
        if res is None:
            print(err[-3000:], flush=True)
    groups = defaultdict(lambda: defaultdict(list))
    for r in results:
        if r["result"]:
            for name, m in r["result"]["metrics"].items():
                groups[(r["cell"], r["trace"])][name].append(m["value"])
            for name, c in r["result"].get("checks", {}).items():
                groups[(r["cell"], r["trace"])]["check." + name].append(
                    c["value"])
    summary = {f"{c}:{t}": {n: spread(v) for n, v in ms.items()}
               for (c, t), ms in groups.items()}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"runs": results, "summary": summary}, f, indent=1)
    for key, ms in summary.items():
        for n, s in ms.items():
            print(f"{key} {n}: median {s['median']!r} spread "
                  f"{s.get('spread')!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
