"""The control: the plain reference in the program's place, computed in
the nearest precision below the one the configurations state (TF32 for
float32 with TF32 off), driven through a cell's whole run and judged as
the program is.  Its readings are the upper ends the limits in
``limits/<cell>.json`` are set below.

    python3 -m portbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

prints one JSON line per seed: the seed and the run's ``checks``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import run


class ControlSystem:
    """The reference in TF32, answering as a system does."""

    def __init__(self, cfg, params_path, corpus, test_queries, device):
        self.ref = run.reference(cfg, params_path, corpus, device, "tf32")

    def submit(self, queries, k: int):
        return self.ref.answer(queries, k)

    def fetch(self, pending):
        return pending

    def close(self) -> None:
        self.ref = None


def control_run(root: str, workload: str, seed: int, seconds: float,
                **kw) -> dict:
    """One run of ``workload`` with the control in the program's place."""
    return run.run_cell(root, workload, seed, seconds, False,
                        system_factory=ControlSystem, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    try:
        for seed in args.seeds:
            res = control_run(os.getcwd(), args.workload, seed,
                              args.seconds)
            print(json.dumps({"seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"],
                              "checks": res["checks"]}), flush=True)
    except run.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
