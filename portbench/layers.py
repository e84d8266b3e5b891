"""The program's own marks in a trace, read by the layer metrics.

The serve bodies of ``nlsh_tpu_torch`` launch a one-thread kernel at each
layer boundary (``nlsh_tpu_torch/csrc/spans.cu``): ``nlsh_span_hash``,
``_prep``, ``_score``, ``_merge``, ``_end``, and ``nlsh_span_bound`` at
the head of the ensemble guard's static-bound branch.  Its index opens
host spans ``nlsh.*`` while a profiler records.  A program without them
(an older commit) leaves none in the trace, and every reader here then
returns None.
"""

from __future__ import annotations

import re
import statistics

MARK = re.compile(r"nlsh_span_([a-z]+)")
LAYERS = ("hash", "prep", "score", "merge")


def marks(trace) -> list[str]:
    """The names of the traced window's marks, in order (``hash``,
    ``prep``, ... ``bound``)."""
    out = []
    for _, _, name, cat in trace.device:
        m = MARK.match(name) if cat == "kernel" else None
        if m:
            out.append(m.group(1))
    return out


def layer_ms(ctx, layer: str) -> float | None:
    """The kernel time of ``layer`` a batch: every kernel of the traced
    window (a mark's own included) counts in the layer the last boundary
    mark before it opened, from that layer's mark to the next (``end``
    opens none, ``bound`` opens nothing); summed, over the traced
    batches.  None without marks."""
    opened, total, seen = None, 0.0, False
    for _, dur, name, cat in ctx.trace.device:
        if cat != "kernel":
            continue
        m = MARK.match(name)
        if m:
            seen = True
            if m.group(1) in LAYERS:
                opened = m.group(1)
            elif m.group(1) == "end":
                opened = None
        if opened == layer:
            total += dur
    if not seen or not ctx.n_batches:
        return None
    return total / 1e3 / ctx.n_batches


def host_span_ms(ctx, name: str) -> float | None:
    """The median duration of the program's host span ``name`` in the
    traced window, ms; None without one."""
    durs = [dur for _, dur, n in ctx.trace.host if n == name]
    return statistics.median(durs) / 1e3 if durs else None
