"""The counts behind ``scoring_roofline`` and ``pass_mfu`` on a case
worked by hand: two queries whose candidates overlap in one row, which
is read once."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import counts
from portbench.manifest import Manifest
from portbench.reference.lsh import Reference
from portbench.tests import toy

PEAK = {"float32_flops": 1e12, "bytes_per_s": 1e9}


def test_scoring_work_by_hand():
    # q0 scores rows {0, 1, 2}, q1 rows {2, 3}: 5 pairs over 4 rows
    ops, nbytes = counts.scoring_work(pairs=5, rows=4, n_queries=2, dim=100,
                                      k=10)
    assert ops == 2 * 100 * 5
    assert nbytes == (4 + 2) * 100 * 4 + 2 * 10 * 4
    # 1,000 operations at 1e12/s against 2,480 bytes at 1e9/s
    assert counts.least_seconds(ops, nbytes, PEAK) == pytest.approx(2.48e-6)


def test_mlp_work_by_hand():
    ops, nbytes = counts.mlp_work(2, 3, [(100, 256), (256, 12)])
    assert ops == 2 * 2 * 3 * (100 * 256 + 256 * 12)
    assert nbytes == 3 * (101 * 256 + 257 * 12) * 4


def test_reference_work_counts_a_shared_row_once():
    # rows 0-3 on a line of buckets: q0's probes serve {0, 1, 2}, q1's
    # {2, 3} (one bit, flip probes: the hard bucket and its neighbour)
    ref = Reference.__new__(Reference)
    ref.n, ref.d, ref.budget = 4, 2, None
    ref.block_bytes, ref.width_bound, ref.device = 1 << 20, 4, "cpu"
    ref.order = torch.tensor([0, 1, 2, 3])
    ref.counts = torch.tensor([[2, 1, 1]])
    ref.starts = torch.tensor([[0, 2, 3]])
    ref.probes = lambda q: (torch.tensor([[[0, 1], [1, 2]]]),
                            torch.ones((1, 2, 2), dtype=torch.bool))
    assert ref.work(np.zeros((2, 2), np.float32)) == (5, 4)


def _ctx(root, name, **kw):
    m = Manifest(root)
    cfg = m.config("toy")
    trace = SimpleNamespace(kernel_s=lambda names=None: 0.002,
                            window_s=0.004, device=[1],
                            busy_s=lambda: 0.003, launches=lambda: 10)
    base = dict(trace=trace, n_batches=2, submit_s=[0.001, 0.003],
                config=cfg, traffic={}, peak=PEAK, dim=100, batch=2, k=10,
                pool_work=lambda: [((5, 4), 2)])
    base.update(kw)
    return m.metric_module(name).read(SimpleNamespace(**base))


def test_metric_readers_by_hand(tmp_path):
    root = toy.make_root(str(tmp_path))
    least = 2 * 2.48e-6  # two batches of the hand case
    assert _ctx(root, "scoring_roofline") == pytest.approx(
        100 * least / 0.002)
    mops, mbytes = counts.mlp_work(2, 1, [(100, 32), (32, 32), (32, 6)])
    whole = 2 * max((1000 + mops) / 1e12, (2480 + mbytes) / 1e9)
    assert _ctx(root, "pass_mfu") == pytest.approx(100 * whole / 0.004)
    assert _ctx(root, "device_idle_share") == pytest.approx(25.0)
    assert _ctx(root, "device_ms_per_batch") == pytest.approx(1.0)
    assert _ctx(root, "launches_per_batch") == 5.0
    assert _ctx(root, "submit_ms") == pytest.approx(2.0)
    # nothing to read: nothing returned, never 0
    assert _ctx(root, "scoring_roofline", peak=None) is None
    assert _ctx(root, "submit_ms", submit_s=[]) is None
    idle = SimpleNamespace(kernel_s=lambda names=None: 0.0, device=[],
                           window_s=1.0)
    for name in ("scoring_roofline", "device_ms_per_batch",
                 "device_idle_share", "launches_per_batch"):
        assert _ctx(root, name, trace=idle) is None, name


def test_peaks_name_the_card():
    peak = counts.peak_of("NVIDIA H100 80GB HBM3")
    assert peak["float32_flops"] == 67e12 and peak["bytes_per_s"] == 3.35e12
    assert counts.peak_of("some other card") is None
    assert os.path.exists(counts.PEAKS)
