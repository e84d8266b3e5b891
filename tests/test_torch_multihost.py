"""The port's multi-process path: 2 real processes joined by
``torch.distributed`` (gloo) over localhost through
``initialize_from_env``, each with a mesh of 2 CPU entries (4 global
entries), as ``tests/test_multihost.py`` runs the JAX package's.

Held to the JAX test's assertions (4 global entries, the gradient
``psum`` of [20, 20] and the row ``psum`` of 48, equal in both
processes), plus: a ``ShardedIndexer`` across the 4 global shards
answers as the single-table ``Indexer`` does (ids on >= 0.99 of the
slots, candidates equal), and 6 data-parallel steps over the 2 x 2
entries give the losses of the same run on a 4-entry mesh in one
process (rtol 1e-6: the gradient mean is summed per process, then
across).  The children bind gloo to the loopback interface, and a pair
whose log shows a lost port or a timed-out name lookup runs once more
on a new port."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nlsh_tpu_torch.parallel import make_mesh
from nlsh_tpu_torch.parallel.multihost import initialize_from_env
from torch_multihost_child import dp_losses

REPO = Path(__file__).resolve().parent.parent


# what a child's log shows when the rendezvous lost its port to another
# process or a name lookup timed out under load: faults of the machine,
# not of the code under test, so the pair runs once more on a new port
_SOCKET_FAULTS = ("Address already in use", "EADDRINUSE",
                  "hostname of the client socket cannot be retrieved")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(out_dir):
    """The two children on a fresh port, gloo bound to the loopback
    interface (no lookup of the host's name); returns each one's return
    code, log and output file."""
    out_dir.mkdir()
    port = _free_port()
    outs = [out_dir / f"out{i}.json" for i in range(2)]
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "NLSH_AUTO_DISTRIBUTED")}
    procs = []
    for i in range(2):
        env = dict(env_base, NLSH_COORDINATOR=f"127.0.0.1:{port}",
                   NLSH_NUM_PROCESSES="2", NLSH_PROCESS_ID=str(i),
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
                   GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_multihost_child.py"),
             str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs, outs


def test_two_process_mesh_collectives_index_and_dp(tmp_path):
    rcs, logs, outs = _run_pair(tmp_path / "first")
    if any(rcs) and any(fault in log for log in logs
                        for fault in _SOCKET_FAULTS):
        rcs, logs, outs = _run_pair(tmp_path / "again")
    for rc, log in zip(rcs, logs):
        assert rc == 0, f"child failed:\n{log}"

    results = [json.loads(o.read_text()) for o in outs]
    for i, r in enumerate(results):
        assert r["initialized"] is True
        assert r["n_processes"] == 2
        assert r["n_global_devices"] == 4  # 2 processes x 2 cpu entries
        assert r["process_index"] == i
        assert r["global_entries"] == [0, 1, 2, 3]
        for engine, s in r["sharded"].items():
            assert s["n_shards"] == 4 and s["n_local"] == 256, engine
            assert s["ids_equal"] >= 0.99 and s["cand_equal"], engine
    # entries of process 0 hold rows of value 1, those of process 1 value
    # 2: psum(sum(x)) = 2*8*1 + 2*8*2 = 48; the psum of the 4 entries'
    # gradients [2v^2, 2v^2] is 2 + 2 + 8 + 8 = 20 per component
    assert results[0]["psum"] == results[1]["psum"] == 48.0
    assert results[0]["grad"] == results[1]["grad"] == [20.0, 20.0]
    assert results[0]["sharded"] == results[1]["sharded"]
    assert results[0]["dp_losses"] == results[1]["dp_losses"]
    np.testing.assert_allclose(results[0]["dp_losses"],
                               dp_losses(make_mesh(4, platform="cpu")),
                               rtol=1e-6)


def test_initialize_from_env_needs_its_variables(monkeypatch):
    """Without the variables nothing is initialised (and the port never
    guesses a backend for an unknown platform)."""
    for name in ("NLSH_COORDINATOR", "NLSH_NUM_PROCESSES", "NLSH_PROCESS_ID",
                 "NLSH_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_from_env(platform="cpu") is False
    monkeypatch.setenv("NLSH_COORDINATOR", "127.0.0.1:1")
    assert initialize_from_env(platform="cpu") is False  # two of three unset
    with pytest.raises(ValueError, match="platform"):
        initialize_from_env(platform="tpu")
