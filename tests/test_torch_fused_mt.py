"""Port parity of the one-dispatch ensemble serve.

``_fused_mt_serve`` and ``_fused_mt_serve_batched`` of the port (plain
kernels on the CPU, where the body runs eagerly) against the JAX
package's (Pallas in interpret mode) on the same numpy inputs and the
same stacked params, bitwise at flip probes: the windowed engine at a
calibrated group count (the JAX ``lax.cond``'s first branch), at a
starved one (the body's own ``cond`` takes the static bound: the JAX
package's other branch) and at the static bound, and the fixed-cap
engine, one batch and a fresh-query pool.  Then
``MultiTableIndexer.query`` through the fused serve against its eager
``plain=True`` serve.  The card runs
the same paths as replays in ``chip_smoke.py`` (``ensemble_fused``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.parallel.multitable import MultiTableIndexer as JMT
from nlsh_tpu.parallel.multitable import _fused_mt_serve as j_mt
from nlsh_tpu.parallel.multitable import (
    _fused_mt_serve_batched as j_mt_batched,
)
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.parallel.multitable import (
    _fused_mt_async,
    _fused_mt_serve,
    _fused_mt_serve_batched,
    _windowed_needed_groups,
)
from nlsh_tpu_torch.utils.checkpoint import stacked_params_from_jax
from nlsh_tpu_torch.utils.graphs import GraphCache

L, DIM, BITS, BR, K, P = 3, 16, 6, 128, 5, 2
STARVED = 8  # groups: far below any batch's need here


def _ensemble(seed: int, n: int = 1021, nq: int = 32):
    """A small ensemble in both packages: narrow SIREN, 6 bits, random
    stacked params carried across, a clustered corpus of small dyadic
    values; returns both indexers on ``engine`` by name."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, DIM))
    pts = centers[rng.integers(0, 24, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, DIM))
    pts = (np.round(pts * 8) / 8).astype(np.float32)
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", DIM, [32]),
                   BITS)
    stacked = init_multi_table(jh, L, jax.random.PRNGKey(seed))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("siren", DIM, [32]), BITS),
        jax.tree.map(np.asarray, stacked))

    def pair(engine, j_engine):
        jm = JMT(jh, stacked, jnp.asarray(pts[:n]), metric="cosine",
                 engine=j_engine, block_rows=BR)
        tm = MultiTableIndexer(hashings, pts[:n], device="cpu",
                               metric="cosine", engine=engine, block_rows=BR)
        return jm, tm

    return pts[n:], jh, stacked, pair


def _serve_both(jm, tm, jh, stacked, queries, engine, j_engine, g):
    want = np.asarray(j_mt(
        jh, stacked, jm._serving_layout(), jnp.asarray(queries),
        jax.random.PRNGKey(0), k=K, hash_times=P, engine=j_engine,
        n_rows=tm.n_rows, g_override=g, probe_mode="flip"))
    got = _fused_mt_serve(tm.hashings, tm._serving_layout(),
                          torch.from_numpy(queries), k=K, hash_times=P,
                          engine=engine, n_rows=tm.n_rows, g_override=g,
                          probe_mode="flip")
    assert got.dtype == torch.int32 and got.shape == (len(queries), K + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def test_fused_mt_serve_windowed_matches_jax_and_guards():
    """Windowed at the calibrated count (the batch fits: the JAX
    ``lax.cond``'s first branch) bitwise the JAX package's; at the static
    bound and at a starved count (the need exceeds it: the body's
    ``cond`` serves at the static bound, the JAX package's other branch)
    the same answer, bitwise the JAX package's starved serve too.  The
    guarded result is final: ``(nq, k+1)``, no need row.  (``calibrate``
    itself is held to the JAX package's in
    ``tests/test_torch_multitable.py``.)"""
    queries, jh, stacked, pair = _ensemble(seed=2)
    jm, tm = pair("windowed", "pallas-windowed")
    g_cal = tm.calibrate(queries, hash_times=P, probe_mode="flip")
    answer = _serve_both(jm, tm, jh, stacked, queries, "windowed",
                         "pallas-windowed", g_cal)
    np.testing.assert_array_equal(
        _serve_both(jm, tm, jh, stacked, queries, "windowed",
                    "pallas-windowed", STARVED), answer)
    for g in (None, STARVED):
        np.testing.assert_array_equal(_fused_mt_serve(
            tm.hashings, tm._serving_layout(), torch.from_numpy(queries),
            k=K, hash_times=P, engine="pallas-windowed", n_rows=tm.n_rows,
            g_override=g, probe_mode="flip").numpy(), answer)
    # the batch's need did not fit the starved count: the other branch
    gp, gv = tm._flat_probes(*tm._probes(torch.from_numpy(queries),
                                         hash_times=P, probe_mode="flip"))
    need = int(_windowed_needed_groups(tm._serving_layout(), gp, gv))
    assert STARVED < need <= g_cal
    guarded = _fused_mt_async(
        tm.hashings, tm._serving_layout(), torch.from_numpy(queries), None,
        k=K, hash_times=P, engine="windowed", n_rows=tm.n_rows,
        g_override=STARVED, probe_mode="flip", repeats=None,
        graphs=GraphCache())
    assert torch.is_tensor(guarded)
    assert guarded.shape == (len(queries), K + 1)
    np.testing.assert_array_equal(guarded.numpy(), answer)


def test_fused_mt_serve_fixed_and_batched_match_jax():
    """Fixed-cap, one batch and a fresh-query pool of 3, bitwise the JAX
    package's; a guarded windowed pool takes each repeat's own branch; a
    pool of the wrong length raises."""
    queries, jh, stacked, pair = _ensemble(seed=3)
    jm, tm = pair("fixed", "pallas")
    _serve_both(jm, tm, jh, stacked, queries, "fixed", "pallas", None)
    R = 3
    pool = np.stack([queries, queries[::-1], queries * 0.5])
    want = np.asarray(j_mt_batched(
        jh, stacked, jm._serving_layout(), jnp.asarray(pool),
        jax.random.PRNGKey(0), k=K, hash_times=P, engine="pallas",
        n_rows=tm.n_rows, repeats=R, probe_mode="flip"))
    kw = dict(k=K, hash_times=P, n_rows=tm.n_rows, probe_mode="flip")
    got = _fused_mt_serve_batched(tm.hashings, tm._serving_layout(),
                                  torch.from_numpy(pool), engine="fixed",
                                  repeats=R, **kw)
    assert got.shape == (R, len(queries), K + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="fresh-query pool"):
        _fused_mt_serve_batched(tm.hashings, tm._serving_layout(),
                                torch.from_numpy(pool), engine="fixed",
                                repeats=R + 1, **kw)
    tm.engine = "windowed"
    layout = tm._serving_layout()
    for g in (None, STARVED):
        got = _fused_mt_serve_batched(tm.hashings, layout,
                                      torch.from_numpy(pool),
                                      engine="windowed", repeats=R,
                                      g_override=g, **kw)
        for i in range(R):
            np.testing.assert_array_equal(
                got[i].numpy(),
                _fused_mt_serve(tm.hashings, layout,
                                torch.from_numpy(pool[i]), engine="windowed",
                                **kw).numpy())
    roll = _fused_mt_serve_batched(tm.hashings, layout,
                                   torch.from_numpy(queries),
                                   engine="windowed", repeats=2, **kw)
    np.testing.assert_array_equal(
        roll[1].numpy(), _fused_mt_serve(
            tm.hashings, layout, torch.from_numpy(np.roll(queries, 1009, 0)),
            engine="windowed", **kw).numpy())


@pytest.mark.parametrize("engine", ["windowed", "fixed"])
def test_ensemble_query_fused_path_matches_its_eager_serve(engine):
    """``MultiTableIndexer.query`` through the fused serve against
    ``plain=True``: flip and default-seeded sampled probes, the windowed
    engine uncalibrated, calibrated and starved; ``query_async`` returns
    the final packed tensor in every case (the guard's branch is taken
    inside the serve), and ``fetch`` takes it and the plain tuple."""
    queries, _, _, pair = _ensemble(seed=4, n=700)
    _, tm = pair(engine, "pallas")
    kw = dict(k=K, hash_times=P)

    def both(**extra):
        got = tm.query(queries, **kw, **extra)
        want = tm.query(queries, plain=True, **kw, **extra)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return got

    base = both(probe_mode="flip")
    both()
    res = tm.query_async(queries, probe_mode="flip", **kw)
    assert torch.is_tensor(res) and res.shape == (len(queries), K + 1)
    if engine == "windowed":
        tm.calibrate(queries, hash_times=P, probe_mode="flip")
        assert tm.query_async(queries, probe_mode="flip", **kw).shape == \
            (len(queries), K + 1)
        for a, b in zip(both(probe_mode="flip"), base):
            np.testing.assert_array_equal(a, b)
        tm.calibrate(queries[:2], hash_times=1, probe_mode="flip")
        gp, gv = tm._flat_probes(*tm._probes(
            torch.from_numpy(queries), hash_times=P, probe_mode="flip"))
        assert tm._g_cal < int(_windowed_needed_groups(
            tm._serving_layout(), gp, gv))
        starved = tm.query_async(queries, probe_mode="flip", **kw)
        assert starved.shape == (len(queries), K + 1)
        for a, b in zip(both(probe_mode="flip"), base):
            np.testing.assert_array_equal(a, b)
    assert isinstance(tm.query_async(queries, plain=True, **kw), tuple)
    assert len(tm._graphs) == 0  # CPU tensors run the body eagerly
