"""Corpus fingerprinting for index persistence.

Own copy of :mod:`nlsh_tpu.utils.fingerprint`: ``save``/``load`` of an
index skip the corpus re-hash on restart, which makes it possible to
pair a saved table with the WRONG corpus.  The guard is a digest over a
fixed row sample (head + tail + a strided sweep through the middle) and
the exact shape.  The digest equals the JAX package's for the same rows
whether the corpus is a numpy array, a CPU tensor or a CUDA tensor, so
an index saved by either package loads in the other.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: rows hashed from each end + across the middle; O(1) in corpus size
_EDGE = 64
_STRIDED = 256

#: digest-format tag: lets ``load`` tell an artifact of an older
#: fingerprint scheme from a corpus that really differs
_VERSION = "v2"


def _sample_indices(n: int) -> np.ndarray:
    idx = np.concatenate([
        np.arange(min(_EDGE, n)),
        np.arange(max(0, n - _EDGE), n),
        np.linspace(0, n - 1, num=min(_STRIDED, n)).astype(np.int64),
    ])
    return np.unique(idx)


def corpus_fingerprint(corpus, n_real: int | None = None) -> str:
    """``"v2:<16-hex>"`` digest of ``corpus`` (numpy array or tensor on
    any device).  ``n_real`` bounds the rows considered."""
    n = int(corpus.shape[0]) if n_real is None else int(n_real)
    d = int(corpus.shape[1])
    idx = _sample_indices(n)
    if torch.is_tensor(corpus):
        # one gather of the sampled rows on the device, one copy to the host
        rows = corpus[torch.from_numpy(idx).to(corpus.device)].cpu().numpy()
    else:
        rows = np.asarray(corpus[idx])
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    h = hashlib.sha1()
    h.update(np.array([n, d], np.int64).tobytes())
    h.update(rows.tobytes())
    return f"{_VERSION}:{h.hexdigest()[:16]}"


def check_fingerprint(stored: str, corpus, n_real: int | None = None,
                      what: str = "index") -> None:
    """Raise ``ValueError`` with a precise reason when ``stored`` does
    not match ``corpus``: stale digest format (rebuild the artifact) vs
    an actual corpus mismatch."""
    if not stored.startswith(_VERSION + ":"):
        raise ValueError(
            f"saved {what} uses an older corpus-fingerprint format "
            f"({stored[:8]!r}...); rebuild and re-save the {what}"
        )
    if corpus_fingerprint(corpus, n_real=n_real) != stored:
        raise ValueError(
            f"saved {what} was built over a different corpus "
            "(fingerprint mismatch)"
        )
