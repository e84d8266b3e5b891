"""Learned hash functions (hashing heads).

Port of :mod:`nlsh_tpu.models.hashings`, the inference side
(``predict``, ``probs``, ``hash``, ``hash_hard``):

* ``MultivariateBernoulli``: encoder -> Linear -> sigmoid gives per-bit
  probabilities, the hard hash thresholds them at 0.5, and multi-probe
  either samples the bits (``probe_mode="sample"``, from an explicit
  ``torch.Generator``) or flips the least-confident ones
  (``probe_mode="flip"``).
* ``Categorical``: a softmax over ``hash_size`` buckets; multi-probe
  takes the most probable buckets.
* ``ProductQuantization``: ``n_bands`` softmax heads of
  ``2**bits_per_band`` sub-codes; the bucket id concatenates the
  per-band codes, band 0 in the highest bits.  Multi-probe samples each
  band, or (``"flip"``) walks the least-confident bands through their
  ranked alternatives.

Wherever the JAX package selects with ``lax.top_k`` (lowest index among
ties) the port sorts stably: ``torch.topk`` promises no order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nlsh_tpu_torch.ops import packing


class MultivariateBernoulli(nn.Module):
    """Per-bit Bernoulli hashing; ``tanh_output`` uses tanh rescaled to
    [0, 1] in place of the sigmoid."""

    def __init__(self, encoder: nn.Module, hash_size: int,
                 tanh_output: bool = False):
        super().__init__()
        self.encoder = encoder
        self.hash_size = hash_size
        self.tanh_output = tanh_output
        self.out = nn.Linear(encoder.output_dim, hash_size)

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hash_size

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        z = self.out(self.encoder(x))
        return torch.tanh(z) if self.tanh_output else torch.sigmoid(z)

    forward = predict

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """Bernoulli probabilities in [0, 1]."""
        p = self.predict(x)
        return p / 2.0 + 0.5 if self.tanh_output else p

    def hash(self, x: torch.Tensor, n_probes: int = 1,
             generator: torch.Generator | None = None,
             probe_mode: str = "sample") -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket ids ``(ids, valid)`` of shape ``(n, n_probes)``: probe 0
        is the hard code, the others Bernoulli samples of the code
        (``"sample"``, drawn from ``generator``) or flips of the
        least-confident bits (``"flip"``).  Ids are sorted per row, with
        repeats masked out of ``valid``."""
        if n_probes < 1:
            raise ValueError(f"`n_probes` should be a positive integer, got {n_probes}")
        if probe_mode not in ("sample", "flip"):
            raise ValueError(f"unknown probe_mode {probe_mode!r} (sample|flip)")
        p = self.probs(x)
        if probe_mode == "flip" and n_probes > 1:
            return self._hash_flip(p, n_probes)
        hard = (p > 0.5).to(torch.int32)[:, None, :]
        if n_probes == 1:
            codes = hard
        else:
            if generator is None:
                raise ValueError("multi-probe sampling needs a `generator`")
            u = torch.rand((x.shape[0], n_probes - 1, self.hash_size),
                           generator=generator, device=p.device)
            codes = torch.cat([hard, (u < p[:, None, :]).to(torch.int32)], dim=1)
        return packing.hash_codes(codes)

    def _hash_flip(self, p: torch.Tensor, n_probes: int):
        """Flip subsets of the ceil(log2(n_probes)) least-confident bits of
        the hard code, enumerated by flip mask (mask 0 = the hard code)."""
        bits = self.hash_size
        n_flip = min(max(math.ceil(math.log2(n_probes)), 1), bits)
        base = packing.pack_bits((p > 0.5).to(torch.int32))
        conf = torch.abs(p - 0.5)
        # the JAX package takes lax.top_k(-conf), which keeps the lowest
        # bit index among equal confidences; a stable ascending sort does
        # the same (torch.topk promises no order among ties)
        flip_pos = torch.sort(conf, dim=1, stable=True).indices[:, :n_flip]
        weights = (1 << (bits - 1 - flip_pos)).to(torch.int32)
        masks = torch.arange(n_probes, dtype=torch.int32, device=p.device)
        shifts = torch.arange(n_flip, dtype=torch.int32, device=p.device)
        take = (masks[None, :, None] >> shifts) & 1       # (1, P, n_flip)
        xor = torch.sum(take * weights[:, None, :], dim=-1, dtype=torch.int32)
        return packing.dedupe_codes(torch.bitwise_xor(base[:, None], xor))

    def hash_hard(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic single bucket id per row: ``(n,)`` int32."""
        return packing.pack_bits((self.probs(x) > 0.5).to(torch.int32))


def _ranked(p: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last dim, descending, the
    lowest index first among equal values (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(p, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class Categorical(nn.Module):
    """Softmax-over-buckets hashing: ``hash_size`` is the number of
    buckets, and multi-probe takes the ``n_probes`` most probable."""

    def __init__(self, encoder: nn.Module, hash_size: int):
        super().__init__()
        self.encoder = encoder
        self.hash_size = hash_size
        self.out = nn.Linear(encoder.output_dim, hash_size)

    @property
    def n_buckets(self) -> int:
        return self.hash_size

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.out(self.encoder(x)), dim=-1)

    forward = predict
    probs = predict

    def hash(self, x: torch.Tensor, n_probes: int = 1,
             generator: torch.Generator | None = None,
             probe_mode: str = "sample") -> tuple[torch.Tensor, torch.Tensor]:
        """The ``n_probes`` most probable buckets, ids sorted per row.
        Deterministic, so ``generator`` and ``probe_mode`` are accepted
        for a uniform interface only.  Probe slots past ``hash_size``
        repeat the last id and are masked out of ``valid``."""
        if n_probes < 1:
            raise ValueError(f"`n_probes` should be a positive integer, got {n_probes}")
        k_eff = min(n_probes, self.hash_size)
        ids = _ranked(self.predict(x), k_eff)[1].to(torch.int32)
        if k_eff < n_probes:
            ids = torch.cat([ids, ids[:, -1:].expand(-1, n_probes - k_eff)],
                            dim=-1)
        return packing.dedupe_codes(ids)

    def hash_hard(self, x: torch.Tensor) -> torch.Tensor:
        # argmax returns the first of equal maxima, as jnp.argmax does
        return torch.argmax(self.predict(x), dim=-1).to(torch.int32)


class ProductQuantization(nn.Module):
    """Learned product-quantisation hashing: the encoder output feeds
    ``n_bands`` independent softmax heads of ``2**bits_per_band``
    sub-codes each.  ``predict`` returns the concatenated band
    probabilities ``(n, n_bands * 2**bits_per_band)``."""

    def __init__(self, encoder: nn.Module, n_bands: int, bits_per_band: int):
        super().__init__()
        self.encoder = encoder
        self.n_bands = n_bands
        self.bits_per_band = bits_per_band
        if self.hash_size > packing.MAX_BITS:
            raise ValueError(f"{self.hash_size} bits exceed the int32 packing "
                             f"limit {packing.MAX_BITS}")
        self.out = nn.Linear(encoder.output_dim, n_bands * self.band_size)

    @property
    def band_size(self) -> int:
        return 2 ** self.bits_per_band

    @property
    def hash_size(self) -> int:
        return self.n_bands * self.bits_per_band

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hash_size

    def _band_probs(self, x: torch.Tensor) -> torch.Tensor:
        z = self.out(self.encoder(x))
        return torch.softmax(z.reshape(x.shape[0], self.n_bands,
                                       self.band_size), dim=-1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self._band_probs(x).reshape(x.shape[0], -1)

    forward = predict
    probs = predict

    def _pack_bands(self, band_codes: torch.Tensor) -> torch.Tensor:
        """``(..., n_bands)`` sub-codes -> packed int32, band 0 high bits."""
        shifts = self.bits_per_band * torch.arange(
            self.n_bands - 1, -1, -1, dtype=torch.int32,
            device=band_codes.device)
        return torch.sum(band_codes.to(torch.int32) << shifts, dim=-1,
                         dtype=torch.int32)

    def hash_hard(self, x: torch.Tensor) -> torch.Tensor:
        return self._pack_bands(torch.argmax(self._band_probs(x), dim=-1))

    def hash(self, x: torch.Tensor, n_probes: int = 1,
             generator: torch.Generator | None = None,
             probe_mode: str = "sample") -> tuple[torch.Tensor, torch.Tensor]:
        """Probe 0 is the hard code; the others sample each band's
        categorical from ``generator`` (``"sample"``) or are the
        deterministic best-first probes of :meth:`_hash_flip`
        (``"flip"``).  Sampled ids are sorted per row, repeats masked."""
        if n_probes < 1:
            raise ValueError(f"`n_probes` should be a positive integer, got {n_probes}")
        p = self._band_probs(x)                                # (n, M, B)
        if probe_mode == "flip" and n_probes > 1:
            return self._hash_flip(p, n_probes)
        codes = torch.argmax(p, dim=-1)[:, None, :]            # (n, 1, M)
        if n_probes > 1:
            if generator is None:
                raise ValueError("multi-probe hashing needs a `generator`")
            # inverse-CDF draw of every (row, probe, band) categorical
            u = torch.rand((x.shape[0], n_probes - 1, self.n_bands),
                           generator=generator, device=p.device)
            cdf = torch.cumsum(p, dim=-1)
            cdf = cdf / cdf[..., -1:]
            sampled = torch.sum(u[..., None] >= cdf[:, None], dim=-1)
            sampled = torch.clamp(sampled, max=self.band_size - 1)
            codes = torch.cat([codes, sampled], dim=1)         # (n, P, M)
        return packing.dedupe_codes(self._pack_bands(codes))

    def _hash_flip(self, p: torch.Tensor, n_probes: int):
        """Deterministic best-first PQ multi-probe.  Bands are ordered
        least-confident first (smallest top1/top2 log-margin) and probe
        ``m``'s base-``B`` digits (B = band_size) pick each band's
        ``digit``-th best sub-code; digit 0 varies fastest, so early
        probes sweep the least-confident band through its ranked
        alternatives before touching better-separated bands.  Probes are
        pairwise distinct (distinct digit vectors give distinct codes)
        and a fixed prefix as ``n_probes`` grows.

        The digit slots are counted with integers: the smallest ``j``
        with ``B**j >= n_probes``.  (The JAX package divides float logs,
        which can round to one slot too few or too many at
        ``n_probes = B**j``.)"""
        n, B = p.shape[0], self.band_size
        if n_probes > self.n_buckets:
            raise ValueError(
                f"n_probes {n_probes} exceeds n_buckets {self.n_buckets}")
        vals, ranked = _ranked(p, B)               # (n, M, B): band rankings
        if B > 1:
            margin = torch.log(vals[..., 0] + 1e-20) \
                - torch.log(vals[..., 1] + 1e-20)
        else:
            margin = torch.zeros_like(vals[..., 0])
        order = torch.argsort(margin, dim=-1, stable=True)
        n_slots = 1
        while B ** n_slots < n_probes and n_slots < self.n_bands:
            n_slots += 1
        probes = torch.arange(n_probes, device=p.device)
        digits = (probes[:, None] // (B ** torch.arange(
            n_slots, device=p.device))) % B                    # (P, slots)
        # slot j is the j-th least-confident band of each query: scatter
        # its digit to that band (bands without a slot keep rank 0)
        rank = torch.zeros((n, n_probes, self.n_bands), dtype=torch.int64,
                           device=p.device)
        rank.scatter_(2, order[:, None, :n_slots].expand(-1, n_probes, -1),
                      digits[None].expand(n, -1, -1))
        codes = torch.gather(ranked[:, None].expand(-1, n_probes, -1, -1), 3,
                             rank[..., None])[..., 0]          # (n, P, M)
        ids = self._pack_bands(codes)
        return ids, torch.ones((n, n_probes), dtype=torch.bool,
                               device=p.device)


def pq_band_split(hash_size: int) -> tuple[int, int]:
    """``(n_bands, bits_per_band)`` of ``hash_size`` total bits: 4-bit
    bands where they divide it, else 2-bit, else 1-bit."""
    bits_per_band = 4 if hash_size % 4 == 0 else (
        2 if hash_size % 2 == 0 else 1)
    return hash_size // bits_per_band, bits_per_band


def get_hashing(hashing_type: str, encoder: nn.Module, hash_size: int) -> nn.Module:
    """Factory keyed like the JAX package's ``get_hashing``."""
    if hashing_type == "MultivariateBernoulli":
        return MultivariateBernoulli(encoder, hash_size)
    if hashing_type == "MultivariateBernoulliTanh":
        return MultivariateBernoulli(encoder, hash_size, tanh_output=True)
    if hashing_type == "Categorical":
        return Categorical(encoder, hash_size)
    if hashing_type == "ProductQuantization":
        return ProductQuantization(encoder, *pq_band_split(hash_size))
    raise ValueError(f"{hashing_type!r} is not a valid hashing type")
