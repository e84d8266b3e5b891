"""Binary-code bit packing and multi-probe dedupe.

Port of :mod:`nlsh_tpu.ops.packing`: codes pack MSB-first into int32
bucket ids (the first bit is the highest), and the per-query probe
"set" becomes a sort plus a neighbour-equality mask, so shapes stay
fixed.
"""

from __future__ import annotations

import torch

MAX_BITS = 30  # packed codes live in int32


def bit_weights(bits: int, device=None) -> torch.Tensor:
    """MSB-first powers of two: ``bit_weights(3) = [4, 2, 1]``."""
    if bits > MAX_BITS:
        raise ValueError(f"bits={bits} exceeds int32 packing limit {MAX_BITS}")
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int32, device=device)
    return torch.ones_like(shifts) << shifts


def pack_bits(codes: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., bits)`` {0,1} codes into ``(...,)`` int32 bucket ids."""
    w = bit_weights(codes.shape[-1], codes.device)
    return torch.sum(codes.to(torch.int32) * w, dim=-1, dtype=torch.int32)


def unpack_bits(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``(...,) int32 -> (..., bits)`` {0,1}."""
    shifts = torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                          device=ids.device)
    return (ids.to(torch.int32)[..., None] >> shifts) & 1


def dedupe_codes(bucket_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of ``(n, n_probes)`` ids and mask repeats.

    Returns ``(sorted_ids, valid)``; ``valid[i, j]`` is True for the
    first occurrence of each distinct id in row ``i``."""
    s = torch.sort(bucket_ids, dim=-1).values
    first = torch.ones_like(s[..., :1], dtype=torch.bool)
    valid = torch.cat([first, s[..., 1:] != s[..., :-1]], dim=-1)
    return s, valid


def hash_codes(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack + dedupe ``(n, n_probes, bits)`` codes into
    ``(bucket_ids, valid)`` of shape ``(n, n_probes)``."""
    return dedupe_codes(pack_bits(codes))
