"""Serving layout, the serving engines' preps and their scoring kernels.

Port of the serving half of :mod:`nlsh_tpu.ops.pallas.query_kernel`:

* **Layout** (:func:`serving_layout`): corpus rows permuted into bucket
  order, each bucket starting at an ``align``-row boundary, and
  metric-extended so that a higher score is always nearer: cosine rows
  are L2-normalised (score = q.c); euclidean rows stay raw, queries are
  doubled and ``||c||^2`` rides a separate ``norms`` array (score =
  2q.c - ||c||^2).  ``n_aligned`` keeps the JAX package's ``+cap`` slack
  and rounding to ``block_rows``, so the arrays compare bitwise.  Rows
  are f32, bf16 or int8; an int8 layout carries its dequantisation
  ``scale`` (one global scale, folded into the queries by
  :func:`extend_queries`, or one per row, applied to the scores before
  the norms).
* **Grouped prep** (:func:`_grouped_prep_v2`): sorts the (query, probe)
  events by bucket and builds the group tables: one group per
  (bucket block, <= G probing queries).  Torch ops, not kernels.
* **Windowed prep** (:func:`_windowed_prep`): expands each event into
  its ``block_rows``-row window sub-events of a dense (8-row-aligned)
  layout, sorts them by window and builds the group tables: one group
  per (window, <= G sub-events), each slot carrying its bucket's
  ``[lo, hi)`` lane range.  With the bounds
  :func:`windowed_needed_groups` (exact, on the device) and
  :func:`windowed_static_bound`.  Torch ops, not kernels.
* **Kernels**: K1 :func:`grouped_scores_topk` (fused scores, mask and
  per-row top-kk), K2 :func:`grouped_scores` (raw panels), K3
  :func:`windowed_scores_topk` (K1 with a ``[lo, hi)`` mask per slot),
  K4 :func:`windowed_scores` (raw windowed panels) and K7
  :func:`int8_block_scores` (K2's kernel on int8 blocks), written in
  CUDA C++: K1 and K3 in ``csrc/grouped_topk.cu``, K2, K4 and K7 in
  ``csrc/grouped_scores.cu``; K5 :func:`bucket_scores_auto`
  and K6 :func:`bucket_scores_impl`, the fixed-cap engine's masked
  per-event scores behind the entry :func:`bucket_scores`, in
  ``csrc/bucket_scores.cu`` (one kernel, on the events sorted by the
  rows they read: :func:`_bucket_event_order`).  Each has its plain
  PyTorch version beside it (``*_plain``).  A wrapper runs the plain
  version only for tensors on the CPU; on a CUDA tensor it launches its
  kernel or raises.

Parity notes (where a port of this module breaks most easily):

* ties — the JAX kernel keeps the lowest lane among equal scores and
  ``lax.top_k`` the lowest index; ``torch.topk`` promises no order, so
  every selection here is a stable sort, sliced;
* ``mode="drop"`` scatters — torch has none: scatter into one sentinel
  row past the end and slice it off;
* ``searchsorted(side="right")`` is ``right=True`` and
  ``associative_scan(max)`` is ``torch.cummax``;
* int8 rounding is half to even in both (``torch.round``, ``jnp.round``);
* storage stays int32 as in JAX; indices widen to int64 only to index.
* the numpy ``*_host`` layout functions (:func:`serving_layout_host`) are
  bitwise twins of the torch ones wherever the float math is exact
  (corpora of small dyadic values); numpy has no bf16, so they round
  f32 to bf16 half to even on the bit patterns (:func:`_bf16_bits`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

LANE = 128         # feature dim padded to a multiple (the TPU lane width)
BLOCK_ROWS = 512   # default rows per grouped-engine block
GROUP_Q = 8        # the prep's default queries per group
GROUP_W = 32       # queries per group of the grouped and windowed serves
_GROUP_EB = 8      # group tables round up to a multiple of this
ROW_TOPK = 16      # widest per-row top-k of the fused kernel (K1)

# launches of each kernel; a wrapper adds one where it launches
KERNEL_LAUNCHES = {"grouped_scores_topk": 0, "grouped_scores": 0,
                   "windowed_scores_topk": 0, "windowed_scores": 0,
                   "bucket_scores_auto": 0, "bucket_scores_impl": 0,
                   "int8_block_scores": 0}

# what the csrc kernels take; the wrappers check it before a launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # `dtype`
_TILE = 128                # block_rows and d_pad are multiples of this
_MAX_G = 32                # their kMaxG
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block may use on sm_90
# grouped_topk.cu (K1, K3): its ring of kStages stages of 128 rows x
# kRowStride bytes, kCap (score, lane) candidates per slot, and at most
# kMaxTiles tiles of 128 rows per block
_TOPK_STAGES, _TOPK_ROW_STRIDE, _TOPK_CAP, _TOPK_MAX_TILES = 2, 144, 64, 64
# grouped_scores.cu (K2, K4, K7): its ring of kStages stages, each
# kTileRows rows x kRowStride bytes (kStageBytes of each row) and the
# same bytes' features of kMaxG f32 query rows
_PANEL_STAGES, _PANEL_TILE_ROWS, _PANEL_STAGE_BYTES = 2, 256, 128
# bucket_scores.cu (K5, K6): kMaxG events of the sorted order per work
# item; its ring is the raw-panel kernel's, beside two items' tables (7
# ints per event and the stage count each) in static shared memory
_BUCKET_G = 32
_BUCKET_ITEM_BYTES = 2 * 4 * (7 * _BUCKET_G + 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _br(block_rows: int | None) -> int:
    return block_rows if block_rows else BLOCK_ROWS


class ServingLayout(NamedTuple):
    """Bucket-contiguous, metric-extended corpus for the serving path."""

    data: torch.Tensor        # (n_aligned, d_pad) f32/bf16/int8, bucket-major
    row_map: torch.Tensor     # (n_aligned,) int32 -> corpus row, -1 pad
    starts: torch.Tensor      # (n_buckets,) int32 aligned bucket offsets
    counts: torch.Tensor      # (n_buckets,) int32
    cap: int                  # rows served per probed bucket
    d_pad: int
    align: int                # bucket start alignment in rows
    metric: str
    total_blocks: int = 0     # sum_b ceil(min(count, cap) / block_rows)
    norms: torch.Tensor | None = None  # (n_aligned,) f32 ||c||^2, euclidean
    block_rows: int = 0       # rows per grouped-engine block; 0 = default
    # int8 dequantisation: () f32 global (data = round(ext / scale), folded
    # into the queries) or (n_aligned,) f32 per row (applied to the scores
    # before the norms; 1.0 on padding rows); None for f32/bf16
    scale: torch.Tensor | None = None

    @property
    def n_rows(self) -> int:
        return self.row_map.shape[0]

    @property
    def br(self) -> int:
        return _br(self.block_rows)


def _scatter_drop(n: int, index: torch.Tensor, values: torch.Tensor,
                  fill) -> torch.Tensor:
    """``full((n, ...), fill).at[index].set(values, mode="drop")``: rows
    with an index outside ``[0, n)`` land in a sentinel row past the end,
    which is sliced off."""
    index = torch.where((index >= 0) & (index < n), index, n)
    out = torch.full((n + 1,) + values.shape[1:], fill, dtype=values.dtype,
                     device=values.device)
    out[index] = values
    return out[:n]


def _check_scale_mode(scale_mode: str) -> None:
    if scale_mode not in ("global", "per_row"):
        raise ValueError(
            f"unknown int8 scale_mode {scale_mode!r} (global|per_row)")


def _metric_ext(corpus, metric: str):
    """Metric-extended rows (cosine: L2-normalised) and, for euclidean,
    the f32 squared norms (None for cosine)."""
    if metric == "cosine":
        nrm = torch.linalg.vector_norm(corpus, dim=1, keepdim=True)
        return corpus / torch.clamp(nrm, min=1e-12), None
    if metric in ("euclidean", "sq_euclidean"):
        return corpus, torch.sum(corpus * corpus, dim=1)
    raise ValueError(f"unsupported serving metric {metric!r}")


def ext_scales(corpus, metric: str, scale_mode: str) -> torch.Tensor:
    """int8 quantisation scale(s) in metric-EXTENDED space: () f32 for
    ``"global"``, ``(n,)`` f32 for ``"per_row"``."""
    ext, _ = _metric_ext(corpus, metric)
    peak = torch.max(torch.abs(ext)) if scale_mode == "global" else \
        torch.max(torch.abs(ext), dim=1).values
    return _over_127(peak)


def _over_127(peak: torch.Tensor) -> torch.Tensor:
    """``peak / 127`` as one correctly rounded f32 division.  The divisor
    is a tensor on ``peak``'s device: by a Python scalar a CUDA tensor is
    multiplied with the reciprocal, which can land one step away from the
    quotient the CPU, numpy and the JAX package give."""
    return (peak / torch.tensor(127.0, dtype=peak.dtype, device=peak.device)
            ).to(torch.float32)


def layout_arrays(row_ids, starts, counts, corpus, cap: int, n_aligned: int,
                  metric: str, dtype=torch.float32, align: int | None = None,
                  scale=None):
    """Layout core: ``(data, row_map, aligned_starts, norms, scale_rows)``
    with shapes ``(n_aligned, d_pad)`` / ``(n_aligned,)``; ``norms`` is
    None for cosine, ``scale_rows`` None unless per-row int8.

    ``dtype=torch.int8`` quantises rows as ``round(ext / scale)`` clipped
    to [-127, 127]; ``scale`` is a () global scale (default ``max|ext| /
    127`` over this corpus) or an ``(n,)`` per-corpus-row scale.
    Euclidean ``norms`` are then of the DEQUANTISED rows."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported layout dtype {dtype}")
    n, _ = corpus.shape
    align = cap if align is None else align
    ext, sq = _metric_ext(corpus, metric)

    scale_per_row = None
    if dtype == torch.int8:
        if scale is None:
            scale = _over_127(torch.max(torch.abs(ext)))
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=corpus.device)
        div = scale if scale.ndim == 0 else \
            torch.clamp(scale, min=1e-30)[:, None]
        ext = torch.clamp(torch.round(ext / div), -127, 127)
        if scale.ndim == 1:
            scale_per_row = torch.clamp(scale, min=1e-30)
        if sq is not None:  # norms of the dequantised rows
            eff = scale if scale.ndim == 0 else scale_per_row
            sq = torch.sum(ext * ext, dim=1) * eff * eff
    d_ext = ext.shape[1]
    d_pad = _round_up(d_ext, LANE)

    counts = counts.long()
    starts = starts.long()
    aligned_sizes = ((counts + align - 1) // align) * align
    aligned_starts = torch.cumsum(aligned_sizes, 0) - aligned_sizes
    i = torch.arange(n, device=corpus.device)
    bucket_of = torch.searchsorted(starts, i, right=True) - 1
    aligned_pos = aligned_starts[bucket_of] + (i - starts[bucket_of])
    # rows past the real count (sentinel-hashed rows sort to the tail) drop
    aligned_pos = torch.where(i < counts.sum(), aligned_pos, n_aligned)

    rid = row_ids.long()
    sorted_ext = torch.zeros((n, d_pad), dtype=dtype, device=corpus.device)
    sorted_ext[:, :d_ext] = ext[rid].to(dtype)
    data = _scatter_drop(n_aligned, aligned_pos, sorted_ext, 0)
    row_map = _scatter_drop(n_aligned, aligned_pos, row_ids.to(torch.int32), -1)
    norms = None
    if sq is not None:
        norms = _scatter_drop(n_aligned, aligned_pos,
                              sq[rid].to(torch.float32), 0)
    scale_rows = None
    if scale_per_row is not None:
        # padding rows keep scale 1.0: masked lanes never turn inf or nan
        scale_rows = _scatter_drop(n_aligned, aligned_pos,
                                   scale_per_row[rid], 1.0)
    return data, row_map, aligned_starts.to(torch.int32), norms, scale_rows


def round_cap(cap: int, block_rows: int | None = None) -> int:
    """cap as a whole number of ``block_rows``-row blocks."""
    br = _br(block_rows)
    return max(_round_up(cap, br), br)


def aligned_rows(counts, cap: int, align: int | None = None) -> int:
    """Row count of a layout for given bucket counts, ``+ cap`` slack."""
    align = cap if align is None else align
    counts = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    aligned_sizes = ((counts.astype(np.int64) + align - 1) // align) * align
    return int(aligned_sizes.sum()) + cap


def serving_layout(table, corpus: torch.Tensor, metric: str = "cosine",
                   cap: int | None = None, dtype=torch.float32,
                   align: int | None = None, block_rows: int | None = None,
                   device=None, scale_mode: str = "per_row") -> ServingLayout:
    """Build the serving layout from a CSR bucket table on ``device``
    (default: the corpus's).  ``cap`` (default: the largest bucket) is
    rounded up to whole blocks; buckets past it are truncated at query
    time.  ``dtype=torch.bfloat16`` halves the streamed bytes and
    ``torch.int8`` quarters them, with ``scale_mode`` ``"per_row"`` (one
    scale per row) or ``"global"`` (one for the corpus); queries stay
    f32 either way."""
    device = corpus.device if device is None else torch.device(device)
    br = _br(block_rows)
    counts_np = table.counts.cpu().numpy()
    if cap is None:
        cap = int(counts_np.max())
    cap = round_cap(cap, br)
    align = cap if align is None else max(_round_up(align, 8), 8)
    n_aligned = _round_up(aligned_rows(counts_np, cap, align=align), br)
    total_blocks = int((-(-np.minimum(counts_np, cap) // br)).sum())
    counts = table.counts.to(device)
    corpus = corpus.to(device)
    scale = None
    if dtype == torch.int8:
        _check_scale_mode(scale_mode)
        scale = ext_scales(corpus, metric, scale_mode)
    data, row_map, starts, norms, scale_rows = layout_arrays(
        table.row_ids.to(device), table.starts.to(device), counts,
        corpus, cap=cap, n_aligned=n_aligned, metric=metric,
        dtype=dtype, align=align, scale=scale,
    )
    return ServingLayout(
        data=data, row_map=row_map, starts=starts, counts=counts, cap=cap,
        d_pad=data.shape[1], align=align, metric=metric,
        total_blocks=total_blocks, norms=norms, block_rows=br,
        scale=scale_rows if scale_rows is not None else scale,
    )


def _metric_ext_host(corpus: np.ndarray, metric: str):
    """Numpy twin of :func:`_metric_ext`."""
    if metric == "cosine":
        nrm = np.linalg.norm(corpus, axis=1, keepdims=True)
        return corpus / np.maximum(nrm, np.float32(1e-12)), None
    if metric in ("euclidean", "sq_euclidean"):
        return corpus, np.einsum("nd,nd->n", corpus, corpus).astype(np.float32)
    raise ValueError(f"unsupported serving metric {metric!r}")


def ext_scales_host(corpus, metric: str, scale_mode: str):
    """Numpy twin of :func:`ext_scales`: both divide the same f32 maxima
    by 127.  A float for ``"global"``, ``(n,)`` f32 for ``"per_row"``."""
    ext, _ = _metric_ext_host(np.asarray(corpus, np.float32), metric)
    if scale_mode == "global":
        return float(np.abs(ext).max() / np.float32(127.0))
    return (np.abs(ext).max(axis=1) / np.float32(127.0)).astype(np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> the uint16 bit patterns of its bf16 rounding, half to even
    (what ``tensor.to(torch.bfloat16)`` and ``astype(jnp.bfloat16)``
    give); NaNs stay quiet NaNs of their sign."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
               ) >> np.uint32(16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (u >> np.uint32(16)) | np.uint32(0x0040)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def layout_arrays_host(row_ids, starts, counts, corpus, cap: int,
                       n_aligned: int, metric: str, dtype=torch.float32,
                       align: int | None = None, scale=None):
    """Numpy twin of :func:`layout_arrays`: permutes on the host, so only
    dense, ready arrays go to the device.  Returns numpy ``(data,
    row_map, aligned_starts, norms, scale_rows)``; bf16 ``data`` is the
    uint16 bit patterns (numpy has no bf16)."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported layout dtype {dtype}")
    row_ids = np.asarray(row_ids)
    starts = np.asarray(starts).astype(np.int64)
    counts = np.asarray(counts).astype(np.int64)
    corpus = np.asarray(corpus, np.float32)
    align = cap if align is None else align
    ext, sq = _metric_ext_host(corpus, metric)

    scale_per_row = None
    if dtype == torch.int8:
        if scale is None:
            scale = np.abs(ext).max() / np.float32(127.0)
        scale = np.asarray(scale, np.float32)
        div = scale if scale.ndim == 0 else \
            np.maximum(scale, np.float32(1e-30))[:, None]
        ext = np.clip(np.round(ext / div), -127, 127)   # half to even
        if scale.ndim == 1:
            scale_per_row = np.maximum(scale, np.float32(1e-30))
        if sq is not None:  # norms of the dequantised rows
            eff = scale if scale.ndim == 0 else scale_per_row
            sq = (np.einsum("nd,nd->n", ext, ext) * eff * eff
                  ).astype(np.float32)
    d_ext = ext.shape[1]
    d_pad = _round_up(d_ext, LANE)

    aligned_sizes = ((counts + align - 1) // align) * align
    aligned_starts = np.cumsum(aligned_sizes) - aligned_sizes
    i = np.arange(row_ids.shape[0], dtype=np.int64)
    bucket_of = np.searchsorted(starts, i, side="right") - 1
    aligned_pos = aligned_starts[bucket_of] + (i - starts[bucket_of])
    valid = i < counts.sum()  # sentinel-hashed rows sort to the tail

    ap, rid = aligned_pos[valid], row_ids[valid]
    if dtype == torch.bfloat16:
        data = np.zeros((n_aligned, d_pad), np.uint16)
        data[ap, :d_ext] = _bf16_bits(ext[rid])
    else:
        np_dtype = np.int8 if dtype == torch.int8 else np.float32
        data = np.zeros((n_aligned, d_pad), np_dtype)
        data[ap, :d_ext] = ext[rid].astype(np_dtype)
    row_map = np.full((n_aligned,), -1, np.int32)
    row_map[ap] = rid
    norms = None
    if sq is not None:
        norms = np.zeros((n_aligned,), np.float32)
        norms[ap] = sq[rid]
    scale_rows = None
    if scale_per_row is not None:
        scale_rows = np.ones((n_aligned,), np.float32)
        scale_rows[ap] = scale_per_row[rid]
    return data, row_map, aligned_starts.astype(np.int32), norms, scale_rows


def _host_data_tensor(data: np.ndarray, dtype, device) -> torch.Tensor:
    """A host-built ``data`` array on ``device`` (bf16 arrives as bits)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(data.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(data).to(device)


def serving_layout_host(table, corpus, metric: str = "cosine",
                        cap: int | None = None, dtype=torch.float32,
                        align: int | None = None,
                        block_rows: int | None = None, *, device,
                        scale_mode: str = "per_row") -> ServingLayout:
    """Host-built :func:`serving_layout`: the same layout, permuted and
    quantised in numpy from a host corpus (numpy or CPU tensor), so the
    device holds the finished arrays only and never the raw corpus."""
    device = torch.device(device)
    br = _br(block_rows)
    corpus = corpus.cpu().numpy() if torch.is_tensor(corpus) else \
        np.asarray(corpus, np.float32)
    counts_np = table.counts.cpu().numpy()
    if cap is None:
        cap = int(counts_np.max())
    cap = round_cap(cap, br)
    align = cap if align is None else max(_round_up(align, 8), 8)
    n_aligned = _round_up(aligned_rows(counts_np, cap, align=align), br)
    total_blocks = int((-(-np.minimum(counts_np, cap) // br)).sum())
    scale = None
    if dtype == torch.int8:
        _check_scale_mode(scale_mode)
        scale = ext_scales_host(corpus, metric, scale_mode)
    data, row_map, starts, norms, scale_rows = layout_arrays_host(
        table.row_ids.cpu().numpy(), table.starts.cpu().numpy(), counts_np,
        corpus, cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
        align=align, scale=scale)
    if scale_rows is not None:
        scale = torch.from_numpy(scale_rows).to(device)
    elif scale is not None:
        scale = torch.tensor(scale, dtype=torch.float32, device=device)
    return ServingLayout(
        data=_host_data_tensor(data, dtype, device),
        row_map=torch.from_numpy(row_map).to(device),
        starts=torch.from_numpy(starts).to(device),
        counts=torch.from_numpy(counts_np.astype(np.int32)).to(device),
        cap=cap, d_pad=data.shape[1], align=align, metric=metric,
        total_blocks=total_blocks,
        norms=None if norms is None else torch.from_numpy(norms).to(device),
        block_rows=br, scale=scale,
    )


def extend_queries(layout: ServingLayout, queries: torch.Tensor) -> torch.Tensor:
    """Metric-extend and zero-pad queries to ``(nq, d_pad)`` f32 to match
    the layout (cosine: L2-normalised; euclidean: doubled).  A global
    int8 scale folds in here, so the kernels' dots come out in
    dequantised units."""
    nq, d = queries.shape
    if layout.metric == "cosine":
        norms = torch.linalg.vector_norm(queries, dim=1, keepdim=True)
        ext = queries / torch.clamp(norms, min=1e-12)
    else:
        ext = 2.0 * queries
    if layout.scale is not None and layout.scale.ndim == 0:
        ext = ext * layout.scale
    out = torch.zeros((nq, layout.d_pad), dtype=torch.float32,
                      device=queries.device)
    out[:, :d] = ext.to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# grouped prep: sort probe events by bucket, build the group tables
# ---------------------------------------------------------------------------

def round_group_override(g_exact: int, static_bound: int) -> int:
    """Round an exact group bound up to ``_GROUP_EB`` times a power of
    two, clamped to the static bound."""
    units = max(-(-int(g_exact) // _GROUP_EB), 1)
    return int(min(_GROUP_EB * (1 << (units - 1).bit_length()),
                   int(static_bound)))


def grouped_exact_bound(counts, probe_ids, probe_valid, cap: int,
                        group_q: int, block_rows: int | None = None) -> int:
    """EXACT group count of :func:`_grouped_prep_v2` for a concrete
    probe batch, on the host: ``sum_b nb_b * ceil(m_b / G)``."""
    br = _br(block_rows)
    counts = counts.cpu().numpy()
    pid = probe_ids.cpu().numpy().reshape(-1)
    pv = probe_valid.cpu().numpy().reshape(-1)
    n_buckets = counts.shape[0]
    ok = pv & (pid >= 0) & (pid < n_buckets)
    m = np.bincount(pid[ok], minlength=n_buckets)
    nb = -(-np.minimum(counts, cap) // br)
    return int(np.sum(nb * -(-m // group_q)))


def grouped_static_bound(n_events: int, max_blocks: int, total_blocks: int,
                         group_q: int) -> int:
    """Upper bound on the group count for ANY batch of ``n_events``
    probe events: ``E*maxB/G + min(total_blocks, E*maxB)``."""
    block_events = n_events * max_blocks
    probed_blocks = min(total_blocks, block_events) if total_blocks > 0 \
        else block_events
    return int(-(-block_events // group_q) + probed_blocks)


def _probe_counts(layout_counts, probe_ids, probe_valid, cap: int):
    """Clipped bucket ids and their served counts (0 on invalid probes)."""
    n_buckets = layout_counts.shape[0]
    safe = torch.clamp(probe_ids.long(), 0, n_buckets - 1)
    counts = torch.where(probe_valid,
                         torch.clamp(layout_counts[safe], max=cap), 0)
    return safe, counts


def _run_ranks(sk):
    """For sorted keys: the mask of each run's first key, and each key's
    rank inside its run of equal keys."""
    pos = torch.arange(sk.shape[0], device=sk.device)
    unique = torch.ones_like(sk, dtype=torch.bool)
    unique[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(unique, pos, -1), 0).values
    return unique, pos - first


def _sorted_probe_events(layout_starts, layout_counts, probe_ids,
                         probe_valid, cap: int):
    """Sort (query, probe) events by bucket id.  Returns per sorted event
    (bucket key, qidx, rank in bucket, bucket multiplicity), the
    histogram, the order and the served counts."""
    nq, n_probes = probe_ids.shape
    n_buckets = layout_counts.shape[0]
    safe, counts = _probe_counts(layout_counts, probe_ids, probe_valid, cap)
    key = torch.where(counts > 0, safe, n_buckets).reshape(-1)   # (E,)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    sq = torch.arange(nq, device=key.device).repeat_interleave(n_probes)[order]
    _, rank = _run_ranks(sk)
    hist = torch.bincount(key, minlength=n_buckets + 1)
    m = hist[torch.clamp(sk, 0, n_buckets)]
    return sk, sq, rank, m, hist, order, counts


def _bucket_blocks(layout_counts, cap: int, block_rows: int | None = None):
    """Blocks per bucket under the cap: ceil(min(count, cap) / block_rows)."""
    capped = torch.clamp(layout_counts.long(), max=cap)
    return -(-capped // _br(block_rows))


def count_groups_v2(layout_starts, layout_counts, probe_ids, probe_valid,
                    cap: int, group_q: int = GROUP_Q,
                    block_rows: int | None = None) -> torch.Tensor:
    """Closed-form group count, no sort: sum_b nb_b * ceil(m_b / G)."""
    n_buckets = layout_counts.shape[0]
    safe, counts = _probe_counts(layout_counts, probe_ids, probe_valid, cap)
    key = torch.where(counts > 0, safe, n_buckets).reshape(-1)
    hist = torch.bincount(key, minlength=n_buckets + 1)[:n_buckets]
    nb = _bucket_blocks(layout_counts, cap, block_rows)
    return torch.sum(nb * (-(-hist // group_q))).to(torch.int32)


def _grouped_prep_v2(layout_starts, layout_counts, probe_ids, probe_valid,
                     queries_ext, cap: int, g_total: int, max_blocks: int,
                     group_q: int = GROUP_Q, block_rows: int | None = None):
    """Group tables and the event -> row map, with only an (nq*P)-key sort.

    Returns ``(grp_block (g,) i32, grp_qvecs (g, G, d_pad) f32,
    grp_cnt (g, G) i32, ev_row (E, maxB) i32, ev_block (E, maxB) i32,
    ev_valid (E, maxB) bool)``; groups past ``g_total`` are dropped, as
    in the JAX package."""
    br = _br(block_rows)
    nq, n_probes = probe_ids.shape
    n_buckets = layout_counts.shape[0]
    dev = probe_ids.device
    sk, sq, rank, _, hist, order, _ = _sorted_probe_events(
        layout_starts, layout_counts, probe_ids, probe_valid, cap)
    nb_bucket = _bucket_blocks(layout_counts, cap, br)
    groups_per_j = -(-hist[:n_buckets] // group_q)
    groups_per_bucket = nb_bucket * groups_per_j
    group_base = torch.cumsum(groups_per_bucket, 0) - groups_per_bucket

    sk_safe = torch.clamp(sk, 0, n_buckets - 1)
    s_valid = sk < n_buckets
    base_block = layout_starts[sk_safe].long() // br
    s_count = torch.clamp(layout_counts[sk_safe].long(), max=cap)
    s_nb = -(-s_count // br)
    s_gpj = groups_per_j[sk_safe]
    s_gbase = group_base[sk_safe]

    j = torch.arange(max_blocks, device=dev)
    ev_valid_s = s_valid[:, None] & (j[None, :] < s_nb[:, None])   # (E, maxB)
    g = s_gbase[:, None] + j[None, :] * s_gpj[:, None] \
        + (rank // group_q)[:, None]
    slot = rank % group_q
    g_drop = torch.where(ev_valid_s, g, g_total).reshape(-1)
    blockno = base_block[:, None] + j[None, :]
    cnt_ij = torch.clamp(s_count[:, None] - j[None, :] * br, 0, br)

    grp_block = _scatter_drop(g_total, g_drop,
                              blockno.reshape(-1).to(torch.int32), 0)
    # (group, slot) flattened; dropped events keep an out-of-range index
    gs = torch.where(g_drop < g_total,
                     g_drop * group_q + slot.repeat_interleave(max_blocks),
                     g_total * group_q)
    n_slots = g_total * group_q
    sq_b = sq.repeat_interleave(max_blocks).to(torch.int32)
    grp_qidx = _scatter_drop(n_slots, gs, sq_b, 0).reshape(g_total, group_q)
    grp_cnt = _scatter_drop(n_slots, gs, cnt_ij.reshape(-1).to(torch.int32),
                            0).reshape(g_total, group_q)
    grp_qvecs = queries_ext[grp_qidx.long()]

    # event rows back in the ORIGINAL probe-event order: (E, maxB)
    row_sorted = torch.where(ev_valid_s, g * group_q + slot[:, None], 0)
    ev_row = torch.empty_like(row_sorted)
    ev_row[order] = row_sorted
    ev_valid = torch.empty_like(ev_valid_s)
    ev_valid[order] = ev_valid_s
    ev_block = torch.empty_like(blockno)
    ev_block[order] = blockno
    return (grp_block, grp_qvecs, grp_cnt, ev_row.to(torch.int32),
            ev_block.to(torch.int32), ev_valid)


# ---------------------------------------------------------------------------
# windowed prep: window sub-events of a dense layout, sorted by window
# ---------------------------------------------------------------------------
# A probed bucket of a dense layout spans at most cap // W + 1 windows of
# W = block_rows rows; neighbouring buckets share windows, so the group
# count follows the probed windows, not the probed buckets.

def _window_sub_events(layout_starts, layout_counts, probe_ids, probe_valid,
                       cap: int, max_sub: int, W: int):
    """Per event, its ``max_sub`` candidate windows ``wj`` and each one's
    lane range ``[lo, hi)``, all ``(E, max_sub)``, and the valid mask."""
    n_buckets = layout_counts.shape[0]
    safe = torch.clamp(probe_ids.long(), 0, n_buckets - 1)
    ct = torch.where(probe_valid, torch.clamp(layout_counts[safe].long(),
                                              max=cap), 0).reshape(-1, 1)
    st = layout_starts[safe].long().reshape(-1, 1)
    j = torch.arange(max_sub, device=probe_ids.device)
    wj = st // W + j
    lo = torch.clamp(st - wj * W, min=0)
    hi = torch.clamp(st + ct - wj * W, max=W)
    return wj, lo, hi, (ct > 0) & (hi > lo)


def windowed_needed_groups(layout_starts, layout_counts, probe_ids,
                           probe_valid, cap: int, max_sub: int, group_q: int,
                           n_windows: int,
                           block_rows: int | None = None) -> torch.Tensor:
    """EXACT group count of :func:`_windowed_prep` for a concrete probe
    batch, ``sum_w ceil(m_w / G)`` with ``m_w`` the window sub-events
    landing in window ``w``, on the device (one scatter-add over
    ``n_windows`` bins; sub-events outside them drop into a sentinel
    bin): a 0-d int64 tensor, so a caller sizes or guards a group table
    with one small read."""
    wj, _, _, sub_valid = _window_sub_events(
        layout_starts, layout_counts, probe_ids, probe_valid, cap, max_sub,
        _br(block_rows))
    ok = sub_valid & (wj >= 0) & (wj < n_windows)
    idx = torch.where(ok, wj, n_windows).reshape(-1)
    m = torch.zeros(n_windows + 1, dtype=torch.int64, device=idx.device)
    m.scatter_add_(0, idx, torch.ones_like(idx))
    return torch.sum(-(-m[:n_windows] // group_q))


def windowed_static_bound(n_events: int, max_sub: int, total_windows: int,
                          group_q: int) -> int:
    """Upper bound on the windowed group count for ANY batch of
    ``n_events`` probe events: ``E*maxJ/G + min(total_windows, E*maxJ)``."""
    sub_events = n_events * max_sub
    probed = min(total_windows, sub_events) if total_windows > 0 \
        else sub_events
    return int(-(-sub_events // group_q) + probed)


def _windowed_prep(layout_starts, layout_counts, probe_ids, probe_valid,
                   queries_ext, cap: int, g_total: int, max_sub: int,
                   group_q: int = GROUP_W, block_rows: int | None = None):
    """Window sub-events sorted by window, and the group tables.

    Returns ``(grp_window (g,) i32, grp_qvecs (g, G, d_pad) f32,
    grp_lo (g, G) i32, grp_hi (g, G) i32, ev_row (E, maxJ) i32,
    ev_window (E, maxJ) i32, ev_valid (E, maxJ) bool)``; empty slots
    carry ``lo = hi = 0`` and groups past ``g_total`` are dropped, as
    in the JAX package (size ``g_total`` with a bound that holds)."""
    W = _br(block_rows)
    nq, n_probes = probe_ids.shape
    e = nq * n_probes
    dev = probe_ids.device
    wj, lo, hi, sub_valid = _window_sub_events(
        layout_starts, layout_counts, probe_ids, probe_valid, cap, max_sub, W)
    qidx = torch.arange(nq, device=dev).repeat_interleave(n_probes)

    big = 2 ** 30
    key = torch.where(sub_valid, wj, big).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    s_lo = lo.reshape(-1)[order]
    s_hi = torch.where(sub_valid, hi, 0).reshape(-1)[order]
    s_q = qidx[:, None].expand(e, max_sub).reshape(-1)[order]

    svalid = sk < big
    unique, rank = _run_ranks(sk)
    # a new group at each window and every G sub-events within it
    new_group = (unique | (rank % group_q == 0)) & svalid
    g = torch.cumsum(new_group, 0) - 1
    slot = rank % group_q
    g_safe = torch.where(svalid, g, g_total)

    grp_window = _scatter_drop(
        g_total, g_safe, torch.where(svalid, sk, 0).to(torch.int32), 0)
    n_slots = g_total * group_q
    gs = torch.where(g_safe < g_total, g_safe * group_q + slot, n_slots)
    grp_qidx = _scatter_drop(n_slots, gs, s_q, 0).reshape(g_total, group_q)
    grp_lo = _scatter_drop(n_slots, gs, s_lo.to(torch.int32), 0)
    grp_hi = _scatter_drop(n_slots, gs, s_hi.to(torch.int32), 0)
    grp_qvecs = queries_ext[grp_qidx]

    # sub-events back in the ORIGINAL order (order is a permutation)
    def unsort(values):
        out = torch.empty_like(values)
        out[order] = values
        return out.reshape(e, max_sub)

    ev_row = unsort(torch.where(svalid, g * group_q + slot, 0).to(torch.int32))
    ev_valid = unsort(svalid)
    ev_window = unsort(torch.where(svalid, sk, 0).to(torch.int32))
    return (grp_window, grp_qvecs, grp_lo.reshape(g_total, group_q),
            grp_hi.reshape(g_total, group_q), ev_row, ev_window, ev_valid)


# ---------------------------------------------------------------------------
# K1-K4: the CUDA kernels' wrappers and their plain PyTorch versions
# ---------------------------------------------------------------------------

_PLAIN_CHUNK = 1024  # groups per step of the plain versions (bounds memory)


def _group_blocks(data, grp_block, br: int) -> torch.Tensor:
    """``(c, br, d_pad)`` f32 corpus blocks of a chunk of groups."""
    return data.view(-1, br, data.shape[1])[grp_block.long()].to(torch.float32)


def grouped_scores_plain(data, grp_qvecs, grp_block,
                         block_rows: int | None = None) -> torch.Tensor:
    """Plain K2: raw ``(g_total, G, block_rows)`` f32 score panels."""
    br = _br(block_rows)
    g_total, G, _ = grp_qvecs.shape
    out = torch.empty((g_total, G, br), dtype=torch.float32,
                      device=grp_qvecs.device)
    for s in range(0, g_total, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, g_total)
        blocks = _group_blocks(data, grp_block[s:e], br)
        out[s:e] = torch.matmul(grp_qvecs[s:e], blocks.transpose(1, 2))
    return out


def _scores_topk_plain(data, grp_qvecs, grp_block, grp_lo, grp_hi, kk: int,
                       br: int, norms, scale_rows):
    """Plain K1 (``grp_lo`` None: lanes ``< grp_hi`` kept) and plain K3
    (lanes in ``[grp_lo, grp_hi)`` kept)."""
    kk = min(max(int(kk), 1), ROW_TOPK)
    g_total, G, _ = grp_qvecs.shape
    dev = grp_qvecs.device
    scores = torch.empty((g_total, G, kk), dtype=torch.float32, device=dev)
    lanes = torch.empty((g_total, G, kk), dtype=torch.int32, device=dev)
    lane = torch.arange(br, device=dev)
    for s in range(0, g_total, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, g_total)
        blk = grp_block[s:e].long()
        p = torch.matmul(grp_qvecs[s:e], _group_blocks(data, blk, br)
                         .transpose(1, 2))                       # (c, G, br)
        if scale_rows is not None:
            p = p * scale_rows.view(-1, br)[blk][:, None, :]
        if norms is not None:
            p = p - norms.view(-1, br)[blk][:, None, :]
        keep = lane < grp_hi[s:e, :, None]
        if grp_lo is not None:
            keep &= lane >= grp_lo[s:e, :, None]
        p = torch.where(keep, p, -torch.inf)
        v, i = torch.sort(p, dim=2, descending=True, stable=True)
        scores[s:e] = v[..., :kk]
        lanes[s:e] = i[..., :kk].to(torch.int32)
    return scores, lanes


def grouped_scores_topk_plain(data, grp_qvecs, grp_block, grp_cnt, kk: int,
                              block_rows: int | None = None, norms=None,
                              scale_rows=None):
    """Plain K1: ``(scores (g_total, G, kk) f32, lanes (g_total, G, kk)
    i32)`` — the panel times ``scale_rows``, minus ``norms``, lanes
    ``>= grp_cnt`` masked to -inf, then each row's top ``kk`` by a stable
    descending sort (lowest lane first among ties).  Lanes under a -inf
    score are unspecified."""
    return _scores_topk_plain(data, grp_qvecs, grp_block, None, grp_cnt, kk,
                              _br(block_rows), norms, scale_rows)


def windowed_scores_topk_plain(data, grp_qvecs, grp_window, grp_lo, grp_hi,
                               kk: int, block_rows: int | None = None,
                               norms=None, scale_rows=None):
    """Plain K3: as :func:`grouped_scores_topk_plain` over the windows
    ``grp_window``, each slot keeping only the lanes in ``[grp_lo,
    grp_hi)``."""
    return _scores_topk_plain(data, grp_qvecs, grp_window, grp_lo, grp_hi,
                              kk, _br(block_rows), norms, scale_rows)


def windowed_scores_plain(data, grp_qvecs, grp_window,
                          block_rows: int | None = None) -> torch.Tensor:
    """Plain K4: raw ``(g_total, G, block_rows)`` f32 panels of the
    windows ``grp_window`` (no scale, norms or mask)."""
    return grouped_scores_plain(data, grp_qvecs, grp_window, block_rows)


def _check(name: str, t: torch.Tensor, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_smem_bytes(d_pad: int, topk: bool, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block of the fused top-k kernel (K1,
    K3: the group's f32 query rows, the corpus ring and the slots'
    candidate buffers, whatever the block rows) or of the raw-panel
    kernel (K2, K4, K7: a ring of stages, each 128 bytes of 256 corpus
    rows of ``dtype``, padded to 144, and the same features of 32 f32
    query rows, whatever the block rows and ``d_pad``)."""
    if topk:
        return (4 * _MAX_G * d_pad + _TOPK_STAGES * _TILE * _TOPK_ROW_STRIDE
                + 8 * _MAX_G * _TOPK_CAP)
    feats = _PANEL_STAGE_BYTES // dtype.itemsize
    return _PANEL_STAGES * (_PANEL_TILE_ROWS * (_PANEL_STAGE_BYTES + 16)
                            + 4 * _MAX_G * feats)


def launch_shape_error(d_pad: int, br: int, topk: bool,
                       dtype=torch.float32) -> str | None:
    """Why the fused (``topk``) or raw-panel kernel cannot take blocks of
    ``br`` rows of ``d_pad`` features of ``dtype``, or None if it can."""
    if br <= 0 or d_pad <= 0 or br % _TILE or d_pad % _TILE:
        return (f"block_rows={br} and d_pad={d_pad} must be multiples of "
                f"{_TILE}")
    smem = kernel_smem_bytes(d_pad, topk, dtype)
    if smem > _SMEM_LIMIT:
        return (f"d_pad={d_pad} needs {smem} bytes of shared memory, over the "
                f"{_SMEM_LIMIT} a block may use")
    if topk and br > _TOPK_MAX_TILES * _TILE:
        return f"block_rows={br} above the fused kernel's {_TOPK_MAX_TILES * _TILE}"
    return None


def _check_launch(data, grp_qvecs, grp_block, br: int, topk: bool):
    """Validate the common operands of a CUDA launch; returns the
    shape numbers the kernel takes.  ``grp_qvecs`` is ``(g_total, G,
    d_pad)``, or ``(G, d_pad)``: one query panel for every group."""
    if data.device.type != "cuda":
        raise ValueError(f"the scoring kernels run on CUDA tensors, got {data.device}")
    dev = data.device
    n_aligned, d_pad = data.shape
    if grp_qvecs.dim() == 2:
        g_total, G = grp_block.shape[0], grp_qvecs.shape[0]
        q_shape = (G, d_pad)
    else:
        g_total, G = grp_qvecs.shape[:2]
        q_shape = (g_total, G, d_pad)
    _check("data", data, tuple(_DTYPE_CODE), (n_aligned, d_pad), dev)
    _check("grp_qvecs", grp_qvecs, (torch.float32,), q_shape, dev)
    _check("grp_block", grp_block, (torch.int32,), (g_total,), dev)
    if not 1 <= G <= _MAX_G:
        raise ValueError(f"group width {G} outside [1, {_MAX_G}]")
    why = launch_shape_error(d_pad, br, topk, data.dtype)
    if why is None and (n_aligned % br or n_aligned == 0):
        why = (f"the layout's {n_aligned} rows must be a positive multiple of "
               f"block_rows={br} (block_rows and d_pad multiples of {_TILE})")
    if why is not None:
        raise ValueError(why)
    return g_total, G, d_pad, n_aligned // br


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _check_rows(data, norms, scale_rows):
    for name, t in (("norms", norms), ("scale_rows", scale_rows)):
        if t is not None:
            _check(name, t, (torch.float32,), (data.shape[0],), data.device)


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def grouped_scores_topk(data, grp_qvecs, grp_block, grp_cnt, kk: int,
                        block_rows: int | None = None, norms=None,
                        scale_rows=None):
    """K1, the fused grouped score + per-row top-``kk`` (replaces
    ``_grouped_scores_topk`` of the JAX package).  Returns ``(scores,
    lanes)`` of shape ``(g_total, G, kk)``; see
    :func:`grouped_scores_topk_plain` for the semantics.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return grouped_scores_topk_plain(data, grp_qvecs, grp_block, grp_cnt,
                                         kk, block_rows, norms, scale_rows)
    br = _br(block_rows)
    kk = min(max(int(kk), 1), ROW_TOPK)
    g_total, G, d_pad, n_blocks = _check_launch(data, grp_qvecs, grp_block,
                                                br, topk=True)
    dev = data.device
    _check("grp_cnt", grp_cnt, (torch.int32,), (g_total, G), dev)
    _check_rows(data, norms, scale_rows)
    scores = torch.empty((g_total, G, kk), dtype=torch.float32, device=dev)
    lanes = torch.empty((g_total, G, kk), dtype=torch.int32, device=dev)
    from nlsh_tpu_torch.ops.cuda.build import load_library

    err = load_library().nlsh_grouped_scores_topk(
        _DTYPE_CODE[data.dtype], _ptr(grp_qvecs), _ptr(data), _ptr(grp_block),
        _ptr(grp_cnt), _ptr(norms), _ptr(scale_rows), _ptr(scores),
        _ptr(lanes), g_total, G, d_pad, br, n_blocks, kk, _stream(dev))
    _raise_on(err, "grouped_scores_topk")
    KERNEL_LAUNCHES["grouped_scores_topk"] += 1
    return scores, lanes


def topk_blocks_per_sm(dtype, d_pad: int, windowed: bool) -> int:
    """Resident blocks per SM of the fused top-k kernel (K3 if
    ``windowed``, else K1) on the current card for a layout ``dtype`` and
    ``d_pad``; its persistent grid is this times the SM count."""
    from nlsh_tpu_torch.ops.cuda.build import load_library

    out = ctypes.c_int(0)
    _raise_on(load_library().nlsh_topk_blocks_per_sm(
        _DTYPE_CODE[dtype], int(windowed), d_pad, ctypes.byref(out)),
        "topk_blocks_per_sm")
    return out.value


def grouped_scores(data, grp_qvecs, grp_block,
                   block_rows: int | None = None) -> torch.Tensor:
    """K2, the raw ``(g_total, G, block_rows)`` grouped score panels
    (replaces ``_grouped_scores_v3`` of the JAX package).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return grouped_scores_plain(data, grp_qvecs, grp_block, block_rows)
    out = _launch_panels(data, grp_qvecs, grp_block, _br(block_rows),
                         "grouped_scores")
    KERNEL_LAUNCHES["grouped_scores"] += 1
    return out


def windowed_scores_topk(data, grp_qvecs, grp_window, grp_lo, grp_hi,
                         kk: int, block_rows: int | None = None, norms=None,
                         scale_rows=None):
    """K3, the fused windowed score + per-row top-``kk`` (replaces
    ``_windowed_scores_topk`` of the JAX package): K1's kernel body with
    a ``[grp_lo, grp_hi)`` lane range per slot.  Returns ``(scores,
    lanes)`` of shape ``(g_total, G, kk)``; see
    :func:`windowed_scores_topk_plain`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return windowed_scores_topk_plain(data, grp_qvecs, grp_window, grp_lo,
                                          grp_hi, kk, block_rows, norms,
                                          scale_rows)
    br = _br(block_rows)
    kk = min(max(int(kk), 1), ROW_TOPK)
    g_total, G, d_pad, n_windows = _check_launch(data, grp_qvecs, grp_window,
                                                 br, topk=True)
    dev = data.device
    _check("grp_lo", grp_lo, (torch.int32,), (g_total, G), dev)
    _check("grp_hi", grp_hi, (torch.int32,), (g_total, G), dev)
    _check_rows(data, norms, scale_rows)
    scores = torch.empty((g_total, G, kk), dtype=torch.float32, device=dev)
    lanes = torch.empty((g_total, G, kk), dtype=torch.int32, device=dev)
    from nlsh_tpu_torch.ops.cuda.build import load_library

    err = load_library().nlsh_windowed_scores_topk(
        _DTYPE_CODE[data.dtype], _ptr(grp_qvecs), _ptr(data),
        _ptr(grp_window), _ptr(grp_lo), _ptr(grp_hi), _ptr(norms),
        _ptr(scale_rows), _ptr(scores), _ptr(lanes), g_total, G, d_pad, br,
        n_windows, kk, _stream(dev))
    _raise_on(err, "windowed_scores_topk")
    KERNEL_LAUNCHES["windowed_scores_topk"] += 1
    return scores, lanes


def windowed_scores(data, grp_qvecs, grp_window,
                    block_rows: int | None = None) -> torch.Tensor:
    """K4, the raw ``(g_total, G, block_rows)`` windowed score panels
    (replaces ``_windowed_scores`` of the JAX package).  A window is
    ``block_rows`` rows and the layout a whole number of them, so a
    window id is a block id and this launches K2's kernel on the window
    table; it keeps its own plain version and launch count.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return windowed_scores_plain(data, grp_qvecs, grp_window, block_rows)
    out = _launch_panels(data, grp_qvecs, grp_window, _br(block_rows),
                         "windowed_scores")
    KERNEL_LAUNCHES["windowed_scores"] += 1
    return out


def _launch_panels(data, grp_qvecs, grp_block, br: int,
                   name: str) -> torch.Tensor:
    """Launch the raw-panel kernel (K2's, also K4's and K7's) on
    validated operands: ``grp_qvecs`` ``(g_total, G, d_pad)``, or
    ``(G, d_pad)`` for one query panel read by every group (a query
    stride of 0 between groups)."""
    g_total, G, d_pad, n_blocks = _check_launch(data, grp_qvecs, grp_block,
                                                br, topk=False)
    q_stride = 0 if grp_qvecs.dim() == 2 else G * d_pad
    out = torch.empty((g_total, G, br), dtype=torch.float32, device=data.device)
    from nlsh_tpu_torch.ops.cuda.build import load_library

    err = load_library().nlsh_grouped_scores(
        _DTYPE_CODE[data.dtype], _ptr(grp_qvecs), _ptr(data), _ptr(grp_block),
        _ptr(out), g_total, G, d_pad, br, n_blocks, q_stride,
        _stream(data.device))
    _raise_on(err, name)
    return out


def panel_blocks_per_sm(dtype, d_pad: int) -> int:
    """Resident blocks per SM of the raw-panel kernel (K2, K4, K7) on the
    current card for a layout ``dtype`` and ``d_pad`` (its footprint does
    not grow with ``d_pad``); its persistent grid is this times the SM
    count."""
    from nlsh_tpu_torch.ops.cuda.build import load_library

    out = ctypes.c_int(0)
    _raise_on(load_library().nlsh_panel_blocks_per_sm(
        _DTYPE_CODE[dtype], d_pad, ctypes.byref(out)), "panel_blocks_per_sm")
    return out.value


def int8_block_scores_plain(data, queries, block_ids,
                            block_rows: int) -> torch.Tensor:
    """Plain K7: ``out[b] = queries . upcast(block block_ids[b])^T``,
    ``(len(block_ids), nq, block_rows)`` f32."""
    blocks = data.view(-1, block_rows, data.shape[1])[block_ids.long()]
    return torch.matmul(queries, blocks.to(torch.float32).transpose(1, 2))


def int8_block_scores(data, queries, block_ids,
                      block_rows: int) -> torch.Tensor:
    """K7, the int8 block probe (replaces the inline kernel of
    ``benchmarks/int8_probe.py``): each int8 block of ``block_rows`` rows
    named by ``block_ids``, upcast to f32 and dotted with the f32
    ``queries`` ``(nq, d_pad)``.  On the card this is K2's kernel on an
    int8 layout, every block's group reading the one query panel (query
    stride 0); it keeps its own plain version and launch count.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if data.dtype != torch.int8:
        raise ValueError(f"K7 scores int8 blocks, got {data.dtype}")
    if data.device.type == "cpu":
        return int8_block_scores_plain(data, queries, block_ids, block_rows)
    out = _launch_panels(data, queries, block_ids, block_rows,
                         "int8_block_scores")
    KERNEL_LAUNCHES["int8_block_scores"] += 1
    return out


# ---------------------------------------------------------------------------
# K5/K6: the fixed-cap engine's masked per-event scores
# ---------------------------------------------------------------------------

def _bucket_scores_plain(data, queries_ext, index, counts, cap: int,
                         stride: int) -> torch.Tensor:
    """Plain K5 (``stride = cap``) and K6 (``stride = 1``): per (query,
    probe) event the ``cap`` rows from row ``stride * index``, clamped
    into the layout, dotted with the query; lanes ``>= counts`` are
    ``-inf``.  Events go a chunk at a time, each chunk's gathered rows
    as many bytes as a chunk of groups of the other plain versions."""
    nq, n_probes = index.shape
    n_ev = nq * n_probes
    dev = queries_ext.device
    first = torch.clamp(index.reshape(-1).long() * stride, 0,
                        data.shape[0] - cap)
    cnt = counts.reshape(-1)
    qidx = torch.arange(nq, device=dev).repeat_interleave(n_probes)
    lane = torch.arange(cap, device=dev)
    out = torch.empty((n_ev, cap), dtype=torch.float32, device=dev)
    chunk = max(_PLAIN_CHUNK * BLOCK_ROWS // cap, 1)
    for s in range(0, n_ev, chunk):
        e = min(s + chunk, n_ev)
        rows = data[first[s:e, None] + lane].to(torch.float32)  # (c, cap, d)
        sc = torch.matmul(rows, queries_ext[qidx[s:e], :, None])[..., 0]
        out[s:e] = torch.where(lane < cnt[s:e, None], sc, -torch.inf)
    return out.reshape(nq, n_probes, cap)


def bucket_scores_auto_plain(data, queries_ext, block_idx, counts,
                             cap: int) -> torch.Tensor:
    """Plain K5: ``(nq, P, cap)`` scores of each event's cap-row block
    ``block_idx`` (rows ``block_idx * cap`` on), lanes ``>= counts``
    masked to ``-inf``."""
    return _bucket_scores_plain(data, queries_ext, block_idx, counts, cap,
                                cap)


def bucket_scores_impl_plain(data, queries_ext, starts, counts,
                             cap: int) -> torch.Tensor:
    """Plain K6: as :func:`bucket_scores_auto_plain`, each event's block
    starting at row ``starts``."""
    return _bucket_scores_plain(data, queries_ext, starts, counts, cap, 1)


def _bucket_event_order(index, counts, cap: int, stride: int, n_rows: int):
    """How the fixed-cap kernel groups its events, on any device and with
    no host read.  An event's key is its first row, ``stride * index``
    clamped into ``[0, n_rows - cap]`` (the rows the plain version
    reads), or ``n_rows`` if its count is ``<= 0`` (it scores nothing).
    Returns ``(order, first, counts)``, each ``(E,)`` i32: the events
    sorted by key (stable), so events that read the same ``cap`` rows are
    neighbours and those that score nothing come last, and the keys and
    counts in that order.  The kernel cuts the order into
    :func:`bucket_work_items` chunks of ``_BUCKET_G`` and reads a chunk's
    run of equal first rows once for all the run's queries."""
    counts = counts.reshape(-1)
    first = torch.clamp(index.reshape(-1).long() * stride, 0, n_rows - cap)
    key = torch.where(counts > 0, first, n_rows).to(torch.int32)
    first, order = torch.sort(key, stable=True)
    return order.to(torch.int32), first, counts[order]


def bucket_work_items(n_events: int) -> int:
    """Work items of one fixed-cap launch: ``_BUCKET_G`` consecutive
    events of the sorted order each, whatever the events are."""
    return -(-n_events // _BUCKET_G)


def bucket_smem_bytes(dtype=torch.float32) -> int:
    """Shared memory of one block of the fixed-cap kernel (K5, K6): the
    raw-panel kernel's ring (whatever ``cap`` and ``d_pad``) and the work
    item's table."""
    return kernel_smem_bytes(_TILE, False, dtype) + _BUCKET_ITEM_BYTES


def bucket_shape_error(d_pad: int, cap: int, n_rows: int,
                       dtype=torch.float32) -> str | None:
    """Why the fixed-cap kernel cannot take ``cap`` rows per event of a
    layout of ``n_rows`` rows of ``d_pad`` features of ``dtype``, or None
    if it can."""
    if d_pad <= 0 or d_pad % _TILE or d_pad > 12288:
        return f"d_pad={d_pad} must be a multiple of {_TILE} up to 12288"
    if not 1 <= cap <= n_rows:
        return f"cap={cap} must lie between 1 and the layout's {n_rows} rows"
    if n_rows >= 2 ** 31:
        return f"the layout's {n_rows} rows do not index with 32 bits"
    smem = bucket_smem_bytes(dtype)
    if smem > _SMEM_LIMIT:
        return (f"{dtype} rows need {smem} bytes of shared memory, over the "
                f"{_SMEM_LIMIT} a block may use")
    return None


def _launch_bucket(data, queries_ext, index, counts, cap: int, stride: int,
                   name: str) -> torch.Tensor:
    """Launch the fixed-cap kernel (K5's, also K6's) on validated
    operands: the events grouped by :func:`_bucket_event_order` (torch
    ops on the card, no host read), then one launch."""
    if data.device.type != "cuda":
        raise ValueError(f"the scoring kernels run on CUDA tensors, got {data.device}")
    dev = data.device
    n_rows, d_pad = data.shape
    nq, n_probes = index.shape
    _check("data", data, tuple(_DTYPE_CODE), (n_rows, d_pad), dev)
    _check("queries_ext", queries_ext, (torch.float32,), (nq, d_pad), dev)
    _check("index", index, (torch.int32,), (nq, n_probes), dev)
    _check("counts", counts, (torch.int32,), (nq, n_probes), dev)
    why = bucket_shape_error(d_pad, cap, n_rows, data.dtype)
    if why is not None:
        raise ValueError(why)
    return _launch_bucket_sorted(
        data, queries_ext,
        *_bucket_event_order(index, counts, cap, stride, n_rows), cap, name)


def _launch_bucket_sorted(data, queries_ext, order, first, counts, cap: int,
                          name: str) -> torch.Tensor:
    """The fixed-cap kernel's launch proper, on the events as
    :func:`_bucket_event_order` has sorted them (and
    :func:`_launch_bucket` validated them)."""
    nq = queries_ext.shape[0]
    n_probes = order.numel() // nq
    n_rows, d_pad = data.shape
    out = torch.empty((nq, n_probes, cap), dtype=torch.float32,
                      device=data.device)
    from nlsh_tpu_torch.ops.cuda.build import load_library

    err = load_library().nlsh_bucket_scores(
        _DTYPE_CODE[data.dtype], _ptr(queries_ext), _ptr(data), _ptr(order),
        _ptr(first), _ptr(counts), _ptr(out), nq * n_probes, n_probes, cap,
        d_pad, n_rows, _stream(data.device))
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def bucket_blocks_per_sm(dtype) -> int:
    """Resident blocks per SM of the fixed-cap kernel (K5, K6) on the
    current card for a layout ``dtype`` (its footprint depends on neither
    ``cap`` nor ``d_pad``); its persistent grid is this times the SM
    count."""
    from nlsh_tpu_torch.ops.cuda.build import load_library

    out = ctypes.c_int(0)
    _raise_on(load_library().nlsh_bucket_blocks_per_sm(
        _DTYPE_CODE[dtype], ctypes.byref(out)), "bucket_blocks_per_sm")
    return out.value


def bucket_scores_auto(data, queries_ext, block_idx, counts,
                       cap: int) -> torch.Tensor:
    """K5, the fixed-cap engine's scorer (replaces ``_bucket_scores_auto``
    of the JAX package): ``(nq, P, cap)`` f32 scores of each (query,
    probe) event's cap-row block ``block_idx`` of a cap-aligned layout,
    lanes ``>= counts`` ``-inf``.  On the card the events are sorted by
    the rows they read (:func:`_bucket_event_order`) and the kernel reads
    a block once for up to 32 of the events that probe it; each score is
    one ``fmaf`` chain over the features in order, bit-identical to K2's
    panel entry of the same (query, block) where ``cap == block_rows``.
    CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if data.device.type == "cpu":
        return bucket_scores_auto_plain(data, queries_ext, block_idx, counts,
                                        cap)
    return _launch_bucket(data, queries_ext, block_idx, counts, cap, cap,
                          "bucket_scores_auto")


def bucket_scores_impl(data, queries_ext, starts, counts,
                       cap: int) -> torch.Tensor:
    """K6 (replaces ``_bucket_scores_impl`` of the JAX package, which has
    no caller there): as :func:`bucket_scores_auto` with each event's
    block at row offset ``starts``; K5's kernel with a row stride of 1.
    Events are grouped by their clamped first row, so only events that
    start at the same row share a read (ranges that merely overlap are
    neighbours in the sort and meet in L2), and the scores are
    bit-identical to K5's, and so to K2's, on the same rows.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if data.device.type == "cpu":
        return bucket_scores_impl_plain(data, queries_ext, starts, counts,
                                        cap)
    return _launch_bucket(data, queries_ext, starts, counts, cap, 1,
                          "bucket_scores_impl")


def bucket_scores(layout: ServingLayout, queries_ext, probe_ids, probe_valid,
                  plain: bool = False):
    """Scores for every (query, probe, lane) candidate slot of a
    cap-aligned layout, through K5 (``plain=True``: its plain version).

    Returns ``scores (nq, P, cap)`` (higher is nearer, ``-inf`` on masked
    lanes) and ``positions (nq, P)`` i32: each probe's first row in the
    layout, clamped to ``n_rows - cap`` (lane ``l`` of probe ``p`` is
    layout row ``positions[:, p] + l``)."""
    cap = layout.cap
    safe, counts = _probe_counts(layout.counts, probe_ids, probe_valid, cap)
    starts = torch.clamp(layout.starts[safe], max=layout.n_rows - cap)
    starts = starts.to(torch.int32)
    block_idx = starts // cap  # cap-aligned layout: starts are block-exact
    score = bucket_scores_auto_plain if plain else bucket_scores_auto
    return score(layout.data, queries_ext, block_idx,
                 counts.to(torch.int32), cap), starts
