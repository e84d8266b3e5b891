// Fixed-cap bucket scoring of the serving path: kernels K5 and K6.
//
// Replaces the Pallas kernels of nlsh_tpu/ops/pallas/query_kernel.py:
//   K5  _bucket_scores_auto (kernel body _make_auto_kernel): per (query,
//       probe) event, the probe's cap-row block at row block_idx * cap of
//       the cap-aligned layout, dotted with the event's query in exact
//       f32, lanes >= the event's count (0 for an invalid probe) set to
//       -inf: out (n_events, cap).
//   K6  _bucket_scores_impl (kernel body _score_kernel): the same with
//       the block at a row offset starts[ev] (a multiple of the layout's
//       alignment) instead of a block index.
// One kernel does both.  The wrapper hands it the events sorted by their
// first row (stride * index, stride = cap for K5 and 1 for K6, clamped
// into [0, n_rows - cap]; n_rows for an event that scores nothing, so
// those sort last), with their first rows and counts in that order.
//
// What bounds it on the H100: the function needs each probed row once and
// writes every score once: at the bench shape (160,000 events of 16 flip
// probes, cap 512, 4,096 buckets) 0.806 GB, 0.24 ms at 3.35 TB/s, against
// 12 GFLOP of f32 FMAs over d_pad 128, 0.18 ms at 67 TFLOP/s.  But a
// bucket is probed by ~39 queries: a kernel that streams an event's rows
// for that event alone (the TPU kernels' per-event block pipeline) moves
// 24 GB, 8 ms however well it streams.  So events that score the same
// rows must share one read of them, and then the FMA pipe is the limit,
// as for the raw-panel kernel (grouped_scores.cu).
//
// Design:
//   * Work item = 32 consecutive events of the sorted order (a static
//     ceil(n_events / 32) items, no group table, no host read).  Inside
//     an item the events with one first row form a run: a run's rows go
//     through shared memory once and are multiplied by all its queries.
//     Block reads are at most items + distinct first rows.  A run only
//     reads rows below its largest count.
//   * A persistent grid of (resident blocks per SM) x (SMs) blocks of 4
//     warps walks the items, item += gridDim.x: the items of a hot bucket
//     (thousands of events on one block) run side by side on neighbouring
//     SMs and re-read it from the 50 MB L2.
//   * Per item, warp 0 reads the 32 events (id, first row, count) and
//     finds the runs with ballots, into a table in shared memory; it does
//     so an item ahead (the loads are issued before, and consumed after,
//     the writes below), so the copy cursor runs on across items and an
//     item's first stage lands while the item before it is multiplied.
//     All warps write -inf to the lanes from each event's count to cap
//     (events that score nothing get only this) at the item's start.
//   * A run is walked in tiles of 256 rows, a tile in stages of 128 bytes
//     of each row, through a 2-stage cp.async ring in the layout's own
//     type (rows padded to 144 bytes, widened to f32 on the read,
//     ring.cuh).  The same features of the run's query rows ride the ring
//     beside them, gathered from queries[ev / n_probes]: no copy of the
//     queries in device memory, and a footprint that does not grow with
//     d_pad.
//   * Register tile: 16 slots x up to 4 rows per lane.  A run of more
//     than 16 events splits its slots over two pairs of warps, each pair
//     dealing the tile's 32-row groups between its two warps; a run of at
//     most 16 (8) events has all 4 warps multiply those 16 (8) slots and
//     deal the row groups four ways, so a block probed by one query still
//     streams with every warp.  A warp multiplies only the row groups
//     below the run's largest count (1 to 4 rows per lane).
//   * Each (slot, row) is one fmaf chain from 0 over features 0 .. d_pad
//     - 1 in order, as in grouped_topk.cu and grouped_scores.cu: K5's
//     scores equal K2's panel bit for bit on the same (query, block), K6
//     equals K5 at the same rows, and the result does not depend on the
//     order of the sort.  No tensor cores, hence no TF32.  A slot's lanes
//     below its own count are stored once (32 consecutive floats per
//     store, streaming); every output element has one writer, no atomics.
//   * Shapes: any cap >= 1, d_pad any multiple of 128; shared memory per
//     block 2 x (256 x 144 + 32 x 32 x 4) = 81,920 bytes for f32 rows
//     (bf16 90,112, int8 106,496) plus two items' tables, 1.8 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "ring.cuh"

namespace {

using nlsh::cp_async16;
using nlsh::cp_async_commit;
using nlsh::cp_async_wait;
using nlsh::Widen;

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 32;                     // events per work item
constexpr int kSlab = 16;                     // slots per warp
constexpr int kNarrow = 8;                    // slots of a narrow run
constexpr int kRowsPerLane = 4;               // rows per lane, at most
constexpr int kTileRows = 256;                // rows per tile
constexpr int kStageBytes = 128;              // bytes of a row per stage
constexpr int kChunks = kStageBytes / 16;     // 16-byte copies per row
constexpr int kRowStride = kStageBytes + 16;  // padded stage row (bytes)
constexpr int kStages = 2;                    // ring depth
constexpr int kMinBlocks = 2;                 // resident blocks per SM
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMaxG == 32, "one event per lane of warp 0");
static_assert(kTileRows == 32 * 2 * kRowsPerLane, "2 warps deal 8 row groups");

// Stage layout for corpus type T: the tile's rows, then the query slice
// (kMaxG rows of kFeat f32 features).
template <typename T>
struct Stage {
  static constexpr int kFeat = kStageBytes / static_cast<int>(sizeof(T));
  static constexpr int kQChunks = kFeat / 4;   // 16-byte copies per slot
  static constexpr int kRowsBytes = kTileRows * kRowStride;
  static constexpr int kBytes = kRowsBytes + kMaxG * kFeat * 4;
};

// A work item: its events (slot s = sorted position 32 item + s) and its
// runs of equal first rows.
struct Item {
  int ev[kMaxG];         // event, -1 past the end of the order
  int qrow[kMaxG];       // its query row
  int cnt[kMaxG];        // its live lanes, 0 for an event that scores nothing
  int run_slot[kMaxG];   // a run's first slot
  int run_len[kMaxG];    // its slots
  int run_rows[kMaxG];   // the largest count among them
  int run_first[kMaxG];  // its first row
  int n_stages;
};

// One stage into acc[i][j], slot i < kS and row j < kR of the warp: lane
// l's row j is buf + j * kStep rows, slot i's query features qrow + i *
// kFeat.  Each (slot, row) is one fmaf chain over the features in order.
template <typename T, int kS, int kR, int kStep>
__device__ __forceinline__ void stage_fma(
    const unsigned char* buf, const float* qrow,
    float (&acc)[kSlab][kRowsPerLane]) {
  constexpr int kN = Widen<T>::kN;
  constexpr int kFeat = Stage<T>::kFeat;
#pragma unroll 1
  for (int u = 0; u < kChunks; ++u) {
    uint4 raw[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      raw[j] = *reinterpret_cast<const uint4*>(buf + j * kStep * kRowStride +
                                               16 * u);
    }
    // Two subs of the body at most: with all four of an int8 chunk
    // unrolled, the eight instantiations below are some 75 KB of code, and
    // a table that mixes wide, mid and narrow runs (warps in different
    // instantiations at once) misses the instruction cache: 1.34 ms at the
    // bench shape against 0.82 ms so, though each mode alone was faster.
#pragma unroll 2
    for (int sub = 0; sub < kN / 4; ++sub) {
      float b[kR][4];
#pragma unroll
      for (int j = 0; j < kR; ++j) Widen<T>::get4(raw[j], sub, b[j]);
      const int k = u * kN + 4 * sub;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + i * kFeat + k);
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          acc[i][j] = fmaf(a.x, b[j][0], acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j][1], acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j][2], acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j][3], acc[i][j]);
        }
      }
    }
  }
}

// stage_fma for a run-time count of rows per lane, 1 .. kMaxR.
template <typename T, int kS, int kMaxR, int kStep>
__device__ __forceinline__ void stage_rows(
    int n, const unsigned char* buf, const float* qrow,
    float (&acc)[kSlab][kRowsPerLane]) {
  if (n == 1) {
    stage_fma<T, kS, 1, kStep>(buf, qrow, acc);
  } else if (n == 2) {
    stage_fma<T, kS, 2, kStep>(buf, qrow, acc);
  } else if constexpr (kMaxR > 2) {
    if (n == 3) {
      stage_fma<T, kS, 3, kStep>(buf, qrow, acc);
    } else {
      stage_fma<T, kS, 4, kStep>(buf, qrow, acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_kernel(const float* __restrict__ queries,  // (nq, d_pad)
              const T* __restrict__ data,         // (n_rows, d_pad)
              const int* __restrict__ order,      // (n_events,) sorted events
              const int* __restrict__ first,      // (n_events,) their first rows
              const int* __restrict__ counts,     // (n_events,) their counts
              float* __restrict__ out,            // (n_events, cap)
              int n_events, int n_probes, int cap, int d_pad, int n_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Item items[2];  // this item's table and the next one's
  using S = Stage<T>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int l = tid % 32;
  const size_t row_bytes = static_cast<size_t>(d_pad) * sizeof(T);
  const int n_chunks = static_cast<int>(row_bytes / kStageBytes);
  const int n_items = (n_events + kMaxG - 1) / kMaxG;
  const int step = static_cast<int>(gridDim.x);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);

  // Warp 0 reads item `item`'s events (sorted position 32 item + lane)...
  auto load_events = [&](int item, int& ev, int& c, int& f) {
    const int p = item * kMaxG + l;
    ev = -1, c = 0, f = 0;
    if (item < n_items && p < n_events) {
      ev = __ldg(order + p);
      c = min(max(__ldg(counts + p), 0), cap);
      f = min(max(__ldg(first + p), 0), n_rows - cap);
    }
  };
  // ... and makes its table: the runs of equal first rows among its live
  // events, found with ballots.
  auto make_item = [&](Item& it, int ev, int c, int f) {
    it.ev[l] = ev;
    it.qrow[l] = ev < 0 ? 0 : ev / n_probes;
    it.cnt[l] = c;
    const bool live = c > 0;
    const int f_prev = __shfl_up_sync(kFull, f, 1);
    const int c_prev = __shfl_up_sync(kFull, c, 1);
    const bool head = live && (l == 0 || c_prev <= 0 || f_prev != f);
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned lives = __ballot_sync(kFull, live);
    __syncwarp();
    int stages = 0;
    if (head) {
      const int k = __popc(heads & ((1u << l) - 1u));  // runs before this one
      // the run ends at the next head or the next dead slot
      const unsigned after = (heads | ~lives) & ~((2u << l) - 1u);
      const int end = after ? __ffs(after) - 1 : kMaxG;
      int rows = 0;
      for (int s = l; s < end; ++s) rows = max(rows, it.cnt[s]);
      it.run_slot[k] = l;
      it.run_len[k] = end - l;
      it.run_rows[k] = rows;
      it.run_first[k] = f;
      stages = (rows + kTileRows - 1) / kTileRows * n_chunks;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      stages += __shfl_xor_sync(kFull, stages, off);
    }
    if (l == 0) it.n_stages = stages;
  };

  float acc[kSlab][kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kSlab; ++i) {
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
  }

  // The copy cursor: the item (by its count k along this block's walk),
  // run, tile and chunk of the next stage to copy, and the stages left to
  // copy in that item.  It runs one stage ahead of the FMAs, across
  // items: an item's first stage lands while the item before it is still
  // multiplied.
  int i_k = -1, i_left = 0, i_run = 0, i_tile = 0, i_chunk = 0;
  auto copy_stage = [&](int s) {
    const Item& it = items[i_k & 1];
    unsigned char* dst = smem + (s % kStages) * S::kBytes;
    const int run_rows = it.run_rows[i_run];
    const int rows = min(kTileRows, run_rows - i_tile * kTileRows);
    const unsigned char* src =
        bytes +
        (static_cast<size_t>(it.run_first[i_run]) + i_tile * kTileRows) *
            row_bytes +
        static_cast<size_t>(i_chunk) * kStageBytes;
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int u = i % kChunks;
      cp_async16(dst + r * kRowStride + 16 * u, src + r * row_bytes + 16 * u);
    }
    const int slot0 = it.run_slot[i_run];
    const int len = it.run_len[i_run];
    const float* qsrc = queries + i_chunk * S::kFeat;
    float* qdst = reinterpret_cast<float*>(dst + S::kRowsBytes);
    for (int i = tid; i < len * S::kQChunks; i += kThreads) {
      const int q = i / S::kQChunks;
      const int u = i % S::kQChunks;
      cp_async16(qdst + q * S::kFeat + 4 * u,
                 qsrc + static_cast<size_t>(it.qrow[slot0 + q]) * d_pad +
                     4 * u);
    }
    --i_left;
    if (++i_chunk < n_chunks) return;
    i_chunk = 0;
    if ((++i_tile) * kTileRows < run_rows) return;
    i_tile = 0;
    ++i_run;
  };
  auto cursor_to = [&](int k) {  // the copy cursor to the start of item k
    i_k = k;
    i_left = items[k & 1].n_stages;
    i_run = i_tile = i_chunk = 0;
  };

  if (warp == 0) {
    int ev, c, f;
    load_events(static_cast<int>(blockIdx.x), ev, c, f);
    make_item(items[0], ev, c, f);
  }
  __syncthreads();

  int s = 0;  // stages multiplied so far: stage s sits in ring slot s % 2
  int k = 0;
  for (int item = static_cast<int>(blockIdx.x); item < n_items;
       item += step, ++k) {
    // Everyone is done with the item before this one (the barrier at the
    // end of the loop), so its table may be overwritten by the next one's.
    const Item& it = items[k & 1];
    const int n_stages = it.n_stages;
    int nev = -1, nc = 0, nf = 0;
    if (warp == 0) load_events(item + step, nev, nc, nf);  // consumed below
    if (i_k != k) {  // not reached by the cursor yet: the first item, or
                     // one after an item with nothing to multiply
      cursor_to(k);
      if (i_left > 0) copy_stage(s);
      cp_async_commit();
    }

    // Lanes from each event's count to cap, while the copies and the next
    // item's events fly.
    for (int e = warp; e < kMaxG; e += kWarps) {
      const int ev = it.ev[e];
      if (ev < 0) continue;
      float* o = out + static_cast<size_t>(ev) * cap;
      for (int r = it.cnt[e] + l; r < cap; r += 32) __stcs(o + r, -CUDART_INF_F);
    }
    if (warp == 0) make_item(items[(k + 1) & 1], nev, nc, nf);

    int c_run = 0, c_tile = 0, c_chunk = 0;  // run, tile, chunk of stage s
    for (int t = 0; t < n_stages; ++t, ++s) {
      cp_async_wait<kStages - 2>();  // stage s has landed (this thread's)
      __syncthreads();               // ... everyone's; stage s - 1 is free,
                                     // and the next item's table is written
      if (i_left == 0 && i_k == k) cursor_to(k + 1);
      if (i_left > 0) copy_stage(s + 1);
      cp_async_commit();

      const int len = it.run_len[c_run];
      const int run_rows = it.run_rows[c_run];
      const int rows = min(kTileRows, run_rows - c_tile * kTileRows);
      const int groups = (rows + 31) / 32;  // the tile's live 32-row groups
      // A wide run (more than kSlab events): warp pair w & 1 takes 16
      // slots, its two warps deal the row groups.  Else all 4 warps take
      // the first 16 (8) slots and deal the row groups four ways.
      const bool wide = len > kSlab;
      const int slab = wide ? (warp & 1) * kSlab : 0;
      const int h = wide ? warp >> 1 : warp;   // the warp's first row group
      const int deal = wide ? 2 : kWarps;      // groups between its rows
      const int nr = groups > h ? (groups - h + deal - 1) / deal : 0;
      if (nr > 0) {
        const unsigned char* stage = smem + (s % kStages) * S::kBytes;
        const unsigned char* buf = stage + (32 * h + l) * kRowStride;
        const float* qrow =
            reinterpret_cast<const float*>(stage + S::kRowsBytes) +
            slab * S::kFeat;
        if (wide) {
          stage_rows<T, kSlab, 4, 64>(nr, buf, qrow, acc);
        } else if (len > kNarrow) {
          stage_rows<T, kSlab, 2, 128>(nr, buf, qrow, acc);
        } else {
          stage_rows<T, kNarrow, 2, 128>(nr, buf, qrow, acc);
        }
        if (c_chunk == n_chunks - 1) {
          // the tile's scores are complete: slot slab + i, lane lane0 +
          // 32 deal j, kept below the slot's own count
          const int slot0 = it.run_slot[c_run] + slab;
          const int lane0 = c_tile * kTileRows + 32 * h + l;
#pragma unroll
          for (int i = 0; i < kSlab; ++i) {
            if (slab + i < len) {
              const int cnt = it.cnt[slot0 + i];
              float* o = out + static_cast<size_t>(it.ev[slot0 + i]) * cap;
#pragma unroll
              for (int j = 0; j < kRowsPerLane; ++j) {
                const int r = lane0 + 32 * deal * j;
                if (j < nr && r < cnt) __stcs(o + r, acc[i][j]);
              }
            }
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
          }
        }
      }
      if (++c_chunk == n_chunks) {
        c_chunk = 0;
        if ((++c_tile) * kTileRows >= run_rows) {
          c_tile = 0;
          ++c_run;
        }
      }
    }
    __syncthreads();
  }
}

// Resident blocks per SM and the persistent grid (that times the SM
// count) of the kernel for corpus type T on the current device.  Its
// shared memory does not depend on the shapes, so the attribute is set
// and the grid worked out on the first call for each device, and kept.
template <typename T>
int occupancy(int* blocks_per_sm, int* grid) {
  struct Entry {
    int device, per_sm, grid;
  };
  static std::mutex mu;
  static std::vector<Entry> kept;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : kept) {
    if (e.device == device) {
      *blocks_per_sm = e.per_sm;
      *grid = e.grid;
      return 0;
    }
  }
  auto kernel = bucket_kernel<T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Stage<T>::kBytes * kStages);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, Stage<T>::kBytes * kStages);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kept.push_back({device, per_sm, per_sm * sms});
  *blocks_per_sm = per_sm;
  *grid = per_sm * sms;
  return 0;
}

template <typename T>
int launch(const void* queries, const void* data, const void* order,
           const void* first, const void* counts, void* out, int n_events,
           int n_probes, int cap, int d_pad, int n_rows, void* stream) {
  if (n_events < 0 || n_probes < 1 || cap < 1 || cap > n_rows || d_pad <= 0 ||
      d_pad % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0, grid = 0;
  const int err = occupancy<T>(&per_sm, &grid);
  if (err != 0) return err;
  if (n_events > 0) {
    const int n_items = (n_events + kMaxG - 1) / kMaxG;
    bucket_kernel<T><<<min(n_items, grid), kThreads,
                       Stage<T>::kBytes * kStages,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const T*>(data),
        static_cast<const int*>(order), static_cast<const int*>(first),
        static_cast<const int*>(counts), static_cast<float*>(out), n_events,
        n_probes, cap, d_pad, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 and K6: `order` is the events sorted by first row (stride * index,
// clamped; K5: stride = cap, K6: 1), those that score nothing last;
// `first` and `counts` are their first rows and counts in that order.
// dtype: 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Returns
// cudaError_t.
extern "C" int nlsh_bucket_scores(int dtype, const void* queries,
                                  const void* data, const void* order,
                                  const void* first, const void* counts,
                                  void* out, int n_events, int n_probes,
                                  int cap, int d_pad, int n_rows,
                                  void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(queries, data, order, first, counts, out, n_events,
                           n_probes, cap, d_pad, n_rows, stream);
    case 1:
      return launch<__nv_bfloat16>(queries, data, order, first, counts, out,
                                   n_events, n_probes, cap, d_pad, n_rows,
                                   stream);
    case 2:
      return launch<int8_t>(queries, data, order, first, counts, out,
                            n_events, n_probes, cap, d_pad, n_rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the fixed-cap kernel for a corpus dtype (the
// same at every cap and d_pad): its persistent grid is this times the SM
// count.  Returns cudaError_t.
extern "C" int nlsh_bucket_blocks_per_sm(int dtype, int* blocks_per_sm) {
  int grid = 0;
  switch (dtype) {
    case 0: return occupancy<float>(blocks_per_sm, &grid);
    case 1: return occupancy<__nv_bfloat16>(blocks_per_sm, &grid);
    case 2: return occupancy<int8_t>(blocks_per_sm, &grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
