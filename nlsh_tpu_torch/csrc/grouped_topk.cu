// Fused grouped score + per-row top-k for Hopper: kernels K1 and K3.
//
// Replaces the Pallas kernels of nlsh_tpu/ops/pallas/query_kernel.py:
//   K1  _grouped_scores_topk (:879; kernel body _make_grouped_topk_kernel
//       :824): per group, S = Q_g . B^T in exact f32, times the optional
//       per-row scale, minus the optional per-row norms, lanes >= grp_cnt
//       masked to -inf, then the top kk of each row, lowest lane first on
//       ties.
//   K3  _windowed_scores_topk (:1372; kernel body _make_windowed_topk_kernel
//       :1316): the same over br-row WINDOWS of a dense layout, query slot s
//       keeping only the lanes in [grp_lo[g, s], grp_hi[g, s]).  K1 is the
//       case lo = 0, hi = cnt (template flag kWindowed).
//
// Corpus rows are f32, bf16 or int8 (dtype 0, 1, 2); an int8 layout's
// per-row scale rides the `scale` pointer.
//
// What bounds it on the H100: a group scores its G <= 32 f32 queries
// against the live rows of one br-row block (window): 2 * 32 = 64 flop
// per streamed f32 corpus element, about 16 flop per byte, under the
// card's f32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 flop per byte)
// even with every slot live, and the live (slot, lane) pairs are only a
// third to a half of a group's.  So the bound is the bytes: each corpus
// row a live slot keeps, once (the prep sorts groups by block or window,
// so neighbouring groups re-read a hot block from the 50 MB L2), plus the
// live slots' queries.  What a kernel has to do to get near it: keep
// bytes in flight (several blocks per SM, loads running ahead of the
// math), spend few issue slots per FMA, select without stalling, and do
// no work on masked lanes or dead groups.
//
// Design:
//   * A persistent grid of (resident blocks per SM) x (SMs) blocks of 4
//     warps walks the group table, g += gridDim.x; the grid covers a
//     contiguous run of groups at any moment, so groups sharing a block
//     or window run side by side and hit L2.  A group's bounds and block id
//     are read while the previous group runs; a dead group then costs the
//     write of its -inf rows.
//   * The corpus streams through a ring of kStages stages in shared
//     memory, filled by cp.async (16 bytes per thread and copy, L2 only):
//     stage = the 128 rows of a tile x 128 bytes of each row (32 f32, 64
//     bf16 or 128 int8 features), kept in the layout's own type and
//     widened to f32 as it is read out of shared memory.  Rows are padded
//     to 144 bytes, so the 16-byte reads of 8 consecutive rows cover all
//     32 banks.  Stage s + 1 loads while stage s is multiplied.  Only the
//     tiles some live slot overlaps are loaded.
//   * Warp w owns the 8 query slots [8w, 8w + 8) of every tile, each lane
//     rows lane + 32j (j < 4): a register tile of 8 slots x 4 rows, 32
//     accumulators, one broadcast float4 read of a query per 16 FMAs.  A
//     warp whose 8 slots all miss the tile skips it (warp-uniform).
//   * No score panel.  Each slot has a buffer of kCap candidates in shared
//     memory and a threshold that its kk-th best provably reaches; a
//     tile's candidate enters (by ballot and prefix count) only if it
//     beats the threshold: a higher score, or the same score and a lower
//     lane.  When a buffer would overflow (the first tile of a slot), the
//     thresholds rise to the kk-th largest of the lanes' running maxima
//     (counted over shared memory), and a buffer still too full is cut to
//     its kk best.  At the end of the group each candidate's rank among
//     its slot's (how many sort before it, with the lowest lane first on
//     equal scores) is its place in the output.  Every step is a ballot,
//     a broadcast read or an independent compare: chains of dependent
//     warp shuffles (insertion into a running list, bitonic networks) left
//     the SM idle, and 8-slot-wide unrolled selection code crowded the FMA
//     loop out of the instruction cache.
//   * 168 registers and 69.6 KB of shared memory at d_pad = 128: 3
//     resident blocks per SM.

// Semantics kept from the reference: exact f32 (fmaf on the CUDA cores,
// no tensor cores, hence no TF32); a lane's FMA chain runs over the
// features in order from 0 whatever the row's position, so one corpus row
// scores bit-identically in every table and window (the ensemble's dedupe
// relies on it) and as the previous kernel did; the scale is applied with
// __fmul_rn and the norms with __fsub_rn, each rounded on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "ring.cuh"

namespace {

using nlsh::cp_async16;
using nlsh::cp_async_commit;
using nlsh::cp_async_wait;
using nlsh::Widen;

constexpr int kThreads = 128;                 // 4 warps
constexpr int kMaxG = 32;                     // query slots per group
constexpr int kSlab = 8;                      // slots per warp
constexpr int kTileRows = 128;                // corpus rows per tile
constexpr int kRowsPerLane = kTileRows / 32;  // rows lane + 32 j
constexpr int kStageBytes = 128;              // bytes of a row per stage
constexpr int kChunks = kStageBytes / 16;     // 16-byte copies per row
constexpr int kRowStride = kStageBytes + 16;  // padded stage row (bytes)
constexpr int kStageSize = kTileRows * kRowStride;
constexpr int kStages = 2;                    // ring depth
constexpr int kMaxTiles = 64;                 // br <= 8192
constexpr int kCap = 64;                      // candidate buffer per slot
constexpr int kMaxKK = 16;                    // ROW_TOPK
constexpr int kNoLane = 0x7fffffff;           // lane of an empty entry
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads / 32 * kSlab == kMaxG, "one warp per 8-slot slab");

// Phase counters, compiled in only with -DNLSH_TOPK_PHASES
// (nlsh_tpu_torch/tools/topk_phases.py; the port's own build has none):
// each warp sums the clock64 cycles of each phase and adds them to
// g_phase at its end.  g_skip_select set skips the per-tile selection, to
// time the kernel without it (its output is then not the top-k).
enum Phase { kWait, kIssue, kCompute, kSelect, kFinal, kHead, kAll, kPhases };
#ifdef NLSH_TOPK_PHASES
__device__ unsigned long long g_phase[kPhases];
__device__ int g_skip_select;
#define PHASE_MARK(t) const long long t = clock64()
#define PHASE_ADD(i, t) phase[i] += clock64() - (t)
#else
#define PHASE_MARK(t)
#define PHASE_ADD(i, t)
#endif

// (s, lane) sorts before (os, ol): a higher score, or the same score and
// a lower lane.
__device__ __forceinline__ bool before(float s, int lane, float os, int ol) {
  return s > os || (s == os && lane < ol);
}

// A float's bits as an int that orders as the float does.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Per slot, a buffer of up to kCap candidates in shared memory and a
// threshold (ts, tl) that the slot's kk-th best provably reaches: every
// candidate of the slot that does not beat it is out of its top kk.
struct Slots {
  float* bs;   // (kMaxG, kCap) scores
  int* bl;     // (kMaxG, kCap) lanes
  float* ts;   // (kMaxG,) threshold score
  int* tl;     // (kMaxG,) threshold lane
  int* n;      // (kMaxG,) candidates held
  float* mx;   // (kMaxG / kSlab, kSlab, 32) scratch: the lanes' maxima
};

// The ranks by `before` of a slot's buffered candidates l and l + 32
// among its n (<= kCap = 64): how many of the n sort before each.
// Broadcast reads and independent compares, no chain of shuffles.
__device__ __forceinline__ void ranks(const float* bs, const int* bl, int n,
                                      int l, float& s0, int& l0, float& s1,
                                      int& l1, int& r0, int& r1) {
  static_assert(kCap == 64, "two candidates per lane");
  s0 = l < n ? bs[l] : -CUDART_INF_F;
  l0 = l < n ? bl[l] : kNoLane;
  s1 = l + 32 < n ? bs[l + 32] : -CUDART_INF_F;
  l1 = l + 32 < n ? bl[l + 32] : kNoLane;
  r0 = r1 = 0;
#pragma unroll 4
  for (int e = 0; e < n; ++e) {
    const float se = bs[e];
    const int le = bl[e];
    r0 += before(se, le, s0, l0);
    r1 += before(se, le, s1, l1);
  }
}

// Add one tile's scores of the warp's kSlab slots (v[i][j]: slot q0 + i,
// lane lane0 + l + 32 j, -inf where masked; mx[i]: this lane's running
// maximum of slot q0 + i) to their buffers.  A candidate enters only if
// it beats the slot's threshold.  When a buffer would overflow, every
// threshold first rises to the kk-th largest of the lanes' running maxima
// (kk distinct candidates reach it); a buffer that still overflows is
// filled and cut to its kk best, in order, the kk-th becoming the
// threshold, until the rest fits.
__device__ __forceinline__ void add_tile(const Slots& st, int q0,
                                         const float (&v)[kSlab][kRowsPerLane],
                                         const float (&mx)[kSlab], int lane0,
                                         int kk, int l) {
  const unsigned below = (1u << l) - 1u;  // lanes under this one
  float ts[kSlab];
  int tl[kSlab], n[kSlab], cnt[kSlab];
  unsigned m[kSlab][kRowsPerLane];
  bool over = false;
#pragma unroll
  for (int i = 0; i < kSlab; ++i) {
    ts[i] = st.ts[q0 + i];
    tl[i] = st.tl[q0 + i];
    n[i] = st.n[q0 + i];
    cnt[i] = 0;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      m[i][j] = __ballot_sync(kFull, v[i][j] > -CUDART_INF_F &&
                              before(v[i][j], lane0 + l + 32 * j, ts[i], tl[i]));
      cnt[i] += __popc(m[i][j]);
    }
    over |= n[i] + cnt[i] > kCap;
  }
  if (over) {
    // th[i]: the largest lane maximum that kk lanes' maxima reach
    float* w = st.mx + q0 * 32;
#pragma unroll
    for (int i = 0; i < kSlab; ++i) w[i * 32 + l] = mx[i];
    __syncwarp();
    int c[kSlab] = {};
#pragma unroll 4
    for (int e = 0; e < 32; ++e) {
#pragma unroll
      for (int i = 0; i < kSlab; ++i) c[i] += w[i * 32 + e] >= mx[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSlab; ++i) {
      const float th = unordered(__reduce_max_sync(
          kFull, c[i] >= kk ? ordered(mx[i]) : ordered(-CUDART_INF_F)));
      if (th > ts[i]) {  // (th, kNoLane): every score >= th beats it
        ts[i] = th;
        tl[i] = kNoLane;
        cnt[i] = 0;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          m[i][j] = __ballot_sync(kFull, ((m[i][j] >> l) & 1u) && v[i][j] >= th);
          cnt[i] += __popc(m[i][j]);
        }
      }
      while (n[i] + cnt[i] > kCap) {  // warp-uniform; ties or long ranges
        float* bs = st.bs + (q0 + i) * kCap;
        int* bl = st.bl + (q0 + i) * kCap;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int pos = n[i] + __popc(m[i][j] & below);
          const bool put = ((m[i][j] >> l) & 1u) && pos < kCap;
          if (put) {
            bs[pos] = v[i][j];
            bl[pos] = lane0 + l + 32 * j;
          }
          n[i] = min(n[i] + __popc(m[i][j]), kCap);
          m[i][j] &= ~__ballot_sync(kFull, put);
        }
        __syncwarp();
        float s0, s1;
        int l0, l1, r0, r1;
        ranks(bs, bl, kCap, l, s0, l0, s1, l1, r0, r1);
        __syncwarp();
        if (r0 < kk) {
          bs[r0] = s0;
          bl[r0] = l0;
        }
        if (r1 < kk) {
          bs[r1] = s1;
          bl[r1] = l1;
        }
        __syncwarp();
        ts[i] = bs[kk - 1];
        tl[i] = bl[kk - 1];
        n[i] = kk;
        cnt[i] = 0;
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          m[i][j] = __ballot_sync(kFull, ((m[i][j] >> l) & 1u) &&
                                  before(v[i][j], lane0 + l + 32 * j, ts[i], tl[i]));
          cnt[i] += __popc(m[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSlab; ++i) {
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      if ((m[i][j] >> l) & 1u) {
        const int pos = n[i] + __popc(m[i][j] & below);
        st.bs[(q0 + i) * kCap + pos] = v[i][j];
        st.bl[(q0 + i) * kCap + pos] = lane0 + l + 32 * j;
      }
      n[i] += __popc(m[i][j]);
    }
  }
  __syncwarp();
  if (l == 0) {
#pragma unroll
    for (int i = 0; i < kSlab; ++i) {
      st.ts[q0 + i] = ts[i];
      st.tl[q0 + i] = tl[i];
      st.n[q0 + i] = n[i];
    }
  }
  __syncwarp();
}

// The top kk of each of the warp's slots: each buffered candidate's rank
// is its place in the output, ranks past the candidates are -inf.
__device__ __forceinline__ void write_topk(const Slots& st, int q0, int l,
                                           int kk, int G, size_t out0,
                                           float* out_scores, int* out_lanes) {
#pragma unroll 1
  for (int i = 0; i < kSlab && q0 + i < G; ++i) {
    const int n = st.n[q0 + i];
    float s0, s1;
    int l0, l1, r0, r1;
    ranks(st.bs + (q0 + i) * kCap, st.bl + (q0 + i) * kCap, n, l, s0, l0, s1,
          l1, r0, r1);
    const size_t o = (out0 + q0 + i) * kk;
    if (l < n && r0 < kk) {
      out_scores[o + r0] = s0;
      out_lanes[o + r0] = l0;
    }
    if (l + 32 < n && r1 < kk) {
      out_scores[o + r1] = s1;
      out_lanes[o + r1] = l1;
    }
    if (l >= n && l < kk) {
      out_scores[o + l] = -CUDART_INF_F;
      out_lanes[o + l] = 0;
    }
  }
}

__device__ __forceinline__ bool overlaps(int lo, int hi, int t) {
  return hi > lo && lo < (t + 1) * kTileRows && hi > t * kTileRows;
}

template <typename T, bool kWindowed>
__global__ void __launch_bounds__(kThreads, 3)
grouped_topk_kernel(const float* __restrict__ qvecs,    // (g_total, G, d_pad)
                    const T* __restrict__ data,         // (n_blocks * br, d_pad)
                    const int* __restrict__ grp_block,  // (g_total,)
                    const int* __restrict__ grp_hi,     // (g_total, G) K1 cnt
                    const int* __restrict__ grp_lo,     // (g_total, G); K3 only
                    const float* __restrict__ norms,    // (n_blocks * br,) or null
                    const float* __restrict__ scale,    // (n_blocks * br,) or null
                    float* __restrict__ out_scores,     // (g_total, G, kk)
                    int* __restrict__ out_lanes,        // (g_total, G, kk)
                    int g_total, int G, int d_pad, int br, int n_blocks,
                    int kk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // kMaxG x d_pad
  unsigned char* ring = smem + sizeof(float) * kMaxG * d_pad;
  __shared__ int lo_s[kMaxG];  // slot s keeps lanes [lo_s, hi_s)
  __shared__ int hi_s[kMaxG];
  __shared__ int tiles_s[kMaxTiles];  // the tiles some slot overlaps
  __shared__ int n_tiles_s;
  __shared__ float ts_s[kMaxG];
  __shared__ int tl_s[kMaxG];
  __shared__ int n_s[kMaxG];
  __shared__ float mx_s[kMaxG * 32];
  __shared__ int blk_s;
  const Slots st{reinterpret_cast<float*>(ring + kStages * kStageSize),
                 reinterpret_cast<int*>(ring + kStages * kStageSize) +
                     kMaxG * kCap,
                 ts_s, tl_s, n_s, mx_s};

  constexpr int kN = Widen<T>::kN;
  constexpr int kFeat = kStageBytes / static_cast<int>(sizeof(T));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int l = tid % 32;
  const int q0 = warp * kSlab;
  const size_t row_bytes = static_cast<size_t>(d_pad) * sizeof(T);
  const int n_chunks = static_cast<int>(row_bytes / kStageBytes);
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);

  // thread tid < kMaxG: slot tid's [lo, hi) in group g, empty as 0, 0
  auto bounds = [&](int g, int& lo, int& hi) {
    lo = hi = 0;
    if (tid < G) {
      hi = min(max(grp_hi[g * G + tid], 0), br);
      if (kWindowed) lo = min(max(grp_lo[g * G + tid], 0), br);
    }
    if (hi <= lo) lo = hi = 0;
  };
  const int g0 = static_cast<int>(blockIdx.x);
  const int g_step = static_cast<int>(gridDim.x);
  int next_lo = 0, next_hi = 0, next_blk = 0;
  if (tid < kMaxG && g0 < g_total) bounds(g0, next_lo, next_hi);
  if (tid == 0 && g0 < g_total) next_blk = grp_block[g0];

#ifdef NLSH_TOPK_PHASES
  long long phase[kPhases] = {};
  PHASE_MARK(t_all);
#endif
  for (int g = g0; g < g_total; g += g_step) {
    PHASE_MARK(t_head);
    __syncthreads();  // the previous group is done with the shared state
    if (tid < kMaxG) {
      lo_s[tid] = next_lo;
      hi_s[tid] = next_hi;
      ts_s[tid] = -CUDART_INF_F;
      tl_s[tid] = kNoLane;
      n_s[tid] = 0;
      if (tid == 0) blk_s = next_blk;
      if (g + g_step < g_total) {
        bounds(g + g_step, next_lo, next_hi);
        if (tid == 0) next_blk = grp_block[g + g_step];
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int lo = lo_s[l], hi = hi_s[l];
      int n = 0;
      for (int t = 0; t < br / kTileRows; ++t) {
        if (__any_sync(kFull, overlaps(lo, hi, t))) {
          if (l == 0) tiles_s[n] = t;
          ++n;
        }
      }
      if (l == 0) n_tiles_s = n;
    }
    __syncthreads();
    const int n_stages = n_tiles_s * n_chunks;
    const size_t row0 =
        static_cast<size_t>(min(max(blk_s, 0), n_blocks - 1)) * br;

    float mx[kSlab];  // this lane's running maximum of each slot
#pragma unroll
    for (int i = 0; i < kSlab; ++i) mx[i] = -CUDART_INF_F;

    if (n_stages > 0) {
      // the group's query rows; rows past G are zero
      const float* qg = qvecs + static_cast<size_t>(g) * G * d_pad;
      for (int i = tid * 4; i < kMaxG * d_pad; i += kThreads * 4) {
        if (i / d_pad < G) {
          cp_async16(qs + i, qg + i);
        } else {
          *reinterpret_cast<float4*>(qs + i) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      // stage s: bytes [c * 128, c * 128 + 128) of the rows of tile t
      auto issue = [&](int s) {
        const int t = tiles_s[s / n_chunks];
        const int c = s % n_chunks;
        const unsigned char* src =
            bytes + (row0 + static_cast<size_t>(t) * kTileRows) * row_bytes +
            static_cast<size_t>(c) * kStageBytes;
        unsigned char* dst = ring + (s % kStages) * kStageSize;
        for (int i = tid; i < kTileRows * kChunks; i += kThreads) {
          const int r = i / kChunks;
          const int u = i % kChunks;
          cp_async16(dst + r * kRowStride + 16 * u, src + r * row_bytes + 16 * u);
        }
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_stages) issue(s);
        cp_async_commit();  // one group per stage, empty or not
      }

      float acc[kSlab][kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kSlab; ++i) {
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
      }
      bool live = false;  // this warp's slots overlap the current tile
      PHASE_ADD(kHead, t_head);
      for (int s = 0; s < n_stages; ++s) {
        PHASE_MARK(t_wait);
        cp_async_wait<kStages - 2>();  // stage s has landed (this thread's)
        __syncthreads();               // ... everyone's; stage s - 1 is free
        PHASE_ADD(kWait, t_wait);
        PHASE_MARK(t_issue);
        if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
        cp_async_commit();
        PHASE_ADD(kIssue, t_issue);
        const int t = tiles_s[s / n_chunks];
        const int c = s % n_chunks;
        if (c == 0) {
          const int slot = q0 + l % kSlab;
          live = __any_sync(kFull,
                            l < kSlab && overlaps(lo_s[slot], hi_s[slot], t));
        }
        if (!live) continue;

        PHASE_MARK(t_compute);
        const unsigned char* buf =
            ring + (s % kStages) * kStageSize + l * kRowStride;
        const float* qrow = qs + q0 * d_pad + c * kFeat;
#pragma unroll 1
        for (int u = 0; u < kChunks; ++u) {
          uint4 raw[kRowsPerLane];
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            raw[j] = *reinterpret_cast<const uint4*>(
                buf + j * 32 * kRowStride + 16 * u);
          }
#pragma unroll
          for (int sub = 0; sub < kN / 4; ++sub) {
            float b[kRowsPerLane][4];
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
              Widen<T>::get4(raw[j], sub, b[j]);
            }
            const int k = u * kN + 4 * sub;
#pragma unroll
            for (int i = 0; i < kSlab; ++i) {
              const float4 a =
                  *reinterpret_cast<const float4*>(qrow + i * d_pad + k);
#pragma unroll
              for (int j = 0; j < kRowsPerLane; ++j) {
                acc[i][j] = fmaf(a.x, b[j][0], acc[i][j]);
                acc[i][j] = fmaf(a.y, b[j][1], acc[i][j]);
                acc[i][j] = fmaf(a.z, b[j][2], acc[i][j]);
                acc[i][j] = fmaf(a.w, b[j][3], acc[i][j]);
              }
            }
          }
        }
        PHASE_ADD(kCompute, t_compute);
        if (c != n_chunks - 1) continue;

        // the tile's scores are complete: scale, norms, mask, merge
        PHASE_MARK(t_select);
        const int lane0 = t * kTileRows;
        float nrm[kRowsPerLane], scl[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const size_t r = row0 + lane0 + l + 32 * j;
          nrm[j] = norms != nullptr ? __ldg(norms + r) : 0.f;
          scl[j] = scale != nullptr ? __ldg(scale + r) : 1.f;
        }
#pragma unroll
        for (int i = 0; i < kSlab; ++i) {
          const int lo = lo_s[q0 + i], hi = hi_s[q0 + i];
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            const int lane = lane0 + l + 32 * j;
            float x = acc[i][j];
            // scale first, then the norms bias, rounded separately (no FMA
            // contraction) as the reference does them
            if (scale != nullptr) x = __fmul_rn(x, scl[j]);
            if (norms != nullptr) x = __fsub_rn(x, nrm[j]);
            acc[i][j] = lane >= lo && lane < hi ? x : -CUDART_INF_F;
            mx[i] = fmaxf(mx[i], acc[i][j]);
          }
        }
#ifdef NLSH_TOPK_PHASES
        if (!g_skip_select)
#endif
          add_tile(st, q0, acc, mx, lane0, kk, l);
        PHASE_ADD(kSelect, t_select);
#pragma unroll
        for (int i = 0; i < kSlab; ++i) {
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
        }
      }
    }

    PHASE_MARK(t_final);
    write_topk(st, q0, l, kk, G, static_cast<size_t>(g) * G, out_scores,
               out_lanes);
    PHASE_ADD(kFinal, t_final);
  }
#ifdef NLSH_TOPK_PHASES
  phase[kAll] = clock64() - t_all;
  if (l == 0) {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&g_phase[i], static_cast<unsigned long long>(phase[i]));
    }
  }
#endif
}

size_t smem_bytes(int d_pad) {
  return sizeof(float) * static_cast<size_t>(kMaxG) * d_pad +
         static_cast<size_t>(kStages) * kStageSize +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(kMaxG) * kCap;
}

// Resident blocks per SM and the persistent grid (that times the SM
// count) of one kernel at d_pad on the current device.  Worked out on the
// first call for each (device, d_pad) and kept, so a launch makes one
// cheap host call (cudaGetDevice) before it starts.  The kernel's dynamic
// shared memory limit on a device only ever rises, to the largest d_pad
// seen there, so every kept d_pad still fits it.
template <typename T, bool kWindowed>
int occupancy(int d_pad, int* blocks_per_sm, int* grid) {
  struct Entry {
    int device, d_pad, per_sm, grid;
  };
  static std::mutex mu;
  static std::vector<Entry> kept;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  size_t limit = 0;  // the attribute as set on this device so far
  for (const Entry& e : kept) {
    if (e.device != device) continue;
    if (e.d_pad == d_pad) {
      *blocks_per_sm = e.per_sm;
      *grid = e.grid;
      return 0;
    }
    limit = std::max(limit, smem_bytes(e.d_pad));
  }
  const size_t smem = smem_bytes(d_pad);
  auto kernel = grouped_topk_kernel<T, kWindowed>;
  if (smem > limit) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kept.push_back({device, d_pad, per_sm, per_sm * sms});
  *blocks_per_sm = per_sm;
  *grid = per_sm * sms;
  return 0;
}

template <typename T, bool kWindowed>
int launch(const void* qvecs, const void* data, const void* grp_block,
           const void* grp_hi, const void* grp_lo, const void* norms,
           const void* scale, void* out_scores, void* out_lanes, int g_total,
           int G, int d_pad, int br, int n_blocks, int kk, void* stream) {
  if (G < 1 || G > kMaxG || br % kTileRows || br / kTileRows > kMaxTiles ||
      d_pad % 128 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kk = min(max(kk, 1), kMaxKK);
  int per_sm = 0, grid = 0;
  const int err = occupancy<T, kWindowed>(d_pad, &per_sm, &grid);
  if (err != 0) return err;
  if (g_total > 0) {
    grouped_topk_kernel<T, kWindowed>
        <<<min(g_total, grid), kThreads, smem_bytes(d_pad),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(qvecs), static_cast<const T*>(data),
            static_cast<const int*>(grp_block),
            static_cast<const int*>(grp_hi), static_cast<const int*>(grp_lo),
            static_cast<const float*>(norms), static_cast<const float*>(scale),
            static_cast<float*>(out_scores), static_cast<int*>(out_lanes),
            g_total, G, d_pad, br, n_blocks, kk);
  }
  return static_cast<int>(cudaGetLastError());
}

// one launch<> per corpus dtype
template <bool kWindowed>
int launch_dtype(int dtype, const void* qvecs, const void* data,
                 const void* grp_block, const void* grp_hi,
                 const void* grp_lo, const void* norms, const void* scale,
                 void* out_scores, void* out_lanes, int g_total, int G,
                 int d_pad, int br, int n_blocks, int kk, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    case 1:
      return launch<__nv_bfloat16, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    case 2:
      return launch<int8_t, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#ifdef NLSH_TOPK_PHASES
// Copies the phase sums since the last call into out (kPhases values in
// Phase order, all of the warps' cycles last) and zeroes them;
// skip_select sets g_skip_select for the launches that follow.  Returns
// cudaError_t.
extern "C" int nlsh_topk_phases(unsigned long long* out, int skip_select) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[kPhases] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  if (e == cudaSuccess) {
    e = cudaMemcpyToSymbol(g_skip_select, &skip_select, sizeof(int));
  }
  return static_cast<int>(e);
}
#endif

// K1.  dtype: 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Returns
// cudaError_t.
extern "C" int nlsh_grouped_scores_topk(
    int dtype, const void* qvecs, const void* data, const void* grp_block,
    const void* grp_cnt, const void* norms, const void* scale,
    void* out_scores, void* out_lanes, int g_total, int G, int d_pad, int br,
    int n_blocks, int kk, void* stream) {
  return launch_dtype<false>(dtype, qvecs, data, grp_block, grp_cnt, nullptr,
                             norms, scale, out_scores, out_lanes, g_total, G,
                             d_pad, br, n_blocks, kk, stream);
}

// K3: grp_window (g,) window ids, grp_lo / grp_hi (g, G) lane bounds.
extern "C" int nlsh_windowed_scores_topk(
    int dtype, const void* qvecs, const void* data, const void* grp_window,
    const void* grp_lo, const void* grp_hi, const void* norms,
    const void* scale, void* out_scores, void* out_lanes, int g_total, int G,
    int d_pad, int br, int n_windows, int kk, void* stream) {
  return launch_dtype<true>(dtype, qvecs, data, grp_window, grp_hi, grp_lo,
                            norms, scale, out_scores, out_lanes, g_total, G,
                            d_pad, br, n_windows, kk, stream);
}

// Resident blocks per SM of the K1 (windowed = 0) or K3 (windowed = 1)
// kernel for a dtype and d_pad: the persistent grid is this times the
// SM count.  Returns cudaError_t.
extern "C" int nlsh_topk_blocks_per_sm(int dtype, int windowed, int d_pad,
                                       int* blocks_per_sm) {
  int grid = 0;
  switch (dtype * 2 + (windowed != 0)) {
    case 0: return occupancy<float, false>(d_pad, blocks_per_sm, &grid);
    case 1: return occupancy<float, true>(d_pad, blocks_per_sm, &grid);
    case 2: return occupancy<__nv_bfloat16, false>(d_pad, blocks_per_sm, &grid);
    case 3: return occupancy<__nv_bfloat16, true>(d_pad, blocks_per_sm, &grid);
    case 4: return occupancy<int8_t, false>(d_pad, blocks_per_sm, &grid);
    case 5: return occupancy<int8_t, true>(d_pad, blocks_per_sm, &grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
