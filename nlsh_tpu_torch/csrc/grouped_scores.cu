// Grouped bucket-block scoring of the serving path: kernels K1-K4.
//
// Replaces the Pallas kernels of nlsh_tpu/ops/pallas/query_kernel.py:
//   K1  _grouped_scores_topk (kernel body _make_grouped_topk_kernel):
//       per group, S = Q_g . B^T in exact f32, times the optional per-row
//       scale, minus the optional per-row norms, lanes >= grp_cnt masked
//       to -inf, then the top kk of each row, lowest lane first on ties.
//   K2  _grouped_scores_v3 (kernel body _make_grouped_kernel_v3): the same
//       product as a raw (G, br) panel: no scale, norms, mask or top-k.
//   K3  _windowed_scores_topk (kernel body _make_windowed_topk_kernel):
//       K1 over br-row WINDOWS of a dense (8-row-aligned) layout; query
//       slot s keeps the lanes in [grp_lo[g, s], grp_hi[g, s]), its
//       bucket's extent inside the window.  K1's mask lane < cnt is the
//       case lo = 0, hi = cnt, so K3 is K1's body with a lower bound
//       (template flag kWindowed; K1 compiles exactly as before).
//   K4  _windowed_scores (kernel body _make_windowed_kernel): raw windowed
//       panels.  A window is br rows and the layout's row count is a
//       multiple of br, so a window index IS a block index and K4 is K2's
//       kernel launched on the window table (entry nlsh_grouped_scores;
//       the Python wrapper windowed_scores keeps its own count).
//   K7  the int8 probe of benchmarks/int8_probe.py (its inline kernel):
//       q . upcast(int8 block)^T over a scrambled block order, i.e. K2's
//       kernel on an int8 layout with the one query panel repeated for
//       every block (wrapper int8_block_scores, its own count).
//
// Corpus rows are f32, bf16 or int8 (dtype 0, 1, 2), widened to f32 by
// the loads of load16.cuh before any arithmetic, as the reference
// upcasts its blocks; an int8 layout's per-row scale rides the `scale`
// pointer of K1/K3.
//
// What bounds it: a group multiplies its G <= 32 f32 query rows by one
// br-row corpus block, 2 * G = 64 flop per corpus element, i.e. about 16
// flop per streamed f32 byte at the bench shape (G = 32, br = 512,
// d_pad = 128).  That is far below the H100's f32 ridge point, so the
// kernel is bound by memory and L2 traffic, not by arithmetic: one
// 256 KB f32 window or block (512 x 128 x 4 B) streamed per live group.
// The prep sorts groups by block (window), so the groups that share a
// hot block run in neighbouring thread blocks and re-read it from the
// 50 MB L2 rather than from HBM.
//
// Design (a simple kernel that is right; wgmma, TMA and persistent blocks
// are later work): one thread block of 512 threads per group.  The
// group's query rows stay in shared memory; the corpus block streams
// through it in 128-row x 128-feature tiles, loaded with 16-byte loads
// and widened to f32.  Each thread accumulates 4 query rows x 2 corpus
// rows with f32 FMAs on the CUDA cores: no tensor cores, hence no TF32,
// so scores stay exact f32 like the reference's HIGHEST-precision dots.
// A lane's dot runs the same FMA sequence wherever the row sits in its
// block, so one corpus row scores bit-identically in every table of an
// ensemble.  K1/K3 keep the (G, br) panel in dynamic shared memory
// (64 KB at br = 512) and select each row's top kk with one warp per row:
// kk rounds of a warp argmax in which the lowest lane wins ties, the
// reference rule.  Row tiles outside [min lo, max hi) over the group's
// live slots are masked anyway and are skipped, which also skips empty
// slots (lo = hi = 0) and whole dead groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "load16.cuh"

namespace {

using nlsh::Load16;

constexpr int kThreads = 512;             // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 32;                 // query rows per group
constexpr int kTileRows = 128;            // corpus rows per tile
constexpr int kTileK = 128;               // features per tile
constexpr int kBStride = kTileK + 4;      // padded tile row (floats): float4
                                          // reads of 8 rows hit 8 bank groups
constexpr int kQPerThread = 4;            // 8 query slabs x 4 = 32 rows
constexpr int kRowHalf = kTileRows / 2;   // a thread's rows: r and r + 64

// Copy rows [0, kTileRows) x features [k0, k0 + kTileK) of `tile` (row
// stride d_pad) into bs[r * kBStride + c] as f32.
template <typename T>
__device__ void stage_corpus_tile(const T* __restrict__ tile, int d_pad,
                                  int k0, float* bs) {
  constexpr int kN = Load16<T>::kN;
  constexpr int kVecPerRow = kTileK / kN;
  for (int i = threadIdx.x; i < kTileRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kN;
    float v[kN];
    Load16<T>::run(tile + static_cast<size_t>(r) * d_pad + k0 + c, v);
    float* dst = bs + r * kBStride + c;
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
}

// One thread block per group.  kTopK selects K1/K3 (masked per-row
// top-kk) or K2/K4 (raw panel); kWindowed adds K3's lower lane bound.
template <typename T, bool kTopK, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const float* __restrict__ qvecs,    // (g_total, G, d_pad)
               const T* __restrict__ data,         // (n_blocks * br, d_pad)
               const int* __restrict__ grp_block,  // (g_total,) block/window
               const int* __restrict__ grp_cnt,    // (g_total, G) K1 cnt, K3 hi
               const int* __restrict__ grp_lo,     // (g_total, G); K3 only
               const float* __restrict__ norms,    // (n_blocks * br,) or null
               const float* __restrict__ scale,    // (n_blocks * br,) or null
               float* __restrict__ out_scores,     // K1 (g, G, kk); K2 (g, G, br)
               int* __restrict__ out_lanes,        // K1 (g, G, kk)
               int G, int d_pad, int br, int n_blocks, int kk) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kMaxG x d_pad
  float* bs = qs + kMaxG * d_pad;               // kTileRows x kBStride
  float* panel = bs + kTileRows * kBStride;     // kMaxG x br (K1)
  __shared__ int lo_s[kMaxG];   // a slot keeps lanes [lo_s, cnt_s)
  __shared__ int cnt_s[kMaxG];
  __shared__ int tile_lo_s, tile_hi_s;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int blk = min(max(grp_block[g], 0), n_blocks - 1);
  const size_t row0 = static_cast<size_t>(blk) * br;

  int t0 = 0;                                // row tiles worth scoring:
  int t1 = (br + kTileRows - 1) / kTileRows; // [t0, t1)
  if (kTopK) {
    if (tid < kMaxG) {
      int lo = 0, hi = 0;
      if (tid < G) {
        hi = min(max(grp_cnt[g * G + tid], 0), br);
        if (kWindowed) lo = min(max(grp_lo[g * G + tid], 0), br);
      }
      if (hi <= lo) lo = hi = 0;  // an empty slot
      lo_s[tid] = lo;
      cnt_s[tid] = hi;
    }
    __syncthreads();
    if (tid == 0) {
      int lo = br, hi = 0;
      for (int q = 0; q < kMaxG; ++q) {
        if (cnt_s[q] > lo_s[q]) {
          lo = min(lo, lo_s[q]);
          hi = max(hi, cnt_s[q]);
        }
      }
      tile_lo_s = hi > lo ? lo / kTileRows : 0;
      tile_hi_s = hi > lo ? (hi + kTileRows - 1) / kTileRows : 0;
    }
    __syncthreads();
    t0 = tile_lo_s;
    t1 = tile_hi_s;
  }

  // the group's query rows; rows past G are zero
  const float* qg = qvecs + static_cast<size_t>(g) * G * d_pad;
  for (int i = tid * 4; i < kMaxG * d_pad && t1 > t0; i += kThreads * 4) {
    const float4 v = i / d_pad < G
                         ? __ldg(reinterpret_cast<const float4*>(qg + i))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + i) = v;
  }

  const int r_lo = tid % kRowHalf;
  const int q_lo = (tid / kRowHalf) * kQPerThread;
  for (int t = t0; t < t1; ++t) {
    float acc[kQPerThread][2];
#pragma unroll
    for (int i = 0; i < kQPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;
    const T* tile = data + (row0 + static_cast<size_t>(t) * kTileRows) * d_pad;
    for (int k0 = 0; k0 < d_pad; k0 += kTileK) {
      __syncthreads();  // the previous tile (and the query rows) are settled
      stage_corpus_tile<T>(tile, d_pad, k0, bs);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTileK; k += 4) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + r_lo * kBStride + k);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + (r_lo + kRowHalf) * kBStride + k);
#pragma unroll
        for (int i = 0; i < kQPerThread; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              qs + (q_lo + i) * d_pad + k0 + k);
          acc[i][0] = fmaf(a.x, b0.x, acc[i][0]);
          acc[i][0] = fmaf(a.y, b0.y, acc[i][0]);
          acc[i][0] = fmaf(a.z, b0.z, acc[i][0]);
          acc[i][0] = fmaf(a.w, b0.w, acc[i][0]);
          acc[i][1] = fmaf(a.x, b1.x, acc[i][1]);
          acc[i][1] = fmaf(a.y, b1.y, acc[i][1]);
          acc[i][1] = fmaf(a.z, b1.z, acc[i][1]);
          acc[i][1] = fmaf(a.w, b1.w, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQPerThread; ++i) {
      const int q = q_lo + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lane = t * kTileRows + r_lo + j * kRowHalf;
        float s = acc[i][j];
        if (kTopK) {
          // scale first, then the norms bias, rounded separately (no FMA
          // contraction) as the reference does them
          if (scale != nullptr) s = __fmul_rn(s, scale[row0 + lane]);
          if (norms != nullptr) s = __fsub_rn(s, norms[row0 + lane]);
          const bool keep =
              (!kWindowed || lane >= lo_s[q]) && lane < cnt_s[q];
          panel[q * br + lane] = keep ? s : -CUDART_INF_F;
        } else if (q < G) {
          out_scores[(static_cast<size_t>(g) * G + q) * br + lane] = s;
        }
      }
    }
  }
  if (!kTopK) return;

  // lanes of skipped tiles are masked
  for (int i = tid; i < kMaxG * br; i += kThreads) {
    const int lane = i % br;
    if (lane < t0 * kTileRows || lane >= t1 * kTileRows) {
      panel[i] = -CUDART_INF_F;
    }
  }
  __syncthreads();

  const int warp = tid / 32;
  const int l = tid % 32;
  for (int q = warp; q < G; q += kWarps) {
    float* row = panel + q * br;
    float* os = out_scores + (static_cast<size_t>(g) * G + q) * kk;
    int* ol = out_lanes + (static_cast<size_t>(g) * G + q) * kk;
    for (int r = 0; r < kk; ++r) {
      float best = row[l];
      int bi = l;
      for (int j = l + 32; j < br; j += 32) {
        const float v = row[j];
        if (v > best) {  // strict: the lower lane keeps a tie
          best = v;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      // every lane now holds the same (best, bi)
      if (l == 0) {
        os[r] = best;
        ol[r] = bi;
      }
      if ((bi & 31) == l) row[bi] = -CUDART_INF_F;
      __syncwarp();
    }
  }
}

size_t smem_bytes(int d_pad, int br, bool topk) {
  return sizeof(float) * (static_cast<size_t>(kMaxG) * d_pad +
                          static_cast<size_t>(kTileRows) * kBStride +
                          (topk ? static_cast<size_t>(kMaxG) * br : 0));
}

template <typename T, bool kTopK, bool kWindowed>
int launch(const void* qvecs, const void* data, const void* grp_block,
           const void* grp_cnt, const void* grp_lo, const void* norms,
           const void* scale, void* out_scores, void* out_lanes, int g_total,
           int G, int d_pad, int br, int n_blocks, int kk, void* stream) {
  const size_t smem = smem_bytes(d_pad, br, kTopK);
  auto kernel = grouped_kernel<T, kTopK, kWindowed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_total > 0) {
    kernel<<<g_total, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qvecs), static_cast<const T*>(data),
        static_cast<const int*>(grp_block), static_cast<const int*>(grp_cnt),
        static_cast<const int*>(grp_lo), static_cast<const float*>(norms),
        static_cast<const float*>(scale), static_cast<float*>(out_scores),
        static_cast<int*>(out_lanes), G, d_pad, br, n_blocks, kk);
  }
  return static_cast<int>(cudaGetLastError());
}

// one launch<> per corpus dtype
template <bool kTopK, bool kWindowed>
int launch_dtype(int dtype, const void* qvecs, const void* data,
                 const void* grp_block, const void* grp_hi,
                 const void* grp_lo, const void* norms, const void* scale,
                 void* out_scores, void* out_lanes, int g_total, int G,
                 int d_pad, int br, int n_blocks, int kk, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float, kTopK, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    case 1:
      return launch<__nv_bfloat16, kTopK, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    case 2:
      return launch<int8_t, kTopK, kWindowed>(
          qvecs, data, grp_block, grp_hi, grp_lo, norms, scale, out_scores,
          out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Returns cudaError_t.
extern "C" int nlsh_grouped_scores_topk(
    int dtype, const void* qvecs, const void* data, const void* grp_block,
    const void* grp_cnt, const void* norms, const void* scale,
    void* out_scores, void* out_lanes, int g_total, int G, int d_pad, int br,
    int n_blocks, int kk, void* stream) {
  return launch_dtype<true, false>(dtype, qvecs, data, grp_block, grp_cnt,
                                   nullptr, norms, scale, out_scores,
                                   out_lanes, g_total, G, d_pad, br,
                                   n_blocks, kk, stream);
}

// K3: grp_window (g,) window ids, grp_lo / grp_hi (g, G) lane bounds.
extern "C" int nlsh_windowed_scores_topk(
    int dtype, const void* qvecs, const void* data, const void* grp_window,
    const void* grp_lo, const void* grp_hi, const void* norms,
    const void* scale, void* out_scores, void* out_lanes, int g_total, int G,
    int d_pad, int br, int n_windows, int kk, void* stream) {
  return launch_dtype<true, true>(dtype, qvecs, data, grp_window, grp_hi,
                                  grp_lo, norms, scale, out_scores, out_lanes,
                                  g_total, G, d_pad, br, n_windows, kk,
                                  stream);
}

// K2, and K4 on a window table, and K7 on an int8 block table.
extern "C" int nlsh_grouped_scores(int dtype, const void* qvecs,
                                   const void* data, const void* grp_block,
                                   void* out, int g_total, int G, int d_pad,
                                   int br, int n_blocks, void* stream) {
  return launch_dtype<false, false>(dtype, qvecs, data, grp_block, nullptr,
                                    nullptr, nullptr, nullptr, out, nullptr,
                                    g_total, G, d_pad, br, n_blocks, 0,
                                    stream);
}
