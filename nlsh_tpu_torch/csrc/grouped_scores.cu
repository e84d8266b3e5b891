// Grouped bucket-block scoring of the serving path: raw score panels,
// kernels K2, K4 and K7 (K1 and K3, the fused top-k, are in
// grouped_topk.cu).
//
// Replaces the Pallas kernels of nlsh_tpu/ops/pallas/query_kernel.py:
//   K2  _grouped_scores_v3 (kernel body _make_grouped_kernel_v3): per
//       group, the raw (G, br) panel S = Q_g . B^T in exact f32: no scale,
//       norms, mask or top-k.
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
// upcasts its blocks.
//
// What bounds it: a group multiplies its G <= 32 f32 query rows by one
// br-row corpus block, 2 * G = 64 flop per corpus element, and writes the
// whole (G, br) f32 panel.  At the bench shape its bytes (each block once,
// the panels once) and its f32 operations take about the same time at
// the H100's rates, so both bound it.  The prep sorts groups by block
// (window), so the groups that share a hot block run in neighbouring
// thread blocks and re-read it from the 50 MB L2.
//
// Design (a simple kernel that is right): one thread block of 512
// threads per group.  The group's query rows stay in shared memory; the
// corpus block streams through it in 128-row x 128-feature tiles, loaded
// with 16-byte loads and widened to f32.  Each thread accumulates 4
// query rows x 2 corpus rows with f32 FMAs on the CUDA cores: no tensor
// cores, hence no TF32, so scores stay exact f32 like the reference's
// HIGHEST-precision dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load16.cuh"

namespace {

using nlsh::Load16;

constexpr int kThreads = 512;             // 16 warps
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

// One thread block per group: the raw (G, br) panel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const float* __restrict__ qvecs,    // (g_total, G, d_pad)
               const T* __restrict__ data,         // (n_blocks * br, d_pad)
               const int* __restrict__ grp_block,  // (g_total,) block/window
               float* __restrict__ out_scores,     // (g_total, G, br)
               int G, int d_pad, int br, int n_blocks) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kMaxG x d_pad
  float* bs = qs + kMaxG * d_pad;               // kTileRows x kBStride

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int blk = min(max(grp_block[g], 0), n_blocks - 1);
  const size_t row0 = static_cast<size_t>(blk) * br;
  const int t1 = (br + kTileRows - 1) / kTileRows;

  // the group's query rows; rows past G are zero
  const float* qg = qvecs + static_cast<size_t>(g) * G * d_pad;
  for (int i = tid * 4; i < kMaxG * d_pad; i += kThreads * 4) {
    const float4 v = i / d_pad < G
                         ? __ldg(reinterpret_cast<const float4*>(qg + i))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + i) = v;
  }

  const int r_lo = tid % kRowHalf;
  const int q_lo = (tid / kRowHalf) * kQPerThread;
  for (int t = 0; t < t1; ++t) {
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
        if (q < G) {
          out_scores[(static_cast<size_t>(g) * G + q) * br + lane] = acc[i][j];
        }
      }
    }
  }
}

size_t smem_bytes(int d_pad) {
  return sizeof(float) * (static_cast<size_t>(kMaxG) * d_pad +
                          static_cast<size_t>(kTileRows) * kBStride);
}

template <typename T>
int launch(const void* qvecs, const void* data, const void* grp_block,
           void* out, int g_total, int G, int d_pad, int br, int n_blocks,
           void* stream) {
  const size_t smem = smem_bytes(d_pad);
  auto kernel = grouped_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_total > 0) {
    kernel<<<g_total, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qvecs), static_cast<const T*>(data),
        static_cast<const int*>(grp_block), static_cast<float*>(out), G,
        d_pad, br, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, and K4 on a window table, and K7 on an int8 block table.  dtype:
// 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Returns cudaError_t.
extern "C" int nlsh_grouped_scores(int dtype, const void* qvecs,
                                   const void* data, const void* grp_block,
                                   void* out, int g_total, int G, int d_pad,
                                   int br, int n_blocks, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(qvecs, data, grp_block, out, g_total, G, d_pad,
                           br, n_blocks, stream);
    case 1:
      return launch<__nv_bfloat16>(qvecs, data, grp_block, out, g_total, G,
                                   d_pad, br, n_blocks, stream);
    case 2:
      return launch<int8_t>(qvecs, data, grp_block, out, g_total, G, d_pad,
                            br, n_blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
