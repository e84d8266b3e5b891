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
//       alignment) instead of a block index; the TPU streamed it with
//       manual double-buffered DMA.
// One kernel does both: an event's first row is stride * index[ev], with
// stride = cap for K5 (block indices) and 1 for K6 (row offsets), clamped
// into [0, n_rows - cap] so that no row past the layout is read.
//
// What bounds it: each live lane is one corpus row, read once and dotted
// once: 2 flop per element, half a flop per f32 byte.  At the bench shape
// (160,000 events, cap 512, d_pad 128) the probed blocks total ~1 GB,
// twenty times the 50 MB L2, so the kernel streams HBM: up to 42 GB of
// f32 rows per 10,000-query pass (10.5 GB for int8).
//
// Design (a simple kernel that is right; not tuned): one thread block of
// 256 threads per event, the event's query row in shared memory.  A row's
// 16-byte chunks go to a group of 8, 16 or 32 lanes of one warp (chunks
// per row = d_pad / values per chunk, a multiple of 8), so a group's loads
// are coalesced; the chunks are widened to f32 (load16.cuh) and dotted
// with f32 FMAs on the CUDA cores (no tensor cores, hence no TF32: exact
// f32 like the reference's HIGHEST-precision dot), and the group's
// partial sums meet by xor shuffles.  Lanes at or past the event's count
// are written -inf without reading their rows: the reference reads and
// masks them, the answer is the same and those bytes are saved.  The FMA
// sequence of a lane depends only on the row and the query, so K5 and K6
// agree bitwise on the same events.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "load16.cuh"

namespace {

using nlsh::Load16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_kernel(const float* __restrict__ queries,  // (nq, d_pad)
              const T* __restrict__ data,         // (n_rows, d_pad)
              const int* __restrict__ index,      // (n_events,) block/start
              const int* __restrict__ counts,     // (n_events,)
              float* __restrict__ out,            // (n_events, cap)
              int n_probes, int cap, int stride, int d_pad, int n_rows) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // d_pad
  const int ev = blockIdx.x;
  const int tid = threadIdx.x;
  const int cnt = min(max(counts[ev], 0), cap);
  const long long first =
      min(max(static_cast<long long>(stride) * index[ev], 0LL),
          static_cast<long long>(n_rows - cap));
  float* o = out + static_cast<size_t>(ev) * cap;
  for (int l = cnt + tid; l < cap; l += kThreads) o[l] = -CUDART_INF_F;
  if (cnt == 0) return;  // the whole block: cnt is the event's

  const float* q = queries + static_cast<size_t>(ev / n_probes) * d_pad;
  for (int i = tid * 4; i < d_pad; i += kThreads * 4) {
    *reinterpret_cast<float4*>(qs + i) =
        __ldg(reinterpret_cast<const float4*>(q + i));
  }
  __syncthreads();

  constexpr int kN = Load16<T>::kN;
  const int chunks = d_pad / kN;  // 16-byte chunks per row
  const int group = chunks % 32 == 0 ? 32 : (chunks % 16 == 0 ? 16 : 8);
  const int rows_per_step = 32 / group;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / group;  // the warp's row this step
  const int sl = lane % group;   // the lane's first chunk of it
  // r0 is the same for the whole warp, so every lane reaches the shuffles
  for (int r0 = warp * rows_per_step; r0 < cnt;
       r0 += kWarps * rows_per_step) {
    const int r = r0 + sub;
    float acc = 0.f;
    if (r < cnt) {
      const T* row = data + (static_cast<size_t>(first) + r) * d_pad;
      for (int c = sl; c < chunks; c += group) {
        float v[kN];
        Load16<T>::run(row + c * kN, v);
        const float* qc = qs + c * kN;
#pragma unroll
        for (int j = 0; j < kN; ++j) acc = fmaf(qc[j], v[j], acc);
      }
    }
    for (int off = group / 2; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (sl == 0 && r < cnt) o[r] = acc;
  }
}

template <typename T>
int launch(const void* queries, const void* data, const void* index,
           const void* counts, void* out, int n_events, int n_probes,
           int cap, int stride, int d_pad, int n_rows, void* stream) {
  if (n_events > 0) {
    bucket_kernel<T><<<n_events, kThreads, sizeof(float) * d_pad,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const T*>(data),
        static_cast<const int*>(index), static_cast<const int*>(counts),
        static_cast<float*>(out), n_probes, cap, stride, d_pad, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 (stride = cap, index = block ids) and K6 (stride = 1, index = row
// offsets).  dtype: 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Returns
// cudaError_t.
extern "C" int nlsh_bucket_scores(int dtype, const void* queries,
                                  const void* data, const void* index,
                                  const void* counts, void* out,
                                  int n_events, int n_probes, int cap,
                                  int stride, int d_pad, int n_rows,
                                  void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(queries, data, index, counts, out, n_events,
                           n_probes, cap, stride, d_pad, n_rows, stream);
    case 1:
      return launch<__nv_bfloat16>(queries, data, index, counts, out,
                                   n_events, n_probes, cap, stride, d_pad,
                                   n_rows, stream);
    case 2:
      return launch<int8_t>(queries, data, index, counts, out, n_events,
                            n_probes, cap, stride, d_pad, n_rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
