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
//       kernel on an int8 layout with one query panel for every block (a
//       query stride of 0 between groups; wrapper int8_block_scores, its
//       own count).
//
// Corpus rows are f32, bf16 or int8 (dtype 0, 1, 2), widened exactly to
// f32 as they are read out of shared memory (ring.cuh).
//
// What bounds it on the H100: a group multiplies its G <= 32 f32 query
// rows by one br-row corpus block, 2 * G = 64 flop per corpus element,
// and writes the whole (G, br) f32 panel.  Every pair is scored, so at
// the serving shapes the f32 operations (over the padded d_pad, which the
// kernel multiplies) take about as long as the bytes (each block once,
// the panels once); neighbouring groups share blocks (the prep sorts
// groups by block or window) and re-read them from the 50 MB L2.  So the
// FMA pipe has to be the limit: the loop must spend fewer shared-memory
// cycles than FMA cycles, and the copies and panel stores must run
// behind it.
//
// Design:
//   * A persistent grid of (resident blocks per SM) x (SMs) blocks of 4
//     warps walks the group table, g += gridDim.x, so the grid covers a
//     contiguous run of groups and groups that share a block run side by
//     side.  The grid, and the dynamic shared memory attribute, are set
//     once per device.
//   * Tile = 256 corpus rows x the group's 32 query slots.  Warp w owns
//     the 16 slots [16 (w & 1), + 16) and the 128 rows [128 (w >> 1), +
//     128) of every tile, each lane rows lane + 32 j (j < 4): a register
//     tile of 16 slots x 4 rows, 64 accumulators.  Per 4 features a warp
//     reads 4 distinct 16-byte row chunks (16 wavefronts; one for 16
//     features of int8) and 16 broadcast query float4s (16 wavefronts)
//     for 256 FMAs per lane: fewer shared-memory cycles than FMA
//     cycles.  A warp whose 16 slots all lie
//     at or beyond G, or whose rows lie past br (br % 256 == 128), skips
//     the loop and the stores (warp-uniform).  A group of at most 8
//     slots would idle the second slab's warps: its 4 warps multiply just
//     those 8 slots and split each tile's rows instead (2 rows per lane,
//     128 apart), so K7's G = 8 costs a quarter of a full group's FMAs,
//     spread over the 4 warps.
//   * A ring of kStages stages in shared memory, filled by cp.async:
//     stage = kStageBytes of each of the tile's rows, in the layout's own
//     type, rows padded by 16 bytes (so the 16-byte reads of 8
//     consecutive rows cover all 32 banks), and the same features of the
//     group's query rows (slots < G only).  Queries ride the ring, so the
//     footprint does not grow with d_pad, and the ring runs on across
//     groups: the next group's first stages (its block id read a group
//     ahead) land while this group's last stage is multiplied.
//   * A tile's scores are stored once its last stage is multiplied: for
//     a slot and j, the warp's lanes write 32 consecutive floats (128
//     bytes) per store, streaming (st.global.cs, the panel is not re-read
//     here), while the next stages' copies are in flight.
//   * Semantics kept: each (slot, row) is one fmaf chain from 0 over
//     features 0 .. d_pad - 1 in order, as in grouped_topk.cu, so K2's
//     panel equals K1's pre-scale scores bit for bit (and K4's K3's); no
//     tensor cores, hence no TF32.
//   * Shapes: br any multiple of 128, d_pad any multiple of 128; shared
//     memory per block 2 x (256 x 144 + 32 x 32 x 4) = 81,920 bytes for
//     f32 rows (bf16 90,112, int8 106,496), whatever br and d_pad.
//
// On an H100 80GB HBM3 (700 W): ptxas gives 145 registers for f32 rows,
// 253 for bf16 and 255 for int8, no spills, so shared memory sets 2
// resident blocks per SM.  Tried there and kept out for being no faster:
// 64-byte stages with 3 or 4 blocks per SM, 3 stages, 8 rows per lane
// (it spills), unrolling the 16-byte loop, ordering the FMAs feature by
// feature, and reading the next 16 bytes' rows ahead.  Where the time
// goes: python3 -m
// nlsh_tpu_torch.tools.panel_variants (the kernel without its copies,
// barriers, query reads or stores, and a register-only FMA probe).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "ring.cuh"

namespace {

using nlsh::cp_async16;
using nlsh::cp_async_commit;
using nlsh::cp_async_wait;
using nlsh::Widen;

constexpr int kThreads = 128;                  // 4 warps
constexpr int kMaxG = 32;                      // query slots per group
constexpr int kSlab = 16;                      // slots per warp
constexpr int kRowsPerLane = 4;                // rows lane + 32 j
constexpr int kNarrow = 8;                     // slots of a narrow group
constexpr int kWarpRows = 32 * kRowsPerLane;   // 128 rows per warp
constexpr int kTileRows = 2 * kWarpRows;       // 256 rows per tile
constexpr int kStageBytes = 128;               // bytes of a row per stage
constexpr int kChunks = kStageBytes / 16;      // 16-byte copies per row
constexpr int kRowStride = kStageBytes + 16;   // padded stage row (bytes)
constexpr int kStages = 2;                     // ring depth
constexpr int kMinBlocks = 2;                  // resident blocks per SM

static_assert(kThreads / 32 == 2 * (kMaxG / kSlab), "2 slabs x 2 row halves");

// Stage layout for corpus type T: the tile's rows, then the query slice
// (kMaxG rows of kFeat f32 features).
template <typename T>
struct Stage {
  static constexpr int kFeat = kStageBytes / static_cast<int>(sizeof(T));
  static constexpr int kQChunks = kFeat / 4;   // 16-byte copies per slot
  static constexpr int kRowsBytes = kTileRows * kRowStride;
  static constexpr int kBytes = kRowsBytes + kMaxG * kFeat * 4;
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
#pragma unroll
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

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
panel_kernel(const float* __restrict__ qvecs,    // group g at g * q_stride
             const T* __restrict__ data,         // (n_blocks * br, d_pad)
             const int* __restrict__ grp_block,  // (g_total,) block/window
             float* __restrict__ out,            // (g_total, G, br)
             int g_total, int G, int d_pad, int br, int n_blocks,
             int q_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Stage<T>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int l = tid % 32;
  // A group of at most kNarrow slots would leave the second slab's warps
  // idle: then all 4 warps take slots [0, kNarrow) and split each tile's
  // rows, warp w rows 32 w + l and 128 + 32 w + l ("narrow").
  const bool narrow = G <= kNarrow;
  const int q0 = narrow ? 0 : (warp & 1) * kSlab;  // the warp's first slot
  const int r0 = narrow ? 32 * warp : (warp >> 1) * kWarpRows;  // first row
  const int r_step = narrow ? kTileRows / 2 : 32;  // rows between its j
  const size_t row_bytes = static_cast<size_t>(d_pad) * sizeof(T);
  const int n_chunks = static_cast<int>(row_bytes / kStageBytes);
  const int n_tiles = (br + kTileRows - 1) / kTileRows;
  const int g_step = static_cast<int>(gridDim.x);
  const int g0 = static_cast<int>(blockIdx.x);
  const int n_stages =
      (g_total - g0 + g_step - 1) / g_step * n_tiles * n_chunks;
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(data);
  auto block_of = [&](int g) {
    return min(max(__ldg(grp_block + g), 0), n_blocks - 1);
  };

  // The copy cursor: group, tile and chunk of the next stage to copy,
  // its group's block and the next group's (read a group ahead).
  int ig = g0, it = 0, ic = 0;
  int iblk = block_of(g0);
  int inext = g0 + g_step < g_total ? block_of(g0 + g_step) : 0;
  auto copy_stage = [&](int s) {
    unsigned char* dst = smem + (s % kStages) * S::kBytes;
    const unsigned char* src =
        bytes + (static_cast<size_t>(iblk) * br + it * kTileRows) * row_bytes +
        static_cast<size_t>(ic) * kStageBytes;
    const int rows = min(kTileRows, br - it * kTileRows);
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int u = i % kChunks;
      cp_async16(dst + r * kRowStride + 16 * u, src + r * row_bytes + 16 * u);
    }
    const float* qsrc =
        qvecs + static_cast<size_t>(ig) * q_stride + ic * S::kFeat;
    float* qdst = reinterpret_cast<float*>(dst + S::kRowsBytes);
    for (int i = tid; i < G * S::kQChunks; i += kThreads) {
      const int q = i / S::kQChunks;
      const int u = i % S::kQChunks;
      cp_async16(qdst + q * S::kFeat + 4 * u,
                 qsrc + static_cast<size_t>(q) * d_pad + 4 * u);
    }
    if (++ic < n_chunks) return;
    ic = 0;
    if (++it < n_tiles) return;
    it = 0;
    ig += g_step;
    iblk = inext;
    if (ig + g_step < g_total) inext = block_of(ig + g_step);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) copy_stage(s);
    cp_async_commit();  // one group per stage, empty or not
  }

  float acc[kSlab][kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kSlab; ++i) {
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
  }
  int cg = g0, ct = 0, cc = 0;  // group, tile and chunk of stage s
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed (this thread's)
    __syncthreads();               // ... everyone's; stage s - 1 is free
    if (s + kStages - 1 < n_stages) copy_stage(s + kStages - 1);
    cp_async_commit();

    const int lane0 = ct * kTileRows + r0;  // the warp's first row
    if (q0 < G && lane0 < br) {
      const unsigned char* stage = smem + (s % kStages) * S::kBytes;
      const unsigned char* buf = stage + (r0 + l) * kRowStride;
      const float* qrow =
          reinterpret_cast<const float*>(stage + S::kRowsBytes) + q0 * S::kFeat;
      // rows per lane: a narrow warp's second row lies past a 128-row tail
      const int n_rows = !narrow ? kRowsPerLane : lane0 + r_step < br ? 2 : 1;
      if (!narrow) {
        stage_fma<T, kSlab, kRowsPerLane, 32>(buf, qrow, acc);
      } else if (n_rows == 2) {
        stage_fma<T, kNarrow, 2, kTileRows / 2>(buf, qrow, acc);
      } else {
        stage_fma<T, kNarrow, 1, kTileRows / 2>(buf, qrow, acc);
      }
      if (cc == n_chunks - 1) {
        // the tile's scores are complete: slot q0 + i, lane lane0 + l +
        // r_step j
        float* o = out + (static_cast<size_t>(cg) * G + q0) * br + lane0 + l;
#pragma unroll
        for (int i = 0; i < kSlab; ++i) {
          if (q0 + i < G) {
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
              if (j < n_rows) {
                __stcs(o + static_cast<size_t>(i) * br + r_step * j,
                       acc[i][j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
        }
      }
    }
    if (++cc == n_chunks) {
      cc = 0;
      if (++ct == n_tiles) {
        ct = 0;
        cg += g_step;
      }
    }
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
  auto kernel = panel_kernel<T>;
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

bool bad_shape(int G, int d_pad, int br) {
  return G < 1 || G > kMaxG || br <= 0 || br % 128 || d_pad <= 0 ||
         d_pad % 128;
}

template <typename T>
int launch(const void* qvecs, const void* data, const void* grp_block,
           void* out, int g_total, int G, int d_pad, int br, int n_blocks,
           int q_stride, void* stream) {
  if (bad_shape(G, d_pad, br) || n_blocks < 1 || q_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0, grid = 0;
  const int err = occupancy<T>(&per_sm, &grid);
  if (err != 0) return err;
  if (g_total > 0) {
    panel_kernel<T><<<min(g_total, grid), kThreads,
                      Stage<T>::kBytes * kStages,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qvecs), static_cast<const T*>(data),
        static_cast<const int*>(grp_block), static_cast<float*>(out),
        g_total, G, d_pad, br, n_blocks, q_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, and K4 on a window table, and K7 on an int8 block table.  dtype:
// 0 = float32, 1 = bfloat16, 2 = int8 corpus.  Group g's query rows are
// the G rows of d_pad floats at qvecs + g * q_stride (K2 and K4: G *
// d_pad; K7: 0, one panel for every block).  Returns cudaError_t.
extern "C" int nlsh_grouped_scores(int dtype, const void* qvecs,
                                   const void* data, const void* grp_block,
                                   void* out, int g_total, int G, int d_pad,
                                   int br, int n_blocks, int q_stride,
                                   void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(qvecs, data, grp_block, out, g_total, G, d_pad,
                           br, n_blocks, q_stride, stream);
    case 1:
      return launch<__nv_bfloat16>(qvecs, data, grp_block, out, g_total, G,
                                   d_pad, br, n_blocks, q_stride, stream);
    case 2:
      return launch<int8_t>(qvecs, data, grp_block, out, g_total, G, d_pad,
                            br, n_blocks, q_stride, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the raw-panel kernel for a corpus dtype (the
// same at every d_pad, a multiple of 128): its persistent grid is this
// times the SM count.  Returns cudaError_t.
extern "C" int nlsh_panel_blocks_per_sm(int dtype, int d_pad,
                                        int* blocks_per_sm) {
  if (bad_shape(1, d_pad, 128)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  switch (dtype) {
    case 0: return occupancy<float>(blocks_per_sm, &grid);
    case 1: return occupancy<__nv_bfloat16>(blocks_per_sm, &grid);
    case 2: return occupancy<int8_t>(blocks_per_sm, &grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
