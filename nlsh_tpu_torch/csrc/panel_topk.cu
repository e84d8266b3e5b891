// Per-slot top-k of raw score panels for Hopper: kernel K8.
//
// Replaces no Pallas kernel.  The JAX package's wide-k branch after the
// raw panels (K2 _grouped_scores_v3, K4 _windowed_scores) is plain
// jax.lax.top_k over the scaled, biased and masked panel
// (nlsh_tpu/index/serving.py); the port did the same with a mask, a
// torch.where copy and a stable torch.sort of every whole panel row.  K8
// is that step in one pass: for slot (g, s) of a (g_total, G, br) f32
// panel it computes
//   x = scores[g, s, lane] * scale[row] - norms[row]   (each optional,
//       __fmul_rn then __fsub_rn, as the plain version rounds them;
//       row = grp_block[g] * br + lane)
// on the live lanes [lo, hi) (lo = grp_lo[g, s] or 0, hi = grp_hi[g, s],
// clamped to [0, br]; every other lane is -inf), and writes the top kk
// of the br lanes, descending, the lowest lane first among equal values:
// the stable descending sort's order, so bit for bit the plain version
// (query_kernel.panel_topk_plain).  -0.0 and +0.0 compare equal and
// order by lane, and each keeps its sign; -inf values order by lane
// whether masked or computed.  A NaN sorts first, as in torch.sort, but
// is written as one canonical NaN.
//
// What bounds it on the H100: the bytes.  It reads each live slot's live
// lanes once (and their scales and norms), writes kk (score, lane) pairs
// of every slot, and reads nothing of a dead slot (hi <= lo).  At the
// single table's k = 100 serve (9,096 groups x 32 slots x 512 lanes, about
// 160,000 live slots of 292 live lanes) that is about 0.19 GB read and
// 0.23 GB written, 0.125 ms at 3.35 TB/s.  The selection itself has to
// stay off the critical path: a few shared-memory passes per slot, no
// sort of anything but the kk winners.
//
// Design:
//   * One warp per slot, 8 slots a block, no block-wide barrier: each
//     warp walks the slots slot += 8 x gridDim.x on its own.  A lane reads
//     the slot's live lanes lo + l + 32 j (j < 16), 128 contiguous bytes a
//     warp per j, all 16 loads issued before the first is used, applies
//     the scale and the norms in registers and keeps each value's key:
//     the float's bits turned into an unsigned integer that orders as the
//     float does (-0.0 taken as +0.0, NaN highest, -inf none).  A slot of
//     at most 512 live lanes (every slot at br 512) keeps its keys in
//     registers; a wider one reads its row again per pass (from L1/L2).
//   * Radix select of the kk-th key: the bits that every candidate's key
//     shares (the common prefix of the warp's largest and smallest key)
//     need no pass; then 8 bits a pass, a 256-bin histogram per warp in
//     shared memory filled by atomics, and a warp-wide scan of the bins
//     finds the bin of the kk-th key.  The search stops once a whole bin
//     is taken (2.3 passes a live slot at the k = 100 serve).  A slot
//     with at most kk candidates skips it.  The result is a threshold T:
//     every key above it wins, and of the keys equal to it the lowest
//     lanes win, as many as are still needed.
//   * The winners are compacted by ballot into (key, lane) pairs, the
//     64-bit value key << 32 | (br - 1 - lane) << 1 | sign of zero,
//     distinct for every lane, so sorting them descending gives the
//     stable sort's order with no tie rule.  Up to kk = 256 a bitonic
//     network sorts them in registers (kE = 1, 2, 4 or 8 pairs a lane, the
//     pairs of a lane adjacent, so the first steps need no shuffle; the
//     variant whose comparators all put the larger first); above it they
//     are sorted in place in the slot's two output rows, so any kk <= br
//     runs without scratch.
//   * Below kk winners (a short or dead slot) the rest of the row is -inf
//     at the lowest lanes that hold no winner: [0, lo) then [hi, br),
//     written directly, or found by ballot where a live score is -inf.
//   * Capturable in a CUDA graph: static shared memory (at most 25.6 KB a
//     block), no allocation, no host read; the launch returns
//     cudaGetLastError.
//
// On an H100 80GB HBM3 (700 W), at the k = 100 serve's table (kk 100,
// kE = 4): 80 registers, 0.79 ms against the plain version's 8.8 ms and
// the bound's 0.126 ms.  Of it, writing the outputs alone takes 0.17 ms,
// the reads 0.17 ms more, the sort 0.23 ms and the select and compaction
// the rest.  Tried there and kept out: copying the next slot's row into
// shared memory with cp.async while the current one is selected (slower),
// warp-aggregated histogram atomics (__match_any_sync; slower), fewer
// registers (launch bounds of 5 or 6 blocks: spills, slower), and a
// shared-memory sort (0.38 ms for the sort).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // slots per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 16;           // keys a lane keeps in registers
constexpr int kSpan = 32 * kPer;   // live lanes a slot keeps in registers
constexpr int kBins = 256;         // an 8-bit digit a pass
constexpr int kBinsPerLane = kBins / 32;
constexpr int kHist = kBins + kBins / kBinsPerLane;  // with a pad word each 8
constexpr int kMaxE = 8;           // widest register sort: 8 x 32 = 256
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0u;     // the key of no candidate (-inf)
constexpr uint32_t kSign = 0x80000000u;

// A score's key: unsigned, ordered as the float is, -0.0 as +0.0, NaN
// above everything (torch.sort's order), kNone for -inf.  Every other
// value's key exceeds 0x007fffff, the key -inf would have.
__device__ __forceinline__ uint32_t key_of(float x) {
  uint32_t b = __float_as_uint(x);
  b = b == kSign ? 0u : b;
  uint32_t k = (b & kSign) ? ~b : (b | kSign);
  k = k == 0x007fffffu ? kNone : k;
  return x != x ? 0xffffffffu : k;
}

// Where bin d sits in a warp's histogram: by rank r = 255 - d (the bins
// in descending order), a pad word after every 8, so lane l's reads of
// ranks 8 l .. 8 l + 7 (words 9 l + i) fall in 32 distinct banks.
__device__ __forceinline__ int hist_word(int d) {
  const int r = kBins - 1 - d;
  return r + r / kBinsPerLane;
}

// The score of a winner from its key and its low word (bit 0: -0.0).
__device__ __forceinline__ float score_of(uint32_t k, uint32_t low) {
  if (low & 1u) return -0.0f;
  return __uint_as_float((k & kSign) ? (k ^ kSign) : ~k);
}

// One slot's row of the panel and its block's scales and norms.
struct Row {
  const float* s;
  const float* scl;
  const float* nrm;

  __device__ __forceinline__ float at(int lane) const {
    float x = __ldg(s + lane);
    if (scl != nullptr) x = __fmul_rn(x, __ldg(scl + lane));
    if (nrm != nullptr) x = __fsub_rn(x, __ldg(nrm + lane));
    return x;
  }
};

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const uint32_t hi = __shfl_xor_sync(kFull, static_cast<uint32_t>(v >> 32), m);
  const uint32_t lo = __shfl_xor_sync(kFull, static_cast<uint32_t>(v), m);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// One step of the register sort within a lane: entries r and r ^ M,
// the larger first.
template <int kE, int M>
__device__ __forceinline__ void step_in_lane(uint64_t (&v)[kE]) {
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    if ((r ^ M) > r && (r ^ M) < kE) {
      const uint64_t a = v[r], b = v[r ^ M];
      v[r] = a > b ? a : b;
      v[r ^ M] = a > b ? b : a;
    }
  }
}

// One step of the register sort across lanes: entry e = kE l + r meets
// e ^ m (m >= kE), the lower index keeping the larger.  A mirror step
// (m = size - 1) meets entry r ^ (kE - 1) of the other lane.
template <int kE, bool kMirror>
__device__ __forceinline__ void step_across(uint64_t (&v)[kE], int m, int l) {
  const int lm = m / kE;
  const bool lower = (l ^ lm) > l;
  uint64_t other[kE];
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    other[r] = shfl_xor64(v[kMirror ? r ^ (kE - 1) : r], lm);
  }
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const bool big = other[r] > v[r];
    v[r] = big == lower ? other[r] : v[r];
  }
}

// Sorts the warp's 32 kE entries (entry kE l + r in lane l's v[r])
// descending, over blocks of `size_max` (a power of two): the bitonic
// network whose comparators all put the larger first (each size's first
// step compares mirrored entries, then half-cleaners).
template <int kE>
__device__ __forceinline__ void sort_warp(uint64_t (&v)[kE], int size_max,
                                          int l) {
  for (int size = 2; size <= size_max; size <<= 1) {
    const int m = size - 1;
    if (m < kE) {
      if (m == 1) step_in_lane<kE, 1>(v);
      if (m == 3) step_in_lane<kE, 3>(v);
      if (m == 7) step_in_lane<kE, 7>(v);
    } else {
      step_across<kE, true>(v, m, l);
    }
    for (int h = size / 4; h >= 1; h >>= 1) {
      if (h < kE) {
        if (h == 1) step_in_lane<kE, 1>(v);
        if (h == 2) step_in_lane<kE, 2>(v);
        if (h == 4) step_in_lane<kE, 4>(v);
      } else {
        step_across<kE, false>(v, h, l);
      }
    }
  }
}

// kE > 0: the winners (at most 32 kE) are sorted in registers; kE = 0:
// in place in the slot's output rows (kk above 32 kMaxE).
template <int kE>
__global__ void __launch_bounds__(kThreads)
wide_topk_select(const float* __restrict__ scores,
                 const int* __restrict__ grp_block,
                 const int* __restrict__ grp_lo,
                 const int* __restrict__ grp_hi,
                 const float* __restrict__ norms,
                 const float* __restrict__ scale, float* out_scores,
                 int* out_lanes, long long n_slots, int G, int br,
                 int n_blocks, int kk) {
  __shared__ uint32_t hist_s[kWarps][kHist];
  __shared__ uint64_t pair_s[kWarps][kE > 0 ? 32 * kE : 1];
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int l = static_cast<int>(threadIdx.x) % 32;
  const unsigned below = (1u << l) - 1u;  // the lanes before this one
  uint32_t* hist = hist_s[warp];

  for (long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
       slot < n_slots; slot += static_cast<long long>(gridDim.x) * kWarps) {
    int hi = min(max(__ldg(grp_hi + slot), 0), br);
    int lo = grp_lo != nullptr ? min(max(__ldg(grp_lo + slot), 0), br) : 0;
    if (hi <= lo) lo = hi = 0;
    const int n_live = hi - lo;
    Row row{scores + slot * br, nullptr, nullptr};
    if (n_live > 0 && (scale != nullptr || norms != nullptr)) {
      const long long g = slot / G;
      const size_t row0 =
          static_cast<size_t>(min(max(__ldg(grp_block + g), 0), n_blocks - 1))
          * br;
      if (scale != nullptr) row.scl = scale + row0;
      if (norms != nullptr) row.nrm = norms + row0;
    }
    float* o_s = out_scores + slot * kk;
    int* o_l = out_lanes + slot * kk;

    // keys of the lanes c0 + 32 j + l below hi, and which were -0.0;
    // every load is issued before the first is used.  The lane's count of
    // candidates and their key range accumulate over the loads.
    uint32_t key[kPer];
    uint32_t negz = 0u;
    int n_mine = 0;
    uint32_t kmax = 0u, kmin = ~0u;
    auto load = [&](int c0) {
      float x[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int lane = c0 + 32 * j + l;
        x[j] = lane < hi ? __ldg(row.s + lane) : 0.f;
      }
      if (row.scl != nullptr) {
        float t[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int lane = c0 + 32 * j + l;
          t[j] = lane < hi ? __ldg(row.scl + lane) : 1.f;
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) x[j] = __fmul_rn(x[j], t[j]);
      }
      if (row.nrm != nullptr) {
        float t[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int lane = c0 + 32 * j + l;
          t[j] = lane < hi ? __ldg(row.nrm + lane) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) x[j] = __fsub_rn(x[j], t[j]);
      }
      negz = 0u;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool live = c0 + 32 * j + l < hi;
        const uint32_t k = live ? key_of(x[j]) : kNone;
        key[j] = k;
        negz |= static_cast<uint32_t>(live && __float_as_uint(x[j]) == kSign)
                << j;
        if (k != kNone) {
          ++n_mine;
          kmax = max(kmax, k);
          kmin = min(kmin, k);
        }
      }
    };
    const bool cached = n_live <= kSpan;
    if (cached) load(lo);

    // winners: keys above T, then the first need_eq lanes whose key is T
    // (T = 0, need_eq = 0: every candidate wins)
    uint32_t T = 0u;
    int need_eq = 0;
    if (n_live > kk) {
      // the candidates' count and key range: the bits every candidate
      // shares need no pass
      if (!cached) {
        for (int c0 = lo; c0 < hi; c0 += kSpan) load(c0);
      }
      const int n_valid = static_cast<int>(
          __reduce_add_sync(kFull, static_cast<unsigned>(n_mine)));
      kmax = __reduce_max_sync(kFull, kmax);
      kmin = __reduce_min_sync(kFull, kmin);
      const int common = __clz(kmax ^ kmin);  // 32 where all are equal
      if (n_valid > kk && common == 32) {
        T = kmax;
        need_eq = kk;
      } else if (n_valid > kk) {
        uint32_t pmask = common > 0 ? ~0u << (32 - common) : 0u;
        uint32_t prefix = kmax & pmask;
        int need = kk;  // winners still to find among keys under the prefix
        for (int shift = max(24 - common, 0);; shift = max(shift - 8, 0)) {
#pragma unroll
          for (int b = l; b < kHist; b += 32) hist[b] = 0u;
          __syncwarp();
          for (int c0 = lo; c0 < hi; c0 += kSpan) {
            if (!cached) load(c0);
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              if (c0 + 32 * j < hi) {  // warp-uniform
                const uint32_t k = key[j];
                if (k != kNone && (k & pmask) == prefix) {
                  atomicAdd(hist + hist_word(static_cast<int>((k >> shift) &
                                                              0xffu)),
                            1u);
                }
              }
            }
          }
          __syncwarp();
          // lane l holds bins 255 - 8 l - i (i < 8): the bins in
          // descending order across the warp
          int c[kBinsPerLane];
          int sum = 0;
#pragma unroll
          for (int i = 0; i < kBinsPerLane; ++i) {
            c[i] = static_cast<int>(hist[(kBinsPerLane + 1) * l + i]);
            sum += c[i];
          }
          int incl = sum;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, o);
            if (l >= o) incl += t;
          }
          __syncwarp();  // every lane has read the bins
          const int excl = incl - sum;
          const int src =
              __ffs(__ballot_sync(kFull, excl < need && need <= incl)) - 1;
          int bin = 0, above = 0, cnt = 0;
          if (l == src) {
            int cum = excl;
#pragma unroll
            for (int i = 0; i < kBinsPerLane; ++i) {
              if (cnt == 0 && cum + c[i] >= need) {
                bin = kBins - 1 - kBinsPerLane * l - i;
                above = cum;
                cnt = c[i];
              }
              cum += c[i];
            }
          }
          bin = __shfl_sync(kFull, bin, src);
          above = __shfl_sync(kFull, above, src);
          cnt = __shfl_sync(kFull, cnt, src);
          need -= above;
          prefix |= static_cast<uint32_t>(bin) << shift;
          pmask |= 0xffu << shift;
          if (cnt == need) {  // the whole bin wins: every key >= prefix
            T = prefix != 0u ? prefix - 1u : 0u;
            break;
          }
          if (shift == 0) {
            T = prefix;
            need_eq = need;
            break;
          }
        }
      }
    }

    // the winners as 64-bit pairs key << 32 | low, in this warp's shared
    // memory, or split over the slot's two output rows (kE = 0)
    uint64_t* pairs = pair_s[warp];
    uint32_t* out_key = reinterpret_cast<uint32_t*>(o_s);
    uint32_t* out_low = reinterpret_cast<uint32_t*>(o_l);
    auto get = [&](int i) -> uint64_t {
      if constexpr (kE > 0) {
        return pairs[i];
      } else {
        return static_cast<uint64_t>(out_key[i]) << 32 | out_low[i];
      }
    };
    auto put = [&](int i, uint64_t v) {
      if constexpr (kE > 0) {
        pairs[i] = v;
      } else {
        out_key[i] = static_cast<uint32_t>(v >> 32);
        out_low[i] = static_cast<uint32_t>(v);
      }
    };

    // compact the winners in lane order
    int n_win = 0, eq_seen = 0;
    for (int c0 = lo; c0 < hi; c0 += kSpan) {
      if (!cached) load(c0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (c0 + 32 * j < hi) {  // warp-uniform
          const uint32_t k = key[j];
          bool win = k > T;
          if (need_eq > 0) {  // warp-uniform
            const bool eq = k == T;
            const unsigned eqs = __ballot_sync(kFull, eq);
            win = win || (eq && eq_seen + __popc(eqs & below) < need_eq);
            eq_seen += __popc(eqs);
          }
          const unsigned wins = __ballot_sync(kFull, win);
          if (win) {
            const int p = n_win + __popc(wins & below);
            const int lane = c0 + 32 * j + l;
            put(p, static_cast<uint64_t>(k) << 32 |
                       static_cast<uint32_t>(br - 1 - lane) << 1 |
                       ((negz >> j) & 1u));
          }
          n_win += __popc(wins);
        }
      }
    }
    __syncwarp();

    // sort the n_win pairs descending: distinct, so the order is the
    // stable sort's; the empty entries (0) are the smallest
    int size_max = 1;
    while (size_max < n_win) size_max <<= 1;
    if constexpr (kE > 0) {
      if (n_win > 1) {
        uint64_t v[kE];
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          const int e = kE * l + r;
          v[r] = e < n_win ? pairs[e] : 0u;
        }
        sort_warp<kE>(v, size_max, l);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          const int e = kE * l + r;
          if (e < n_win) pairs[e] = v[r];
        }
        __syncwarp();
      }
    } else {
      // in the output rows: comparators past n_win are skipped, since
      // every comparator puts the larger first
      for (int size = 2; size <= size_max; size <<= 1) {
        for (int h = size / 2; h >= 1; h /= 2) {
          for (int t = l; t < size_max / 2; t += 32) {
            const int off = t & (h - 1);
            const int i = 2 * (t - off) + off;
            const int j = h == size / 2 ? 2 * (t - off) + size - 1 - off
                                        : i + h;
            if (j < n_win) {
              const uint64_t a = get(i), b = get(j);
              if (b > a) {
                put(i, b);
                put(j, a);
              }
            }
          }
          __syncwarp();
        }
      }
    }
    for (int i = l; i < n_win; i += 32) {
      const uint64_t v = get(i);
      const uint32_t low = static_cast<uint32_t>(v);
      o_s[i] = score_of(static_cast<uint32_t>(v >> 32), low);
      o_l[i] = br - 1 - static_cast<int>(low >> 1);
    }

    // the rest: -inf at the lowest lanes that hold no winner, [0, lo) then
    // [hi, br) where every live lane won; else found by ballot (a live
    // lane with a -inf score)
    if (n_win < kk && n_win == n_live) {
      for (int p = n_win + l; p < kk; p += 32) {
        const int i = p - n_win;
        o_s[p] = -CUDART_INF_F;
        o_l[p] = i < lo ? i : hi + i - lo;
      }
    } else if (n_win < kk) {
      int pos = n_win;
      for (int c0 = 0; pos < kk && c0 < br; c0 += 32) {
        const int lane = c0 + l;
        const bool won =
            lane >= lo && lane < hi && key_of(row.at(lane)) != kNone;
        const bool take = lane < br && !won;
        const unsigned takes = __ballot_sync(kFull, take);
        const int p = pos + __popc(takes & below);
        if (take && p < kk) {
          o_s[p] = -CUDART_INF_F;
          o_l[p] = lane;
        }
        pos += __popc(takes);
      }
    }
    __syncwarp();  // the next slot reuses this warp's shared memory
  }
}

template <int kE>
void launch_e(unsigned grid, cudaStream_t stream, const float* scores,
              const int* grp_block, const int* grp_lo, const int* grp_hi,
              const float* norms, const float* scale, float* out_scores,
              int* out_lanes, long long n_slots, int G, int br, int n_blocks,
              int kk) {
  wide_topk_select<kE><<<grid, kThreads, 0, stream>>>(
      scores, grp_block, grp_lo, grp_hi, norms, scale, out_scores, out_lanes,
      n_slots, G, br, n_blocks, kk);
}

}  // namespace

// K8: scores (g_total, G, br) f32; grp_block (g_total,) i32 block (window)
// ids, read only for scale or norms; grp_lo (g_total, G) i32 or null
// (lanes from 0); grp_hi (g_total, G) i32; norms, scale (n_blocks * br,)
// f32 or null; out_scores (g_total * G, kk) f32, out_lanes i32; kk in
// [1, br].  Returns cudaError_t.
extern "C" int nlsh_panel_topk(const void* scores, const void* grp_block,
                               const void* grp_lo, const void* grp_hi,
                               const void* norms, const void* scale,
                               void* out_scores, void* out_lanes, int g_total,
                               int G, int br, int n_blocks, int kk,
                               void* stream) {
  if (g_total < 0 || G < 1 || br < 1 || n_blocks < 1 || kk < 1 || kk > br) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_slots = static_cast<long long>(g_total) * G;
  if (n_slots > 0) {
    const long long blocks = (n_slots + kWarps - 1) / kWarps;
    const unsigned grid = static_cast<unsigned>(
        blocks < (1LL << 30) ? blocks : (1LL << 30));
    auto run = kk <= 32 ? launch_e<1>
             : kk <= 64 ? launch_e<2>
             : kk <= 128 ? launch_e<4>
             : kk <= 32 * kMaxE ? launch_e<kMaxE>
                                : launch_e<0>;
    run(grid, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(scores), static_cast<const int*>(grp_block),
        static_cast<const int*>(grp_lo), static_cast<const int*>(grp_hi),
        static_cast<const float*>(norms), static_cast<const float*>(scale),
        static_cast<float*>(out_scores), static_cast<int*>(out_lanes),
        n_slots, G, br, n_blocks, kk);
  }
  return static_cast<int>(cudaGetLastError());
}
