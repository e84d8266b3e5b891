// The pieces of a cp.async ring shared by the staged scoring kernels
// (grouped_topk.cu: K1, K3; grouped_scores.cu: K2, K4, K7): 16-byte
// asynchronous copies from global into shared memory (L2 only), their
// commit and wait, and the widening of 16 stored bytes of a corpus row
// to f32 as they are read out of shared memory.  Every widening is exact
// (a bf16 or an int8 value is a float), so the dots see the stored
// values themselves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nlsh {

// Four consecutive values of 16 stored bytes, widened to f32.  `s` picks
// values 4s .. 4s + 3.
template <typename T>
struct Widen;

template <>
struct Widen<float> {
  static constexpr int kN = 4;  // values per 16 bytes
  __device__ static void get4(const uint4& v, int, float out[4]) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void get4(const uint4& v, int s, float out[4]) {
    const unsigned a = s == 0 ? v.x : v.z;
    const unsigned b = s == 0 ? v.y : v.w;
    out[0] = __uint_as_float(a << 16);  // a bf16 is the top half of a float
    out[1] = __uint_as_float(a & 0xffff0000u);
    out[2] = __uint_as_float(b << 16);
    out[3] = __uint_as_float(b & 0xffff0000u);
  }
};

template <>
struct Widen<int8_t> {
  static constexpr int kN = 16;
  __device__ static void get4(const uint4& v, int s, float out[4]) {
    const unsigned w = s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
    out[0] = static_cast<float>(static_cast<int8_t>(w));
    out[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
    out[2] = static_cast<float>(static_cast<int8_t>(w >> 16));
    out[3] = static_cast<float>(static_cast<int8_t>(w >> 24));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace nlsh
