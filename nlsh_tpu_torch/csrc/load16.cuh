// 16 bytes of a corpus row, widened to f32: the loads of the scoring
// kernels for f32, bf16 and int8 layouts.  Every widening is exact (a
// bf16 or an int8 value is a float), so the dots that follow see the
// stored values themselves.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nlsh {

template <typename T>
struct Load16;

template <>
struct Load16<float> {
  static constexpr int kN = 4;
  __device__ static void run(const float* src, float* dst) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

template <>
struct Load16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void run(const __nv_bfloat16* src, float* dst) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load16<int8_t> {
  static constexpr int kN = 16;
  __device__ static void run(const int8_t* src, float* dst) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src));
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
  }
};

}  // namespace nlsh
