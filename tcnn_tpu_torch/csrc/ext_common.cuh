// Shared pieces of the externally indexed table kernels K10-K13 (PPNG1/2/3):
// the tables are flat [n_rows, F] with every level's rows at its own offset,
// and the caller hands each pick its global row as int32 (idx [B, C * NL],
// column c * NL + l for corner c of level l).
#pragma once

#include "common.cuh"

namespace tcnn {

// v rounded to bf16 and back, the rounding of a scattered contribution.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// F f32 values from p (16-byte aligned when F >= 4), as float4 loads where
// they fit.
template <int F>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = p[f];
  }
}

inline unsigned blocks_for(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace tcnn
