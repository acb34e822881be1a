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

// V values (1, 2 or 4; int32: 1 or 2) from p, V-element aligned: one load
// (bf16 as f32).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const int* p, int* v) {
  static_assert(V == 1 || V == 2, "int32 loads of 1 or 2 values");
  if constexpr (V == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  load_bf16<V>(p, v);
}

inline unsigned blocks_for(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace tcnn
