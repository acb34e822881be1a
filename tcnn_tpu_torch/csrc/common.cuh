// Shared helpers of the port's CUDA kernels: bf16 row loads/stores of F
// features and the error string of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcnn {

using bf16 = __nv_bfloat16;

// F bf16 values moved as one 2/4/8/16-byte access.
template <int F> struct BfVec;
template <> struct BfVec<1> { using T = unsigned short; };
template <> struct BfVec<2> { using T = unsigned int; };
template <> struct BfVec<4> { using T = uint2; };
template <> struct BfVec<8> { using T = uint4; };

template <int F>
__device__ __forceinline__ void load_bf16(const bf16* p, float* v) {
  union { typename BfVec<F>::T raw; unsigned short h[F]; } u;
  u.raw = *reinterpret_cast<const typename BfVec<F>::T*>(p);
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = __uint_as_float(((unsigned)u.h[f]) << 16);  // exact
}

template <int F>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
  union { typename BfVec<F>::T raw; unsigned short h[F]; } u;
#pragma unroll
  for (int f = 0; f < F; ++f) u.h[f] = __bfloat16_as_ushort(__float2bfloat16_rn(v[f]));
  *reinterpret_cast<typename BfVec<F>::T*>(p) = u.raw;
}

}  // namespace tcnn
