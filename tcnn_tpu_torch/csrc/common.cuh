// Shared helpers of the port's CUDA kernels: bf16 row loads/stores of F
// features (and the f32 values of a row's raw bits), a raw row swapped
// between the lanes of a pair, a row's vector atomic add, and the
// fixed-order sum of per-block partials.
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
__device__ __forceinline__ void unpack_bf16(typename BfVec<F>::T raw, float* v) {
  union { typename BfVec<F>::T raw; unsigned short h[F]; } u;
  u.raw = raw;
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = __uint_as_float(((unsigned)u.h[f]) << 16);  // exact
}

template <int F>
__device__ __forceinline__ void load_bf16(const bf16* p, float* v) {
  unpack_bf16<F>(*reinterpret_cast<const typename BfVec<F>::T*>(p), v);
}

template <int F>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
  union { typename BfVec<F>::T raw; unsigned short h[F]; } u;
#pragma unroll
  for (int f = 0; f < F; ++f) u.h[f] = __bfloat16_as_ushort(__float2bfloat16_rn(v[f]));
  *reinterpret_cast<typename BfVec<F>::T*>(p) = u.raw;
}

// A raw row from lane ^ 1 of the warp (every lane of the warp calls it).
__device__ __forceinline__ unsigned short shfl_pair(unsigned short v) {
  return (unsigned short)__shfl_xor_sync(0xffffffffu, (unsigned)v, 1);
}
__device__ __forceinline__ unsigned shfl_pair(unsigned v) {
  return __shfl_xor_sync(0xffffffffu, v, 1);
}
__device__ __forceinline__ uint2 shfl_pair(uint2 v) {
  return make_uint2(shfl_pair(v.x), shfl_pair(v.y));
}
__device__ __forceinline__ uint4 shfl_pair(uint4 v) {
  return make_uint4(shfl_pair(v.x), shfl_pair(v.y), shfl_pair(v.z), shfl_pair(v.w));
}

// dst[0..F) += v[0..F) in global memory, one vector atomic per 2 or 4
// features: sm_90's float2 / float4 atomicAdd (F = 2, 4; F = 8 as two
// float4), a scalar one for F = 1. dst is F-float aligned.
template <int F>
__device__ __forceinline__ void atomic_add_row(float* dst, const float* v) {
  if constexpr (F == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
    }
  }
}

// out[j] = sum over blocks b = 0..n_blocks-1, in that order, of
// partials[b * stride + j], for j < n: the deterministic second pass of the
// persistent kernels (K4, K5, K6, K9), whose blocks each leave a partial.
// Eight loads are in flight a thread; the adds keep their order. A static
// template: only the sources that launch it instantiate it, each its own.
template <class T>
static __global__ void reduce_partials(const T* __restrict__ partials, int n_blocks, size_t stride,
                                size_t n, T* __restrict__ out) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (size_t)gridDim.x * blockDim.x) {
    T s = 0;
    int b = 0;
    for (; b + 8 <= n_blocks; b += 8) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = partials[(size_t)(b + k) * stride + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; b < n_blocks; ++b) s += partials[(size_t)b * stride + j];
    out[j] = s;
  }
}

// The persistent grid of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory a block (opted in here) over n_tiles tiles: the
// blocks resident at once, by occupancy, never more than the tiles. Returns
// -cudaError on failure and 0 when no block fits.
template <class Kernel>
static int resident_grid(Kernel kernel, int threads, size_t smem, int device, long n_tiles) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, n_sm = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  const long g = (long)per_sm * n_sm;
  return (int)(g < n_tiles ? g : n_tiles);
}

template <class T>
static int launch_reduce(const T* partials, int n_blocks, size_t stride, size_t n, T* out,
                         cudaStream_t stream) {
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  reduce_partials<T><<<(unsigned)(blocks < 1024 ? blocks : 1024), threads, 0, stream>>>(
      partials, n_blocks, stride, n, out);
  return (int)cudaGetLastError();
}

}  // namespace tcnn
