// K4: multiresolution grid backward (the table gradient).
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_bwd_kernel (through _bwd_call
//   and _grid_pallas_bwd), which scatters dL/dtable[row, f] += w_c * gy[b,
//   l*F + f] over every (sample, level, corner) through one-hot matmuls
//   accumulated across the sequential TPU grid.
// What bounds it on this card: f32 atomics. At config_hash (L=16, F=2,
//   B=2^18) it makes 2^18 * 16 * 4 * 2 = 33.5 M atomic adds into a 2.8 MB
//   f32 gradient that stays in L2, and reads 16.8 MB of bf16 cotangent. The
//   coarse dense levels are hot: level 0 has 17^2 rows for 2^18 samples, so
//   thousands of adds land on each of its rows, and those serialise in L2.
// What the design does about it: one thread per (sample, active level),
//   neighbouring threads on neighbouring cotangent columns (coalesced
//   reads); positions, weights and corner rows come from K1's own device
//   function (grid_common.cuh), so forward and backward agree on every corner;
//   each contribution is rounded to bf16 as the TPU kernel rounds it, then
//   added in f32 with atomicAdd (a fire-and-forget RED, no return value).
//   Levels past max_level are not visited. The wrapper zeroes the gradient;
//   the contention at the coarse levels is left for a later PR.
// Stochastic option: replaces grid_kernel.py:_bwd_stoch_kernel (through
//   _bwd_stoch_call), which scatters each (sample, level)'s whole cotangent
//   row, rounded to bf16, into one corner chosen by a uniform draw. Here the
//   same thread draws u in-kernel (grid_common.cuh:stoch_uniform), picks the
//   corner (grid_stoch_row) and makes F atomics instead of 2^D * F; all of a
//   sample's mass lands on one row, so the coarse levels stay as contended.
#include "grid_common.cuh"

namespace tcnn {

template <int F>
__global__ void grid_bwd_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
                                float* __restrict__ gtable, long B, int n_active) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * n_active) return;
  const long b = t / n_active;
  const int l = (int)(t % n_active);
  float v[F];
  load_bf16<F>(gy + b * gy_width + l * F, v);
  grid_level_bwd<F>(g, b, l, v, gtable);
}

template <int F>
static int launch_grid_bwd(const GridArgs& g, const bf16* gy, int gy_width, float* gtable, long B,
                           int n_active, cudaStream_t stream) {
  const int threads = 256;
  const long blocks = (B * n_active + threads - 1) / threads;
  grid_bwd_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(g, gy, gy_width, gtable, B,
                                                               n_active);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

extern "C" int tcnn_grid_bwd(const void* x, const void* gy, const void* level_i32,
                             const void* level_f32, void* gtable, int B, int D, int F, int L,
                             int n_active, int interp, unsigned f0, unsigned f1, unsigned f2,
                             unsigned f3, int hash, int stochastic, int gy_width, int device, void* stream) {
  using namespace tcnn;
  if (n_active > L || gy_width < L * F) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), nullptr, static_cast<const int*>(level_i32),
             static_cast<const float*>(level_f32), D, L, interp, {f0, f1, f2, f3}, hash, stochastic};
  const bf16* gyp = static_cast<const bf16*>(gy);
  float* gt = static_cast<float*>(gtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_bwd<1>(g, gyp, gy_width, gt, B, n_active, s);
    case 2: return launch_grid_bwd<2>(g, gyp, gy_width, gt, B, n_active, s);
    case 4: return launch_grid_bwd<4>(g, gyp, gy_width, gt, B, n_active, s);
    case 8: return launch_grid_bwd<8>(g, gyp, gy_width, gt, B, n_active, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
