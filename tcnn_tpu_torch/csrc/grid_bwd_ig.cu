// K7: multiresolution grid backward with input gradients (the table
// gradient and dL/dx in one pass).
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_bwd_ig_kernel (through
//   _bwd_ig_call and _ig_backward), which scatters the table gradient
//   through one-hot matmuls and, sharing those one-hots, picks each corner's
//   feature row to form dL/dx_d = sum over levels and corners of
//   (sum_f feat_f gy_f) * dW_c/dx_d.
// What bounds it on this card: K4's f32 atomics (2^D * F per (sample,
//   level)) plus a second random L2 read of every corner's bf16 feature row.
//   At the SDF config (D=3, L=12, F=2, 1,016,456 rows) and B=2^16 that is
//   12.6 M atomics into an 8.1 MB f32 gradient and 6.3 M 4-byte row reads
//   from a 4.1 MB table, both L2-resident. Counting each input and output
//   once (x, gy, the table, its gradient, dL/dx: ~17 MB) the bound is
//   ~5 us at 3.35 TB/s; the time is set by L2 atomics and gathers.
// What the design does about it: one thread per (sample, level), K4's
//   mapping, so the scatter is K4's (each contribution w_c * gy rounded to
//   bf16 as the TPU kernel rounds it, grid_kernel.py:884-894, then an f32
//   atomicAdd); the corner walk, weights and their x-derivatives come from
//   the shared grid_corners, so K1, K4 and K7 visit the same corners. The
//   sum over a sample's levels is deterministic: a block holds
//   blockDim / L whole samples, their levels in adjacent threads; each
//   thread leaves its level's dL/dx partial in shared memory and one thread
//   per (sample, dim) adds them in level order (sum_levels), the twin's
//   order. L = 12 does not divide 32, so warp shuffles would split samples
//   across warps; the block layout wastes 256 mod L threads instead (4 of
//   256 at L = 12).
#include "grid_common.cuh"

namespace tcnn {

template <int F>
__global__ void grid_bwd_ig_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
                                   float* __restrict__ gtable, float* __restrict__ gx, long B) {
  const int S = blockDim.x / g.L;
  const int s = threadIdx.x / g.L, l = threadIdx.x % g.L;
  const long b0 = (long)blockIdx.x * S;
  const long b = b0 + s;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if (s < S && b < B) {
    float v[F];
    load_bf16<F>(gy + b * gy_width + l * F, v);
    grid_level_bwd_ig<F>(g, b, l, v, gtable, part);
  }
  sum_levels(part, g.D, g.L, b0, B, gx);
}

template <int F>
static int launch_grid_bwd_ig(const GridArgs& g, const bf16* gy, int gy_width, float* gtable,
                              float* gx, long B, cudaStream_t stream) {
  const int threads = 256;
  const long per_block = threads / g.L;
  const long blocks = (B + per_block - 1) / per_block;
  grid_bwd_ig_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(g, gy, gy_width, gtable, gx, B);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

extern "C" int tcnn_grid_bwd_ig(const void* x, const void* gy, const void* table,
                                const void* level_i32, const void* level_f32, void* gtable,
                                void* gx, int B, int D, int F, int L, int interp, unsigned f0,
                                unsigned f1, unsigned f2, unsigned f3, int hash, int gy_width, int device,
                                void* stream) {
  using namespace tcnn;
  if (L < 1 || L > 256 || gy_width < L * F || interp == INTERP_NEAREST)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  const bf16* gyp = static_cast<const bf16*>(gy);
  float* gt = static_cast<float*>(gtable);
  float* gxp = static_cast<float*>(gx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_bwd_ig<1>(g, gyp, gy_width, gt, gxp, B, s);
    case 2: return launch_grid_bwd_ig<2>(g, gyp, gy_width, gt, gxp, B, s);
    case 4: return launch_grid_bwd_ig<4>(g, gyp, gy_width, gt, gxp, B, s);
    case 8: return launch_grid_bwd_ig<8>(g, gyp, gy_width, gt, gxp, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
