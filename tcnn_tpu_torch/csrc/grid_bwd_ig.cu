// K7: multiresolution grid backward with input gradients (the table
// gradient and dL/dx in one pass).
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_bwd_ig_kernel (through
//   _bwd_ig_call and _ig_backward), which scatters the table gradient
//   through one-hot matmuls and, sharing those one-hots, picks each corner's
//   feature row to form dL/dx_d = sum over levels and corners of
//   (sum_f feat_f gy_f) * dW_c/dx_d.
// What bounds it on this card: its table-gradient atomics and the hot rows
//   of the dense levels, not bytes. At the SDF config (D=3, L=12, F=2,
//   1,016,456 rows) and B=2^18 the scatter makes 25.2 M contributions of F
//   floats into an 8.1 MB f32 gradient that stays in L2, levels 0-2 taking
//   4,096 / 1,214 / 360 adds a row; the dot product reads 25.2 M 4-byte rows
//   of a 4.1 MB table. Counting each input and output once the bound is
//   0.0105 ms at 3.35 TB/s. The first-slice K7 (one thread a (sample,
//   level), F scalar f32 atomics a corner, lanes mixing levels) took 0.99
//   device ms there, 0.18 without its atomics; this one takes 0.347, 0.121
//   without its atomics, 0.315 without its row loads, 0.394 with its rows
//   spread, and 0.0054 device ms at the eikonal term's 1024 points (0.0075
//   before); `index_add_` of the same contributions takes 0.60 (H100 80GB
//   HBM3, 700.00 W; PERF.md, scripts/time_ig_kernels.py,
//   ablate_ig_kernels.py).
// What the design does about it: K1's lane pairs, and vector atomics.
//   - Lanes 2i and 2i + 1 take levels l0, l0 + 1 of one sample
//     (grid_common.cuh:pair_levels), every lane of a warp the same two
//     levels for 16 samples (pair_tiles), so an odd L only idles the last
//     pair's second lane. The lane with x bit k loads corners 2j + k of
//     both levels, so an x-pair of corners goes out in one load
//     instruction, and the lanes swap rows (pair_swap) so that each sums
//     its own level's 2^D corners in the twin's order: dL/dx is the twin's
//     bit for bit.
//   - The same lane adds the contributions of the corners it loaded: one
//     vector atomic a corner (common.cuh:atomic_add_row, a float2 RED at
//     F = 2) in place of F scalar ones, the two rows of an x-pair in one
//     instruction (spreading the rows over 2^16 others made it slower:
//     the pairs share sectors, and the hot rows cost less). Every level
//     adds globally: K4's private levels in shared memory (shared f32
//     atomics are CAS loops on sm_90) were slower at 2^16 and 2^17 and
//     within the run-to-run spread at 2^18, where no path launches K7.
//   - Each contribution is rounded to bf16 as the TPU kernel rounds it
//     (grid_kernel.py:884-894), then added in f32.
//   dL/dx is summed over a sample's levels in level order in shared memory
//   (sum_level_parts), deterministic and in the twin's order.
#include "grid_common.cuh"

namespace tcnn {

template <int F, int D>
__global__ void __launch_bounds__(kPairMaxThreads)
    grid_bwd_ig_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
        float* __restrict__ gtable, float* __restrict__ gx, long B, int groups, long n_tiles) {
  using Raw = typename BfVec<F>::T;
  constexpr int H = 1 << (D - 1);
  extern __shared__ __align__(16) float smem[];
  const int xbit = threadIdx.x & 1;
  auto task = [&](long b, int l0, float* part) {
    PairLevels<D> p;
    pair_levels<D>(g, b, l0, b < B, p);
    float gv[2][F];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int f = 0; f < F; ++f) gv[q][f] = 0.f;
      if (p.active[q]) load_bf16<F>(gy + b * gy_width + (l0 + q) * F, gv[q]);
    }
    unsigned row[2][H];
    Raw mine[2][H], theirs[H];
    pair_rows<D>(g, p, row);
    pair_loads<F, D>(g.table, p, row, mine);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!p.active[q]) continue;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float cw = corner_weight<D>(p.w[q], 2 * j + xbit);
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f)
          v[f] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gv[q][f])));
        atomic_add_row<F>(gtable + (size_t)row[q][j] * F, v);
      }
    }
    pair_swap<F, D>(mine, theirs);
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] = 0.f;
    if (!(xbit ? p.active[1] : p.active[0])) return;
    float go[F], w[D], dv[D];
#pragma unroll
    for (int f = 0; f < F; ++f) go[f] = xbit ? gv[1][f] : gv[0][f];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      w[d] = xbit ? p.w[1][d] : p.w[0][d];
      dv[d] = xbit ? p.deriv[1][d] : p.deriv[0][d];
    }
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const CornerDerivs k = corner_derivs<D>(w, dv, dv, c);
      float v[F];
      own_corner<F, D>(mine, theirs, c, v);
      float dot = __fmul_rn(v[0], go[0]);
#pragma unroll
      for (int f = 1; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(v[f], go[f]));
#pragma unroll
      for (int d = 0; d < D; ++d) part[d] = __fadd_rn(part[d], __fmul_rn(dot, k.dw(d)));
    }
  };
  pair_tiles<D>(g, smem, B, groups, gx, n_tiles, task, [](long) {});
}

}  // namespace tcnn

// The grid of tcnn_grid_bwd_ig over B samples at `groups` sample groups and
// `warps` warps a block (ops/cuda/grid_kernel.py:ig_layout): the resident
// blocks, never more than the tiles (> 0; 0 when no block fits;
// -cudaError).
extern "C" int tcnn_grid_bwd_ig_grid(int B, int D, int F, int L, int groups, int warps,
                                     int device) {
  using namespace tcnn;
  if (groups < 1 || warps < 1 || warps > 32) return -(int)cudaErrorInvalidValue;
  return with_f_d(F, D, -(int)cudaErrorInvalidValue, [&](auto f, auto d) {
    return resident_grid(grid_bwd_ig_kernel<decltype(f)::value, decltype(d)::value>, warps * 32,
                         pair_smem(groups, L, D), device, pair_n_tiles(B, groups));
  });
}

// `grid` blocks, as tcnn_grid_bwd_ig_grid gave them; gy_width a multiple
// of F (the wrapper cuts a wider cotangent to its L F columns).
extern "C" int tcnn_grid_bwd_ig(const void* x, const void* gy, const void* table,
                                const void* level_i32, const void* level_f32, void* gtable,
                                void* gx, int B, int D, int F, int L, int interp, unsigned f0,
                                unsigned f1, unsigned f2, unsigned f3, int hash, int gy_width,
                                int groups, int warps, int grid, int device, void* stream) {
  using namespace tcnn;
  if (L < 1 || L > 256 || gy_width < L * F || gy_width % F != 0 || interp == INTERP_NEAREST ||
      groups < 1 || warps < 1 || warps > 32 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  return with_f_d(F, D, (int)cudaErrorInvalidValue, [&](auto f, auto d) {
    const auto kernel = grid_bwd_ig_kernel<decltype(f)::value, decltype(d)::value>;
    const size_t smem = pair_smem(groups, L, D);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        g, static_cast<const bf16*>(gy), gy_width, static_cast<float*>(gtable),
        static_cast<float*>(gx), B, groups, pair_n_tiles(B, groups));
    return (int)cudaGetLastError();
  });
}
