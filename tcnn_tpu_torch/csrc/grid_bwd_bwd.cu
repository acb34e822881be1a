// K8: the multiresolution grid's double backward: the vjp of K7's
// (table gradient, dL/dx) for their cotangents (ct_table, z).
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_bwd_bwd_kernel (through
//   _bwd_bwd_call and _ig_backward_bwd), the reference's
//   backward_backward_input trio fused into one pass, all blocks included:
//   with zw_c = sum_d z_d dW_c/dx_d, per corner
//     ct_gy[l, f]  += table[row, f] zw_c + ct_table[row, f] W_c
//     gtable2[row] += bf16(gy_f zw_c)
//     ct_x[e]      += dotf_c sum_d z_d d2W_c/dx_d dx_e + dotf2_c dW_c/dx_e
//   where dotf_c = sum_f gy_f table[row, f], dotf2_c the same of ct_table.
//   The off-diagonal Hessian terms d2W/dx_d dx_e are nonzero for Linear at
//   D >= 2; the diagonal is zero there.
// What bounds it on this card: its arithmetic and loads, then its atomics
//   (about 0.11 of its 0.38 ms at 2^18), not bytes. Per (sample, level)
//   2^D atomics of gtable2 and 2^D row reads of the table, and 2^D more of
//   ct_table when it is given. In the eikonal step ct_table is absent (the table-gradient
//   output has no cotangent), and the kernel skips that gather and the
//   dotf2 terms; z absent skips the rest. At the SDF config and B=2^18 the
//   bound is 0.027 ms (its f32 operations at 67 TFLOP/s). The first-slice
//   K8 (one thread a (sample, level), D read at run time, its arrays in a
//   112-byte stack frame, F scalar atomics a corner) took 1.21 device ms
//   there, 0.78 without atomics; this one takes 0.377, 0.265 without its
//   atomics, 0.340 without its row loads, and 0.0064 device ms at the
//   eikonal term's 1024 points (0.022 before); `index_add_` of the
//   contributions takes 0.60 (H100 80GB HBM3, 700.00 W; PERF.md,
//   scripts/time_ig_kernels.py, ablate_ig_kernels.py). At 102 registers
//   (F = 2, D = 3) one block of 12 warps fills an SM.
// What the design does about it: K7's (grid_bwd_ig.cu): lane pairs that
//   load each x-pair of rows of the table (and of ct_table) in one
//   instruction and swap them, each lane summing its own level's ct_gy and
//   ct_x terms over its corners in the twin's order (bit for bit); gtable2's
//   contributions, rounded to bf16 as K4's are, added by the lane that
//   loaded the corner, one vector atomic a corner on every level (a private
//   slice in shared memory was slower at every batch tried: its shared
//   f32 atomics are CAS loops on sm_90). D is a template parameter; whether
//   ct_table is given is tested at run time (a kernel built without the
//   ct_table branches took 0.3738 against 0.3757 ms at 2^18, 0.0062
//   against 0.0064 at 1024 points). ct_gy belongs to one (sample, level)
//   and is written directly, one vector store a (sample, level), and the
//   kernel writes the zeros of its padding columns, so the wrapper zeroes
//   neither ct_gy nor ct_x; ct_x is summed over levels in order in shared
//   memory (sum_level_parts). ct_table is read as bf16, as repack_table
//   rounds it on the TPU (grid_kernel.py:215-238).
#include "grid_common.cuh"

namespace tcnn {

// ct_gy[b, l F .. l F + F) = v, one vector store.
template <int F>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  if constexpr (F == 1) {
    dst[0] = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <int F, int D>
__global__ void __launch_bounds__(kPairMaxThreads)
    grid_bwd_bwd_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
        const float* __restrict__ z, const bf16* __restrict__ ct_table,
        float* __restrict__ ct_gy, float* __restrict__ gtable2, float* __restrict__ ct_x, long B,
        int groups, long n_tiles) {
  using Raw = typename BfVec<F>::T;
  constexpr int H = 1 << (D - 1);
  extern __shared__ __align__(16) float smem[];
  const int xbit = threadIdx.x & 1;
  auto task = [&](long b, int l0, float* part) {
    PairLevels<D> p;
    pair_levels<D>(g, b, l0, b < B, p);
    float gv[2][F], zz[D];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int f = 0; f < F; ++f) gv[q][f] = 0.f;
      if (p.active[q]) load_bf16<F>(gy + b * gy_width + (l0 + q) * F, gv[q]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) zz[d] = (z && b < B) ? z[b * D + d] : 0.f;
    unsigned row[2][H];
    Raw mine[2][H], theirs[H], mine2[2][H], theirs2[H];
    pair_rows<D>(g, p, row);
    if (z) pair_loads<F, D>(g.table, p, row, mine);
    if (ct_table) pair_loads<F, D>(ct_table, p, row, mine2);
    // gtable2 += bf16(gy_f zw_c) at this lane's corners of both levels
    if (z) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!p.active[q]) continue;
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const CornerDerivs k = corner_derivs<D>(p.w[q], p.deriv[q], p.deriv2[q], 2 * j + xbit);
          float zw = __fmul_rn(zz[0], k.dw(0));
#pragma unroll
          for (int d = 1; d < D; ++d) zw = __fadd_rn(zw, __fmul_rn(zz[d], k.dw(d)));
          float v[F];
#pragma unroll
          for (int f = 0; f < F; ++f)
            v[f] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv[q][f], zw)));
          atomic_add_row<F>(gtable2 + (size_t)row[q][j] * F, v);
        }
      }
    }
    if (z) pair_swap<F, D>(mine, theirs);
    if (ct_table) pair_swap<F, D>(mine2, theirs2);
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] = 0.f;
    if (!(xbit ? p.active[1] : p.active[0])) return;
    // this lane's own level: ct_gy and ct_x over its corners in order
    float go[F], w[D], dv[D], dv2[D], cg_acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      go[f] = xbit ? gv[1][f] : gv[0][f];
      cg_acc[f] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      w[d] = xbit ? p.w[1][d] : p.w[0][d];
      dv[d] = xbit ? p.deriv[1][d] : p.deriv[0][d];
      dv2[d] = xbit ? p.deriv2[1][d] : p.deriv2[0][d];
    }
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const CornerDerivs k = corner_derivs<D>(w, dv, dv2, c);
      float cg[F], cx[D];
#pragma unroll
      for (int e = 0; e < D; ++e) cx[e] = 0.f;
      if (z) {
        float v[F];
        own_corner<F, D>(mine, theirs, c, v);
        float zw = __fmul_rn(zz[0], k.dw(0));
#pragma unroll
        for (int d = 1; d < D; ++d) zw = __fadd_rn(zw, __fmul_rn(zz[d], k.dw(d)));
        float dotf = __fmul_rn(v[0], go[0]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          cg[f] = __fmul_rn(v[f], zw);
          if (f > 0) dotf = __fadd_rn(dotf, __fmul_rn(v[f], go[f]));
        }
#pragma unroll
        for (int e = 0; e < D; ++e) {
          float hess = __fmul_rn(zz[0], k.d2w(0, e));
#pragma unroll
          for (int d = 1; d < D; ++d) hess = __fadd_rn(hess, __fmul_rn(zz[d], k.d2w(d, e)));
          cx[e] = __fmul_rn(dotf, hess);
        }
      }
      if (ct_table) {
        const float cw = corner_weight<D>(w, c);
        float v2[F];
        own_corner<F, D>(mine2, theirs2, c, v2);
        float dotf2 = __fmul_rn(v2[0], go[0]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float t = __fmul_rn(v2[f], cw);
          cg[f] = z ? __fadd_rn(cg[f], t) : t;
          if (f > 0) dotf2 = __fadd_rn(dotf2, __fmul_rn(v2[f], go[f]));
        }
#pragma unroll
        for (int e = 0; e < D; ++e) {
          const float t = __fmul_rn(dotf2, k.dw(e));
          cx[e] = z ? __fadd_rn(cx[e], t) : t;
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) cg_acc[f] = __fadd_rn(cg_acc[f], cg[f]);
#pragma unroll
      for (int e = 0; e < D; ++e) part[e] = __fadd_rn(part[e], cx[e]);
    }
    store_row<F>(ct_gy + b * gy_width + (l0 + xbit) * F, cg_acc);
  };
  // the padding columns [L F, gy_width) of ct_gy: zeros
  const int pad = gy_width - g.L * F, tile = kPairSamples * groups;
  auto pad_zeros = [&](long b0) {
    for (int i = threadIdx.x; i < tile * pad; i += blockDim.x) {
      const long b = b0 + i / pad;
      if (b < B) ct_gy[b * gy_width + g.L * F + i % pad] = 0.f;
    }
  };
  pair_tiles<D>(g, smem, B, groups, ct_x, n_tiles, task, pad_zeros);
}

}  // namespace tcnn

// The grid of tcnn_grid_bwd_bwd over B samples at `groups` sample groups
// and `warps` warps a block (ops/cuda/grid_kernel.py:ig_layout): the
// resident blocks, never more than the tiles (> 0; 0 when no block fits;
// -cudaError).
extern "C" int tcnn_grid_bwd_bwd_grid(int B, int D, int F, int L, int groups, int warps,
                                      int device) {
  using namespace tcnn;
  if (groups < 1 || warps < 1 || warps > 32) return -(int)cudaErrorInvalidValue;
  return with_f_d(F, D, -(int)cudaErrorInvalidValue, [&](auto f, auto d) {
    return resident_grid(grid_bwd_bwd_kernel<decltype(f)::value, decltype(d)::value>, warps * 32,
                         pair_smem(groups, L, D), device, pair_n_tiles(B, groups));
  });
}

// z or ct_table may be null (that cotangent is absent), not both; without
// z there is no gtable2 scatter. `grid` blocks, as tcnn_grid_bwd_bwd_grid
// gave them; gy_width a multiple of F (the wrapper cuts a wider cotangent
// to its L F columns and pads ct_gy back).
extern "C" int tcnn_grid_bwd_bwd(const void* x, const void* gy, const void* z, const void* table,
                                 const void* ct_table, const void* level_i32,
                                 const void* level_f32, void* ct_gy, void* gtable2, void* ct_x,
                                 int B, int D, int F, int L, int interp, unsigned f0, unsigned f1,
                                 unsigned f2, unsigned f3, int hash, int gy_width, int groups,
                                 int warps, int grid, int device, void* stream) {
  using namespace tcnn;
  if (L < 1 || L > 256 || gy_width < L * F || gy_width % F != 0 || interp == INTERP_NEAREST ||
      (!z && !ct_table) || groups < 1 || warps < 1 || warps > 32 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  return with_f_d(F, D, (int)cudaErrorInvalidValue, [&](auto f, auto d) {
    const auto kernel = grid_bwd_bwd_kernel<decltype(f)::value, decltype(d)::value>;
    const size_t smem = pair_smem(groups, L, D);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        g, static_cast<const bf16*>(gy), gy_width, static_cast<const float*>(z),
        static_cast<const bf16*>(ct_table), static_cast<float*>(ct_gy),
        static_cast<float*>(gtable2), static_cast<float*>(ct_x), B, groups,
        pair_n_tiles(B, groups));
    return (int)cudaGetLastError();
  });
}
