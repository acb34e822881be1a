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
// What bounds it on this card: like K7, L2 atomics and random row reads:
//   per (sample, level) 2^D * F atomics and 2^D row reads of the table, and
//   2^D more of ct_table when it is given. In the eikonal step ct_table is
//   absent (the table-gradient output has no cotangent), and the kernel
//   skips that gather and the dotf2 terms; z absent skips the rest.
// What the design does about it: K7's mapping (one thread per (sample,
//   level), blockDim / L whole samples per block) and its corner walk with
//   derivatives (grid_corners<true>); the scatter rounds each contribution
//   to bf16 as K4 does; ct_gy belongs to one (sample, level) and is written
//   directly; ct_x is summed over levels in order in shared memory
//   (sum_levels), deterministic and in the twin's order. ct_table is read
//   as bf16, as repack_table rounds it on the TPU (grid_kernel.py:215-238).
#include "grid_common.cuh"

namespace tcnn {

template <int F>
__global__ void grid_bwd_bwd_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
                                    const float* __restrict__ z, const bf16* __restrict__ ct_table,
                                    float* __restrict__ ct_gy, float* __restrict__ gtable2,
                                    float* __restrict__ ct_x, long B) {
  const int S = blockDim.x / g.L;
  const int s = threadIdx.x / g.L, l = threadIdx.x % g.L;
  const long b0 = (long)blockIdx.x * S;
  const long b = b0 + s;
  const int D = g.D;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if (s < S && b < B) {
    float gv[F], zz[4] = {0.f, 0.f, 0.f, 0.f}, cg_acc[F];
    load_bf16<F>(gy + b * gy_width + l * F, gv);
    if (z) {
      for (int d = 0; d < D; ++d) zz[d] = z[b * D + d];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) cg_acc[f] = 0.f;
    grid_corners<true>(g, b, l, [&](unsigned row, float cw, const CornerDerivs& k) {
      float cg[F], cx[4] = {0.f, 0.f, 0.f, 0.f};
      if (z) {
        float v[F];
        load_bf16<F>(g.table + (size_t)row * F, v);
        float zw = __fmul_rn(zz[0], k.dw(0));
        for (int d = 1; d < D; ++d) zw = __fadd_rn(zw, __fmul_rn(zz[d], k.dw(d)));
        float dotf = __fmul_rn(v[0], gv[0]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          cg[f] = __fmul_rn(v[f], zw);
          if (f > 0) dotf = __fadd_rn(dotf, __fmul_rn(v[f], gv[f]));
          atomicAdd(gtable2 + (size_t)row * F + f,
                    __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv[f], zw))));
        }
        for (int e = 0; e < D; ++e) {
          float hess = __fmul_rn(zz[0], k.d2w(0, e));
          for (int d = 1; d < D; ++d) hess = __fadd_rn(hess, __fmul_rn(zz[d], k.d2w(d, e)));
          cx[e] = __fmul_rn(dotf, hess);
        }
      }
      if (ct_table) {
        float v2[F];
        load_bf16<F>(ct_table + (size_t)row * F, v2);
        float dotf2 = __fmul_rn(v2[0], gv[0]);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float t = __fmul_rn(v2[f], cw);
          cg[f] = z ? __fadd_rn(cg[f], t) : t;
          if (f > 0) dotf2 = __fadd_rn(dotf2, __fmul_rn(v2[f], gv[f]));
        }
        for (int e = 0; e < D; ++e) {
          const float t = __fmul_rn(dotf2, k.dw(e));
          cx[e] = z ? __fadd_rn(cx[e], t) : t;
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) cg_acc[f] = __fadd_rn(cg_acc[f], cg[f]);
      for (int e = 0; e < D; ++e) part[e] = __fadd_rn(part[e], cx[e]);
    });
    float* out = ct_gy + b * gy_width + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = cg_acc[f];
  }
  sum_levels(part, D, g.L, b0, B, ct_x);
}

template <int F>
static int launch_grid_bwd_bwd(const GridArgs& g, const bf16* gy, int gy_width, const float* z,
                               const bf16* ct_table, float* ct_gy, float* gtable2, float* ct_x,
                               long B, cudaStream_t stream) {
  const int threads = 256;
  const long per_block = threads / g.L;
  const long blocks = (B + per_block - 1) / per_block;
  grid_bwd_bwd_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(
      g, gy, gy_width, z, ct_table, ct_gy, gtable2, ct_x, B);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

// z or ct_table may be null (that cotangent is absent), not both.
extern "C" int tcnn_grid_bwd_bwd(const void* x, const void* gy, const void* z, const void* table,
                                 const void* ct_table, const void* level_i32,
                                 const void* level_f32, void* ct_gy, void* gtable2, void* ct_x,
                                 int B, int D, int F, int L, int interp, unsigned f0, unsigned f1,
                                 unsigned f2, unsigned f3, int hash, int gy_width, int device,
                                 void* stream) {
  using namespace tcnn;
  if (L < 1 || L > 256 || gy_width < L * F || interp == INTERP_NEAREST || (!z && !ct_table))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  const bf16* gyp = static_cast<const bf16*>(gy);
  const float* zp = static_cast<const float*>(z);
  const bf16* ctp = static_cast<const bf16*>(ct_table);
  float* cg = static_cast<float*>(ct_gy);
  float* g2 = static_cast<float*>(gtable2);
  float* cx = static_cast<float*>(ct_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_bwd_bwd<1>(g, gyp, gy_width, zp, ctp, cg, g2, cx, B, s);
    case 2: return launch_grid_bwd_bwd<2>(g, gyp, gy_width, zp, ctp, cg, g2, cx, B, s);
    case 4: return launch_grid_bwd_bwd<4>(g, gyp, gy_width, zp, ctp, cg, g2, cx, B, s);
    case 8: return launch_grid_bwd_bwd<8>(g, gyp, gy_width, zp, ctp, cg, g2, cx, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
