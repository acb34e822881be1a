// The fused grid + MLP training kernel shared by K6 (fused_train.cu: the
// train step) and K9 (fused_ig.cu: the input-gradient backward), one
// template, fused_train_kernel<F, IG>; each source instantiates its own half,
// so the two build in parallel. See fused_train.cu and fused_ig.cu for what
// each replaces and what bounds it.
#pragma once

#include "grid_common.cuh"
#include "mlp_bwd_common.cuh"

namespace tcnn {

struct LossArgs {
  const float* targets;  // [B, dims] f32, or dL/doutput [B, out_w] when code == 0
  const float* pdf;      // [B, dims] f32 or null
  const float* noise;    // [B, out_w] f32 or null
  int code, dims;        // loss code (ops/losses.py kernel_code; 0: external dL), target width
  float loss_scale, n;   // n = B * dims
};

// (value, gradient) of loss `code` at one element, in the operation order of
// ops/losses.py; `lum` is the luminance of the sample's first 3 predictions.
__device__ __forceinline__ float2 loss_eval(int code, float p, float t, float pdf, float n,
                                            float lum) {
  const float d = p - t;
  const float sgn = (float)((d > 0.f) - (d < 0.f));
  switch (code) {
    case 1: return make_float2(d * d / pdf / n, 2.f * d / pdf / n);
    case 2: {
      const float den = p * p + 0.01f;
      return make_float2(d * d / den / pdf / n, 2.f * d / den / pdf / n);
    }
    case 3: {
      const float den = lum * lum + 0.01f;
      return make_float2(d * d / den / pdf / n, 2.f * d / den / pdf / n);
    }
    case 4: return make_float2(fabsf(d) / pdf / n, sgn / pdf / n);
    case 5: {
      const float s = 1.f / (fabsf(p) + 1e-2f) / pdf;
      return make_float2(fabsf(d) * s / n, sgn * s / n);
    }
    case 6: {
      const float s = 1.f / (fabsf(t) + 1e-2f) / pdf;
      return make_float2(fabsf(d) * s / n, sgn * s / n);
    }
    case 7: {
      const float s = 1.f / (0.5f * (fabsf(t) + fabsf(p)) + 1e-2f) / pdf;
      return make_float2(fabsf(d) * s / n, sgn * s / n);
    }
    case 8: {
      const float f = -t / pdf / n;
      return make_float2(f * logf(p), f / p);
    }
    case 9: {
      const float f = t * t / pdf / n;
      return make_float2(f / p - f / pdf, -f / (p * p));
    }
    default: return make_float2(0.f, 0.f);
  }
}

// IG (K9): the raw output cotangent in place of the loss (la.code == 0), no
// loss sum, and dL/dx into gx [B, D] from the encoding's f32 gradient.
// K6 keeps the table gradient of levels 0..n_private-1 (L.priv floats) in
// shared memory and leaves it in its partial after the weights'; K9 keeps
// none (n_private = 0, L.priv = 0).
template <int F, bool IG>
__global__ void fused_train_kernel(GridArgs g, MlpArgs m, BwdLayout L, LossArgs la,
                                   float* __restrict__ gtable, float* __restrict__ partials,
                                   float* __restrict__ loss_sum, float* __restrict__ gx, long B,
                                   int n_active, int n_private, long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = L.nt;
  const size_t n_weights = L.n_weights();
  bf16* sw = reinterpret_cast<bf16*>(smem);
  load_weights(m.weights, sw, n_weights);
  float* scratch = reinterpret_cast<float*>(smem + L.g_offset(2));
  float* sc = scratch + (threadIdx.x / 32) * 256;
  float* partial = partials + (size_t)blockIdx.x * L.n_partial();
  float* priv = reinterpret_cast<float*>(smem + L.priv_offset());
  // zeroed once; the first tile's barrier after its gather orders this
  // before any scatter
  for (int i = threadIdx.x; i < L.priv; i += blockDim.x) priv[i] = 0.f;
  bf16* h0 = h_tile(smem, L, 0);
  bf16* hout = h_tile(smem, L, m.n_hidden + 1);
  const int ld0 = L.ld_h(0), ldo = L.ld_h(m.n_hidden + 1), ldg = L.ld_g();
  const GTile g0 = g_tile(smem, L, 0);
  const int r0 = (threadIdx.x / 32) * 16, lane = threadIdx.x % 32;
  const int pad = m.in_w - g.L * F;
  const int out_w = m.out_w;
  float loss_acc = 0.f;

  bool first = true;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = tile * nt;
    // 1. gather: the encoded tile, zero past B, past n_active and in the padding
    for (int p = threadIdx.x; p < nt * g.L; p += blockDim.x) {
      const int r = p / g.L, l = p % g.L;
      const long row = row0 + r;
      float v[F];
      if (row < B && l < n_active) {
        grid_level<F>(g, row, l, v);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.f;
      }
      store_bf16<F>(h0 + r * ld0 + l * F, v);
    }
    for (int p = threadIdx.x; p < nt * pad; p += blockDim.x) {
      h0[(p / pad) * ld0 + g.L * F + p % pad] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    // 2. forward, keeping every layer's output (each warp its own rows)
    mlp_forward_keep(m, L, smem, sw, sc);
    // 3. loss value and gradient (or the external dL), through the output
    //    activation, split into the first gradient tile
    for (int e = lane; e < 16 * out_w; e += 32) {
      const int r = r0 + e / out_w, c = e % out_w;
      const long row = row0 + r;
      float gv = 0.f;
      if (row < B) {
        if (la.code == 0) {
          gv = la.targets[row * out_w + c];
        } else if (c < la.dims) {
          auto pred = [&](int cc) {
            const float p = __bfloat162float(hout[r * ldo + cc]);
            return la.noise ? p + la.noise[row * out_w + cc] : p;
          };
          const float lum =
              la.code == 3 ? 0.299f * pred(0) + 0.587f * pred(1) + 0.114f * pred(2) : 0.f;
          const float2 vg = loss_eval(la.code, pred(c), la.targets[row * la.dims + c],
                                      la.pdf ? la.pdf[row * la.dims + c] : 1.f, la.n, lum);
          loss_acc += vg.x;
          gv = vg.y * la.loss_scale;
        }
      }
      store_g(g0, r * ldg + c,
                    act_bwd_out(gv, __bfloat162float(hout[r * ldo + c]), m.out_act));
    }
    __syncthreads();
    // 4. backward: weight gradients into the partial, the encoding gradient
    //    (f32) into `fin`
    const float* fin = mlp_backward_chain(
        m, L, smem, sw, partial, first, sc,
        [&](float* f, int r, int c, float v) { f[r * ldg + c] = v; });
    // 5. scatter from the encoding gradient (the next tile's first barrier
    //    orders these reads before `fin` is written again); K9 also leaves
    //    each (row, level)'s dL/dx partial in shared memory and sums each
    //    row's levels in order, as K7 does
    if (IG) {
      float* gxs = reinterpret_cast<float*>(smem + L.ig_offset());
      const int D = g.D;
      for (int p = threadIdx.x; p < nt * g.L; p += blockDim.x) {
        const int r = p / g.L, l = p % g.L;
        const long row = row0 + r;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < B) grid_level_bwd_ig<F>(g, row, l, fin + r * ldg + l * F, gtable, part);
        for (int d = 0; d < D; ++d) gxs[p * D + d] = part[d];
      }
      __syncthreads();
      sum_level_parts(gxs, nt, D, g.L, row0, B, gx);
    } else {
      // a warp takes 32 rows of one level, so a level's private/global
      // branch is the whole warp's
      for (int p = threadIdx.x; p < nt * n_active; p += blockDim.x) {
        const int l = p / nt, r = p % nt;
        const long row = row0 + r;
        if (row < B) grid_level_bwd<F>(g, row, l, fin + r * ldg + l * F, gtable, priv, l < n_private);
      }
    }
    first = false;
  }
  if (IG) return;

  // the private levels' gradient into the partial, after the weights', for
  // the fixed-order reduce
  __syncthreads();
  for (int i = threadIdx.x; i < L.priv; i += blockDim.x) partial[n_weights + i] = priv[i];
  // the block's loss: warp sums, then one atomic
  for (int o = 16; o > 0; o /= 2) loss_acc += __shfl_down_sync(0xffffffffu, loss_acc, o);
  __syncthreads();
  if (lane == 0) scratch[threadIdx.x / 32] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += scratch[w];
    atomicAdd(loss_sum, s);
  }
}

template <int F, bool IG>
static int launch_fused_train(const GridArgs& g, const MlpArgs& m, const BwdLayout& L,
                              const LossArgs& la, float* grads, float* partials, float* loss_sum,
                              float* gx, long B, int n_active, int n_private, int grid,
                              int device, cudaStream_t stream) {
  const cudaError_t e = opt_in_smem(fused_train_kernel<F, IG>, L, device);
  if (e != cudaSuccess) return (int)e;
  const long n_tiles = (B + L.nt - 1) / L.nt;
  fused_train_kernel<F, IG><<<grid, L.nt * 2, L.bytes(), stream>>>(
      g, m, L, la, grads + L.n_weights(), partials, loss_sum, gx, B, n_active, n_private,
      n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // the weights' gradient and, right after it in [network | table], the
  // private levels' rows 0..priv/F-1
  return launch_reduce(partials, grid, L.n_partial(), L.n_weights() + L.priv, grads, stream);
}

}  // namespace tcnn
