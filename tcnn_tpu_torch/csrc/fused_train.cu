// K6: the fused train step (grid gather -> MLP forward -> loss -> MLP
// backward -> grid scatter) of a grid + fully fused MLP model.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_kernel_vt (through
//   fused_train_grads, from Trainer.loss_and_grad_fn), for Linear, Smoothstep
//   and Nearest interpolation, the Prime-family hashes, the nine losses, a
//   data pdf, output noise, an external dL/doutput and max_level.
// What bounds it on this card: shared memory and the scatter. A block keeps
//   the weights, every layer's output of its tile and two gradient tiles
//   (mlp_bwd_common.cuh): at config_hash and 128 rows that is 146 KB, so one
//   block (8 warps) per SM, which leaves few random L2 reads in flight in
//   the gather and the scatter. The scatter makes the same 33.5 M f32
//   atomics as K4 at B=2^18, contended at the coarse dense levels. Device
//   memory traffic is small: x, the targets and the gradients.
// What the design does about it: the encoding, the hidden activations and
//   the output gradient never touch device memory, which is what the TPU
//   kernel saves too. Per tile, K1's per-(sample, level) device function
//   fills the encoded tile in shared memory; the forward keeps each layer's
//   output; the loss takes its value and gradient per element (values
//   normalised by n = B * dims once, where the TPU kernel normalises per tile
//   and rescales, equal up to f32 rounding); the backward keeps the gradient
//   at about f32 precision, as _kernel_vt does, by running each product on
//   the tensor cores for the bf16 high and low halves of g; K4's device
//   function scatters from the f32 encoding gradient. Blocks are persistent
//   and keep their weight-gradient partials in L2-resident scratch, summed
//   in a fixed order by a second pass; the loss is summed per block and
//   added with one atomic. Rows past B are masked in the loss and in both
//   scatters, never padded.
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

template <int F>
__global__ void fused_train_kernel(GridArgs g, MlpArgs m, BwdLayout L, LossArgs la,
                                   float* __restrict__ gtable, float* __restrict__ partials,
                                   float* __restrict__ loss_sum, long B, int n_active,
                                   long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = L.nt;
  const size_t n_weights = L.n_weights();
  bf16* sw = reinterpret_cast<bf16*>(smem);
  load_weights(m.weights, sw, n_weights);
  float* scratch = reinterpret_cast<float*>(smem + L.g_offset(2));
  float* sc = scratch + (threadIdx.x / 32) * 256;
  float* partial = partials + (size_t)blockIdx.x * n_weights;
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
      store_g<true>(g0, r * ldg + c,
                    act_bwd_out(gv, __bfloat162float(hout[r * ldo + c]), m.out_act));
    }
    __syncthreads();
    // 4. backward: weight gradients into the partial, the encoding gradient
    //    (f32) into `fin`
    const float* fin = mlp_backward_chain<true>(
        m, L, smem, sw, partial, first, sc,
        [&](float* f, int r, int c, float v) { f[r * ldg + c] = v; });
    // 5. scatter from the encoding gradient (the next tile's first barrier
    //    orders these reads before `fin` is written again)
    for (int p = threadIdx.x; p < nt * n_active; p += blockDim.x) {
      const int r = p / n_active, l = p % n_active;
      const long row = row0 + r;
      if (row < B) grid_level_bwd<F>(g, row, l, fin + r * ldg + l * F, gtable);
    }
    first = false;
  }

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

template <int F>
static int launch_fused_train(const GridArgs& g, const MlpArgs& m, const BwdLayout& L,
                              const LossArgs& la, float* grads, float* partials, float* loss_sum,
                              long B, int n_active, int grid, int device, cudaStream_t stream) {
  const cudaError_t e = opt_in_smem(fused_train_kernel<F>, L, device);
  if (e != cudaSuccess) return (int)e;
  const long n_tiles = (B + L.nt - 1) / L.nt;
  fused_train_kernel<F><<<grid, L.nt * 2, L.bytes(), stream>>>(
      g, m, L, la, grads + L.n_weights(), partials, loss_sum, B, n_active, n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_reduce(partials, grid, L.n_weights(), grads, stream);
}

}  // namespace tcnn

// The persistent grid of tcnn_fused_train over B rows in tiles of nt, for F
// features per level (persistent_grid: > 0 blocks, 0 when no block fits,
// -cudaError).
extern "C" int tcnn_fused_train_grid(int B, int F, int nt, int in_w, int width, int n_hidden,
                                     int out_w, int device) {
  using namespace tcnn;
  const BwdLayout L{nt, in_w, width, n_hidden, out_w, 1};
  if (!valid_layout(L)) return -(int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return persistent_grid(fused_train_kernel<1>, L, device, B);
    case 2: return persistent_grid(fused_train_kernel<2>, L, device, B);
    case 4: return persistent_grid(fused_train_kernel<4>, L, device, B);
    case 8: return persistent_grid(fused_train_kernel<8>, L, device, B);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// `grid` blocks, as tcnn_fused_train_grid gave them; `partials` holds
// grid x n_weights f32.
extern "C" int tcnn_fused_train(const void* x, const void* table, const void* level_i32,
                                const void* level_f32, const void* weights, const void* targets,
                                const void* pdf, const void* noise, void* grads, void* partials,
                                void* loss_sum, int grid, int B, int D, int F, int L, int n_active,
                                int interp, unsigned f0, unsigned f1, unsigned f2, unsigned f3,
                                int nt, int in_w, int width, int n_hidden, int out_w, int act,
                                int out_act, int loss_code, int dims, float loss_scale, int device,
                                void* stream) {
  using namespace tcnn;
  const BwdLayout lay{nt, in_w, width, n_hidden, out_w, 1};
  if (!valid_layout(lay) || grid < 1 || in_w < L * F || n_active > L)
    return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}};
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  LossArgs la{static_cast<const float*>(targets), static_cast<const float*>(pdf),
              static_cast<const float*>(noise), loss_code, dims, loss_scale,
              (float)((long)B * dims)};
  float* gr = static_cast<float*>(grads);
  float* part = static_cast<float*>(partials);
  float* ls = static_cast<float*>(loss_sum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_train<1>(g, m, lay, la, gr, part, ls, B, n_active, grid, device, s);
    case 2: return launch_fused_train<2>(g, m, lay, la, gr, part, ls, B, n_active, grid, device, s);
    case 4: return launch_fused_train<4>(g, m, lay, la, gr, part, ls, B, n_active, grid, device, s);
    case 8: return launch_fused_train<8>(g, m, lay, la, gr, part, ls, B, n_active, grid, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
