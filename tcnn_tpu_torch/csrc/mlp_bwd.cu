// K5: fully fused MLP backward.
//
// Replaces: tcnn_tpu/ops/pallas/mlp_kernel.py:_bwd_kernel (through _bwd_call
//   and _fused_mlp_bwd): recompute the forward chain, run the dgrad chain
//   with the activation transfer from the kept outputs, g rounded to bf16 at
//   every layer (mlp_kernel.py:91), accumulate the weight gradients across
//   batch tiles and write dL/dinput as bf16.
// What bounds it on this card: at config_hash (32 -> 64 -> 64 -> 16,
//   B=2^18) it reads 16.8 MB of bf16 input and 8.4 MB of bf16 cotangent,
//   writes 16.8 MB of bf16 input gradient, and computes 3 x 3.8 GFLOP (the
//   recomputed forward, dgrad and wgrad): far below the bf16 ridge, so
//   device-memory traffic, the per-tile barriers and the round trips through
//   shared memory bound it, not the tensor cores.
// What the design does about it: no intermediate touches device memory: the
//   recomputed activations and the gradient tiles stay in shared memory with
//   every weight (mlp_bwd_common.cuh). Blocks run in no order, so the
//   weight gradients cannot be carried from tile to tile as the TPU grid
//   carries them: a persistent grid (the resident blocks, each looping over
//   tiles) keeps one f32 partial per block in L2-resident scratch, and a
//   second pass (reduce_partials, common.cuh) sums them in a fixed order into the flat
//   [fan_out, fan_in] layout. The batch tail is masked, never padded.
#include "mlp_bwd_common.cuh"

namespace tcnn {

__global__ void mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy, MlpArgs m,
                               BwdLayout L, bf16* __restrict__ gx, float* __restrict__ partials,
                               long B, long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = L.nt;
  const size_t n_weights = L.n_weights();
  bf16* sw = reinterpret_cast<bf16*>(smem);
  load_weights(m.weights, sw, n_weights);
  float* sc = reinterpret_cast<float*>(smem + L.g_offset(2)) + (threadIdx.x / 32) * 256;
  float* partial = partials + (size_t)blockIdx.x * n_weights;
  bf16* h0 = h_tile(smem, L, 0);
  bf16* hout = h_tile(smem, L, m.n_hidden + 1);
  const int ld0 = L.ld_h(0), ldo = L.ld_h(m.n_hidden + 1), ldg = L.ld_g();
  const GTile g0 = g_tile(smem, L, 0);
  const int chunks = m.in_w / 8;  // 16-byte chunks per input row
  const int r0 = (threadIdx.x / 32) * 16, lane = threadIdx.x % 32;

  bool first = true;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = tile * nt;
    for (int i = threadIdx.x; i < nt * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i % chunks;
      const long row = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < B) v = reinterpret_cast<const uint4*>(x + row * m.in_w)[c];
      *reinterpret_cast<uint4*>(h0 + r * ld0 + c * 8) = v;
    }
    __syncthreads();
    mlp_forward_keep(m, L, smem, sw, sc);
    for (int e = lane; e < 16 * m.out_w; e += 32) {
      const int r = r0 + e / m.out_w, c = e % m.out_w;
      const long row = row0 + r;
      const float g = row < B ? __bfloat162float(gy[row * m.out_w + c]) : 0.f;
      store_g<false>(g0, r * ldg + c,
                     act_bwd_out(g, __bfloat162float(hout[r * ldo + c]), m.out_act));
    }
    __syncthreads();
    mlp_backward_chain<false>(m, L, smem, sw, partial, first, sc,
                              [&](float*, int r, int c, float v) {
                                const long row = row0 + r;
                                if (row < B) gx[row * m.in_w + c] = __float2bfloat16_rn(v);
                              });
    first = false;
  }
}

}  // namespace tcnn

// The persistent grid of tcnn_mlp_bwd over B rows in tiles of nt
// (persistent_grid: > 0 blocks, 0 when no block fits, -cudaError).
extern "C" int tcnn_mlp_bwd_grid(int B, int nt, int in_w, int width, int n_hidden, int out_w,
                                 int device) {
  using namespace tcnn;
  const BwdLayout L{nt, in_w, width, n_hidden, out_w, 0};
  if (!valid_layout(L)) return -(int)cudaErrorInvalidValue;
  return persistent_grid(mlp_bwd_kernel, L, device, B);
}

// `grid` blocks, as tcnn_mlp_bwd_grid gave them; `partials` holds grid x
// n_weights f32.
extern "C" int tcnn_mlp_bwd(const void* x, const void* gy, const void* weights, void* gw, void* gx,
                            void* partials, int grid, int B, int nt, int in_w, int width,
                            int n_hidden, int out_w, int act, int out_act, int device,
                            void* stream) {
  using namespace tcnn;
  const BwdLayout L{nt, in_w, width, n_hidden, out_w, 0};
  if (!valid_layout(L) || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in_smem(mlp_bwd_kernel, L, device);
  if (e != cudaSuccess) return (int)e;
  const long n_tiles = ((long)B + nt - 1) / nt;
  const MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  mlp_bwd_kernel<<<grid, nt * 2, L.bytes(), s>>>(static_cast<const bf16*>(x),
                                                 static_cast<const bf16*>(gy), m, L,
                                                 static_cast<bf16*>(gx), part, B, n_tiles);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_reduce(part, grid, L.n_weights(), L.n_weights(), static_cast<float*>(gw), s);
}
