// The fully fused MLP layer chain of K2 (mlp_fwd.cu), and the activations,
// forward and backward, of every MLP kernel (K3, K5, K6 and K9 run their
// layers on mma.sync, mlp_frag.cuh).
//
// Shared-memory layout of a block of nt rows (nt/16 warps, 16 rows each):
//   [weights: all layers, flat bf16, row-major [fan_out, fan_in] per matrix]
//   [act0: nt x ld bf16][act1: nt x ld bf16][scratch: nt/16 x 16x16 f32]
// with ld = max(in_w, width, out_w) + 8 (the pad staggers rows across
// banks and keeps every 16-row fragment 32-byte aligned). Each warp runs its
// 16 rows through every layer on the tensor cores (wmma 16x16x16, bf16 in,
// f32 accumulate). y = x W^T, so W's row-major [fan_out, fan_in] storage is
// read directly as a col-major B operand. The accumulator goes through the
// warp's f32 scratch, gets the activation in f32 and is rounded to bf16, as
// mlp_kernel.py:51-62 does. A warp only touches its own rows, so layers are
// separated by __syncwarp, not __syncthreads.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace tcnn {

enum Act {
  ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_EXPONENTIAL = 3,
  ACT_SIGMOID = 4, ACT_SQUAREPLUS = 5, ACT_SOFTPLUS = 6, ACT_TANH = 7,
};

struct MlpArgs {
  const bf16* weights;  // flat [n_weights] bf16
  int in_w, width, n_hidden, out_w, act, out_act;
};

// Forward activations (common_device.h:102-165), K_ACT = 10.
__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(z, 0.f);
    case ACT_LEAKY_RELU: return z > 0.f ? z : 0.01f * z;
    case ACT_EXPONENTIAL: return expf(z);
    case ACT_SIGMOID: return 1.f / (1.f + expf(-z));
    case ACT_SQUAREPLUS: {
      const float xk = z * 10.f;
      return 0.5f * (xk + sqrtf(xk * xk + 4.f)) / 10.f;
    }
    case ACT_SOFTPLUS: {
      const float t = z * 10.f;
      return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) / 10.f;
    }
    case ACT_TANH: return tanhf(z);
    default: return z;
  }
}

// grad * act'(x) from the post-activation output y (common_device.h:237-304,
// activations.py:activation_bwd_out); Sine has no such form.
__device__ __forceinline__ float act_bwd_out(float g, float y, int act) {
  switch (act) {
    case ACT_RELU: return g * (y > 0.f ? 1.f : 0.f);
    case ACT_LEAKY_RELU: return g * (y > 0.f ? 1.f : 0.01f);
    case ACT_EXPONENTIAL: return g * y;
    case ACT_SIGMOID: return g * y * (1.f - y);
    case ACT_SQUAREPLUS: {
      const float yk = y * 10.f;
      const float y2 = yk * yk;
      return g * (y2 / (y2 + 1.f));
    }
    case ACT_SOFTPLUS: return g * (1.f - expf(-y * 10.f));
    case ACT_TANH: return g * (1.f - y * y);
    default: return g;
  }
}

inline size_t mlp_n_weights(int in_w, int width, int n_hidden, int out_w) {
  return (size_t)width * in_w + (size_t)(n_hidden - 1) * width * width + (size_t)out_w * width;
}

inline int mlp_ld(int in_w, int width, int out_w) {
  int m = in_w > width ? in_w : width;
  m = m > out_w ? m : out_w;
  return m + 8;
}

inline size_t mlp_smem_bytes(int in_w, int width, int n_hidden, int out_w, int nt) {
  return mlp_n_weights(in_w, width, n_hidden, out_w) * sizeof(bf16) +
         2 * (size_t)nt * mlp_ld(in_w, width, out_w) * sizeof(bf16) +
         (size_t)(nt / 16) * 256 * sizeof(float);
}

struct MlpSmem {
  bf16* weights;
  bf16* act0;
  bf16* act1;
  float* scratch;
};

__device__ __forceinline__ MlpSmem mlp_smem(unsigned char* base, size_t n_weights, int nt, int ld) {
  MlpSmem s;
  s.weights = reinterpret_cast<bf16*>(base);
  s.act0 = s.weights + n_weights;
  s.act1 = s.act0 + (size_t)nt * ld;
  s.scratch = reinterpret_cast<float*>(s.act1 + (size_t)nt * ld);
  return s;
}

// Block-wide copy of the flat weights into shared memory (16-byte chunks;
// every layer holds a multiple of 256 weights, so the total does too).
__device__ __forceinline__ void load_weights(const bf16* __restrict__ w, bf16* sw, size_t n_weights) {
  const uint4* src = reinterpret_cast<const uint4*>(w);
  uint4* dst = reinterpret_cast<uint4*>(sw);
  for (size_t i = threadIdx.x; i < n_weights / 8; i += blockDim.x) dst[i] = src[i];
}

// One layer for the warp's 16 rows r0..r0+15 of a tile: z = in W^T on the
// tensor cores (W row-major [fan_out, fan_in], read as a col-major B
// operand), the activation in f32 through the warp's 16x16 f32 scratch `sc`,
// and epi(row, col, bf16 value) for every output of those rows.
template <class Epi>
__device__ __forceinline__ void warp_layer(const bf16* in, int ld_in, const bf16* w, int fan_in,
                                           int fan_out, int act, float* sc, Epi&& epi) {
  using namespace nvcuda;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  for (int n0 = 0; n0 < fan_out; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < fan_in; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, in + r0 * ld_in + k0, ld_in);
      wmma::load_matrix_sync(b, w + n0 * fan_in + k0, fan_in);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      epi(r0 + e / 16, n0 + e % 16, __float2bfloat16_rn(apply_act(sc[e], act)));
    }
    __syncwarp();
  }
}

// Runs the layer chain from act0 (the block's input tile, already in shared
// memory and synchronised) and writes rows row0.. of the [B, out_w] output.
template <int WIDTH>
__device__ void mlp_chain(const MlpArgs& m, const MlpSmem& s, int ld, bf16* __restrict__ out,
                          long row0, long B) {
  float* sc = s.scratch + (threadIdx.x / 32) * 256;
  const bf16* w = s.weights;
  bf16* cur = s.act0;
  bf16* nxt = s.act1;
  const int n_layers = m.n_hidden + 1;
  for (int i = 0; i < n_layers; ++i) {
    const bool last = i == n_layers - 1;
    const int fan_in = i == 0 ? m.in_w : WIDTH;
    const int fan_out = last ? m.out_w : WIDTH;
    if (!last) {
      warp_layer(cur, ld, w, fan_in, fan_out, m.act,
                 sc, [&](int r, int c, bf16 h) { nxt[r * ld + c] = h; });
    } else {
      warp_layer(cur, ld, w, fan_in, fan_out, m.out_act, sc, [&](int r, int c, bf16 h) {
        const long row = row0 + r;
        if (row < B) out[row * m.out_w + c] = h;
      });
    }
    w += (size_t)fan_out * fan_in;
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace tcnn

// Rows per block for this MLP on `device`: the largest of 128, 64, 32, 16
// whose shared memory fits the block's opt-in limit, else 0.
extern "C" int tcnn_mlp_tile(int in_w, int width, int n_hidden, int out_w, int device);
