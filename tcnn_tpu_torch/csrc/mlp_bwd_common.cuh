// The fully fused MLP backward of K6 and K9 (fused_train.cuh); K5 runs its
// own on mma.sync (mlp_bwd.cu, mlp_frag.cuh).
//
// Shared-memory layout of a block of nt rows (nt/16 warps, 16 rows each),
// the same bytes as ops/cuda/mlp_kernel.py:bwd_smem_bytes:
//   [weights: all layers, flat bf16, row-major [fan_out, fan_in] per matrix]
//   [h_0: nt x (in_w+8)][h_1..h_H: nt x (width+8)][h_out: nt x (out_w+8)]
//       every layer's bf16 output of the recomputed forward (h_0 the input)
//   [G_0][G_1]: two gradient tiles, each hi: nt x ldg bf16 and lo: nt x ldg
//       bf16, ldg = max(in_w, width, out_w) + 8
//   [scratch: nt/16 x 16x16 f32]
//   [K9 only: nt x L*D f32, the dL/dx partials of each (row, level)]
//   [K6 only: the f32 table gradient of the leading dense levels the block
//       keeps private (`priv` floats), added to with shared atomics]
// Row pitches are multiples of 8 elements, so every 16-row fragment starts
// 32-byte aligned.
//
// The gradient g entering a layer is held as bf16 "hi" and the bf16
// "lo" = bf16(g - hi): hi + lo carries 16 significant bits, and each product
// runs twice on the tensor cores (hi, then lo) into f32 accumulators. That
// keeps g at about f32 precision through the chain, as the TPU's fused
// kernel does (train_kernel.py:891-903), at bf16 tensor-core rates.
//
// Per layer i, from the last down: the weight gradient gW_i += G^T h_i (all
// rows of the tile; its 16x16 output tiles are shared out over the warps),
// then the data gradient G' = G W_i (each warp its own rows), transferred
// through the previous layer's activation from its kept output and split
// again. Blocks are persistent (about one per SM slot, each walking many
// tiles), and each keeps its weight-gradient partial in its own slice of a
// global f32 scratch (L2-resident), loaded into the wmma accumulators and
// stored back once per tile; reduce_partials (common.cuh) sums the slices
// afterwards, in a fixed order. K6's slice also carries its private levels'
// table gradient after the weights' (n_partial floats a block).
#pragma once

#include "mlp_common.cuh"

namespace tcnn {

struct BwdLayout {
  int nt, in_w, width, n_hidden, out_w;
  int ig;    // K9: f32 dL/dx partials per row (L * D), after the scratch; 0 otherwise
  int priv;  // K6: f32 private table-gradient floats, after the rest; 0 otherwise

  __host__ __device__ int ld_h(int i) const {
    return (i == 0 ? in_w : i == n_hidden + 1 ? out_w : width) + 8;
  }
  __host__ __device__ int ld_g() const {
    int m = in_w > width ? in_w : width;
    m = m > out_w ? m : out_w;
    return m + 8;
  }
  __host__ __device__ size_t n_weights() const {
    return (size_t)width * in_w + (size_t)(n_hidden - 1) * width * width + (size_t)out_w * width;
  }
  // element offset of layer i's matrix in the flat weights
  __host__ __device__ size_t w_offset(int i) const {
    return i == 0 ? 0 : (size_t)width * in_w + (size_t)(i - 1) * width * width;
  }
  __host__ __device__ size_t h_offset(int i) const {
    size_t off = n_weights() * 2;
    for (int j = 0; j < i; ++j) off += (size_t)nt * ld_h(j) * 2;
    return off;
  }
  __host__ __device__ size_t g_bytes() const { return (size_t)2 * nt * ld_g() * 2; }
  __host__ __device__ size_t g_offset(int k) const { return h_offset(n_hidden + 2) + k * g_bytes(); }
  __host__ __device__ size_t ig_offset() const { return g_offset(2) + (size_t)(nt / 16) * 256 * 4; }
  __host__ __device__ size_t priv_offset() const { return ig_offset() + (size_t)nt * ig * 4; }
  __host__ __device__ size_t bytes() const { return priv_offset() + (size_t)priv * 4; }
  // floats of a block's partial: the weights' gradient, then the private
  // levels', padded to 8 floats so that every slice stays 32-byte aligned
  // for wmma
  __host__ __device__ size_t n_partial() const { return n_weights() + ((size_t)priv + 7) / 8 * 8; }
};

struct GTile {
  bf16* hi;
  bf16* lo;  // hi + nt * ldg
};

__device__ __forceinline__ GTile g_tile(unsigned char* smem, const BwdLayout& L, int k) {
  bf16* hi = reinterpret_cast<bf16*>(smem + L.g_offset(k));
  return GTile{hi, hi + (size_t)L.nt * L.ld_g()};
}

__device__ __forceinline__ bf16* h_tile(unsigned char* smem, const BwdLayout& L, int i) {
  return reinterpret_cast<bf16*>(smem + L.h_offset(i));
}

__device__ __forceinline__ void store_g(const GTile& g, int idx, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  g.hi[idx] = hi;
  g.lo[idx] = __float2bfloat16_rn(v - __bfloat162float(hi));  // v - hi is exact
}

// The forward chain for the warp's own rows, keeping every layer's output.
__device__ __forceinline__ void mlp_forward_keep(const MlpArgs& m, const BwdLayout& L,
                                                 unsigned char* smem, const bf16* w, float* sc) {
  const int n_layers = m.n_hidden + 1;
  for (int i = 0; i < n_layers; ++i) {
    const bool last = i == n_layers - 1;
    const int fan_in = i == 0 ? m.in_w : m.width;
    const int fan_out = last ? m.out_w : m.width;
    bf16* out = h_tile(smem, L, i + 1);
    const int ld_out = L.ld_h(i + 1);
    warp_layer(h_tile(smem, L, i), L.ld_h(i), w + L.w_offset(i), fan_in, fan_out,
               last ? m.out_act : m.act, sc,
               [&](int r, int c, bf16 h) { out[r * ld_out + c] = h; });
  }
}

// gW [fan_out, fan_in] += G^T h over the tile's nt rows, into the block's
// f32 partial (global); `first` starts the partial from zero.
static __device__ void wgrad_layer(const GTile& g, int ldg, const bf16* h, int ld_h, int fan_out,
                            int fan_in, int nt, float* partial, bool first) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  const int tiles_in = fan_in / 16;
  for (int t = warp; t < (fan_out / 16) * tiles_in; t += n_warps) {
    const int o0 = (t / tiles_in) * 16, k0 = (t % tiles_in) * 16;
    float* dst = partial + (size_t)o0 * fan_in + k0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (first) {
      wmma::fill_fragment(acc, 0.f);
    } else {
      wmma::load_matrix_sync(acc, dst, fan_in, wmma::mem_row_major);
    }
    for (int r0 = 0; r0 < nt; r0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;  // G^T
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;  // h
      wmma::load_matrix_sync(b, h + r0 * ld_h + k0, ld_h);
      wmma::load_matrix_sync(a, g.hi + r0 * ldg + o0, ldg);
      wmma::mma_sync(acc, a, b, acc);
      wmma::load_matrix_sync(a, g.lo + r0 * ldg + o0, ldg);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dst, acc, fan_in, wmma::mem_row_major);
  }
}

// G' = G W [rows, fan_in] for the warp's own rows; epi(row, col, f32 value).
template <class Epi>
__device__ void dgrad_layer(const GTile& g, int ldg, const bf16* w, int fan_out, int fan_in,
                            float* sc, Epi&& epi) {
  using namespace nvcuda;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  for (int k0 = 0; k0 < fan_in; k0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int o0 = 0; o0 < fan_out; o0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;  // G
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;  // W
      wmma::load_matrix_sync(b, w + o0 * fan_in + k0, fan_in);
      wmma::load_matrix_sync(a, g.hi + r0 * ldg + o0, ldg);
      wmma::mma_sync(acc, a, b, acc);
      wmma::load_matrix_sync(a, g.lo + r0 * ldg + o0, ldg);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(r0 + e / 16, k0 + e % 16, sc[e]);
    __syncwarp();
  }
}

// The backward chain of one tile. G_0 holds the output layer's gradient
// after its activation transfer, for every row, and the block is
// synchronised. Each layer's weight gradient goes into `partial` (the
// block's slice, [n_weights] f32); the input gradient of the first layer goes
// to last(fin, row, col, f32 value), where `fin` is a free f32 [nt, ldg]
// view of a gradient tile. Returns `fin`; ends synchronised.
template <class Last>
__device__ float* mlp_backward_chain(const MlpArgs& m, const BwdLayout& L, unsigned char* smem,
                                     const bf16* w, float* partial, bool first, float* sc,
                                     Last&& last) {
  const int ldg = L.ld_g();
  GTile cur = g_tile(smem, L, 0), nxt = g_tile(smem, L, 1);
  float* fin = nullptr;
  for (int i = m.n_hidden; i >= 0; --i) {
    const int fan_in = i == 0 ? m.in_w : m.width;
    const int fan_out = i == m.n_hidden ? m.out_w : m.width;
    const bf16* wi = w + L.w_offset(i);
    wgrad_layer(cur, ldg, h_tile(smem, L, i), L.ld_h(i), fan_out, fan_in, L.nt,
                       partial + L.w_offset(i), first);
    if (i > 0) {
      const bf16* hp = h_tile(smem, L, i);  // output of layer i-1
      const int ldp = L.ld_h(i);
      const GTile out = nxt;
      dgrad_layer(cur, ldg, wi, fan_out, fan_in, sc, [&](int r, int c, float v) {
        store_g(out, r * ldg + c, act_bwd_out(v, __bfloat162float(hp[r * ldp + c]), m.act));
      });
    } else {
      fin = reinterpret_cast<float*>(nxt.hi);
      float* f = fin;
      dgrad_layer(cur, ldg, wi, fan_out, fan_in, sc,
                         [&](int r, int c, float v) { last(f, r, c, v); });
    }
    __syncthreads();
    const GTile t = cur;
    cur = nxt;
    nxt = t;
  }
  return fin;
}

// Opt the kernel in to the layout's shared memory on `device`.
template <class Kernel>
static cudaError_t opt_in_smem(Kernel kernel, const BwdLayout& L, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes());
}

// The persistent grid of a launch over B rows: the blocks resident at once
// (by occupancy at the layout's shared memory), never more than the tiles.
// The wrapper sizes the per-block weight-gradient scratch by it and passes
// it back to the launch. Returns -cudaError on failure and 0 when no block
// fits.
template <class Kernel>
static int persistent_grid(Kernel kernel, const BwdLayout& L, int device, long B) {
  return resident_grid(kernel, L.nt * 2, L.bytes(), device, (B + L.nt - 1) / L.nt);
}

static bool valid_layout(const BwdLayout& L) {
  return L.nt >= 16 && L.nt <= 128 && L.nt % 16 == 0 && L.n_hidden >= 1 && L.priv >= 0;
}

}  // namespace tcnn
