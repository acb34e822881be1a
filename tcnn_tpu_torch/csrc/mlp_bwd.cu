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
//   device-memory traffic bounds it, and short of that, the traffic a tile
//   makes in shared memory and L2.
// What the design does about it: persistent blocks of nt rows (a warp each
//   16) load the padded weights once (mlp_frag.cuh) and walk tiles. A
//   warp's forward and dgrad run on mma.sync from registers: the forward
//   keeps each layer's bf16 output in shared memory once (wgrad reads h^T
//   across every warp's rows), and dgrad takes G from registers, applies the
//   activation transfer from the kept output and writes the next G once as
//   bf16, and the input gradient as 16-byte row pieces. The weight gradient
//   is dealt out in 16x16 units (gw_unit): a warp keeps up to K5_REG_UNITS of
//   them in registers across every tile it walks, and the block writes its
//   partial once, at the end; units past that (wide or deep MLPs) add into
//   the block's partial in L2 once a tile, several at a time at width 128 so
//   that their loads overlap. reduce_partials (common.cuh) sums the partials in
//   a fixed order, so gW is the same bits run to run. One barrier after the
//   forward and one a layer: G alternates between two shared buffers. A
//   kernel is built for the ReLU / None activations with no branch on them
//   (mlp_frag.cuh:with_acts). The batch tail is masked, never padded.
#include "mlp_frag.cuh"

namespace tcnn {

// 16x16 weight-gradient units (mlp_frag.cuh: gw_unit) a warp keeps in
// registers (8 f32 a thread each): 32 units at 8 warps, config_hash's 28
// among them (tests/test_torch_mlp_layouts.py copies the plan).
constexpr int K5_REG_UNITS = 4;

// Shared memory of a block of nt rows, in elements from its base
// (mlp_kernel.py:mlp_bwd_smem_bytes counts the same): the padded weights,
// h_0 (the input, pitch in_w + 8), h_1..h_H (pitch width + 8), then two G
// buffers of pitch max(width, out_w) + 8.
struct K5Layout {
  MlpArgs m;
  int nt;
  __host__ __device__ int ld_h(int i) const { return (i == 0 ? m.in_w : m.width) + 8; }
  __host__ __device__ int ld_g() const { return (m.width > m.out_w ? m.width : m.out_w) + 8; }
  __host__ __device__ size_t h_offset(int i) const {
    size_t off = frag_weight_elems(m);
    if (i > 0) off += (size_t)nt * ld_h(0) + (size_t)(i - 1) * nt * ld_h(1);
    return off;
  }
  __host__ __device__ size_t g_offset(int k) const {
    return h_offset(m.n_hidden + 1) + (size_t)k * nt * ld_g();
  }
  __host__ __device__ size_t bytes() const { return g_offset(2) * sizeof(bf16); }
};

// c += G^T h over the tile's nt rows for the unit at (o0, c0): G [nt, fan_out]
// and h [nt, fan_in], both read transposed from shared memory; unrolled so
// that several row slabs' ldmatrix are in flight (K5 -4%,
// scripts/ablate_mlp_kernels.py k5-rolled).
__device__ __forceinline__ void unit_mma(float (&c)[2][4], const bf16* G, int ldg, const bf16* h,
                                         int ldh, int nt, int o0, int c0) {
#pragma unroll 4
  for (int r = 0; r < nt; r += 16) {
    uint32_t a[4], b[4];
    ldsm_x4<true>(a, cols_first(G, ldg, r, o0));
    ldsm_x4<true>(b, rows_first(h, ldh, r, c0));
    mma_bf16(c[0], a, b[0], b[1]);
    mma_bf16(c[1], a, b[2], b[3]);
  }
}

template <int WIDTH, int ACT, int OUT_ACT>
__global__ void __launch_bounds__(256, WIDTH <= 64 ? 2 : 1)
    mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy, MlpArgs m, int nt,
                   bf16* __restrict__ gx, float* __restrict__ partials, long B, long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = WIDTH / 16, LDW = WIDTH + 8;
  // units past the registers that a warp carries through L2 at once: four
  // at width 128, whose single-block SMs leave registers spare; one below,
  // where a batch's registers would spill the main path's 128
  constexpr int K5_SPILL_BATCH = WIDTH > 64 ? 4 : 1;
  const K5Layout L{m, nt};
  const int H = m.n_hidden;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int r0 = warp * 16, ld0 = L.ld_h(0), ldg = L.ld_g();
  const int cap = K5_REG_UNITS * n_warps;
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* h0 = sw + L.h_offset(0);
  float* partial = partials + (size_t)blockIdx.x * flat_offset(m, H + 1);
  float acc[K5_REG_UNITS][2][4];
#pragma unroll
  for (int k = 0; k < K5_REG_UNITS; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][q][e] = 0.f;
  load_weights_padded(m, sw);
  __syncthreads();

  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = tile * nt, wrow0 = row0 + r0;
    const bool first = tile == blockIdx.x;
    // the warp's 16 input rows into h_0, zero past B
    const int chunks = m.in_w / 8;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = i % chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (wrow0 + r < B) v = reinterpret_cast<const uint4*>(x + (wrow0 + r) * m.in_w)[c];
      *reinterpret_cast<uint4*>(h0 + (r0 + r) * ld0 + c * 8) = v;
    }
    __syncwarp();
    // forward, keeping h_1..h_H; the output layer's G_H = bf16(act'(gy))
    // from the output's bf16 values, into G buffer H % 2
    bf16* gH = sw + L.g_offset(H & 1) + r0 * ldg;
    frag_forward<WIDTH, ACT, OUT_ACT>(
        m, sw, h0 + r0 * ld0, ld0,
        [&](int i, int p, const uint32_t(&a)[4]) {
          store_slab(sw + L.h_offset(i) + r0 * LDW, LDW, 16 * p, a);
        },
        [&](int p, const uint32_t(&o)[4]) {
          uint32_t gq[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long row = wrow0 + frag_row(j);
            const uint32_t gv = row < B ? *reinterpret_cast<const uint32_t*>(
                                              gy + row * m.out_w + 16 * p + frag_col(j))
                                        : 0u;
            const float2 y = unpack_bf16(o[j]), d = unpack_bf16(gv);
            gq[j] = pack_bf16(act_bwd<OUT_ACT>(d.x, y.x, m.out_act),
                              act_bwd<OUT_ACT>(d.y, y.y, m.out_act));
          }
          store_slab(gH, ldg, 16 * p, gq);
        });
    __syncthreads();

    uint32_t gc[NS][4];  // G_i of the warp's rows for i < H
    for (int i = H; i >= 0; --i) {
      const bf16* Gi = sw + L.g_offset(i & 1);
      const bf16* hi = sw + L.h_offset(i);
      const int fi = frag_fan_in(m, i), fo = frag_fan_out(m, i), cb = fi / 16;
      const int ldh = L.ld_h(i);
      // wgrad: this warp's units of layer i, in registers ...
      int base = 0;
      for (int j = 0; j < i; ++j) base += layer_units(m, j);
      const int n_i = layer_units(m, i);
#pragma unroll
      for (int k = 0; k < K5_REG_UNITS; ++k) {
        const int u = k * n_warps + warp - base;
        if (u >= 0 && u < n_i) unit_mma(acc[k], Gi, ldg, hi, ldh, nt, (u / cb) * 16, (u % cb) * 16);
      }
      // ... and past the registers, through the block's partial, a batch of
      // units at a time: their loads first, then their products, row slab
      // by row slab
      const int start = base > cap ? base : cap;
      for (int u0 = start + ((warp - start) % n_warps + n_warps) % n_warps; u0 < base + n_i;
           u0 += K5_SPILL_BATCH * n_warps) {
        float c[K5_SPILL_BATCH][2][4];
        int o0[K5_SPILL_BATCH], c0[K5_SPILL_BATCH];
        float* dst[K5_SPILL_BATCH];
#pragma unroll
        for (int b = 0; b < K5_SPILL_BATCH; ++b) {
          const int lu = u0 + b * n_warps - base;
          o0[b] = (lu / cb) * 16;
          c0[b] = (lu % cb) * 16;
          dst[b] = lu < n_i ? partial + flat_offset(m, i) + (size_t)o0[b] * fi + c0[b] : nullptr;
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const float2 v = first || !dst[b] ? make_float2(0.f, 0.f)
                                                : *unit_pair(dst[b], fi, q, e / 2);
              c[b][q][e] = v.x;
              c[b][q][e + 1] = v.y;
            }
        }
        for (int r = 0; r < nt; r += 16) {
#pragma unroll
          for (int b = 0; b < K5_SPILL_BATCH; ++b) {
            if (!dst[b]) continue;
            uint32_t a[4], bb[4];
            ldsm_x4<true>(a, cols_first(Gi, ldg, r, o0[b]));
            ldsm_x4<true>(bb, rows_first(hi, ldh, r, c0[b]));
            mma_bf16(c[b][0], a, bb[0], bb[1]);
            mma_bf16(c[b][1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int b = 0; b < K5_SPILL_BATCH; ++b) {
          if (!dst[b]) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              *unit_pair(dst[b], fi, q, e / 2) = make_float2(c[b][q][e], c[b][q][e + 1]);
            }
        }
      }

      const bf16* wi = sw + frag_w_offset(m, i);
      if (i == 0) {
        // dL/dinput = G_0 W_0, bf16, as 16-byte row pieces
        for (int p = 0; p < m.in_w / 16; ++p) {
          float a2[2][4];
          mma_pair_regs<NS, true>(gc, wi, m.in_w + 8, p, a2);
          uint32_t o[4];
          pack_pair(o, a2, [](int, int, float v) { return v; });
          store_slab_rows(gx, m.in_w, wrow0, B, 16 * p, o);
        }
      } else {
        // dgrad: G_{i-1} = bf16(act'(G_i W_i)), the transfer from layer
        // i-1's kept output h_i, into registers and G buffer (i-1) % 2
        const bf16* y = hi + r0 * LDW;
        bf16* gn = sw + L.g_offset((i - 1) & 1) + r0 * ldg;
        uint32_t nx[NS][4];
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          float a2[2][4];
          if (i == H) {
            mma_pair_smem<true>(gH, ldg, fo, wi, LDW, p, a2);
          } else {
            mma_pair_regs<NS, true>(gc, wi, LDW, p, a2);
          }
          pack_pair(nx[p], a2, [&](int j, int e, float v) {
            const float2 yy = unpack_bf16(slab_word(y, LDW, 16 * p, j));
            return act_bwd<ACT>(v, e ? yy.y : yy.x, m.act);
          });
          store_slab(gn, ldg, 16 * p, nx[p]);
        }
#pragma unroll
        for (int p = 0; p < NS; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) gc[p][j] = nx[p][j];
        __syncthreads();
      }
    }
    __syncthreads();  // wgrad's reads of h_0 and G_0 before the next tile writes them
  }

  // the register units into the block's partial, once
#pragma unroll
  for (int k = 0; k < K5_REG_UNITS; ++k) {
    const int u = k * n_warps + warp;
    if (u >= cap) break;
    int n_units = 0;
    for (int i = 0; i <= H; ++i) n_units += layer_units(m, i);
    if (u >= n_units) break;
    int ld;
    float* dst = gw_unit(m, partial, u, &ld);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; e += 2) *unit_pair(dst, ld, q, e / 2) = make_float2(acc[k][q][e], acc[k][q][e + 1]);
  }
}

static bool valid_k5(const K5Layout& L) {
  const MlpArgs& m = L.m;
  return L.nt >= 16 && L.nt <= 128 && L.nt % 16 == 0 && m.n_hidden >= 1 && m.in_w > 0 &&
         m.in_w % 16 == 0 && m.out_w > 0 && m.out_w % 16 == 0;
}

// fn(the kernel instantiation for this width and these activations)
template <class Fn>
static int with_kernel(const MlpArgs& m, Fn&& fn) {
  return with_acts(m.act, m.out_act, [&](auto act, auto out_act) {
    constexpr int A = decltype(act)::value, O = decltype(out_act)::value;
    switch (m.width) {
      case 16: return fn(mlp_bwd_kernel<16, A, O>);
      case 32: return fn(mlp_bwd_kernel<32, A, O>);
      case 64: return fn(mlp_bwd_kernel<64, A, O>);
      case 128: return fn(mlp_bwd_kernel<128, A, O>);
      default: return -(int)cudaErrorInvalidValue;
    }
  });
}

}  // namespace tcnn

// The persistent grid of tcnn_mlp_bwd over B rows in tiles of nt
// (resident_grid: > 0 blocks, 0 when no block fits, -cudaError).
extern "C" int tcnn_mlp_bwd_grid(int B, int nt, int in_w, int width, int n_hidden, int out_w,
                                 int act, int out_act, int device) {
  using namespace tcnn;
  const K5Layout L{MlpArgs{nullptr, in_w, width, n_hidden, out_w, act, out_act}, nt};
  if (!valid_k5(L)) return -(int)cudaErrorInvalidValue;
  return with_kernel(L.m, [&](auto kernel) {
    return resident_grid(kernel, nt * 2, L.bytes(), device, ((long)B + nt - 1) / nt);
  });
}

// `grid` blocks, as tcnn_mlp_bwd_grid gave them; `partials` holds grid x
// n_weights f32.
extern "C" int tcnn_mlp_bwd(const void* x, const void* gy, const void* weights, void* gw, void* gx,
                            void* partials, int grid, int B, int nt, int in_w, int width,
                            int n_hidden, int out_w, int act, int out_act, int device,
                            void* stream) {
  using namespace tcnn;
  const MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  const K5Layout L{m, nt};
  if (!valid_k5(L) || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long n_tiles = ((long)B + nt - 1) / nt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const int rc = with_kernel(m, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.bytes());
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, nt * 2, L.bytes(), s>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(gy), m, nt,
                                           static_cast<bf16*>(gx), part, B, n_tiles);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc < 0 ? -rc : rc;
  const size_t n_weights = flat_offset(m, n_hidden + 1);
  return launch_reduce(part, grid, n_weights, n_weights, static_cast<float*>(gw), s);
}
