// The fused grid + MLP training kernel shared by K6 (fused_train.cu: the
// train step) and K9 (fused_ig.cu: the input-gradient backward), one
// template, fused_train_kernel<F, IG, WIDTH, ACT, OUT_ACT>; each source
// instantiates its own half, so the two build in parallel. See
// fused_train.cu and fused_ig.cu for what each replaces and what bounds it.
//
// The MLP runs on mlp_frag.cuh's mma.sync register chain, as K3's and K5's
// do. Per tile of nt rows (nt / 16 warps, 16 rows each):
//   1. each warp gathers its own rows' encoding into h_0 with K1's
//      per-(sample, level) walker, with no block barrier before its forward,
//      so that other warps' gathers overlap a warp's MLP;
//   2. frag_forward runs the layers from registers, storing each hidden
//      output once (h_1..h_H) for the activation transfer and wgrad;
//   3. the loss takes its value and gradient per element from the output
//      layer's packed bf16 fragments (the luminance loss gets the row's
//      first three predictions from lanes 0 and 1 of the quad by __shfl_sync),
//      through the output activation, split into bf16 hi + lo (the gout tile);
//   4. the backward keeps g at about f32 precision as hi + lo, every dgrad
//      product run for each (mlp_frag.cuh: mma_pair_split_*), the activation
//      transfer on the f32 accumulators and the result split again; up to
//      width 64 G stays in registers between layers (mma_pair_split_regs),
//      at width 128 the warp reads its rows back from the G tile it stores
//      for wgrad (registers: 2 x 64 a thread for G alone). Each layer's G is
//      stored once for wgrad, which reads G^T (hi and lo) and h by
//      ldmatrix.trans in 16x16 units: a warp keeps TRAIN_REG_UNITS of them in
//      registers across every tile it walks (the block writes its partial
//      once, at the end), the rest go through the block's L2 partial once a
//      tile; the first layer's dgrad leaves the f32 encoding gradient `fin`;
//   5. the scatter walks fin (K4's private levels and vector atomics;
//      K9: grid_level_bwd_ig and sum_level_parts).
// Barriers: one after the weights' load, one after the loss (wgrad reads
// every warp's rows), one after each layer's dgrad; K9 one more before its
// level sums.
//
// Shared-memory layout (TrainLayout; ops/cuda/mlp_kernel.py:bwd_smem_bytes
// counts the same bytes):
//   [weights, padded (mlp_frag.cuh: frag_weight_elems)]
//   [h_0: nt x (in_w+8) bf16][h_1..h_H: nt x (width+8) bf16]
//   [gout: hi, lo, each nt x (out_w+8) bf16: the output layer's G]
//   [G tile 0: hi, lo, each nt x (width+8) bf16]
//   [G tile 1: the same, or fin, nt x (in_w+1) f32, if larger]
//   [K9 only: nt x L*D f32, the dL/dx partials of each (row, level)]
//   [K6 only: the f32 table gradient of the leading dense levels the block
//       keeps private (`priv` floats), added to with shared atomics]
// G_i (i < H) sits in tile i % 2 and fin in tile 1 (G_0 is in tile 0). Only
// gout and the h tiles are written before a tile's barrier after the loss,
// so a warp may start the next tile while others still scatter from fin.
// fin's odd pitch keeps the scatter's 32 rows of one level in 32 banks.
#pragma once

#include "grid_common.cuh"
#include "mlp_frag.cuh"

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

// 16x16 weight-gradient units a warp keeps in registers (8 f32 a thread
// each): 32 at 8 warps, config_hash's and the SDF config's 28 among them
// (tests/test_torch_mlp_layouts.py copies the plan). Eight a warp (all 28
// at 64-row tiles) took K6 from 0.834 to 0.873 ms at config_hash
// (scripts/ablate_k6_phases.py reg-units-8; H100 80GB HBM3, 700 W).
constexpr int TRAIN_REG_UNITS = 4;

struct TrainLayout {
  MlpArgs m;
  int nt;
  int ig;    // K9: f32 dL/dx partials per row (L * D); 0 otherwise
  int priv;  // K6: f32 private table-gradient floats; 0 otherwise

  __host__ __device__ int ld_h(int i) const { return (i == 0 ? m.in_w : m.width) + 8; }
  __host__ __device__ int ld_o() const { return m.out_w + 8; }
  __host__ __device__ int ld_g() const { return m.width + 8; }
  __host__ __device__ int ld_f() const { return m.in_w + 1; }
  __host__ __device__ size_t n_weights() const { return flat_offset(m, m.n_hidden + 1); }
  // byte offsets from the block's base
  __host__ __device__ size_t h_offset(int i) const {
    size_t off = frag_weight_elems(m) * 2;
    if (i > 0) off += (size_t)nt * ld_h(0) * 2 + (size_t)(i - 1) * nt * ld_h(1) * 2;
    return off;
  }
  __host__ __device__ size_t gout_offset() const { return h_offset(m.n_hidden + 1); }
  __host__ __device__ size_t g_bytes() const { return (size_t)2 * nt * ld_g() * 2; }
  __host__ __device__ size_t g_offset(int k) const {
    return gout_offset() + (size_t)2 * nt * ld_o() * 2 + k * g_bytes();
  }
  __host__ __device__ size_t ig_offset() const {
    const size_t fin = (size_t)nt * ld_f() * 4;
    return g_offset(1) + (fin > g_bytes() ? fin : g_bytes());
  }
  __host__ __device__ size_t priv_offset() const { return ig_offset() + (size_t)nt * ig * 4; }
  __host__ __device__ size_t bytes() const { return priv_offset() + (size_t)priv * 4; }
  // floats of a block's partial: the weights' gradient, then the private
  // levels', padded to 8 floats so that every slice stays 32-byte aligned
  __host__ __device__ size_t n_partial() const { return n_weights() + ((size_t)priv + 7) / 8 * 8; }
};

// c += G^T h over the tile's nt rows for the unit at (o0, c0), G as hi and
// lo [nt, fan_out] and h [nt, fan_in], all read transposed from shared
// memory: per row slab, the hi product, then the lo one.
__device__ __forceinline__ void unit_mma_split(float (&c)[2][4], const bf16* ghi, const bf16* glo,
                                               int ldg, const bf16* h, int ldh, int nt, int o0,
                                               int c0) {
#pragma unroll 2
  for (int r = 0; r < nt; r += 16) {
    uint32_t ah[4], al[4], b[4];
    ldsm_x4<true>(ah, cols_first(ghi, ldg, r, o0));
    ldsm_x4<true>(al, cols_first(glo, ldg, r, o0));
    ldsm_x4<true>(b, rows_first(h, ldh, r, c0));
    mma_bf16(c[0], ah, b[0], b[1]);
    mma_bf16(c[1], ah, b[2], b[3]);
    mma_bf16(c[0], al, b[0], b[1]);
    mma_bf16(c[1], al, b[2], b[3]);
  }
}

// IG (K9): the raw output cotangent in place of the loss (la.code == 0), no
// loss sum, and dL/dx into gx [B, D] from the encoding's f32 gradient.
// K6 keeps the table gradient of levels 0..n_private-1 (L.priv floats) in
// shared memory and leaves it in its partial after the weights'; K9 keeps
// none (n_private = 0, L.priv = 0).
template <int F, bool IG, int WIDTH, int ACT, int OUT_ACT>
__global__ void __launch_bounds__(256, 1)
    fused_train_kernel(GridArgs g, MlpArgs m, TrainLayout L, LossArgs la,
                       float* __restrict__ gtable, float* __restrict__ partials,
                       float* __restrict__ loss_sum, float* __restrict__ gx, long B, int n_active,
                       int n_private, long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = WIDTH / 16, LDW = WIDTH + 8, R = TRAIN_REG_UNITS;
  constexpr bool G_REGS = WIDTH <= 64;
  const int nt = L.nt, H = m.n_hidden;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int r0 = warp * 16, ld0 = L.ld_h(0), ldo = L.ld_o(), ldg = L.ld_g(), ldf = L.ld_f();
  const int cap = R * n_warps;
  const size_t n_weights = L.n_weights();
  bf16* sw = reinterpret_cast<bf16*>(smem);
  auto h_tile = [&](int i) { return reinterpret_cast<bf16*>(smem + L.h_offset(i)); };
  auto g_hi = [&](int k) { return reinterpret_cast<bf16*>(smem + L.g_offset(k)); };
  bf16* h0 = h_tile(0);
  bf16* gout = reinterpret_cast<bf16*>(smem + L.gout_offset());  // hi, then lo
  float* fin = reinterpret_cast<float*>(smem + L.g_offset(1));
  float* partial = partials + (size_t)blockIdx.x * L.n_partial();
  float* priv = reinterpret_cast<float*>(smem + L.priv_offset());
  float acc[R][2][4];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][q][e] = 0.f;

  load_weights_padded(m, sw);
  for (int i = threadIdx.x; i < L.priv; i += blockDim.x) priv[i] = 0.f;
  // the padding columns of the warp's rows of h_0, which the gather never writes
  const int enc = g.L * F, pad = m.in_w - enc;
  for (int p = lane; p < 16 * pad; p += 32) {
    h0[(r0 + p / pad) * ld0 + enc + p % pad] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  float loss_acc = 0.f;

  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = tile * nt, wrow0 = row0 + r0;
    const bool first = tile == blockIdx.x;
    // 1. gather the warp's rows: zero past B and past n_active
    for (int p = lane; p < 16 * g.L; p += 32) {
      const int r = p / g.L, l = p % g.L;
      float v[F];
      if (wrow0 + r < B && l < n_active) {
        grid_level<F>(g, wrow0 + r, l, v);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.f;
      }
      store_bf16<F>(h0 + (r0 + r) * ld0 + l * F, v);
    }
    __syncwarp();
    // 2-3. forward, keeping h_1..h_H; the loss (or the external dL) from the
    //      output fragments through the output activation, split into gout
    float lum[2] = {0.f, 0.f};
    frag_forward<WIDTH, ACT, OUT_ACT>(
        m, sw, h0 + r0 * ld0, ld0,
        [&](int i, int p, const uint32_t(&a)[4]) {
          store_slab(h_tile(i) + r0 * LDW, LDW, 16 * p, a);
        },
        [&](int p, const uint32_t(&o)[4]) {
          if (la.code == 3 && p == 0) {
            // the row's predictions 0-2: words 0 (row g) and 1 (row g + 8)
            // of quad lanes 0 (columns 0, 1) and 1 (columns 2, 3)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 a = unpack_bf16(__shfl_sync(0xffffffffu, o[j], lane & ~3));
              const float2 b = unpack_bf16(__shfl_sync(0xffffffffu, o[j], (lane & ~3) | 1));
              const long row = wrow0 + frag_row(j);
              float p0 = a.x, p1 = a.y, p2 = b.x;
              if (la.noise && row < B) {
                const float* nz = la.noise + row * m.out_w;
                p0 += nz[0];
                p1 += nz[1];
                p2 += nz[2];
              }
              lum[j] = 0.299f * p0 + 0.587f * p1 + 0.114f * p2;
            }
          }
          float gv[2][4];  // [n8 tile][C element], as split_pair reads them
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long row = wrow0 + frag_row(j);
            const float2 y = unpack_bf16(o[j]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 16 * p + frag_col(j) + e;
              float v = 0.f;
              if (row < B) {
                if (la.code == 0) {
                  v = la.targets[row * m.out_w + c];
                } else if (c < la.dims) {
                  const float pr = (e ? y.y : y.x) + (la.noise ? la.noise[row * m.out_w + c] : 0.f);
                  const float2 vg =
                      loss_eval(la.code, pr, la.targets[row * la.dims + c],
                                la.pdf ? la.pdf[row * la.dims + c] : 1.f, la.n, lum[j & 1]);
                  loss_acc += vg.x;
                  v = vg.y * la.loss_scale;
                }
              }
              gv[j >> 1][(j & 1) * 2 + e] = act_bwd<OUT_ACT>(v, e ? y.y : y.x, m.out_act);
            }
          }
          uint32_t hi[4], lo[4];
          split_pair(hi, lo, gv, [](int, int, float v) { return v; });
          store_slab(gout + r0 * ldo, ldo, 16 * p, hi);
          store_slab(gout + (size_t)nt * ldo + r0 * ldo, ldo, 16 * p, lo);
        });
    __syncthreads();

    // 4. backward, layer by layer from the output
    uint32_t gc_hi[G_REGS ? NS : 1][4], gc_lo[G_REGS ? NS : 1][4];  // G_i of the warp's rows
    int base = 0;
    for (int i = 0; i < H; ++i) base += layer_units(m, i);
    for (int i = H; i >= 0; --i) {
      const bf16* ghi = i == H ? gout : g_hi(i & 1);
      const int ld = i == H ? ldo : ldg;
      const bf16* glo = ghi + (size_t)nt * ld;
      const bf16* hi_ = h_tile(i);
      const int fi = frag_fan_in(m, i), cb = fi / 16, ldh = L.ld_h(i);
      const int n_i = layer_units(m, i);
      // wgrad: this warp's units of layer i, in registers ...
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int u = k * n_warps + warp - base;
        if (u >= 0 && u < n_i) {
          unit_mma_split(acc[k], ghi, glo, ld, hi_, ldh, nt, (u / cb) * 16, (u % cb) * 16);
        }
      }
      // ... and past the registers, through the block's partial
      const int start = base > cap ? base : cap;
      for (int u = start + ((warp - start) % n_warps + n_warps) % n_warps; u < base + n_i;
           u += n_warps) {
        const int lu = u - base, o0 = (lu / cb) * 16, c0 = (lu % cb) * 16;
        float* dst = partial + flat_offset(m, i) + (size_t)o0 * fi + c0;
        float c[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float2 v = first ? make_float2(0.f, 0.f) : *unit_pair(dst, fi, q, e / 2);
            c[q][e] = v.x;
            c[q][e + 1] = v.y;
          }
        unit_mma_split(c, ghi, glo, ld, hi_, ldh, nt, o0, c0);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; e += 2) *unit_pair(dst, fi, q, e / 2) = make_float2(c[q][e], c[q][e + 1]);
      }

      // dgrad: G W_i for the warp's rows, from gout (i = H), G_i's registers
      // (up to width 64) or G_i's tile (width 128)
      const bf16* wi = sw + frag_w_offset(m, i);
      const int ldw = fi + 8;
      auto dgrad = [&](int p, float (&a2)[2][4]) {
        if (i == H) {
          mma_pair_split_smem<true>(ghi + r0 * ld, glo + r0 * ld, ld, m.out_w, wi, ldw, p, a2);
        } else if constexpr (G_REGS) {
          mma_pair_split_regs<NS, true>(gc_hi, gc_lo, wi, ldw, p, a2);
        } else {
          mma_pair_split_smem<true>(ghi + r0 * ld, glo + r0 * ld, ld, WIDTH, wi, ldw, p, a2);
        }
      };
      if (i == 0) {
        // the encoding's f32 gradient into fin
        for (int p = 0; p < m.in_w / 16; ++p) {
          float a2[2][4];
          dgrad(p, a2);
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              fin[(r0 + (lane >> 2) + 8 * (e >> 1)) * ldf + 16 * p + 8 * q + 2 * (lane & 3) +
                  (e & 1)] = a2[q][e];
            }
        }
      } else {
        // G_{i-1} = act'(G_i W_i), the transfer from layer i-1's kept output
        // h_i, split into hi + lo, into G tile (i-1) % 2 (and registers)
        const bf16* y = hi_ + r0 * LDW;
        bf16* nhi = g_hi((i - 1) & 1) + r0 * ldg;
        bf16* nlo = nhi + (size_t)nt * ldg;
        uint32_t nx_hi[G_REGS ? NS : 1][4], nx_lo[G_REGS ? NS : 1][4];
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          float a2[2][4];
          dgrad(p, a2);
          uint32_t sh[4], sl[4];
          split_pair(sh, sl, a2, [&](int j, int e, float v) {
            const float2 yy = unpack_bf16(slab_word(y, LDW, 16 * p, j));
            return act_bwd<ACT>(v, e ? yy.y : yy.x, m.act);
          });
          store_slab(nhi, ldg, 16 * p, sh);
          store_slab(nlo, ldg, 16 * p, sl);
          if constexpr (G_REGS) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              nx_hi[p][j] = sh[j];
              nx_lo[p][j] = sl[j];
            }
          }
        }
        if constexpr (G_REGS) {
#pragma unroll
          for (int p = 0; p < NS; ++p)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              gc_hi[p][j] = nx_hi[p][j];
              gc_lo[p][j] = nx_lo[p][j];
            }
        }
        base -= layer_units(m, i - 1);
      }
      __syncthreads();
    }

    // 5. scatter from fin (its tile is written again only after the next
    //    tile's barrier after the loss); K9 also leaves each (row, level)'s
    //    dL/dx partial in shared memory and sums each row's levels in order,
    //    as K7 does
    if (IG) {
      float* gxs = reinterpret_cast<float*>(smem + L.ig_offset());
      const int D = g.D;
      for (int p = threadIdx.x; p < nt * g.L; p += blockDim.x) {
        const int r = p / g.L, l = p % g.L;
        const long row = row0 + r;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < B) grid_level_bwd_ig<F>(g, row, l, fin + r * ldf + l * F, gtable, part);
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
        if (row < B) grid_level_bwd<F>(g, row, l, fin + r * ldf + l * F, gtable, priv, l < n_private);
      }
    }
  }

  // the register units into the block's partial, once
  int n_units = 0;
  for (int i = 0; i <= H; ++i) n_units += layer_units(m, i);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int u = k * n_warps + warp;
    if (u < n_units) {
      int ld;
      float* dst = gw_unit(m, partial, u, &ld);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          *unit_pair(dst, ld, q, e / 2) = make_float2(acc[k][q][e], acc[k][q][e + 1]);
        }
    }
  }
  if (IG) return;

  // the private levels' gradient into the partial, after the weights', for
  // the fixed-order reduce
  __syncthreads();
  for (int i = threadIdx.x; i < L.priv; i += blockDim.x) partial[n_weights + i] = priv[i];
  // the block's loss: warp sums, then one atomic (G tile 0 is free now)
  float* sums = reinterpret_cast<float*>(smem + L.g_offset(0));
  for (int o = 16; o > 0; o /= 2) loss_acc += __shfl_down_sync(0xffffffffu, loss_acc, o);
  if (lane == 0) sums[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += sums[w];
    atomicAdd(loss_sum, s);
  }
}

static bool valid_train_layout(const TrainLayout& L) {
  const MlpArgs& m = L.m;
  return L.nt >= 16 && L.nt <= 128 && L.nt % 16 == 0 && m.n_hidden >= 1 && m.in_w > 0 &&
         m.in_w % 16 == 0 && m.out_w > 0 && m.out_w % 16 == 0 && L.priv >= 0 && L.ig >= 0;
}

// fn(the kernel instantiation for this width and these activations), or
// -cudaErrorInvalidValue for a width the kernels do not take
template <int F, bool IG, class Fn>
static int with_train_kernel(const MlpArgs& m, Fn&& fn) {
  return with_acts(m.act, m.out_act, [&](auto act, auto out_act) {
    constexpr int A = decltype(act)::value, O = decltype(out_act)::value;
    switch (m.width) {
      case 16: return fn(fused_train_kernel<F, IG, 16, A, O>);
      case 32: return fn(fused_train_kernel<F, IG, 32, A, O>);
      case 64: return fn(fused_train_kernel<F, IG, 64, A, O>);
      case 128: return fn(fused_train_kernel<F, IG, 128, A, O>);
      default: return -(int)cudaErrorInvalidValue;
    }
  });
}

// The persistent grid of a launch over B rows (resident_grid: > 0 blocks, 0
// when no block fits, -cudaError).
template <int F, bool IG>
int train_grid(const TrainLayout& L, int device, long B) {
  return with_train_kernel<F, IG>(L.m, [&](auto kernel) {
    return resident_grid(kernel, L.nt * 2, L.bytes(), device, (B + L.nt - 1) / L.nt);
  });
}

template <int F, bool IG>
int launch_fused_train(const GridArgs& g, const TrainLayout& L, const LossArgs& la, float* grads,
                       float* partials, float* loss_sum, float* gx, long B, int n_active,
                       int n_private, int grid, int device, cudaStream_t stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long n_tiles = (B + L.nt - 1) / L.nt;
  const int rc = with_train_kernel<F, IG>(L.m, [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes());
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, L.nt * 2, L.bytes(), stream>>>(g, L.m, L, la, grads + L.n_weights(), partials,
                                                  loss_sum, gx, B, n_active, n_private, n_tiles);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc < 0 ? -rc : rc;
  // the weights' gradient and, right after it in [network | table], the
  // private levels' rows 0..priv/F-1
  return launch_reduce(partials, grid, L.n_partial(), L.n_weights() + L.priv, grads, stream);
}

}  // namespace tcnn

// The (F, IG) instantiation's host functions: `extern` in the entry points'
// sources (fused_train.cu, fused_ig.cu), defined in a source of their own
// (fused_train_f<F>.cu, fused_ig_f<F>.cu), one nvcc each, so that the eight
// halves (8 kernels each) build in parallel.
#define TCNN_TRAIN_INSTANCE(EXTERN, F, IG)                                                     \
  namespace tcnn {                                                                            \
  EXTERN template int train_grid<F, IG>(const TrainLayout&, int, long);                      \
  EXTERN template int launch_fused_train<F, IG>(const GridArgs&, const TrainLayout&,         \
                                                const LossArgs&, float*, float*, float*,     \
                                                float*, long, int, int, int, int,            \
                                                cudaStream_t);                               \
  }
