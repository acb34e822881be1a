// K5's split plan: the fully fused MLP backward as a dgrad kernel and a
// split-K weight-gradient kernel, for the shapes whose resident plan
// (mlp_bwd.cu) cannot give a block 4 warps (ops/cuda/mlp_kernel.py:
// mlp_bwd_plan).
//
// Replaces: tcnn_tpu/ops/pallas/mlp_kernel.py:_bwd_kernel, as K5 does, at
//   those shapes: the same roundings (h_i and G_i in bf16, products summed
//   in f32); only the f32 summation order of gW differs.
// What bounds it on this card: at config_oneblob (128 -> 128 x 5 -> 16,
//   B = 2^18) the padded weights take 178 KB of a block's 227 KB, so the
//   resident plan keeps 16-row tiles, one warp an SM, and carries 324 of its
//   328 weight-gradient units through L2 every tile. Split, the backward
//   moves 1.57 GB of device memory (x and gy read, h_1..h_5 and G_0..G_5
//   written once as bf16 and read once, dL/dinput written) and computes
//   132 GFLOP: bytes bound it at ~0.47 ms.
// What the design does about it: mlp_dgrad_kernel is K2's plan (every
//   padded weight resident, up to 8 warps of 16 rows walking tiles on their
//   own, no barrier after the weights' load). A warp recomputes the forward
//   from registers (forward_slabs: frag_forward with each layer's slabs k
//   outer, 16 accumulators in flight instead of 2 at width 128, the same
//   bits; 0.78 -> 0.70 ms at config_oneblob), writing each kept output h_i
//   once to device memory as 16-byte row pieces, then runs the dgrad chain
//   from registers (k outer too): G_H = bf16(out_act'(gy)) from its own
//   shared slice, each G_{i-1} = bf16(act'(G_i W_i)), each written once;
//   dL/dinput = G_0 W_0 as K5 writes it. ReLU's transfer reads only y > 0,
//   so under ReLU the
//   forward keeps h_i's signs as bits in shared memory (8 bytes a lane a
//   layer); any other activation reads back the row pieces of h_i that the
//   lane itself wrote (load_slab_piece), which cost 0.24 of 1.01 ms at
//   config_oneblob (H100, read back from device memory and L2).
//   mlp_wgrad_kernel computes gW_i = G_i^T h_i, a product whose depth is the
//   batch: persistent blocks each own a contiguous slice of rows and walk
//   the layers; for each, the block holds the layer's whole gW in registers
//   (16 warps of WGRAD_RO x WGRAD_RC 16x16 units: 32 f32 a thread at 128 x
//   128; a wider layer takes more passes over the slice), fed by a cp.async
//   ring of WGRAD_STAGES stages of WGRAD_ROWS rows, and writes its partial
//   once. reduce_partials (common.cuh) sums the partials in a fixed order,
//   so gW is the same bits run to run; no float atomics.
#include "mlp_frag.cuh"

namespace tcnn {

// Rows of G_i and h_i a cp.async stage of mlp_wgrad_kernel holds, its
// stages, a warp's rectangle of 16x16 units and the block's threads
// (mlp_kernel.py mirrors them: WGRAD_ROWS, WGRAD_STAGES, WGRAD_RECT,
// WGRAD_WARPS).
constexpr int WGRAD_ROWS = 64;
constexpr int WGRAD_STAGES = 3;
constexpr int WGRAD_RO = 2, WGRAD_RC = 2;
constexpr int WGRAD_THREADS = 512;

// Scratch of the split plan, bf16, B rows each: h_1..h_H [B, width] one
// after another, then G_0..G_{H-1} [B, width] and G_H [B, out_w].
__host__ __device__ inline size_t kept_offset(const MlpArgs& m, long B, int i) {
  return (size_t)(i - 1) * B * m.width;
}
__host__ __device__ inline size_t grad_offset(const MlpArgs& m, long B, int i) {
  return (size_t)i * B * m.width;
}

// mlp_dgrad_kernel's shared memory a warp past the weights: its 16 input
// rows (pitch in_w + 8), its 16 rows of G_H (pitch out_w + 8), then the
// signs of its rows of h_1..h_H, 8 bytes a lane a layer (read under ReLU
// only).
__host__ __device__ inline size_t dgrad_slice_elems(const MlpArgs& m) {
  return (size_t)16 * (m.in_w + 8) + (size_t)16 * (m.out_w + 8) + (size_t)128 * m.n_hidden;
}

// The bit of a lane's 64 sign bits a layer that holds y > 0 of word j of
// slab p's A fragment (low element; the high one is the next bit): slabs
// 0-3 in the first 32 bits, 4-7 in the second.
__host__ __device__ constexpr int sign_bit(int p, int j) { return ((p % 4) * 4 + j) * 2; }
inline size_t dgrad_smem_bytes(const MlpArgs& m, int warps) {
  return (frag_weight_elems(m) + (size_t)warps * dgrad_slice_elems(m)) * sizeof(bf16);
}
// Warps of a mlp_dgrad_kernel block: the most of 8, 4, 2, 1 that fit
// `limit` bytes, else 0 (mlp_kernel.py:mlp_dgrad_warps).
inline int dgrad_warps(const MlpArgs& m, size_t limit) {
  int warps = 8;
  while (warps > 0 && dgrad_smem_bytes(m, warps) > limit) warps /= 2;
  return warps;
}

// mlp_wgrad_kernel's ring: each stage WGRAD_ROWS rows of G_i (pitch
// fan_out + 8) then of h_i (pitch fan_in + 8), sized for the widest layer.
__host__ __device__ inline size_t wgrad_stage_elems(const MlpArgs& m) {
  const int fo = m.width > m.out_w ? m.width : m.out_w;
  const int fi = m.width > m.in_w ? m.width : m.in_w;
  return (size_t)WGRAD_ROWS * (fo + 8 + fi + 8);
}
inline size_t wgrad_smem_bytes(const MlpArgs& m) {
  return WGRAD_STAGES * wgrad_stage_elems(m) * sizeof(bf16);
}

// acc[p] = A B for every output slab p of a width-16 NS layer at once (the
// n8 tiles 2p, 2p + 1; B fragments as mma_pair_regs takes them), k outer:
// 2 NS independent accumulators in flight where mma_pair_regs keeps 2, each
// summed over k in mma_pair_regs's order, so the same bits. A in registers
// ...
template <int NS, bool TRANS>
__device__ __forceinline__ void mma_slabs_regs(const uint32_t (&a)[NS][4], const bf16* w, int ldw,
                                               float (&acc)[NS][2][4]) {
#pragma unroll
  for (int p = 0; p < NS; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      uint32_t b[4];
      b_frags<TRANS>(b, w, ldw, p, s);
      mma_bf16(acc[p][0], a[s], b[0], b[1]);
      mma_bf16(acc[p][1], a[s], b[2], b[3]);
    }
}
// ... or in the warp's 16 rows at `a` (shared memory, pitch lda), k = 0..k_len.
template <int NS, bool TRANS>
__device__ __forceinline__ void mma_slabs_smem(const bf16* a, int lda, int k_len, const bf16* w,
                                               int ldw, float (&acc)[NS][2][4]) {
#pragma unroll
  for (int p = 0; p < NS; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.f;
  for (int s = 0; s < k_len / 16; ++s) {
    uint32_t af[4];
    ldsm_x4<false>(af, rows_first(a, lda, 0, 16 * s));
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      uint32_t b[4];
      b_frags<TRANS>(b, w, ldw, p, s);
      mma_bf16(acc[p][0], af, b[0], b[1]);
      mma_bf16(acc[p][1], af, b[2], b[3]);
    }
  }
}

// frag_forward (mlp_frag.cuh) with each layer's slabs k outer
// (mma_slabs_*): the same bits, more products in flight a warp.
template <int WIDTH, int ACT, int OUT_ACT, class Keep, class Last>
__device__ __forceinline__ void forward_slabs(const MlpArgs& m, const bf16* sw, const bf16* x,
                                              int ldx, Keep&& keep, Last&& last) {
  constexpr int NS = WIDTH / 16, LDW = WIDTH + 8;
  uint32_t h[NS][4];
  float acc[NS][2][4];
  mma_slabs_smem<NS, false>(x, ldx, m.in_w, sw, m.in_w + 8, acc);
#pragma unroll
  for (int p = 0; p < NS; ++p) {
    pack_act<ACT>(h[p], acc[p], m.act);
    keep(1, p, h[p]);
  }
  const bf16* w = sw + (size_t)WIDTH * (m.in_w + 8);
  for (int i = 1; i < m.n_hidden; ++i) {
    mma_slabs_regs<NS, false>(h, w, LDW, acc);
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      pack_act<ACT>(h[p], acc[p], m.act);
      keep(i + 1, p, h[p]);
    }
    w += (size_t)WIDTH * LDW;
  }
  for (int p = 0; p < m.out_w / 16; ++p) {
    float a2[2][4];
    mma_pair_regs<NS, false>(h, w, LDW, p, a2);
    uint32_t o[4];
    pack_act<OUT_ACT>(o, a2, m.out_act);
    last(p, o);
  }
}

template <int WIDTH, int ACT, int OUT_ACT>
__global__ void __launch_bounds__(256, 1)
    mlp_dgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy, MlpArgs m,
                     bf16* __restrict__ h, bf16* __restrict__ g, bf16* __restrict__ gx, long B,
                     long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = WIDTH / 16, LDW = WIDTH + 8;
  bf16* sw = reinterpret_cast<bf16*>(smem);
  const int H = m.n_hidden;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int ldx = m.in_w + 8, ldg = m.out_w + 8, chunks = m.in_w / 8;
  bf16* xs = sw + frag_weight_elems(m) + (size_t)warp * dgrad_slice_elems(m);
  bf16* gs = xs + 16 * ldx;
  uint2* signs = reinterpret_cast<uint2*>(gs + 16 * ldg);
  bf16* g_out = g + grad_offset(m, B, H);

  load_weights_padded(m, sw);
  __syncthreads();

  for (long tile = (long)blockIdx.x * n_warps + warp; tile < n_tiles;
       tile += (long)gridDim.x * n_warps) {
    const long row0 = tile * 16;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = i - r * chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < B) v = reinterpret_cast<const uint4*>(x + (row0 + r) * m.in_w)[c];
      *reinterpret_cast<uint4*>(xs + r * ldx + c * 8) = v;
    }
    __syncwarp();
    // forward: h_1..h_H to device memory (under ReLU, their signs also as
    // bits in the warp's slice); G_H = bf16(out_act'(gy)) from the output's
    // bf16 values, into the slice and to device memory
    uint32_t bits[2] = {0u, 0u};
    forward_slabs<WIDTH, ACT, OUT_ACT>(
        m, sw, xs, ldx,
        [&](int i, int p, const uint32_t(&a)[4]) {
          store_slab_rows(h + kept_offset(m, B, i), WIDTH, row0, B, 16 * p, a);
          if constexpr (ACT == ACT_RELU) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t pos = (int16_t)(a[j] & 0xffffu) > 0,
                             pos_hi = (int16_t)(a[j] >> 16) > 0;
              bits[p / 4] |= (pos | pos_hi << 1) << sign_bit(p, j);
            }
            if (p == NS - 1) {
              signs[(i - 1) * 32 + lane] = make_uint2(bits[0], bits[1]);
              bits[0] = bits[1] = 0u;
            }
          }
        },
        [&](int p, const uint32_t(&o)[4]) {
          uint32_t gq[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long row = row0 + frag_row(j);
            const uint32_t gv = row < B ? *reinterpret_cast<const uint32_t*>(
                                              gy + row * m.out_w + 16 * p + frag_col(j))
                                        : 0u;
            const float2 y = unpack_bf16(o[j]), d = unpack_bf16(gv);
            gq[j] = pack_bf16(act_bwd<OUT_ACT>(d.x, y.x, m.out_act),
                              act_bwd<OUT_ACT>(d.y, y.y, m.out_act));
          }
          store_slab(gs, ldg, 16 * p, gq);
          store_slab_rows(g_out, m.out_w, row0, B, 16 * p, gq);
        });
    __syncwarp();

    // dgrad: G_{i-1} = bf16(act'(G_i W_i)) into registers and to device
    // memory, the transfer from h_i: under ReLU from its sign bits (y > 0
    // is all ReLU's transfer reads), else from the row pieces of h_i that
    // this lane wrote, read back from device memory
    uint32_t gc[NS][4];
    for (int i = H; i >= 1; --i) {
      const bf16* wi = sw + frag_w_offset(m, i);
      const bf16* hi = h + kept_offset(m, B, i);
      uint4 piece[NS];
      uint2 sg = make_uint2(0u, 0u);
      if constexpr (ACT == ACT_RELU) {
        sg = signs[(i - 1) * 32 + lane];
      } else {
#pragma unroll
        for (int p = 0; p < NS; ++p) piece[p] = load_slab_piece(hi, WIDTH, row0, B, 16 * p);
      }
      float acc[NS][2][4];
      if (i == H) {
        mma_slabs_smem<NS, true>(gs, ldg, m.out_w, wi, LDW, acc);
      } else {
        mma_slabs_regs<NS, true>(gc, wi, LDW, acc);
      }
      bf16* gn = g + grad_offset(m, B, i - 1);
#pragma unroll
      for (int p = 0; p < NS; ++p) {
        uint32_t y[4];
        if constexpr (ACT == ACT_RELU) {
          const uint32_t word = p < 4 ? sg.x : sg.y;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = word >> sign_bit(p, j);
            y[j] = (b & 1u ? 0x3f80u : 0u) | (b & 2u ? 0x3f800000u : 0u);  // 1 or 0
          }
        } else {
          slab_from_piece(y, piece[p]);
        }
        pack_pair(gc[p], acc[p], [&](int j, int e, float v) {
          const float2 yy = unpack_bf16(y[j]);
          return act_bwd<ACT>(v, e ? yy.y : yy.x, m.act);
        });
        store_slab_rows(gn, WIDTH, row0, B, 16 * p, gc[p]);
      }
    }
    // dL/dinput = G_0 W_0, bf16, as 16-byte row pieces
    for (int p = 0; p < m.in_w / 16; ++p) {
      float a2[2][4];
      mma_pair_regs<NS, true>(gc, sw, m.in_w + 8, p, a2);
      uint32_t o[4];
      pack_pair(o, a2, [](int, int, float v) { return v; });
      store_slab_rows(gx, m.in_w, row0, B, 16 * p, o);
    }
    __syncwarp();  // the chain's reads of the slice before the next tile writes it
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block b sums gW_i = G_i^T h_i over rows [b * rows, min(B, (b + 1) * rows))
// for every layer i into its partial (grid x n_weights f32).
__global__ void __launch_bounds__(WGRAD_THREADS, 1)
    mlp_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                     const bf16* __restrict__ g, MlpArgs m, float* __restrict__ partials, long B,
                     long rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RO = WGRAD_RO, RC = WGRAD_RC;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const size_t stage = wgrad_stage_elems(m);
  const int H = m.n_hidden;
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  const long r_begin = (long)blockIdx.x * rows;
  const long r_end = r_begin + rows < B ? r_begin + rows : B;
  const int n_chunks = r_end > r_begin ? (int)((r_end - r_begin + WGRAD_ROWS - 1) / WGRAD_ROWS) : 0;
  float* partial = partials + (size_t)blockIdx.x * flat_offset(m, H + 1);

  for (int i = 0; i <= H; ++i) {
    const int fo = frag_fan_out(m, i), fi = frag_fan_in(m, i);
    const int ldg = fo + 8, ldh = fi + 8, gch = fo / 8, per_row = (fo + fi) / 8;
    const bf16* gsrc = g + grad_offset(m, B, i);
    const bf16* hsrc = i == 0 ? x : h + kept_offset(m, B, i);
    const int n_ro = fo / 16, n_rc = fi / 16;
    const int rect_cols = (n_rc + RC - 1) / RC;
    const int n_rects = ((n_ro + RO - 1) / RO) * rect_cols;
    // chunk c's rows of G_i and h_i into stage c % WGRAD_STAGES, rows past
    // the block's slice zero-filled
    auto load = [&](int c) {
      bf16* gst = ring + (c % WGRAD_STAGES) * stage;
      bf16* hst = gst + WGRAD_ROWS * ldg;
      const long r0 = r_begin + (long)c * WGRAD_ROWS;
      for (int e = threadIdx.x; e < WGRAD_ROWS * per_row; e += blockDim.x) {
        const int r = e / per_row, k = e - r * per_row;
        const bool ok = r0 + r < r_end;
        const long row = ok ? r0 + r : r_begin;
        if (k < gch) {
          cp_async16(gst + r * ldg + k * 8, gsrc + row * fo + k * 8, ok);
        } else {
          cp_async16(hst + r * ldh + (k - gch) * 8, hsrc + row * fi + (k - gch) * 8, ok);
        }
      }
    };
    for (int rect0 = 0; rect0 < n_rects; rect0 += n_warps) {
      const int rect = rect0 + warp;
      const bool active = rect < n_rects;
      const int uo = (rect / rect_cols) * RO, uc = (rect % rect_cols) * RC;
      float acc[RO][RC][2][4];
#pragma unroll
      for (int a = 0; a < RO; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b)
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][q][e] = 0.f;

      for (int c = 0; c < WGRAD_STAGES - 1; ++c) {
        if (c < n_chunks) load(c);
        cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<WGRAD_STAGES - 2>();
        __syncthreads();  // chunk c has landed, and every warp is done with chunk c - 1
        if (c + WGRAD_STAGES - 1 < n_chunks) load(c + WGRAD_STAGES - 1);
        cp_async_commit();
        if (!active) continue;
        const bf16* gst = ring + (c % WGRAD_STAGES) * stage;
        const bf16* hst = gst + WGRAD_ROWS * ldg;
        const long left = r_end - (r_begin + (long)c * WGRAD_ROWS);
        const int live = left < WGRAD_ROWS ? (int)left : WGRAD_ROWS;
        for (int r = 0; r < live; r += 16) {
          uint32_t a[RO][4], b[RC][4];
#pragma unroll
          for (int ro = 0; ro < RO; ++ro)
            if (uo + ro < n_ro) ldsm_x4<true>(a[ro], cols_first(gst, ldg, r, 16 * (uo + ro)));
#pragma unroll
          for (int rc = 0; rc < RC; ++rc)
            if (uc + rc < n_rc) ldsm_x4<true>(b[rc], rows_first(hst, ldh, r, 16 * (uc + rc)));
#pragma unroll
          for (int ro = 0; ro < RO; ++ro)
#pragma unroll
            for (int rc = 0; rc < RC; ++rc)
              if (uo + ro < n_ro && uc + rc < n_rc) {
                mma_bf16(acc[ro][rc][0], a[ro], b[rc][0], b[rc][1]);
                mma_bf16(acc[ro][rc][1], a[ro], b[rc][2], b[rc][3]);
              }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring before the next pass fills it
      if (!active) continue;
#pragma unroll
      for (int ro = 0; ro < RO; ++ro)
#pragma unroll
        for (int rc = 0; rc < RC; ++rc) {
          if (uo + ro >= n_ro || uc + rc >= n_rc) continue;
          float* dst = partial + flat_offset(m, i) + (size_t)16 * (uo + ro) * fi + 16 * (uc + rc);
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; e += 2)
              *unit_pair(dst, fi, q, e / 2) = make_float2(acc[ro][rc][q][e], acc[ro][rc][q][e + 1]);
        }
    }
  }
}

// fn(the dgrad kernel instantiation for this width and these activations)
template <class Fn>
static int with_dgrad_kernel(const MlpArgs& m, Fn&& fn) {
  return with_acts(m.act, m.out_act, [&](auto act, auto out_act) {
    constexpr int A = decltype(act)::value, O = decltype(out_act)::value;
    switch (m.width) {
      case 16: return fn(mlp_dgrad_kernel<16, A, O>);
      case 32: return fn(mlp_dgrad_kernel<32, A, O>);
      case 64: return fn(mlp_dgrad_kernel<64, A, O>);
      case 128: return fn(mlp_dgrad_kernel<128, A, O>);
      default: return -(int)cudaErrorInvalidValue;
    }
  });
}

static bool valid_split(const MlpArgs& m) {
  return m.n_hidden >= 1 && m.in_w > 0 && m.in_w % 16 == 0 && m.out_w > 0 && m.out_w % 16 == 0;
}

static int optin_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return limit;
}

}  // namespace tcnn

// The persistent grid of mlp_wgrad_kernel over B rows (resident_grid: > 0
// blocks, 0 when no block fits, -cudaError): the partials hold grid x
// n_weights f32.
extern "C" int tcnn_mlp_bwd_split_grid(int B, int in_w, int width, int n_hidden, int out_w,
                                       int act, int out_act, int device) {
  using namespace tcnn;
  const MlpArgs m{nullptr, in_w, width, n_hidden, out_w, act, out_act};
  if (!valid_split(m) || B < 1) return -(int)cudaErrorInvalidValue;
  return resident_grid(mlp_wgrad_kernel, WGRAD_THREADS, wgrad_smem_bytes(m), device,
                       ((long)B + WGRAD_ROWS - 1) / WGRAD_ROWS);
}

// dgrad, then the weight gradient into `partials` (`grid` blocks, as
// tcnn_mlp_bwd_split_grid gave them) and their fixed-order sum into gw. `h`
// holds n_hidden x B x width bf16, `g` n_hidden x B x width + B x out_w.
extern "C" int tcnn_mlp_bwd_split(const void* x, const void* gy, const void* weights, void* gw,
                                  void* gx, void* h, void* g, void* partials, int grid, int B,
                                  int in_w, int width, int n_hidden, int out_w, int act,
                                  int out_act, int device, void* stream) {
  using namespace tcnn;
  const MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  if (!valid_split(m) || grid < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int warps = dgrad_warps(m, (size_t)optin_limit(device));
  if (warps == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xx = static_cast<const bf16*>(x);
  bf16* hh = static_cast<bf16*>(h);
  bf16* gg = static_cast<bf16*>(g);
  const long n_tiles = ((long)B + 15) / 16;
  const int rc = with_dgrad_kernel(m, [&](auto kernel) {
    const size_t smem = dgrad_smem_bytes(m, warps);
    const int blocks =
        resident_grid(kernel, warps * 32, smem, device, (n_tiles + warps - 1) / warps);
    if (blocks < 0) return -blocks;
    if (blocks == 0) return (int)cudaErrorInvalidValue;
    kernel<<<blocks, warps * 32, smem, s>>>(xx, static_cast<const bf16*>(gy), m, hh, gg,
                                            static_cast<bf16*>(gx), B, n_tiles);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc < 0 ? -rc : rc;
  const size_t smem = wgrad_smem_bytes(m);
  cudaError_t err =
      cudaFuncSetAttribute(mlp_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part = static_cast<float*>(partials);
  const long rows = ((long)B + grid - 1) / grid;
  mlp_wgrad_kernel<<<grid, WGRAD_THREADS, smem, s>>>(xx, hh, gg, m, part, B, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n_weights = flat_offset(m, n_hidden + 1);
  return launch_reduce(part, grid, n_weights, n_weights, static_cast<float*>(gw), s);
}
