// A warp's MLP layer on mma.sync with the activations in registers, shared
// by K2 (mlp_fwd.cu), K3 (fused_infer.cu), K5 (mlp_bwd.cu) and K6 / K9
// (fused_train.cuh).
//
// A warp owns 16 rows. Each product is mma.sync.m16n8k16 (bf16 in, f32
// accumulate; PTX ISA "Matrix Fragments for mma.m16n8k16"). With
// g = lane / 4 and t = lane % 4, a thread holds
//   A (16 x 16, row-major), four bf16x2 words: a0 = A[g][2t, 2t+1],
//     a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, k x n), two: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, f32), four: C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// So the C fragments of the n8 tiles 2p and 2p+1, rounded to bf16 and
// packed in pairs, are exactly the A fragment of the next layer's k16 slab
// p: a layer's output stays in registers as the next layer's input, with
// the activation applied to the f32 accumulators on the way (pack_act).
//
// The activations are template parameters (ACT, OUT_ACT): a kernel built
// for the main paths' pair (ReLU hidden, None out) applies them with no
// branch; -1 reads the code at run time through apply_act's switch, whose
// inlined branches in the unrolled fragment loops cost K5 more than half
// its time (scripts/ablate_mlp_kernels.py).
//
// B fragments come from the weights in shared memory by ldmatrix. The
// weights sit there per layer as row-major [fan_out, fan_in] with a row
// pitch of fan_in + 8 (frag_weight_elems): a multiple of 16 elements plus
// 8, so the eight 16-byte rows of every 8x8 matrix fall in distinct banks.
// Every other shared tile of K2, K3 and K5 is padded the same way. y = x W^T
// reads W's rows as B's columns directly (ldmatrix); dgrad's G W and
// wgrad's G^T h read their operands transposed (ldmatrix .trans).
//
// K6 and K9 keep the gradient g at about f32 precision as two bf16 A
// operands, hi = bf16(g) and lo = bf16(g - hi) (hi + lo carries 16
// significant bits): each product runs once for hi and once for lo into the
// same f32 accumulators (mma_pair_split_*), and each result is split again
// (split_pair).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "mlp_common.cuh"

namespace tcnn {

// The flat MLP's weights in shared memory: every layer's [fan_out, fan_in]
// at a row pitch of fan_in + 8 (elements).
__host__ __device__ inline int frag_fan_in(const MlpArgs& m, int i) {
  return i == 0 ? m.in_w : m.width;
}
__host__ __device__ inline int frag_fan_out(const MlpArgs& m, int i) {
  return i == m.n_hidden ? m.out_w : m.width;
}
__host__ __device__ inline size_t frag_w_offset(const MlpArgs& m, int i) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) off += (size_t)frag_fan_out(m, j) * (frag_fan_in(m, j) + 8);
  return off;
}
__host__ __device__ inline size_t frag_weight_elems(const MlpArgs& m) {
  return frag_w_offset(m, m.n_hidden + 1);
}

// The shared memory of a K2 or K3 block of `warps` warps: the padded
// weights, then each warp's 16 input rows at a pitch of in_w + 8
// (ops/cuda/mlp_kernel.py:frag_tile_smem_bytes counts the same).
inline size_t frag_tile_smem_bytes(const MlpArgs& m, int warps) {
  return (frag_weight_elems(m) + (size_t)warps * 16 * (m.in_w + 8)) * sizeof(bf16);
}

// Warps of a K2 or K3 block: the most of 8, 4, 2, 1 whose shared memory
// fits `limit` bytes, else 0 (mlp_kernel.py:frag_tile_warps).
inline int frag_tile_warps(const MlpArgs& m, size_t limit) {
  int warps = 8;
  while (warps > 0 && frag_tile_smem_bytes(m, warps) > limit) warps /= 2;
  return warps;
}

// Block-wide copy of the flat weights into the padded layout (16-byte
// chunks; fan_in is a multiple of 16).
__device__ __forceinline__ void load_weights_padded(const MlpArgs& m, bf16* sw) {
  const uint4* src = reinterpret_cast<const uint4*>(m.weights);
  for (int i = 0; i <= m.n_hidden; ++i) {
    const int chunks = frag_fan_in(m, i) / 8, n = frag_fan_out(m, i) * chunks;
    bf16* dst = sw + frag_w_offset(m, i);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      *reinterpret_cast<uint4*>(dst + (e / chunks) * (chunks * 8 + 8) + (e % chunks) * 8) =
          src[e];
    }
    src += n;
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane i supplying the address
// of row i % 8 of matrix i / 8; thread (g, t) receives row g, columns 2t and
// 2t+1 of each (with .trans: row 2t and 2t+1, column g).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  }
}

// This lane's row address for an ldmatrix.x4 of the 16x16 block at (row0,
// col0) of a row-major tile of pitch ld, its four 8x8 matrices taken rows
// first: (row0, col0), (row0 + 8, col0), (row0, col0 + 8), (row0 + 8,
// col0 + 8) ...
__device__ __forceinline__ const bf16* rows_first(const bf16* base, int ld, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  return base + (row0 + (lane & 7) + (lane & 8)) * ld + col0 + ((lane >> 4) << 3);
}
// ... or columns first: (row0, col0), (row0, col0 + 8), (row0 + 8, col0),
// (row0 + 8, col0 + 8).
__device__ __forceinline__ const bf16* cols_first(const bf16* base, int ld, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  return base + (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 + (lane & 8);
}

// The B fragments of the n8 tiles 2p, 2p+1 at k16 slab s, {b0, b1} each:
// of W^T for y = x W^T (W [n, k] row-major), or of W for dgrad's G W (W
// [k, n] row-major, TRANS).
template <bool TRANS>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const bf16* w, int ldw, int p, int s) {
  if (TRANS) {
    ldsm_x4<true>(b, rows_first(w, ldw, 16 * s, 16 * p));
  } else {
    ldsm_x4<false>(b, cols_first(w, ldw, 16 * p, 16 * s));
  }
}

// acc[q] (the n8 tiles 2p + q) = A B over k = 0..16*NS, A in registers.
template <int NS, bool TRANS>
__device__ __forceinline__ void mma_pair_regs(const uint32_t (&a)[NS][4], const bf16* w, int ldw,
                                              int p, float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t b[4];
    b_frags<TRANS>(b, w, ldw, p, s);
    mma_bf16(acc[0], a[s], b[0], b[1]);
    mma_bf16(acc[1], a[s], b[2], b[3]);
  }
}

// The same with A read from the 16 rows at `a` (shared memory, pitch lda),
// k = 0..k_len (a multiple of 16).
template <bool TRANS>
__device__ __forceinline__ void mma_pair_smem(const bf16* a, int lda, int k_len, const bf16* w,
                                              int ldw, int p, float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int s = 0; s < k_len / 16; ++s) {
    uint32_t af[4], b[4];
    ldsm_x4<false>(af, rows_first(a, lda, 0, 16 * s));
    b_frags<TRANS>(b, w, ldw, p, s);
    mma_bf16(acc[0], af, b[0], b[1]);
    mma_bf16(acc[1], af, b[2], b[3]);
  }
}

// acc[q] (the n8 tiles 2p + q) = (Ahi + Alo) B over k = 0..16*NS, the hi and
// lo A fragments in registers: per k16 slab, the hi product, then the lo one.
template <int NS, bool TRANS>
__device__ __forceinline__ void mma_pair_split_regs(const uint32_t (&hi)[NS][4],
                                                    const uint32_t (&lo)[NS][4], const bf16* w,
                                                    int ldw, int p, float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t b[4];
    b_frags<TRANS>(b, w, ldw, p, s);
    mma_bf16(acc[0], hi[s], b[0], b[1]);
    mma_bf16(acc[1], hi[s], b[2], b[3]);
    mma_bf16(acc[0], lo[s], b[0], b[1]);
    mma_bf16(acc[1], lo[s], b[2], b[3]);
  }
}

// The same with hi and lo read from the warp's 16 rows at `hi` and `lo`
// (shared memory, pitch lda), k = 0..k_len (a multiple of 16).
template <bool TRANS>
__device__ __forceinline__ void mma_pair_split_smem(const bf16* hi, const bf16* lo, int lda,
                                                    int k_len, const bf16* w, int ldw, int p,
                                                    float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int s = 0; s < k_len / 16; ++s) {
    uint32_t ah[4], al[4], b[4];
    ldsm_x4<false>(ah, rows_first(hi, lda, 0, 16 * s));
    ldsm_x4<false>(al, rows_first(lo, lda, 0, 16 * s));
    b_frags<TRANS>(b, w, ldw, p, s);
    mma_bf16(acc[0], ah, b[0], b[1]);
    mma_bf16(acc[1], ah, b[2], b[3]);
    mma_bf16(acc[0], al, b[0], b[1]);
    mma_bf16(acc[1], al, b[2], b[3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Word j of a slab's A fragment holds row frag_row(j) (of the warp's 16),
// columns frag_col(j) and frag_col(j) + 1 (of the slab's 16).
__device__ __forceinline__ int frag_row(int j) { return ((threadIdx.x & 31) >> 2) + (j & 1) * 8; }
__device__ __forceinline__ int frag_col(int j) { return (threadIdx.x & 3) * 2 + (j >> 1) * 8; }

// The A fragment of a slab from the pair's accumulators: word j takes C
// fragment j / 2 (the n8 tile), elements 2(j % 2) and 2(j % 2) + 1 (row
// g + 8 (j % 2)), each through fn(f32) and rounded to bf16.
template <class Fn>
__device__ __forceinline__ void pack_pair(uint32_t (&a)[4], const float (&acc)[2][4], Fn&& fn) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = j >> 1, e = (j & 1) * 2;
    a[j] = pack_bf16(fn(j, 0, acc[q][e]), fn(j, 1, acc[q][e + 1]));
  }
}

// pack_pair's split: v = fn(j, e, f32) for each element, then the hi A
// fragment of bf16(v) and the lo one of bf16(v - bf16(v)) (v - bf16(v) is
// exact in f32).
template <class Fn>
__device__ __forceinline__ void split_pair(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&acc)[2][4], Fn&& fn) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = j >> 1, e = (j & 1) * 2;
    const float v0 = fn(j, 0, acc[q][e]), v1 = fn(j, 1, acc[q][e + 1]);
    hi[j] = pack_bf16(v0, v1);
    const float2 h = unpack_bf16(hi[j]);
    lo[j] = pack_bf16(v0 - h.x, v1 - h.y);
  }
}

// The activation, fixed when ACT >= 0 (apply_act's switch folds away), else
// `act`, read at run time; act_bwd likewise for act_bwd_out.
template <int ACT>
__device__ __forceinline__ float act_fwd(float z, int act) {
  return apply_act(z, ACT >= 0 ? ACT : act);
}
template <int ACT>
__device__ __forceinline__ float act_bwd(float g, float y, int act) {
  return act_bwd_out(g, y, ACT >= 0 ? ACT : act);
}

template <int ACT>
__device__ __forceinline__ void pack_act(uint32_t (&a)[4], const float (&acc)[2][4], int act) {
  pack_pair(a, acc, [&](int, int, float z) { return act_fwd<ACT>(z, act); });
}

// fn(ACT, OUT_ACT) with both as std::integral_constant: fixed for the main
// paths' pair (ReLU hidden, None out), -1 (read at run time) otherwise.
template <class Fn>
inline int with_acts(int act, int out_act, Fn&& fn) {
  using std::integral_constant;
  if (act == ACT_RELU && out_act == ACT_NONE) {
    return fn(integral_constant<int, ACT_RELU>{}, integral_constant<int, ACT_NONE>{});
  }
  return fn(integral_constant<int, -1>{}, integral_constant<int, -1>{});
}

// A slab (16 rows of the warp, 16 columns from col0) to or from a row-major
// shared tile of pitch ld, one 4-byte word a thread (bank-conflict free at
// the padded pitches).
__device__ __forceinline__ void store_slab(bf16* s, int ld, int col0, const uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(s + frag_row(j) * ld + col0 + frag_col(j)) = a[j];
  }
}

__device__ __forceinline__ uint32_t slab_word(const bf16* s, int ld, int col0, int j) {
  return *reinterpret_cast<const uint32_t*>(s + frag_row(j) * ld + col0 + frag_col(j));
}

// Stores a slab to rows row0..row0+15, columns col0..col0+15 of a row-major
// global [B, ld] bf16 matrix as 16-byte row pieces, skipping rows at or past
// B. The four lanes of a quad swap words so that lane t holds columns
// 8(t % 2)..8(t % 2)+7 of row g + 8(t / 2): lane t wants word
// want(t) = {a0, a2, a1, a3}[t] of every quad lane s, at position s; in
// round k it receives from lane (t + k) % 4, which sends the word that
// lane (t - k) % 4 wants.
__device__ __forceinline__ void store_slab_rows(bf16* out, int ld, long row0, long B, int col0,
                                                const uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  auto pick = [&](int d) {  // want(d)
    const int j = ((d & 1) << 1) | (d >> 1);
    return j == 0 ? a[0] : j == 1 ? a[1] : j == 2 ? a[2] : a[3];
  };
  uint32_t got[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    got[k] = __shfl_sync(0xffffffffu, pick((t - k) & 3), (lane & ~3) | ((t + k) & 3));
  }
  // position s came in round (s - t) % 4
  auto at = [&](int s) {
    const int k = (s - t) & 3;
    return k == 0 ? got[0] : k == 1 ? got[1] : k == 2 ? got[2] : got[3];
  };
  const long row = row0 + (lane >> 2) + (t >> 1) * 8;
  if (row < B) {
    *reinterpret_cast<uint4*>(out + row * ld + col0 + (t & 1) * 8) =
        make_uint4(at(0), at(1), at(2), at(3));
  }
}

// Weight-gradient units of K5 and K6 / K9: 16x16 blocks of each layer's gW
// [fan_out, fan_in], numbered layer by layer, row-major within a layer. Unit
// u belongs to warp u % n_warps, in its register slot u / n_warps while that
// is below the kernel's register budget (K5_REG_UNITS, TRAIN_REG_UNITS).
__host__ __device__ inline int layer_units(const MlpArgs& m, int i) {
  return (frag_fan_out(m, i) / 16) * (frag_fan_in(m, i) / 16);
}
// flat offset of layer i's gW in the [n_weights] gradient
__host__ __device__ inline size_t flat_offset(const MlpArgs& m, int i) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) off += (size_t)frag_fan_out(m, j) * frag_fan_in(m, j);
  return off;
}
// unit u's first float in the flat gradient, and its row pitch
__device__ __forceinline__ float* gw_unit(const MlpArgs& m, float* gw, int u, int* ld) {
  int i = 0;
  while (u >= layer_units(m, i)) u -= layer_units(m, i++);
  const int cb = frag_fan_in(m, i) / 16;
  *ld = frag_fan_in(m, i);
  return gw + flat_offset(m, i) + (size_t)(u / cb) * 16 * *ld + (u % cb) * 16;
}

// This thread's two floats of element pair (g + 8 half, 8 q + 2t) of a
// unit's C fragments in the flat gradient
__device__ __forceinline__ float2* unit_pair(float* dst, int ld, int q, int half) {
  const int lane = threadIdx.x & 31;
  return reinterpret_cast<float2*>(dst + ((lane >> 2) + 8 * half) * ld + 8 * q + 2 * (lane & 3));
}

// The forward chain of the warp's 16 rows, from x (shared memory, pitch
// ldx, m.in_w columns) through every layer on the tensor cores: the hidden
// layers' outputs stay in registers, and keep(i, p, slab) sees slab p of
// layer i's bf16 output h_i (i = 1..n_hidden); last(p, slab) sees slab p of
// the output (out_act applied, bf16).
template <int WIDTH, int ACT, int OUT_ACT, class Keep, class Last>
__device__ __forceinline__ void frag_forward(const MlpArgs& m, const bf16* sw, const bf16* x,
                                             int ldx, Keep&& keep, Last&& last) {
  constexpr int NS = WIDTH / 16;
  constexpr int LDW = WIDTH + 8;
  uint32_t h[NS][4];
#pragma unroll
  for (int p = 0; p < NS; ++p) {
    float acc[2][4];
    mma_pair_smem<false>(x, ldx, m.in_w, sw, m.in_w + 8, p, acc);
    pack_act<ACT>(h[p], acc, m.act);
    keep(1, p, h[p]);
  }
  const bf16* w = sw + (size_t)WIDTH * (m.in_w + 8);
  for (int i = 1; i < m.n_hidden; ++i) {
    uint32_t nx[NS][4];
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      float acc[2][4];
      mma_pair_regs<NS, false>(h, w, LDW, p, acc);
      pack_act<ACT>(nx[p], acc, m.act);
      keep(i + 1, p, nx[p]);
    }
#pragma unroll
    for (int p = 0; p < NS; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[p][j] = nx[p][j];
    w += (size_t)WIDTH * LDW;
  }
  for (int p = 0; p < m.out_w / 16; ++p) {
    float acc[2][4];
    mma_pair_regs<NS, false>(h, w, LDW, p, acc);
    uint32_t o[4];
    pack_act<OUT_ACT>(o, acc, m.out_act);
    last(p, o);
  }
}

}  // namespace tcnn
