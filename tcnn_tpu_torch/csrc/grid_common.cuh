// One (sample, level) of the multiresolution grid, forward and backward:
// the forward grid_level is K3's alone (fused_infer.cu); the backwards are
// K4's (grid_bwd.cu) and the scatters of K6 and K9 (fused_train.cuh). K1
// (grid_fwd.cu) and the gather of K6 and K9 walk the same corners on lane
// pairs, grid_level_pair, and K7 (grid_bwd_ig.cu) and K8 (grid_bwd_bwd.cu)
// on lane pairs with derivatives, pair_levels .. pair_tiles.
//
// The arithmetic is written to round exactly where the plain PyTorch twin
// (ops/cuda/grid_kernel.py:_corners) and the JAX package round: every float
// multiply and add goes through __fmul_rn/__fadd_rn/__fsub_rn, which nvcc
// never contracts into an FMA. A contracted pos = x*scale + 0.5 would move
// floor(pos) at cell boundaries and send a sample to another cell. The
// corner weight is the product over d = 0..D-1 and the corners run over
// c = 0..C-1, in the twin's order. Cells are int32(floor(pos)) reinterpreted
// as uint32; strides, hashes and dense indices wrap in uint32
// (grid.py:256-291), and the row within a level is an exact integer modulo.
// K3's forward and the backwards visit the corners through one function,
// grid_corners, so all agree on every corner at cell boundaries;
// the stochastic scatter picks its one corner through the same position and
// row functions (grid_stoch_row). grid_level_pair and K7's and K8's
// pair_levels repeat the same operations in the same order with D fixed
// at compile time.
//
// Two options of every grid kernel (K1, K3, K4, K6, K7, K8, K9):
// - HashType.Rng (HASH_RNG): a hashed level indexes through rng_hash, the
//   PCG32 advance of common_device.h:663-677, on native 64-bit integers.
//   The TPU kernels read hashes precomputed outside them because Mosaic has
//   no uint64 (tcnn_tpu/ops/pallas/grid_kernel.py:99-103); here each thread
//   hashes its own corners. The advance walks the set bits of delta from
//   the lowest, with the 64 per-bit (mult, plus) constants of the seeded
//   generator in constant memory: all threads of a warp step through bit i
//   together, so each step reads one constant address, which the constant
//   cache broadcasts.
// - Stochastic interpolation (K4, K6): the table gradient of a (sample,
//   level) goes whole to one corner, bit d set where u < w_d. The draw u is
//   computed here from b * L + l (stoch_uniform, the JAX package's
//   jax.random.uniform(PRNGKey(1337), (B, L)) element), not read from a
//   [B, L] tensor: 20 Threefry rounds cost less than the 16.8 MB a step
//   would write and read back at config_hash's B = 2^18, and a kernel needs
//   no extra input or launch.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tcnn {

enum Interp { INTERP_NEAREST = 0, INTERP_LINEAR = 1, INTERP_SMOOTHSTEP = 2 };
enum Hash { HASH_FACTORS = 0, HASH_RNG = 1 };

struct GridArgs {
  const float* x;          // [B, D] f32
  const bf16* table;       // [total_rows, F] bf16
  const int* level_i32;    // [L, 8]: offset, size, use_hash, stride0..3, 0
  const float* level_f32;  // [L]: scale
  int D, L, interp;
  unsigned factors[4];     // hash factors (common_device.h:647-661)
  int hash;                // HASH_FACTORS or HASH_RNG
  int stochastic;          // K4, K6: the table gradient goes to one drawn corner
};

// The seeded PCG32 generator of the Rng hash and the per-bit (mult, plus)
// constants of its advance (pcg32.h:53-59, 145-166; ops/pcg32.py:
// advance_tables), for rng_hash's seed 1337.
struct RngTables {
  unsigned long long state, mult[64], plus[64];
};

__host__ __device__ constexpr RngTables rng_tables(unsigned long long seed) {
  constexpr unsigned long long kMult = 0x5851F42D4C957F2DULL;
  const unsigned long long inc = 3ULL;  // (initseq << 1) | 1 with initseq = 1
  RngTables t{};
  // seed(): state = 0, next() (state = inc), state += seed, next()
  t.state = (inc + seed) * kMult + inc;
  unsigned long long m = kMult, p = inc;
  for (int i = 0; i < 64; ++i) {
    t.mult[i] = m;
    t.plus[i] = p;
    p = (m + 1ULL) * p;
    m = m * m;
  }
  return t;
}

static __constant__ RngTables kRng = rng_tables(1337ULL);

// rng_hash (common_device.h:663-677) of the cell cc: delta = XOR_d
// (u64(cc[d]) << (d * (64 / D))), bits past 63 dropped; the generator
// advanced by delta; next_uint's output.
__device__ __forceinline__ unsigned rng_hash(const unsigned* cc, int D) {
  const int nbits = 64 / D;
  unsigned long long delta = 0ULL;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < D) delta ^= (unsigned long long)cc[d] << (d * nbits);
  }
  unsigned long long am = 1ULL, ap = 0ULL;
  for (int i = 0; delta != 0ULL; ++i, delta >>= 1) {
    if (delta & 1ULL) {
      am *= kRng.mult[i];
      ap = ap * kRng.mult[i] + kRng.plus[i];
    }
  }
  const unsigned long long s = am * kRng.state + ap;
  const unsigned xorshifted = (unsigned)(((s >> 18) ^ s) >> 27);
  const unsigned rot = (unsigned)(s >> 59);
  return (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
}

__device__ __forceinline__ unsigned rotl32(unsigned v, int r) {
  return (v << r) | (v >> (32 - r));
}

// The stochastic draw of flat index i = b * L + l: Threefry-2x32, 20 rounds,
// of the counter (i >> 32, i) under the key (0, 1337), its two words XORed,
// the top 23 bits as a float in [1, 2), minus 1 (ops/threefry.py).
__device__ __forceinline__ float stoch_uniform(unsigned long long i) {
  const unsigned ks[3] = {0u, 1337u, 0u ^ 1337u ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = (unsigned)(i >> 32) + ks[0], x1 = (unsigned)i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[r % 2][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (unsigned)(r + 1);
  }
  return __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

// The per-corner derivative terms of the input-gradient kernels (K7, K8,
// K9), in the twin's order (grid_kernel.py:_corners): term[d] is w_d (bit d
// of corner c set) or 1 - w_d; deriv[d], deriv2[d] are dw_d/dx_d and
// d2w_d/dx_d^2 (scale and 0 for Linear; 6t(1-t) scale and 6(1-2t) scale^2
// for Smoothstep).
struct CornerDerivs {
  int c, D;
  float term[4], deriv[4], deriv2[4];

  __device__ __forceinline__ float sgn(int d) const { return ((c >> d) & 1) ? 1.f : -1.f; }
  // product of the terms other than d and e, left to right; 1 when none
  __device__ __forceinline__ float prod_except(int d, int e) const {
    float p = 1.f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < D && k != d && k != e) {
        p = first ? term[k] : __fmul_rn(p, term[k]);
        first = false;
      }
    }
    return p;
  }
  // dW_c/dx_d = (s_d * prod_{d' != d} term_d') * dw_d
  __device__ __forceinline__ float dw(int d) const {
    return __fmul_rn(sgn(d) * prod_except(d, d), deriv[d]);
  }
  // d2W_c/dx_d dx_e: ((s_d s_e prod_{k not d, e} term_k) * dw_d) * dw_e off
  // the diagonal, (s_d * prod_{k != d} term_k) * d2w_d on it
  __device__ __forceinline__ float d2w(int d, int e) const {
    if (d == e) return __fmul_rn(sgn(d) * prod_except(d, d), deriv2[d]);
    return __fmul_rn(__fmul_rn(sgn(d) * sgn(e) * prod_except(d, e), deriv[d]), deriv[e]);
  }
};

// pos_fract (common_device.h:826-867) of sample b at level l: cell[d] and
// the weight w[d] (the fraction, or its smoothstep); with DERIV also k's
// deriv[d] and deriv2[d].
template <bool DERIV>
__device__ __forceinline__ void grid_position(const GridArgs& g, long b, int l, unsigned* cell,
                                              float* w, CornerDerivs& k) {
  const float scale = g.level_f32[l];
  const bool smooth = g.interp == INTERP_SMOOTHSTEP;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    cell[d] = 0u;
    w[d] = 0.f;
    k.deriv[d] = k.deriv2[d] = 0.f;
    if (d < g.D) {
      const float pos = __fadd_rn(__fmul_rn(g.x[b * g.D + d], scale), 0.5f);
      const float cf = floorf(pos);
      const float fr = __fsub_rn(pos, cf);
      cell[d] = (unsigned)(int)cf;
      w[d] = smooth ? __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr))) : fr;
      if (DERIV) {
        k.deriv[d] = smooth
            ? __fmul_rn(__fmul_rn(__fmul_rn(6.0f, fr), __fsub_rn(1.0f, fr)), scale)
            : scale;
        k.deriv2[d] = smooth
            ? __fmul_rn(__fmul_rn(__fmul_rn(6.0f, __fsub_rn(1.0f, __fmul_rn(2.0f, fr))), scale),
                        scale)
            : 0.f;
      }
    }
  }
}

// The absolute table row of the integer cell cc at the level whose constants
// are li (grid_index, common_device.h:690-707).
__device__ __forceinline__ unsigned level_row(const GridArgs& g, const int* li,
                                              const unsigned* cc) {
  const unsigned size = (unsigned)li[1];
  unsigned dense = 0u, hash = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d < g.D) {
      dense += cc[d] * (unsigned)li[3 + d];
      hash ^= cc[d] * g.factors[d];
    }
  }
  unsigned raw = dense;
  if (li[2] != 0) raw = g.hash == HASH_RNG ? rng_hash(cc, g.D) : hash;
  const unsigned idx = (size & (size - 1u)) == 0u ? (raw & (size - 1u)) : raw % size;
  return (unsigned)li[0] + idx;
}

// Calls fn(row, w) for corner c = 0..C-1 of sample b at level l: `row` is the
// absolute table row, `w` the corner weight (1 for Nearest). With DERIV
// (Linear or Smoothstep only) it calls fn(row, w, k), k the corner's
// CornerDerivs.
template <bool DERIV = false, class Fn>
__device__ __forceinline__ void grid_corners(const GridArgs& g, long b, int l, Fn&& fn) {
  const int* li = g.level_i32 + l * 8;
  const bool nearest = g.interp == INTERP_NEAREST;
  unsigned cell[4];
  float w[4];
  CornerDerivs k;
  k.D = g.D;
  grid_position<DERIV>(g, b, l, cell, w, k);

  const int n_corners = nearest ? 1 : (1 << g.D);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c < n_corners) {
      unsigned cc[4];
      float cw = 1.f;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const unsigned bit = (c >> d) & 1u;
        cc[d] = cell[d] + bit;
        if (d < g.D) {
          const float term = bit ? w[d] : __fsub_rn(1.0f, w[d]);
          cw = d == 0 ? term : __fmul_rn(cw, term);
          k.term[d] = term;
        }
      }
      const unsigned row = level_row(g, li, cc);
      if constexpr (DERIV) {
        k.c = c;
        fn(row, cw, k);
      } else {
        fn(row, nearest ? 1.f : cw);
      }
    }
  }
}

// The one corner that stochastic interpolation's table gradient of sample b
// at level l goes to (grid.h:284-299): bit d set where u < w_d, u the draw
// of b * L + l. Returns its absolute table row.
__device__ __forceinline__ unsigned grid_stoch_row(const GridArgs& g, long b, int l) {
  unsigned cell[4];
  float w[4];
  CornerDerivs k;
  grid_position<false>(g, b, l, cell, w, k);
  const float u = stoch_uniform((unsigned long long)b * (unsigned long long)g.L + l);
  unsigned cc[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) cc[d] = cell[d] + (u < w[d] ? 1u : 0u);
  return level_row(g, g.level_i32 + l * 8, cc);
}

// Forward: out[f] = sum over corners of w * table[row, f], in f32.
template <int F>
__device__ __forceinline__ void grid_level(const GridArgs& g, long b, int l, float* out) {
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = 0.f;
  grid_corners(g, b, l, [&](unsigned row, float cw) {
    float v[F];
    load_bf16<F>(g.table + (size_t)row * F, v);
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = __fadd_rn(out[f], __fmul_rn(v[f], cw));
  });
}

// A level's constants in registers (the lane-pair walkers): two 16-byte
// loads of its level_i32 row and its scale.
struct LevelConsts {
  unsigned offset, size, stride[4];
  float scale;
  bool hashed, pow2;
};

__device__ __forceinline__ LevelConsts level_consts(const GridArgs& g, int l) {
  const int4 c0 = reinterpret_cast<const int4*>(g.level_i32)[2 * l];
  const int4 c1 = reinterpret_cast<const int4*>(g.level_i32)[2 * l + 1];
  LevelConsts k;
  k.offset = (unsigned)c0.x;
  k.size = (unsigned)c0.y;
  k.hashed = c0.z != 0;
  k.pow2 = (k.size & (k.size - 1u)) == 0u;
  k.stride[0] = (unsigned)c0.w;
  k.stride[1] = (unsigned)c1.x;
  k.stride[2] = (unsigned)c1.y;
  k.stride[3] = (unsigned)c1.z;
  k.scale = g.level_f32[l];
  return k;
}

// The row of corner c (bit d of c: cell[d] + 1) at the level k, as
// level_row computes it, with D fixed at compile time: the index sums
// unroll over d < D with no test of D, and the row is reduced modulo the
// level's size only when it lies past it (a dense level's in-grid cells
// never do), which gives level_row's row.
template <int D>
__device__ __forceinline__ unsigned corner_row(const GridArgs& g, const LevelConsts& k,
                                               const unsigned* cell, int c) {
  unsigned cc[4] = {0u, 0u, 0u, 0u};
  unsigned dense = 0u, hash = 0u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    cc[d] = cell[d] + ((c >> d) & 1u);
    dense += cc[d] * k.stride[d];
    hash ^= cc[d] * g.factors[d];
  }
  unsigned idx = dense;
  if (k.hashed) idx = g.hash == HASH_RNG ? rng_hash(cc, D) : hash;
  if (idx >= k.size) idx = k.pow2 ? (idx & (k.size - 1u)) : idx % k.size;
  return k.offset + idx;
}

// The walker of K1 and of K6's and K9's gather (fused_train.cuh:
// gather_rows): two lanes of a warp, 2i and 2i + 1, serve levels 2j and
// 2j + 1 of one sample (items 0 and 1; l is either), lane 2i + q owning
// item q, with D fixed at compile time. For both items, the lane whose x bit (lane & 1)
// is k loads the 2^(D-1) corners whose bit 0 (their x bit) is k, corner
// 2j + k in slot j; so corners c and c ^ 1 of an item, which differ in x
// alone, go out in one load instruction: at a dense level, and at a hashed
// level under the Prime family's x factor 1 (CoherentPrime), they are
// neighbouring rows, most often in one 32-byte sector, which the two lanes
// then fetch once. Each lane computes both items' cells, loads for both,
// sends its partner the rows of the partner's item and receives those of
// its own (__shfl_xor_sync(..., 1): one 32-bit word a row up to F = 2),
// then sums its own item's 2^D corners in the twin's order c = 0, 1, ...,
// each weight the product over d = 0..D-1 and each term rounded as
// grid_corners and grid_level round: the twin's sum bit for bit. Nearest
// loads corner 0 alone (lane 2i, for both items). An item that is not
// active (its level at or past n_active, its sample past the batch) loads
// nothing and sums to zero, but its lanes still swap: every lane of the
// warp must reach the shuffles.
template <int F, int D>
__device__ __forceinline__ void grid_level_pair(const GridArgs& g, long b, int l, bool in_batch,
                                                int n_active, float* out) {
  using Raw = typename BfVec<F>::T;
  constexpr int H = 1 << (D - 1);
  const int xbit = threadIdx.x & 1;
  const bool smooth = g.interp == INTERP_SMOOTHSTEP, nearest = g.interp == INTERP_NEAREST;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = in_batch ? g.x[b * D + d] : 0.f;
  bool active[2];
  LevelConsts k[2];
  unsigned cell[2][D];
  float w[D];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int lq = (l & ~1) | q;
    active[q] = in_batch && lq < n_active;
    k[q] = level_consts(g, active[q] ? lq : 0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float pos = __fadd_rn(__fmul_rn(x[d], k[q].scale), 0.5f);
      const float cf = floorf(pos);
      cell[q][d] = (unsigned)(int)cf;
      if (q == xbit) {
        const float fr = __fsub_rn(pos, cf);
        w[d] = smooth ? __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr))) : fr;
      }
    }
  }
  Raw mine[2][H], theirs[H];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int c = 2 * j + xbit;
      mine[q][j] = Raw{};
      if (active[q] && !(nearest && c > 0)) {
        mine[q][j] = *reinterpret_cast<const Raw*>(
            g.table + (size_t)corner_row<D>(g, k[q], cell[q], c) * F);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) theirs[j] = shfl_pair(xbit ? mine[0][j] : mine[1][j]);
#pragma unroll
  for (int f = 0; f < F; ++f) out[f] = 0.f;
  if (!(xbit ? active[1] : active[0])) return;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    if (nearest && c > 0) break;
    float cw = 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float term = ((c >> d) & 1) ? w[d] : __fsub_rn(1.0f, w[d]);
      cw = d == 0 ? term : __fmul_rn(cw, term);
    }
    if (nearest) cw = 1.f;
    float v[F];
    unpack_bf16<F>((c & 1) == xbit ? (xbit ? mine[1][c >> 1] : mine[0][c >> 1]) : theirs[c >> 1],
                   v);
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = __fadd_rn(out[f], __fmul_rn(v[f], cw));
  }
}

// K7's and K8's walker (grid_bwd_ig.cu, grid_bwd_bwd.cu), K1's lane pairs
// with derivatives: lanes 2i and 2i + 1 of a warp serve levels l0 and
// l0 + 1 of one sample (items 0 and 1), lane 2i + q owning item q, with D
// fixed at compile time. pair_levels computes both items' positions in
// grid_position's operations and order; the lane whose x bit (lane & 1) is
// k takes corners 2j + k (j < 2^(D-1)) of both items: their rows
// (corner_row), their table-row loads, which put each x-pair (c, c ^ 1) of
// an item into one load instruction, and their table-gradient adds, which
// put the two rows of an x-pair into one atomic instruction (neighbouring
// rows at a dense level and, under CoherentPrime's x factor 1, at a hashed
// level for an even x cell). own_corner gives a lane all 2^D raw rows of
// its own item after the exchange (pair_swap), so that it sums its own
// corners c = 0, 1, ... in the twin's order. An item that is not active
// (its level at or past L, its sample past the batch) loads and adds
// nothing and its lane leaves zeros, but still takes part in the swaps.
template <int D>
struct PairLevels {
  LevelConsts k[2];
  bool active[2];
  unsigned cell[2][D];
  float w[2][D], deriv[2][D], deriv2[2][D];
};

template <int D>
__device__ __forceinline__ void pair_levels(const GridArgs& g, long b, int l0, bool in_batch,
                                            PairLevels<D>& p) {
  const bool smooth = g.interp == INTERP_SMOOTHSTEP;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = in_batch ? g.x[b * D + d] : 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    p.active[q] = in_batch && l0 + q < g.L;
    p.k[q] = level_consts(g, p.active[q] ? l0 + q : 0);
    const float scale = p.k[q].scale;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
      const float cf = floorf(pos);
      const float fr = __fsub_rn(pos, cf);
      p.cell[q][d] = (unsigned)(int)cf;
      p.w[q][d] = smooth ? __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr))) : fr;
      p.deriv[q][d] = smooth
          ? __fmul_rn(__fmul_rn(__fmul_rn(6.0f, fr), __fsub_rn(1.0f, fr)), scale)
          : scale;
      p.deriv2[q][d] = smooth
          ? __fmul_rn(__fmul_rn(__fmul_rn(6.0f, __fsub_rn(1.0f, __fmul_rn(2.0f, fr))), scale),
                      scale)
          : 0.f;
    }
  }
}

// Corner c's weight from the weights w[d], as grid_corners forms it.
template <int D>
__device__ __forceinline__ float corner_weight(const float* w, int c) {
  float cw = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float term = ((c >> d) & 1) ? w[d] : __fsub_rn(1.0f, w[d]);
    cw = d == 0 ? term : __fmul_rn(cw, term);
  }
  return cw;
}

// Corner c's CornerDerivs from one item's weights and derivatives.
template <int D>
__device__ __forceinline__ CornerDerivs corner_derivs(const float* w, const float* deriv,
                                                      const float* deriv2, int c) {
  CornerDerivs k;
  k.c = c;
  k.D = D;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    k.term[d] = 1.f;
    k.deriv[d] = k.deriv2[d] = 0.f;
    if (d < D) {
      k.term[d] = ((c >> d) & 1) ? w[d] : __fsub_rn(1.0f, w[d]);
      k.deriv[d] = deriv[d];
      k.deriv2[d] = deriv2[d];
    }
  }
  return k;
}

// The rows of this lane's corners 2j + (lane & 1) of both items (0 for an
// item that is not active).
template <int D>
__device__ __forceinline__ void pair_rows(const GridArgs& g, const PairLevels<D>& p,
                                          unsigned (&row)[2][1 << (D - 1)]) {
  const int xbit = threadIdx.x & 1;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < (1 << (D - 1)); ++j)
      row[q][j] = p.active[q] ? corner_row<D>(g, p.k[q], p.cell[q], 2 * j + xbit) : 0u;
}

// The raw rows of `tab` at this lane's corners of both items.
template <int F, int D>
__device__ __forceinline__ void pair_loads(const bf16* tab, const PairLevels<D>& p,
                                           const unsigned (&row)[2][1 << (D - 1)],
                                           typename BfVec<F>::T (&mine)[2][1 << (D - 1)]) {
  using Raw = typename BfVec<F>::T;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < (1 << (D - 1)); ++j)
      mine[q][j] = p.active[q] ? *reinterpret_cast<const Raw*>(tab + (size_t)row[q][j] * F) : Raw{};
}

// The exchange: theirs[j] = the partner's row 2j + (its x bit) of this
// lane's item (every lane of the warp calls it).
template <int F, int D>
__device__ __forceinline__ void pair_swap(const typename BfVec<F>::T (&mine)[2][1 << (D - 1)],
                                          typename BfVec<F>::T (&theirs)[1 << (D - 1)]) {
  const int xbit = threadIdx.x & 1;
#pragma unroll
  for (int j = 0; j < (1 << (D - 1)); ++j) theirs[j] = shfl_pair(xbit ? mine[0][j] : mine[1][j]);
}

// Corner c of this lane's own item, unpacked to f32.
template <int F, int D>
__device__ __forceinline__ void own_corner(const typename BfVec<F>::T (&mine)[2][1 << (D - 1)],
                                           const typename BfVec<F>::T (&theirs)[1 << (D - 1)],
                                           int c, float* v) {
  const int xbit = threadIdx.x & 1;
  unpack_bf16<F>((c & 1) == xbit ? (xbit ? mine[1][c >> 1] : mine[0][c >> 1]) : theirs[c >> 1], v);
}

// Backward (K4, K6): row += bf16(w * gy[f]) per corner, the contribution
// rounded to bf16 as the TPU kernel rounds it (grid_kernel.py:674-677), then
// added in f32. Stochastic: row += bf16(gy[f]) into the one drawn corner's
// row (grid_kernel.py:_bwd_stoch_kernel). A level the caller keeps private
// (`to_priv`: one of the leading dense levels, whose absolute rows all lie
// below the private slice's end because level 0 starts at table row 0) adds
// into the block's f32 slice `priv` in shared memory, one shared atomic per
// feature; any other level into the global gradient `gtable`, one vector
// atomic per corner (atomic_add_row). The two pointers stay apart so that
// each branch's atomics keep their address space; callers keep `to_priv`
// uniform across a warp.
template <int F>
__device__ __forceinline__ void grid_level_bwd(const GridArgs& g, long b, int l, const float* gy,
                                               float* __restrict__ gtable, float* priv,
                                               bool to_priv) {
  auto add = [&](unsigned row, const float* v) {
    if (to_priv) {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(priv + (size_t)row * F + f, v[f]);
    } else {
      atomic_add_row<F>(gtable + (size_t)row * F, v);
    }
  };
  float v[F];
  if (g.stochastic) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __bfloat162float(__float2bfloat16_rn(gy[f]));
    add(grid_stoch_row(g, b, l), v);
    return;
  }
  grid_corners(g, b, l, [&](unsigned row, float cw) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gy[f])));
    add(row, v);
  });
}

// Backward with input gradients (K9): the same bf16-rounded
// contributions, one scalar f32 atomic per feature into the global gradient
// (every level), plus each corner's
// feature row read again for dot = sum_f table[row, f] * gy[f], and
// part[d] += dot * dW_c/dx_d, summed over corners c = 0..C-1 in order
// (grid_kernel.py:884-921).
template <int F>
__device__ __forceinline__ void grid_level_bwd_ig(const GridArgs& g, long b, int l,
                                                  const float* gy, float* __restrict__ gtable,
                                                  float* part) {
  grid_corners<true>(g, b, l, [&](unsigned row, float cw, const CornerDerivs& k) {
    float v[F];
    load_bf16<F>(g.table + (size_t)row * F, v);
    float dot = __fmul_rn(v[0], gy[0]);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (f > 0) dot = __fadd_rn(dot, __fmul_rn(v[f], gy[f]));
      atomicAdd(gtable + (size_t)row * F + f,
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gy[f]))));
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (d < g.D) part[d] = __fadd_rn(part[d], __fmul_rn(dot, k.dw(d)));
    }
  });
}

// Per-sample sums over levels of the partials in shared memory `parts`
// [rows][L][D] of samples b0 .. b0 + rows - 1: out[b * D + d] = sum over
// l = 0..L-1, in order, of parts[b - b0][l][d], for b < B. One thread per
// (sample, dim); deterministic, and the twin's order
// (grid_kernel.py:_level_sum). K9 calls it on its tile's partials, K7 and
// K8 on theirs (pair_tiles).
__device__ __forceinline__ void sum_level_parts(const float* parts, int rows, int D, int L,
                                                long b0, long B, float* __restrict__ out) {
  for (int q = threadIdx.x; q < rows * D; q += blockDim.x) {
    const int r = q / D, d = q % D;
    const long b = b0 + r;
    if (b < B) {
      float acc = parts[r * L * D + d];
      for (int l = 1; l < L; ++l) acc = __fadd_rn(acc, parts[(r * L + l) * D + d]);
      out[b * D + d] = acc;
    }
  }
}

// The tile walk of K7 and K8. A block of blockDim.x / 32 warps takes tiles
// of kPairSamples * groups samples; within a tile, task t (t < groups *
// n_pairs, n_pairs = ceil(L / 2)) is sample group t / n_pairs at level
// pair t % n_pairs, and warp w takes tasks w, w + warps, ...: lane
// 2i + q serves sample 16 (t / n_pairs) + i of the tile at level
// 2 (t % n_pairs) + q. So every lane pair is one sample, whatever the
// parity of L (an odd L leaves item 1 of the last pair inactive).
// task(b, l0, part) runs one task and leaves the lane's own dL/dx partial
// in part[0..D); those land in shared memory `smem` [tile samples][L][D],
// and after the tile's tasks one thread per (sample, dim) sums them over
// levels in order (sum_level_parts) into out_x. tile_end(b0) runs after
// the sums. The walk is persistent: gridDim.x blocks take tiles
// blockIdx.x, +gridDim.x, ...
constexpr int kPairSamples = 16;
// The most threads a K7 / K8 block has (grid_kernel.py:IG_WARPS warps).
constexpr int kPairMaxThreads = 512;

template <int D, class Task, class TileEnd>
__device__ __forceinline__ void pair_tiles(const GridArgs& g, float* parts, long B, int groups,
                                           float* __restrict__ out_x, long n_tiles, Task&& task,
                                           TileEnd&& tile_end) {
  const int tile = kPairSamples * groups, n_pairs = (g.L + 1) >> 1;
  const int lane = threadIdx.x & 31, xbit = lane & 1;
  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long b0 = t * tile;
    for (int task_i = threadIdx.x >> 5; task_i < groups * n_pairs; task_i += blockDim.x >> 5) {
      const int s = (task_i / n_pairs) * kPairSamples + (lane >> 1);
      const int l0 = 2 * (task_i % n_pairs);
      float part[D];
      task(b0 + s, l0, part);
      if (b0 + s < B && l0 + xbit < g.L) {
#pragma unroll
        for (int d = 0; d < D; ++d) parts[(s * g.L + l0 + xbit) * D + d] = part[d];
      }
    }
    __syncthreads();
    sum_level_parts(parts, tile, D, g.L, b0, B, out_x);
    tile_end(b0);
    __syncthreads();
  }
}

// K7's and K8's shared memory a block: its tile's dL/dx (ct_x) partials.
inline size_t pair_smem(int groups, int L, int D) {
  return (size_t)kPairSamples * groups * L * D * sizeof(float);
}

inline long pair_n_tiles(long B, int groups) {
  const long tile = (long)kPairSamples * groups;
  return (B + tile - 1) / tile;
}

// fn(F, D) with both as std::integral_constant, for the F (1, 2, 4, 8) and
// D (1-4) that K7 and K8 are built for; `bad` for any other.
template <class Fn>
inline int with_f_d(int F, int D, int bad, Fn&& fn) {
  using std::integral_constant;
  auto dims = [&](auto f) {
    switch (D) {
      case 1: return fn(f, integral_constant<int, 1>{});
      case 2: return fn(f, integral_constant<int, 2>{});
      case 3: return fn(f, integral_constant<int, 3>{});
      case 4: return fn(f, integral_constant<int, 4>{});
      default: return bad;
    }
  };
  switch (F) {
    case 1: return dims(integral_constant<int, 1>{});
    case 2: return dims(integral_constant<int, 2>{});
    case 4: return dims(integral_constant<int, 4>{});
    case 8: return dims(integral_constant<int, 8>{});
    default: return bad;
  }
}

}  // namespace tcnn
