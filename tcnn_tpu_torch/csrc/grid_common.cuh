// One (sample, level) of the multiresolution grid, forward and backward,
// shared by K1 (grid_fwd.cu), K3 (fused_infer.cu), K4 (grid_bwd.cu) and K6
// (fused_train.cu).
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
// The forward and the backward visit the corners through one function,
// grid_corners, so both agree on every corner at cell boundaries.
#pragma once

#include "common.cuh"

namespace tcnn {

enum Interp { INTERP_NEAREST = 0, INTERP_LINEAR = 1, INTERP_SMOOTHSTEP = 2 };

struct GridArgs {
  const float* x;          // [B, D] f32
  const bf16* table;       // [total_rows, F] bf16
  const int* level_i32;    // [L, 8]: offset, size, use_hash, stride0..3, 0
  const float* level_f32;  // [L]: scale
  int D, L, interp;
  unsigned factors[4];     // hash factors (common_device.h:647-661)
};

// Calls fn(row, w) for corner c = 0..C-1 of sample b at level l: `row` is the
// absolute table row, `w` the corner weight (1 for Nearest).
template <class Fn>
__device__ __forceinline__ void grid_corners(const GridArgs& g, long b, int l, Fn&& fn) {
  const int* li = g.level_i32 + l * 8;
  const unsigned offset = (unsigned)li[0];
  const unsigned size = (unsigned)li[1];
  const bool use_hash = li[2] != 0;
  const float scale = g.level_f32[l];
  const bool nearest = g.interp == INTERP_NEAREST;

  unsigned cell[4];
  float w[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    cell[d] = 0u;
    w[d] = 0.f;
    if (d < g.D) {
      const float pos = __fadd_rn(__fmul_rn(g.x[b * g.D + d], scale), 0.5f);
      const float cf = floorf(pos);
      const float fr = __fsub_rn(pos, cf);
      cell[d] = (unsigned)(int)cf;
      w[d] = g.interp == INTERP_SMOOTHSTEP
                 ? __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr)))
                 : fr;
    }
  }

  const int n_corners = nearest ? 1 : (1 << g.D);
  const bool pow2 = (size & (size - 1u)) == 0u;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c < n_corners) {
      unsigned dense = 0u, hash = 0u;
      float cw = 1.f;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (d < g.D) {
          const unsigned bit = (c >> d) & 1u;
          const unsigned cc = cell[d] + bit;
          dense += cc * (unsigned)li[3 + d];
          hash ^= cc * g.factors[d];
          const float term = bit ? w[d] : __fsub_rn(1.0f, w[d]);
          cw = d == 0 ? term : __fmul_rn(cw, term);
        }
      }
      const unsigned raw = use_hash ? hash : dense;
      const unsigned idx = pow2 ? (raw & (size - 1u)) : raw % size;
      fn(offset + idx, nearest ? 1.f : cw);
    }
  }
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

// Backward: gtable[row, f] += bf16(w * gy[f]) in f32 atomics, the
// contribution rounded to bf16 as the TPU kernel rounds it
// (grid_kernel.py:674-677).
template <int F>
__device__ __forceinline__ void grid_level_bwd(const GridArgs& g, long b, int l, const float* gy,
                                               float* __restrict__ gtable) {
  grid_corners(g, b, l, [&](unsigned row, float cw) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float v = __bfloat162float(__float2bfloat16_rn(__fmul_rn(cw, gy[f])));
      atomicAdd(gtable + (size_t)row * F + f, v);
    }
  });
}

}  // namespace tcnn
