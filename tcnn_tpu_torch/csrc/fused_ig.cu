// K9: the fused input-gradient backward of a grid + fully fused MLP model.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_ig_kernel_vt / _ig_kernel
//   (through fused_ig_grads, from fused_apply_ig's backward): per tile the
//   recomputed grid + MLP forward, the MLP backward from an external raw
//   output cotangent (no loss, no normalisation, no loss_scale), the grid
//   scatter and dL/dx from the encoding's gradient and the unweighted
//   corner features (train_kernel.py:2075-2103).
// What bounds it on this card: K6's (fused_train.cu) gather and scatter,
//   with the SDF config's 8 corners per level in place of config_hash's 4,
//   plus a second read of each corner's feature row for dL/dx. Its main path
//   runs it on the eikonal term's 1024 points, where launch latency bounds it.
// What the design does about it: K6 with the IG flag of fused_train_kernel
//   (fused_train.cuh: the mma.sync register chain, g split into bf16 hi +
//   lo, the weight gradient in registers across tiles): the raw cotangent
//   enters where K6's external dL/dy does; g stays at about f32 precision
//   through the chain, as _ig_kernel keeps g in f32 (train_kernel.py:
//   2033-2048); the scatter walks the corners with K7's device function
//   (grid_level_bwd_ig), which also leaves each (row, level)'s dL/dx partial
//   in shared memory; one thread per (row, dim) then sums the row's levels
//   in order, deterministically and in the twin's order. The tile is chosen
//   before launch with the partials' bytes counted (train_kernel.ig_tile).
#include "fused_train.cuh"

TCNN_TRAIN_INSTANCE(extern, 1, true)
TCNN_TRAIN_INSTANCE(extern, 2, true)
TCNN_TRAIN_INSTANCE(extern, 4, true)
TCNN_TRAIN_INSTANCE(extern, 8, true)

// K9's persistent grid (as tcnn_fused_train_grid), for ig = L * D f32 dL/dx
// partials per row.
extern "C" int tcnn_fused_ig_grid(int B, int F, int ig, int nt, int in_w, int width, int n_hidden,
                                  int out_w, int act, int out_act, int device) {
  using namespace tcnn;
  const TrainLayout L{MlpArgs{nullptr, in_w, width, n_hidden, out_w, act, out_act}, nt, ig, 0};
  if (!valid_train_layout(L) || ig < 1) return -(int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return train_grid<1, true>(L, device, B);
    case 2: return train_grid<2, true>(L, device, B);
    case 4: return train_grid<4, true>(L, device, B);
    case 8: return train_grid<8, true>(L, device, B);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// K9: the fused input-gradient backward from the raw output cotangent gy
// [B, out_w] f32 (no loss, no normalisation, no loss_scale), into the flat
// gradient `grads` (zeroed by the caller) and dL/dx `gx` [B, D]; `grid`
// blocks as tcnn_fused_ig_grid gave them.
extern "C" int tcnn_fused_ig(const void* x, const void* table, const void* level_i32,
                             const void* level_f32, const void* weights, const void* gy,
                             void* grads, void* gx, void* partials, int grid, int B, int D, int F,
                             int L, int interp, unsigned f0, unsigned f1, unsigned f2,
                             unsigned f3, int hash, int nt, int in_w, int width, int n_hidden, int out_w,
                             int act, int out_act, int device, void* stream) {
  using namespace tcnn;
  const MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  const TrainLayout lay{m, nt, L * D, 0};
  if (!valid_train_layout(lay) || grid < 1 || D < 1 || D > 4 || in_w < L * F ||
      interp == INTERP_NEAREST)
    return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  LossArgs la{static_cast<const float*>(gy), nullptr, nullptr, 0, out_w, 1.f, 1.f};
  float* gr = static_cast<float*>(grads);
  float* gxp = static_cast<float*>(gx);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_train<1, true>(g, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 2: return launch_fused_train<2, true>(g, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 4: return launch_fused_train<4, true>(g, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 8: return launch_fused_train<8, true>(g, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
