// K9: the fused input-gradient backward of a grid + fully fused MLP model.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_ig_kernel_vt / _ig_kernel
//   (through fused_ig_grads, from fused_apply_ig's backward): per tile the
//   recomputed grid + MLP forward, the MLP backward from an external raw
//   output cotangent (no loss, no normalisation, no loss_scale), the grid
//   scatter and dL/dx from the encoding's gradient and the unweighted
//   corner features (train_kernel.py:2075-2103).
// What bounds it on this card: K6's (fused_train.cu) shared memory and
//   scatter, with the SDF config's 8 corners per level in place of
//   config_hash's 4, plus a second read of each corner's feature row for
//   dL/dx. At the SDF config and 128 rows a block holds 164 KB (K6's 146 KB
//   and 18 KB of dL/dx partials), so one block per SM.
// What the design does about it: K6 with the IG flag of fused_train_kernel
//   (fused_train.cuh): the raw cotangent enters where K6's external dL/dy
//   does; g stays at about f32 precision through the chain (split bf16 hi
//   + lo), as _ig_kernel keeps g in f32 (train_kernel.py:2033-2048); the
//   scatter walks the corners with K7's device function
//   (grid_level_bwd_ig), which also leaves each (row, level)'s dL/dx partial
//   in shared memory; one thread per (row, dim) then sums the row's levels
//   in order, deterministically and in the twin's order. The tile is chosen
//   before launch with the partials' bytes counted (train_kernel.ig_tile).
#include "fused_train.cuh"

// K9's persistent grid (as tcnn_fused_train_grid), for ig = L * D f32 dL/dx
// partials per row.
extern "C" int tcnn_fused_ig_grid(int B, int F, int ig, int nt, int in_w, int width, int n_hidden,
                                  int out_w, int device) {
  using namespace tcnn;
  const BwdLayout L{nt, in_w, width, n_hidden, out_w, 1, ig};
  if (!valid_layout(L) || ig < 1) return -(int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return persistent_grid(fused_train_kernel<1, true>, L, device, B);
    case 2: return persistent_grid(fused_train_kernel<2, true>, L, device, B);
    case 4: return persistent_grid(fused_train_kernel<4, true>, L, device, B);
    case 8: return persistent_grid(fused_train_kernel<8, true>, L, device, B);
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
  const BwdLayout lay{nt, in_w, width, n_hidden, out_w, 1, L * D};
  if (!valid_layout(lay) || grid < 1 || in_w < L * F || interp == INTERP_NEAREST)
    return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  LossArgs la{static_cast<const float*>(gy), nullptr, nullptr, 0, out_w, 1.f, 1.f};
  float* gr = static_cast<float*>(grads);
  float* gxp = static_cast<float*>(gx);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_train<1, true>(g, m, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 2: return launch_fused_train<2, true>(g, m, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 4: return launch_fused_train<4, true>(g, m, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    case 8: return launch_fused_train<8, true>(g, m, lay, la, gr, part, nullptr, gxp, B, L, 0, grid, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
