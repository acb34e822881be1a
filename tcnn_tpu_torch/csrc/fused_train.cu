// K6: the fused train step (grid gather -> MLP forward -> loss -> MLP
// backward -> grid scatter) of a grid + fully fused MLP model.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_kernel_vt (through
//   fused_train_grads, from Trainer.loss_and_grad_fn), for Linear, Smoothstep
//   and Nearest interpolation, the Prime-family hashes, the nine losses, a
//   data pdf, output noise, an external dL/doutput and max_level; and, as
//   options, train_kernel.py:_kernel (:968), where the JAX package sends
//   stochastic and Rng plans: the Rng hash in the gather and the scatter
//   (grid_common.cuh:rng_hash; each corner's row is hashed again in the
//   scatter rather than kept from the gather), and stochastic
//   interpolation's one-corner scatter of the active levels
//   (train_kernel.py:1221-1283).
// What bounds it on this card: the gather's and the scatter's random L2
//   traffic. At config_hash (B=2^18) the MLP's forward, dgrad and wgrad,
//   with g's hi and lo halves, come to ~19 GFLOP of bf16 tensor-core work
//   (0.02 ms at peak); the scatter adds 2^18 * 16 * 4 corner contributions
//   of F floats; device memory carries only x, the targets and the
//   gradients. The gather waits on L2 latency: a block takes 149,760 bytes
//   and ~200 registers a thread at config_hash, so an SM holds 8 warps
//   (K1 up to 64), and K6's gather takes ~0.34 ms to K1's 0.09
//   (scripts/ablate_k6_phases.py; H100 80GB HBM3, 700 W).
// What the design does about it: persistent blocks of nt rows walk tiles
//   (fused_train.cuh): each warp gathers its own rows and runs
//   its MLP on mma.sync from registers with no block barrier in between, so
//   other warps' gathers overlap it; the loss takes its value and gradient
//   per element from the output fragments (values normalised by n = B * dims
//   once, where the TPU kernel normalises per tile and rescales, equal up to
//   f32 rounding); the backward keeps the gradient at about f32 precision,
//   as _kernel_vt does, by running each product on the tensor cores for the
//   bf16 high and low halves of g; the weight gradient stays in registers
//   across tiles (written once a block, then summed over blocks in a fixed
//   order, so it is the same bits run to run); K4's device function
//   scatters from the f32 encoding gradient, a warp taking 32 rows of one
//   level. The encoding, the hidden activations and the output gradient
//   never touch device memory, which is what the TPU kernel saves too. The
//   leading dense levels that fit the spare shared memory
//   (train_kernel.train_layout: levels 0-3 at config_hash, 0-2 at the
//   reference default T=2^19) are summed there with shared atomics; every
//   other level adds one float2 / float4 vector atomic per corner. Since the
//   gradient is [network | table] and level 0 starts at table row 0, one
//   fixed-order second pass writes the weights' gradient and those levels'
//   rows together, with no global atomic on them. The loss is summed per
//   block and added with one atomic. Rows past B are masked in the loss and
//   in both scatters, never padded. The tile and the blocks an SM are
//   train_kernel.K6_LAYOUT, chosen by scripts/time_k6_layouts.py.
#include "fused_train.cuh"

TCNN_TRAIN_INSTANCE(extern, 1, false)
TCNN_TRAIN_INSTANCE(extern, 2, false)
TCNN_TRAIN_INSTANCE(extern, 4, false)
TCNN_TRAIN_INSTANCE(extern, 8, false)

// The persistent grid of tcnn_fused_train over B rows in tiles of nt, for F
// features per level and `priv` private table-gradient floats a block
// (train_grid: > 0 blocks, 0 when no block fits, -cudaError).
extern "C" int tcnn_fused_train_grid(int B, int F, int priv, int nt, int in_w, int width,
                                     int n_hidden, int out_w, int act, int out_act, int device) {
  using namespace tcnn;
  const TrainLayout L{MlpArgs{nullptr, in_w, width, n_hidden, out_w, act, out_act}, nt, 0, priv};
  if (!valid_train_layout(L)) return -(int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return train_grid<1, false>(L, device, B);
    case 2: return train_grid<2, false>(L, device, B);
    case 4: return train_grid<4, false>(L, device, B);
    case 8: return train_grid<8, false>(L, device, B);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// `grid` blocks, as tcnn_fused_train_grid gave them; levels 0..n_private-1
// (table rows 0..priv/F-1) kept private; `partials` holds grid x
// (n_weights + priv rounded up to 8) f32.
extern "C" int tcnn_fused_train(const void* x, const void* table, const void* level_i32,
                                const void* level_f32, const void* weights, const void* targets,
                                const void* pdf, const void* noise, void* grads, void* partials,
                                void* loss_sum, int grid, int B, int D, int F, int L, int n_active,
                                int interp, unsigned f0, unsigned f1, unsigned f2, unsigned f3, int hash, int stochastic,
                                int n_private, int priv,
                                int nt, int in_w, int width, int n_hidden, int out_w, int act,
                                int out_act, int loss_code, int dims, float loss_scale, int device,
                                void* stream) {
  using namespace tcnn;
  const MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  const TrainLayout lay{m, nt, 0, priv};
  if (!valid_train_layout(lay) || grid < 1 || in_w < L * F || n_active > L ||
      n_private > n_active || n_private < 0 || priv % F != 0)
    return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, stochastic};
  LossArgs la{static_cast<const float*>(targets), static_cast<const float*>(pdf),
              static_cast<const float*>(noise), loss_code, dims, loss_scale,
              (float)((long)B * dims)};
  float* gr = static_cast<float*>(grads);
  float* part = static_cast<float*>(partials);
  float* ls = static_cast<float*>(loss_sum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_train<1, false>(g, lay, la, gr, part, ls, nullptr, B, n_active, n_private, grid, device, s);
    case 2: return launch_fused_train<2, false>(g, lay, la, gr, part, ls, nullptr, B, n_active, n_private, grid, device, s);
    case 4: return launch_fused_train<4, false>(g, lay, la, gr, part, ls, nullptr, B, n_active, n_private, grid, device, s);
    case 8: return launch_fused_train<8, false>(g, lay, la, gr, part, ls, nullptr, B, n_active, n_private, grid, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
