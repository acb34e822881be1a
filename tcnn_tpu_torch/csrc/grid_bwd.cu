// K4: multiresolution grid backward (the table gradient).
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_bwd_kernel (through _bwd_call
//   and _grid_pallas_bwd), which scatters dL/dtable[row, f] += w_c * gy[b,
//   l*F + f] over every (sample, level, corner) through one-hot matmuls
//   accumulated across the sequential TPU grid.
// What bounds it on this card: atomics, not bytes. At config_hash (L=16,
//   F=2, B=2^18) the scatter makes 2^18 * 16 * 4 contributions of F floats
//   into a 2.8 MB f32 gradient that stays in L2, and reads 16.8 MB of bf16
//   cotangent. The coarse dense levels are hot: level 0 has 256 (16^2) rows
//   for 2^18 samples, so ~4096 adds land on each of its floats, level 5
//   (14,888 rows) still ~70, and adds to one address serialise in L2. As
//   one scalar f32 atomic per (sample, level, corner, feature), 33.5 M of
//   them, lanes mixing levels, it took 0.74 ms against a 0.0065 ms bound;
//   redesigned, 0.21 ms. The count of atomics, not their width, still
//   bounds it: the 11.5 M vector REDs left (one per corner of levels 5-15)
//   would take 0.26 ms at the rate the 33.5 M scalar ones ran (H100 80GB
//   HBM3, 700 W; PERF.md).
// What the design does about it:
//   - Persistent blocks (as many as are resident, each walking tiles of
//     kBwdThreads samples), one thread per sample of a tile walking the
//     active levels in order, so that a warp takes 32 samples of one level
//     and every branch on the level is the whole warp's.
//   - The leading dense levels 0..n_private-1 (ops/cuda/grid_kernel.py:
//     private_levels chooses them to fit K4_PRIVATE_BYTES of shared memory:
//     levels 0-4 at config_hash, two blocks an SM, timed against no private
//     level and against levels 0-5 at one block an SM by
//     scripts/time_k4_budgets.py) are summed in a private f32 slice of the
//     block's shared memory with shared atomics; the slice is zeroed once
//     and written once, into the block's partial, and reduce_partials
//     (common.cuh) sums the partials in block order into table rows
//     0..priv/F-1 (level 0 starts at row 0): no global atomic on those rows,
//     and a deterministic sum over blocks (a flush by global atomics, one
//     per private float and block, was not built).
//   - Every other level adds with one vector atomic per corner (sm_90's
//     float2 / float4 atomicAdd; common.cuh:atomic_add_row), a
//     fire-and-forget RED, in place of F scalar ones.
//   Each contribution is rounded to bf16 as the TPU kernel rounds it, then
//   added in f32; only the order of the f32 sums differs from the twin's.
//   Positions, weights and corner rows come from K1's own device functions
//   (grid_common.cuh), so forward and backward agree on every corner. Levels
//   past max_level are not visited. The wrapper zeroes the gradient.
// Stochastic option: replaces grid_kernel.py:_bwd_stoch_kernel (through
//   _bwd_stoch_call), which scatters each (sample, level)'s whole cotangent
//   row, rounded to bf16, into one corner chosen by a uniform draw. Here the
//   same thread draws u in-kernel (grid_common.cuh:stoch_uniform), picks the
//   corner (grid_stoch_row) and adds the row there through the same two
//   routes: a shared atomic per feature on a private level, one vector
//   atomic on the others.
#include "grid_common.cuh"

namespace tcnn {

// Threads of a block, and samples of a tile.
constexpr int kBwdThreads = 512;

template <int F>
__global__ void __launch_bounds__(kBwdThreads, 2)
    grid_bwd_kernel(GridArgs g, const bf16* __restrict__ gy, int gy_width,
                    float* __restrict__ gtable, float* __restrict__ partials, long B,
                    int n_active, int n_private, int priv_floats, long n_tiles) {
  extern __shared__ __align__(16) float priv[];
  for (int i = threadIdx.x; i < priv_floats; i += blockDim.x) priv[i] = 0.f;
  __syncthreads();
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long b = tile * kBwdThreads + threadIdx.x;
    if (b >= B) continue;
    for (int l = 0; l < n_active; ++l) {
      float v[F];
      load_bf16<F>(gy + b * gy_width + l * F, v);
      grid_level_bwd<F>(g, b, l, v, gtable, priv, l < n_private);
    }
  }
  if (priv_floats == 0) return;
  __syncthreads();
  float* out = partials + (size_t)blockIdx.x * priv_floats;
  for (int i = threadIdx.x; i < priv_floats; i += blockDim.x) out[i] = priv[i];
}

static long bwd_tiles(long B) { return (B + kBwdThreads - 1) / kBwdThreads; }

template <int F>
static int bwd_grid(int priv_floats, int device, long B) {
  return resident_grid(grid_bwd_kernel<F>, kBwdThreads, (size_t)priv_floats * 4, device,
                       bwd_tiles(B));
}

template <int F>
static int launch_grid_bwd(const GridArgs& g, const bf16* gy, int gy_width, float* gtable,
                           float* partials, long B, int n_active, int n_private, int priv_floats,
                           int grid, cudaStream_t stream) {
  const size_t smem = (size_t)priv_floats * 4;
  cudaError_t e =
      cudaFuncSetAttribute(grid_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  grid_bwd_kernel<F><<<grid, kBwdThreads, smem, stream>>>(g, gy, gy_width, gtable, partials, B,
                                                          n_active, n_private, priv_floats,
                                                          bwd_tiles(B));
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || priv_floats == 0) return rc;
  return launch_reduce(partials, grid, (size_t)priv_floats, (size_t)priv_floats, gtable, stream);
}

}  // namespace tcnn

// The persistent grid of tcnn_grid_bwd over B samples for F features per
// level and `priv` private floats a block (> 0 blocks, 0 when no block
// fits, -cudaError).
extern "C" int tcnn_grid_bwd_grid(int B, int F, int priv, int device) {
  using namespace tcnn;
  if (priv < 0) return -(int)cudaErrorInvalidValue;
  switch (F) {
    case 1: return bwd_grid<1>(priv, device, B);
    case 2: return bwd_grid<2>(priv, device, B);
    case 4: return bwd_grid<4>(priv, device, B);
    case 8: return bwd_grid<8>(priv, device, B);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// `grid` blocks, as tcnn_grid_bwd_grid gave them; levels 0..n_private-1
// (table rows 0..priv/F-1) kept private; `partials` holds grid x priv f32.
extern "C" int tcnn_grid_bwd(const void* x, const void* gy, const void* level_i32,
                             const void* level_f32, void* gtable, void* partials, int B, int D,
                             int F, int L, int n_active, int interp, unsigned f0, unsigned f1,
                             unsigned f2, unsigned f3, int hash, int stochastic, int n_private,
                             int priv, int grid, int gy_width, int device, void* stream) {
  using namespace tcnn;
  if (n_active > L || gy_width < L * F || n_private < 0 || n_private > n_active || priv < 0 ||
      priv % F != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), nullptr, static_cast<const int*>(level_i32),
             static_cast<const float*>(level_f32), D, L, interp, {f0, f1, f2, f3}, hash, stochastic};
  const bf16* gyp = static_cast<const bf16*>(gy);
  float* gt = static_cast<float*>(gtable);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_bwd<1>(g, gyp, gy_width, gt, part, B, n_active, n_private, priv, grid, s);
    case 2: return launch_grid_bwd<2>(g, gyp, gy_width, gt, part, B, n_active, n_private, priv, grid, s);
    case 4: return launch_grid_bwd<4>(g, gyp, gy_width, gt, part, B, n_active, n_private, priv, grid, s);
    case 8: return launch_grid_bwd<8>(g, gyp, gy_width, gt, part, B, n_active, n_private, priv, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
