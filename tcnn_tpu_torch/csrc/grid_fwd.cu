// K1: multiresolution grid forward.
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_fwd_kernel (through
//   _fwd_call and grid_encode_pallas), which gathers rows through one-hot
//   matmuls on the MXU because the TPU has no per-lane random access.
// What bounds it on this card: its bound is bytes: at config_hash (L=16,
//   F=2, B=2^18) x in (2 MB), a 1.4 MB bf16 table (354,296 rows x F=2) that
//   stays in the 50 MB L2, and 16.8 MB of bf16 output, 0.0061 ms at
//   3.35 TB/s. What sets its time is the 16.8 M corner reads, each a
//   32-byte sector from L2 for a 4-byte row, and the instructions around
//   them. The first-slice K1 (one thread a (sample, level), D read at run
//   time) spent about as long on each: 0.089 ms whole, 0.079 without its
//   table loads (scripts/ablate_mlp_kernels.py k1-*, H100).
// What the design does about it: fewer instructions and fewer sectors.
//   D is a template parameter, so the position, the 2^D corners and their
//   index sums unroll with no test of D; a block is a 2-D grid of threads,
//   x the output's F-column group and y the sample, so no thread divides to
//   find its (sample, level); a row is reduced modulo its level's size only
//   when it lies past it; a level's constants are two 16-byte loads. And
//   the two lanes of a pair of levels load each x-pair of corners (c, c ^ 1)
//   in one instruction (grid_common.cuh:grid_level_pair), so the x-pair,
//   which shares a 32-byte sector in ~7/8 of cases at config_hash, costs
//   one sector fetch, not two; the lanes swap rows by shuffles and each
//   sums its own level's corners in the twin's order, bit for bit.
//   Neighbouring threads write neighbouring columns (coalesced F-wide
//   stores); the threads past the last level write the padding columns
//   with the same stores; the batch tail is masked, never padded.
#include "grid_common.cuh"

namespace tcnn {

// Thread (x, y) of block i serves column group x of sample
// i * blockDim.y + y, lanes 2i and 2i + 1 of a warp together
// (grid_level_pair): level x's encoding while x < n_active, zeros past it
// (levels past n_active and the padding columns), written as columns
// [x F, x F + F) (out_width is a multiple of F). blockDim.x is even; with
// an odd count of groups its last thread writes nothing.
template <int F, int D>
__global__ void grid_fwd_kernel(GridArgs g, bf16* __restrict__ out, long B, int n_active,
                                int out_width) {
  const long b = (long)blockIdx.x * blockDim.y + threadIdx.y;
  const int l = threadIdx.x;
  float v[F];
  grid_level_pair<F, D>(g, b, l, b < B, n_active, v);
  if (b >= B || l * F >= out_width) return;
  store_bf16<F>(out + b * out_width + l * F, v);
}

template <int F, int D>
static int launch_grid_fwd(const GridArgs& g, bf16* out, long B, int n_active, int out_width,
                           cudaStream_t stream) {
  const int groups = out_width / F, lanes = groups + (groups & 1);
  if (lanes > 1024) return (int)cudaErrorInvalidValue;
  const int samples = lanes >= 256 ? 1 : 256 / lanes;
  const long blocks = (B + samples - 1) / samples;
  grid_fwd_kernel<F, D><<<(unsigned)blocks, dim3(lanes, samples), 0, stream>>>(
      g, out, B, n_active < g.L ? n_active : g.L, out_width);
  return (int)cudaGetLastError();
}

template <int F>
static int launch_grid_fwd_dims(const GridArgs& g, bf16* out, long B, int n_active,
                                int out_width, cudaStream_t stream) {
  switch (g.D) {
    case 1: return launch_grid_fwd<F, 1>(g, out, B, n_active, out_width, stream);
    case 2: return launch_grid_fwd<F, 2>(g, out, B, n_active, out_width, stream);
    case 3: return launch_grid_fwd<F, 3>(g, out, B, n_active, out_width, stream);
    case 4: return launch_grid_fwd<F, 4>(g, out, B, n_active, out_width, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tcnn

extern "C" int tcnn_grid_fwd(const void* x, const void* table, const void* level_i32,
                             const void* level_f32, void* out, int B, int D, int F, int L,
                             int n_active, int interp, unsigned f0, unsigned f1, unsigned f2,
                             unsigned f3, int hash, int out_width, int device, void* stream) {
  using namespace tcnn;
  if (out_width < L * F || out_width % F) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_fwd_dims<1>(g, o, B, n_active, out_width, s);
    case 2: return launch_grid_fwd_dims<2>(g, o, B, n_active, out_width, s);
    case 4: return launch_grid_fwd_dims<4>(g, o, B, n_active, out_width, s);
    case 8: return launch_grid_fwd_dims<8>(g, o, B, n_active, out_width, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
