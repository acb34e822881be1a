// K1: multiresolution grid forward.
//
// Replaces: tcnn_tpu/ops/pallas/grid_kernel.py:_fwd_kernel (through
//   _fwd_call and grid_encode_pallas), which gathers rows through one-hot
//   matmuls on the MXU because the TPU has no per-lane random access.
// What bounds it on this card: random reads. At config_hash (L=16, F=2,
//   B=2^18) it makes 2^18 * 16 * 4 = 16.8 M corner reads of 4 bytes from a
//   1.4 MB bf16 table (354,296 rows x F=2), which stays in the 50 MB L2, and
//   writes 16.8 MB of bf16 output; each read costs a 32-byte L2 sector.
// What the design does about it: one thread per (sample, level), so
//   neighbouring threads share a sample and write neighbouring output
//   columns (coalesced stores); each corner row is one F-wide vector load;
//   the table is bf16 (half the bytes of f32) and is read straight from L2
//   with no packing; the padding columns are written here, so no second
//   pass pads the output; the batch tail is masked, never padded.
#include "grid_common.cuh"

namespace tcnn {

template <int F>
__global__ void grid_fwd_kernel(GridArgs g, bf16* __restrict__ out, long B, int n_active,
                                int out_width) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * g.L) return;
  const long b = t / g.L;
  const int l = (int)(t % g.L);
  float v[F];
  if (l < n_active) {
    grid_level<F>(g, b, l, v);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.f;
  }
  bf16* row = out + b * out_width;
  store_bf16<F>(row + l * F, v);
  if (l == g.L - 1) {
    for (int c = g.L * F; c < out_width; ++c) row[c] = __float2bfloat16_rn(0.f);
  }
}

template <int F>
static int launch_grid_fwd(const GridArgs& g, bf16* out, long B, int n_active, int out_width,
                           cudaStream_t stream) {
  const int threads = 256;
  const long blocks = (B * g.L + threads - 1) / threads;
  grid_fwd_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(g, out, B, n_active, out_width);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

extern "C" int tcnn_grid_fwd(const void* x, const void* table, const void* level_i32,
                             const void* level_f32, void* out, int B, int D, int F, int L,
                             int n_active, int interp, unsigned f0, unsigned f1, unsigned f2,
                             unsigned f3, int hash, int out_width, int device, void* stream) {
  using namespace tcnn;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_grid_fwd<1>(g, o, B, n_active, out_width, s);
    case 2: return launch_grid_fwd<2>(g, o, B, n_active, out_width, s);
    case 4: return launch_grid_fwd<4>(g, o, B, n_active, out_width, s);
    case 8: return launch_grid_fwd<8>(g, o, B, n_active, out_width, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
