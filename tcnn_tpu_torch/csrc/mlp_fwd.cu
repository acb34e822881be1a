// K2: fully fused MLP forward.
//
// Replaces: tcnn_tpu/ops/pallas/mlp_kernel.py:_fwd_kernel (through _fwd_call
//   and fused_mlp_apply): matmul -> activation chain with every weight
//   resident, bf16 in, f32 accumulate, bf16 between layers.
// What bounds it on this card: at config_hash (32 -> 64 -> 64 -> 16, B=2^18)
//   it moves 16.8 MB of bf16 input and 8.4 MB of output for 2^18 * 7168 * 2
//   = 3.8 GFLOP, about 150 FLOP per byte of device memory: below the bf16
//   ridge (~295), so device-memory traffic and latency bound it, and the
//   tensor cores idle most of the time.
// What the design does about it: one read of the input and one write of the
//   output per sample, with no intermediate in device memory: all weights
//   (14 KB here) sit in shared memory for the whole block, and the hidden
//   activations stay in shared memory between layers. Products run on the
//   tensor cores (wmma bf16 16x16x16). Shared memory above 48 KB is
//   dynamic, after cudaFuncSetAttribute; the tile shrinks from 128 rows when
//   the weights are large (width 128, many layers). The batch tail is
//   masked, never padded.
#include "mlp_common.cuh"

namespace tcnn {

template <int WIDTH>
__global__ void mlp_fwd_kernel(const bf16* __restrict__ x, MlpArgs m, bf16* __restrict__ out,
                               long B, int ld, size_t n_weights) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x / 2;  // 16 rows per warp of 32 threads
  const MlpSmem s = mlp_smem(smem, n_weights, nt, ld);
  const long row0 = (long)blockIdx.x * nt;

  load_weights(m.weights, s.weights, n_weights);
  const int chunks = m.in_w / 8;  // 16-byte chunks per input row
  for (int i = threadIdx.x; i < nt * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    const long row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < B) v = reinterpret_cast<const uint4*>(x + row * m.in_w)[c];
    *reinterpret_cast<uint4*>(s.act0 + r * ld + c * 8) = v;
  }
  __syncthreads();
  mlp_chain<WIDTH>(m, s, ld, out, row0, B);
}

template <int WIDTH>
static int launch_mlp_fwd(const bf16* x, const MlpArgs& m, bf16* out, long B, int nt,
                          cudaStream_t stream) {
  const int ld = mlp_ld(m.in_w, WIDTH, m.out_w);
  const size_t n_weights = mlp_n_weights(m.in_w, WIDTH, m.n_hidden, m.out_w);
  const size_t smem = mlp_smem_bytes(m.in_w, WIDTH, m.n_hidden, m.out_w, nt);
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel<WIDTH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (B + nt - 1) / nt;
  mlp_fwd_kernel<WIDTH><<<(unsigned)blocks, nt * 2, smem, stream>>>(x, m, out, B, ld, n_weights);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

extern "C" int tcnn_mlp_tile(int in_w, int width, int n_hidden, int out_w, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  for (int nt = 128; nt >= 16; nt /= 2) {
    if (tcnn::mlp_smem_bytes(in_w, width, n_hidden, out_w, nt) <= (size_t)limit) return nt;
  }
  return 0;
}

extern "C" int tcnn_mlp_fwd(const void* x, const void* weights, void* out, int B, int in_w,
                            int width, int n_hidden, int out_w, int act, int out_act,
                            int device, void* stream) {
  using namespace tcnn;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nt = tcnn_mlp_tile(in_w, width, n_hidden, out_w, device);
  if (nt == 0) return (int)cudaErrorInvalidValue;
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  const bf16* xx = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch_mlp_fwd<16>(xx, m, o, B, nt, s);
    case 32: return launch_mlp_fwd<32>(xx, m, o, B, nt, s);
    case 64: return launch_mlp_fwd<64>(xx, m, o, B, nt, s);
    case 128: return launch_mlp_fwd<128>(xx, m, o, B, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
