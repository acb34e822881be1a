// K3: fused grid + MLP inference.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_infer_kernel_vt (through
//   fused_forward_prepared, from Trainer.inference): grid forward and MLP
//   forward in one kernel, so the encoding never leaves fast memory.
// What bounds it on this card: the grid gather, as in K1: at config_hash
//   (B=2^18) 16.8 M random 4-byte corner reads from the L2-resident 1.4 MB
//   bf16 table. Device-memory traffic is only x in (2 MB) and y out (8.4 MB
//   of bf16 at out_pad=16); the 16.8 MB encoded tile that K1 writes and K2
//   reads back never exists in device memory here.
// What the design does about it: per block of nt samples, the threads fill
//   the encoded tile [nt, enc_pad] bf16 in shared memory with K1's
//   per-(sample, level) gather (grid_common.cuh) and zero its padding
//   columns, then K2's layer chain (mlp_common.cuh) runs from that tile
//   with every weight resident in shared memory. The batch tail is masked.
// Rng option: replaces train_kernel.py:_infer_kernel's Rng plans (:1331), which
//   read hashes precomputed outside the kernel; here each thread hashes its
//   corners (grid_common.cuh:rng_hash), as K1 does.
#include "grid_common.cuh"
#include "mlp_common.cuh"

namespace tcnn {

template <int F, int WIDTH>
__global__ void fused_infer_kernel(GridArgs g, MlpArgs m, bf16* __restrict__ out, long B, int ld,
                                   size_t n_weights) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x / 2;
  const MlpSmem s = mlp_smem(smem, n_weights, nt, ld);
  const long row0 = (long)blockIdx.x * nt;

  load_weights(m.weights, s.weights, n_weights);
  for (int p = threadIdx.x; p < nt * g.L; p += blockDim.x) {
    const int r = p / g.L, l = p % g.L;
    const long row = row0 + r;
    float v[F];
    if (row < B) {
      grid_level<F>(g, row, l, v);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = 0.f;
    }
    store_bf16<F>(s.act0 + r * ld + l * F, v);
  }
  const int pad = m.in_w - g.L * F;
  for (int p = threadIdx.x; p < nt * pad; p += blockDim.x) {
    s.act0[(p / pad) * ld + g.L * F + p % pad] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  mlp_chain<WIDTH>(m, s, ld, out, row0, B);
}

template <int F, int WIDTH>
static int launch_fused(const GridArgs& g, const MlpArgs& m, bf16* out, long B, int nt,
                        cudaStream_t stream) {
  const int ld = mlp_ld(m.in_w, WIDTH, m.out_w);
  const size_t n_weights = mlp_n_weights(m.in_w, WIDTH, m.n_hidden, m.out_w);
  const size_t smem = mlp_smem_bytes(m.in_w, WIDTH, m.n_hidden, m.out_w, nt);
  cudaError_t e = cudaFuncSetAttribute(fused_infer_kernel<F, WIDTH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (B + nt - 1) / nt;
  fused_infer_kernel<F, WIDTH><<<(unsigned)blocks, nt * 2, smem, stream>>>(g, m, out, B, ld,
                                                                           n_weights);
  return (int)cudaGetLastError();
}

template <int F>
static int launch_fused_width(const GridArgs& g, const MlpArgs& m, bf16* out, long B, int nt,
                              cudaStream_t stream) {
  switch (m.width) {
    case 16: return launch_fused<F, 16>(g, m, out, B, nt, stream);
    case 32: return launch_fused<F, 32>(g, m, out, B, nt, stream);
    case 64: return launch_fused<F, 64>(g, m, out, B, nt, stream);
    case 128: return launch_fused<F, 128>(g, m, out, B, nt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tcnn

extern "C" int tcnn_fused_infer(const void* x, const void* table, const void* level_i32,
                                const void* level_f32, const void* weights, void* out, int B,
                                int D, int F, int L, int interp, unsigned f0, unsigned f1,
                                unsigned f2, unsigned f3, int hash, int in_w, int width, int n_hidden,
                                int out_w, int act, int out_act, int device, void* stream) {
  using namespace tcnn;
  if (in_w < L * F) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int nt = tcnn_mlp_tile(in_w, width, n_hidden, out_w, device);
  if (nt == 0) return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_width<1>(g, m, o, B, nt, s);
    case 2: return launch_fused_width<2>(g, m, o, B, nt, s);
    case 4: return launch_fused_width<4>(g, m, o, B, nt, s);
    case 8: return launch_fused_width<8>(g, m, o, B, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
