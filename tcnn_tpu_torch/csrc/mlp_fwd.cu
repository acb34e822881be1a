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
// What the design does about it: K3's layer chain without the gather. One
//   read of the input and one write of the output per sample, with no
//   intermediate in device memory. Persistent blocks load the weights once
//   into mlp_frag.cuh's padded layout (14 KB at config_hash, 16.6 KB
//   padded); no barrier follows that load: each warp walks 16-row tiles on
//   its own. It copies its rows' bf16 inputs as 16-byte pieces into its own
//   slice of shared memory (pitch in_w + 8), runs the layers on mma.sync
//   with the activations in registers (frag_forward: one layer's C
//   fragments are the next one's A fragments, no shared scratch between
//   layers) and writes the output rows as 16-byte pieces
//   (store_slab_rows), so while one warp runs its chain the SM's other
//   warps keep their input loads in flight. A kernel is built for the
//   ReLU / None activations with no branch on them (with_acts); any other
//   pair reads the activation at run time. The batch tail is masked, never
//   padded.
#include "mlp_frag.cuh"

namespace tcnn {

template <int WIDTH, int ACT, int OUT_ACT>
__global__ void __launch_bounds__(256, WIDTH <= 64 ? 4 : 2)
    mlp_fwd_kernel(const bf16* __restrict__ x, MlpArgs m, bf16* __restrict__ out, long B,
                   long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int ldx = m.in_w + 8, chunks = m.in_w / 8;  // 16-byte pieces a row
  bf16* xs = sw + frag_weight_elems(m) + (size_t)warp * 16 * ldx;

  load_weights_padded(m, sw);
  __syncthreads();

  for (long tile = (long)blockIdx.x * n_warps + warp; tile < n_tiles;
       tile += (long)gridDim.x * n_warps) {
    const long row0 = tile * 16;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = i - r * chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < B) v = reinterpret_cast<const uint4*>(x + (row0 + r) * m.in_w)[c];
      *reinterpret_cast<uint4*>(xs + r * ldx + c * 8) = v;
    }
    __syncwarp();
    frag_forward<WIDTH, ACT, OUT_ACT>(
        m, sw, xs, ldx, [](int, int, const uint32_t(&)[4]) {},
        [&](int p, const uint32_t(&o)[4]) { store_slab_rows(out, m.out_w, row0, B, 16 * p, o); });
    __syncwarp();  // the chain's reads of xs before the next tile's copy writes it
  }
}

template <int WIDTH>
static int launch_mlp_fwd(const bf16* x, const MlpArgs& m, bf16* out, long B, int warps,
                          int device, cudaStream_t stream) {
  return with_acts(m.act, m.out_act, [&](auto act, auto out_act) {
    const auto kernel = mlp_fwd_kernel<WIDTH, decltype(act)::value, decltype(out_act)::value>;
    const size_t smem = frag_tile_smem_bytes(m, warps);
    const long n_tiles = (B + 15) / 16;
    const int grid = resident_grid(kernel, warps * 32, smem, device, (n_tiles + warps - 1) / warps);
    if (grid < 0) return -grid;
    if (grid == 0) return (int)cudaErrorInvalidValue;
    kernel<<<grid, warps * 32, smem, stream>>>(x, m, out, B, n_tiles);
    return (int)cudaGetLastError();
  });
}

}  // namespace tcnn

extern "C" int tcnn_mlp_tile(int in_w, int width, int n_hidden, int out_w, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  const tcnn::MlpArgs m{nullptr, in_w, width, n_hidden, out_w, 0, 0};
  return 16 * tcnn::frag_tile_warps(m, (size_t)limit);
}

extern "C" int tcnn_mlp_fwd(const void* x, const void* weights, void* out, int B, int in_w,
                            int width, int n_hidden, int out_w, int act, int out_act,
                            int device, void* stream) {
  using namespace tcnn;
  if (in_w % 16 || out_w % 16 || n_hidden < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int rows = tcnn_mlp_tile(in_w, width, n_hidden, out_w, device);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  const bf16* xx = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch_mlp_fwd<16>(xx, m, o, B, rows / 16, device, s);
    case 32: return launch_mlp_fwd<32>(xx, m, o, B, rows / 16, device, s);
    case 64: return launch_mlp_fwd<64>(xx, m, o, B, rows / 16, device, s);
    case 128: return launch_mlp_fwd<128>(xx, m, o, B, rows / 16, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
