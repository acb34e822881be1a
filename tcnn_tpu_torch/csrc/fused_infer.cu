// K3: fused grid + MLP inference.
//
// Replaces: tcnn_tpu/ops/pallas/train_kernel.py:_infer_kernel_vt (through
//   fused_forward_prepared, from Trainer.inference): grid forward and MLP
//   forward in one kernel, so the encoding never leaves fast memory.
// What bounds it on this card: the grid gather, as in K1: at config_hash
//   (B=2^18) 16.8 M random 4-byte corner reads from the L2-resident 1.4 MB
//   bf16 table. Device-memory traffic is only x in (2 MB) and y out (8.4 MB
//   of bf16 at out_pad=16); the 16.8 MB encoded tile that K1 writes and K2
//   reads back never exists in device memory here. The MLP's 3.8 GFLOP take
//   a few microseconds of the tensor cores.
// What the design does about it: persistent blocks load the weights once
//   (mlp_frag.cuh's padded layout) and their warps walk 16-row tiles, each
//   on its own: a warp gathers its rows' encoding with the shared
//   per-(sample, level) walker (grid_common.cuh:grid_level) into its own
//   slice of shared memory, runs the layer chain on mma.sync with the
//   activations in registers (frag_forward), and writes the output rows as
//   16-byte pieces. No barrier follows the weights' load, so while one warp
//   runs its MLP the SM's other warps keep their gathers in flight;
//   registers (64 a thread up to width 64) and the block's small shared
//   memory (K2's layout, mlp_frag.cuh:frag_tile_smem_bytes) set how many. A
//   kernel is built for the ReLU / None activations with no branch on them
//   (mlp_frag.cuh:with_acts). The batch tail is masked.
// Rng option: replaces train_kernel.py:_infer_kernel's Rng plans (:1331), which
//   read hashes precomputed outside the kernel; here each thread hashes its
//   corners (grid_common.cuh:rng_hash), as K1 does.
#include "grid_common.cuh"
#include "mlp_frag.cuh"

namespace tcnn {

template <int F, int WIDTH, int ACT, int OUT_ACT>
__global__ void __launch_bounds__(256, WIDTH <= 64 ? 4 : 2)
    fused_infer_kernel(GridArgs g, MlpArgs m, bf16* __restrict__ out, long B, long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int ldx = m.in_w + 8;
  bf16* xs = sw + frag_weight_elems(m) + (size_t)warp * 16 * ldx;

  load_weights_padded(m, sw);
  // the padding columns, which the gather never writes
  const int enc = g.L * F, pad = m.in_w - enc;
  for (int p = lane; p < 16 * pad; p += 32) {
    xs[(p / pad) * ldx + enc + p % pad] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  for (long tile = (long)blockIdx.x * n_warps + warp; tile < n_tiles;
       tile += (long)gridDim.x * n_warps) {
    const long row0 = tile * 16;
    for (int p = lane; p < 16 * g.L; p += 32) {
      const int r = p / g.L, l = p % g.L;
      float v[F];
      if (row0 + r < B) {
        grid_level<F>(g, row0 + r, l, v);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.f;
      }
      store_bf16<F>(xs + r * ldx + l * F, v);
    }
    __syncwarp();
    frag_forward<WIDTH, ACT, OUT_ACT>(
        m, sw, xs, ldx, [](int, int, const uint32_t(&)[4]) {},
        [&](int p, const uint32_t(&o)[4]) { store_slab_rows(out, m.out_w, row0, B, 16 * p, o); });
    __syncwarp();  // the chain's reads of xs before the next gather writes it
  }
}

template <int F, int WIDTH>
static int launch_fused(const GridArgs& g, const MlpArgs& m, bf16* out, long B, int warps,
                        int device, cudaStream_t stream) {
  return with_acts(m.act, m.out_act, [&](auto act, auto out_act) {
    const auto kernel = fused_infer_kernel<F, WIDTH, decltype(act)::value, decltype(out_act)::value>;
    const size_t smem = frag_tile_smem_bytes(m, warps);
    const long n_tiles = (B + 15) / 16;
    const int grid = resident_grid(kernel, warps * 32, smem, device, (n_tiles + warps - 1) / warps);
    if (grid < 0) return -grid;
    if (grid == 0) return (int)cudaErrorInvalidValue;
    kernel<<<grid, warps * 32, smem, stream>>>(g, m, out, B, n_tiles);
    return (int)cudaGetLastError();
  });
}

template <int F>
static int launch_fused_width(const GridArgs& g, const MlpArgs& m, bf16* out, long B, int warps,
                              int device, cudaStream_t stream) {
  switch (m.width) {
    case 16: return launch_fused<F, 16>(g, m, out, B, warps, device, stream);
    case 32: return launch_fused<F, 32>(g, m, out, B, warps, device, stream);
    case 64: return launch_fused<F, 64>(g, m, out, B, warps, device, stream);
    case 128: return launch_fused<F, 128>(g, m, out, B, warps, device, stream);
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
  if (in_w < L * F || in_w % 16 || out_w % 16 || n_hidden < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return (int)cudaErrorInvalidValue;
  MlpArgs m{static_cast<const bf16*>(weights), in_w, width, n_hidden, out_w, act, out_act};
  // the most warps a block (up to 8) whose shared memory fits, K2's layout
  const int warps = frag_tile_warps(m, (size_t)limit);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  GridArgs g{static_cast<const float*>(x), static_cast<const bf16*>(table),
             static_cast<const int*>(level_i32), static_cast<const float*>(level_f32),
             D, L, interp, {f0, f1, f2, f3}, hash, 0};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_fused_width<1>(g, m, o, B, warps, device, s);
    case 2: return launch_fused_width<2>(g, m, o, B, warps, device, s);
    case 4: return launch_fused_width<4>(g, m, o, B, warps, device, s);
    case 8: return launch_fused_width<8>(g, m, o, B, warps, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
