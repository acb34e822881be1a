// K11: the scatter-add transpose of K10 (ext_scatter), and K13: the
// backward of K12's weighted lookup (ext_lookup_bwd), for PPNG1/2/3.
//
// K11 replaces tcnn_tpu/ops/pallas/dense_ext_kernel.py:_scatter_kernel
//   (through _scatter and dense_ext_scatter): gT[idx[p], f] += ct[p, f] in
//   f32, ct read in its own dtype: bf16 where the gather read a bf16 table
//   (dense_ext_kernel.py:161 rounds the cotangent before its f32-accumulating
//   matmul), f32 for PPNG1's f32 einsum transpose, which does not round.
// K13 replaces tcnn_tpu/ops/pallas/binned_kernel.py:_combine_extg_kernel
//   (through _combine_extg_call and _binned_ext_backward) with the ext_iw
//   mode of _place_kernel and _scatter_kernel: per pick, the table gradient
//   dT[idx, f] += bf16(cw * gy[f]) (binned_kernel.py:1748-1750) and the
//   weight gradient dcw = sum_f T[idx, f] * gy[f] in f32.
// What bounds them on this card: f32 atomics. The picks' rows follow the
//   sine-warped quantization, whose extremes rows 0 and Q-1 collect many
//   picks, so adds to those rows serialise in L2, as the grid's coarse
//   levels do in K4.
// What the design does about it: nothing yet beyond fire-and-forget adds
//   (RED, no return value). K11 runs one thread per (pick, feature) so that
//   neighbouring threads add into neighbouring words of a row; K13 one
//   thread per pick, with F-wide loads of gy and of the table row and the
//   twin's f32 order (__fmul_rn/__fadd_rn). A null dT or dcw skips that half.
//   The wrapper zeroes the gradient.
#include "ext_common.cuh"

namespace tcnn {

template <typename TC>
__global__ void ext_scatter_kernel(const int* __restrict__ idx, const TC* __restrict__ ct,
                                   float* __restrict__ gtable, long n_picks, int F) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_picks * F) return;
  const long p = t / F;
  const int f = (int)(t - p * F);
  atomicAdd(gtable + (long)idx[p] * F + f, to_f32(ct[t]));
}

template <typename TC>
static int launch_scatter(const int* idx, const void* ct, float* gtable, long n_picks, int F,
                          cudaStream_t s) {
  const int threads = 256;
  ext_scatter_kernel<TC><<<blocks_for(n_picks * F, threads), threads, 0, s>>>(
      idx, static_cast<const TC*>(ct), gtable, n_picks, F);
  return (int)cudaGetLastError();
}

template <int F>
__global__ void ext_lookup_bwd_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
                                      const float* __restrict__ cw, const float* __restrict__ gy,
                                      float* __restrict__ gtable, float* __restrict__ dcw, long B,
                                      int NL, int C) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long per = (long)C * NL;
  if (t >= B * per) return;
  const long b = t / per;
  const int l = (int)((t - b * per) % NL);
  float g[F];
  load_f32<F>(gy + (b * NL + l) * F, g);
  const long row = idx[t];
  if (gtable != nullptr) {
    const float w = cw[t];
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(gtable + row * F + f, round_bf16(__fmul_rn(w, g[f])));
  }
  if (dcw != nullptr) {
    float v[F];
    load_bf16<F>(table + row * F, v);
    float d = __fmul_rn(v[0], g[0]);
#pragma unroll
    for (int f = 1; f < F; ++f) d = __fadd_rn(d, __fmul_rn(v[f], g[f]));
    dcw[t] = d;
  }
}

template <int F>
static int launch_lookup_bwd(const bf16* table, const int* idx, const float* cw, const float* gy,
                             float* gtable, float* dcw, long B, int NL, int C, cudaStream_t s) {
  const int threads = 256;
  ext_lookup_bwd_kernel<F><<<blocks_for(B * C * NL, threads), threads, 0, s>>>(
      table, idx, cw, gy, gtable, dcw, B, NL, C);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

// gtable [n_rows, F] f32 += ct [B * K picks, F] (f32, or bf16 when ct_bf16)
// at rows idx [B * K].
extern "C" int tcnn_ext_scatter(const void* idx, const void* ct, void* gtable, int B, int K, int F,
                                int ct_bf16, int device, void* stream) {
  using namespace tcnn;
  if (F <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int* ip = static_cast<const int*>(idx);
  float* gt = static_cast<float*>(gtable);
  const long n = (long)B * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_bf16) return launch_scatter<bf16>(ip, ct, gt, n, F, s);
  return launch_scatter<float>(ip, ct, gt, n, F, s);
}

// The backward of tcnn_ext_lookup for the cotangent gy [B, NL * F] f32:
// gtable [n_rows, F] f32 += bf16(cw * gy) at each pick's row (skipped when
// gtable is null), dcw [B, C * NL] f32 = each pick's row dotted with gy
// (skipped when dcw is null; table is then not read).
extern "C" int tcnn_ext_lookup_bwd(const void* table, const void* idx, const void* cw,
                                   const void* gy, void* gtable, void* dcw, int B, int NL, int C,
                                   int F, int device, void* stream) {
  using namespace tcnn;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bf16* tp = static_cast<const bf16*>(table);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(cw);
  const float* gp = static_cast<const float*>(gy);
  float* gt = static_cast<float*>(gtable);
  float* dp = static_cast<float*>(dcw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_lookup_bwd<1>(tp, ip, wp, gp, gt, dp, B, NL, C, s);
    case 2: return launch_lookup_bwd<2>(tp, ip, wp, gp, gt, dp, B, NL, C, s);
    case 4: return launch_lookup_bwd<4>(tp, ip, wp, gp, gt, dp, B, NL, C, s);
    case 8: return launch_lookup_bwd<8>(tp, ip, wp, gp, gt, dp, B, NL, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
