// K10: raw row gather of many small tables (ext_gather), and K12: the
// weighted lookup y = sum_c cw_c * T[idx_c] (ext_lookup), for PPNG1/2/3.
//
// K10 replaces tcnn_tpu/ops/pallas/dense_ext_kernel.py:_gather_kernel
//   (through _gather and dense_ext_gather): picks[b, (c*NL + l)*F + f] =
//   T_l[idx[b, c*NL + l], f], which the TPU computes as a one-hot matmul
//   against its 128-lane packed tables. It also serves PPNG1's endpoint
//   lookups, which the JAX package writes as a one-hot einsum
//   (ppng.py:185-210): on Hopper that einsum is this gather.
// K12 replaces tcnn_tpu/ops/pallas/binned_kernel.py's ext_iw forward
//   (_bin_kernel, _gather_kernel, _combine_kernel through binned_ext_lookup)
//   and the dense-ext gather plus jnp weighted sum that PPNG3 takes at
//   Q <= 64 (ppng.py:572-584): the counting sort exists for the TPU only.
// What bounds them on this card: bytes. K10 moves each pick's row once from
//   a table that stays in L2 (PPNG2 at factory defaults: 4.7 MB of bf16
//   planes) to a picks array that does not (604 MB at B = 2^17); K12 reads
//   eight rows per (sample, level) from a 25 MB bf16 table in L2 and writes
//   one bf16 row.
// What the design does about it: K10 is a byte copy, one thread per 16-,
//   8-, 4- or 2-byte piece of a pick's row (the widest that divides the
//   row), neighbouring threads on neighbouring output bytes; it returns the
//   table's own values, f32 or bf16. K12 is one thread per (sample, level)
//   with an F-wide vector load per corner and the twin's f32 order,
//   __fmul_rn/__fadd_rn so that no FMA is contracted, corners c = 0..C-1.
#include "ext_common.cuh"

namespace tcnn {

template <typename V>
__global__ void ext_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                                  V* __restrict__ out, long n_picks, int units) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_picks * units) return;
  const long p = t / units;
  const int j = (int)(t - p * units);
  out[t] = table[(long)idx[p] * units + j];
}

template <typename V>
static int launch_gather(const void* table, const int* idx, void* out, long n_picks,
                         int row_bytes, cudaStream_t s) {
  const int units = row_bytes / (int)sizeof(V);
  const int threads = 256;
  ext_gather_kernel<V><<<blocks_for(n_picks * units, threads), threads, 0, s>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), n_picks, units);
  return (int)cudaGetLastError();
}

template <int F>
__global__ void ext_lookup_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
                                  const float* __restrict__ cw, bf16* __restrict__ y, long B,
                                  int NL, int C) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * NL) return;
  const long b = t / NL;
  const int l = (int)(t - b * NL);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const long k = b * C * NL + (long)c * NL + l;
    const float w = cw[k];
    float v[F];
    load_bf16<F>(table + (long)idx[k] * F, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
  }
  store_bf16<F>(y + t * F, acc);
}

template <int F>
static int launch_lookup(const bf16* table, const int* idx, const float* cw, bf16* y, long B,
                         int NL, int C, cudaStream_t s) {
  const int threads = 256;
  ext_lookup_kernel<F><<<blocks_for(B * NL, threads), threads, 0, s>>>(table, idx, cw, y, B,
                                                                        NL, C);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

// picks [B * K rows of row_bytes] = table rows idx [B * K] (int32 global rows).
extern "C" int tcnn_ext_gather(const void* table, const void* idx, void* out, int B, int K,
                               int row_bytes, int device, void* stream) {
  using namespace tcnn;
  if (row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int* ip = static_cast<const int*>(idx);
  const long n = (long)B * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) return launch_gather<uint4>(table, ip, out, n, row_bytes, s);
  if (row_bytes % 8 == 0) return launch_gather<uint2>(table, ip, out, n, row_bytes, s);
  if (row_bytes % 4 == 0) return launch_gather<unsigned>(table, ip, out, n, row_bytes, s);
  return launch_gather<unsigned short>(table, ip, out, n, row_bytes, s);
}

// y [B, NL * F] bf16 = sum over corners c of cw[b, c*NL + l] * table[idx[b, c*NL + l]].
extern "C" int tcnn_ext_lookup(const void* table, const void* idx, const void* cw, void* y, int B,
                               int NL, int C, int F, int device, void* stream) {
  using namespace tcnn;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bf16* tp = static_cast<const bf16*>(table);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(cw);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_lookup<1>(tp, ip, wp, yp, B, NL, C, s);
    case 2: return launch_lookup<2>(tp, ip, wp, yp, B, NL, C, s);
    case 4: return launch_lookup<4>(tp, ip, wp, yp, B, NL, C, s);
    case 8: return launch_lookup<8>(tp, ip, wp, yp, B, NL, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
