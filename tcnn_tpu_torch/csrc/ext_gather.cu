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
// What bounds them on this card: K10 bytes: it moves each pick's row once
//   from a table that stays in L2 (PPNG2 at factory defaults: 4.7 MB of bf16
//   planes) to a picks array that does not (604 MB at B = 2^17). K12 reads
//   idx and cw (8 bytes a pick: 32 MB at PPNG3's sample config, B = 2^16)
//   and eight rows per (sample, level) from a table in L2 (1 MB there, 25
//   MB at the factory defaults), each row a 32-byte sector of its own but
//   for x-neighbours: the row gathers, not the bytes, set its pace. The
//   first-slice kernel (one thread per (sample, level), eight dependent
//   rounds of an idx load then a row load; the kernel of C != 8 since)
//   took 0.0356 device ms at the sample config, 0.0107 without its row
//   loads, 0.0187 with idx and cw synthesized; 0.128 / 0.040 / 0.062 at the
//   defaults (scripts/ablate_ext_kernels.py, H100 80GB HBM3, 700 W).
// What the design does about it: K10 is a byte copy, one thread per 16-,
//   8-, 4- or 2-byte piece of a pick's row (the widest that divides the
//   row), neighbouring threads on neighbouring output bytes; it returns the
//   table's own values, f32 or bf16. K12 at C = 8 (every PPNG3 config:
//   D = 3) fixes the corners at compile time and issues every index and
//   weight load of a lane before any row load, and pairs the lanes of two
//   levels of a sample so that each load instruction takes both corners of
//   an x-pair, rows r and r + 1, mostly one sector: 0.0237 device ms at the
//   sample config (0.0074 without row loads, 0.0174 with idx and cw
//   synthesized), 0.0887 at the defaults (0.0387, 0.0515). Single lanes
//   (0.0274, 0.1061) and a lane group of four levels with int4 / float4
//   index and weight loads (0.0229, 0.0880: no faster) went. The sum keeps
//   the twin's f32 order, corners c = 0..C-1 with __fmul_rn/__fadd_rn, so
//   that no FMA is contracted: bit-equal to the twin.
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

// K12 at any C (<= 64), odd NL or unaligned idx, the first-slice kernel:
// one thread per (sample, level), its corners in a run-time loop.
template <int F>
__global__ void ext_lookup_any_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
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

// K12 at C = 8 with NL even and idx 8-byte aligned (every PPNG3 path: NL =
// 2 x its frequencies): a lane sums one (sample, level), corners c = 0..7
// in order. Lanes 2i and 2i + 1 take levels l0 and l0 + 1 of one sample and
// split the loads by the corner's x bit: lane q loads the rows of corners
// 2j + q, j = 0..3, at both levels (their indices as one int2), so that
// corners c and c ^ 1 of a level, rows r and r + 1 or one row, go out in
// one load instruction, most often within one 32-byte sector; then the two
// swap the rows of each other's level (one shuffle a 32-bit word). Every
// index and weight load is issued before any row load. A lane past the
// last pair loads the last pair's picks, so that its partner has rows to
// swap with, and stores nothing.
template <int F>
__global__ void __launch_bounds__(256)
    ext_lookup8_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
                       const float* __restrict__ cw, bf16* __restrict__ y, long n_pairs, int NL) {
  using Raw = typename BfVec<F>::T;
  constexpr int C = 8, CL = C / 2;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(t & 1);
  const long item = (t / 2 < n_pairs ? t / 2 : n_pairs - 1) * 2 + q;  // b * NL + l
  const long b = item / NL;
  const int l0 = (int)(item - b * NL) - q;
  const long base = b * C * NL + l0;
  int row[CL][2];
#pragma unroll
  for (int j = 0; j < CL; ++j) load_vec<2>(idx + base + (long)(j * 2 + q) * NL, row[j]);
  float w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) w[c] = cw[base + (long)c * NL + q];
  Raw raw[CL][2];
#pragma unroll
  for (int j = 0; j < CL; ++j) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      raw[j][v] = *reinterpret_cast<const Raw*>(table + (long)row[j][v] * F);
    }
  }
  // mine[j]: corner 2j + q at this lane's level; theirs: corner 2j + (q ^ 1)
  // there, from the partner
  Raw mine[CL], theirs[CL];
#pragma unroll
  for (int j = 0; j < CL; ++j) {
    mine[j] = q ? raw[j][1] : raw[j][0];
    theirs[j] = shfl_pair(q ? raw[j][0] : raw[j][1]);
  }
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v[F];
    unpack_bf16<F>((c & 1) == q ? mine[c / 2] : theirs[c / 2], v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w[c], v[f]));
  }
  if (t / 2 < n_pairs) store_bf16<F>(y + item * F, acc);
}

template <int F>
static int launch_lookup(const bf16* table, const int* idx, const float* cw, bf16* y, long B,
                         int NL, int C, int threads, cudaStream_t s) {
  if (threads <= 0 || threads > 256 || threads % 32) return (int)cudaErrorInvalidValue;
  if (C == 8 && NL % 2 == 0 && reinterpret_cast<uintptr_t>(idx) % 8 == 0) {
    ext_lookup8_kernel<F><<<blocks_for(B * NL, threads), threads, 0, s>>>(table, idx, cw, y,
                                                                         B * NL / 2, NL);
  } else {
    ext_lookup_any_kernel<F><<<blocks_for(B * NL, threads), threads, 0, s>>>(table, idx, cw, y,
                                                                            B, NL, C);
  }
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
// C = 8 at an even NL takes ext_lookup8_kernel's lane pairs where idx is
// 8-byte aligned (their int2 loads); any other input the first-slice
// kernel. Blocks of `threads` (ext_kernel.py:lookup_threads).
extern "C" int tcnn_ext_lookup(const void* table, const void* idx, const void* cw, void* y, int B,
                               int NL, int C, int F, int threads, int device, void* stream) {
  using namespace tcnn;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bf16* tp = static_cast<const bf16*>(table);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(cw);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: return launch_lookup<1>(tp, ip, wp, yp, B, NL, C, threads, s);
    case 2: return launch_lookup<2>(tp, ip, wp, yp, B, NL, C, threads, s);
    case 4: return launch_lookup<4>(tp, ip, wp, yp, B, NL, C, threads, s);
    case 8: return launch_lookup<8>(tp, ip, wp, yp, B, NL, C, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
