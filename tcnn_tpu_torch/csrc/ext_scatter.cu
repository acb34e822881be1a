// K11: the scatter-add transpose of K10 (ext_scatter), and K13: the
// backward of K12's weighted lookup (ext_lookup_bwd), for PPNG1/2/3.
//
// K11 replaces tcnn_tpu/ops/pallas/dense_ext_kernel.py:_scatter_kernel
//   (through _scatter and dense_ext_scatter): gT[idx[p], f] += ct[p, f] in
//   f32, ct read in its own dtype: bf16 where the gather read a bf16 table
//   (dense_ext_kernel.py:161 rounds the cotangent before its f32-accumulating
//   matmul), f32 for PPNG1's f32 einsum transpose, which does not round.
// What bounds it on this card: its bound is the read of ct (302 MB at
//   PPNG1, B = 2^16: 0.090 ms at 3.35 TB/s). The first-slice kernel (one
//   thread per (pick, feature), a 64-bit division and one scalar RED each)
//   was far from it, bound by instructions at PPNG1 and PPNG2's defaults
//   (0.264 and 0.917 ms; 0.210 and 0.823 without its atomics) and by the
//   adds that pile onto the sine-warped quantization's edge rows at PPNG2's
//   sample config (0.204 ms; 0.074 without atomics, 0.082 with every pick
//   on a row of its own) (scripts/ablate_ext_kernels.py, H100).
// What the design does about it:
//   - a thread takes V = 4 features of a pick (one 16-byte f32 or 8-byte
//     bf16 load) and walks its items on 32-bit counters, the item's column
//     decoded by 32-bit divisions only where a step moves it;
//   - the levels whose f32 gradient fits a block's shared memory, where
//     the batch gives every resident block enough adds a float
//     (ops/cuda/ext_kernel.py:scatter_plan: PPNG1's 36 tables in one group
//     of 147,456 B at B = 2^16 and 2^17) are summed in private copies that
//     each warp owns a share of the levels of: no shared atomic (a shared
//     f32 atomicAdd is a compare-and-swap loop on this card; summed that
//     way PPNG1 took 0.465 ms), lanes that would add to one word summed
//     first, found by shuffles with the lanes that share their level and
//     slice, and by __match_any_sync only in a step where some do (every
//     step through it: 0.288 ms). Each copy is added to the gradient once,
//     one vector RED per V floats;
//   - the other levels (PPNG2's defaults: 262,144 B a plane; PPNG2's
//     sample planes, where too few adds fall on a float per block; every
//     level at the eikonal term's 1024 points) add with one vector RED per
//     V features (common.cuh:atomic_add_row). Their rows are not summed
//     within a warp first: a warp's picks are V-wide slices of 32 / (F / V)
//     different tables, and with no hot row at all (the ablation's spread
//     rows) the first-slice kernel ran no faster at PPNG2's defaults.
//
// K13 replaces tcnn_tpu/ops/pallas/binned_kernel.py:_combine_extg_kernel
//   (through _combine_extg_call and _binned_ext_backward) with the ext_iw
//   mode of _place_kernel and _scatter_kernel: per pick, the table gradient
//   dT[idx, f] += bf16(cw * gy[f]) (binned_kernel.py:1748-1750) and the
//   weight gradient dcw = sum_f T[idx, f] * gy[f] in f32.
// What bounds it on this card: its table half's atomics. The first-slice
//   kernel (a thread per pick, F scalar REDs) took 0.092 ms of its 0.102
//   at PPNG3's sample config (0.038 without atomics, 0.064 with no hot
//   row) and 0.606 of 0.742 at the defaults (0.096 without atomics, 0.355
//   with no hot row): REDs to rows that the arcsine-shaped density of the
//   sine coordinates piles onto the cube's faces, edges and corners, and
//   too many of them. No level fits in shared memory (Q^3 rows: 262,144 B
//   of f32 a level at the sample config, 4 MB at the defaults).
// What the design does about it:
//   - a warp's lanes are 16 consecutive samples at each of two corners of
//     one level that differ in x (neighbouring rows, mostly one 32-byte
//     sector), so the hot rows coincide within a warp: __match_any_sync on
//     the row, the matching lanes' contributions (each rounded to bf16 by
//     its own lane first, as the twin rounds per pick) summed in f32 into
//     the lowest of them, which adds the row with one vector RED (float2
//     at F = 2, float4 at F = 4, two at F = 8). Lanes past B take part with
//     a sentinel row and add nothing;
//   - a block takes 32 samples at LC levels (ops/cuda/ext_kernel.py:
//     lookup_chunk; a level a block at the eikonal term's 1024 points, so
//     that the card still gets two blocks an SM), stages their indices,
//     weights and cotangents in shared memory, each thread decoding its
//     column once, so the loads and the dots' stores stay coalesced; the
//     dots keep their F-wide table-row loads, U tasks' at a time, and the
//     twin's f order (__fmul_rn/__fadd_rn).
//   The table half, which the data term launches alone, is what the design
//   speeds; the dots alone (the eikonal term, at 1024 points) stay slower
//   than the first-slice kernel's, 0.036 against 0.024 ms at 2^16: the
//   staging and the lanes' random rows (32 samples of one corner a warp, as
//   first built, took 0.048). A null dT or dcw skips that half.
//   The wrappers zero the gradients.
#include "ext_common.cuh"

namespace tcnn {

// Threads of a K11 global-route block, and its blocks an SM at most (a
// grid-stride walk past that); items a warp of a private block loads
// before it adds them.
constexpr int kScatterGlobalThreads = 256;
constexpr int kScatterGlobalPerSm = 8;
constexpr int kScatterUnroll = 8;
// The key of a lane with nothing to add (warp_sum).
constexpr int kNoRow = -1;

// Lanes holding the same key (all 32 lanes take part; kNoRow is a key like
// any other): the lowest of them returns true with their `acc` summed in
// f32, its own first, then the others' in lane order. The others' `acc`
// stay as they were.
template <int N>
__device__ __forceinline__ bool warp_sum(int key, float* acc) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
  unsigned rest = leader ? peers & (peers - 1u) : 0u;
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : (int)lane;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float o = __shfl_sync(0xffffffffu, acc[n], src);
      if (rest) acc[n] = __fadd_rn(acc[n], o);
    }
    rest &= rest - 1u;
  }
  return leader;
}

// A walk over the picks of levels [l0, l0 + nl) of samples [b, b_end) in
// V-feature items: item (sample, corner c, level l, slice s) with s
// fastest, then l, then c; a thread's first item `start` past sample b's
// first, then every `stride`-th, on 32-bit counters. Columns are c * NL + l
// (ext_common.cuh), so neighbouring items read neighbouring cotangents in
// runs of nl * F. The item's column and slice are decoded (two 32-bit
// divisions) only when a step moves them: never where the stride is a
// multiple of the items a sample (a private warp's 32 at PPNG1 and PPNG2).
struct PickWalk {
  long b, b_end, K;
  unsigned r, per_sample, slices, sb, sr, col, s;
  int NL, nl, l0;

  __device__ PickWalk(int NL_, int C, int F, int V, int l0_, int nl_, long b0, long b1,
                      unsigned start, unsigned stride)
      : b(b0), b_end(b1), K((long)C * NL_), NL(NL_), nl(nl_), l0(l0_) {
    slices = F / V;
    per_sample = (unsigned)C * nl * slices;
    sb = stride / per_sample;
    sr = stride % per_sample;
    b += start / per_sample;
    r = start % per_sample;
    decode();
  }
  __device__ void decode() {
    const unsigned q = r / slices, c = q / nl;
    s = r - q * slices;
    col = c * NL + l0 + (q - c * nl);
  }
  __device__ bool on() const { return b < b_end; }
  __device__ long pick() const { return b * K + col; }
  __device__ void next() {
    b += sb;
    if (sr == 0) return;
    r += sr;
    if (r >= per_sample) {
      r -= per_sample;
      ++b;
    }
    decode();
  }
};

// K11's private route: block (x, y) sums group y's levels [y * G, y * G +
// G) (fewer in the last group, up to n_private) over its share x of the
// samples in a shared f32 copy of their rows (contiguous from the first
// level's), then adds the copy to the gradient. Warp w alone owns the
// group's levels [w * lpw, w * lpw + lpw) and adds to them by plain loads
// and stores, so no shared atomic is made (a shared f32 atomicAdd is a
// compare-and-swap loop on this card) and no two lanes or warps write one
// word at once: each step its lanes load kScatterUnroll items each and,
// where no two of them fall on one slice of a row (found by shuffles with
// the few lanes that share a lane's level and slice), add them; else the
// items on one slice are summed first (warp_sum, a __match_any_sync,
// whose cost is most of this route's where every step takes it) into the
// lowest lane, which adds them.
template <typename TC, int V>
__global__ void __launch_bounds__(1024)
    ext_scatter_private_kernel(const int* __restrict__ idx, const TC* __restrict__ ct,
                               float* __restrict__ gtable, long B, int NL, int C, int F,
                               int rows_per_level, int group_levels, int n_private, int lpw) {
  extern __shared__ __align__(16) float priv[];
  const int l0 = blockIdx.y * group_levels;
  const int nl = min(group_levels, n_private - l0);
  const int floats = nl * rows_per_level * F;
  const int base = l0 * rows_per_level;
  for (int i = threadIdx.x; i < floats; i += blockDim.x) priv[i] = 0.f;
  __syncthreads();
  const int la = (threadIdx.x >> 5) * lpw;
  if (la < nl) {
    const long b0 = B * blockIdx.x / gridDim.x, b1 = B * (blockIdx.x + 1) / gridDim.x;
    const int wl = min(lpw, nl - la);
    // lanes per (sample, corner) run; where the runs tile the warp, lane j
    // keeps its (level, slice) every step and shares it only with lanes
    // j ^ m for m = P, 2P, ... (the other corners and samples of the step):
    // checked by shuffles where those are at most 3 (P >= 8)
    const int P = wl * (F / V);
    const bool fixed = 32 % (C * P) == 0 && P >= 8;
    PickWalk w(NL, C, F, V, l0 + la, wl, b0, b1, threadIdx.x & 31, 32);
    while (__any_sync(0xffffffffu, w.on())) {
      int key[kScatterUnroll];
      float v[kScatterUnroll][V];
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        key[u] = kNoRow;
#pragma unroll
        for (int k = 0; k < V; ++k) v[u][k] = 0.f;
        if (w.on()) {
          const long p = w.pick();
          key[u] = (idx[p] - base) * (F / V) + (int)w.s;
          load_vec<V>(ct + p * F + w.s * V, v[u]);
        }
        w.next();
      }
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        bool clash = !fixed;
        for (int m = P; fixed && m < 32; m += P)
          clash |= __shfl_xor_sync(0xffffffffu, key[u], m) == key[u] && key[u] != kNoRow;
        if ((!__any_sync(0xffffffffu, clash) || warp_sum<V>(key[u], v[u])) && key[u] != kNoRow) {
          float* dst = priv + key[u] * V;
          float old[V];
          load_vec<V>(dst, old);
#pragma unroll
          for (int k = 0; k < V; ++k) dst[k] = __fadd_rn(old[k], v[u][k]);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* out = gtable + (long)base * F;
  for (int i = V * threadIdx.x; i < floats; i += V * blockDim.x) {
    float v[V];
    load_vec<V>(priv + i, v);
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) any |= v[k] != 0.f;
    if (any) atomic_add_row<V>(out + i, v);
  }
}

// K11's global route: levels [l0, NL) of every sample, one vector RED per
// item.
template <typename TC, int V>
__global__ void __launch_bounds__(kScatterGlobalThreads)
    ext_scatter_global_kernel(const int* __restrict__ idx, const TC* __restrict__ ct,
                              float* __restrict__ gtable, long B, int NL, int C, int F, int l0) {
  PickWalk w(NL, C, F, V, l0, NL - l0, 0, B, blockIdx.x * blockDim.x + threadIdx.x,
             gridDim.x * blockDim.x);
  for (; w.on(); w.next()) {
    const long p = w.pick();
    float v[V];
    load_vec<V>(ct + p * F + w.s * V, v);
    atomic_add_row<V>(gtable + (long)idx[p] * F + w.s * V, v);
  }
}

template <typename TC, int V>
static int launch_scatter(const int* idx, const void* ct_raw, float* gtable, long B, int NL, int C,
                          int F, int rows_per_level, int n_private, int group_levels, int warps,
                          int blocks, int device, cudaStream_t s) {
  const TC* ct = static_cast<const TC*>(ct_raw);
  cudaError_t e = cudaSuccess;
  if (n_private > 0) {
    const unsigned groups = (unsigned)((n_private + group_levels - 1) / group_levels);
    const int lpw = (group_levels + warps - 1) / warps;
    const size_t smem = (size_t)group_levels * rows_per_level * F * sizeof(float);
    e = cudaFuncSetAttribute(ext_scatter_private_kernel<TC, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ext_scatter_private_kernel<TC, V><<<dim3((unsigned)blocks, groups), 32 * warps, smem, s>>>(
        idx, ct, gtable, B, NL, C, F, rows_per_level, group_levels, n_private, lpw);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n_private < NL) {
    int n_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    const long items = B * C * (NL - n_private) * (F / V);
    const long most = (long)n_sm * kScatterGlobalPerSm;
    const long grid = (items + kScatterGlobalThreads - 1) / kScatterGlobalThreads;
    ext_scatter_global_kernel<TC, V><<<(unsigned)(grid < most ? grid : most),
                                       kScatterGlobalThreads, 0, s>>>(idx, ct, gtable, B, NL, C,
                                                                      F, n_private);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <typename TC>
static int launch_scatter_v(const int* idx, const void* ct, float* gtable, long B, int NL, int C,
                            int F, int rows_per_level, int n_private, int group_levels, int warps,
                            int blocks, int device, cudaStream_t s) {
  if (F % 4 == 0)
    return launch_scatter<TC, 4>(idx, ct, gtable, B, NL, C, F, rows_per_level, n_private,
                                 group_levels, warps, blocks, device, s);
  if (F % 2 == 0)
    return launch_scatter<TC, 2>(idx, ct, gtable, B, NL, C, F, rows_per_level, n_private,
                                 group_levels, warps, blocks, device, s);
  return launch_scatter<TC, 1>(idx, ct, gtable, B, NL, C, F, rows_per_level, n_private,
                               group_levels, warps, blocks, device, s);
}

// K13: warps, the staged columns (corners x levels) of a chunk.
constexpr int kLookupWarps = 8;
constexpr int kTileCols = 64;

// Block (i, y) takes samples [32 i, 32 i + 32) at levels [y LC, y LC + LC)
// (C * LC <= kTileCols columns, LC * F <= kTileCols cotangents a sample):
// the chunk's indices, weights and cotangents staged in shared memory
// (column k = c * lc + l of the chunk is c * NL + la + l of the sample),
// then warp w takes the chunk's tasks w, w + kLookupWarps, ..., U at a
// time (their table rows loaded together): a task is 16 samples at a pair
// of corners that differ in x, whose rows are neighbours and mostly share
// a 32-byte sector, so a warp holds 16 samples of each corner.
template <int F>
__global__ void __launch_bounds__(kLookupWarps * 32, F <= 2 ? 5 : 4)
    ext_lookup_bwd_kernel(const bf16* __restrict__ table, const int* __restrict__ idx,
                          const float* __restrict__ cw, const float* __restrict__ gy,
                          float* __restrict__ gtable, float* __restrict__ dcw, long B, int NL,
                          int C, int LC) {
  constexpr int U = F >= 4 ? 2 : 4;
  __shared__ int s_idx[32][kTileCols + 1];
  __shared__ float s_cw[32][kTileCols + 1];
  __shared__ float s_gy[32][kTileCols + 1];
  __shared__ float s_dcw[32][kTileCols + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long b0 = (long)blockIdx.x * 32;
  const int n_s = B - b0 < 32 ? (int)(B - b0) : 32;
  const long CNL = (long)C * NL;
  {
    const int la = blockIdx.y * LC;
    const int lc = min(LC, NL - la), W = C * lc, GW = lc * F;
    // staging: thread t < (blockDim.x / W) W takes the chunk's column
    // k = t % W of samples t / W, t / W + blockDim.x / W, ..., its column
    // decoded once; likewise the cotangents.
    const int k = threadIdx.x % W, s0 = threadIdx.x / W, ds = blockDim.x / W;
    const long col = (long)(k / lc) * NL + la + k % lc;
    for (int s = s0; s < 32 && s0 < ds; s += ds) {
      const long at = (b0 + s) * CNL + col;
      s_idx[s][k] = s < n_s ? idx[at] : kNoRow;
      if (gtable != nullptr) s_cw[s][k] = s < n_s ? cw[at] : 0.f;
    }
    const int kg = threadIdx.x % GW, sg0 = threadIdx.x / GW, dsg = blockDim.x / GW;
    for (int s = sg0; s < 32 && sg0 < dsg; s += dsg)
      s_gy[s][kg] = s < n_s ? gy[(b0 + s) * NL * F + (long)la * F + kg] : 0.f;
    __syncthreads();
    // task q: samples [16 (q & 1), 16 (q & 1) + 16) of the chunk's corner pair
    // (2 cp, 2 cp + 1) at level l, pu = q >> 1 = cp * lc + l; lane j takes
    // sample j >> 1 of them at corner 2 cp + (j & 1)
    const int tasks = 2 * ((C + 1) / 2) * lc;
    for (int q0 = warp; q0 < tasks; q0 += kLookupWarps * U) {
      int row[U], col[U], smp[U];
      float g[U][F], v[U][F];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * kLookupWarps, pu = q >> 1, cp = pu / lc, l = pu - cp * lc;
        const int c = 2 * cp + (lane & 1);
        smp[u] = 16 * (q & 1) + (lane >> 1);
        col[u] = c * lc + l;
        const bool on = q < tasks && c < C;
        row[u] = on ? s_idx[smp[u]][col[u]] : kNoRow;
#pragma unroll
        for (int f = 0; f < F; ++f) g[u][f] = on ? s_gy[smp[u]][l * F + f] : 0.f;
        if (dcw != nullptr && row[u] != kNoRow) load_bf16<F>(table + (long)row[u] * F, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (q0 + u * kLookupWarps >= tasks) break;
        if (gtable != nullptr) {
          const float w = row[u] != kNoRow ? s_cw[smp[u]][col[u]] : 0.f;
          float acc[F];
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = round_bf16(__fmul_rn(w, g[u][f]));
          if (warp_sum<F>(row[u], acc) && row[u] != kNoRow)
            atomic_add_row<F>(gtable + (long)row[u] * F, acc);
        }
        if (dcw != nullptr && col[u] < W) {
          float d = 0.f;
          if (row[u] != kNoRow) {
            d = __fmul_rn(v[u][0], g[u][0]);
#pragma unroll
            for (int f = 1; f < F; ++f) d = __fadd_rn(d, __fmul_rn(v[u][f], g[u][f]));
          }
          s_dcw[smp[u]][col[u]] = d;
        }
      }
    }
    __syncthreads();
    if (dcw != nullptr) {
      for (int s = s0; s < n_s && s0 < ds; s += ds) dcw[(b0 + s) * CNL + col] = s_dcw[s][k];
    }
  }
}

template <int F>
static int launch_lookup_bwd(const bf16* table, const int* idx, const float* cw, const float* gy,
                             float* gtable, float* dcw, long B, int NL, int C, int LC,
                             cudaStream_t s) {
  if (LC * F > kTileCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(B, 32), (unsigned)((NL + LC - 1) / LC));
  ext_lookup_bwd_kernel<F><<<grid, kLookupWarps * 32, 0, s>>>(table, idx, cw, gy, gtable, dcw, B,
                                                               NL, C, LC);
  return (int)cudaGetLastError();
}

}  // namespace tcnn

// gtable [n_rows, F] f32 += ct [B * K picks, F] (f32, or bf16 when ct_bf16)
// at rows idx [B, K], column j of level j % NL; level l's rows are
// [l * rows_per_level, (l + 1) * rows_per_level). The plan (ext_kernel.py:
// scatter_plan): levels 0..n_private-1 summed in shared memory, in groups
// of group_levels consecutive levels, each group's samples split over
// `blocks` blocks of `warps` warps (each owning ceil(group_levels / warps)
// of its levels); levels n_private..NL-1 by vector atomics.
extern "C" int tcnn_ext_scatter(const void* idx, const void* ct, void* gtable, int B, int K, int F,
                                int ct_bf16, int NL, int rows_per_level, int n_private,
                                int group_levels, int warps, int blocks, int device,
                                void* stream) {
  using namespace tcnn;
  if (F <= 0 || NL <= 0 || K % NL || n_private < 0 || n_private > NL ||
      (n_private > 0 && (group_levels <= 0 || blocks <= 0 || warps <= 0 || warps > 32 ||
                         (long)group_levels * rows_per_level * F * 4 > 232448)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int* ip = static_cast<const int*>(idx);
  float* gt = static_cast<float*>(gtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_bf16)
    return launch_scatter_v<bf16>(ip, ct, gt, B, NL, K / NL, F, rows_per_level, n_private,
                                  group_levels, warps, blocks, device, s);
  return launch_scatter_v<float>(ip, ct, gt, B, NL, K / NL, F, rows_per_level, n_private,
                                 group_levels, warps, blocks, device, s);
}

// The backward of tcnn_ext_lookup for the cotangent gy [B, NL * F] f32:
// gtable [n_rows, F] f32 += bf16(cw * gy) at each pick's row (skipped when
// gtable is null; cw is then not read), dcw [B, C * NL] f32 = each pick's
// row dotted with gy (skipped when dcw is null; table is then not read).
// The plan (ext_kernel.py:lookup_chunk): LC levels a block, C * LC and
// LC * F at most kTileCols.
extern "C" int tcnn_ext_lookup_bwd(const void* table, const void* idx, const void* cw,
                                   const void* gy, void* gtable, void* dcw, int B, int NL, int C,
                                   int F, int LC, int device, void* stream) {
  using namespace tcnn;
  if (NL <= 0 || C <= 0 || LC <= 0 || C * LC > kTileCols) return (int)cudaErrorInvalidValue;
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
    case 1: return launch_lookup_bwd<1>(tp, ip, wp, gp, gt, dp, B, NL, C, LC, s);
    case 2: return launch_lookup_bwd<2>(tp, ip, wp, gp, gt, dp, B, NL, C, LC, s);
    case 4: return launch_lookup_bwd<4>(tp, ip, wp, gp, gt, dp, B, NL, C, LC, s);
    case 8: return launch_lookup_bwd<8>(tp, ip, wp, gp, gt, dp, B, NL, C, LC, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
