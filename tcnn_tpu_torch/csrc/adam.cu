// K14: the Adam step (AdaBound, decay, clipping and the exact-zero skip
// rule), in place on the flat f32 parameter vector and its state.
//
// Replaces: no Pallas kernel. The JAX package's Adam is one XLA computation
//   (tcnn_tpu/optimizers/adam.py), which XLA fuses; the port ran it as plain
//   elementwise torch, about 45 launches a step, each a pass over memory and
//   ~15-20 us of host time. The reference fuses it into one kernel
//   (optimizers/adam.h:47-188); so does this one.
// What bounds it on this card: bytes. Each parameter reads its gradient,
//   weight, two moments (4 B each) and its int64 step count (8 B) and writes
//   all but the gradient back: 40 B, 28.6 MB at config_hash's 715,760
//   parameters, 8.5 us at 3.35 TB/s. The two powf and the divisions a
//   parameter are far below the card's f32 rate.
// What the design does about it: one pass, 16-byte accesses. A thread takes
//   four consecutive parameters: a float4 each of g, w, m1, m2 and two
//   longlong2 of param_steps, in a grid-stride loop; the matrix / non-matrix
//   boundary is an index compare. When any pointer is not 16-byte aligned (a
//   Composite hands a nested Adam a view that may start anywhere), every
//   thread takes one parameter at a time instead; neither path reads past n.
//   The arithmetic is the plain twin's (AdamOptimizer._step_plain), in its
//   order, each operation rounded alone (__fmul_rn / __fadd_rn / __fdiv_rn
//   keep nvcc from contracting a product and a sum into an FMA), so the
//   kernel agrees with the twin run on the card bit for bit; powf and the
//   int64 -> f32 conversion are the ones torch's CUDA kernels call.
// The global step: every thread uses the step read at its block's start
//   plus one (AdaBound's bounds), and the last block to arrive, by an
//   arrival count that wraps back to 0, writes it; no block writes it while
//   another may still read it, and the host never reads the device.
#include "common.cuh"

#include <float.h>

namespace tcnn {

enum AdamFlags : int {
  kAdaBound = 1,
  kClip = 2,
  kOptimizeMatrix = 4,
  kOptimizeNonMatrix = 8,
};

struct AdamArgs {
  long n, n_matrix;
  float loss_scale, l2_reg, beta1, one_minus_beta1, beta2, one_minus_beta2, epsilon;
  float lr_matrix, lr_non_matrix, non_matrix_factor;
  float relative_decay, absolute_decay, clipping_magnitude;
  int flags;
};

// torch.clamp's element rule: NaN stays NaN.
__device__ __forceinline__ float clamp_like_torch(float v, float lower, float upper) {
  return v != v ? v : fminf(fmaxf(v, lower), upper);
}

// Per-block values: the learning rates (a device lr_scale multiplies the
// matrix rate, and the non-matrix factor then multiplies that) and
// AdaBound's bounds from the new global step.
struct AdamBlock {
  float lr_matrix, lr_non_matrix, lower, upper;
};

__device__ __forceinline__ AdamBlock adam_block(const AdamArgs& a, long long new_step,
                                                const float* lr_scale) {
  AdamBlock b;
  if (lr_scale != nullptr) {
    b.lr_matrix = __fmul_rn(*lr_scale, a.lr_matrix);
    b.lr_non_matrix = __fmul_rn(b.lr_matrix, a.non_matrix_factor);
  } else {
    b.lr_matrix = a.lr_matrix;
    b.lr_non_matrix = a.lr_non_matrix;
  }
  if (a.flags & kAdaBound) {
    const float gs = __ll2float_rn(new_step);
    const float c = __fmul_rn(gs, a.one_minus_beta2);
    b.lower = __fsub_rn(0.1f, __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(c, 1.0f)), 0.1f));
    b.upper = __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, c), 0.1f), 0.1f);
  } else {
    b.lower = 0.0f;
    b.upper = FLT_MAX;
  }
  return b;
}

// One parameter, in place; an inactive one is left as it is.
__device__ __forceinline__ void adam_element(const AdamArgs& a, const AdamBlock& b, long i,
                                             float graw, float& w, float& m1, float& m2,
                                             long long& steps) {
  const bool is_matrix = i < a.n_matrix;
  float g = __fdiv_rn(graw, a.loss_scale);
  const bool active = is_matrix ? (a.flags & kOptimizeMatrix) != 0
                                : (a.flags & kOptimizeNonMatrix) != 0 && g != 0.0f;
  if (!active) return;
  if (is_matrix) g = __fadd_rn(g, __fmul_rn(w, a.l2_reg));
  const float nm1 = __fadd_rn(__fmul_rn(m1, a.beta1), __fmul_rn(g, a.one_minus_beta1));
  const float nm2 = __fadd_rn(__fmul_rn(m2, a.beta2), __fmul_rn(__fmul_rn(g, a.one_minus_beta2), g));
  const long long t_steps = steps + 1;
  const float t = __ll2float_rn(t_steps);
  float lr = is_matrix ? b.lr_matrix : b.lr_non_matrix;
  lr = __fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.0f, powf(a.beta2, t))));
  lr = __fdiv_rn(lr, __fsub_rn(1.0f, powf(a.beta1, t)));
  const float eff_lr =
      clamp_like_torch(__fdiv_rn(lr, __fadd_rn(__fsqrt_rn(nm2), a.epsilon)), b.lower, b.upper);
  const float decayed = __fsub_rn(__fmul_rn(__fsub_rn(1.0f, __fmul_rn(lr, a.relative_decay)), w),
                                  copysignf(__fmul_rn(lr, a.absolute_decay), w));
  float nw = __fsub_rn(decayed, __fmul_rn(eff_lr, nm1));
  if (a.flags & kClip) nw = clamp_like_torch(nw, -a.clipping_magnitude, a.clipping_magnitude);
  w = nw;
  m1 = nm1;
  m2 = nm2;
  steps = t_steps;
}

// VEC: four parameters a thread in 16-byte accesses, the last n % 4 one
// each; otherwise one parameter a thread.
template <bool VEC>
__global__ void adam_step_kernel(AdamArgs a, const float* __restrict__ grads,
                                 float* __restrict__ weights, float* __restrict__ m1,
                                 float* __restrict__ m2, long long* __restrict__ param_steps,
                                 long long* __restrict__ step, const float* __restrict__ lr_scale,
                                 unsigned* __restrict__ arrivals) {
  __shared__ long long old_step;
  if (threadIdx.x == 0) {
    old_step = *step;
    __threadfence();
    if (atomicInc(arrivals, gridDim.x - 1) == gridDim.x - 1) {
      __threadfence();
      *step = old_step + 1;  // every other block has read it
    }
  }
  __syncthreads();
  const AdamBlock b = adam_block(a, old_step + 1, lr_scale);
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  long scalar_from = 0;
  if (VEC) {
    const long n4 = a.n / 4;
    for (long q = first; q < n4; q += stride) {
      const float4 g = reinterpret_cast<const float4*>(grads)[q];
      float4 w = reinterpret_cast<float4*>(weights)[q];
      float4 p = reinterpret_cast<float4*>(m1)[q];
      float4 v = reinterpret_cast<float4*>(m2)[q];
      longlong2 s0 = reinterpret_cast<longlong2*>(param_steps)[2 * q];
      longlong2 s1 = reinterpret_cast<longlong2*>(param_steps)[2 * q + 1];
      const long i = 4 * q;
      adam_element(a, b, i, g.x, w.x, p.x, v.x, s0.x);
      adam_element(a, b, i + 1, g.y, w.y, p.y, v.y, s0.y);
      adam_element(a, b, i + 2, g.z, w.z, p.z, v.z, s1.x);
      adam_element(a, b, i + 3, g.w, w.w, p.w, v.w, s1.y);
      reinterpret_cast<float4*>(weights)[q] = w;
      reinterpret_cast<float4*>(m1)[q] = p;
      reinterpret_cast<float4*>(m2)[q] = v;
      reinterpret_cast<longlong2*>(param_steps)[2 * q] = s0;
      reinterpret_cast<longlong2*>(param_steps)[2 * q + 1] = s1;
    }
    scalar_from = 4 * n4;
  }
  for (long i = scalar_from + first; i < a.n; i += stride) {
    float w = weights[i], p = m1[i], v = m2[i];
    long long s = param_steps[i];
    adam_element(a, b, i, grads[i], w, p, v, s);
    weights[i] = w;
    m1[i] = p;
    m2[i] = v;
    param_steps[i] = s;
  }
}

}  // namespace tcnn

// Pointers: grads, weights, first and second moments (f32 [n]),
// param_steps (int64 [n]), step (int64, 0-d), lr_scale (f32, 0-d, or null:
// lr_matrix and lr_non_matrix are then the rates), arrivals (one unsigned,
// 0 between launches on this stream). flags: AdamFlags.
extern "C" int tcnn_adam_step(const void* grads, void* weights, void* m1, void* m2,
                              void* param_steps, void* step, const void* lr_scale,
                              void* arrivals, int n, int n_matrix, float loss_scale,
                              float l2_reg, float beta1, float one_minus_beta1, float beta2,
                              float one_minus_beta2, float epsilon, float lr_matrix,
                              float lr_non_matrix, float non_matrix_factor, float relative_decay,
                              float absolute_decay, float clipping_magnitude, int flags,
                              int device, void* stream) {
  using namespace tcnn;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const AdamArgs a{n, n_matrix, loss_scale, l2_reg, beta1, one_minus_beta1, beta2,
                   one_minus_beta2, epsilon, lr_matrix, lr_non_matrix, non_matrix_factor,
                   relative_decay, absolute_decay, clipping_magnitude, flags};
  const bool vec = ((reinterpret_cast<uintptr_t>(grads) | reinterpret_cast<uintptr_t>(weights) |
                     reinterpret_cast<uintptr_t>(m1) | reinterpret_cast<uintptr_t>(m2) |
                     reinterpret_cast<uintptr_t>(param_steps)) & 15) == 0;
  const int threads = 256;
  const long units = vec ? ((long)n + 3) / 4 : (long)n;
  long blocks = (units + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks > 4096 ? 4096 : blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_grads = static_cast<const float*>(grads);
  float* f_w = static_cast<float*>(weights);
  float* f_m1 = static_cast<float*>(m1);
  float* f_m2 = static_cast<float*>(m2);
  long long* ps = static_cast<long long*>(param_steps);
  long long* st = static_cast<long long*>(step);
  const float* lr = static_cast<const float*>(lr_scale);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  if (vec) {
    adam_step_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(a, f_grads, f_w, f_m1, f_m2, ps,
                                                                 st, lr, arr);
  } else {
    adam_step_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(a, f_grads, f_w, f_m1, f_m2, ps,
                                                                  st, lr, arr);
  }
  return (int)cudaGetLastError();
}
