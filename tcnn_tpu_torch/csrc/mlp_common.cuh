// The MLP arguments and the activations, forward and backward, of every
// MLP kernel (K2, K3, K5, K6 and K9, which run their layers on mma.sync
// through mlp_frag.cuh). The activations are applied in f32 to the f32
// accumulators, as mlp_kernel.py:51-62 does.
#pragma once

#include "common.cuh"

namespace tcnn {

enum Act {
  ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_EXPONENTIAL = 3,
  ACT_SIGMOID = 4, ACT_SQUAREPLUS = 5, ACT_SOFTPLUS = 6, ACT_TANH = 7,
};

struct MlpArgs {
  const bf16* weights;  // flat [n_weights] bf16
  int in_w, width, n_hidden, out_w, act, out_act;
};

// Forward activations (common_device.h:102-165), K_ACT = 10.
__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(z, 0.f);
    case ACT_LEAKY_RELU: return z > 0.f ? z : 0.01f * z;
    case ACT_EXPONENTIAL: return expf(z);
    case ACT_SIGMOID: return 1.f / (1.f + expf(-z));
    case ACT_SQUAREPLUS: {
      const float xk = z * 10.f;
      return 0.5f * (xk + sqrtf(xk * xk + 4.f)) / 10.f;
    }
    case ACT_SOFTPLUS: {
      const float t = z * 10.f;
      return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) / 10.f;
    }
    case ACT_TANH: return tanhf(z);
    default: return z;
  }
}

// grad * act'(x) from the post-activation output y (common_device.h:237-304,
// activations.py:activation_bwd_out); Sine has no such form.
__device__ __forceinline__ float act_bwd_out(float g, float y, int act) {
  switch (act) {
    case ACT_RELU: return g * (y > 0.f ? 1.f : 0.f);
    case ACT_LEAKY_RELU: return g * (y > 0.f ? 1.f : 0.01f);
    case ACT_EXPONENTIAL: return g * y;
    case ACT_SIGMOID: return g * y * (1.f - y);
    case ACT_SQUAREPLUS: {
      const float yk = y * 10.f;
      const float y2 = yk * yk;
      return g * (y2 / (y2 + 1.f));
    }
    case ACT_SOFTPLUS: return g * (1.f - expf(-y * 10.f));
    case ACT_TANH: return g * (1.f - y * y);
    default: return g;
  }
}

}  // namespace tcnn
