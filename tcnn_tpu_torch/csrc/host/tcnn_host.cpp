// tcnn_tpu_torch native host runtime: the port's copy of the JAX package's
// native/tcnn_host.cpp (the port reads none of that package's files).
//
// The reference's host/data path samples training batches through a CUDA
// texture with a device-side PCG32 stream (reference:
// samples/mlp_learning_an_image.cu:222-266, random.h:39-87,
// dependencies/pcg32/pcg32.h). This C ABI shared library (OpenMP-parallel),
// bound from Python with ctypes (tcnn_tpu_torch/native.py), generates the
// same stream on the host and samples the image there.
//
// The PCG32 stream layout reproduces the reference's generate_random kernel
// EXACTLY (random.h:40-66): with T = ceil(ceil(n/4)/128)*128 virtual
// threads, virtual thread i advances the generator by 4*i and writes draws
// j=0..3 to out[i + T*j]; afterwards the host state advances by n. A run
// seeded with 1337 therefore produces the same coordinate stream as the
// reference demo on GPU.
//
// One change from the JAX package's copy: the logistic transform takes its
// logarithm in double and rounds it to float, so that the numpy fallback
// (np.log in float64) reproduces it bit for bit; float logf and numpy's
// float32 log differ in the last bit of about 1% of draws.
//
// Build: ops/cuda/_build.py:host_library (g++ -O3 -std=c++17 -fPIC -fopenmp
// -shared), at first use.

#include <cmath>
#include <cstdint>
#include <cstddef>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr uint64_t PCG32_MULT = 0x5851f42d4c957f2dULL;

struct Pcg32 {
    uint64_t state;
    uint64_t inc;

    void raw_seed(uint64_t initstate, uint64_t initseq) {
        state = 0u;
        inc = (initseq << 1u) | 1u;
        next_uint();
        state += initstate;
        next_uint();
    }

    uint32_t next_uint() {
        uint64_t old = state;
        state = old * PCG32_MULT + inc;
        uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
        uint32_t rot = (uint32_t)(old >> 59u);
        return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31u));
    }

    float next_float() {
        union {
            uint32_t u;
            float f;
        } x;
        x.u = (next_uint() >> 9) | 0x3f800000u;
        return x.f - 1.0f;
    }

    void advance(uint64_t delta) {
        uint64_t cur_mult = PCG32_MULT, cur_plus = inc;
        uint64_t acc_mult = 1u, acc_plus = 0u;
        while (delta > 0) {
            if (delta & 1) {
                acc_mult *= cur_mult;
                acc_plus = acc_plus * cur_mult + cur_plus;
            }
            cur_plus = (cur_mult + 1) * cur_plus;
            cur_mult *= cur_mult;
            delta /= 2;
        }
        state = acc_mult * state + acc_plus;
    }
};

inline uint64_t virtual_thread_count(uint64_t n) {
    // div_round_up(n, 4) threads, launched in 128-wide blocks
    // (random.h:57-60, common_host.h N_THREADS_LINEAR=128)
    uint64_t n_threads = (n + 3) / 4;
    uint64_t n_blocks = (n_threads + 127) / 128;
    return n_blocks * 128;
}

template <typename F>
void generate_batched(uint64_t* state, uint64_t* inc, uint64_t n, float* out,
                      F transform) {
    const uint64_t T = virtual_thread_count(n);
    Pcg32 base{*state, *inc};
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < (int64_t)T; ++i) {
        Pcg32 rng = base;
        rng.advance((uint64_t)i * 4);
        for (uint64_t j = 0; j < 4; ++j) {
            uint64_t idx = (uint64_t)i + T * j;
            if (idx >= n) break;
            out[idx] = transform(rng.next_float());
        }
    }
    base.advance(n);
    *state = base.state;
}

}  // namespace

extern "C" {

// -- PCG32 state management (pcg32.h:42-59) ---------------------------------

void tcnn_pcg32_seed(uint64_t initstate, uint64_t initseq, uint64_t* state,
                     uint64_t* inc) {
    Pcg32 rng;
    rng.raw_seed(initstate, initseq);
    *state = rng.state;
    *inc = rng.inc;
}

uint32_t tcnn_pcg32_next_uint(uint64_t* state, uint64_t inc) {
    Pcg32 rng{*state, inc};
    uint32_t v = rng.next_uint();
    *state = rng.state;
    return v;
}

void tcnn_pcg32_advance(uint64_t* state, uint64_t inc, uint64_t delta) {
    Pcg32 rng{*state, inc};
    rng.advance(delta);
    *state = rng.state;
}

// -- batched generation (random.h:39-87 semantics) --------------------------

void tcnn_generate_random_uniform(uint64_t* state, uint64_t* inc, uint64_t n,
                                  float lower, float upper, float* out) {
    generate_batched(state, inc, n, out, [lower, upper](float v) {
        return v * (upper - lower) + lower;
    });
}

void tcnn_generate_random_logistic(uint64_t* state, uint64_t* inc, uint64_t n,
                                   float mean, float stddev, float* out) {
    // logit(v)*stddev*0.551328895 + mean (random.h:78-87)
    generate_batched(state, inc, n, out, [mean, stddev](float v) {
        v = v < 1e-7f ? 1e-7f : (v > 1.0f - 1e-7f ? 1.0f - 1e-7f : v);
        float logit = (float)std::log((double)(v / (1.0f - v)));
        return logit * stddev * 0.551328895f + mean;
    });
}

// -- bilinear image sampling (texture-equivalent) ----------------------------
// image: [H, W, C] float32 row-major; xy: [n, 2] normalized coords (x first);
// out: [n, C]. Pixel-center convention with edge clamp - identical math to
// tcnn_tpu.utils.image.sample_image and the reference's tex2D linear mode.

void tcnn_sample_image_bilinear(const float* image, int64_t h, int64_t w,
                                int64_t c, const float* xy, int64_t n,
                                float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float fx = xy[i * 2 + 0] * (float)w - 0.5f;
        float fy = xy[i * 2 + 1] * (float)h - 0.5f;
        float x0f = std::floor(fx), y0f = std::floor(fy);
        float tx = fx - x0f, ty = fy - y0f;
        int64_t x0 = (int64_t)x0f, y0 = (int64_t)y0f;
        auto cl = [](int64_t v, int64_t hi) {
            return v < 0 ? 0 : (v >= hi ? hi - 1 : v);
        };
        int64_t x0c = cl(x0, w), x1c = cl(x0 + 1, w);
        int64_t y0c = cl(y0, h), y1c = cl(y0 + 1, h);
        const float* r00 = image + (y0c * w + x0c) * c;
        const float* r01 = image + (y0c * w + x1c) * c;
        const float* r10 = image + (y1c * w + x0c) * c;
        const float* r11 = image + (y1c * w + x1c) * c;
        for (int64_t k = 0; k < c; ++k) {
            float top = r00[k] * (1.0f - tx) + r01[k] * tx;
            float bot = r10[k] * (1.0f - tx) + r11[k] * tx;
            out[i * c + k] = top * (1.0f - ty) + bot * ty;
        }
    }
}

// -- fused batch: generate 2-D coords + sample targets (one call per step) --

void tcnn_make_image_batch(uint64_t* state, uint64_t* inc, const float* image,
                           int64_t h, int64_t w, int64_t c, int64_t batch,
                           float* xy_out, float* rgb_out) {
    tcnn_generate_random_uniform(state, inc, (uint64_t)batch * 2, 0.0f, 1.0f,
                                 xy_out);
    tcnn_sample_image_bilinear(image, h, w, c, xy_out, batch, rgb_out);
}

int tcnn_native_version() { return 1; }

}  // extern "C"
