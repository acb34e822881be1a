"""ctypes bindings for the port's native host runtime
(``csrc/host/tcnn_host.cpp``; counterpart of ``tcnn_tpu/native.py``).

The reference's data path samples each training batch through a CUDA
texture with a device-side PCG32 stream (samples/mlp_learning_an_image.cu,
random.h). This module generates the same stream on the host: deterministic
PCG32 batches in the reference's exact stream layout and OpenMP-parallel
bilinear image sampling, from a C++ shared library that
`ops.cuda._build.host_library` builds with g++ at first use. Every entry
point has a numpy fallback with identical semantics, bit for bit, so the
module works without a toolchain; `HostRng(use_native=True)` demands the
library and raises when it cannot be built. Results are numpy arrays on the
host: the caller moves them to the card.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .ops.cuda import _build

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None

PCG32_MULT = 0x5851F42D4C957F2D
_M64 = (1 << 64) - 1


def _load():
    """The bound library, or None (the reason in `_lib_error`)."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build.host_library()))
        except (RuntimeError, OSError) as e:
            _lib_error = str(e)
            return None

        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tcnn_pcg32_seed.argtypes = [ctypes.c_uint64, ctypes.c_uint64, u64p, u64p]
        lib.tcnn_pcg32_seed.restype = None
        lib.tcnn_pcg32_next_uint.restype = ctypes.c_uint32
        lib.tcnn_pcg32_next_uint.argtypes = [u64p, ctypes.c_uint64]
        lib.tcnn_pcg32_advance.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64]
        lib.tcnn_pcg32_advance.restype = None
        for name in ("tcnn_generate_random_uniform", "tcnn_generate_random_logistic"):
            fn = getattr(lib, name)
            fn.argtypes = [u64p, u64p, ctypes.c_uint64, ctypes.c_float, ctypes.c_float, f32p]
            fn.restype = None
        lib.tcnn_sample_image_bilinear.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_int64, f32p,
        ]
        lib.tcnn_sample_image_bilinear.restype = None
        lib.tcnn_make_image_batch.argtypes = [
            u64p, u64p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, f32p, f32p,
        ]
        lib.tcnn_make_image_batch.restype = None
        lib.tcnn_native_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# numpy fallback with identical semantics
# ---------------------------------------------------------------------------


def _np_pcg32_seed(initstate, initseq=1):
    inc = ((initseq << 1) | 1) & _M64
    state = 0
    state = (state * PCG32_MULT + inc) & _M64
    state = (state + initstate) & _M64
    state = (state * PCG32_MULT + inc) & _M64
    return state, inc


def _np_advance(state, inc, delta):
    cur_mult, cur_plus = PCG32_MULT, inc
    acc_mult, acc_plus = 1, 0
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _M64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _M64
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
        delta >>= 1
    return (acc_mult * state + acc_plus) & _M64


def _np_next_uint(state, inc):
    """(next state, the output of `state`)."""
    xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
    rot = state >> 59
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF
    return (state * PCG32_MULT + inc) & _M64, out


def _np_generate(state, inc, n, transform):
    """(state advanced by n, n draws): virtual thread i of
    T = ceil(ceil(n / 4) / 128) * 128 starts at state advanced by 4 i and
    writes its draws j = 0..3 to out[i + T j] (random.h:40-66)."""
    t = ((n + 3) // 4 + 127) // 128 * 128
    a4, c4 = 1, 0  # the affine map of four steps: s -> a4 s + c4
    for _ in range(4):
        a4 = (a4 * PCG32_MULT) & _M64
        c4 = (c4 * PCG32_MULT + inc) & _M64
    states = []
    s = state
    for _ in range(t):
        states.append(s)
        s = (s * a4 + c4) & _M64
    out = np.empty(n, np.float32)
    for j in range(4):
        idx = np.arange(t, dtype=np.int64) + t * j
        mask = idx < n
        if not mask.any():
            break
        draws = []
        for i, s in enumerate(states):
            states[i], u = _np_next_uint(s, inc)
            draws.append(u)
        u = np.asarray(draws, np.uint32)
        f = ((u >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
        out[idx[mask]] = transform(f[mask])
    return _np_advance(state, inc, n), out


def _np_logistic(f, mean, stddev):
    """logit(f) * stddev * 0.551328895 + mean in f32, the logarithm taken in
    f64 and rounded, as the library computes it."""
    f = np.clip(f, np.float32(1e-7), np.float32(1 - 1e-7))
    logit = np.log((f / (np.float32(1.0) - f)).astype(np.float64)).astype(np.float32)
    return logit * np.float32(stddev) * np.float32(0.551328895) + np.float32(mean)


def _np_sample_bilinear(image, xy):
    h, w = image.shape[:2]
    fx = xy[:, 0] * np.float32(w) - np.float32(0.5)
    fy = xy[:, 1] * np.float32(h) - np.float32(0.5)
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)

    def at(yi, xi):
        return image[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]

    one = np.float32(1.0)
    top = at(y0, x0) * (one - tx) + at(y0, x0 + 1) * tx
    bot = at(y0 + 1, x0) * (one - tx) + at(y0 + 1, x0 + 1) * tx
    return (top * (one - ty) + bot * ty).astype(np.float32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class HostRng:
    """Deterministic PCG32 batch generator, reference stream layout
    (random.h:39-66). Seeded like `default_rng_t rng{1337}`.

    `use_native`: None takes the library when it builds, else the numpy
    fallback; True demands the library (RuntimeError when it cannot be
    built); False takes the fallback."""

    def __init__(self, seed: int = 1337, initseq: int = 1, use_native=None):
        self._native = _load() if use_native in (None, True) else None
        if use_native is True and self._native is None:
            raise RuntimeError(f"native tcnn_host library unavailable: {_lib_error}")
        if self._native is not None:
            self._state = ctypes.c_uint64(0)
            self._inc = ctypes.c_uint64(0)
            self._native.tcnn_pcg32_seed(
                seed & _M64, initseq & _M64,
                ctypes.byref(self._state), ctypes.byref(self._inc),
            )
        else:
            self._py_state, self._py_inc = _np_pcg32_seed(seed & _M64, initseq & _M64)

    @property
    def state(self) -> int:
        if self._native is not None:
            return int(self._state.value)
        return self._py_state

    def advance(self, delta: int) -> None:
        if self._native is not None:
            self._native.tcnn_pcg32_advance(
                ctypes.byref(self._state), self._inc, delta & _M64
            )
        else:
            self._py_state = _np_advance(self._py_state, self._py_inc, delta & _M64)

    def next_uint(self) -> int:
        if self._native is not None:
            return int(
                self._native.tcnn_pcg32_next_uint(
                    ctypes.byref(self._state), self._inc
                )
            )
        self._py_state, out = _np_next_uint(self._py_state, self._py_inc)
        return out

    def uniform(self, n: int, lower: float = 0.0, upper: float = 1.0):
        if self._native is not None:
            out = np.empty(n, np.float32)
            self._native.tcnn_generate_random_uniform(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                n, lower, upper,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        lo, span = np.float32(lower), np.float32(upper) - np.float32(lower)
        self._py_state, out = _np_generate(
            self._py_state, self._py_inc, n, lambda f: f * span + lo,
        )
        return out

    def logistic(self, n: int, mean: float = 0.0, stddev: float = 1.0):
        if self._native is not None:
            out = np.empty(n, np.float32)
            self._native.tcnn_generate_random_logistic(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                n, mean, stddev,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        self._py_state, out = _np_generate(
            self._py_state, self._py_inc, n, lambda f: _np_logistic(f, mean, stddev)
        )
        return out

    def image_batch(self, image: np.ndarray, batch: int):
        """(xy [B,2], rgb [B,C]) - one fused native call per training step."""
        image = np.ascontiguousarray(image, np.float32)
        h, w, c = image.shape
        if self._native is not None:
            xy = np.empty((batch, 2), np.float32)
            rgb = np.empty((batch, c), np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            self._native.tcnn_make_image_batch(
                ctypes.byref(self._state), ctypes.byref(self._inc),
                image.ctypes.data_as(f32p), h, w, c, batch,
                xy.ctypes.data_as(f32p), rgb.ctypes.data_as(f32p),
            )
            return xy, rgb
        xy = self.uniform(batch * 2).reshape(batch, 2)
        return xy, _np_sample_bilinear(image, xy)


def sample_image_bilinear(image: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """OpenMP bilinear sampling (native when available)."""
    image = np.ascontiguousarray(image, np.float32)
    xy = np.ascontiguousarray(xy, np.float32)
    lib = _load()
    if lib is None:
        return _np_sample_bilinear(image, xy)
    h, w, c = image.shape
    out = np.empty((xy.shape[0], c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tcnn_sample_image_bilinear(
        image.ctypes.data_as(f32p), h, w, c,
        xy.ctypes.data_as(f32p), xy.shape[0],
        out.ctypes.data_as(f32p),
    )
    return out
