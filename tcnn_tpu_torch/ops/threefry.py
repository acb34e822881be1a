"""The stochastic-interpolation draws: Threefry-2x32 (20 rounds) in plain
PyTorch.

The JAX package draws the per-(sample, level) uniforms of stochastic
interpolation as ``jax.random.uniform(PRNGKey(1337), (B, L))``
(``tcnn_tpu/ops/encodings/grid.py:stochastic_uniforms``). With JAX's
partitionable Threefry, element i = b * L + l of that draw is the
Threefry-2x32 cipher of the counter (i >> 32, i & 0xFFFFFFFF) under the key
(0, seed); the two output words are XORed into 32 random bits, whose top 23
become the mantissa of a float in [1, 2), minus 1. So u[b, l] depends on
b * L + l alone, not on B. The kernels compute the same draw in the device
function ``stoch_uniform`` (``csrc/grid_common.cuh``).

Values are int64 tensors holding uint32 words; every sum is masked back to
32 bits, so nothing overflows.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
#: Rotations of the two groups of four rounds (Threefry-2x32, Salmon et al.
#: 2011; jax/_src/prng.py).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & U32


def threefry2x32(key: tuple, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) (int64
    tensors of uint32 values) under the key (k0, k1) (python ints).
    Returns the two output words."""
    k0, k1 = key
    ks = (k0 & U32, k1 & U32, (k0 ^ k1 ^ _PARITY) & U32)
    x0 = (x0 + ks[0]) & U32
    x1 = (x1 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


def uniform_at(index, seed: int = 1337):
    """f32 uniforms in [0, 1) at flat positions `index` (int64 tensor) of
    ``jax.random.uniform(PRNGKey(seed), shape)``."""
    w0, w1 = threefry2x32((0, seed), index >> 32, index & U32)
    bits = (w0 ^ w1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
