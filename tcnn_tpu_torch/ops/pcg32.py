"""PCG32 and the grid's Rng hash in plain PyTorch.

Counterpart of ``tcnn_tpu/ops/pcg32.py`` (the reference's pcg32.h:33-165
and rng_hash, common_device.h:663-677), with its own copy of the python-int
oracle. The kernels compute the same hash in the device function
``rng_hash`` (``csrc/grid_common.cuh``) on native 64-bit integers.

  seed(initstate, initseq): state = 0; inc = (initseq << 1) | 1; next();
    state += initstate; next()
  next_uint: old = state; state = old * MULT + inc;
    ror32(u32(((old >> 18) ^ old) >> 27), old >> 59)
  advance(delta): state = MULT^delta * state + (MULT^delta - 1)/(MULT - 1) * inc,
    by binary exponentiation over the bits of delta (pcg32.h:145-166)
  rng_hash(pos, seed = 1337): delta = XOR_i (u64(pos_i) << (i * (64 // D))),
    bits past 63 dropped; pcg32(seed).advance(delta).next_uint()

`rng_hash` works on int64 tensors holding uint32 values. A torch int64
product that overflows is not a documented wrap, so every 64-bit value is a
pair (hi, lo) of 32-bit halves and every product goes through 16-bit limbs.
The advance folds delta eight bits at a time: for each byte k of delta, a
table of 256 (mult, plus) pairs composes the per-bit steps of that byte's
set bits, in the order `host_rng_hash` applies them. The tables depend on
the seed alone and are built once.
"""

from __future__ import annotations

import functools

import torch

PCG32_MULT = 0x5851F42D4C957F2D
_M64 = (1 << 64) - 1
U32 = 0xFFFFFFFF


# -- the python-int oracle -----------------------------------------------------


def _host_next(state, inc):
    new_state = (state * PCG32_MULT + inc) & _M64
    xorshifted = (((state >> 18) ^ state) >> 27) & U32
    rot = state >> 59
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & U32
    return new_state, out


def host_pcg32_init(initstate: int, initseq: int = 1):
    """(state, inc) after pcg32::seed (pcg32.h:53-59)."""
    inc = ((initseq << 1) | 1) & _M64
    state, _ = _host_next(0, inc)
    state = (state + initstate) & _M64
    state, _ = _host_next(state, inc)
    return state, inc


def host_rng_hash(pos, n_dims: int, seed: int = 1337) -> int:
    """rng_hash of one cell (python ints), bit by bit as pcg32::advance."""
    nbits = 64 // n_dims
    delta = 0
    for i in range(n_dims):
        delta ^= (int(pos[i]) << (i * nbits)) & _M64
    state, inc = host_pcg32_init(seed)
    cur_mult, cur_plus = PCG32_MULT, inc
    acc_mult, acc_plus = 1, 0
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _M64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _M64
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
        delta >>= 1
    state = (acc_mult * state + acc_plus) & _M64
    return _host_next(state, inc)[1]


@functools.lru_cache(maxsize=None)
def advance_tables(seed: int = 1337):
    """(state, inc, mults, pluses): the seeded generator and the 64 per-bit
    (cur_mult, cur_plus) constants of pcg32::advance, which do not depend
    on delta (pcg32.h:151-164)."""
    state, inc = host_pcg32_init(seed)
    cur_mult, cur_plus = PCG32_MULT, inc
    mults, pluses = [], []
    for _ in range(64):
        mults.append(cur_mult)
        pluses.append(cur_plus)
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
    return state, inc, tuple(mults), tuple(pluses)


@functools.lru_cache(maxsize=None)
def _byte_tables(seed: int):
    """[8, 256] tables (mult, plus) of python ints: entry [k, v] composes the
    per-bit steps of the set bits of byte value v at byte k of delta."""
    _, _, mults, pluses = advance_tables(seed)
    out = []
    for k in range(8):
        rows = []
        for v in range(256):
            m, p = 1, 0
            for j in range(8):
                if (v >> j) & 1:
                    m = (m * mults[8 * k + j]) & _M64
                    p = (p * mults[8 * k + j] + pluses[8 * k + j]) & _M64
            rows.append((m, p))
        out.append(rows)
    return out


@functools.lru_cache(maxsize=None)
def _byte_tables_on(seed: int, device: str):
    """The byte tables as int64 tensors [8, 256] of 32-bit halves on
    `device`: (mult hi, mult lo, plus hi, plus lo)."""
    tables = _byte_tables(seed)
    halves = [[[m >> 32 for m, _ in t] for t in tables], [[m & U32 for m, _ in t] for t in tables],
              [[p >> 32 for _, p in t] for t in tables], [[p & U32 for _, p in t] for t in tables]]
    return tuple(torch.tensor(h, dtype=torch.int64, device=device) for h in halves)


# -- 64-bit arithmetic on (hi, lo) pairs of int64 tensors holding uint32 ----------


def _mul32_wide(a, b):
    """The full 64-bit product of uint32 values, as (hi, lo): four 16 x 16
    products, each below 2^32."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0  # < 2^33
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = a1 * b1 + (mid >> 16) + (lo >> 32)
    return hi & U32, lo & U32


def _mul32_low(a, b):
    """The low 32 bits of a product of uint32 values."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & U32


def _mul64(a, b):
    """(a * b) mod 2^64 of (hi, lo) pairs."""
    hi, lo = _mul32_wide(a[1], b[1])
    hi = (hi + _mul32_low(a[0], b[1]) + _mul32_low(a[1], b[0])) & U32
    return hi, lo


def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & U32, lo & U32


def _shl64(v, s: int):
    """A uint32 value shifted left by s bits within 64 bits, as (hi, lo)."""
    if s >= 64:
        return torch.zeros_like(v), torch.zeros_like(v)
    if s >= 32:
        return (v << (s - 32)) & U32, torch.zeros_like(v)
    if s == 0:
        return torch.zeros_like(v), v
    return (v >> (32 - s)) & U32, (v << s) & U32


def rng_hash(cells, n_dims: int, seed: int = 1337):
    """rng_hash of uint32 cells: int64 [..., D] -> int64 [...] holding
    uint32 values, bit-equal to `host_rng_hash`."""
    nbits = 64 // n_dims
    dhi = torch.zeros_like(cells[..., 0])
    dlo = torch.zeros_like(dhi)
    for i in range(n_dims):
        h, l = _shl64(cells[..., i], i * nbits)
        dhi, dlo = dhi ^ h, dlo ^ l
    mh, ml, ph, pl = _byte_tables_on(seed, str(cells.device))
    acc_m = acc_p = None
    for k in range(8):
        byte = ((dlo if k < 4 else dhi) >> (8 * (k % 4))) & 0xFF
        m = (mh[k][byte], ml[k][byte])
        p = (ph[k][byte], pl[k][byte])
        if acc_m is None:
            acc_m, acc_p = m, p
        else:
            acc_m, acc_p = _mul64(acc_m, m), _add64(_mul64(acc_p, m), p)
    state0 = advance_tables(seed)[0]
    st = (torch.full_like(dhi, state0 >> 32), torch.full_like(dhi, state0 & U32))
    sh, sl = _add64(_mul64(acc_m, st), acc_p)
    # next_uint's output from the advanced state: xorshifted = u32(((s >> 18)
    # ^ s) >> 27), i.e. bits 27..58 of s ^ (s >> 18); rot = s >> 59
    yh = sh ^ (sh >> 18)
    yl = sl ^ (((sl >> 18) | (sh << 14)) & U32)
    xorshifted = ((yl >> 27) | (yh << 5)) & U32
    rot = sh >> 27
    return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & U32
