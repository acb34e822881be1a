"""K12's block size and lane map (tcnn_tpu_torch/ops/cuda/ext_kernel.py:
lookup_threads; csrc/ext_gather.cu: ext_lookup8_kernel and, at C != 8, an
odd NL or an idx that is not 8-byte aligned, ext_lookup_any_kernel), on the
CPU.

At C = 8 corners and an even NL a lane sums one (sample, level), corners
c = 0..7 in order, and the lanes of levels 2k and 2k + 1 of a sample split
their loads by the corner's x bit (lane q loads corners 2j + q at both
levels, their indices as one int2), so that corners c and c ^ 1 go out in
one load instruction, then swap the rows of each other's level through
one shuffle. The block size is decided in Python and the map is written
in CUDA, which runs on the card only, so a wrong one would show there
only. These pin the block size, transcribe both kernels lane by lane in
torch (every load's alignment, the swap, the summation order, the stores)
and hold the transcription bit for bit against the plain twin
`_ext_lookup_plain`, at the PPNG3 shapes, ragged batches, clamped rows
(p0 == p1), the hot input, odd NL and C = 3; the twin's corner sum rounded
to bf16 breaks that equality.
"""

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
from tcnn_tpu_torch.ops.encodings import ppng

N_SM = 132
#: chip_smoke.py's hot input: every sample at one point.
HOT_POINT = (0.5, 0.0, 1.0)
#: Block sizes the C side takes (a multiple of 32, at most LOOKUP_THREADS).
THREADS = (64, 128, 256)


def emulate_k12(table, idx, cw, n_levels, threads):
    """csrc/ext_gather.cu:ext_lookup8_kernel transcribed, every lane of the
    grid at once: y [B, NL * F] bf16, and how often each output value was
    stored, each idx and cw element loaded."""
    B, CNL = idx.shape
    C, NL, F = 8, n_levels, table.shape[1]
    P, T = 2, threads
    CL = C // P
    n_pairs = B * NL // P
    n_lanes = -(-n_pairs * P // T) * T  # blocks_for(n * P, threads) blocks
    t = torch.arange(n_lanes)
    q = t % P
    live = t // P < n_pairs
    item = torch.clamp(t // P, max=n_pairs - 1) * P + q  # b * NL + l
    b = item // NL
    l0 = item - b * NL - q
    base = b * C * NL + l0
    idx_f, cw_f = idx.reshape(-1).long(), cw.reshape(-1)
    idx_loads = torch.zeros(B * CNL, dtype=torch.long)
    cw_loads = torch.zeros(B * CNL, dtype=torch.long)
    ones = torch.ones(int(live.sum()), dtype=torch.long)
    raw = {}
    for j in range(CL):
        at = base + (j * P + q) * NL
        assert bool((at % P == 0).all()), "an int2 load off its alignment"
        for v in range(P):
            idx_loads.index_add_(0, (at + v)[live], ones)
            raw[j, v] = table[idx_f[at + v]]  # the row, bf16 [lanes, F]
    w = []
    for c in range(C):
        at = base + c * NL + q
        cw_loads.index_add_(0, at[live], ones)
        w.append(cw_f[at])
    mine, theirs = {}, {}
    qq = (q == 1)[:, None]
    for j in range(CL):
        mine[j] = torch.where(qq, raw[j, 1], raw[j, 0])
        theirs[j] = torch.where(qq, raw[j, 0], raw[j, 1])[t ^ 1]  # shfl_pair
    acc = torch.zeros(n_lanes, F)
    for c in range(C):
        r = torch.where(((c & 1) == q)[:, None], mine[c // 2], theirs[c // 2])
        acc = acc + w[c][:, None] * r.float()  # __fmul_rn, then __fadd_rn
    y = torch.zeros(B * NL * F, dtype=torch.bfloat16)
    stores = torch.zeros(B * NL * F, dtype=torch.long)
    cols = (item[:, None] * F + torch.arange(F))[live].reshape(-1)
    y[cols] = acc[live].to(torch.bfloat16).reshape(-1)
    stores.index_add_(0, cols, torch.ones(cols.numel(), dtype=torch.long))
    return y.reshape(B, NL * F), stores, idx_loads, cw_loads


def emulate_k12_any(table, idx, cw, n_levels):
    """ext_lookup_any_kernel (any C, odd NL, unaligned idx): a thread a
    (sample, level), corners c = 0..C-1 in order."""
    B, CNL = idx.shape
    C, NL = CNL // n_levels, n_levels
    rows = table[idx.long()].float().reshape(B, C, NL, -1)
    wc = cw.reshape(B, C, NL, 1)
    acc = torch.zeros_like(rows[:, 0])
    for c in range(C):
        acc = acc + wc[:, c] * rows[:, c]
    return acc.reshape(B, -1).to(torch.bfloat16)


def inputs(n_levels, f, corners, batch, kind, seed=0):
    """(table bf16, idx int32 [B, C * NL], cw f32): PPNG3's own rows and
    weights where n_levels is even (Q = 16, points uniform, or at 0 and 1
    for clamped rows, or all at HOT_POINT; its first C corners where
    C < 8), else uniform rows and weights."""
    rng = np.random.default_rng(seed)
    if n_levels % 2 == 0:
        enc = ppng.PPNG3Encoding(3, n_quants=16, n_frequencies=n_levels // 2, n_features=f)
        if kind == "hot":
            x = np.tile(np.asarray(HOT_POINT, np.float32), (batch, 1))
        elif kind == "clamped":
            x = rng.integers(0, 2, (batch, 3)).astype(np.float32)
            x[::2] = rng.random((len(x[::2]), 3), dtype=np.float32)
        else:
            x = rng.random((batch, 3), dtype=np.float32)
        idx, cw = enc.indices(torch.from_numpy(x))
        idx, cw = idx[:, :corners * n_levels], cw[:, :corners * n_levels]
        n_rows = enc.spec.n_rows
    else:
        n_rows = n_levels * 64
        shape = (batch, corners * n_levels)
        idx = torch.from_numpy(rng.integers(0, n_rows, shape).astype(np.int32))
        cw = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (n_rows, f)).astype(np.float32)).to(torch.bfloat16)
    return table, idx.contiguous(), cw.contiguous()


def bits(t):
    return t.view(torch.int16)


# ---------------------------------------------------------------------------
# The block size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_levels,batch,want", [
    # PPNG3's sample config (Q 32, 4 frequencies), B = 2^16, and the
    # factory defaults (Q 64, 6 frequencies), B = 2^17: 256-thread blocks
    (8, 1 << 16, 256),
    (12, 1 << 17, 256),
    # the eikonal term's 1024 points: 8,192 or 12,288 lanes, blocks halved
    # to 64 threads (128 or 192 blocks)
    (8, 1024, 64),
    (12, 1024, 64),
    # an odd NL (the first-slice kernel) sizes its blocks the same way
    (3, 1 << 16, 256),
    (1, 1024, 64),
])
def test_lookup_threads_pinned(n_levels, batch, want):
    assert ek.lookup_threads(batch * n_levels, N_SM) == want


@pytest.mark.parametrize("batch,threads", [
    (1, 64), (31, 64), (1024, 64), (2048, 64), (4096, 128), (8192, 256), (1 << 16, 256),
])
def test_lookup_threads_by_batch(batch, threads):
    """Blocks halve from 256 threads down to 64 while the batch's lanes
    leave fewer blocks than SMs (NL = 8: 8 lanes a sample)."""
    assert ek.lookup_threads(batch * 8, N_SM) == threads
    assert threads == 64 or -(-batch * 8 // threads) >= N_SM


@pytest.mark.parametrize("n_levels", [1, 2, 3, 6, 8, 12, 16, 36])
@pytest.mark.parametrize("batch", [1, 1000, 1 << 17])
def test_lookup_threads_names_a_block_size(n_levels, batch):
    """A block size the C side takes: a multiple of 32, at most the
    kernels' __launch_bounds__."""
    assert ek.lookup_threads(batch * n_levels, N_SM) in THREADS


# ---------------------------------------------------------------------------
# The kernels transcribed, against the twin
# ---------------------------------------------------------------------------


def check_emulation(table, idx, cw, n_levels, threads=None):
    """The kernel that csrc/ext_gather.cu:launch_lookup picks for an aligned
    idx, transcribed, against the twin bit for bit."""
    B, CNL = idx.shape
    want = ek._ext_lookup_plain(table, idx, cw, n_levels)
    if CNL // n_levels != 8 or n_levels % 2:
        got = emulate_k12_any(table, idx, cw, n_levels)
        assert torch.equal(bits(got), bits(want))
        return got, want
    threads = threads or ek.lookup_threads(B * n_levels, N_SM)
    got, stores, idx_loads, cw_loads = emulate_k12(table, idx, cw, n_levels, threads)
    assert bool((stores == 1).all()), "an output stored other than once"
    assert bool((idx_loads == 1).all()) and bool((cw_loads == 1).all()), \
        "a pick's index or weight loaded other than once"
    assert torch.equal(bits(got), bits(want))
    return got, want


@pytest.mark.parametrize("corners", [8, 3])
@pytest.mark.parametrize("batch", [1, 31, 1024, (1 << 12) - 37])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("n_levels", [8, 12, 6, 1])
def test_k12_bit_equal_to_twin(n_levels, f, corners, batch):
    check_emulation(*inputs(n_levels, f, corners, batch, "uniform", seed=n_levels * 7 + f),
                    n_levels)


@pytest.mark.parametrize("kind", ["clamped", "hot"])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("n_levels", [8, 12])
def test_k12_clamped_and_hot(n_levels, f, kind):
    table, idx, cw = inputs(n_levels, f, 8, (1 << 12) - 37, kind, seed=3)
    pairs = idx.reshape(idx.shape[0], 4, 2, n_levels)
    same = (pairs[:, :, 0] == pairs[:, :, 1]).float().mean()
    assert same > 0.05, "no clamped x-pair (p0 == p1) in the input"
    if kind == "hot":
        assert bool((idx == idx[:1]).all())
    check_emulation(table, idx, cw, n_levels)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("batch", [31, 1000])
def test_k12_every_block_size(threads, batch):
    """The lane pairs (NL = 12, F = 4) in each block size the C side
    takes, at a ragged batch: lookup_threads may pick any elsewhere."""
    check_emulation(*inputs(12, 4, 8, batch, "uniform", seed=batch), 12, threads)


@pytest.mark.parametrize("corners", [8, 3])
def test_k12_unaligned_idx(corners):
    """An idx view 4 bytes past an 8-byte boundary, as a slice of a larger
    buffer gives: the wrapper takes it, as the twin does (on the card
    launch_lookup routes it to the first-slice kernel, whose loads are
    4 bytes wide), and the result is the aligned input's."""
    table, idx, cw = inputs(8, 2, corners, 1024, "uniform", seed=11)
    buf = torch.empty(idx.numel() + 1, dtype=torch.int32)
    buf[1:] = idx.reshape(-1)
    shifted = buf[1:].view(idx.shape)
    assert shifted.is_contiguous() and shifted.storage_offset() * 4 % 8 == 4
    got = ek.ext_lookup(table, shifted, cw, 8)
    assert torch.equal(bits(got), bits(ek._ext_lookup_plain(table, idx, cw, 8)))
    assert torch.equal(bits(emulate_k12_any(table, shifted, cw, 8)), bits(got))


def test_k12_control_corner_sum_in_bf16():
    """The bit-equality that the card checks sees a corner sum kept in bf16."""
    table, idx, cw = inputs(8, 2, 8, 1024, "uniform", seed=5)
    _, want = check_emulation(table, idx, cw, 8)
    rows = table[idx.long()].float().reshape(1024, 8, 8, 2)
    acc = torch.zeros_like(rows[:, 0])
    for c in range(8):
        acc = (acc + cw.reshape(1024, 8, 8, 1)[:, c] * rows[:, c]).to(torch.bfloat16).float()
    assert (acc.reshape(1024, -1).to(torch.bfloat16).float() != want.float()).float().mean() > 0.2


@pytest.mark.parametrize("n_quants,n_levels,f,share", [(32, 8, 2, 0.8), (64, 12, 4, 0.7)])
def test_k12_pairs_load_x_neighbours(n_quants, n_levels, f, share):
    """In each row-load instruction lanes 2i and 2i + 1 take corners 2j and
    2j + 1 of one (sample, level): rows r and r + 1 (or one row at a
    clamp), in one 32-byte sector for most pairs (7 in 8 rows of 4 bytes
    at the sample config, 3 in 4 of 8 bytes at the defaults)."""
    enc = ppng.PPNG3Encoding(3, n_quants=n_quants, n_frequencies=n_levels // 2, n_features=f)
    x = torch.from_numpy(np.random.default_rng(1).random((1024, 3), dtype=np.float32))
    idx, _ = enc.indices(x)
    rows = idx.reshape(1024, 4, 2, n_levels).long()  # [b, j, x bit, level]
    lo, hi = rows[:, :, 0], rows[:, :, 1]
    assert bool(((hi == lo) | (hi == lo + 1)).all())
    one_sector = ((lo * f * 2) // 32 == (hi * f * 2) // 32).float().mean()
    assert one_sector > share
