"""K2's, K3's, K5's, K6's and K9's layouts and their mma.sync fragment maps,
on the CPU.

K2 (csrc/mlp_fwd.cu), K3 (csrc/fused_infer.cu), K5 (csrc/mlp_bwd.cu), K6
and K9 (csrc/fused_train.cuh) run the MLP on mma.sync.m16n8k16 with the
activations in registers (csrc/mlp_frag.cuh). The card is the only place
they run, so a wrong index (a fragment map, an ldmatrix address, the quad
exchange of the row stores, a unit of the weight gradient dealt twice)
would show there only. These tests pin the Python mirrors of the
shared-memory layouts, tile choices and the weight-gradient plans, and
emulate the header's index arithmetic in numpy (a Python copy of every
address formula, lane by lane) against plain matrix products; K6's and
K9's backward with g split into bf16 hi + lo is emulated against the f32
chain of their twins.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.common import Activation
from tcnn_tpu_torch.ops.cuda import mlp_kernel as mk
from tcnn_tpu_torch.ops.cuda import train_kernel as tk


def _dims(in_w, width, n_hidden, out_w=16):
    return mk.MlpDims(in_w, width, n_hidden, out_w, Activation.ReLU, Activation.NONE)


#: 16x16 weight-gradient units a K5 warp keeps in registers across tiles
#: (csrc/mlp_bwd.cu:K5_REG_UNITS).
REG_UNITS = 4


def mlp_bwd_units(dims, nt, reg_units=REG_UNITS):
    """A Python copy of K5's (and K6's, K9's) weight-gradient plan at nt
    rows a block (csrc/mlp_frag.cuh: layer_units, gw_unit; the wgrad loops
    of csrc/mlp_bwd.cu and csrc/fused_train.cuh): [(layer, o0, c0, warp,
    slot)] for every 16x16 unit gW_layer[o0:o0+16, c0:c0+16], numbered
    layer by layer and row-major within a layer. Unit u belongs to warp
    u % (nt // 16); `slot` is its register slot u // (nt // 16) while that
    is below `reg_units`, else None: its sums then go through the block's
    f32 partial once a tile."""
    n_warps = nt // 16
    units = []
    for i, (fan_out, fan_in) in enumerate(dims.layer_sizes()):
        for o0 in range(0, fan_out, 16):
            for c0 in range(0, fan_in, 16):
                u = len(units)
                slot = u // n_warps if u // n_warps < reg_units else None
                units.append((i, o0, c0, u % n_warps, slot))
    return units


def train_reg_units():
    """K6's and K9's register units a warp (csrc/fused_train.cuh:
    TRAIN_REG_UNITS), read from the source."""
    src = (pathlib.Path(mk.__file__).parents[2] / "csrc" / "fused_train.cuh").read_text()
    return int(re.search(r"constexpr int TRAIN_REG_UNITS = (\d+);", src).group(1))


# (n_hidden, in_w): K3 warps, K3 bytes, K5 rows, K5 bytes, K5 units, all units
# in registers. in_w 32 is config_hash's and the SDF sample's (24 -> 32), 48
# and 16 the PPNG sample models'; out_w 16 throughout.
LAYOUTS = {
    16: {(1, 16): (8, 7680, 128, 26112, 2, True), (1, 32): (8, 12288, 128, 30720, 3, True),
         (1, 48): (8, 16896, 128, 35328, 4, True), (2, 16): (8, 8448, 128, 33024, 3, True),
         (2, 32): (8, 13056, 128, 37632, 4, True), (2, 48): (8, 17664, 128, 42240, 5, True),
         (3, 16): (8, 9216, 128, 39936, 4, True), (3, 32): (8, 13824, 128, 44544, 5, True),
         (3, 48): (8, 18432, 128, 49152, 6, True), (4, 16): (8, 9984, 128, 46848, 5, True),
         (4, 32): (8, 14592, 128, 51456, 6, True), (4, 48): (8, 19200, 128, 56064, 7, True),
         (5, 16): (8, 10752, 128, 53760, 6, True), (5, 32): (8, 15360, 128, 58368, 7, True),
         (5, 48): (8, 19968, 128, 62976, 8, True)},
    32: {(1, 16): (8, 8960, 128, 39680, 4, True), (1, 32): (8, 14080, 128, 44800, 6, True),
         (1, 48): (8, 19200, 128, 49920, 8, True), (2, 16): (8, 11520, 128, 52480, 8, True),
         (2, 32): (8, 16640, 128, 57600, 10, True), (2, 48): (8, 21760, 128, 62720, 12, True),
         (3, 16): (8, 14080, 128, 65280, 12, True), (3, 32): (8, 19200, 128, 70400, 14, True),
         (3, 48): (8, 24320, 128, 75520, 16, True), (4, 16): (8, 16640, 128, 78080, 16, True),
         (4, 32): (8, 21760, 128, 83200, 18, True), (4, 48): (8, 26880, 128, 88320, 20, True),
         (5, 16): (8, 19200, 128, 90880, 20, True), (5, 32): (8, 24320, 128, 96000, 22, True),
         (5, 48): (8, 29440, 128, 101120, 24, True)},
    64: {(1, 16): (8, 11520, 128, 66816, 8, True), (1, 32): (8, 17664, 128, 72960, 12, True),
         (1, 48): (8, 23808, 128, 79104, 16, True), (2, 16): (8, 20736, 128, 94464, 24, True),
         (2, 32): (8, 26880, 128, 100608, 28, True), (2, 48): (8, 33024, 128, 106752, 32, True),
         (3, 16): (8, 29952, 128, 122112, 40, False), (3, 32): (8, 36096, 128, 128256, 44, False),
         (3, 48): (8, 42240, 128, 134400, 48, False), (4, 16): (8, 39168, 128, 149760, 56, False),
         (4, 32): (8, 45312, 128, 155904, 60, False), (4, 48): (8, 51456, 128, 162048, 64, False),
         (5, 16): (8, 48384, 128, 177408, 72, False), (5, 32): (8, 54528, 128, 183552, 76, False),
         (5, 48): (8, 60672, 128, 189696, 80, False)},
    128: {(1, 16): (8, 16640, 128, 121088, 16, True), (1, 32): (8, 24832, 128, 129280, 24, True),
          (1, 48): (8, 33024, 128, 137472, 32, True), (2, 16): (8, 51456, 128, 190720, 80, False),
          (2, 32): (8, 59648, 128, 198912, 88, False), (2, 48): (8, 67840, 128, 207104, 96, False),
          (3, 16): (8, 86272, 64, 170240, 144, False), (3, 32): (8, 94464, 64, 176384, 152, False),
          (3, 48): (8, 102656, 64, 182528, 160, False), (4, 16): (8, 121088, 64, 222464, 208, False),
          (4, 32): (8, 129280, 64, 228608, 216, False), (4, 48): (8, 137472, 32, 178944, 224, False),
          (5, 16): (8, 155904, 32, 212224, 272, False), (5, 32): (8, 164096, 32, 217344, 280, False),
          (5, 48): (8, 172288, 32, 222464, 288, False)},
}


#: K2's layout beyond LAYOUTS' input widths, (width, n_hidden, in_w): (warps,
#: bytes): config_hash at F = 8 (a 128-wide input), and 128 x 5 on it.
K2_WIDE = {(64, 2, 128): (8, 63744), (128, 5, 128): (8, 213248)}


@pytest.mark.parametrize("width,kernel", [pytest.param(w, "K3 K5", id=str(w)) for w in sorted(LAYOUTS)]
                         + [pytest.param(w, "K2", id=f"K2-{w}") for w in sorted(LAYOUTS)])
def test_k3_and_k5_layouts(width, kernel):
    """K3's and K5's layouts and tiles; K2 (csrc/mlp_fwd.cu) runs K3's
    layout without the gather, so its warps and bytes are K3's columns
    (mlp_frag.cuh:frag_tile_warps, frag_tile_smem_bytes), and 16 rows a
    warp are what tcnn_mlp_tile answers for the gate."""
    src = (pathlib.Path(mk.__file__).parents[2] / "csrc" / "mlp_fwd.cu").read_text()
    assert "frag_tile_smem_bytes(m, warps)" in src and "16 * tcnn::frag_tile_warps(m" in src
    for (n_hidden, in_w), want in LAYOUTS[width].items():
        d = _dims(in_w, width, n_hidden)
        if kernel == "K2":
            warps = mk.frag_tile_warps(d)
            assert (warps, mk.frag_tile_smem_bytes(d, warps)) == want[:2], (n_hidden, in_w)
            continue
        warps, nt = mk.frag_tile_warps(d), mk.mlp_bwd_tile(d)
        units = mlp_bwd_units(d, nt)
        got = (warps, mk.frag_tile_smem_bytes(d, warps), nt, mk.mlp_bwd_smem_bytes(d, nt),
               len(units), all(u[4] is not None for u in units))
        assert got == want, (width, n_hidden, in_w)
        assert got[1] <= mk.SMEM_OPTIN and got[3] <= mk.SMEM_OPTIN
        # the next larger K5 tile would not fit
        assert nt == 128 or mk.mlp_bwd_smem_bytes(d, 2 * nt) > mk.SMEM_OPTIN
    if kernel == "K2":
        for (w, n_hidden, in_w), want in K2_WIDE.items():
            if w == width:
                d = _dims(in_w, w, n_hidden)
                assert (mk.frag_tile_warps(d), mk.frag_tile_smem_bytes(d, 8)) == want
                assert want[1] <= mk.SMEM_OPTIN


def test_main_path_shapes_take_the_register_plan():
    """config_hash (32 -> 64 -> 64 -> 16, also the SDF sample's) and the
    PPNG sample models (48 and 16 in) keep every weight-gradient unit in
    registers at 128 rows; 128 x 5 keeps 8 of its 280 and sends the rest
    through the block's partial."""
    for in_w in (32, 48, 16):
        d = _dims(in_w, 64, 2)
        assert mk.mlp_bwd_tile(d) == 128
        assert all(u[4] is not None for u in mlp_bwd_units(d, 128))
    src = (pathlib.Path(mk.__file__).parents[2] / "csrc" / "mlp_bwd.cu").read_text()
    assert re.search(r"constexpr int K5_REG_UNITS = (\d+);", src).group(1) == str(REG_UNITS)
    big = _dims(32, 128, 5)
    units = mlp_bwd_units(big, mk.mlp_bwd_tile(big))
    assert mk.mlp_bwd_tile(big) == 32 and len(units) == 280
    assert sum(u[4] is not None for u in units) == 2 * REG_UNITS
    # config_hash's 28 units: warps 0-3 keep four, warps 4-7 three
    plan = mlp_bwd_units(_dims(32, 64, 2), 128)
    per_warp = np.bincount([u[3] for u in plan], minlength=8)
    assert per_warp.tolist() == [4, 4, 4, 4, 3, 3, 3, 3]
    assert max(u[4] for u in plan) == REG_UNITS - 1


@pytest.mark.parametrize("shape", [(32, 64, 2, 16), (48, 64, 2, 16), (16, 64, 2, 16),
                                   (32, 128, 5, 16), (32, 16, 3, 32), (64, 32, 1, 48)])
def test_k5_units_cover_every_weight_once(shape):
    d = _dims(*shape)
    nt = mk.mlp_bwd_tile(d)
    n_warps = nt // 16
    seen = [np.zeros(s, dtype=int) for s in d.layer_sizes()]
    slots = set()
    for u, (layer, o0, c0, warp, slot) in enumerate(mlp_bwd_units(d, nt)):
        seen[layer][o0:o0 + 16, c0:c0 + 16] += 1
        assert warp == u % n_warps
        if slot is not None:
            assert (warp, slot) not in slots and slot < REG_UNITS
            slots.add((warp, slot))
    assert all((s == 1).all() for s in seen)
    assert sum(s.size for s in seen) == d.n_weights


# ---------------------------------------------------------------------------
# A Python copy of csrc/mlp_frag.cuh's fragment maps and addresses, lane by
# lane (g = lane // 4, t = lane % 4).


def a_pos(lane, j):
    """Word j of an A fragment: (row, first column) of its bf16 pair
    (frag_row, frag_col)."""
    return lane // 4 + (j & 1) * 8, (lane % 4) * 2 + (j >> 1) * 8


def b_pos(lane, j):
    """Word j (0: b0, 1: b1) of a B fragment: (first k, n) of its pair."""
    return (lane % 4) * 2 + 8 * j, lane // 4


def c_pos(lane, e):
    """Element e of a C fragment: (row, column)."""
    return lane // 4 + 8 * (e // 2), (lane % 4) * 2 + e % 2


def rows_first(lane, row0, col0):
    return row0 + (lane & 7) + (lane & 8), col0 + ((lane >> 4) << 3)


def cols_first(lane, row0, col0):
    return row0 + (lane & 7) + ((lane >> 4) << 3), col0 + (lane & 8)


def ldsm_x4(mem, addr, row0, col0, trans):
    """ldmatrix.x4: lane i names row i % 8 of matrix i // 8; thread (g, t)
    receives row g, columns 2t, 2t+1 of each matrix (of its transpose with
    .trans). Returns [32 lanes][4 registers][2 values]."""
    mats = []
    for m in range(4):
        starts = [addr(8 * m + i, row0, col0) for i in range(8)]
        s = np.stack([mem[r, c:c + 8] for r, c in starts])
        mats.append(s.T if trans else s)
    return np.array([[mats[m][lane // 4, 2 * (lane % 4):2 * (lane % 4) + 2] for m in range(4)]
                     for lane in range(32)])


def mma(c, a, b0, b1):
    """mma.sync.m16n8k16 over the warp: c [32][4] += A B from the lanes'
    fragments a [32][4][2], b0, b1 [32][2]."""
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for lane in range(32):
        for j in range(4):
            r, col = a_pos(lane, j)
            A[r, col:col + 2] = a[lane][j]
        for j, b in enumerate((b0, b1)):
            k, n = b_pos(lane, j)
            Bm[k:k + 2, n] = b[lane]
    C = A @ Bm
    return c + np.array([[C[c_pos(lane, e)] for e in range(4)] for lane in range(32)])


def pack_pair(acc):
    """The A fragment of a slab from the pair's accumulators acc[2][32][4]:
    word j takes tile j // 2, elements 2(j % 2) and 2(j % 2) + 1."""
    return np.array([[[acc[j >> 1][lane][(j & 1) * 2], acc[j >> 1][lane][(j & 1) * 2 + 1]]
                      for j in range(4)] for lane in range(32)])


def b_frags(w, p, s, trans):
    if trans:
        return ldsm_x4(w, rows_first, 16 * s, 16 * p, True)
    return ldsm_x4(w, cols_first, 16 * p, 16 * s, False)


def mma_pair(a_slabs, w, p, trans):
    acc = [np.zeros((32, 4)), np.zeros((32, 4))]
    for s, a in enumerate(a_slabs):
        b = b_frags(w, p, s, trans)
        acc[0] = mma(acc[0], a, b[:, 0], b[:, 1])
        acc[1] = mma(acc[1], a, b[:, 2], b[:, 3])
    return acc


def slab_matrix(a):
    """The 16 x 16 block an A fragment holds."""
    out = np.full((16, 16), np.nan)
    for lane in range(32):
        for j in range(4):
            r, c = a_pos(lane, j)
            out[r, c:c + 2] = a[lane][j]
    return out


def _ints(rng, shape):
    """Small integers, so that every emulated sum is exact in any order."""
    return rng.integers(-4, 5, shape).astype(float)


def padded(m):
    """A row-major tile at the kernels' pitch (columns + 8)."""
    return np.concatenate([m, np.full((m.shape[0], 8), np.nan)], axis=1)


def test_fragment_maps_are_bijections_and_c_pairs_are_the_next_a():
    a_cells = sorted((r, c + e) for lane in range(32) for j in range(4)
                     for r, c in [a_pos(lane, j)] for e in range(2))
    assert a_cells == [(r, c) for r in range(16) for c in range(16)]
    b_cells = sorted((k + e, n) for lane in range(32) for j in range(2)
                     for k, n in [b_pos(lane, j)] for e in range(2))
    assert b_cells == [(k, n) for k in range(16) for n in range(8)]
    c_cells = sorted(c_pos(lane, e) for lane in range(32) for e in range(4))
    assert c_cells == [(r, n) for r in range(16) for n in range(8)]
    # tiles 2p and 2p+1 of C, side by side, are slab p's A, word for word
    rng = np.random.default_rng(0)
    C = _ints(rng, (16, 16))
    acc = [np.array([[C[r, q * 8 + n] for r, n in (c_pos(lane, e) for e in range(4))]
                     for lane in range(32)]) for q in range(2)]
    assert np.array_equal(slab_matrix(pack_pair(acc)), C)


def test_padded_pitches_are_bank_conflict_free():
    """ldmatrix's eight 16-byte rows of a matrix fall in distinct bank
    groups, and store_slab's 32 words in distinct banks, at pitch w + 8."""
    for w in (16, 32, 48, 64, 128):
        ld = w + 8
        for addr in (rows_first, cols_first):
            for m in range(4):
                groups = {((r * ld + c) * 2 // 16) % 8
                          for r, c in (addr(8 * m + i, 0, 0) for i in range(8))}
                assert len(groups) == 8, (w, addr.__name__, m)
        for j in range(4):
            banks = {((r * ld + c) * 2 // 4) % 32 for r, c in (a_pos(lane, j) for lane in range(32))}
            assert len(banks) == 32, (w, j)


def k2_input_copy(x, row0, ld):
    """csrc/mlp_fwd.cu's copy of a warp's 16 input rows into its shared
    slice: lane by lane, piece i = lane, lane + 32, ... of 16 * in_w / 8
    16-byte pieces goes to row i // chunks, columns 8 (i % chunks) ..., at
    the pitch ld; rows past the batch are zeros."""
    B, in_w = x.shape
    chunks = in_w // 8
    xs = np.full((16, ld), np.nan)
    for lane in range(32):
        for i in range(lane, 16 * chunks, 32):
            r, c = i // chunks, i % chunks
            xs[r, 8 * c:8 * c + 8] = x[row0 + r, 8 * c:8 * c + 8] if row0 + r < B else 0.0
    return xs


@pytest.mark.parametrize("in_w,width,out_w,k2", [
    pytest.param(32, 64, 16, False, id="32-64-16"), pytest.param(48, 32, 32, False, id="48-32-32"),
    pytest.param(16, 128, 16, False, id="16-128-16"),
    pytest.param(32, 64, 16, True, id="K2-32-64-16"), pytest.param(48, 64, 16, True, id="K2-48-64-16"),
    pytest.param(128, 64, 16, True, id="K2-128-64-16")])
def test_emulated_forward_chain(in_w, width, out_w, k2):
    """frag_forward's first layer (A by ldmatrix from x), a hidden layer (A
    from registers) and the output layer give x W^T, layer by layer. K2's
    cases take x through its input copy first, on the batch's last tile
    (13 of its 16 rows in the batch)."""
    rng = np.random.default_rng(1)
    x = _ints(rng, (16, in_w))
    ws = [_ints(rng, (width, in_w)), _ints(rng, (width, width)),
          _ints(rng, (out_w, width))]
    xs = padded(x)
    if k2:
        batch = _ints(rng, (32 + 13, in_w))
        batch[32:] = x[:13]
        x[13:] = 0.0
        xs = k2_input_copy(batch, 32, in_w + 8)
        assert np.isnan(xs[:, in_w:]).all()  # the pad columns: no ldmatrix reads them
    h = [pack_pair(mma_pair([ldsm_x4(xs, rows_first, 0, 16 * s, False)
                             for s in range(in_w // 16)], padded(ws[0]), p, False))
         for p in range(width // 16)]
    want = x @ ws[0].T
    np.testing.assert_array_equal(np.hstack([slab_matrix(a) for a in h]), want)
    for w in ws[1:]:
        h = [pack_pair(mma_pair(h, padded(w), p, False)) for p in range(w.shape[0] // 16)]
        want = want @ w.T
        np.testing.assert_array_equal(np.hstack([slab_matrix(a) for a in h]), want)


@pytest.mark.parametrize("fan_out,fan_in", [(64, 64), (16, 64), (64, 48)])
def test_emulated_dgrad(fan_out, fan_in):
    """dgrad's G W with W's B fragments by ldmatrix .trans, from G in
    registers and from G in shared memory (the output layer)."""
    rng = np.random.default_rng(2)
    G = _ints(rng, (16, fan_out))
    W = _ints(rng, (fan_out, fan_in))
    regs = [pack_pair([np.array([[G[r, 16 * s + 8 * q + n] for r, n in
                                  (c_pos(lane, e) for e in range(4))] for lane in range(32)])
                       for q in range(2)]) for s in range(fan_out // 16)]
    smem = [ldsm_x4(padded(G), rows_first, 0, 16 * s, False) for s in range(fan_out // 16)]
    for a_slabs in (regs, smem):
        out = np.hstack([slab_matrix(pack_pair(mma_pair(a_slabs, padded(W), p, True)))
                         for p in range(fan_in // 16)])
        np.testing.assert_array_equal(out, G @ W)


def test_emulated_wgrad_units_and_their_flat_stores():
    """unit_mma's G^T h over a tile's rows (both operands by ldmatrix .trans)
    and unit_pair's float2 positions in the flat [fan_out, fan_in] gW."""
    rng = np.random.default_rng(3)
    nt, fan_out, fan_in = 64, 32, 48
    G = _ints(rng, (nt, fan_out))
    h = _ints(rng, (nt, fan_in))
    gw = np.full((fan_out, fan_in), np.nan)
    for o0 in range(0, fan_out, 16):
        for c0 in range(0, fan_in, 16):
            c = [np.zeros((32, 4)), np.zeros((32, 4))]
            for r in range(0, nt, 16):
                a = ldsm_x4(padded(G), cols_first, r, o0, True)
                b = ldsm_x4(padded(h), rows_first, r, c0, True)
                c[0] = mma(c[0], a, b[:, 0], b[:, 1])
                c[1] = mma(c[1], a, b[:, 2], b[:, 3])
            for lane in range(32):  # unit_pair(dst, ld, q, half)
                for q in range(2):
                    for half in range(2):
                        row = o0 + lane // 4 + 8 * half
                        col = c0 + 8 * q + 2 * (lane % 4)
                        gw[row, col:col + 2] = c[q][lane][2 * half:2 * half + 2]
    np.testing.assert_array_equal(gw, G.T @ h)


def test_emulated_row_stores():
    """store_slab_rows: four shuffle rounds inside each quad leave lane t
    with columns 8(t % 2).. of row g + 8(t / 2), in column order."""
    rng = np.random.default_rng(4)
    S = _ints(rng, (16, 16))
    a = [[S[r, c:c + 2] for r, c in (a_pos(lane, j) for j in range(4))] for lane in range(32)]

    def pick(lane, d):  # want(d) of this lane's words
        return a[lane][((d & 1) << 1) | (d >> 1)]

    got = [[None] * 4 for _ in range(32)]
    for k in range(4):
        sent = [pick(lane, (lane % 4 - k) & 3) for lane in range(32)]
        for lane in range(32):
            got[lane][k] = sent[(lane & ~3) | ((lane % 4 + k) & 3)]
    out = np.full((16, 16), np.nan)
    for lane in range(32):
        t = lane % 4
        row, col = lane // 4 + (t >> 1) * 8, (t & 1) * 8
        words = [got[lane][(s - t) & 3] for s in range(4)]
        out[row, col:col + 8] = np.concatenate(words)
    assert np.array_equal(out, S)


# ---------------------------------------------------------------------------
# K6 and K9 (csrc/fused_train.cuh)

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "data" / "config_hash.json"


def _train_net(case):
    """The networks of K6's and K9's paths: config_hash, the reference
    default T=2^19, config_hash at F = 8, the SDF sample's config."""
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    if case == "sdf":
        return tt.create_from_config(3, 1, sdf.CONFIG, device="cpu").network
    cfg = tt.load_config(str(CONFIG))
    cfg["encoding"].update({"T=2^19": {"log2_hashmap_size": 19, "per_level_scale": 2.0},
                            "F=8": {"n_features_per_level": 8}}.get(case, {}))
    return tt.create_from_config(2, 3, cfg, device="cpu").network


# case: (K6 rows, K6 private levels, K6 bytes with them; K9 rows, K9 bytes)
TRAIN_LAYOUTS = {
    "config_hash": (128, 4, 149_760 + 41_280, 128, 149_760 + 128 * 16 * 2 * 4),
    "T=2^19": (128, 3, 149_760 + 43_008, 128, 149_760 + 128 * 16 * 2 * 4),
    "F=8": (128, 1, 215_808 + 8_192, 128, 215_808 + 128 * 16 * 2 * 4),
    "sdf": (128, 3, 149_760 + 64_576, 128, 149_760 + 128 * 12 * 3 * 4),
}


@pytest.mark.parametrize("case", sorted(TRAIN_LAYOUTS))
def test_k6_and_k9_layouts_and_units(case):
    """K6's and K9's tiles, private levels and shared memory at the paths'
    configs fit SMEM_OPTIN, and their weight-gradient plans cover every
    weight once, each (warp, register slot) used once."""
    net = _train_net(case)
    dims, plan = net.network.dims, net.encoding.plan
    nt, n_private, priv = tk.train_layout(net)
    nt9 = tk.ig_tile(net)
    got = (nt, n_private, mk.bwd_smem_bytes(dims, nt, priv_floats=priv), nt9,
           mk.bwd_smem_bytes(dims, nt9, ig_floats=plan.n_levels * plan.d))
    assert got == TRAIN_LAYOUTS[case]
    assert got[2] <= mk.SMEM_OPTIN and got[4] <= mk.SMEM_OPTIN
    for rows in (nt, nt9):
        seen = [np.zeros(s, dtype=int) for s in dims.layer_sizes()]
        slots = set()
        r = train_reg_units()
        for layer, o0, c0, warp, slot in mlp_bwd_units(dims, rows, r):
            seen[layer][o0:o0 + 16, c0:c0 + 16] += 1
            if slot is not None:
                assert (warp, slot) not in slots and slot < r
                slots.add((warp, slot))
        assert all((s == 1).all() for s in seen)
    # config_hash's 28 units all stay in registers at 128 rows
    if case == "config_hash":
        assert all(u[4] is not None for u in mlp_bwd_units(dims, nt, train_reg_units()))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def _split(m):
    """mlp_frag.cuh:split_pair on a block: bf16 hi and the bf16 of the rest."""
    hi = _bf16(m)
    return hi, _bf16(m - hi)


def _frags(m):
    """The A fragments [32][4][2] of a 16 x 16 block (frag_row, frag_col)."""
    return np.array([[m[r, c:c + 2] for r, c in (a_pos(lane, j) for j in range(4))]
                     for lane in range(32)])


def _emulated_split_backward(dims, ws, hs, g_out, nt, with_lo=True):
    """K6's backward (csrc/fused_train.cuh) on nt rows, lane by lane: gout
    split into hi + lo; per layer from the last, wgrad's units (G^T h, hi
    then lo, by ldmatrix .trans) and each warp's dgrad (G W, hi then lo:
    mma_pair_split_smem from gout, mma_pair_split_regs from registers), the
    ReLU transfer on the accumulators and the split again; the first
    layer's dgrad in f32 (fin). Sums are exact in f64. Returns (the flat
    weight gradient, fin). Without `with_lo`, g is bf16 (the control)."""
    H = dims.n_hidden
    g_hi, g_lo = _split(g_out)
    if not with_lo:
        g_lo = np.zeros_like(g_lo)
    regs = None  # per warp: (hi slabs, lo slabs) of G_i
    grads = [None] * (H + 1)
    fin = np.zeros((nt, dims.in_w))
    for i in range(H, -1, -1):
        fan_out, fan_in = ws[i].shape
        gw = np.zeros((fan_out, fan_in))
        for o0 in range(0, fan_out, 16):
            for c0 in range(0, fan_in, 16):
                c = [np.zeros((32, 4)), np.zeros((32, 4))]
                for r in range(0, nt, 16):
                    b = ldsm_x4(padded(hs[i]), rows_first, r, c0, True)
                    for gt in (g_hi, g_lo):
                        a = ldsm_x4(padded(gt), cols_first, r, o0, True)
                        c[0] = mma(c[0], a, b[:, 0], b[:, 1])
                        c[1] = mma(c[1], a, b[:, 2], b[:, 3])
                for lane in range(32):
                    for q in range(2):
                        for half in range(2):
                            gw[o0 + lane // 4 + 8 * half,
                               c0 + 8 * q + 2 * (lane % 4):c0 + 8 * q + 2 * (lane % 4) + 2] = \
                                c[q][lane][2 * half:2 * half + 2]
        grads[i] = gw.reshape(-1)
        new_hi, new_lo, new_regs = np.zeros((nt, fan_in)), np.zeros((nt, fan_in)), []
        for w in range(nt // 16):
            rows = slice(16 * w, 16 * w + 16)
            if i == H:
                his = [ldsm_x4(padded(g_hi[rows]), rows_first, 0, 16 * s, False)
                       for s in range(fan_out // 16)]
                los = [ldsm_x4(padded(g_lo[rows]), rows_first, 0, 16 * s, False)
                       for s in range(fan_out // 16)]
            else:
                his, los = regs[w]
            out_hi, out_lo = [], []
            for p in range(fan_in // 16):
                acc = mma_pair(his, padded(ws[i]), p, True)
                acc_lo = mma_pair(los, padded(ws[i]), p, True)
                m = slab_matrix(pack_pair([acc[0] + acc_lo[0], acc[1] + acc_lo[1]]))
                cols = slice(16 * p, 16 * p + 16)
                if i == 0:
                    fin[rows, cols] = m
                    continue
                m = m * (hs[i][rows, cols] > 0)  # ReLU's transfer from the kept output
                hi, lo = _split(m)
                if not with_lo:
                    lo = np.zeros_like(lo)
                new_hi[rows, cols], new_lo[rows, cols] = hi, lo
                out_hi.append(_frags(hi))
                out_lo.append(_frags(lo))
            new_regs.append((out_hi, out_lo))
        g_hi, g_lo, regs = new_hi, new_lo, new_regs
    return np.concatenate(grads), fin


def test_emulated_split_backward_matches_the_f32_chain():
    """K6's and K9's hi + lo backward against their twins' f32 chain
    (train_kernel._mlp_backward_f32), both in f64 on the same bf16 weights
    and kept outputs. Tolerance 2^-14 norm-relative (hi + lo carries g to
    16 significant bits, 2^-17 relative an element, split again at each of
    three layers; measured 3.4e-6 on the weights and 4.2e-6 on the encoding
    gradient, seeds 5-7); the control, g in bf16 alone (lo dropped), reads
    2.4e-3 to 3.0e-3 and must fail it."""
    rng = np.random.default_rng(5)
    dims = _dims(32, 32, 2)
    nt = 32
    ws = [_bf16(rng.normal(size=s) * 0.3) for s in dims.layer_sizes()]
    x = _bf16(rng.uniform(-1, 1, (nt, dims.in_w)))
    hs = [h.double().numpy() for h in mk._forward_keep(
        dims, [torch.from_numpy(w).float() for w in ws], torch.from_numpy(x).float())]
    g_out = rng.normal(size=(nt, dims.out_w)).astype(np.float32).astype(np.float64) * 1e-2
    ref_grads, ref_fin = tk._mlp_backward_f32(
        dims, [torch.from_numpy(w) for w in ws], [torch.from_numpy(h) for h in hs],
        torch.from_numpy(g_out))
    ref = np.concatenate([g.numpy() for g in ref_grads])

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    gw, fin = _emulated_split_backward(dims, ws, hs, g_out, nt)
    assert rel(gw, ref) < 2.0**-14 and rel(fin, ref_fin.numpy()) < 2.0**-14
    gw, fin = _emulated_split_backward(dims, ws, hs, g_out, nt, with_lo=False)
    assert rel(gw, ref) > 2.0**-14 and rel(fin, ref_fin.numpy()) > 2.0**-14
