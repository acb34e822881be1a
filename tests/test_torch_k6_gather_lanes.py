"""K6's gather (csrc/fused_train.cuh:gather_rows, on K1's lane pairs,
csrc/grid_common.cuh:grid_level_pair), emulated lane by lane on the CPU.

K6 and K9 run only on the card, so a wrong slot map (a pair split across
two rows, a lane left out of a shuffle, a phantom level written into the
padding columns) or a wrong exchange would show there only. These tests
copy into torch the warp's walk over its 16 rows (16 x Lp slots, Lp = L
rounded up to even, slot lane + 32 s at row slot / Lp and level
slot % Lp), the corners each lane of a pair loads for both of the pair's
levels, the exchange of raw rows between the two lanes and the order in
which a lane sums its own level's corners, and hold the h_0 columns the warps
store bit for bit against `grid_kernel._grid_encode_plain`: at
config_hash, the T=2^19 grid with wrapped strides, the SDF shape (D = 3,
L = 12), odd L, n_active < L, batch tails inside a tile, F = 1/4/8,
Nearest, Smoothstep and Rng. The padding columns stay the zeros the kernel
writes before its tiles, and the columns past the MLP input are never
written.
"""

import json
import pathlib
import re

import torch
import pytest

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.common import InterpolationType
from tcnn_tpu_torch.ops.cuda import grid_kernel as gk
from tcnn_tpu_torch.samples import learn_a_sdf as sdf

from test_torch_k1_lanes import CONFIG, _model, _small, corner_rows

HEADER = pathlib.Path(gk.__file__).resolve().parents[2] / "csrc" / "fused_train.cuh"


def slots(L):
    """(row, level) [32, steps] of each lane's pair-steps: slot
    p = lane + 32 s of the warp's 16 x Lp, row p // Lp, level p % Lp."""
    Lp = L + (L & 1)
    p = torch.arange(32)[:, None] + 32 * torch.arange(Lp // 2)[None, :]
    return p // Lp, p % Lp


def emulate_k6_gather(plan, table, x, in_w, n_active):
    """h_0 [16 * warps, in_w + 8] bf16 as K6's warps leave it: the
    columns past in_w NaN (never written), the padding columns
    [L * F, in_w) the zeros of the kernel's preamble, then each warp's
    gather. At each step, lane 2i + k (k its x bit) loads, for both items q
    of its pair (levels (l & ~1) | q), corners 2j + k into slot j; an item
    whose level is at or past n_active, or whose row is past the batch,
    loads nothing; under Nearest only corner 0. Then each lane receives the
    partner's slots of its own item and sums its own level's corners
    c = 0, 1, ... in order; a lane whose slot is a phantom level (l = L,
    odd L) stores nothing."""
    B, L, F, D = x.shape[0], plan.n_levels, plan.f, plan.d
    nearest = plan.interpolation == InterpolationType.Nearest
    C, H = (1 if nearest else 1 << D), 1 << (D - 1)
    warps = -(-B // 16)
    cells, w = gk.positions(x, torch.from_numpy(plan.scales), plan.interpolation)
    rows = [corner_rows(plan, cells, c) for c in range(C)]  # each [B, L]
    r, l = slots(L)
    steps = r.shape[1]
    xbit = (torch.arange(32) % 2)[:, None].expand(32, steps)
    h0 = torch.full((16 * warps, in_w + 8), float("nan"), dtype=torch.bfloat16)
    h0[:, L * F:in_w] = 0.0
    stores = torch.zeros(16 * warps, L + 1, dtype=torch.int64)  # [row, level slot]
    for wp in range(warps):
        b = 16 * wp + r  # [32, steps]
        in_batch = b < B
        bi = torch.where(in_batch, b, 0)
        for s0 in range(steps):
            cols = slice(s0, s0 + 1)
            # the step's loads: mine[q][j] [32, 1, F], every lane at once
            mine = [[torch.zeros(32, 1, F) for _ in range(H)] for _ in range(2)]
            active = []
            for q in range(2):
                lq = (l[:, cols] & ~1) | q
                act = in_batch[:, cols] & (lq < n_active)
                active.append(act)
                for j in range(H):
                    for k in range(2):
                        c = 2 * j + k
                        lane_k = act & (xbit[:, cols] == k)
                        if nearest and c > 0:
                            continue
                        got = table[rows[c][bi[:, cols], torch.where(lq < L, lq, 0)]].float()
                        mine[q][j] = torch.where(lane_k[..., None], got, mine[q][j])
            # the exchange: lane t receives lane t ^ 1's slots of item (t & 1)
            partner = torch.arange(32) ^ 1
            own_q = xbit[:, cols]
            theirs = [torch.where(own_q[..., None] == 1, mine[1][j][partner], mine[0][j][partner])
                      for j in range(H)]
            own = torch.where(own_q == 1, active[1], active[0])
            lo = l[:, cols]
            wl = w[bi[:, cols], torch.where(lo < L, lo, 0)]  # [32, 1, D]
            out = torch.zeros(32, 1, F)
            for c in range(C):
                cw = None
                for d in range(D):
                    term = wl[..., d] if (c >> d) & 1 else 1.0 - wl[..., d]
                    cw = term if cw is None else cw * term
                if nearest:
                    cw = torch.ones_like(cw)
                mine_c = torch.where(own_q[..., None] == 1, mine[1][c >> 1], mine[0][c >> 1])
                v = torch.where(((c & 1) == own_q)[..., None], mine_c, theirs[c >> 1])
                out = out + v * cw[..., None]
            out = torch.where(own[..., None], out, torch.zeros_like(out)).to(torch.bfloat16)
            for t in range(32):
                lv, row = int(lo[t, 0]), 16 * wp + int(r[t, s0])
                if lv < L:
                    h0[row, lv * F:lv * F + F] = out[t, 0]
                    stores[row, lv] += 1
    assert (stores[:, :L] == 1).all() and not stores[:, L].any(), "a level stored twice or a phantom"
    return h0


def _check(plan, B, seed, in_w=None, n_active=None, lo=0.0, hi=1.0):
    gen = torch.Generator().manual_seed(seed)
    L, F = plan.n_levels, plan.f
    table = (torch.rand(plan.total_rows, F, generator=gen) * 2 - 1).to(torch.bfloat16)
    x = lo + (hi - lo) * torch.rand(B, plan.d, generator=gen)
    in_w = -(-L * F // 16) * 16 if in_w is None else in_w
    n_active = L if n_active is None else n_active
    h0 = emulate_k6_gather(plan, table, x, in_w, n_active)
    want = gk._grid_encode_plain(plan, table, x, in_w, n_active)
    assert torch.equal(h0[:B, :in_w].view(torch.int16), want.view(torch.int16))
    assert not h0[B:, :in_w].float().any(), "rows past the batch must be zeros"
    assert torch.isnan(h0[:, in_w:].float()).all(), "a lane wrote past the MLP input's columns"


def test_slots_pair_lanes_on_one_row_and_cover_each_row_once():
    """Lanes 2i and 2i + 1 hold one row at levels 2j and 2j + 1 at every
    step, every lane takes Lp / 2 steps (so all reach each shuffle), and
    the 16 x Lp slots cover every (row, level) of the warp's 16 rows once,
    the phantom level of an odd L included."""
    for L in range(1, 33):
        r, l = slots(L)
        Lp = L + (L & 1)
        assert r.shape == (32, Lp // 2)
        assert torch.equal(r[0::2], r[1::2])
        assert (l[0::2] % 2 == 0).all() and torch.equal(l[1::2], l[0::2] + 1)
        seen = sorted(zip(r.flatten().tolist(), l.flatten().tolist()))
        assert seen == [(row, lv) for row in range(16) for lv in range(Lp)]


def test_the_walk_is_the_headers():
    """The slot map, the pair call and the phantom's skipped store are the
    ones csrc/fused_train.cuh:gather_rows writes, and the kernel switches
    to it with D fixed at compile time for D = 1-4."""
    src = HEADER.read_text()
    for line in ("const int lane = threadIdx.x & 31, Lp = g.L + (g.L & 1);",
                 "for (int p = lane; p < 16 * Lp; p += 32) {",
                 "const int r = p / Lp, l = p % Lp;",
                 "grid_level_pair<F, D>(g, wrow0 + r, l, wrow0 + r < B, n_active, v);",
                 "if (l < g.L) store_bf16<F>(h0 + r * ld0 + l * F, v);"):
        assert line in src, line
    for d in (1, 2, 3, 4):
        assert re.search(rf"gather_rows<F, {d}>\(g, h0w, ld0, wrow0, B, n_active\)", src)


def test_gather_at_config_hash():
    _check(_model(tt.load_config(str(CONFIG)), 2).encoding.plan, 37, 1)


def test_gather_at_the_reference_default_with_wrapped_strides():
    """T = 2^19, per_level_scale 2: levels 12-15 do not hash (their final
    uint32 stride wraps to 0)."""
    enc = _model(tt.load_config(str(CONFIG)), 2, {"log2_hashmap_size": 19,
                                                  "per_level_scale": 2.0}).encoding
    assert not any(enc.plan.use_hash[12:])
    _check(enc.plan, 24, 2)


def test_gather_at_the_sdf_shape():
    """D = 3, 12 levels (Lp = 12: the level changes from step to step),
    24 columns padded to 32."""
    cfg = json.loads(json.dumps(sdf.CONFIG))
    plan = tt.create_from_config(3, 1, cfg, device="cpu").network.encoding.plan
    assert (plan.d, plan.n_levels) == (3, 12)
    _check(plan, 21, 3, in_w=32)


@pytest.mark.parametrize("d,levels", [(2, 5), (3, 11), (2, 15)])
def test_gather_at_an_odd_level_count(d, levels):
    """The phantom level L of each row loads and stores nothing; at
    L = 15 (Lp = 16) the lanes keep one level a tile."""
    _check(_model(_small(n_levels=levels), d).encoding.plan, 35, 4 + levels)


@pytest.mark.parametrize("n_active", [0, 3, 4])
def test_gather_below_n_active(n_active):
    _check(_model(_small(n_levels=7), 2).encoding.plan, 18, 5, n_active=n_active)


@pytest.mark.parametrize("B", [1, 15, 17, 50])
def test_gather_with_a_batch_tail_inside_a_tile(B):
    _check(_model(_small(), 3).encoding.plan, B, 6)


@pytest.mark.parametrize("f", [1, 4, 8])
def test_gather_by_features(f):
    _check(_model(_small(n_features_per_level=f, n_levels=5), 3).encoding.plan, 20, 10 + f)


@pytest.mark.parametrize("enc", [{"interpolation": "Nearest"}, {"interpolation": "Smoothstep"},
                                 {"hash": "Rng"}, {"stochastic_interpolation": True},
                                 {"type": "Dense", "n_levels": 3}])
def test_gather_under_the_options(enc):
    """Nearest (corner 0 alone, loaded by the even lane for both items),
    Smoothstep, the Rng hash, stochastic interpolation (the gather as
    Linear) and a dense grid whose inputs past [0, 1] send rows past a
    level's size."""
    plan = _model(_small(**enc), 2).encoding.plan
    lo, hi = (-0.3, 1.3) if enc.get("type") == "Dense" else (0.0, 1.0)
    _check(plan, 19, 7, lo=lo, hi=hi)
