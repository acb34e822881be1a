"""K1's lane map (csrc/grid_fwd.cu, csrc/grid_common.cuh:grid_level_pair),
emulated lane by lane on the CPU.

K1 runs only on the card, so a wrong lane map (a pair split across warps,
a corner loaded by the wrong lane, the partner's rows summed out of order)
would show there only. These tests copy into numpy and torch the kernel's
launch shape and thread map, the corners each lane of a pair loads for
both of the pair's levels (lane bit k: corners 2j + k), its row arithmetic (corner_row: the index sums, the
hash, the reduction modulo the level's size only past it), the exchange of
raw rows between the two lanes and the order in which a lane sums all 2^D
corners, and hold the output the writing lanes store bit for bit against
`grid_kernel._grid_encode_plain`, across dimensions, feature counts,
interpolations, hashes, a wrapped-stride T=2^19 grid, inactive levels,
padding columns and batch tails. They also count how often the two rows of
an x-pair fall in one 128-byte line and one 32-byte sector at config_hash,
the fetches the pair design saves.
"""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

import tcnn_tpu_torch as tt
from tcnn_tpu_torch.common import GridType, HashType, InterpolationType
from tcnn_tpu_torch.ops.cuda import grid_kernel as gk

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "data" / "config_hash.json"
U32 = 0xFFFFFFFF


def launch_shape(out_width, F):
    """(threads a sample, samples a block) of csrc/grid_fwd.cu:
    launch_grid_fwd: one thread a column group of F columns, rounded up to
    an even count, 256 threads a block."""
    groups = out_width // F
    lanes = groups + (groups & 1)
    return lanes, max(1, 256 // lanes)


def thread_map(B, out_width, F):
    """Every thread of the launch: (sample b, column group l, warp, lane).
    Thread (x, y) of block i serves sample i * samples + y, group x; its
    warp and lane come from its linear index x + y * lanes in the block."""
    lanes, samples = launch_shape(out_width, F)
    out = []
    for i in range(-(-B // samples)):
        for y in range(samples):
            for x in range(lanes):
                t = x + y * lanes
                out.append((i * samples + y, x, (i, t // 32), t % 32))
    return out


def corner_rows(plan, cells, c):
    """csrc/grid_common.cuh:corner_row for corner c of uint32 cells [B, L, D]
    (int64): the dense index sum, the level hash where the level hashes, the
    reduction modulo the level's size only when the index lies past it, the
    level's offset. int64 [B, L]."""
    D = plan.d
    cc = (cells + torch.tensor([(c >> d) & 1 for d in range(D)])) & U32
    strides = torch.tensor(plan.strides, dtype=torch.int64).reshape(plan.n_levels, D)
    dense = torch.zeros(cc.shape[:-1], dtype=torch.int64)
    for d in range(D):
        dense = (dense + gk.mul_u32(cc[..., d], strides[:, d])) & U32
    idx = dense
    if plan.hash_type is not None:
        hashed = plan.hash_fn()(cc)
        idx = torch.where(torch.tensor(plan.use_hash), hashed, dense)
    size = torch.tensor(plan.sizes, dtype=torch.int64)
    pow2 = (size & (size - 1)) == 0
    past = idx >= size
    idx = torch.where(past, torch.where(pow2, idx & (size - 1), idx % size), idx)
    return torch.tensor(plan.offsets, dtype=torch.int64) + idx


def emulate_k1(plan, table, x, out_width, n_active):
    """K1's output [B, out_width] bf16, lane by lane (grid_level_pair): the
    lanes 2i + k (k = 0, 1) of a pair serve levels 2i and 2i + 1 of one
    sample, lane 2i + k owning level 2i + k; for both levels lane 2i + k
    loads corners 2j + k (slot j); it sends its partner the slots of the
    partner's level and sums its own level's corners in order c = 0, 1, ...,
    taking corner c from its own slot c >> 1 when c & 1 == k, else from
    what it received. Also checks that the lanes of a pair share a warp."""
    B, L, F, D = x.shape[0], plan.n_levels, plan.f, plan.d
    nearest = plan.interpolation == InterpolationType.Nearest
    cells, w = gk.positions(x, torch.from_numpy(plan.scales), plan.interpolation)
    C, H = (1 if nearest else 1 << D), 1 << (D - 1)
    n_active = min(n_active, L)
    pairs = -(-L // 2)
    # mine[k][q][j]: lane k's slot j of item q, [B, pairs, F] (level 2i + q)
    mine = [[[torch.zeros(B, pairs, F) for _ in range(H)] for _ in range(2)] for _ in range(2)]
    for c in range(C):
        k, j = c & 1, c >> 1
        rows = table[corner_rows(plan, cells, c)].float()  # [B, L, F]
        for q in range(2):
            levels = list(range(q, L, 2))
            mine[k][q][j][:, : len(levels)] = rows[:, levels]
    acc = torch.zeros(B, L, F)
    for k in range(2):
        theirs = [mine[1 - k][k][j] for j in range(H)]  # partner sends its slots of item k
        levels = list(range(k, L, 2))
        own = torch.zeros(B, len(levels), F)
        for c in range(C):
            cw = None
            for d in range(D):
                term = w[:, levels, d] if (c >> d) & 1 else 1.0 - w[:, levels, d]
                cw = term if cw is None else cw * term
            if nearest:
                cw = torch.ones(B, len(levels))
            v = mine[k][k][c >> 1] if (c & 1) == k else theirs[c >> 1]
            own = own + v[:, : len(levels)] * cw[..., None]
        acc[:, levels] = own
    out = torch.full((B, out_width), float("nan"), dtype=torch.bfloat16)
    lanes_of = {}
    for b, l, warp, lane in thread_map(B, out_width, F):
        lanes_of.setdefault((b, l >> 1), []).append((warp, lane))
        if b >= B or l * F >= out_width:
            continue
        out[b, l * F:l * F + F] = (acc[b, l] if l < n_active else torch.zeros(F)).to(torch.bfloat16)
    for (w0, n0), (w1, n1) in lanes_of.values():
        assert w0 == w1 and n0 % 2 == 0 and n1 == n0 + 1
    return out


def _model(cfg, d, enc=None):
    c = json.loads(json.dumps(cfg))
    c["encoding"].update(enc or {})
    return tt.create_from_config(d, 1, c, device="cpu").network


def _small(**enc):
    e = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
         "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 2.0}
    e.update(enc)
    return {"encoding": e, "network": {"otype": "FullyFusedMLP", "n_neurons": 16,
                                       "n_hidden_layers": 1}}


def _plan_1d(interp, F=2):
    """A 1-D plan (GridEncoding takes 2-4 dims; K1 takes 1-4): 8 levels
    from resolution 8, doubling, 128 rows a hashed level."""
    res = [8 << lvl for lvl in range(8)]
    sizes = [min(-(-r // 8) * 8, 128) for r in res]
    enc = types.SimpleNamespace(
        n_dims_to_encode=1, n_features_per_level=F, n_levels=8, interpolation=interp,
        _offsets=np.cumsum([0] + sizes[:-1]).astype(np.uint32),
        _sizes=np.array(sizes, np.uint32), _scales=np.array([r - 1.0 for r in res], np.float32),
        _total_table_rows=sum(sizes), _resolutions=np.array(res, np.uint32),
        grid_type=GridType.Hash, hash_type=HashType.CoherentPrime,
        stochastic_interpolation=False)
    return gk.GridPlan(enc)


def _check(plan, B, seed, out_width=None, n_active=None, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    L, F = plan.n_levels, plan.f
    table = torch.from_numpy(rng.uniform(-1, 1, (plan.total_rows, F)).astype(np.float32))
    table = table.to(torch.bfloat16)
    x = torch.from_numpy(rng.uniform(lo, hi, (B, plan.d)).astype(np.float32))
    out_width = L * F if out_width is None else out_width
    n_active = L if n_active is None else n_active
    got = emulate_k1(plan, table, x, out_width, n_active)
    want = gk._grid_encode_plain(plan, table, x, out_width, n_active)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_pairs_match_the_twin_by_dims_and_features(d, f):
    interp = "Smoothstep" if d == 3 else "Linear"
    plan = _model(_small(n_features_per_level=f, interpolation=interp), d).encoding.plan
    _check(plan, 37, d * 10 + f)


@pytest.mark.parametrize("interp", [InterpolationType.Linear, InterpolationType.Nearest])
def test_pairs_at_one_dimension(interp):
    _check(_plan_1d(interp), 41, 3)


@pytest.mark.parametrize("hash_type", ["CoherentPrime", "Prime", "ReversedPrime", "Rng"])
def test_pairs_under_each_hash(hash_type):
    plan = _model(_small(hash=hash_type), 3).encoding.plan
    assert plan.hash_type == HashType[hash_type]
    _check(plan, 29, 7)


@pytest.mark.parametrize("interp", ["Nearest", "Smoothstep"])
def test_pairs_under_nearest_and_smoothstep(interp):
    _check(_model(_small(interpolation=interp), 2).encoding.plan, 33, 11)


def test_pairs_at_the_reference_default_with_wrapped_strides():
    """T = 2^19, per_level_scale 2: levels 12-15 do not hash, because their
    final uint32 stride res^2 wraps to 0 (grid_kernel.level_strides)."""
    cfg = tt.load_config(str(CONFIG))
    enc = _model(cfg, 2, {"log2_hashmap_size": 19, "per_level_scale": 2.0}).encoding
    plan = enc.plan
    assert plan.use_hash[6:12] == (True,) * 6 and not any(plan.use_hash[12:])
    assert all(gk.level_strides(plan.sizes[lvl], int(enc._resolutions[lvl]), 2)[1] == 0
               for lvl in range(12, 16))
    _check(plan, 24, 13)


def test_inactive_levels_padding_columns_and_tails():
    """n_active < L zeroes the trailing levels; out_width > L*F adds column
    groups of zeros (the SDF's 24 -> 32), an odd count of groups leaves a
    pair's second thread without a column; B = 1 and a batch that is no
    multiple of a block's samples leave the tail threads idle; inputs past
    [0, 1] send a dense level's rows past its size."""
    plan = _model(_small(n_levels=5), 3).encoding.plan
    _check(plan, 1, 17, out_width=16)
    _check(plan, 23, 19, out_width=16, n_active=3)
    _check(plan, 19, 21, out_width=12, n_active=0)
    _check(plan, 30, 23, out_width=14)
    dense = _model(_small(type="Dense", n_levels=3), 2).encoding.plan
    _check(dense, 26, 25, lo=-0.3, hi=1.3)


def test_launch_shapes_of_the_paths():
    """config_hash (16 levels, F = 2, 32 columns): two samples a warp, 16 a
    block; F = 8 (16 groups of 8): the same; 13 groups take 14 threads a
    sample; 2048 groups one sample a block."""
    assert launch_shape(32, 2) == (16, 16)
    assert launch_shape(128, 8) == (16, 16)
    assert launch_shape(26, 2) == (14, 18)  # 13 groups: one thread idle
    assert launch_shape(2048, 1) == (2048, 1)


def test_x_pairs_share_lines_at_config_hash():
    """At config_hash (CoherentPrime: x factor 1) the two rows of an x-pair
    (corners c and c ^ 1, a pair's two lanes in one load instruction) lie
    in one 128-byte line in 94.5% of (sample, level)s and in one 32-byte
    sector in 87.9% (~7/8: a carry out of the row's low bits splits them),
    so a (sample, level)'s 4 corners cost 2.24 sector fetches, not 4
    (table rows counted from the table's start, which the card's allocator
    aligns to 512 bytes)."""
    cfg = tt.load_config(str(CONFIG))
    plan = _model(cfg, 2).encoding.plan
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (4096, 2)).astype(np.float32))
    cells, _ = gk.positions(x, torch.from_numpy(plan.scales), plan.interpolation)
    line = sector = 0.0
    for c in (0, 2):
        a, b = corner_rows(plan, cells, c), corner_rows(plan, cells, c + 1)
        line += ((a * plan.f * 2) // 128 == (b * plan.f * 2) // 128).double().mean() / 2
        sector += ((a * plan.f * 2) // 32 == (b * plan.f * 2) // 32).double().mean() / 2
    print(f"x-pairs in one 128-byte line: {float(line):.4f}, in one 32-byte sector: "
          f"{float(sector):.4f}, sectors a (sample, level): {2 * (2 - float(sector)):.3f}")
    assert 0.9 < line < 1.0 and 0.85 < sector < 0.9
