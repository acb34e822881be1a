"""The redesigned K7 and K8 (csrc/grid_bwd_ig.cu, csrc/grid_bwd_bwd.cu,
csrc/grid_common.cuh:pair_levels .. pair_tiles) emulated on the CPU, their
host-side layout (tcnn_tpu_torch/ops/cuda/grid_kernel.py:ig_layout), and
their wrappers at a cotangent width that is not a multiple of F.

K7 and K8 run only on the card, so a wrong lane map (a lane pair split
across two samples, a corner loaded or added by no lane or by two, the
partner's rows summed out of order) would show there only. These tests
copy the kernels' thread map (tiles of 16 x groups samples, a warp a level
pair, lane 2i + q on level l0 + q of sample i), the corners a lane loads
and adds (lane bit k: corners 2j + k of both levels, one add a corner into
the global gradient), the exchange of raw rows between the two lanes of a
pair, the order in which a lane sums its own level's corners and the
per-sample sum over levels.

Tolerances:
  - dL/dx (K7), ct_gy and ct_x (K8) against the twins: bit-equal (each lane
    sums its own corners in the twin's order, levels in order);
  - the table gradients against the twins: norm-relative 1e-6 (the same
    bf16-rounded contributions, summed in f32 in another order;
    chip_smoke.py's K7_REL), against a float64 sum of the twin's
    contributions 1e-6;
  - against the JAX package's Pallas input-gradient path (`jax.vjp` of
    `apply_unpadded(..., impl="pallas", needs_input_grad=True)`, reaching
    `_bwd_ig_call` and `_bwd_bwd_call` in interpret mode), as
    tests/test_torch_grid_ig.py holds the twins: 1e-4 for the table
    gradients, 1e-5 for dL/dx, ct_x and ct_gy (ct_gy after the bf16
    rounding the JAX package applies);
  - the wrappers at a width that is not a multiple of F (on the CPU they
    cut the cotangent and pad ct_gy back as on the card, then run the
    twins): bit-equal to the twins at the full width and to the same
    cotangent without its padding columns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tcnn_tpu as tc
import tcnn_tpu_torch as tt
from tcnn_tpu_torch.ops.cuda import grid_kernel as gk
from tcnn_tpu_torch.samples import learn_a_sdf as sdf

LANES = 32
PAIR_SAMPLES = 16


def _enc_cfg(**kw):
    cfg = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.6}
    cfg.update(kw)
    return cfg


def _sdf_plan(log2_t=17, **enc):
    cfg = dict(sdf.CONFIG["encoding"], log2_hashmap_size=log2_t, **enc)
    return tt.create_encoding(3, cfg).plan


# -- the layout -------------------------------------------------------------


def test_layout():
    # ceil(L / 2) level pairs a task row, groups of 16 samples filling 16 warps
    assert gk.ig_layout(12) == (2, 12)  # the SDF config: 32 samples a tile
    assert gk.ig_layout(11) == (2, 12)  # an odd L: the last pair's item 1 idles
    assert gk.ig_layout(16) == (2, 16)
    assert gk.ig_layout(1) == (16, 16)
    assert gk.ig_layout(5) == (5, 15)
    assert gk.ig_layout(40) == (1, 16)  # 20 pairs: warps loop over them


# -- the lane map -------------------------------------------------------------


def thread_map(B, L):
    """Every lane of a launch over B samples, block by block as a
    persistent grid of one block walks its tiles: (tile, warp, lane, sample
    b, own level l, level pair l0, x bit), in the order the kernel's loops
    visit them (csrc/grid_common.cuh:pair_tiles)."""
    groups, warps = gk.ig_layout(L)
    tile, pairs = PAIR_SAMPLES * groups, (L + 1) // 2
    out = []
    for t in range(-(-B // tile)):
        for task in range(groups * pairs):
            warp = task % warps
            for lane in range(LANES):
                s = (task // pairs) * PAIR_SAMPLES + (lane >> 1)
                l0 = 2 * (task % pairs)
                out.append((t, warp, lane, t * tile + s, l0 + (lane & 1), l0, lane & 1))
    return out


@pytest.mark.parametrize("L", [1, 2, 3, 5, 7, 11, 12, 16, 24, 40])
def test_lane_pairs_never_span_samples(L):
    B = 3 * PAIR_SAMPLES * gk.ig_layout(L)[0] - 5  # a ragged last tile
    lanes = thread_map(B, L)
    own = {}
    for t, warp, lane, b, l, l0, xbit in lanes:
        if b < B and l < L:
            assert (b, l) not in own
            own[(b, l)] = (t, warp, lane)
    # every (sample, level) is one lane's own item
    assert len(own) == B * L
    # the two lanes of a pair: one sample, levels l0 and l0 + 1
    for i in range(0, len(lanes), 2):
        a, c = lanes[i], lanes[i + 1]
        assert a[2] + 1 == c[2] and a[2] % 2 == 0
        assert a[3] == c[3] and a[5] == c[5] and (a[4], c[4]) == (a[5], a[5] + 1)
    # a warp's task: one level pair for all its lanes
    for task_lanes in (lanes[i:i + LANES] for i in range(0, len(lanes), LANES)):
        assert len({x[5] for x in task_lanes}) == 1
    if L % 2:
        assert all(l == L for *_, l, l0, xbit in lanes if l0 == L - 1 and xbit == 1)


def _corner_table(plan, x):
    """The twin's corners (grid_kernel._corners with derivatives)."""
    return list(gk._corners(plan, x, derivs=True))


def emulate(plan, table, x, gy, z=None, ct_table=None, k8=False):
    """The redesigned K7 (k8 False: (gtable, gx)) or K8 (k8 True: (ct_gy,
    gtable2, ct_x)) lane by lane: each lane loads its x-bit corners of both
    levels of its pair, adds their table-gradient contributions into the
    global gradient, swaps rows with its partner and sums its own level's
    corners in order; per sample, the levels' partials in level order.
    Also returns the lanes' adds {(b, l, c): count}."""
    B, L, F, D = x.shape[0], plan.n_levels, plan.f, plan.d
    cs = _corner_table(plan, x)
    C = len(cs)
    gl = gy[:, : L * F].float().reshape(B, L, F)
    tf = table.float()
    ctf = None if ct_table is None else ct_table.float()
    global_rows, global_vals = [], []
    parts = torch.zeros((B, L, D))
    ct_gy = torch.zeros((B, gy.shape[1]))
    adds = {}
    scatter = z is not None if k8 else True
    for t, warp, lane, b, l, l0, xbit in thread_map(B, L):
        if b >= B:
            continue
        # this lane's loads and adds: corners 2j + xbit of levels l0, l0 + 1
        mine = {}
        for q in (0, 1):
            lq = l0 + q
            if lq >= L:
                continue
            for j in range(C // 2):
                c = 2 * j + xbit
                row = int(cs[c].rows[b, lq])
                mine[(q, j)] = (tf[row], None if ctf is None else ctf[row])
                if not scatter:
                    continue
                adds[(b, lq, c)] = adds.get((b, lq, c), 0) + 1
                if k8:
                    w = z[b, 0] * cs[c].dw[0][b, lq]
                    for d in range(1, D):
                        w = w + z[b, d] * cs[c].dw[d][b, lq]
                else:
                    w = cs[c].w[b, lq]
                global_rows.append(row)
                global_vals.append((w * gl[b, lq]).to(torch.bfloat16).float())
        if l >= L:
            continue
        # the partner's loads of this lane's level (its mine[q = xbit])
        theirs = {}
        for j in range(C // 2):
            c = 2 * j + (1 - xbit)
            row = int(cs[c].rows[b, l])
            theirs[j] = (tf[row], None if ctf is None else ctf[row])
        part = torch.zeros(D)
        cg_acc = torch.zeros(F)
        for c in range(C):
            v, v2 = mine[(xbit, c >> 1)] if (c & 1) == xbit else theirs[c >> 1]
            k = cs[c]
            if not k8:
                dot = v[0] * gl[b, l, 0]
                for f in range(1, F):
                    dot = dot + v[f] * gl[b, l, f]
                part = part + torch.stack([dot * k.dw[d][b, l] for d in range(D)])
                continue
            cg, cx = None, None
            if z is not None:
                zw = z[b, 0] * k.dw[0][b, l]
                for d in range(1, D):
                    zw = zw + z[b, d] * k.dw[d][b, l]
                cg = v * zw
                dotf = v[0] * gl[b, l, 0]
                for f in range(1, F):
                    dotf = dotf + v[f] * gl[b, l, f]
                hess = []
                for e in range(D):
                    h = z[b, 0] * k.d2w[0][e][b, l]
                    for d in range(1, D):
                        h = h + z[b, d] * k.d2w[d][e][b, l]
                    hess.append(dotf * h)
                cx = torch.stack(hess)
            if ctf is not None:
                t2 = v2 * k.w[b, l]
                cg = t2 if cg is None else cg + t2
                dotf2 = v2[0] * gl[b, l, 0]
                for f in range(1, F):
                    dotf2 = dotf2 + v2[f] * gl[b, l, f]
                t3 = torch.stack([dotf2 * k.dw[e][b, l] for e in range(D)])
                cx = t3 if cx is None else cx + t3
            cg_acc = cg_acc + cg
            part = part + cx
        parts[b, l] = part
        if k8:
            ct_gy[b, l * F:(l + 1) * F] = cg_acc
    gx = parts[:, 0]
    for l in range(1, L):
        gx = gx + parts[:, l]
    gtable = torch.zeros((plan.total_rows, F))
    if global_rows:
        gtable.index_add_(0, torch.tensor(global_rows), torch.stack(global_vals))
    if k8:
        return (ct_gy, gtable, gx), adds
    return (gtable, gx), adds


def _contributions64(plan, x, gy, z=None):
    """The twin's bf16-rounded table contributions summed in float64."""
    L, F = plan.n_levels, plan.f
    gl = gy[:, : L * F].float().reshape(-1, L, F)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float64)
    for k in gk._corners(plan, x, derivs=True):
        w = k.w if z is None else sum(z[:, None, d] * k.dw[d] for d in range(plan.d))
        out.index_add_(0, k.rows.reshape(-1),
                       (w[..., None] * gl).to(torch.bfloat16).double().reshape(-1, F))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(d, cfg, seed, B, lo=0.02, hi=0.98):
    je, te = tc.create_encoding(d, cfg), tt.create_encoding(d, cfg)
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, je.n_params).astype(np.float32)
    x = rng.uniform(lo, hi, (B, d)).astype(np.float32)
    gy = np.array(jnp.asarray(rng.normal(size=(B, te.n_output_dims)), jnp.bfloat16)
                  .astype(jnp.float32))
    z = rng.normal(size=(B, d)).astype(np.float32)
    ct = rng.normal(size=je.n_params).astype(np.float32)
    return je, te, p, x, gy, z, ct


# (interpolation, D, F, L, B): D = 2, 3 and 4, an odd L, batches that are
# not a multiple of the tile (tile 32 at L = 4, 80 at L = 5, 96 at L = 3,
# 256 at L = 2)
_CASES = [("Linear", 2, 2, 4, 100), ("Smoothstep", 3, 2, 5, 130), ("Linear", 3, 1, 3, 70),
          ("Linear", 4, 4, 2, 40)]


@pytest.mark.parametrize("interp,d,f,L,B", _CASES)
def test_emulated_kernels_match_twins(interp, d, f, L, B):
    cfg = _enc_cfg(interpolation=interp, n_features_per_level=f, n_levels=L)
    _, te, p, x, gy, z, ct = _inputs(d, cfg, seed=7 * d + L, B=B)
    plan = te.plan
    table = torch.from_numpy(p).reshape(-1, f).to(torch.bfloat16)
    ct_table = torch.from_numpy(ct).reshape(-1, f).to(torch.bfloat16)
    xt, gyt, zt = torch.from_numpy(x), torch.from_numpy(gy).to(torch.bfloat16), torch.from_numpy(z)
    (gt, gx), adds = emulate(plan, table, xt, gyt)
    want_t, want_x = gk._grid_backward_ig_plain(plan, table, xt, gyt)
    assert torch.equal(gx, want_x)
    assert _rel(gt, want_t) < 1e-6
    assert _rel(gt, _contributions64(plan, xt, gyt)) < 1e-6
    # every (sample, level, corner) added once
    assert len(adds) == B * L * plan.n_corners and set(adds.values()) == {1}
    for cti in (None, ct_table):
        (cg, g2, cx), adds = emulate(plan, table, xt, gyt, zt, cti, k8=True)
        want = gk._grid_backward_bwd_plain(plan, table, cti, xt, gyt, zt)
        assert torch.equal(cg, want[0]) and torch.equal(cx, want[2])
        assert _rel(g2, want[1]) < 1e-6
        assert _rel(g2, _contributions64(plan, xt, gyt, zt)) < 1e-6
        assert set(adds.values()) == {1}
    # K8 without z adds nothing (no gtable2 scatter)
    (_, g2, _), adds = emulate(plan, table, xt, gyt, None, ct_table, k8=True)
    assert not adds and not g2.any()


def _jax(je, p, x, gy, z, ct):
    """(gparams, gx) = jax.vjp of the Pallas input-gradient path, and
    (ct_params, ct_x, ct_gy) = jax.vjp of that vjp for (ct, z), in
    interpret mode (tests/test_torch_grid_ig.py's route)."""

    def bwd(pp, xx, gg):
        enc = lambda a, b: je.apply_unpadded(a, b, impl="pallas", needs_input_grad=True)  # noqa: E731
        return jax.vjp(enc, pp, xx)[1](gg.astype(jnp.bfloat16))

    with pltpu.force_tpu_interpret_mode():
        first, vjp2 = jax.vjp(bwd, jnp.asarray(p), jnp.asarray(x), jnp.asarray(gy))
        second = vjp2((jnp.asarray(ct), jnp.asarray(z)))
    return [np.asarray(t, np.float32) for t in first], [np.asarray(t, np.float32) for t in second]


@pytest.mark.parametrize("interp,d,f,L,B", _CASES[:2])
def test_emulated_kernels_match_pallas(interp, d, f, L, B):
    cfg = _enc_cfg(interpolation=interp, n_features_per_level=f, n_levels=L)
    je, te, p, x, gy, z, ct = _inputs(d, cfg, seed=11 * d + L, B=B)
    je._kernel_plan_cache = dataclasses.replace(je._kernel_plan(), batch_tile=256)
    (jg, jx), (jcp, jcx, jcg) = _jax(je, p, x, gy, z, ct)
    plan = te.plan
    table = torch.from_numpy(p).reshape(-1, f).to(torch.bfloat16)
    ct_table = torch.from_numpy(ct).reshape(-1, f).to(torch.bfloat16)
    xt, gyt, zt = torch.from_numpy(x), torch.from_numpy(gy).to(torch.bfloat16), torch.from_numpy(z)
    (gt, gx), _ = emulate(plan, table, xt, gyt)
    (cg, g2, cx), _ = emulate(plan, table, xt, gyt, zt, ct_table, k8=True)
    assert _rel(gt.reshape(-1), jg) < 1e-4 and _rel(gx, jx) < 1e-5
    assert _rel(g2.reshape(-1), jcp) < 1e-4 and _rel(cx, jcx) < 1e-5
    assert _rel(cg.to(torch.bfloat16).float(), jcg) < 1e-5


def test_hot_rows_sum_exactly():
    """Every sample at one point with the same cotangents: each float of
    the table gradients takes B equal bf16 contributions, which f32 sums
    exactly in any order (B <= 2^16), so the emulated scatters equal the
    float64 sum: a lost or doubled add would show."""
    plan = tt.create_encoding(3, _enc_cfg(n_levels=5)).plan
    B = 200
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.uniform(-1, 1, (plan.total_rows, plan.f)).astype(np.float32))
    table = table.to(torch.bfloat16)
    x = torch.tensor([[0.5, 0.0, 1.0]]).expand(B, 3).contiguous()
    gy = torch.from_numpy(rng.normal(size=(1, plan.n_levels * plan.f)).astype(np.float32))
    gy = gy.expand(B, -1).to(torch.bfloat16).contiguous()
    z = torch.from_numpy(rng.normal(size=(1, 3)).astype(np.float32)).expand(B, 3).contiguous()
    (gt, _), _ = emulate(plan, table, x, gy)
    assert torch.equal(gt.double(), _contributions64(plan, x, gy))
    (_, g2, _), _ = emulate(plan, table, x, gy, z, k8=True)
    assert torch.equal(g2.double(), _contributions64(plan, x, gy, z))


# -- the wrappers at a width that is not a multiple of F ---------------------

#: (F, alignment, width): 16 levels padded to 66 columns at F = 4, 132 at F = 8
_WIDTHS = [(4, 6, 66), (8, 12, 132)]


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("f,alignment,width", _WIDTHS)
def test_wrappers_cut_odd_widths(f, alignment, width, d):
    cfg = _enc_cfg(n_levels=16, n_features_per_level=f, log2_hashmap_size=12)
    te = tt.create_encoding(d, cfg, alignment=alignment)
    plan, lf = te.plan, 16 * f
    assert te.padded_output_width == width and width % f
    rng = np.random.default_rng(30 + 10 * f + d)
    table = torch.from_numpy(rng.uniform(-1, 1, (plan.total_rows, f)).astype(np.float32))
    table = table.to(torch.bfloat16)
    x = torch.from_numpy(rng.uniform(0, 1, (97, d)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(97, width)).astype(np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.normal(size=(97, d)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(plan.total_rows, f)).astype(np.float32))
    ct = ct.to(torch.bfloat16)
    gt, gx = gk.grid_backward_ig(plan, table, x, gy)
    want_t, want_x = gk._grid_backward_ig_plain(plan, table, x, gy)
    assert torch.equal(gt, want_t) and torch.equal(gx, want_x)
    unpadded = gk.grid_backward_ig(plan, table, x, gy[:, :lf].contiguous())
    assert torch.equal(gt, unpadded[0]) and torch.equal(gx, unpadded[1])
    for cti in (None, ct):
        got = gk.grid_backward_bwd(plan, table, cti, x, gy, z)
        want = gk._grid_backward_bwd_plain(plan, table, cti, x, gy, z)
        assert tuple(got[0].shape) == (97, width) and not got[0][:, lf:].any()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        unpadded = gk.grid_backward_bwd(plan, table, cti, x, gy[:, :lf].contiguous(), z)
        assert torch.equal(got[0][:, :lf], unpadded[0])
        assert torch.equal(got[1], unpadded[1]) and torch.equal(got[2], unpadded[2])
