"""K11's and K13's plans and lane maps (tcnn_tpu_torch/ops/cuda/
ext_kernel.py: scatter_plan, lookup_chunk; csrc/ext_scatter.cu), on the CPU.

K11 sums the levels whose gradient fits a block's shared memory in private
copies, each warp the only one to add into its share of a group's levels,
and adds the rest by vector atomics; K13 puts 16 samples at each of two
x-neighbour corners of one level on a warp's lanes and sums the lanes that
share a row before one vector atomic. Plans and maps are decided in Python
or written in CUDA, and run on the card only, so a wrong one would show
there only. These pin the plans at the PPNG sample configs and factory
defaults, check that every level lands in exactly one place within the
budget, walk the kernels' index arithmetic (PickWalk, K13's tasks) to see
that every pick is visited once, and emulate both kernels' summation
order in torch: the emulation equals the plain twin within
chip_smoke.EXT_SCATTER_REL, and its control (the warp's sum rounded to
bf16 in place of each pick) breaks that bound.
"""

import math

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
from tcnn_tpu_torch.ops.encodings import ppng
from tcnn_tpu_torch.samples import learn_a_sdf as sdf

#: chip_smoke.py's bound for K11 and K13's table half (norm-relative).
EXT_SCATTER_REL = 2e-6
N_SM = 132
CLASSES = {"PPNG1": ppng.PPNG1Encoding, "PPNG2": ppng.PPNG2Encoding, "PPNG3": ppng.PPNG3Encoding}


def _enc(variant, sample=True):
    cfg = {k: v for k, v in sdf.ENCODINGS[variant].items() if k != "otype"} if sample else {}
    return CLASSES[variant](3, **cfg)


def _plan_args(enc, batch):
    spec = enc.spec
    corners = {"PPNG1": 2, "PPNG2": 4}[enc.otype_name]
    return spec.n_levels, spec.n_rows // spec.n_levels, spec.f, corners, batch


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,sample,batch,want", [
    # PPNG1 (sample = factory default): 36 tables of 64 x 16 f32, 147,456 B:
    # one group, 18 warps of 2 tables, one block an SM
    ("PPNG1", True, 1 << 16, ek.ScatterPlan(36, 36, 18, 132)),
    ("PPNG1", False, 1 << 17, ek.ScatterPlan(36, 36, 18, 132)),
    # the eikonal term's 1024 points: 32 adds a float in all, global
    ("PPNG1", True, 1024, ek.ScatterPlan()),
    # PPNG2 sample: 24 planes of 16 KB fit in 2 groups of 12, but 256 adds a
    # float leave fewer than K11_MIN_ADDS to each of 66 blocks a group
    ("PPNG2", True, 1 << 16, ek.ScatterPlan()),
    # PPNG2 defaults: a plane is 262,144 B, above any block's shared memory
    ("PPNG2", False, 1 << 17, ek.ScatterPlan()),
])
def test_scatter_plan_pinned(variant, sample, batch, want):
    assert ek.scatter_plan(*_plan_args(_enc(variant, sample), batch), N_SM) == want


@pytest.mark.parametrize("variant,sample,batch,want", [
    ("PPNG3", True, 1 << 16, 8),   # all 8 levels a block
    ("PPNG3", False, 1 << 17, 8),  # 12 levels: blocks of 8 and of 4
    ("PPNG3", True, 1024, 1),      # 32 tiles: a level a block, 256 blocks
])
def test_lookup_chunk_pinned(variant, sample, batch, want):
    spec = _enc(variant, sample).spec
    assert ek.lookup_chunk(spec.n_levels, 8, spec.f, batch, N_SM) == want
    assert 8 * want <= ek.LOOKUP_TILE_COLS and want * spec.f <= ek.LOOKUP_TILE_COLS


@pytest.mark.parametrize("budget", [0, 4096, 34_816, 115_712, ek.K11_PRIVATE_BYTES, 1 << 20])
@pytest.mark.parametrize("n_levels,rows,f,corners", [
    (36, 64, 16, 2), (24, 1024, 4, 4), (36, 4096, 16, 4), (7, 100, 6, 2), (40, 16, 2, 2),
    (5, 8, 3, 4),
])
@pytest.mark.parametrize("batch", [1, 1024, 1 << 16])
def test_scatter_plan_places_every_level_once(budget, n_levels, rows, f, corners, batch):
    plan = ek.scatter_plan(n_levels, rows, f, corners, batch, N_SM, budget)
    private = [l for lo, hi in plan.groups() for l in range(lo, hi)]
    assert private == list(range(plan.n_private))
    assert plan.n_private in (0, n_levels)  # equal levels: all or none
    if plan.n_private == 0:
        return
    level_bytes = rows * f * 4
    assert plan.group_levels * level_bytes <= min(budget, ek.SMEM_OPTIN)
    assert 1 <= plan.warps <= 32 and plan.blocks >= 1
    per_warp = -(-plan.group_levels // plan.warps)
    assert (plan.warps - 1) * per_warp < plan.group_levels  # every warp owns a level
    # every resident block of a group gets K11_MIN_ADDS adds a private float
    assert batch * corners >= ek.K11_MIN_ADDS * rows * plan.blocks
    n_groups = len(plan.groups())
    per_sm = ek.SMEM_SM // (plan.group_levels * level_bytes + 1024)
    assert plan.blocks * n_groups <= N_SM * per_sm


# ---------------------------------------------------------------------------
# The kernels' index arithmetic
# ---------------------------------------------------------------------------


class PickWalk:
    """csrc/ext_scatter.cu:PickWalk, transcribed."""

    def __init__(self, NL, C, F, V, l0, nl, b0, b1, start, stride):
        self.b, self.b_end, self.K, self.NL, self.nl, self.l0 = b0, b1, C * NL, NL, nl, l0
        self.slices = F // V
        self.per_sample = C * nl * self.slices
        self.sb, self.sr = divmod(stride, self.per_sample)
        self.b += start // self.per_sample
        self.r = start % self.per_sample
        self.decode()

    def decode(self):
        q, self.s = divmod(self.r, self.slices)
        c, l = divmod(q, self.nl)
        self.col = c * self.NL + self.l0 + l

    def on(self):
        return self.b < self.b_end

    def pick(self):
        return self.b * self.K + self.col

    def next(self):
        self.b += self.sb
        if self.sr == 0:
            return
        self.r += self.sr
        if self.r >= self.per_sample:
            self.r -= self.per_sample
            self.b += 1
        self.decode()


def _vector(f):
    return 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1


@pytest.mark.parametrize("NL,C,F,l0,nl,B,threads", [
    (36, 2, 16, 0, 2, 37, 32),      # a PPNG1 private warp: 16 items a sample
    (36, 2, 16, 34, 2, 37, 32),
    (24, 4, 4, 0, 24, 21, 256 * 3),  # PPNG2's global route, 96 items a sample
    (36, 4, 16, 0, 36, 5, 256 * 2),
    (7, 3, 6, 2, 5, 11, 64),        # F / V = 3, 45 items a sample: the steps move columns
    (5, 4, 3, 0, 5, 9, 32),
])
def test_pick_walk_visits_every_item_once(NL, C, F, l0, nl, B, threads):
    V = _vector(F)
    seen = []
    for t in range(threads):
        w = PickWalk(NL, C, F, V, l0, nl, 0, B, t, threads)
        while w.on():
            seen.append((w.pick(), w.s))
            w.next()
    want = [(b * C * NL + c * NL + l, s) for b in range(B) for c in range(C)
            for l in range(l0, l0 + nl) for s in range(F // V)]
    assert sorted(seen) == sorted(want)


def k13_tasks(B, NL, C, LC):
    """Every (sample, column) K13's lanes take, as csrc/ext_scatter.cu:
    ext_lookup_bwd_kernel maps them: block (i, y) on 32 samples at levels
    [y LC, y LC + LC), task q of the block (pu = q >> 1 = cp * lc + l) on
    samples 16 (q & 1) + j >> 1 at corner 2 cp + (j & 1) for lane j."""
    out = []
    for i in range(-(-B // 32)):
        for la in range(0, NL, LC):
            lc = min(LC, NL - la)
            for q in range(2 * ((C + 1) // 2) * lc):
                pu = q >> 1
                cp, l = divmod(pu, lc)
                for j in range(32):
                    c, s = 2 * cp + (j & 1), 16 * (q & 1) + (j >> 1)
                    if c < C and 32 * i + s < B:
                        out.append((32 * i + s, c * NL + la + l, (i, la, q)))
    return out


@pytest.mark.parametrize("B,NL,C,F", [(77, 8, 8, 2), (40, 12, 8, 4), (33, 12, 8, 8), (5, 3, 5, 1),
                                     (1 << 12, 12, 8, 4)])
def test_k13_tasks_cover_every_pick_once(B, NL, C, F):
    tasks = k13_tasks(B, NL, C, ek.lookup_chunk(NL, C, F, B, N_SM))
    assert sorted((b, col) for b, col, _ in tasks) == [(b, col) for b in range(B)
                                                       for col in range(C * NL)]


@pytest.mark.parametrize("NL,C,F,LC", [(8, 8, 2, 8), (12, 8, 4, 8), (8, 8, 2, 1), (7, 5, 8, 3)])
def test_k13_staging_covers_the_chunk_once(NL, C, F, LC):
    """ext_lookup_bwd_kernel's staging: thread t < (256 / W) W takes column
    k = t % W of samples t / W, t / W + 256 / W, ...; column k of the chunk
    at la is c * NL + la + l of the sample (c, l = divmod(k, lc)); the
    cotangents likewise over GW = lc * F."""
    for la in range(0, NL, LC):
        lc = min(LC, NL - la)
        for width in (C * lc, lc * F):
            seen = [(s, t % width) for t in range(256) if t // width < 256 // width
                    for s in range(t // width, 32, 256 // width)]
            assert sorted(seen) == [(s, k) for s in range(32) for k in range(width)]
        cols = sorted((k // lc) * NL + la + k % lc for k in range(C * lc))
        assert cols == sorted(c * NL + l for c in range(C) for l in range(la, la + lc))


# ---------------------------------------------------------------------------
# Summation order, emulated
# ---------------------------------------------------------------------------


def _norm_rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _hot(B):
    return torch.tensor([0.5, 0.0, 1.0]).expand(B, 3).contiguous()


def _points(kind, B, seed):
    if kind == "hot":
        return _hot(B)
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (B, 3)).astype(np.float32))


def _group_sums(gid, vals, round_sum):
    """(unique group ids, f32 sums of `vals` [n, V] per group in item order),
    each sum rounded to bf16 with `round_sum`."""
    uniq, inv = torch.unique(gid, return_inverse=True)
    sums = torch.zeros((len(uniq), vals.shape[1]), dtype=torch.float32).index_add_(0, inv, vals)
    if round_sum:
        sums = sums.to(torch.bfloat16).float()
    return uniq, sums


def k11_private_emulated(idx, ct, spec, plan, round_sum=False):
    """K11's private route in its order of f32 adds: block x's samples
    [B x / blocks, B (x+1) / blocks), warp w's levels, its steps of 32 items
    in PickWalk order, the items of a step on one slice of a row summed in
    lane order first, the steps added in order, then the blocks' copies in
    block order."""
    B, K = idx.shape
    NL, F = spec.n_levels, spec.f
    C, rows, V = K // NL, spec.n_rows // NL, _vector(F)
    S = F // V
    out = torch.zeros((spec.n_rows * F // V, V), dtype=torch.float32)
    flat_idx, flat_ct = idx.reshape(-1).long(), ct.float().reshape(-1, F)
    lpw = -(-plan.group_levels // plan.warps)
    for x in range(plan.blocks):
        b0, b1 = B * x // plan.blocks, B * (x + 1) // plan.blocks
        for lo, hi in plan.groups():
            priv = torch.zeros(((hi - lo) * rows * S, V), dtype=torch.float32)
            for w in range(plan.warps):
                la = w * lpw
                if la >= hi - lo:
                    continue
                bb, cc, ll, ss = torch.meshgrid(
                    torch.arange(b0, b1), torch.arange(C),
                    torch.arange(lo + la, lo + min(la + lpw, hi - lo)), torch.arange(S),
                    indexing="ij")
                p = (bb * K + cc * NL + ll).reshape(-1)
                s = ss.reshape(-1)
                key = (flat_idx[p] - lo * rows) * S + s
                vals = flat_ct[p].reshape(-1, S, V)[torch.arange(len(p)), s]
                step = torch.arange(len(p)) // 32
                uniq, sums = _group_sums(step * priv.shape[0] + key, vals, round_sum)
                priv.index_add_(0, uniq % priv.shape[0], sums)
            out[lo * rows * S:hi * rows * S] += priv
    return out.reshape(spec.n_rows, F)


def k13_table_emulated(idx, cw, gy, spec, round_sum=False):
    """K13's table half in its order of f32 adds: each task's 32 lanes (16
    samples x an x-pair of corners of one level), the lanes on one row
    summed in lane order (each contribution rounded to bf16 first, or only
    the sum with `round_sum`), then added to the row."""
    B, CNL = idx.shape
    NL, F = spec.n_levels, spec.f
    C = CNL // NL
    contrib = cw.reshape(B, C, NL, 1) * gy.reshape(B, 1, NL, F)
    if not round_sum:
        contrib = contrib.to(torch.bfloat16).float()
    bb, cc, ll = torch.meshgrid(torch.arange(B), torch.arange(C), torch.arange(NL), indexing="ij")
    task = ((bb // 16) * ((C + 1) // 2) + cc // 2) * NL + ll
    lane = 2 * (bb % 16) + cc % 2
    rows = idx.reshape(B, C, NL).long()
    order = torch.argsort((task * 32 + lane).reshape(-1))
    gid = (task * spec.n_rows + rows).reshape(-1)[order]
    uniq, sums = _group_sums(gid, contrib.reshape(-1, F)[order], round_sum)
    dT = torch.zeros((spec.n_rows, F), dtype=torch.float32)
    return dT.index_add_(0, uniq % spec.n_rows, sums)


@pytest.mark.parametrize("kind", ["uniform", "hot"])
def test_k11_private_order_matches_twin(kind):
    enc = _enc("PPNG1")
    spec, B = enc.spec, 1061
    plan = ek.scatter_plan(*_plan_args(enc, B), 4)
    assert plan.n_private == spec.n_levels and plan.blocks == 4
    idx, _ = enc.indices(_points(kind, B, 7))
    rng = np.random.default_rng(11)
    ct = torch.from_numpy(rng.normal(size=(B, idx.shape[1] * spec.f)).astype(np.float32))
    want = ek._ext_scatter_plain(idx, ct, spec.n_rows)
    assert _norm_rel(k11_private_emulated(idx, ct, spec, plan), want) <= EXT_SCATTER_REL
    lower = k11_private_emulated(idx, ct, spec, plan, round_sum=True)
    assert _norm_rel(lower, want) > EXT_SCATTER_REL


@pytest.mark.parametrize("kind", ["uniform", "hot"])
def test_k13_warp_sums_match_twin(kind):
    enc = _enc("PPNG3")
    spec, B = enc.spec, 1061
    idx, cw = enc.indices(_points(kind, B, 5))
    rng = np.random.default_rng(13)
    gy = torch.from_numpy(rng.normal(size=(B, spec.n_levels * spec.f)).astype(np.float32))
    gy = gy.to(torch.bfloat16).float()
    want, _ = ek._ext_lookup_bwd_plain(None, idx, cw, gy, spec.n_rows, spec.n_levels, True, False)
    got = k13_table_emulated(idx, cw, gy, spec)
    assert _norm_rel(got, want) <= EXT_SCATTER_REL
    if kind == "hot":  # every task's 16 samples of a corner share its row
        lower = k13_table_emulated(idx, cw, gy, spec, round_sum=True)
        assert _norm_rel(lower, want) > EXT_SCATTER_REL


def test_hot_point_sends_each_column_to_one_row():
    for variant in CLASSES:
        idx, _ = _enc(variant).indices(_hot(77))
        assert bool((idx == idx[:1]).all())
        assert math.prod(idx.shape) == 77 * idx.shape[1]
