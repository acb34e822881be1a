"""Fused grid + MLP kernels: inference K3 (``csrc/fused_infer.cu``), the
train step K6 (``csrc/fused_train.cu``) and the input-gradient backward K9
(``csrc/fused_ig.cu``; one kernel template with K6, ``fused_train.cuh``),
their plain PyTorch twins, the gates that decide
which models K6 and K9 take, and the autograd Functions of the fused
input-gradient route.

K3 replaces ``tcnn_tpu/ops/pallas/train_kernel.py:_infer_kernel_vt``
(reached through ``fused_forward_prepared`` from ``Trainer.inference``).
Its persistent blocks load the weights once; each warp walks 16-row tiles
on its own: K1's gather fills the warp's encoded rows [16, enc_pad] bf16 in
shared memory and the layer chain runs from there on ``mma.sync`` with the
activations in registers (``csrc/mlp_frag.cuh``), so the encoding never
touches device memory (`infer_smem_bytes`, `infer_warps`). Its layout is carried explicitly: `prepare_forward`
returns a `PreparedForward` that holds the grid plan, the MLP shape and the
bf16 operands, and `fused_forward_prepared` reads nothing else.

K6 replaces ``_kernel_vt`` (reached through ``fused_train_grads`` from
``Trainer.loss_and_grad_fn``): per tile, K1's gather into each warp's own
rows, the MLP forward on ``mma.sync`` from registers (``csrc/mlp_frag.cuh``)
keeping each hidden output once, the loss value and gradient from the
output fragments (or an external dL/doutput), the MLP backward with g split
into bf16 hi + lo and the weight gradient kept in registers across tiles,
and K4's scatter; the encoding and the hidden activations never leave
shared memory. The scatter sums the leading dense levels in the block's
spare shared memory (`train_layout`, `K6_LAYOUT`) and adds the rest with
one vector atomic per corner. `supported` is its gate. Its
stochastic and Rng options replace ``_kernel`` (train_kernel.py:968), where
the JAX package sends those plans (``_resolve_variant``), and K3's Rng
option replaces ``_infer_kernel``'s Rng plans (:1331).

K9 replaces ``_ig_kernel_vt`` / ``_ig_kernel`` (reached through
``fused_ig_grads`` from ``fused_apply_ig``'s backward): K6 with the raw
output cotangent in place of the loss, plus dL/dx from the encoding's
gradient and the corner features it re-reads. `supported_ig` is its gate.

Neither gate has a table-size term: a table past the JAX package's
one-hot cap (its `_fused_plan_for` refuses the reference-default T=2^19,
whose trailing levels take the binned stages of ``binned_kernel.py`` on the
composed route there) runs K3, K6 and K9 all the same, their gathers and
scatters reading the table directly as K1 and K4 do.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...common import Activation
from ..activations import activation_bwd_out
from ..losses import Loss, RelativeL2LuminanceLoss
from . import _build
from .grid_kernel import (
    HASH_ARGS,
    INTERP_CODES,
    GridPlan,
    _check_inputs,
    _grid_backward_plain,
    _grid_encode_plain,
    _grid_input_grad_plain,
    no_third_order,
    private_levels,
)
from .mlp_kernel import (
    SMEM_OPTIN,
    MlpDims,
    _forward_keep,
    _mlp_forward_plain,
    _weights,
    bwd_smem_bytes,
    bwd_tile,
    check_mlp_inputs,
    frag_weight_elems,
    persistent_grid,
)

#: Launches of K3, K6 and K9 since the last reset (counted where each
#: kernel launches).
LAUNCHES = 0
TRAIN_LAUNCHES = 0
IG_LAUNCHES = 0


def fused_plan_for(model):
    """Shape gate of the fused kernels (train_kernel.py:200-217): a
    grid + FullyFusedMLP model without Sine. Returns the grid plan, or None
    when inference must take the composed path."""
    from ...models.mlp import FullyFusedMLP
    from ...models.network_with_input_encoding import NetworkWithInputEncoding
    from ..encodings.grid import GridEncoding

    if not isinstance(model, NetworkWithInputEncoding):
        return None
    if not isinstance(model.encoding, GridEncoding):
        return None
    mlp = model.network
    if not isinstance(mlp, FullyFusedMLP):
        return None
    if Activation.Sine in (mlp.activation, mlp.output_activation):
        return None
    return model.encoding.plan


@dataclasses.dataclass(frozen=True)
class PreparedForward:
    """Device-ready operands of the fused forward: the grid plan and MLP
    shape, the bf16 [total_rows, F] table and the flat bf16 weights."""

    plan: GridPlan
    dims: MlpDims
    table: torch.Tensor
    weights: torch.Tensor


def prepare_forward(model, params) -> PreparedForward:
    """Cast the flat fp32 params [network | encoding] to the kernel's
    operands. Splitting this from the call lets repeated inference skip the
    casts (the JAX Trainer caches them the same way, trainer.py:449-465)."""
    plan = fused_plan_for(model)
    if plan is None:
        raise ValueError(f"{model!r} is not a grid + FullyFusedMLP model")
    net_p, enc_p = model.split_params(params)
    return PreparedForward(
        plan=plan,
        dims=model.network.dims,
        table=enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous(),
        weights=net_p.to(torch.bfloat16).contiguous(),
    )


def infer_smem_bytes(dims: MlpDims, warps: int) -> int:
    """Shared memory of a K3 block of `warps` warps (csrc/fused_infer.cu
    counts the same): the padded weights (`frag_weight_elems`), then each
    warp's 16 encoded rows at a pitch of in_w + 8, all bf16."""
    return 2 * (frag_weight_elems(dims) + warps * 16 * (dims.in_w + 8))


def infer_warps(dims: MlpDims) -> int:
    """Warps of a K3 block: the most of 8, 4, 2, 1 whose shared memory fits
    SMEM_OPTIN, else 0. The C side makes the same choice against the
    card's own opt-in limit."""
    for warps in (8, 4, 2, 1):
        if infer_smem_bytes(dims, warps) <= SMEM_OPTIN:
            return warps
    return 0


def _fused_forward_plain(prep: PreparedForward, x):
    """What K3 computes, in plain PyTorch on any device: the grid forward
    into the padded bf16 encoding, then the MLP chain."""
    enc = _grid_encode_plain(prep.plan, prep.table, x, prep.dims.in_w, prep.plan.n_levels)
    return _mlp_forward_plain(prep.dims, prep.weights, enc)


def fused_forward_prepared(prep: PreparedForward, x):
    """x [B, D] f32 -> [B, out_w] bf16 through the fused grid + MLP."""
    B = _check_inputs(prep.plan, prep.table, x)
    check_mlp_inputs(prep.dims, prep.weights)
    if prep.weights.device != x.device:
        raise ValueError(f"weights on {prep.weights.device}, x on {x.device}")
    if prep.dims.in_w < prep.plan.n_levels * prep.plan.f:
        raise ValueError("MLP input narrower than the encoding")
    if x.device.type == "cpu":
        return _fused_forward_plain(prep, x)
    if infer_warps(prep.dims) == 0:
        raise ValueError(f"fused MLP {prep.dims} does not fit K3's shared memory")
    global LAUNCHES
    plan, dims = prep.plan, prep.dims
    out = torch.empty((B, dims.out_w), dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out
    level_i32, level_f32 = plan.device_consts(x.device)
    fn = _build.function("tcnn_fused_infer", _FUSED_INFER_ARGS)
    _build.check(
        fn(
            x.data_ptr(), prep.table.data_ptr(), level_i32.data_ptr(),
            level_f32.data_ptr(), prep.weights.data_ptr(), out.data_ptr(),
            B, plan.d, plan.f, plan.n_levels, INTERP_CODES[plan.interpolation],
            *plan.c_hash(), *dims.c_args(), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "tcnn_fused_infer",
    )
    LAUNCHES += 1
    return out


_FUSED_INFER_ARGS = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5
    + HASH_ARGS
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)


def fused_forward(model, params, x):
    """Inference-only fused grid + MLP forward: [B, D] -> [B, out_pad] bf16."""
    return fused_forward_prepared(prepare_forward(model, params), x)


# ---------------------------------------------------------------------------
# The fused train step, K6
# ---------------------------------------------------------------------------


def supported(model, loss, perturbation_sigma: float = 0.0) -> bool:
    """Whether K6 takes this (model, loss): a grid + FullyFusedMLP model
    without Sine (`fused_plan_for`; any hash, stochastic interpolation or
    not), one of the nine losses, a scalar max_level (a per-sample one is
    masked on the composed route), and a tile whose shared memory fits the
    block (`mlp_kernel.bwd_tile`), decided before any launch, as the JAX
    gate decides on its VMEM estimate (train_kernel.py:238-288).
    Perturbation noise and an external dL/doutput arrive as inputs and do
    not gate."""
    from ..encodings.grid import per_sample

    if not isinstance(loss, Loss) or loss.kernel_code == 0:
        return False
    plan = fused_plan_for(model)
    if plan is None:
        return False
    if model.encoding.max_level is not None and per_sample(model.encoding.max_level):
        return False
    if isinstance(loss, RelativeL2LuminanceLoss) and model.n_output_dims < 3:
        return False
    return bwd_tile(model.network.dims) > 0


#: Shared memory of an H100 SM, of which each resident block reserves 1 KB.
SMEM_SM = 233_472

#: K6's layout: the most rows of a block's tile and the blocks an SM its
#: private levels leave room for (each block's budget is SMEM_SM / blocks
#: less 1 KB, at most SMEM_OPTIN). Chosen by scripts/time_k6_layouts.py
#: (H100 80GB HBM3, 700 W, B = 2^18; every layout holds 8 warps an SM): at
#: config_hash 0.828 ms (levels 0-3 private) against 0.957 at (64, 2) and
#: 0.941 at (32, 4); at the reference default T=2^19 1.143 against 1.239
#: and 1.422.
K6_LAYOUT = (128, 1)


def train_layout(model) -> tuple:
    """(nt, P, priv) of K6 for a model that `supported` takes: the rows of
    a block's tile (`mlp_kernel.bwd_tile`, at most K6_LAYOUT's), then the
    leading dense levels 0..P-1 whose table gradient the block sums in the
    shared memory that tile leaves spare of its budget for K6_LAYOUT's
    blocks an SM (`grid_kernel.private_levels`), and their f32 count
    priv = rows x F, which the launch adds to its layout's bytes; (0, 0, 0)
    when no tile fits."""
    plan, dims = fused_plan_for(model), model.network.dims
    max_nt, blocks = K6_LAYOUT
    nt = bwd_tile(dims, max_nt=max_nt)
    if nt == 0:
        return 0, 0, 0
    budget = min(SMEM_OPTIN, SMEM_SM // blocks - 1024)
    n_private, rows = private_levels(plan, model.encoding.active_levels(),
                                     max(0, budget - bwd_smem_bytes(dims, nt)))
    return nt, n_private, rows * plan.f


def _fused_train_grads_plain(plan, dims, n_active, table, weights, loss, x, targets,
                             loss_scale, pdf, noise, ext_dl):
    """What K6 computes, in plain PyTorch on any device: (loss sum, f32
    gradient [n_weights + n_table]). The MLP backward keeps the gradient in
    f32 through the chain (train_kernel.py:891-903); the table gradient
    rounds each corner's contribution to bf16 like K4, or under stochastic
    interpolation sends each (sample, level)'s row to its drawn corner
    (train_kernel.py:1221-1283)."""
    mats = _weights(dims, weights)
    hs = _forward_keep(dims, mats, _grid_encode_plain(plan, table, x, dims.in_w, n_active))
    if ext_dl:
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        g = targets.float()
    else:
        pred = hs[-1] if noise is None else hs[-1] + noise
        values, grad = loss.value_and_grad_fn(pred, targets, pdf)
        loss_sum = values.sum()
        g = grad * loss_scale
    grads, g = _mlp_backward_f32(dims, mats, hs, g)
    gtable = _grid_backward_plain(plan, x, g, n_active)
    return loss_sum, torch.cat(grads + [gtable.reshape(-1)])


def _mlp_backward_f32(dims, mats, hs, g):
    """The MLP backward of K6/K9's twins from the output gradient `g` f32,
    kept in f32 through the chain (train_kernel.py:891-903, 2033-2048):
    (the flat weight gradients per layer, the encoding's gradient f32)."""
    grads = [None] * len(mats)
    for i in reversed(range(len(mats))):
        act = dims.output_activation if i == len(mats) - 1 else dims.activation
        g = activation_bwd_out(g, hs[i + 1], act)
        grads[i] = (g.T @ hs[i]).reshape(-1)
        g = g @ mats[i]
    return grads, g


def fused_train_grads(model, loss, params, x, targets, loss_scale, pdf=None, noise=None,
                      ext_dl=False):
    """(loss sum, f32 gradient [n_params]) of one train step of a model that
    `supported` takes, in one kernel (train_kernel.py:1655-1883).

    targets [B, dims] f32; pdf optional [B, dims]; noise optional
    [B, out_pad], added to the prediction before the loss; with `ext_dl`,
    `targets` is dL/doutput [B, out_pad]: no loss (the sum is 0) and no
    loss_scale. Values and gradients are normalised by n = B * dims once;
    the JAX kernel normalises each tile by nt * dims and rescales by nt / B
    afterwards, which is equal up to f32 rounding. The gradient carries
    loss_scale, as the optimizer expects."""
    plan = fused_plan_for(model)
    dims = model.network.dims
    n_active = model.encoding.active_levels()
    net_p, enc_p = model.split_params(params)
    table = enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
    weights = net_p.to(torch.bfloat16).contiguous()
    B = _check_inputs(plan, table, x)
    check_mlp_inputs(dims, weights)
    width = dims.out_w if ext_dl else model.n_output_dims
    for name, t, w in (("targets", targets, width), ("pdf", pdf, width),
                       ("noise", noise, dims.out_w)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (B, w) or t.device != x.device:
            raise ValueError(f"{name} must be float32 [{B}, {w}] on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ext_dl and (pdf is not None or noise is not None):
        raise ValueError("an external dL/doutput takes no pdf and no noise")
    if x.device.type == "cpu":
        return _fused_train_grads_plain(plan, dims, n_active, table, weights, loss, x,
                                        targets, loss_scale, pdf, noise, ext_dl)
    for t in (targets, pdf, noise):
        if t is not None and not t.is_contiguous():
            raise ValueError("targets, pdf and noise must be contiguous")
    nt, n_private, priv = train_layout(model)
    if nt == 0:
        raise ValueError(f"{model!r} does not fit the fused train kernel's shared memory")
    global TRAIN_LAUNCHES
    dev = x.device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    grads = torch.zeros(model.n_params, dtype=torch.float32, device=dev)
    if B == 0:
        return loss_sum, grads
    grid = persistent_grid("tcnn_fused_train_grid", (B, plan.f, priv, nt, *dims.c_args()), dev)
    # a block's partial: the weights' gradient, then the private levels',
    # padded to 8 floats (csrc/fused_train.cuh: TrainLayout::n_partial)
    partials = torch.empty(grid * (dims.n_weights + -(-priv // 8) * 8), dtype=torch.float32,
                           device=dev)
    level_i32, level_f32 = plan.device_consts(dev)
    fn = _build.function("tcnn_fused_train", _FUSED_TRAIN_ARGS)
    _build.check(
        fn(
            x.data_ptr(), table.data_ptr(), level_i32.data_ptr(), level_f32.data_ptr(),
            weights.data_ptr(), targets.data_ptr(),
            0 if pdf is None else pdf.data_ptr(), 0 if noise is None else noise.data_ptr(),
            grads.data_ptr(), partials.data_ptr(), loss_sum.data_ptr(),
            grid, B, plan.d, plan.f, plan.n_levels, int(n_active),
            INTERP_CODES[plan.interpolation], *plan.c_hash(), int(plan.stochastic),
            n_private, priv, nt, *dims.c_args(),
            0 if ext_dl else loss.kernel_code, width, float(loss_scale),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ),
        "tcnn_fused_train",
    )
    TRAIN_LAUNCHES += 1
    return loss_sum, grads


_FUSED_TRAIN_ARGS = (
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 7
    + HASH_ARGS
    + [ctypes.c_int] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


# ---------------------------------------------------------------------------
# The fused input-gradient backward, K9
# ---------------------------------------------------------------------------


def ig_tile(model) -> int:
    """Rows per block of K9 for a model `fused_plan_for` takes: K6's layout
    plus L * D f32 per row of dL/dx partials, or 0 when no tile fits."""
    plan = fused_plan_for(model)
    return bwd_tile(model.network.dims, ig_floats=plan.n_levels * plan.d)


def supported_ig(model) -> bool:
    """Whether K9 takes the input-gradient path of this model
    (train_kernel.py:1894-1931, without the VMEM arithmetic): a grid +
    FullyFusedMLP model without Sine (`fused_plan_for`) whose encoding takes
    the input-gradient kernels (fast_input_grads; no stochastic
    interpolation, Nearest or max_level), and a tile whose shared memory
    fits the block, decided before any launch."""
    from ...common import InterpolationType

    if fused_plan_for(model) is None:
        return False
    enc = model.encoding
    if not enc.fast_input_grads or enc.stochastic_interpolation or enc.max_level is not None:
        return False
    if enc.interpolation == InterpolationType.Nearest:
        return False
    return ig_tile(model) > 0


def _fused_ig_grads_plain(plan, dims, table, weights, x, gy):
    """What K9 computes, in plain PyTorch on any device: the recomputed
    grid + MLP forward, the MLP backward from the raw output cotangent `gy`
    with g kept in f32, K4's scatter and dL/dx from the encoding's f32
    gradient (train_kernel.py:1934-2103). Returns (f32 gradient
    [n_weights + n_table], dL/dx f32 [B, D])."""
    mats = _weights(dims, weights)
    hs = _forward_keep(dims, mats, _grid_encode_plain(plan, table, x, dims.in_w, plan.n_levels))
    grads, g = _mlp_backward_f32(dims, mats, hs, gy.float())
    gtable = _grid_backward_plain(plan, x, g, plan.n_levels)
    return torch.cat(grads + [gtable.reshape(-1)]), _grid_input_grad_plain(plan, table, x, g)


def fused_ig_grads(model, params, x, gy):
    """(f32 gradient [n_params], dL/dx f32 [B, D]) of a model that
    `supported_ig` takes, for the raw output cotangent `gy` f32
    [B, out_pad], in one kernel (train_kernel.py:2305-2426): no loss, no
    normalisation, no loss_scale; the caller owns any scale."""
    plan = fused_plan_for(model)
    dims = model.network.dims
    net_p, enc_p = model.split_params(params)
    table = enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
    weights = net_p.to(torch.bfloat16).contiguous()
    B = _check_inputs(plan, table, x)
    check_mlp_inputs(dims, weights)
    if gy.dtype != torch.float32 or tuple(gy.shape) != (B, dims.out_w) or gy.device != x.device:
        raise ValueError(f"gy must be float32 [{B}, {dims.out_w}] on {x.device}, "
                         f"got {gy.dtype} {tuple(gy.shape)} on {gy.device}")
    if x.device.type == "cpu":
        return _fused_ig_grads_plain(plan, dims, table, weights, x, gy)
    if not gy.is_contiguous():
        raise ValueError("gy must be contiguous")
    nt = ig_tile(model)
    if nt == 0:
        raise ValueError(f"{model!r} does not fit the fused input-gradient kernel's shared memory")
    global IG_LAUNCHES
    dev = x.device
    grads = torch.zeros(model.n_params, dtype=torch.float32, device=dev)
    gx = torch.empty((B, plan.d), dtype=torch.float32, device=dev)
    if B == 0:
        return grads, gx
    grid = persistent_grid("tcnn_fused_ig_grid",
                           (B, plan.f, plan.n_levels * plan.d, nt, *dims.c_args()), dev)
    partials = torch.empty(grid * dims.n_weights, dtype=torch.float32, device=dev)
    level_i32, level_f32 = plan.device_consts(dev)
    fn = _build.function("tcnn_fused_ig", _FUSED_IG_ARGS)
    _build.check(
        fn(
            x.data_ptr(), table.data_ptr(), level_i32.data_ptr(), level_f32.data_ptr(),
            weights.data_ptr(), gy.data_ptr(), grads.data_ptr(), gx.data_ptr(),
            partials.data_ptr(), grid, B, plan.d, plan.f, plan.n_levels,
            INTERP_CODES[plan.interpolation], *plan.c_hash(), nt, *dims.c_args(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ),
        "tcnn_fused_ig",
    )
    IG_LAUNCHES += 1
    return grads, gx


_FUSED_IG_ARGS = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 6
    + HASH_ARGS
    + [ctypes.c_int] * 8
    + [ctypes.c_void_p]
)


class FusedApplyIgFn(torch.autograd.Function):
    """The fused model forward whose backward is K9 (counterpart of
    ``fused_apply_ig``, train_kernel.py:2474-2493): [B, D] -> [B, out_pad]
    bf16 through K3, with gradients to the flat params and to x; second
    order through `FusedIgBackwardFn`'s composed fallback."""

    @staticmethod
    def forward(ctx, params, x, model):
        ctx.save_for_backward(params, x)
        ctx.model = model
        ctx.set_materialize_grads(False)
        return fused_forward(model, params, x)

    @staticmethod
    def backward(ctx, gy):
        if gy is None:
            return None, None, None
        params, x = ctx.saved_tensors
        gp, gx = FusedIgBackwardFn.apply(params, x, gy.float().contiguous(), ctx.model)
        return gp, gx, None


class FusedIgBackwardFn(torch.autograd.Function):
    """(flat params gradient, dL/dx) = K9 at (params, x, gy), as a
    differentiable function (counterpart of ``_fused_ig_backward``,
    train_kernel.py:2437-2471). Its backward is ``_fib_bwd``'s: re-run the
    composed route (`_no_fused_ig`; K1 forward, K7 backward, under autograd),
    take its first-order gradient with create_graph, and differentiate that
    (K8). A third derivative raises."""

    @staticmethod
    def forward(ctx, params, x, gy, model):
        ctx.save_for_backward(params, x, gy)
        ctx.model = model
        ctx.set_materialize_grads(False)
        return fused_ig_grads(model, params, x, gy)

    @staticmethod
    def backward(ctx, ct_grads, ct_gx):
        if ct_grads is None and ct_gx is None:
            return None, None, None, None
        params, x, gy = ctx.saved_tensors
        with torch.enable_grad():
            p = params.detach().requires_grad_(True)
            xx = x.detach().requires_grad_(True)
            g = gy.detach().requires_grad_(True)
            out = ctx.model.apply(p, xx, prepare_input_gradients=True, _no_fused_ig=True)
            gp, gx = torch.autograd.grad(out, (p, xx), grad_outputs=g.to(out.dtype),
                                         create_graph=True)
            pairs = [(o, c) for o, c in ((gp, ct_grads), (gx, ct_gx)) if c is not None]
            cts = torch.autograd.grad([o for o, _ in pairs], (p, xx, g),
                                      grad_outputs=[c.float() for _, c in pairs],
                                      allow_unused=True)
        return no_third_order(*cts) + (None,)
