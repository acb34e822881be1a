"""The Adam step K14 (``csrc/adam.cu``): one launch a step, in place on the
flat f32 parameter vector and the optimizer's state, for
``optimizers/adam.py:AdamOptimizer.step`` on a CUDA tensor.

K14 replaces no Pallas kernel: the JAX package's Adam is one XLA
computation (``tcnn_tpu/optimizers/adam.py``). Its plain twin is
`AdamOptimizer._step_plain`, which a CPU tensor takes; the kernel runs the
twin's arithmetic in the twin's order. The C function takes every
hyperparameter at run time, as the twin rounds it to f32 (`scalar_args`),
so one kernel serves every configuration.

The global step is read and written on the card only (no step reads the
device): each block reads it, and the last block to arrive, by a counter
of its own stream (`_arrivals`), writes it plus one. A ctypes write does
not bump a tensor's version, which `Trainer._prepared` keys K3's cached
operands on, so the wrapper bumps the version of every tensor K14 wrote.
"""

from __future__ import annotations

import numbers

import torch

from . import _build

#: AdamFlags of csrc/adam.cu.
ADABOUND, CLIP, OPTIMIZE_MATRIX, OPTIMIZE_NON_MATRIX = 1, 2, 4, 8

#: (device index, stream) -> the stream's arrival counter (one int32, 0
#: between launches).
_counters: dict = {}


def check_adam_args(n: int, state: dict, weights, grads, lr_scale) -> None:
    """The checks of what K14 takes: the f32 weights, gradient and moments
    and the int64 param_steps contiguous [n] on one device, the int64 step
    0-d there, lr_scale a number or a 0-d f32 tensor there."""
    dev = weights.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if n >= 2**31:
        raise ValueError(f"{n} parameters exceed K14's 2^31 index range")
    leaves = (("weights", weights, torch.float32, (n,)), ("grads", grads, torch.float32, (n,)),
              ("first_moments", state["first_moments"], torch.float32, (n,)),
              ("second_moments", state["second_moments"], torch.float32, (n,)),
              ("param_steps", state["param_steps"], torch.int64, (n,)),
              ("step", state["step"], torch.int64, ()))
    for name, t, dtype, shape in leaves:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} {list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, weights on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if isinstance(lr_scale, torch.Tensor):
        if lr_scale.dtype != torch.float32 or lr_scale.dim() != 0 or lr_scale.device != dev:
            raise ValueError(f"lr_scale must be a number or a 0-d float32 tensor on {dev}, got "
                             f"{lr_scale.dtype} {list(lr_scale.shape)} on {lr_scale.device}")
    elif not isinstance(lr_scale, numbers.Real):
        raise ValueError(f"lr_scale must be a number or a 0-d tensor, got {type(lr_scale)}")


def scalar_args(opt, loss_scale, lr_scale) -> tuple:
    """K14's scalar arguments (n_matrix, then the floats and the flags), each
    as the twin rounds it to f32: a Python product stays in double until
    ctypes rounds it. With a tensor lr_scale the kernel multiplies it by the
    base rate and then by the non-matrix factor in f32, as the twin does."""
    lr = opt.base_learning_rate
    factor = opt.non_matrix_learning_rate_factor
    if isinstance(lr_scale, torch.Tensor):
        lr_matrix, lr_non_matrix = lr, 0.0
    else:
        lr_matrix = lr * lr_scale
        lr_non_matrix = lr_matrix * factor
    flags = ((ADABOUND if opt.adabound else 0) | (CLIP if opt.clipping_magnitude != 0.0 else 0)
             | (OPTIMIZE_MATRIX if opt.optimize_matrix_params else 0)
             | (OPTIMIZE_NON_MATRIX if opt.optimize_non_matrix_params else 0))
    return (opt.n_matrix_weights, float(loss_scale), opt.l2_reg, opt.beta1, 1 - opt.beta1,
            opt.beta2, 1 - opt.beta2, opt.epsilon, lr_matrix, lr_non_matrix, factor,
            opt.relative_decay, opt.absolute_decay, opt.clipping_magnitude, flags)


def _arrivals(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    counter = _counters.get(key)
    if counter is None:
        counter = _counters[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return counter


def adam_step(opt, state: dict, loss_scale, weights, grads, lr_scale=1.0) -> None:
    """One Adam step of `opt` (an AdamOptimizer) by K14, in place on
    `weights` and `state`; the arguments as `AdamOptimizer.step` takes them."""
    n = opt.n_weights
    check_adam_args(n, state, weights, grads, lr_scale)
    dev = weights.device
    m1, m2 = state["first_moments"], state["second_moments"]
    steps, step = state["param_steps"], state["step"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_matrix, *floats, flags = scalar_args(opt, loss_scale, lr_scale)
    lr_ptr = lr_scale.data_ptr() if isinstance(lr_scale, torch.Tensor) else None
    _build.launch("tcnn_adam_step", dev, grads.data_ptr(), weights.data_ptr(), m1.data_ptr(),
                  m2.data_ptr(), steps.data_ptr(), step.data_ptr(), lr_ptr,
                  _arrivals(dev, stream).data_ptr(), n, n_matrix, *floats, flags)
    for t in (weights, m1, m2, steps, step):
        torch.autograd.graph.increment_version(t)
