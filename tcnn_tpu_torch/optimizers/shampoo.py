"""Shampoo, the full second-order optimizer, with tcnn's semantics
(counterpart of ``tcnn_tpu/optimizers/shampoo.py``; the reference's
optimizers/shampoo.h:286-1050). The JAX package runs it as one XLA program
with `jnp` matmuls and no Pallas kernel, so here it is plain torch on the
flat vector, in place, its products `torch.matmul`s.

Semantics carried over:
  - debiased EMAs: (alpha, beta) from the step count before the increment
    (debiased_alpha_beta, shampoo.h:311-321), in f32;
  - momentum m1 / (sqrt(m2) + eps) of the l2-regularised unscaled gradient
    (shampoo.h:167-192);
  - per-layer Gram factors L = b3 L + a3 G G^T, R = b3 R + a3 G^T G over
    runs of consecutive same-shape layers, on the momentum (cg_on_momentum,
    default) or on the raw loss-scaled gradient with a3 /= loss_scale^2
    (shampoo.h:634-660, 725-760);
  - U = L_root M R_root from the roots before this step's refresh, the
    shampoo momentum s = b_sh s + a_sh U, and the update only from the
    second step on (shampoo.h:765-816);
  - Frobenius normalisation lr *= ||M||_F / ||s||_F per matrix
    (shampoo.h:248-251), weight decay, and momentum SGD on the non-matrix
    remainder every step (shampoo.h:264-282);
  - the roots of every group refreshed at step 1, then one group every
    (step < 100 ? 10 : 200) // n_groups steps, round robin
    (shampoo.h:831-856), each the coupled-Newton inverse fourth root run a
    fixed 30 iterations (shampoo.h:434-637).

The refresh is decided on the host-side step count (optimizers/base.py), so
a step off the schedule runs no Newton iteration, as `lax.cond` skips it in
the JAX package, and no step reads the device. The step pins torch's f32
matmul precision to "highest" (full f32), whatever the process set (`torch.backends.cuda.matmul.allow_tf32`,
`set_float32_matmul_precision`): TF32 rounds every product's operands to
10 mantissa bits, which the Newton iteration amplifies (on an H100 it
turned a root of config_hash's first step into NaN).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .base import Optimizer

_NEWTON_ITERS = 30


@contextlib.contextmanager
def matmul_precision(precision: str):
    """torch's float32 matmul precision set to `precision` inside, restored
    after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _debiased_alpha_beta(decay: float, t: int):
    """(alpha, beta) of shampoo.h:311-321 at the pre-increment step `t`, in
    f32 as the JAX package computes them."""
    f = np.float32
    d, tf = f(decay), f(t)
    debias = f(1.0) - d ** (tf + f(1.0))
    return float(f(1.0 - decay) / debias), float(d * (f(1.0) - d**tf) / debias)


def inverse_fourth_root(a):
    """Batched A^{-1/4} of SPD a [G, M, M] f32 (shampoo.h:434-637): the
    spectral bound from ||A^4||_F, X_{k+1} = X_k (5I - M_k) / 4,
    M_{k+1} = ((5I - M_k) / 4)^4 M_k."""
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)[None]
    a2 = a @ a
    a4 = a2 @ a2
    c = torch.sum(a4 * a4, dim=(-2, -1), keepdim=True)  # ||A^4||_F^2
    s = math.sqrt(2.0) / c**0.125
    mk = a * s
    x = eye * s**0.25
    t = (5.0 * eye - mk) * 0.25
    x = x @ t
    for _ in range(_NEWTON_ITERS):
        t2 = t @ t
        mk = (t2 @ t2) @ mk
        t = (5.0 * eye - mk) * 0.25
        x = x @ t
    return x


class ShampooOptimizer(Optimizer):
    def __init__(
        self,
        learning_rate: float = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.99,
        beta3: float = 0.9,
        beta_shampoo: float = 0.9,
        epsilon: float = 1e-8,
        identity: float = 0.01,
        l2_reg: float = 1e-5,
        relative_decay: float = 0.0,
        absolute_decay: float = 0.0,
        cg_on_momentum: bool = True,
        frobenius_normalization: bool = True,
    ):
        super().__init__()
        self.base_learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.beta3 = float(beta3)
        self.beta_shampoo = float(beta_shampoo)
        self.epsilon = float(epsilon)
        self.identity_strength = float(identity)
        self.l2_reg = float(l2_reg)
        self.relative_decay = float(relative_decay)
        self.absolute_decay = float(absolute_decay)
        self.cg_on_momentum = bool(cg_on_momentum)
        self.frobenius_normalization = bool(frobenius_normalization)
        self._host_step = 0

    def groups(self):
        """[(layer count, (rows, cols), offset)] of each run of consecutive
        same-shape layers (shampoo.h:370-395)."""
        out, off = [], 0
        for shape in self._layer_sizes:
            if out and out[-1][1] == shape:
                out[-1][0] += 1
            else:
                out.append([1, shape, off])
            off += shape[0] * shape[1]
        return [tuple(g) for g in out]

    def refresh_groups(self, step: int) -> list:
        """The groups whose roots step `step` (counted from 1) refreshes."""
        n_groups = max(len(self.groups()), 1)
        if step == 1:
            return list(range(len(self.groups())))
        single = max((10 if step < 100 else 200) // n_groups, 1)
        j = (step // single) % n_groups
        return [j] if step % single == 0 and j < len(self.groups()) else []

    def init_state(self, device="cuda") -> dict:
        n = self.n_weights

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        state = {
            "step": torch.zeros((), dtype=torch.int64, device=device),
            "first_moments": zeros(n),
            "second_moments": zeros(n),
            "momentum": zeros(n),
            "shampoo_momentum": zeros(n),
        }
        for j, (count, (m, nn), _) in enumerate(self.groups()):
            state[f"L_{j}"] = zeros(count, m, m)
            state[f"R_{j}"] = zeros(count, nn, nn)
            state[f"L_root_{j}"] = zeros(count, m, m)
            state[f"R_root_{j}"] = zeros(count, nn, nn)
        self._host_step = 0
        return state

    def load_state(self, state) -> None:
        self._host_step = int(state["step"])

    def _symmetrize(self, a):
        eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)[None]
        return (0.5 * (a + a.transpose(-1, -2)) * (1.0 - self.identity_strength)
                + self.identity_strength * eye)

    def step(self, state, loss_scale, weights, grads, lr_scale=1.0) -> None:
        with matmul_precision("highest"):
            self._step(state, loss_scale, weights, grads, lr_scale)

    def _step(self, state, loss_scale, weights, grads, lr_scale) -> None:
        t = self._host_step  # pre-increment, like m_current_step at entry
        a1, b1 = _debiased_alpha_beta(self.beta1, t)
        a2, b2 = _debiased_alpha_beta(self.beta2, t)
        a3, b3 = _debiased_alpha_beta(self.beta3, t)
        ash, bsh = _debiased_alpha_beta(self.beta_shampoo, t)
        if not self.cg_on_momentum:
            a3 = float(np.float32(a3) / np.float32(loss_scale * loss_scale))

        g_raw = grads.float()
        g = g_raw / loss_scale + self.l2_reg * weights
        m1 = b1 * state["first_moments"] + a1 * g
        m2 = b2 * state["second_moments"] + a2 * g * g
        momentum = m1 / (torch.sqrt(m2) + self.epsilon)
        lr = self.base_learning_rate * lr_scale
        refresh = self.refresh_groups(t + 1)

        for j, (count, (m, nn), off) in enumerate(self.groups()):
            seg = slice(off, off + count * m * nn)
            gmat = (momentum if self.cg_on_momentum else g_raw)[seg].reshape(count, m, nn)
            L = b3 * state[f"L_{j}"] + a3 * (gmat @ gmat.transpose(-1, -2))
            R = b3 * state[f"R_{j}"] + a3 * (gmat.transpose(-1, -2) @ gmat)
            if t > 0:
                mom = momentum[seg].reshape(count, m, nn)
                u = state[f"L_root_{j}"] @ mom @ state[f"R_root_{j}"]
                sh_mom = state["shampoo_momentum"][seg].view(count, m, nn)
                sh = bsh * sh_mom + ash * u
                if self.frobenius_normalization:
                    adam_norm = torch.sum(mom**2, dim=(-2, -1), keepdim=True)
                    sh_norm = torch.sum(sh**2, dim=(-2, -1), keepdim=True)
                    lr_mat = lr * torch.sqrt(adam_norm) / torch.sqrt(sh_norm + 1e-30)
                else:
                    lr_mat = lr * torch.ones((count, 1, 1), device=weights.device)
                w = weights[seg].view(count, m, nn)
                decayed = (1.0 - self.relative_decay * lr_mat) * w - torch.copysign(
                    self.absolute_decay * lr_mat, w)
                w.copy_(decayed - lr_mat * sh)
                sh_mom.copy_(sh)
            state[f"L_{j}"].copy_(L)
            state[f"R_{j}"].copy_(R)
            if j in refresh:
                state[f"L_root_{j}"].copy_(inverse_fourth_root(self._symmetrize(L)))
                state[f"R_root_{j}"].copy_(inverse_fourth_root(self._symmetrize(R)))

        n_mat = self.n_matrix_weights
        if n_mat < self.n_weights:
            w = weights[n_mat:]
            decayed = (1.0 - self.relative_decay * lr) * w - torch.copysign(
                self.absolute_decay * lr * torch.ones_like(w), w)
            w.copy_(decayed - lr * momentum[n_mat:])

        state["first_moments"].copy_(m1)
        state["second_moments"].copy_(m2)
        state["momentum"].copy_(momentum)
        state["step"].add_(1)
        self._host_step += 1

    @property
    def learning_rate(self) -> float:
        return self.base_learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self.base_learning_rate = float(lr)

    def hyperparams(self) -> dict:
        return {
            "otype": "Shampoo",
            "beta1": self.beta1,
            "beta2": self.beta2,
            "beta3": self.beta3,
            "beta_shampoo": self.beta_shampoo,
            "epsilon": self.epsilon,
            "identity": self.identity_strength,
            "learning_rate": self.base_learning_rate,
            "cg_on_momentum": self.cg_on_momentum,
            "frobenius_normalization": self.frobenius_normalization,
            "l2_reg": self.l2_reg,
            "relative_decay": self.relative_decay,
            "absolute_decay": self.absolute_decay,
        }

    def update_hyperparams(self, params: dict) -> None:
        for key, attr in [
            ("beta1", "beta1"),
            ("beta2", "beta2"),
            ("beta3", "beta3"),
            ("beta_shampoo", "beta_shampoo"),
            ("epsilon", "epsilon"),
            ("identity", "identity_strength"),
            ("learning_rate", "base_learning_rate"),
            ("cg_on_momentum", "cg_on_momentum"),
            ("frobenius_normalization", "frobenius_normalization"),
            ("l2_reg", "l2_reg"),
            ("relative_decay", "relative_decay"),
            ("absolute_decay", "absolute_decay"),
        ]:
            if key in params:
                setattr(self, attr, params[key])
