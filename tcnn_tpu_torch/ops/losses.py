"""Losses (counterpart of ``tcnn_tpu/ops/losses.py:40-240``; the
reference's Loss<T>::evaluate, loss.h:38-61, and losses/*.h).

Each loss maps prediction [B, stride], target [B, dims] and an optional
data pdf [B, dims] to values [B, stride] f32, zero on the padded columns and
normalised by n = B * dims, and defines d(loss)/d(prediction) *by
specification*: several reference losses treat their normaliser as a
constant (RelativeL2's 1/(p^2 + 0.01), relative_l2.h:66-75), so autograd of
the value would give another training gradient. `Loss.__call__` therefore
runs a `torch.autograd.Function` whose backward returns the specified
gradient times the upstream cotangent (tcnn_tpu's `_loss_values` custom vjp,
losses.py:91-108).

Every loss also carries `kernel_code`, the code the fused train kernel K6
(csrc/fused_train.cu) evaluates the same formulas under, in the same
operation order.

  L2                  (p-t)^2/pdf/n                grad 2(p-t)/pdf/n
  RelativeL2          (p-t)^2/(p^2+.01)/pdf/n      grad 2(p-t)/(p^2+.01)/pdf/n
  RelativeL2Luminance as RelativeL2, normaliser from the luminance
                      .299r+.587g+.114b of the sample's first 3 predictions
  L1                  |p-t|/pdf/n                  grad sign(p-t)/pdf/n
  RelativeL1          |p-t|/(|p|+.01)/pdf/n        grad sign(p-t)/(|p|+.01)/pdf/n
  MAPE                |p-t|/(|t|+.01)/pdf/n        grad sign(p-t)/(|t|+.01)/pdf/n
  SMAPE               |p-t|/(.5(|p|+|t|)+.01)/pdf/n
  CrossEntropy        -t log(p)/pdf/n              grad -t/p/pdf/n
  Variance            t^2/pdf/n (1/p - 1/pdf)      grad -t^2/pdf/n/p^2
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Loss:
    """A named elementwise loss with reference-exact value and gradient."""

    otype = "Loss"
    #: the loss's code in the fused train kernel (csrc/fused_train.cu)
    kernel_code = 0

    def _formula(self, pred, tgt, pdf, n):
        """(values, grad) [B, dims] f32 from f32 operands."""
        raise NotImplementedError

    def value_and_grad_fn(self, prediction, target, pdf=None):
        """(values, grad), both [B, stride] f32 (before any loss scale)."""
        dims = target.shape[1]
        n = target.numel()  # B * dims
        pred = prediction[:, :dims].float()
        tgt = target.float()
        pdf = torch.ones_like(tgt) if pdf is None else pdf.float()
        values, grad = self._formula(pred, tgt, pdf, n)
        pad = (0, prediction.shape[1] - dims)
        return F.pad(values, pad), F.pad(grad, pad)

    def __call__(self, prediction, target, pdf=None):
        """values [B, stride] f32 whose backward is the specified gradient
        with respect to `prediction` (none flows to target or pdf, as in the
        reference, which only emits dL/dprediction)."""
        return _LossValues.apply(prediction, target, pdf, self)

    def hyperparams(self):
        return {"otype": self.otype}

    def update_hyperparams(self, params: dict) -> None:
        pass

    def __repr__(self):
        return f"{type(self).__name__}()"


class _LossValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prediction, target, pdf, loss):
        values, grad = loss.value_and_grad_fn(prediction, target, pdf)
        ctx.save_for_backward(grad.to(prediction.dtype))
        return values

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return (g * grad).to(grad.dtype), None, None, None


class L2Loss(Loss):
    otype = "L2"
    kernel_code = 1

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        return diff * diff / pdf / n, 2.0 * diff / pdf / n


class RelativeL2Loss(Loss):
    otype = "RelativeL2"
    kernel_code = 2

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        denom = pred * pred + 0.01
        return diff * diff / denom / pdf / n, 2.0 * diff / denom / pdf / n


class RelativeL2LuminanceLoss(Loss):
    """Every channel of a sample shares the luminance normaliser of its
    first three predictions (relative_l2_luminance.h:70-86)."""

    otype = "RelativeL2Luminance"
    kernel_code = 3

    def _formula(self, pred, tgt, pdf, n):
        lum = (0.299 * pred[:, 0] + 0.587 * pred[:, 1] + 0.114 * pred[:, 2])[:, None]
        denom = lum * lum + 0.01
        diff = pred - tgt
        return diff * diff / denom / pdf / n, 2.0 * diff / denom / pdf / n


class L1Loss(Loss):
    otype = "L1"
    kernel_code = 4

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        return diff.abs() / pdf / n, torch.sign(diff) / pdf / n


class RelativeL1Loss(Loss):
    otype = "RelativeL1"
    kernel_code = 5

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        scale = 1.0 / (pred.abs() + 1e-2) / pdf
        return diff.abs() * scale / n, torch.sign(diff) * scale / n


class MapeLoss(Loss):
    otype = "MAPE"
    kernel_code = 6

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        scale = 1.0 / (tgt.abs() + 1e-2) / pdf
        return diff.abs() * scale / n, torch.sign(diff) * scale / n


class SmapeLoss(Loss):
    otype = "SMAPE"
    kernel_code = 7

    def _formula(self, pred, tgt, pdf, n):
        diff = pred - tgt
        scale = 1.0 / (0.5 * (tgt.abs() + pred.abs()) + 1e-2) / pdf
        return diff.abs() * scale / n, torch.sign(diff) * scale / n


class CrossEntropyLoss(Loss):
    otype = "CrossEntropy"
    kernel_code = 8

    def _formula(self, pred, tgt, pdf, n):
        factor = -tgt / pdf / n
        return factor * torch.log(pred), factor / pred


class VarianceIsLoss(Loss):
    otype = "Variance"
    kernel_code = 9

    def _formula(self, pred, tgt, pdf, n):
        factor = tgt * tgt / pdf / n
        return factor / pred - factor / pdf, -factor / (pred * pred)


#: The nine losses the reference registers (loss.cu:77-82), by otype.
LOSSES = {
    cls.otype: cls
    for cls in (
        L2Loss, RelativeL2Loss, RelativeL2LuminanceLoss, L1Loss, RelativeL1Loss,
        MapeLoss, SmapeLoss, CrossEntropyLoss, VarianceIsLoss,
    )
}
