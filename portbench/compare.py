"""The numbers that decide `correct`: the program's readings against the
plain reference's, each number held to its own limit from the cell's file
(`workloads/<cell>.json`).

Training (the first three steps of the object the window then drives):
  loss_gap    the largest |loss_p - loss_r| / |loss_r| over the three steps;
  grad_gap    the first gradient as the optimizer got it, by the worst leaf:
              | |g_p| - |g_r| | over max(|g_r|, the median leaf's |g_r|);
  change_gap  the same of the parameters' change over the three steps, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's (a leaf with none moves by round-off).
Answers (rows a frame produced in the window):
  answer_gap  the largest |y_p - y_r| over the reference's RMS;
  rms_gap     |y_p - y_r| / |y_r| over every row compared.
"""

from __future__ import annotations

import math

import torch

ZERO_GRADIENT = 1e-3


def _leaf_norms(vec: torch.Tensor, leaves) -> list:
    v = vec.detach().double()
    return [float(torch.linalg.vector_norm(v[b:e])) for _, b, e in leaves]


def _median(values) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def worst_leaf_gap(program: torch.Tensor, reference: torch.Tensor, leaves, keep=None):
    """(gap, leaf name) of the worst leaf."""
    p, r = _leaf_norms(program, leaves), _leaf_norms(reference, leaves)
    med = _median(r)
    worst, name = 0.0, None
    for i, (leaf, _, _) in enumerate(leaves):
        if keep is not None and i not in keep:
            continue
        denom = max(r[i], med)
        gap = abs(p[i] - r[i]) / denom if denom > 0 else (math.inf if p[i] > 0 else 0.0)
        if gap >= worst:
            worst, name = gap, leaf
    return worst, name


def training(program: dict, reference: dict, leaves) -> dict:
    """{name: value} of a training cell from readings {"losses": [3],
    "grad": flat, "change": flat} of each side."""
    lp = program["losses"].detach().double().cpu()
    lr = reference["losses"].detach().double().cpu()
    loss_gap = float(((lp - lr).abs() / lr.abs()).max())
    grad_gap, grad_leaf = worst_leaf_gap(program["grad"], reference["grad"], leaves)
    g_ref = _leaf_norms(reference["grad"], leaves)
    med = _median(g_ref)
    moving = {i for i, g in enumerate(g_ref) if g >= ZERO_GRADIENT * med}
    change_gap, change_leaf = worst_leaf_gap(program["change"], reference["change"], leaves, moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_leaves": {"grad": grad_leaf, "change": change_leaf,
                        "left_out": [leaves[i][0] for i in range(len(leaves)) if i not in moving]}}


def answers(program: dict, reference: dict) -> dict:
    """{name: value} of an answer cell from readings {"outputs": {key:
    [N, C]}} of each side (the reference holds every key the program
    answered)."""
    worst, sq_diff, sq_ref, n = 0.0, 0.0, 0.0, 0
    for key, yp in program["outputs"].items():
        yr = reference["outputs"][key].double()
        d = yp.double() - yr
        worst = max(worst, float(d.abs().max()))
        sq_diff += float((d * d).sum())
        sq_ref += float((yr * yr).sum())
        n += yr.numel()
    rms = math.sqrt(sq_ref / n)
    return {"answer_gap": worst / rms, "rms_gap": math.sqrt(sq_diff / sq_ref)}


def judge(numbers: dict, limits: dict):
    """({name: {"value", "limit"}}, [names that fail]): a number fails when
    it is over its limit, has none, or is not finite."""
    checks, failed = {}, []
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            failed.append(name)
    return checks, failed
