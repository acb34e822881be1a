#!/usr/bin/env python3
"""Drive the tcnn_tpu_torch inference and training paths on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. environment: torch version, the card, `nvidia-smi` name and power limit;
  2. build: the kernels of tcnn_tpu_torch/csrc/ built with nvcc for sm_90a,
     one nvcc per source, in parallel;
  3. each kernel against its plain PyTorch twin on the card at config_hash
     shapes, B = 2^18, 2^18 - 37 and 1: K1 grid forward, K2 fused MLP
     forward (also at width 128 with 5 hidden layers), K3 fused inference,
     K4 grid backward, K5 fused MLP backward (also 128x5; its gW and gx
     bit-equal between two launches on the same inputs, wherever it is
     checked), K6 fused train step (also with a pdf, output noise and an
     external dL/doutput; its weight gradient bit-equal between two
     launches at each B), each gradient bound beside a control of lower
     precision that it must reject; then, at B = 2^16 - 37, K6 on all nine losses and K4, K5 and K6
     on every activation but Sine, Smoothstep and Nearest interpolation and
     max_level; and K4 and K6 at 8 features per level (B = 2^18, 2^18 - 37),
     each beside its control;
  4. the inference slice: `create_from_config` on data/config_hash.json at
     full width, requests through `trainer.inference` (K3) checked against
     the composed `model.apply` (K1 + K2) and the plain twins on the CPU, the
     launch counters of that run, and a save/load round trip;
  5. the training slice: `training_step` at B = 2^18 on targets sampled on
     the card from a synthetic 1024^2 image, through K6 only (counters), the
     loss falling and the holdout PSNR of `trainer.inference` after it; the
     composed route (K1, K2, K5, K4) on a second model against K6's
     gradient; a save/load with the optimizer state and one more step on
     each copy;
  6. times on the card (CUDA events) of each kernel and its twin at B = 2^18
     (K4 also beside one `index_add_` of its precomputed rows and
     bf16-rounded contributions), of `trainer.inference` per call and of
     `training_step` on both routes;
  7. the input-gradient kernels against their twins at the SDF config
     (samples/learn_a_sdf.py's HashGrid, 3-D, 12 levels, T = 2^17; 64 x 2
     ReLU MLP), B = 2^16, 2^16 - 37 and 1, on the inputs the eikonal step
     gives them: K7 grid backward with dL/dx, K8 grid double backward
     (without and with a table cotangent; Linear and Smoothstep), K9 fused
     input-gradient backward, each gradient part beside a control of lower
     precision that its bound must reject; the same at 8 features per
     level (B = 2^16, inputs from their own generator); K7 and K8 also at
     D = 2 and 4;
  8. the SDF slice: `create_from_config` on that config trains SDF_STEPS
     eikonal steps through tcnn_tpu_torch.samples.learn_a_sdf (counters:
     K3, K9, K1, K7, K8 and K1, K2, K5, K4 on every step), the loss falling
     and the z = 0.5 slice error under limits set before the first run; the
     fused route's eikonal gradient against the composed route's;
  9. times of K7, K8, K9 and their twins at the eikonal term's 1024
     points (the shape the SDF step launches), B = 2^16 and 2^18, and of one
     SDF training step; K3 and K5 timed, with their bounds, at their paths'
     other shapes: K3 at B = 2^20 (the render's chunk) and at the SDF's
     1024 eikonal points, K5 at the SDF's data term (B = 2^16) and at 128 x
     5 (B = 2^18);
 10. the PPNG kernels against their twins at the factory defaults of
     PPNG1/2/3 (Q 64, 6 frequencies, 4 features, rank 4), B = 2^17, and at
     the sample's configs (samples/learn_a_sdf.py:38-44), B = 2^16, whose
     kernel instantiations phase 11 launches, on the rows and weights the
     encodings compute from seeded points and the cotangents the SDF data
     term gives: K10 ext_gather (PPNG1's f32 and PPNG2's bf16 tables), K11
     ext_scatter, K12 ext_lookup and K13 ext_lookup_bwd (PPNG3; table and
     dots halves), each beside a control its bound must reject; K2 and K5
     at the sample models' MLP input widths (48 and 16); times of each
     kernel, its twin and its one-call PyTorch yardstick at the defaults
     and at the sample's configs;
 11. the PPNG SDF slice: samples/learn_a_sdf.py's PPNG1, PPNG2 and PPNG3
     configs train SDF_STEPS eikonal steps each (counters: K10 K11 for
     PPNG1/2, K12 K13 for PPNG3, K2 K5 for the data term, no grid kernel),
     the loss falling and the z = 0.5 slice error under limits set before
     the first run; requests through `trainer.inference` on the trained
     PPNG3 model equal `model.apply`; ms per step;
 12. the stochastic-interpolation and Rng options of the grid kernels
     against their twins on the card: at config_hash with "stochastic",
     "rng" and "both" (B = 2^18, 2^18 - 37 and 1), K1 and K3 with Rng, K4
     and K6 with each option (K4's stochastic inputs hold rows where a
     draw equals its weight; K6 also beside the control with g in bf16);
     K7, K8 and K9 with Rng at the SDF config
     (B = 2^16, 2^16 - 37, 1); K1 and K4 with Rng at D = 4. Each bound
     beside a control that must break it: the twin drawing with key 1338 or
     hashing with seed 1338. Then each option and its twin timed at B = 2^18
     with its bound, the hash's integer work counted apart, and K4's
     stochastic option beside one `index_add_` of the rows it scatters;
 13. the options' training slice: config_hash with each option trains
     N_TRAIN steps at B = 2^18 through K6 only (counters), the loss falling
     and the holdout PSNR under limits set before the first run; a
     composed-route step (K1 K2 K5 K4, counters) against K6's gradient;
     `trainer.inference` (K3) against `model.apply`; ms per step of both
     routes;
 14. the reference's default hash grid (config_hash with log2_hashmap_size
     19 and per_level_scale 2.0: 5,592,320 rows, levels 12-15 unhashed by a
     wrapped uint32 stride), where the JAX package runs its binned stages
     (B12): K1, K3, K4 (plain and stochastic) and K6 against their twins at
     B = 2^18, 2^18 - 37 and 1, K1 and K6 with Rng, each beside a control
     that hashes the wrapped levels (or draws or hashes with 1338); the
     image sample (tcnn_tpu_torch.samples.mlp_learning_an_image) trains
     N_SAMPLE_STEPS steps at B = 2^18 through K6 alone (counters) and
     renders the 1024^2 image through K3, loss fall and PSNR under
     SAMPLE_LIMITS; a composed step against K6; a save/load of the trained
     state and a step on each copy; times of K1, K3, K4, K6, both routes'
     steps and `trainer.inference` beside config_hash's;
 15. the SDF sample at T=2^19 (3,471,664 rows): K7, K8 and K9 against
     their twins with controls, SDF_STEPS eikonal steps (counters as phase
     8) under SDF19_LIMITS, the fused eikonal gradient against the
     composed one, and times.
Then a line with every kernel and option (its launches on the main path,
error against its twin, time, twin's time, bound, what bounds it and its
yardstick's time; K3's, K5's, K6's and K9's entries, redesigned for
Hopper, say so),
the `nvidia-smi` line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result; it also exits non-zero when no GPU is present.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234
B_MAIN = 1 << 18
BATCHES = (B_MAIN, B_MAIN - 37, 1)

#: K1 writes what its twin writes bit for bit when both round once per
#: operation; the check allows one bf16 ulp (2^-7 relative) per value.
K1_REL = 2.0**-7
#: K2/K3 sum each product in another order than torch's f32 matmul, which
#: can flip the bf16 rounding of a hidden unit; allowed: 2^-5 of the
#: output's largest magnitude (at least 2^-5 absolute).
MLP_REL = 2.0**-5
#: Gradients are held against their twins by norm-relative error, per part
#: (a train-step gradient splits into its "weights" and "table" parts),
#: each part under its own bound. Each bound is set from the kernel's
#: readings against its twin (H100 80GB HBM3, 700 W; the inputs the main
#: path gives it: the loss gradient, not random cotangents) with about 3x
#: room or more, and lies below what a kernel of lower precision reads: a
#: control in the same run, the twin at that lower precision, must break
#: it.
#:
#: K4 adds the same bf16-rounded contributions as its twin, in another
#: order (its private levels by shared atomics, then a fixed-order sum over
#: blocks; the other levels by f32 vector atomics, run-dependent): readings
#: up to 7.0e-8 (6.7e-8 since the scatter's redesign, F = 8 included).
GRID_BWD_REL = 1e-6
#: K5 sums on the tensor cores in its own order, which can flip the bf16
#: rounding of a hidden unit or of g at a layer boundary, as its twin rounds
#: them. Readings: gW up to 1.8e-6 at config_hash and 1.0e-5 at 128x5; gx,
#: itself bf16, up to 3.1e-4 and 2.2e-3. Control: the twin's gW rounded to
#: bf16 (partials kept in bf16, not f32) reads 1.6e-3 to 1.7e-3.
K5_REL = {"config_hash": {"gW": 1e-4, "gx": 1e-3}, "128x5": {"gW": 1e-4, "gx": 6e-3}}
#: K6 against its twin: the forward's bf16 roundings can flip as in K2, the
#: split-bf16 backward carries g to 16 significant bits where the twin keeps
#: f32, and the atomics add in their own order. Readings over ten inputs:
#: loss up to 1.9e-7 relative; weights 3.7e-6 to 5.7e-6; table 1.6e-5 to
#: 6.9e-5 (both round each corner's contribution to bf16, and g's 2^-16
#: difference flips a few of those roundings, more where a sample's
#: gradient is large). Control: the composed route's precision, g rounded to
#: bf16 at the loss and at every layer, reads 9e-6 to 1.6e-5 on the weights
#: (sums over 2^18 rows average its roundings away) and 4.3e-4 to 5.1e-4 on
#: the table, which is the part that tells the two apart; a K6 built that
#: way read 4.3e-4 there and failed. The redesigned scatter (private levels,
#: vector atomics) reads the same: table 1.6e-5 to 6.9e-5 at config_hash,
#: up to 9.6e-5 at F = 8, whose control reads 7.0e-4.
TRAIN_LOSS_RTOL = 1e-5
K6_REL = {"weights": 2e-5, "table": 2e-4}
#: The composed route (K1 K2 K5 K4) against K6 on the same step of the
#: training phase: it rounds the loss gradient and every layer's g to bf16
#: where K6 keeps them at f32 precision. Readings: weights 1.5e-4 to
#: 2.3e-4, table 2.3e-3.
ROUTE_REL = {"weights": 1e-3, "table": 8e-3}
#: Coverage of K4, K5 and K6 beyond the main path, at a batch that is not a
#: tile multiple: every loss, every activation but Sine, Smoothstep and
#: Nearest interpolation, and max_level. It looks for a wrong branch, whose
#: error is of order 1. Its targets lie on either side of the prediction,
#: so the residuals' signs cancel in the sums and raise the relative error
#: (readings up to 1.0e-3, through an Exponential output); K4 keeps
#: GRID_BWD_REL.
B_COVER = (1 << 16) - 37
COVER_REL = 5e-3
#: Training phase: steps at B = 2^18; the loss must fall by at least
#: LOSS_FALL (first step over the mean of the last ten) and the holdout PSNR
#: of trainer.inference must reach PSNR_MIN dB. Both written before the
#: first run on the card, from a CPU rehearsal at B = 2^16 (980x, 22.6 dB).
N_TRAIN = 100
LOSS_FALL = 100.0
PSNR_MIN = 20.0
#: Two copies of a trained state, one step each: the steps (new - old
#: params) agree to norm-relative RESUME_REL (only the atomics' order
#: differs; readings 2.3e-9 to 6.6e-8).
RESUME_REL = 1e-6

#: The SDF slice: samples/learn_a_sdf.py's HashGrid config at full width.
B_SDF = 1 << 16
SDF_BATCHES = (B_SDF, B_SDF - 37, 1)
#: K7 against its twin (H100 80GB HBM3, 700 W; the eikonal step's inputs):
#: the same bf16-rounded contributions summed by f32 atomics in another
#: order (gtable, readings up to 3.0e-7); dL/dx summed in the twin's order
#: and rounded where the twin rounds (readings: bit-equal). Controls: the
#: contributions unrounded, f32 (2.6e-4 and more); dL/dx rounded to bf16
#: (1.5e-3 and more).
K7_REL = {"gtable": 1e-6, "gx": 1e-6}
#: K8 against its twin: ct_gy and ct_x bit-equal, gtable2 up to 5.7e-9.
#: Controls: ct_gy and ct_x in bf16 (1.3e-3, 6.8e-4 and more), gtable2
#: unrounded (1.5e-3).
K8_REL = {"ct_gy": 1e-6, "gtable2": 2e-8, "ct_x": 1e-6}
#: K9 against its twin: K6's differences (g split into bf16 hi + lo, 16
#: significant bits, where the twin keeps f32), carried into dL/dx.
#: Readings: weights up to 6.3e-6, table up to 1.2e-4. Controls: the
#: weight gradient rounded to bf16 (bf16 partials, as K5's control); the
#: composed route's precision, g rounded to bf16 at every layer, on the
#: table (4.4e-4 and more) and on dL/dx.
#: dL/dx per sample: a hidden unit whose bf16 rounding flips against the
#: twin's flips a ReLU mask and moves that sample's dL/dx by order 1 (over
#: the batch a norm then reads 1.3e-3, as the bf16 control does), so dL/dx
#: is held per sample at the K9_GX_Q quantile: readings up to 1.8e-5,
#: control 1.8e-3 and more.
K9_REL = {"weights": 2e-5, "table": 4e-4, "gx": 6e-5}
K9_GX_Q = 0.99
#: Coverage of K7 and K8 at D = 2 and D = 4 (B = 2^16 - 37, random
#: cotangents): a wrong branch errs by order 1.
COVER_IG_REL = 1e-5
#: SDF training: SDF_STEPS steps at B = 2^16 (1024 eikonal points); the
#: loss must fall by SDF_LOSS_FALL (first step over the mean of the last
#: ten) and the mean |SDF error| on the z = 0.5 slice must end under
#: SDF_SLICE_MAX. Both set before the first run on the card from a CPU
#: rehearsal of the same config on the twins (`python -m
#: tcnn_tpu_torch.samples.learn_a_sdf 200 cpu`: 0.0384 -> 3.94e-4, ~97x;
#: slice error 0.00445), with room for another seed and generator.
SDF_STEPS = 200
SDF_LOSS_FALL = 30.0
SDF_SLICE_MAX = 0.015
#: The fused route's eikonal gradient against the composed route's, after
#: the training: the composed first order rounds g to bf16 per layer where
#: K9 keeps f32, and its matmul chain sums in another order than K3, which
#: flips the ReLU mask of a few points (reading 2.4e-2; the bound first
#: written, 1e-2, came from a CPU reading at a small size, 9.1e-4).
SDF_ROUTE_REL = 7e-2

#: The PPNG kernels at the factory defaults (ppng_1.h:340-378), B = 2^17.
B_PPNG = 1 << 17
PPNG_VARIANTS = ("PPNG1", "PPNG2", "PPNG3")
#: K10 and K12 against their twins: bit-equal (K10 copies the table's own
#: values; K12 sums the corners in the twin's order with __fmul_rn and
#: __fadd_rn; readings: bit-equal, H100 80GB HBM3, 700 W). Controls, each
#: differing on 48-100% of the values: PPNG1's gather over a bf16 table,
#: PPNG2's over a table truncated (not rounded) to bf16, K12 keeping its
#: corner sum in bf16.
#: K11 and K13's table half add the same contributions as their twins by
#: f32 atomics in another order: norm-relative EXT_SCATTER_REL (readings:
#: PPNG1 4.4e-7 to 4.6e-7, where thousands of adds land on each of its 37 K
#: gradient floats; PPNG2 1.6e-7; K13 2.6e-8). Controls: PPNG1's
#: contributions rounded to bf16 where its einsum does not round (3.5e-4);
#: PPNG2's and PPNG3's not rounded where the dense-ext scatter rounds
#: (9.1e-4, 1.0e-3).
#: K13's dots: the twin's feature order and roundings, EXT_DOTS_REL
#: (readings: bit-equal). Control: the dots rounded to bf16 (1.7e-3).
EXT_SCATTER_REL = 2e-6
EXT_DOTS_REL = 1e-6
#: PPNG SDF training: SDF_STEPS steps of each sample config at B = 2^16;
#: (least loss fall, largest z = 0.5 slice error). Set before the first run
#: on the card from CPU rehearsals on the twins (PERF.md, §6): the loss of
#: PPNG1 and PPNG2 falls ~300x, dominated by the eikonal term, and their
#: slice error stays at its start (~0.122, the mean |SDF| of the slice) in
#: 200 steps; PPNG3's falls ~19x to a slice error of 0.016 (the JAX
#: package's own sample on the CPU: 0.019). On the card PPNG3 reads ~10.5x
#: and 0.0366: other batches, from a CUDA generator.
PPNG_SDF_LIMITS = {"PPNG1": (100.0, 0.15), "PPNG2": (100.0, 0.15), "PPNG3": (8.0, 0.04)}
#: Neither limit sees PPNG1's or PPNG2's table gradient: in 200 steps their
#: data term does not fall (CPU rehearsals: PPNG1 0.0275 -> 0.0286, PPNG2
#: 0.0312 -> 0.0288 on held-out points; PPNG3 0.0288 -> 4.2e-4). So after
#: the training, the sample's gradient on one batch through the kernels is
#: held against the same step with K10-K13 swapped for their twins (K2, K5
#: and torch's ops shared), per part: the atomics' order is all that differs
#: (the kernel-level readings of EXT_SCATTER_REL). Control: the twins' scatters
#: accumulating in bf16.
PPNG_GRAD_REL = {"weights": EXT_SCATTER_REL, "table": EXT_SCATTER_REL}
#: Launches per SDF step of each PPNG config: the data term's gather and its
#: table gradient (K10, K11 or K12, K13) and K2, K5; the eikonal term's
#: gather, its first order (PPNG3: K13's two halves, each a Function) and
#: its second order's table gradient (K11 or K13) and, for PPNG3, K12 for
#: the MLP chain's cotangent.
PPNG_PER_STEP = {"PPNG1": {"K10": 2, "K11": 2, "K2": 1, "K5": 1},
                 "PPNG2": {"K10": 2, "K11": 2, "K2": 1, "K5": 1},
                 "PPNG3": {"K12": 3, "K13": 4, "K2": 1, "K5": 1}}

#: The options of config_hash's grid that phases 12 and 13 drive.
OPTIONS = {"stochastic": {"stochastic_interpolation": True}, "rng": {"hash": "Rng"},
           "both": {"stochastic_interpolation": True, "hash": "Rng"}}
#: The controls of phase 12: each option's twin drawing with this key or
#: hashing with this seed, where the kernels take 1337.
CONTROL_SEED = 1338
#: Phase 12's bounds are the base kernels' (K1_REL, MLP_REL, GRID_BWD_REL,
#: K6_REL, K7_REL, K8_REL, K9_REL): the hash is integer math and the draw a
#: bit-equal cipher, so an option adds no rounding of its own; a corner
#: chosen otherwise than the twin's moves a whole contribution and reads
#: 1e-4 and more.
#: K6's options read more than K6 on their own models (H100 80GB HBM3,
#: 700 W; table part at config_hash, B = 2^18 and 2^18 - 37): before the
#: scatter's redesign, over two runs, stochastic 5.0e-5 to 2.06e-4, rng
#: 3.5e-5 to 1.68e-4, both 5.0e-5 to 1.14e-4; after it, in one run,
#: stochastic 5.0e-5, rng 1.39e-4 to 1.49e-4, both 5.1e-5 to 5.2e-5. Where
#: K6's g (16 significant bits) and the twin's (f32) round a contribution
#: to neighbouring bf16 values, a table row moves by a whole ulp of it, and
#: a few samples whose loss gradient is large (RelativeL2 near a zero
#: prediction) carry most of the norm. The control with g in bf16 (the
#: composed route's precision) reads 1.04e-3 to 1.39e-3 on these models,
#: and the options' faults (another corner or row) 0.37 and more. So the
#: options' table bound is 4e-4: about twice the largest reading, under
#: half the control's smallest (the bound of 6e-4 before it passed the
#: base model's control, 4.3e-4).
K6_OPT_REL = {"weights": K6_REL["weights"], "table": 4e-4}
#: Phase 13: (least loss fall, least holdout PSNR in dB) of each option over
#: N_TRAIN steps at B = 2^18, set before the first run on the card from CPU
#: rehearsals of both packages at B = 2^16 (scripts/rehearse_train_options.py;
#: PERF.md, section 6).
OPTION_LIMITS = {"stochastic": (100.0, 20.0), "rng": (100.0, 20.0), "both": (100.0, 20.0)}

#: Phases 14 and 15: the reference's default hash grid (README.md:28-41 of
#: tiny-cuda-nn, grid.h:1148-1160), config_hash's encoding with these keys:
#: 16 levels of up to 2^19 rows, 5,592,320 in all; levels 6-11 hash, and
#: 12-15 do not because their uint32 stride res^2 wraps to 0 (at level 15
#: the row is pos0 mod 2^19). The JAX package runs levels 6-15 through its
#: binned stages (B12); the port through the kernels of config_hash. The
#: SDF's 3-D grid at T=2^19 has 3,471,664 rows. The checks keep the base
#: bounds (K1_REL, MLP_REL, GRID_BWD_REL, K6_REL, K7_REL, K8_REL, K9_REL,
#: ROUTE_REL, RESUME_REL, SDF_ROUTE_REL): the table's size adds no rounding.
#: Beside each stands a control that hashes the wrapped levels, as an index
#: computed with an unwrapped stride would.
REFERENCE_ENCODING = {"log2_hashmap_size": 19, "per_level_scale": 2.0}
#: Phase 14 trains the reference default through the image sample's
#: `train` for N_SAMPLE_STEPS steps at B = 2^18 on the synthetic 1024^2
#: image; (least loss fall, first step over the mean of the last ten; least
#: PSNR in dB of the sample's `render` over every pixel). Set before the
#: first run on the card from a CPU rehearsal on the twins at B = 2^16
#: (scripts/rehearse_reference_default.py image 200 16: 27.0 -> 0.00378,
#: 7144x; 29.55 dB), with room for another batch size, seed and generator.
N_SAMPLE_STEPS = 200
SAMPLE_LIMITS = (1000.0, 26.0)
#: Phase 15: SDF_STEPS eikonal steps of the SDF sample at T=2^19; (least
#: loss fall, largest z = 0.5 slice error), set the same way
#: (scripts/rehearse_reference_default.py sdf 200: 0.0384 -> 3.62e-4, 106x;
#: slice error 0.00441, as at T=2^17), with phase 8's room.
SDF19_LIMITS = (30.0, 0.015)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare(name, got, want, rel_ulp=None, rel_max=None):
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if rel_ulp is not None:
        bound = rel_ulp * torch.maximum(g.abs(), w.abs())
        ok = bool((diff <= bound).all())
        limit = f"{rel_ulp} x |value|"
    else:
        limit = rel_max * max(1.0, float(w.abs().max()))
        ok = err <= limit
    emit({"phase": "compare", "name": name, "B": int(got.shape[0]), "max_abs_err": err,
          "bit_equal_share": float((diff == 0).float().mean()), "limit": str(limit), "ok": ok})
    check(ok, f"{name}: kernel disagrees with its plain twin (max abs err {err})")
    torch.cuda.synchronize()
    return err


def norm_errors(got, want, bounds, split=None):
    """Norm-relative error of `got` against `want` for each part named in
    `bounds` ("all": the whole tensor; a flat train-step gradient splits
    at `split` into "weights" and "table"), and the max abs error."""
    import torch

    torch.cuda.synchronize()
    g, w = got.double().reshape(-1), want.double().reshape(-1)
    parts = {"all": slice(None), "weights": slice(0, split), "table": slice(split, None)}
    rel = {p: float(torch.linalg.vector_norm(g[parts[p]] - w[parts[p]])
                    / torch.linalg.vector_norm(w[parts[p]]).clamp_min(1e-30)) for p in bounds}
    return rel, float((g - w).abs().max()) if g.numel() else 0.0


def compare_norm(name, got, want, bounds, split=None):
    """A gradient against its twin's: each part's norm-relative error under
    its bound (`bounds`: part -> bound, or one bound for the whole)."""
    import torch

    if not isinstance(bounds, dict):
        bounds = {"all": bounds}
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    rel, err = norm_errors(got, want, bounds, split)
    ok = all(rel[p] <= b for p, b in bounds.items())
    emit({"phase": "compare", "name": name, "shape": list(got.shape), "norm_rel_err": rel,
          "max_abs_err": err, "max_abs": float(want.abs().max()), "limit": bounds, "ok": ok})
    check(ok, f"{name}: kernel disagrees with its plain twin (norm-relative {rel})")
    torch.cuda.synchronize()
    return err


def control(name, lower, want, bounds, split=None):
    """A twin of lower precision against the twin: the same bounds must
    reject it, or they could not tell such a kernel from the right one."""
    if not isinstance(bounds, dict):
        bounds = {"all": bounds}
    rel, _ = norm_errors(lower, want, bounds, split)
    rejected = any(rel[p] > b for p, b in bounds.items())
    emit({"phase": "control", "name": name, "norm_rel_err": rel, "limit": bounds,
          "rejected": rejected})
    check(rejected, f"control {name}: the bounds {bounds} pass a lower-precision twin ({rel})")


def row_errors(got, want):
    """Per-row relative error |got - want| / |want| (2-norms over a row)."""
    import torch

    g, w = got.double(), want.double()
    return (torch.linalg.vector_norm(g - w, dim=1)
            / torch.linalg.vector_norm(w, dim=1).clamp_min(1e-30))


def compare_rows(name, got, want, q, bound):
    """dL/dx against its twin's, per sample: the q-quantile of the per-row
    relative error under `bound`. A hidden unit whose bf16 rounding flips
    (the tensor cores sum in another order than the twin) flips a ReLU mask
    and moves that one sample's dL/dx by order 1; such samples are counted
    and reported, and the quantile holds the rest to the kernel's
    precision."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    e = row_errors(got, want)
    qv = float(torch.quantile(e.float(), q)) if e.numel() else 0.0
    rel, err = norm_errors(got, want, {"all": None})
    ok = qv <= bound
    emit({"phase": "compare", "name": name, "shape": list(got.shape), "quantile": q,
          "row_rel_err_at_quantile": qv, "rows_over_1e-3": int((e > 1e-3).sum()),
          "row_rel_err_median": float(e.median()) if e.numel() else 0.0,
          "norm_rel_err": rel, "max_abs_err": err, "limit": bound, "ok": ok})
    check(ok, f"{name}: kernel disagrees with its plain twin (q{q} row error {qv})")
    return err


def control_rows(name, lower, want, q, bound):
    """The row-quantile bound must reject a twin of lower precision."""
    import torch

    e = row_errors(lower, want)
    qv = float(torch.quantile(e.float(), q)) if e.numel() else 0.0
    emit({"phase": "control", "name": name, "quantile": q, "row_rel_err_at_quantile": qv,
          "limit": bound, "rejected": qv > bound})
    check(qv > bound, f"control {name}: the bound {bound} passes a lower-precision twin ({qv})")


def counters():
    """Every kernel's launch counter, by name."""
    from tcnn_tpu_torch.ops.cuda import ext_kernel, grid_kernel, mlp_kernel, train_kernel

    return {"K1": grid_kernel.LAUNCHES, "K2": mlp_kernel.LAUNCHES, "K3": train_kernel.LAUNCHES,
            "K4": grid_kernel.BWD_LAUNCHES, "K5": mlp_kernel.BWD_LAUNCHES,
            "K6": train_kernel.TRAIN_LAUNCHES, "K7": grid_kernel.IG_LAUNCHES,
            "K8": grid_kernel.BWDBWD_LAUNCHES, "K9": train_kernel.IG_LAUNCHES,
            "K10": ext_kernel.GATHER_LAUNCHES, "K11": ext_kernel.SCATTER_LAUNCHES,
            "K12": ext_kernel.LOOKUP_LAUNCHES, "K13": ext_kernel.LOOKUP_BWD_LAUNCHES}


def reset_counters():
    from tcnn_tpu_torch.ops.cuda import ext_kernel, grid_kernel, mlp_kernel, train_kernel

    grid_kernel.LAUNCHES = grid_kernel.BWD_LAUNCHES = 0
    grid_kernel.IG_LAUNCHES = grid_kernel.BWDBWD_LAUNCHES = 0
    mlp_kernel.LAUNCHES = mlp_kernel.BWD_LAUNCHES = 0
    train_kernel.LAUNCHES = train_kernel.TRAIN_LAUNCHES = train_kernel.IG_LAUNCHES = 0
    ext_kernel.GATHER_LAUNCHES = ext_kernel.SCATTER_LAUNCHES = 0
    ext_kernel.LOOKUP_LAUNCHES = ext_kernel.LOOKUP_BWD_LAUNCHES = 0


def cuda_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_params(trainer, gen):
    """The model's init with the encoding table redrawn from U(-1, 1), so
    the MLP sees inputs of a trained model's size (the grid init is 1e-4)."""
    import torch

    p = trainer.params.detach().cpu().clone()
    n_net = trainer.model.network.n_params
    p[n_net:] = torch.rand(p.numel() - n_net, generator=gen) * 2 - 1
    return p


#: (label, encoding keys, network keys, max_level, losses) of config_hash
#: variants for the coverage phase. Every activation but Sine is a hidden
#: or an output activation once; CrossEntropy and Variance need a positive
#: prediction, which Sigmoid gives.
COVER_CASES = (
    ("ReLU/None", {}, {}, None,
     ("L2", "RelativeL2", "RelativeL2Luminance", "L1", "RelativeL1", "MAPE", "SMAPE")),
    ("Tanh/Sigmoid", {}, {"activation": "Tanh", "output_activation": "Sigmoid"}, None,
     ("CrossEntropy", "Variance", "L2")),
    ("LeakyReLU/Exponential", {}, {"activation": "LeakyReLU", "output_activation": "Exponential"},
     None, ("RelativeL1",)),
    ("Softplus/Squareplus", {}, {"activation": "Softplus", "output_activation": "Squareplus"},
     None, ("MAPE",)),
    ("Sigmoid/Tanh", {}, {"activation": "Sigmoid", "output_activation": "Tanh"}, None,
     ("SMAPE",)),
    ("Exponential/LeakyReLU", {}, {"activation": "Exponential", "output_activation": "LeakyReLU"},
     None, ("RelativeL2Luminance",)),
    ("Smoothstep", {"interpolation": "Smoothstep"}, {}, None, ("RelativeL2",)),
    ("Nearest", {"interpolation": "Nearest"}, {}, None, ("RelativeL2",)),
    ("max_level 0.5", {}, {}, 0.5, ("RelativeL2",)),
)


def loss_cotangent(dims, weights, enc, loss, targets, loss_scale, pdf=None, noise=None):
    """The cotangent the composed route hands K5: the loss gradient at the
    twin's prediction, times loss_scale, in bf16 [B, out_w]."""
    import torch
    from tcnn_tpu_torch.ops.cuda import mlp_kernel

    pred = mlp_kernel._mlp_forward_plain(dims, weights, enc).float()
    if noise is not None:
        pred = pred + noise
    return (loss.value_and_grad_fn(pred, targets, pdf)[1] * loss_scale).to(torch.bfloat16)


def composed_twin(prep, n_active, loss, x, targets, loss_scale, pdf=None, noise=None,
                  ext_dl=False):
    """The flat train-step gradient at the composed route's precision, from
    the twins: the loss gradient and every layer's g rounded to bf16 (K5's
    twin), then the table gradient (K4's twin)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel

    enc = grid_kernel._grid_encode_plain(prep.plan, prep.table, x, prep.dims.in_w, n_active)
    gout = (targets.to(torch.bfloat16) if ext_dl else
            loss_cotangent(prep.dims, prep.weights, enc, loss, targets, loss_scale, pdf, noise))
    gw, gx = mlp_kernel._mlp_backward_plain(prep.dims, prep.weights, enc, gout)
    return torch.cat([gw, grid_kernel._grid_backward_plain(prep.plan, x, gx, n_active).reshape(-1)])


def check_train_step(name, net, loss, params, x, targets, loss_scale, bounds, control_too=False,
                     ctl_plan=None, bits=False, **kw):
    """K6 against its twin on one step: the loss sum within TRAIN_LOSS_RTOL,
    the gradient's weights and table parts within `bounds`; with
    `control_too`, the composed route's precision must break them, and with
    `ctl_plan`, the twin on that plan (other draws or another hash seed);
    with `bits`, the weights' gradient of a second launch must be the same
    bits (K6 sums it in a fixed order). Returns the max abs error of the
    gradient."""
    import torch
    from tcnn_tpu_torch.ops.cuda import train_kernel

    prep = train_kernel.prepare_forward(net, params)
    n_active = net.encoding.active_levels()
    kl, kg = train_kernel.fused_train_grads(net, loss, params, x, targets, loss_scale, **kw)
    if bits:
        _, kg2 = train_kernel.fused_train_grads(net, loss, params, x, targets, loss_scale, **kw)
        torch.cuda.synchronize()
        n = prep.dims.n_weights
        same = torch.equal(kg[:n], kg2[:n])
        emit({"phase": "compare", "name": f"K6 {name}, weights of two launches bit-equal",
              "ok": same})
        check(same, f"K6 {name}: two launches' weight gradients differ")
    pl, pg = train_kernel._fused_train_grads_plain(
        prep.plan, prep.dims, n_active, prep.table, prep.weights, loss, x, targets, loss_scale,
        kw.get("pdf"), kw.get("noise"), kw.get("ext_dl", False))
    torch.cuda.synchronize()
    kl, pl = float(kl), float(pl)
    loss_ok = abs(kl - pl) <= TRAIN_LOSS_RTOL * abs(pl)
    emit({"phase": "compare", "name": f"K6 fused_train loss {name}", "kernel": kl, "plain": pl,
          "rtol": TRAIN_LOSS_RTOL, "ok": loss_ok})
    check(loss_ok, f"K6 fused_train loss {name}: {kl} vs {pl}")
    split = prep.dims.n_weights
    err = compare_norm(f"K6 fused_train grads {name}", kg, pg, bounds, split)
    if control_too:
        lower = composed_twin(prep, n_active, loss, x, targets, loss_scale, **kw)
        control(f"K6 {name}, g in bf16", lower, pg, bounds, split)
    if ctl_plan is not None:
        _, other = train_kernel._fused_train_grads_plain(
            ctl_plan, prep.dims, n_active, prep.table, prep.weights, loss, x, targets, loss_scale,
            kw.get("pdf"), kw.get("noise"), kw.get("ext_dl", False))
        control(f"K6 {name}, {control_label(ctl_plan)}", other, pg, bounds, split)
    return err


def check_mlp_bwd(name, dims, weights, enc, gout, bounds, control_too=False):
    """K5 against its twin: gW and gx within `bounds` ({"gW": .., "gx": ..}),
    and bit-equal between two launches (K5 sums its weight gradient in a
    fixed order); with `control_too`, the twin's gW rounded to bf16 must
    break the gW bound. Returns the max abs error."""
    import torch
    from tcnn_tpu_torch.ops.cuda import mlp_kernel

    gw, gx = mlp_kernel.mlp_backward(dims, weights, enc, gout)
    gw2, gx2 = mlp_kernel.mlp_backward(dims, weights, enc, gout)
    torch.cuda.synchronize()
    same = torch.equal(gw, gw2) and torch.equal(gx, gx2)
    emit({"phase": "compare", "name": name + ", two launches bit-equal", "ok": same})
    check(same, f"{name}: two launches on the same inputs differ")
    pw, px = mlp_kernel._mlp_backward_plain(dims, weights, enc, gout)
    err = max(compare_norm(name + " gW", gw, pw, bounds["gW"]),
              compare_norm(name + " gx", gx.float(), px.float(), bounds["gx"]))
    if control_too:
        control(name + " gW in bf16", pw.to(torch.bfloat16).float(), pw, bounds["gW"])
    return err


def to_bf16(t):
    import torch

    return t.to(torch.bfloat16).float()


def scatter_f32(plan, x, g, z=None):
    """The table-gradient scatter without the bf16 rounding of each
    contribution, the control that the table-gradient bounds must reject:
    K4's and K7's (corner weights W_c) or, with z, K8's (zw_c =
    sum_d z_d dW_c/dx_d)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    L, F = plan.n_levels, plan.f
    gl = g[:, : L * F].float().reshape(-1, L, F)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    for k in grid_kernel._corners(plan, x, derivs=z is not None):
        w = k.w if z is None else sum(z[:, None, d] * k.dw[d] for d in range(plan.d))
        out.index_add_(0, k.rows.reshape(-1), (w[..., None] * gl).reshape(-1, F))
    return out


def check_f8(cfg, gen, dev):
    """Phase 3c: config_hash with 8 features per level (a 128-wide MLP
    input; K6 at a 64-row tile; levels 0-2 private in K4 and K6): K4 and
    K6 against their twins at B = 2^18 and 2^18 - 37, each bound beside a
    control that must break it (K4's contributions unrounded; K6 with g in
    bf16). Returns {kernel: max abs err}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel

    m = reference_model(cfg, SEED + 40, dev, gen, n_features_per_level=8)
    net, tr = m.network, m.trainer
    plan = net.encoding.plan
    check(plan.f == 8 and tr.use_fused(), "F = 8 must take K6")
    L, w = plan.n_levels, net.encoding.padded_output_width
    errs = {"K4": 0.0, "K6": 0.0}
    for B in BATCHES[:2]:
        x = torch.rand(B, 2, generator=gen).to(dev)
        gy = torch.randn(B, w, generator=gen).to(torch.bfloat16).to(dev)
        want = grid_kernel._grid_backward_plain(plan, x, gy, L)
        errs["K4"] = max(errs["K4"], compare_norm(
            f"K4 grid_bwd F=8 B={B}", grid_kernel.grid_backward(plan, x, gy, L), want, GRID_BWD_REL))
        t = torch.rand(B, 3, generator=gen).to(dev)
        errs["K6"] = max(errs["K6"], check_train_step(
            f"F=8 B={B}", net, tr.loss_fn, tr.params, x, t, tr.loss_scale, K6_REL,
            control_too=B == B_MAIN))
        if B == B_MAIN:
            control("K4 F=8, contributions unrounded", scatter_f32(plan, x, gy), want, GRID_BWD_REL)
    emit({"phase": "F=8", "private_levels": {
        "K4": grid_kernel.private_levels(plan, L, grid_kernel.K4_PRIVATE_BYTES)[0],
        "K6": train_kernel.train_layout(net)[1]}, "tile": train_kernel.train_layout(net)[0]})
    return errs


def eikonal_inputs(net, params, x):
    """The cotangents the eikonal step hands K7, K8 and K9 at the points x:
    K9's gy (d sum(out[:, 0]) / d out, f32 [B, out_w]); K7's gy (the MLP
    chain's input gradient of the same, bf16 [B, enc_w], the composed
    route's first order); K8's z (d eik / d gx at the twin's gx)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    net_p, enc_p = net.split_params(params)
    plan = net.encoding.plan
    table = enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
    enc = grid_kernel._grid_encode_plain(plan, table, x, net.encoding.padded_output_width,
                                         plan.n_levels).requires_grad_(True)
    with torch.enable_grad():
        out = net.network.apply(net_p, enc, second_order=True)
        (gy_enc,) = torch.autograd.grad(out[:, 0].float().sum(), enc)
    gy_out = torch.zeros((x.shape[0], net.network.padded_output_width), device=x.device)
    gy_out[:, 0] = 1.0
    gx = grid_kernel._grid_input_grad_plain(plan, table, x, gy_enc).requires_grad_(True)
    with torch.enable_grad():
        eik = 0.01 * torch.mean((torch.linalg.vector_norm(gx, dim=-1) - 1.0) ** 2)
        (z,) = torch.autograd.grad(eik, gx)
    return table, gy_out, gy_enc.to(torch.bfloat16).contiguous(), z.contiguous()


def check_ig_kernels(tag, net, params, x, gen, control_too=True, bounds=None):
    """K7, K8 (without and with a table cotangent) and K9 against their
    twins on the eikonal step's inputs at x; each part under its bound, and
    with `control_too` a lower-precision twin that must break it. Returns
    the max abs errors {K7, K8, K9}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel, train_kernel

    plan = net.encoding.plan
    table, gy_out, gy_enc, z = eikonal_inputs(net, params, x)
    errs = {}
    b7 = bounds or K7_REL
    kt, kx = grid_kernel.grid_backward_ig(plan, table, x, gy_enc)
    pt, px = grid_kernel._grid_backward_ig_plain(plan, table, x, gy_enc)
    errs["K7"] = max(compare_norm(f"K7 grid_bwd_ig gtable {tag}", kt, pt, b7["gtable"]),
                     compare_norm(f"K7 grid_bwd_ig gx {tag}", kx, px, b7["gx"]))
    if control_too:
        control(f"K7 gtable unrounded {tag}", scatter_f32(plan, x, gy_enc), pt, b7["gtable"])
        control(f"K7 gx in bf16 {tag}", to_bf16(px), px, b7["gx"])
    b8 = bounds or K8_REL
    ct = (torch.randn(plan.total_rows, plan.f, generator=gen) * 1e-2).to(torch.bfloat16).to(x.device)
    errs["K8"] = 0.0
    for label, ct_table in (("", None), (" ct_table", ct)):
        k = grid_kernel.grid_backward_bwd(plan, table, ct_table, x, gy_enc, z)
        q = grid_kernel._grid_backward_bwd_plain(plan, table, ct_table, x, gy_enc, z)
        for part, a, b in zip(("ct_gy", "gtable2", "ct_x"), k, q):
            errs["K8"] = max(errs["K8"], compare_norm(
                f"K8 grid_bwd_bwd {part}{label} {tag}", a, b, b8[part]))
        if control_too:
            control(f"K8 ct_gy in bf16{label} {tag}", to_bf16(q[0]), q[0], b8["ct_gy"])
            control(f"K8 ct_x in bf16{label} {tag}", to_bf16(q[2]), q[2], b8["ct_x"])
            control(f"K8 gtable2 unrounded{label} {tag}",
                    scatter_f32(plan, x, gy_enc, z), q[1], b8["gtable2"])
    if bounds is not None:
        return errs
    prep = train_kernel.prepare_forward(net, params)
    kg, kx9 = train_kernel.fused_ig_grads(net, params, x, gy_out)
    pg, px9 = train_kernel._fused_ig_grads_plain(plan, prep.dims, prep.table, prep.weights, x,
                                                 gy_out)
    split = prep.dims.n_weights
    errs["K9"] = max(compare_norm(f"K9 fused_ig grads {tag}", kg, pg,
                                  {"weights": K9_REL["weights"], "table": K9_REL["table"]}, split),
                     compare_rows(f"K9 fused_ig gx {tag}", kx9, px9, K9_GX_Q, K9_REL["gx"]))
    if control_too:
        enc = grid_kernel._grid_encode_plain(plan, prep.table, x, prep.dims.in_w, plan.n_levels)
        gw, genc = mlp_kernel._mlp_backward_plain(prep.dims, prep.weights, enc,
                                                  gy_out.to(torch.bfloat16))
        lower = torch.cat([gw, grid_kernel._grid_backward_plain(plan, x, genc, plan.n_levels)
                           .reshape(-1)])
        control(f"K9 table {tag}, g in bf16", lower, pg, {"table": K9_REL["table"]}, split)
        control(f"K9 weights {tag}, in bf16", to_bf16(pg), pg, {"weights": K9_REL["weights"]},
                split)
        control_rows(f"K9 gx {tag}, g in bf16",
                     grid_kernel._grid_input_grad_plain(plan, prep.table, x, genc), px9, K9_GX_Q,
                     K9_REL["gx"])
    return errs


def control_exact(name, lower, want):
    """A lower-precision twin against the twin: a bit-equality bound must
    reject it."""
    import torch

    differ = float((lower.float() != want.float()).float().mean())
    emit({"phase": "control", "name": name, "differing_share": differ, "limit": "bit-equal",
          "rejected": differ > 0})
    check(differ > 0, f"control {name}: bit-equal to the twin")


def ppng_model(variant, seed, gen, device, encoding=None):
    """A PPNG model (the sample's MLP, 64 x 2 ReLU) with the factory-default
    encoding or `encoding`, its table redrawn from U(-1, 1)."""
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    cfg = sdf.config(variant)
    cfg["encoding"] = encoding or {"otype": variant}
    m = tt.create_from_config(3, 1, cfg, seed=seed, device=device)
    m.trainer.set_params(random_params(m.trainer, gen))
    return m


def ppng_inputs(net, params, x):
    """What the main path hands the PPNG kernels at x: the flat f32 table,
    the rows (and PPNG3's weights), and the cotangents of the SDF data term
    mean((f(x) - sdf(x))^2), from the twins and the MLP's matmul chain:
    PPNG1/2 the picks' (f32 before the bf16 cast of PPNG2's), PPNG3 the
    encoding's (bf16-valued, as autograd hands it to K13)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    enc = net.encoding
    spec = enc.spec
    net_p, enc_p = net.split_params(params)
    flat = enc.table(enc_p)
    idx, w = enc.indices(x)

    def data_ct(leaf, y):
        y = torch.nn.functional.pad(y, (0, enc.n_to_pad))
        out = net.network.apply(net_p, y, second_order=True)[:, :1].float()
        loss = torch.mean((out - sdf.sdf_true(x)[:, None]) ** 2)
        return torch.autograd.grad(loss, leaf)[0]

    with torch.enable_grad():
        if enc.otype_name == "PPNG3":  # the weighted lookup
            y = ek._ext_lookup_plain(spec.table(flat), idx, w, spec.n_levels)
            leaf = y.float().requires_grad_(True)
            gy = data_ct(leaf, leaf.to(torch.bfloat16)).to(torch.bfloat16).float()
            return dict(flat=flat, table=spec.table(flat), idx=idx, cw=w, gy=gy.contiguous())
        picks = ek._ext_gather_plain(spec.table(flat), idx)
        leaf = picks.float().requires_grad_(True)
        ct = data_ct(leaf, enc.combine(leaf, w))
    return dict(flat=flat, table=spec.table(flat), idx=idx, ct=ct.to(spec.dtype).contiguous(),
                ct_f32=ct)


def time_pair(kern, plain, library=None, iters=20, plain_iters=3):
    """(kernel ms, twin ms, yardstick ms or None), in turns plain, kernel,
    kernel, plain (and the yardstick twice)."""
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kern, iters)
    k2 = cuda_ms(kern, iters)
    p2 = cuda_ms(plain, plain_iters)
    lib = None if library is None else min(cuda_ms(library, iters), cuda_ms(library, iters))
    return min(k1, k2), min(p1, p2), lib


def check_ppng_variant(tag, net, params, x, errs, timed=False):
    """K10 and K11 (PPNG1/2) or K12 and K13 (PPNG3) of one PPNG model
    against their twins at the points x, each beside a control its bound
    must reject. Adds to `errs`; with `timed`, returns ({kernel: (ms, twin
    ms, yardstick ms)}, {kernel: (bound ms, bound_by)})."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

    inp = ppng_inputs(net, params, x)
    spec, idx, tbl = net.encoding.spec, inp["idx"], inp["table"]
    B, F, P = x.shape[0], spec.f, inp["idx"].numel()
    ms, bounds = {}, {}
    if net.encoding.otype_name != "PPNG3":
        picks = ek.ext_gather(tbl, idx)
        want = ek._ext_gather_plain(tbl, idx)
        errs["K10"] = max(errs["K10"], compare(f"K10 ext_gather {tag}", picks, want, rel_ulp=0.0))
        if spec.dtype == torch.float32:
            control_exact(f"K10 {tag} over a bf16 table",
                          ek._ext_gather_plain(tbl.to(torch.bfloat16), idx), want)
        else:
            trunc = (inp["flat"].reshape(spec.n_rows, F).contiguous().view(torch.int32)
                     & -65536).view(torch.float32).to(torch.bfloat16)
            control_exact(f"K10 {tag} over a truncated bf16 table",
                          ek._ext_gather_plain(trunc, idx), want)
        ct = inp["ct"]
        got = ek.ext_scatter(idx, ct, spec.n_rows)
        want = ek._ext_scatter_plain(idx, ct, spec.n_rows)
        errs["K11"] = max(errs["K11"], compare_norm(f"K11 ext_scatter {tag}", got, want,
                                                    EXT_SCATTER_REL))
        if spec.dtype == torch.bfloat16:
            control(f"K11 {tag}, unrounded",
                    ek._ext_scatter_plain(idx, inp["ct_f32"], spec.n_rows), want, EXT_SCATTER_REL)
        else:
            control(f"K11 {tag}, rounded to bf16",
                    ek._ext_scatter_plain(idx, ct.to(torch.bfloat16), spec.n_rows), want,
                    EXT_SCATTER_REL)
        if timed:
            ct32 = ct.float()
            out = torch.zeros((spec.n_rows, F), device=x.device)
            ms["K10"] = time_pair(
                lambda: ek.ext_gather(tbl, idx), lambda: ek._ext_gather_plain(tbl, idx),
                lambda: tbl.index_select(0, idx.reshape(-1)))
            ms["K11"] = time_pair(
                lambda: ek.ext_scatter(idx, ct, spec.n_rows),
                lambda: ek._ext_scatter_plain(idx, ct, spec.n_rows),
                lambda: out.zero_().index_add_(0, idx.reshape(-1), ct32.reshape(P, F)))
            bounds["K10"] = kernel_bound(bytes_of(idx, tbl, picks))
            bounds["K11"] = kernel_bound(bytes_of(idx, ct, got), f32=P * F)
        return ms, bounds
    cw, gy = inp["cw"], inp["gy"]
    NL = spec.n_levels
    y = ek.ext_lookup(tbl, idx, cw, NL)
    want = ek._ext_lookup_plain(tbl, idx, cw, NL)
    errs["K12"] = max(errs["K12"], compare(f"K12 ext_lookup {tag}", y, want, rel_ulp=0.0))
    picks = tbl[idx.long()].float().reshape(B, -1, NL, F)
    wc = cw.reshape(B, -1, NL, 1)
    acc = torch.zeros_like(picks[:, 0])
    for c in range(picks.shape[1]):
        acc = (acc + wc[:, c] * picks[:, c]).to(torch.bfloat16).float()
    control_exact(f"K12 {tag}, corner sum in bf16", acc.reshape(B, -1).to(torch.bfloat16), want)
    dT, dcw = ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL)
    wT, wcw = ek._ext_lookup_bwd_plain(tbl, idx, cw, gy, spec.n_rows, NL, True, True)
    errs["K13"] = max(errs["K13"],
                      compare_norm(f"K13 ext_lookup_bwd table {tag}", dT, wT, EXT_SCATTER_REL),
                      compare_norm(f"K13 ext_lookup_bwd dots {tag}", dcw, wcw, EXT_DOTS_REL))
    for half, kw in (("table", dict(want_dots=False)), ("dots", dict(want_table=False))):
        one = ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL, **kw)
        errs["K13"] = max(errs["K13"], compare_norm(
            f"K13 ext_lookup_bwd {half} alone {tag}", one[0 if half == "table" else 1],
            wT if half == "table" else wcw, EXT_SCATTER_REL if half == "table" else EXT_DOTS_REL))
    unrounded = torch.zeros_like(wT).index_add_(
        0, idx.reshape(-1).long(), (cw.reshape(B, -1, NL, 1) * gy.reshape(B, 1, NL, F)).reshape(-1, F))
    control(f"K13 table {tag}, unrounded", unrounded, wT, EXT_SCATTER_REL)
    control(f"K13 dots {tag}, in bf16", to_bf16(wcw), wcw, EXT_DOTS_REL)
    if timed:
        bag_idx = idx.reshape(B, -1, NL).transpose(1, 2).reshape(B * NL, -1)
        bag_w = cw.reshape(B, -1, NL).transpose(1, 2).reshape(B * NL, -1)
        tbl32 = tbl.float()
        ms["K12"] = time_pair(
            lambda: ek.ext_lookup(tbl, idx, cw, NL),
            lambda: ek._ext_lookup_plain(tbl, idx, cw, NL),
            lambda: torch.nn.functional.embedding_bag(bag_idx, tbl32, mode="sum",
                                                      per_sample_weights=bag_w))
        ms["K13"] = time_pair(
            lambda: ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL),
            lambda: ek._ext_lookup_bwd_plain(tbl, idx, cw, gy, spec.n_rows, NL, True, True))
        bounds["K12"] = kernel_bound(bytes_of(idx, cw, tbl, y), f32=2 * P * F)
        bounds["K13"] = kernel_bound(bytes_of(idx, cw, gy, tbl, dT, dcw), f32=4 * P * F)
    return ms, bounds


def check_ppng_kernels(gen, dev, smi, errs):
    """Phase 10: for each PPNG variant, K10-K13 against their twins with
    their controls at the factory defaults (B_PPNG), then at the sample's
    config (B_SDF), whose kernel instantiations phase 11 launches, with K2
    and K5 at its MLP input width; each timed. Adds to `errs`; returns
    ({(kernel, variant): (ms, twin ms, yardstick ms)}, {(kernel, variant):
    (bound ms, bound_by)})."""
    import torch
    from tcnn_tpu_torch.ops.cuda import mlp_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    ppng_ms, ppng_bounds, sample_ms = {}, {}, {}
    for k in ("K10", "K11", "K12", "K13"):
        errs[k] = 0.0
    for variant in PPNG_VARIANTS:
        pm = ppng_model(variant, SEED + 11, gen, dev)
        x = torch.rand(B_PPNG, 3, generator=gen).to(dev)
        ms, bounds = check_ppng_variant(f"{variant} defaults B={B_PPNG}", pm.network,
                                        pm.trainer.params, x, errs, timed=True)
        ppng_ms.update({(k, variant): v for k, v in ms.items()})
        ppng_bounds.update({(k, variant): v for k, v in bounds.items()})

        pm = ppng_model(variant, SEED + 12, gen, dev, encoding=dict(sdf.ENCODINGS[variant]))
        pnet, pparams = pm.network, pm.trainer.params
        x = torch.rand(B_SDF, 3, generator=gen).to(dev)
        ms, bounds = check_ppng_variant(f"{variant} sample B={B_SDF}", pnet, pparams, x, errs,
                                        timed=True)
        sample_ms.update({(k, variant): (v, bounds[k]) for k, v in ms.items()})
        # K2 and K5 at the MLP input width the sample config gives them
        pdims = pnet.network.dims
        net_p, enc_p = pnet.split_params(pparams)
        enc_out = pnet.encoding.apply(enc_p, x)
        weights = net_p.to(torch.bfloat16).contiguous()
        errs["K2"] = max(errs["K2"], compare(
            f"K2 mlp_fwd {variant} in_w={pdims.in_w}", mlp_kernel.mlp_forward(pdims, weights, enc_out),
            mlp_kernel._mlp_forward_plain(pdims, weights, enc_out), rel_max=MLP_REL))
        gout = loss_cotangent(pdims, weights, enc_out, pm.loss, sdf.sdf_true(x)[:, None],
                              pm.trainer.loss_scale)
        errs["K5"] = max(errs["K5"], check_mlp_bwd(
            f"K5 mlp_bwd {variant} in_w={pdims.in_w}", pdims, weights, enc_out, gout,
            K5_REL["config_hash"], control_too=True))
    emit({"phase": "times ppng", "card": smi, "B": B_PPNG,
          "ms": {f"{k} {v}": {"kernel": t[0], "plain": t[1], "library": t[2],
                             "bound": ppng_bounds[(k, v)][0]}
                 for (k, v), t in ppng_ms.items()}})
    emit({"phase": "times ppng sample", "card": smi, "B": B_SDF,
          "ms": {f"{k} {v}": {"kernel": t[0], "plain": t[1], "library": t[2], "bound": b[0]}
                 for (k, v), (t, b) in sample_ms.items()}})
    return ppng_ms, ppng_bounds


@contextlib.contextmanager
def ext_twins(acc_bf16=False):
    """K10-K13's wrappers swapped for their plain twins where the autograd
    Functions call them; with `acc_bf16`, the scatters (K11's and K13's
    table half) accumulate in bf16, the control of lower precision."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

    def add_rows(n_rows, idx, contrib):
        out = torch.zeros((n_rows, contrib.shape[1]), dtype=torch.bfloat16, device=idx.device)
        return out.index_add_(0, idx.reshape(-1).long(), contrib.to(torch.bfloat16)).float()

    def scatter(idx, ct, n_rows):
        if acc_bf16:
            return add_rows(n_rows, idx, ct.reshape(idx.numel(), -1))
        return ek._ext_scatter_plain(idx, ct, n_rows)

    def lookup_bwd(table, idx, cw, gy, n_rows, n_levels, want_table=True, want_dots=True):
        dT, dcw = ek._ext_lookup_bwd_plain(table, idx, cw, gy, n_rows, n_levels, want_table,
                                           want_dots)
        if acc_bf16 and want_table:
            B, CNL = idx.shape
            contrib = (cw.reshape(B, CNL // n_levels, n_levels, 1)
                       * gy.reshape(B, 1, n_levels, -1)).to(torch.bfloat16)
            dT = add_rows(n_rows, idx, contrib.reshape(B * CNL, -1))
        return dT, dcw

    saved = ek.ext_gather, ek.ext_scatter, ek.ext_lookup, ek.ext_lookup_bwd
    ek.ext_gather, ek.ext_scatter = ek._ext_gather_plain, scatter
    ek.ext_lookup, ek.ext_lookup_bwd = ek._ext_lookup_plain, lookup_bwd
    try:
        yield
    finally:
        ek.ext_gather, ek.ext_scatter, ek.ext_lookup, ek.ext_lookup_bwd = saved


def ppng_sdf_slice(gen, dev, smi):
    """Phase 11: each PPNG sample config trains SDF_STEPS steps through the
    sample's step; its launches, loss fall and slice error are checked, and
    PPNG3's trainer.inference against model.apply. Returns ({variant:
    launches}, {variant: ms per step})."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    ppng_launches, ppng_step_ms = {}, {}
    for variant in PPNG_VARIANTS:
        pm = tt.create_from_config(3, 1, sdf.config(variant), seed=SEED + 13, device=dev)
        ptr, pnet = pm.trainer, pm.network
        check(not ptr.use_fused() and not train_kernel.supported_ig(pnet),
              f"{variant} must take the composed route")
        pgen = torch.Generator(device=dev).manual_seed(SEED)
        batches = [torch.rand(B_SDF, 3, generator=pgen, device=dev) for _ in range(SDF_STEPS)]
        held_out = torch.rand(B_SDF, 3, generator=pgen, device=dev)
        before = sdf.slice_error(pnet, ptr.params)
        with torch.no_grad():
            data_before = float(sdf.data_term(pnet, ptr.params, held_out))
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        plosses = [sdf.train_step(ptr, xs) for xs in batches]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launched = counters()
        plosses = torch.stack(plosses).cpu()
        check(bool(torch.isfinite(plosses).all()), f"{variant} SDF loss not finite")
        fall = float(plosses[0] / plosses[-10:].mean())
        after = sdf.slice_error(pnet, ptr.params)
        with torch.no_grad():
            data_after = float(sdf.data_term(pnet, ptr.params, held_out))
        per_step = PPNG_PER_STEP[variant]
        fall_min, slice_max = PPNG_SDF_LIMITS[variant]
        emit({"phase": "ppng sdf slice", "variant": variant, "steps": SDF_STEPS, "B": B_SDF,
              "eikonal_points": sdf.N_EIKONAL, "launches": launched,
              "launches_per_step_expected": per_step,
              "loss_first": float(plosses[0]), "loss_last10_mean": float(plosses[-10:].mean()),
              "loss_at": {str(i): float(plosses[i])
                          for i in sorted({0, SDF_STEPS // 10, SDF_STEPS // 4, SDF_STEPS // 2,
                                           SDF_STEPS - 1})},
              "loss_fall": fall, "loss_fall_min": fall_min, "slice_error_before": before,
              "slice_error": after, "slice_error_max": slice_max,
              "data_term_held_out": [data_before, data_after], "loop_seconds": loop_s})
        check(all(launched[k] == per_step.get(k, 0) * SDF_STEPS for k in launched),
              f"the {variant} SDF steps did not run {per_step} on every step: {launched}")
        check(fall >= fall_min, f"{variant} SDF loss fell only {fall}x")
        check(after <= slice_max, f"{variant} SDF slice error {after}")
        # the trained model's gradient through K10-K13 against their twins'
        split = pnet.network.n_params
        _, gk = sdf.loss_and_grad(ptr, batches[-1])
        with ext_twins():
            _, gp = sdf.loss_and_grad(ptr, batches[-1])
        compare_norm(f"{variant} SDF gradient, K10-K13 vs twins", gk, gp, PPNG_GRAD_REL, split)
        with ext_twins(acc_bf16=True):
            _, gl = sdf.loss_and_grad(ptr, batches[-1])
        control(f"{variant} SDF gradient, scatters in bf16", gl, gp, PPNG_GRAD_REL, split)
        ppng_launches[variant] = launched
        ppng_step_ms[variant] = cuda_ms(lambda: sdf.train_step(ptr, batches[-1]), 20)
        if variant == "PPNG3":
            for B in (B_SDF, 100_003, 1):
                xq = torch.rand(B, 3, generator=gen).to(dev)
                yq = ptr.inference(xq)
                check(yq.shape == (B, 1) and bool(torch.isfinite(yq).all()),
                      "PPNG3 inference shape/finite")
                check(torch.equal(yq, pnet.apply(ptr.params, xq)[:, :1].float()),
                      "PPNG3 trainer.inference differs from model.apply")
    emit({"phase": "times ppng sdf", "card": smi, "B": B_SDF, "sdf_train_step_ms": ppng_step_ms,
          "sdf_steps_per_s": {k: 1e3 / v for k, v in ppng_step_ms.items()}})
    return ppng_launches, ppng_step_ms


#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core
#: and f32 (non-tensor) operations/s.
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}


def bytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def grid_ops(B, plan, kind) -> float:
    """f32 operations of the grid's work per (sample, level) and corner, as
    the twins count them: the corner weight (D - 1 multiplies) and the
    weighted row (2F) forward; the same plus F multiplies and F adds of the
    scatter backward; with input gradients 2F more for the feature dot and
    D * D for dW/dx; the double backward's zw (2D), d2W (D^3) and hessian
    sums (2D^2), ct_gy (2F), the dot (2F) and the scatter (2F)."""
    D, F, C = plan.d, plan.f, plan.n_corners
    per = {"fwd": D - 1 + 2 * F, "bwd": D - 1 + 2 * F, "ig": D - 1 + 4 * F + D * D,
           "bwdbwd": D * D + 2 * D + D ** 3 + 2 * D * D + 6 * F}[kind]
    return float(B) * plan.n_levels * C * per


def kernel_bound(n_bytes, f32=0.0, bf16=0.0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peaks."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = f32 / PEAK_OPS["f32"] + bf16 / PEAK_OPS["bf16"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def grid_bounds(net, prep, x, t, gy_enc):
    """(bound ms, bound_by) of K1, K3, K4 and K6 on these inputs: bytes
    (each input read once, each output written once: the table once) over
    the memory rate against the corner math (one corner per (sample, level)
    in a stochastic scatter) and the MLP's products over their peaks."""
    plan, dims, B = prep.plan, prep.dims, x.shape[0]
    enc_w = net.encoding.padded_output_width
    fwd = grid_ops(B, plan, "fwd")
    bwd = grid_ops(B, plan, "bwd") / (plan.n_corners if plan.stochastic else 1)
    return {
        "K1": kernel_bound(bytes_of(x, prep.table) + B * enc_w * 2, f32=fwd),
        "K3": kernel_bound(bytes_of(x, prep.table, prep.weights) + B * dims.out_w * 2, f32=fwd,
                           bf16=2 * B * dims.n_weights),
        "K4": kernel_bound(bytes_of(x, gy_enc) + plan.total_rows * plan.f * 4, f32=bwd),
        "K6": kernel_bound(bytes_of(x, t, prep.table, prep.weights) + net.n_params * 4,
                           f32=fwd + bwd, bf16=6 * B * dims.n_weights),
    }


def time_grid_kernels(net, tr, x, t, gy_enc, kernels=("K1", "K3", "K4", "K6"), library=None,
                      plain_iters=3):
    """{kernel: (ms, twin ms, yardstick ms or None)} of `kernels` among K1,
    K3, K4 and K6 on these inputs, 50 launches a turn; `library` maps a
    kernel to its one-call PyTorch yardstick."""
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel

    prep = train_kernel.prepare_forward(net, tr.params)
    plan, dims, L = prep.plan, prep.dims, prep.plan.n_levels
    enc_w = net.encoding.padded_output_width
    timed = {
        "K1": (lambda: grid_kernel.grid_encode(plan, prep.table, x, enc_w, L),
               lambda: grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, L)),
        "K3": (lambda: train_kernel.fused_forward_prepared(prep, x),
               lambda: train_kernel._fused_forward_plain(prep, x)),
        "K4": (lambda: grid_kernel.grid_backward(plan, x, gy_enc, L),
               lambda: grid_kernel._grid_backward_plain(plan, x, gy_enc, L)),
        "K6": (lambda: train_kernel.fused_train_grads(net, tr.loss_fn, tr.params, x, t,
                                                      tr.loss_scale),
               lambda: train_kernel._fused_train_grads_plain(
                   plan, dims, L, prep.table, prep.weights, tr.loss_fn, x, t, tr.loss_scale,
                   None, None, False)),
    }
    library = library or {}
    return {k: time_pair(*timed[k], library.get(k), iters=50, plain_iters=plain_iters)
            for k in kernels}


def k4_yardstick(plan, x, gy, n_active):
    """K4's one-call PyTorch yardstick: `index_add_` of every corner's
    bf16-rounded contribution w_c * gy into its row, the rows and the
    contributions computed beforehand (as phase 12 hands the stochastic
    option's rows to its yardstick)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    L, F = plan.n_levels, plan.f
    g = gy[:, : L * F].float().reshape(-1, L, F)[:, :n_active]
    rows, contrib = [], []
    for k in grid_kernel._corners(plan, x):
        rows.append(k.rows[:, :n_active].reshape(-1))
        contrib.append((k.w[:, :n_active, None] * g).to(torch.bfloat16).float().reshape(-1, F))
    rows, contrib = torch.cat(rows), torch.cat(contrib)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    return lambda: out.zero_().index_add_(0, rows, contrib)


def time_steps(tr, x, t):
    """ms per `training_step` on the fused route, the composed one and the
    fused one again, 30 steps each."""
    step_ms = {}
    for route, flag in (("fused", None), ("composed", False), ("fused again", None)):
        tr.use_fused_train_kernel = flag
        step_ms[route] = cuda_ms(lambda: tr.training_step(x, t), 30)
    return step_ms


def time_ig_kernels(net, params, x, plain_iters=3):
    """K7, K8 and K9 on the eikonal step's inputs at x: ({kernel: (ms, twin
    ms, None)}, {kernel: (bound ms, bound_by)}), 20 launches a turn."""
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel

    plan, B = net.encoding.plan, x.shape[0]
    prep = train_kernel.prepare_forward(net, params)
    table, gy_out, gy_enc, z = eikonal_inputs(net, params, x)
    timed = {
        "K7": (lambda: grid_kernel.grid_backward_ig(plan, table, x, gy_enc),
               lambda: grid_kernel._grid_backward_ig_plain(plan, table, x, gy_enc)),
        "K8": (lambda: grid_kernel.grid_backward_bwd(plan, table, None, x, gy_enc, z),
               lambda: grid_kernel._grid_backward_bwd_plain(plan, table, None, x, gy_enc, z)),
        "K9": (lambda: train_kernel.fused_ig_grads(net, params, x, gy_out),
               lambda: train_kernel._fused_ig_grads_plain(plan, prep.dims, prep.table,
                                                          prep.weights, x, gy_out)),
    }
    ms = {k: time_pair(kern, plain, plain_iters=plain_iters) for k, (kern, plain) in timed.items()}
    gtable = plan.total_rows * plan.f * 4
    bounds = {
        "K7": kernel_bound(bytes_of(x, gy_enc, table) + gtable + x.numel() * 4,
                           f32=grid_ops(B, plan, "ig")),
        "K8": kernel_bound(bytes_of(x, gy_enc, z, table) + gy_enc.numel() * 4 + gtable
                           + x.numel() * 4, f32=grid_ops(B, plan, "bwdbwd")),
        "K9": kernel_bound(bytes_of(x, gy_out, table, prep.weights) + net.n_params * 4
                           + x.numel() * 4, f32=grid_ops(B, plan, "fwd") + grid_ops(B, plan, "ig"),
                           bf16=6 * B * prep.dims.n_weights),
    }
    return ms, bounds


def k5_bound(dims, weights, enc, gy):
    """K5's (bound ms, bound_by): x, gy and the weights read once, gW (f32)
    and gx written once; the recomputed forward, dgrad and wgrad products."""
    B = enc.shape[0]
    return kernel_bound(bytes_of(enc, gy, weights) + dims.n_weights * 4 + B * dims.in_w * 2,
                        bf16=6 * B * dims.n_weights)


def time_path_shapes(net, params, snet, sparams, gen, w128):
    """K3 and K5 at their paths' other shapes, each (ms, twin ms, None)
    beside its (bound ms, bound_by): K3 at B = 2^20 on `net` (the image
    sample's render chunk) and at the eikonal term's 1024 points on the SDF
    model `snet`; K5 at the SDF's data term (B = 2^16) and at 128 x 5 (the
    weights `w128`, B = 2^18)."""
    import torch
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel, train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    dev = params.device
    ms, bounds = {}, {}
    for key, model, p, B, d in (("K3 B=2^20", net, params, 1 << 20, 2),
                                (f"K3 SDF B={sdf.N_EIKONAL}", snet, sparams, sdf.N_EIKONAL, 3)):
        prep = train_kernel.prepare_forward(model, p)
        x = torch.rand(B, d, generator=gen).to(dev)
        ms[key] = time_pair(lambda: train_kernel.fused_forward_prepared(prep, x),
                            lambda: train_kernel._fused_forward_plain(prep, x), iters=20)
        bounds[key] = kernel_bound(bytes_of(x, prep.table, prep.weights) + B * prep.dims.out_w * 2,
                                   f32=grid_ops(B, prep.plan, "fwd"),
                                   bf16=2 * B * prep.dims.n_weights)
    dims128 = mlp_kernel.MlpDims(net.encoding.padded_output_width, 128, 5, 16, Activation.ReLU,
                                 Activation.NONE)
    sprep = train_kernel.prepare_forward(snet, sparams)
    for key, model, prep, dims, weights, B, d in (
            ("K5 SDF B=2^16", snet, sprep, sprep.dims, sprep.weights, B_SDF, 3),
            ("K5 128x5", net, train_kernel.prepare_forward(net, params), dims128, w128, B_MAIN, 2)):
        x = torch.rand(B, d, generator=gen).to(dev)
        enc = grid_kernel.grid_encode(prep.plan, prep.table, x, dims.in_w, prep.plan.n_levels)
        gy = torch.randn(B, dims.out_w, generator=gen).to(torch.bfloat16).to(dev)
        ms[key] = time_pair(lambda: mlp_kernel.mlp_backward(dims, weights, enc, gy),
                            lambda: mlp_kernel._mlp_backward_plain(dims, weights, enc, gy),
                            iters=20)
        bounds[key] = k5_bound(dims, weights, enc, gy)
    return ms, bounds


# ---------------------------------------------------------------------------
# Phases 12 and 13: the stochastic-interpolation and Rng options
# ---------------------------------------------------------------------------


def control_plan(plan, option):
    """The plan's twin with the draws of key CONTROL_SEED (stochastic) or
    the hash seeded with CONTROL_SEED (Rng); the kernels refuse it."""
    ctl = copy.copy(plan)
    if plan.stochastic:
        ctl.draw_seed = CONTROL_SEED
    if plan.rng:
        ctl.hash_seed = CONTROL_SEED
    assert option in OPTIONS and (ctl.draw_seed, ctl.hash_seed) != (plan.draw_seed, plan.hash_seed)
    return ctl


def control_label(plan) -> str:
    parts = [plan.label] if getattr(plan, "label", None) else []
    if plan.draw_seed == CONTROL_SEED:
        parts.append(f"drawing with key {CONTROL_SEED}")
    if plan.hash_seed == CONTROL_SEED:
        parts.append(f"hashing with seed {CONTROL_SEED}")
    return " and ".join(parts)


def control_ulp(name, lower, want, rel_ulp):
    """A twin of another hash against the twin: the per-value bound must
    reject it."""
    import torch

    diff = (lower.float() - want.float()).abs()
    over = float((diff > rel_ulp * torch.maximum(lower.float().abs(), want.float().abs()))
                 .float().mean())
    emit({"phase": "control", "name": name, "share_over_bound": over, "limit": f"{rel_ulp} x |value|",
          "rejected": over > 0})
    check(over > 0, f"control {name}: the bound {rel_ulp} passes it")


def control_max(name, lower, want, rel_max):
    """The same for a bound on the max abs error relative to max |want|."""
    err = float((lower.float() - want.float()).abs().max())
    limit = rel_max * max(1.0, float(want.float().abs().max()))
    emit({"phase": "control", "name": name, "max_abs_err": err, "limit": limit,
          "rejected": err > limit})
    check(err > limit, f"control {name}: the bound {limit} passes it ({err})")


def with_ties(plan, x, n=64):
    """x with its first n rows moved so that dimension 0's weight at level
    b % L equals the draw u[b, b % L] exactly: the stochastic corner keeps
    cell 0 there (u < w is false), which a kernel must reproduce."""
    import numpy as np
    import torch
    from tcnn_tpu_torch.ops.encodings.grid import stochastic_uniforms

    n = min(n, x.shape[0])
    u = stochastic_uniforms(n, plan.n_levels, "cpu").numpy()
    xs = x[:n].cpu().numpy().copy()
    for b in range(n):
        l = b % plan.n_levels
        if plan.interpolation.value != "Linear" or not 0.0 < u[b, l] < 1.0:
            continue
        uu, s = np.float32(u[b, l]), np.float32(plan.scales[l])
        v = np.float32((uu - np.float32(0.5)) / s)
        for _ in range(200):
            pos = np.float32(np.float32(v * s) + np.float32(0.5))
            if pos == uu:
                xs[b, 0] = v
                break
            v = np.nextafter(v, np.float32(np.inf) if pos < uu else np.float32(-np.inf))
    out = x.clone()
    out[:n] = torch.from_numpy(xs).to(x.device)
    return out


def option_model(cfg, option, seed, dev, gen, d=2, n_out=3):
    """A model of `cfg` with `option` set, its table redrawn from U(-1, 1)."""
    import tcnn_tpu_torch as tt

    ocfg = json.loads(json.dumps(cfg))
    ocfg["encoding"].update(OPTIONS[option])
    m = tt.create_from_config(d, n_out, ocfg, seed=seed, device=dev)
    m.trainer.set_params(random_params(m.trainer, gen))
    return m


def hash_int_ops(plan, x) -> float:
    """64-bit multiplies the Rng hashes of the corners of x need (two per
    set bit of each hashed corner's delta), counted apart from the bound."""
    import torch
    from tcnn_tpu_torch.ops import pcg32
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    cells, _ = grid_kernel.positions(x, torch.from_numpy(plan.scales).to(x.device),
                                     plan.interpolation)
    hashed = torch.tensor(plan.use_hash, device=x.device)
    total = 0
    for corner in range(plan.n_corners):
        cc = (cells + torch.tensor([(corner >> d) & 1 for d in range(plan.d)],
                                   device=x.device)) & 0xFFFFFFFF
        halves = [torch.zeros_like(cc[..., 0]), torch.zeros_like(cc[..., 0])]
        for d in range(plan.d):
            hi, lo = pcg32._shl64(cc[..., d], d * (64 // plan.d))
            halves = [halves[0] ^ hi, halves[1] ^ lo]
        bits = torch.zeros_like(halves[0])
        for v in halves:
            for _ in range(32):
                bits += v & 1
                v = v >> 1
        total += int(bits[:, hashed].sum())
    return 2.0 * total


def check_option_kernels(cfg, gen, dev, smi, enc_w):
    """Phase 12: each option of the grid kernels against its twin with a
    control; returns ({entry: max abs err}, {entry: (ms, twin ms, yardstick
    ms)}, {entry: (bound ms, bound_by)}), entries named "K4 stochastic" and
    the like."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    errs, ms, bounds, extra = {}, {}, {}, {}

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    models = {}
    for option in OPTIONS:
        m = option_model(cfg, option, SEED + 20, dev, gen)
        net, tr = m.network, m.trainer
        prep = train_kernel.prepare_forward(net, tr.params)
        plan, L = prep.plan, prep.plan.n_levels
        check(plan.rng == ("Rng" in str(OPTIONS[option])) and plan.stochastic
              == ("stochastic_interpolation" in OPTIONS[option]), f"{option}: plan options")
        ctl = control_plan(plan, option)
        models[option] = m
        for B in BATCHES:
            x = torch.rand(B, 2, generator=gen).to(dev)
            if plan.stochastic and B == B_MAIN:
                x = with_ties(plan, x)
            if plan.rng:
                want = grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, L)
                note(f"K1 {option}", compare(f"K1 grid_fwd {option} B={B}",
                                             grid_kernel.grid_encode(plan, prep.table, x, enc_w, L),
                                             want, rel_ulp=K1_REL))
                want3 = train_kernel._fused_forward_plain(prep, x)
                note(f"K3 {option}", compare(f"K3 fused_infer {option} B={B}",
                                             train_kernel.fused_forward_prepared(prep, x), want3,
                                             rel_max=MLP_REL))
                if B == B_MAIN:
                    control_ulp(f"K1 {option}, {control_label(ctl)}",
                                grid_kernel._grid_encode_plain(ctl, prep.table, x, enc_w, L), want,
                                K1_REL)
                    control_max(f"K3 {option}, {control_label(ctl)}",
                                train_kernel._fused_forward_plain(
                                    dataclasses.replace(prep, plan=ctl), x), want3, MLP_REL)
            gy = torch.randn(B, enc_w, generator=gen).to(torch.bfloat16).to(dev)
            want4 = grid_kernel._grid_backward_plain(plan, x, gy, L)
            note(f"K4 {option}", compare_norm(f"K4 grid_bwd {option} B={B}",
                                              grid_kernel.grid_backward(plan, x, gy, L), want4,
                                              GRID_BWD_REL))
            if B == B_MAIN:
                control(f"K4 {option}, {control_label(ctl)}",
                        grid_kernel._grid_backward_plain(ctl, x, gy, L), want4, GRID_BWD_REL)
            t = torch.rand(B, 3, generator=gen).to(dev)
            note(f"K6 {option}", check_train_step(
                f"{option} B={B}", net, tr.loss_fn, tr.params, x, t, tr.loss_scale,
                K6_OPT_REL, control_too=B == B_MAIN,
                ctl_plan=ctl if B == B_MAIN else None))

    # K7, K8, K9 with Rng at the SDF config (3-D: 21-bit lanes of delta)
    scfg = json.loads(json.dumps(sdf.CONFIG))
    sm = option_model(scfg, "rng", SEED + 21, dev, gen, d=3, n_out=1)
    snet, sparams = sm.network, sm.trainer.params
    check(sm.network.encoding.plan.rng and train_kernel.supported_ig(snet),
          "the Rng SDF config must take the fused ig route")
    for B in SDF_BATCHES:
        x = torch.rand(B, 3, generator=gen).to(dev)
        for k, v in check_ig_kernels(f"Rng B={B}", snet, sparams, x, gen,
                                     control_too=False).items():
            note(f"{k} rng", v)
    splan = snet.encoding.plan
    sctl = control_plan(splan, "rng")
    x = torch.rand(B_SDF, 3, generator=gen).to(dev)
    table, gy_out, gy_enc, z = eikonal_inputs(snet, sparams, x)
    label = control_label(sctl)
    pt, _ = grid_kernel._grid_backward_ig_plain(splan, table, x, gy_enc)
    control(f"K7 gtable Rng, {label}",
            grid_kernel._grid_backward_ig_plain(sctl, table, x, gy_enc)[0], pt, K7_REL["gtable"])
    q = grid_kernel._grid_backward_bwd_plain(splan, table, None, x, gy_enc, z)
    control(f"K8 gtable2 Rng, {label}",
            grid_kernel._grid_backward_bwd_plain(sctl, table, None, x, gy_enc, z)[1], q[1],
            K8_REL["gtable2"])
    sprep = train_kernel.prepare_forward(snet, sparams)
    pg, _ = train_kernel._fused_ig_grads_plain(splan, sprep.dims, sprep.table, sprep.weights, x,
                                               gy_out)
    cg, _ = train_kernel._fused_ig_grads_plain(sctl, sprep.dims, sprep.table, sprep.weights, x,
                                               gy_out)
    control(f"K9 table Rng, {label}", cg, pg, {"table": K9_REL["table"]}, sprep.dims.n_weights)
    # their times at B = 2^18, as phase 9 times them without the hash
    x = torch.rand(B_MAIN, 3, generator=gen).to(dev)
    ig_ms, ig_bounds = time_ig_kernels(snet, sparams, x, plain_iters=1)
    for k in ("K7", "K8", "K9"):
        ms[f"{k} rng"], bounds[f"{k} rng"] = ig_ms[k], ig_bounds[k]
        extra[f"{k} rng"] = {"hash_mul64": hash_int_ops(splan, x)}

    # K1 and K4 with Rng at D = 4 (16-bit lanes of delta that overlap)
    scfg["encoding"]["interpolation"] = "Linear"
    dm = option_model(scfg, "rng", SEED + 23, dev, gen, d=4, n_out=1)
    dplan = dm.network.encoding.plan
    dprep = train_kernel.prepare_forward(dm.network, dm.trainer.params)
    dctl = control_plan(dplan, "rng")
    x = torch.rand(B_SDF - 37, 4, generator=gen).to(dev)
    w = dm.network.encoding.padded_output_width
    want = grid_kernel._grid_encode_plain(dplan, dprep.table, x, w, dplan.n_levels)
    note("K1 rng", compare("K1 grid_fwd Rng D=4", grid_kernel.grid_encode(
        dplan, dprep.table, x, w, dplan.n_levels), want, rel_ulp=K1_REL))
    control_ulp(f"K1 Rng D=4, {control_label(dctl)}",
                grid_kernel._grid_encode_plain(dctl, dprep.table, x, w, dplan.n_levels), want, K1_REL)
    gy = torch.randn(x.shape[0], w, generator=gen).to(torch.bfloat16).to(dev)
    want = grid_kernel._grid_backward_plain(dplan, x, gy, dplan.n_levels)
    note("K4 rng", compare_norm("K4 grid_bwd Rng D=4", grid_kernel.grid_backward(
        dplan, x, gy, dplan.n_levels), want, GRID_BWD_REL))
    control(f"K4 Rng D=4, {control_label(dctl)}",
            grid_kernel._grid_backward_plain(dctl, x, gy, dplan.n_levels), want, GRID_BWD_REL)

    # times at B = 2^18, each option beside its twin
    for option, m in models.items():
        net, tr = m.network, m.trainer
        prep = train_kernel.prepare_forward(net, tr.params)
        plan, L = prep.plan, prep.plan.n_levels
        x = torch.rand(B_MAIN, 2, generator=gen).to(dev)
        t = torch.rand(B_MAIN, 3, generator=gen).to(dev)
        gy = torch.randn(B_MAIN, enc_w, generator=gen).to(torch.bfloat16).to(dev)
        library = None
        if plan.stochastic:
            rows = grid_kernel.stochastic_rows(plan, x).reshape(-1)
            grow = gy[:, : L * plan.f].float().reshape(-1, plan.f)
            out = torch.zeros((plan.total_rows, plan.f), device=dev)
            library = {"K4": lambda: out.zero_().index_add_(0, rows, grow)}
        kernels = ("K1", "K3", "K4", "K6") if plan.rng else ("K4", "K6")  # K1, K3: Rng only
        timed = time_grid_kernels(net, tr, x, t, gy, kernels, library, plain_iters=1)
        grid_bnd = grid_bounds(net, prep, x, t, gy)
        hash_ops = hash_int_ops(plan, x) if plan.rng else 0.0
        for k in kernels:
            ms[f"{k} {option}"], bounds[f"{k} {option}"] = timed[k], grid_bnd[k]
            extra[f"{k} {option}"] = {"hash_mul64": hash_ops}
    emit({"phase": "times options", "card": smi, "B": B_MAIN,
          "ms": {k: {"kernel": v[0], "plain": v[1], "library": v[2], "bound": bounds[k][0],
                     **extra.get(k, {})} for k, v in ms.items()}})
    return errs, ms, bounds


def options_slice(cfg, dev, smi, batch):
    """Phase 13: each option of config_hash trains N_TRAIN steps through K6
    (counters), its loss falling and holdout PSNR under OPTION_LIMITS; one
    composed step (K1 K2 K5 K4) against K6's gradient; trainer.inference
    (K3) against model.apply; ms per step of both routes. Returns ({option:
    {route: launches}}, {option: {route: ms per step}})."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.image import psnr

    launches, step_ms = {}, {}
    for option in OPTIONS:
        ocfg = json.loads(json.dumps(cfg))
        ocfg["encoding"].update(OPTIONS[option])
        model = tt.create_from_config(2, 3, ocfg, seed=SEED + 24, device=dev)
        tr, net = model.trainer, model.network
        check(tr.use_fused(), f"config_hash {option} must take the fused train kernel")
        batches = [batch() for _ in range(N_TRAIN)]
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        losses = [tr.training_step(x, t) for x, t in batches]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        fused = counters()
        losses = torch.stack(losses).cpu()
        check(bool(torch.isfinite(losses).all()), f"{option} training loss not finite")
        fall = float(losses[0] / losses[-10:].mean())
        x_hold, t_hold = batch(1 << 16)
        reset_counters()
        holdout_psnr = psnr(tr.inference(x_hold), t_hold)
        infer = counters()
        fall_min, psnr_min = OPTION_LIMITS[option]
        emit({"phase": "options slice", "option": option, "steps": N_TRAIN, "B": B_MAIN,
              "launches": fused, "loss_first": float(losses[0]),
              "loss_last10_mean": float(losses[-10:].mean()),
              "loss_at": {str(i): float(losses[i])
                          for i in sorted({0, N_TRAIN // 10, N_TRAIN // 4, N_TRAIN // 2,
                                           N_TRAIN - 1})},
              "loss_fall": fall, "loss_fall_min": fall_min, "holdout_psnr_db": holdout_psnr,
              "psnr_min_db": psnr_min, "loop_seconds": loop_s})
        check(fused["K6"] == N_TRAIN and all(v == 0 for k, v in fused.items() if k != "K6"),
              f"the {option} training steps did not run K6 alone: {fused}")
        check(fall >= fall_min, f"{option} loss fell only {fall}x")
        check(holdout_psnr >= psnr_min, f"{option} holdout PSNR {holdout_psnr} dB")

        # the composed route on a second model: its gradient against K6's
        other = tt.create_from_config(2, 3, ocfg, seed=SEED + 25, device=dev)
        other.trainer.set_params(tr.params)
        other.trainer.use_fused_train_kernel = False
        x, t = batch()
        fl, fg = tr.loss_and_grad_fn(tr.params, x, t)
        cl, cg = other.trainer.loss_and_grad_fn(other.trainer.params, x, t)
        compare_norm(f"{option} composed route (K1 K2 K5 K4) vs K6 gradient", cg, fg, ROUTE_REL,
                     net.network.n_params)
        check(abs(float(cl) - float(fl)) <= TRAIN_LOSS_RTOL * abs(float(fl)),
              f"{option} composed loss")
        reset_counters()
        other.trainer.training_step(x, t)
        torch.cuda.synchronize()
        composed = counters()
        emit({"phase": "options composed step", "option": option, "launches": composed})
        check(all(composed[k] == 1 for k in ("K1", "K2", "K4", "K5"))
              and composed["K3"] == composed["K6"] == 0,
              f"the {option} composed step did not run K1, K2, K5 and K4 once each")

        # trainer.inference (K3) against model.apply (K1 + K2)
        reset_counters()
        requests = (B_MAIN, 100_003, 1)
        for B in requests:
            xq = torch.rand(B, 2, device=dev)
            y = tr.inference(xq)
            check(y.shape == (B, 3) and bool(torch.isfinite(y).all()), "inference shape/finite")
            compare(f"{option} trainer.inference vs model.apply", y,
                    net.apply(tr.params, xq)[:, :3].float(), rel_max=MLP_REL)
        infer_k3 = counters()["K3"]
        check(infer_k3 == len(requests), f"{option} trainer.inference did not run K3")
        launches[option] = {"fused": fused, "composed": composed,
                            "inference": infer["K3"] + infer_k3}
        step_ms[option] = time_steps(tr, x, t)
    emit({"phase": "times options slice", "card": smi, "B": B_MAIN, "training_step_ms": step_ms,
          "training_steps_per_s": {o: {r: 1e3 / v for r, v in d.items()}
                                   for o, d in step_ms.items()}})
    return launches, step_ms


# ---------------------------------------------------------------------------
# Phases 14 and 15: the reference-default T=2^19 hash grid (B12's functions)
# ---------------------------------------------------------------------------


def wrap_control_plan(enc):
    """The encoding's plan with its wrap-degenerate levels (unhashed only
    because the uint32 stride res^D wrapped) hashed, as an index computed
    with an unwrapped stride would hash them: the control of phases 14 and
    15. Twins take it; no kernel does."""
    plan = enc.plan
    wrapped = [not plan.use_hash[l] and int(enc._resolutions[l]) ** plan.d > plan.sizes[l]
               for l in range(plan.n_levels)]
    check(any(wrapped), "the control needs a wrap-degenerate level")
    ctl = copy.copy(plan)
    ctl.use_hash = tuple(u or w for u, w in zip(plan.use_hash, wrapped))
    ctl.label = f"levels {[l for l, w in enumerate(wrapped) if w]} hashed"
    return ctl


def reference_model(cfg, seed, dev, gen, d=2, n_out=3, **enc):
    """A model of `cfg` with the encoding keys `enc` set and its table
    redrawn from U(-1, 1)."""
    import tcnn_tpu_torch as tt

    rcfg = json.loads(json.dumps(cfg))
    rcfg["encoding"].update(enc)
    m = tt.create_from_config(d, n_out, rcfg, seed=seed, device=dev)
    m.trainer.set_params(random_params(m.trainer, gen))
    return m


def check_reference_kernels(cfg, gen, dev):
    """Phase 14's kernel checks: K1, K3, K4 (plain and stochastic) and K6
    against their twins at the reference default, B = 2^18, 2^18 - 37 and
    1, each beside a control its bound must reject; K1 and K6 once with the
    Rng hash. Returns {kernel: max abs err}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel

    errs = dict.fromkeys(("K1", "K3", "K4", "K6"), 0.0)
    m = reference_model(cfg, SEED + 30, dev, gen, **REFERENCE_ENCODING)
    net, tr = m.network, m.trainer
    prep = train_kernel.prepare_forward(net, tr.params)
    plan, L = prep.plan, prep.plan.n_levels
    check(plan.total_rows == 5_592_320 and tr.use_fused(), "the reference default's plan and route")
    enc_w = net.encoding.padded_output_width
    ctl = wrap_control_plan(net.encoding)
    st = reference_model(cfg, SEED + 31, dev, gen, stochastic_interpolation=True,
                         **REFERENCE_ENCODING).network.encoding.plan
    st_ctl = control_plan(st, "stochastic")
    for B in BATCHES:
        x = torch.rand(B, 2, generator=gen).to(dev)
        want = grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, L)
        errs["K1"] = max(errs["K1"], compare(
            f"K1 grid_fwd T=2^19 B={B}", grid_kernel.grid_encode(plan, prep.table, x, enc_w, L),
            want, rel_ulp=K1_REL))
        want3 = train_kernel._fused_forward_plain(prep, x)
        errs["K3"] = max(errs["K3"], compare(
            f"K3 fused_infer T=2^19 B={B}", train_kernel.fused_forward_prepared(prep, x), want3,
            rel_max=MLP_REL))
        gy = torch.randn(B, enc_w, generator=gen).to(torch.bfloat16).to(dev)
        want4 = grid_kernel._grid_backward_plain(plan, x, gy, L)
        errs["K4"] = max(errs["K4"], compare_norm(
            f"K4 grid_bwd T=2^19 B={B}", grid_kernel.grid_backward(plan, x, gy, L), want4,
            GRID_BWD_REL))
        xs = with_ties(st, x) if B == B_MAIN else x
        want4s = grid_kernel._grid_backward_plain(st, xs, gy, L)
        errs["K4"] = max(errs["K4"], compare_norm(
            f"K4 grid_bwd stochastic T=2^19 B={B}", grid_kernel.grid_backward(st, xs, gy, L),
            want4s, GRID_BWD_REL))
        t = torch.rand(B, 3, generator=gen).to(dev)
        errs["K6"] = max(errs["K6"], check_train_step(
            f"T=2^19 B={B}", net, tr.loss_fn, tr.params, x, t, tr.loss_scale, K6_REL,
            control_too=B == B_MAIN, ctl_plan=ctl if B == B_MAIN else None))
        if B == B_MAIN:
            label = control_label(ctl)
            control_ulp(f"K1 T=2^19, {label}",
                        grid_kernel._grid_encode_plain(ctl, prep.table, x, enc_w, L), want, K1_REL)
            control_max(f"K3 T=2^19, {label}", train_kernel._fused_forward_plain(
                dataclasses.replace(prep, plan=ctl), x), want3, MLP_REL)
            control(f"K4 T=2^19, {label}", grid_kernel._grid_backward_plain(ctl, x, gy, L), want4,
                    GRID_BWD_REL)
            control("K4 T=2^19, contributions unrounded", scatter_f32(plan, x, gy), want4,
                    GRID_BWD_REL)
            control(f"K4 stochastic T=2^19, {control_label(st_ctl)}",
                    grid_kernel._grid_backward_plain(st_ctl, xs, gy, L), want4s, GRID_BWD_REL)
    # K1 and K6 with the Rng hash (levels 6-11 hash; 12-15 wrap and do not)
    rm = reference_model(cfg, SEED + 32, dev, gen, hash="Rng", **REFERENCE_ENCODING)
    rprep = train_kernel.prepare_forward(rm.network, rm.trainer.params)
    rctl = control_plan(rprep.plan, "rng")
    x = torch.rand(B_MAIN - 37, 2, generator=gen).to(dev)
    want = grid_kernel._grid_encode_plain(rprep.plan, rprep.table, x, enc_w, L)
    errs["K1"] = max(errs["K1"], compare(
        "K1 grid_fwd Rng T=2^19", grid_kernel.grid_encode(rprep.plan, rprep.table, x, enc_w, L),
        want, rel_ulp=K1_REL))
    control_ulp(f"K1 Rng T=2^19, {control_label(rctl)}",
                grid_kernel._grid_encode_plain(rctl, rprep.table, x, enc_w, L), want, K1_REL)
    t = torch.rand(x.shape[0], 3, generator=gen).to(dev)
    errs["K6"] = max(errs["K6"], check_train_step(
        "Rng T=2^19", rm.network, rm.trainer.loss_fn, rm.trainer.params, x, t,
        rm.trainer.loss_scale, K6_OPT_REL, ctl_plan=rctl))
    return errs


def reference_slice(cfg, gen, dev):
    """Phase 14's main path: the reference default trains N_SAMPLE_STEPS
    steps at B = 2^18 through the image sample's `train` (K6 alone, by the
    counters) and renders through its `render` (one K3 launch per 2^20
    pixels, held against K3's twin); its loss fall and render PSNR under
    SAMPLE_LIMITS; one composed step (K1 K2 K5 K4) against K6's gradient;
    a save/load of the trained state and one more step on each copy; then
    the times of K1, K3, K4 and K6 and their twins, of both routes'
    `training_step` and of `trainer.inference`. Returns (launches {K1, K3,
    K4, K6}, the render's max abs error, {kernel: (ms, twin ms, None)},
    {kernel: (bound ms, bound_by)}, times)."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import _build, train_kernel
    from tcnn_tpu_torch.samples import mlp_learning_an_image as image_sample
    from tcnn_tpu_torch.utils.image import pixel_center_coords, psnr, sample_image, synthetic_image

    rcfg = json.loads(json.dumps(cfg))
    rcfg["encoding"].update(REFERENCE_ENCODING)
    image = synthetic_image(1024, 1024, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    model, losses = image_sample.train(rcfg, image, N_SAMPLE_STEPS, device=dev, log=None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    trained = counters()
    tr, net = model.trainer, model.network
    check(bool(torch.isfinite(losses).all()), "reference default loss not finite")
    fall = float(losses[0] / losses[-10:].mean())
    reset_counters()
    pred = image_sample.render(tr, 1024, 1024)
    torch.cuda.synchronize()
    rendered = counters()
    render_psnr = psnr(pred, image)
    # the render's K3 launch against its twin on the same pixel centers, the
    # trained table and the chunk's shape (check_reference_kernels shows
    # that MLP_REL rejects the twin with the wrapped levels hashed)
    coords = pixel_center_coords(1024, 1024, device=dev)
    want = train_kernel._fused_forward_plain(train_kernel.prepare_forward(net, tr.inference_params),
                                             coords)[:, :3].float()
    render_err = compare("K3 fused_infer T=2^19, the sample's render vs its twin",
                         pred.reshape(-1, 3), want, rel_max=MLP_REL)
    del coords, want
    fall_min, psnr_min = SAMPLE_LIMITS
    chunks = -(-1024 * 1024 // image_sample.RENDER_CHUNK)
    emit({"phase": "reference slice", "steps": N_SAMPLE_STEPS, "B": image_sample.BATCH,
          "table_rows": net.encoding.plan.total_rows, "params": net.n_params,
          "launches": trained, "render_launches": rendered, "loss_first": float(losses[0]),
          "loss_last10_mean": float(losses[-10:].mean()),
          "loss_at": {str(i): float(losses[i]) for i in sorted(
              {0, N_SAMPLE_STEPS // 10, N_SAMPLE_STEPS // 4, N_SAMPLE_STEPS // 2,
               N_SAMPLE_STEPS - 1})},
          "loss_fall": fall, "loss_fall_min": fall_min, "render_psnr_db": render_psnr,
          "psnr_min_db": psnr_min, "loop_seconds": loop_s,
          "sample_steps_per_s": N_SAMPLE_STEPS / loop_s})
    check(trained["K6"] == N_SAMPLE_STEPS and all(v == 0 for k, v in trained.items() if k != "K6"),
          f"the sample's steps did not run K6 alone: {trained}")
    check(rendered["K3"] == chunks and all(v == 0 for k, v in rendered.items() if k != "K3"),
          f"the sample's render did not run K3 once per chunk: {rendered}")
    check(fall >= fall_min, f"reference default loss fell only {fall}x")
    check(render_psnr >= psnr_min, f"reference default render PSNR {render_psnr} dB")

    dgen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def batch(B=B_MAIN):
        x = torch.rand(B, 2, generator=dgen, device=dev)
        return x, sample_image(image, x)

    # the composed route on a second model, same params, same batch
    other = tt.create_from_config(2, 3, rcfg, seed=SEED + 33, device=dev)
    other.trainer.set_params(tr.params)
    other.trainer.use_fused_train_kernel = False
    x, t = batch()
    fl, fg = tr.loss_and_grad_fn(tr.params, x, t)
    cl, cg = other.trainer.loss_and_grad_fn(other.trainer.params, x, t)
    compare_norm("T=2^19 composed route (K1 K2 K5 K4) vs K6 gradient", cg, fg, ROUTE_REL,
                 net.network.n_params)
    check(abs(float(cl) - float(fl)) <= TRAIN_LOSS_RTOL * abs(float(fl)), "T=2^19 composed loss")
    reset_counters()
    other.trainer.training_step(x, t)
    torch.cuda.synchronize()
    composed = counters()
    emit({"phase": "reference composed step", "launches": composed})
    check(all(composed[k] == 1 for k in ("K1", "K2", "K4", "K5"))
          and composed["K3"] == composed["K6"] == 0,
          "the T=2^19 composed step did not run K1, K2, K5 and K4 once each")

    # save/load with the optimizer state, then one more step on each copy
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "reference.json")
        t0 = time.perf_counter()
        tr.save(path)
        copied = tt.create_from_config(2, 3, rcfg, seed=SEED + 34, device=dev)
        copied.trainer.load(path)
        snap = {"bytes": os.path.getsize(path), "seconds": time.perf_counter() - t0}
    for k, v in tr.state["opt"].items():
        check(torch.equal(copied.trainer.state["opt"][k], v), f"T=2^19 optimizer state {k}")
    before = tr.params.clone()
    x, t = batch()
    tr.training_step(x, t)
    copied.trainer.training_step(x, t)
    compare_norm("T=2^19 resumed step vs original step", copied.trainer.params - before,
                 tr.params - before, RESUME_REL)
    emit({"phase": "reference snapshot", **snap})

    # times at B = 2^18
    gy = torch.randn(B_MAIN, net.encoding.padded_output_width,
                     generator=gen).to(torch.bfloat16).to(dev)
    plan = net.encoding.plan
    ms = time_grid_kernels(net, tr, x, t, gy,
                           library={"K4": k4_yardstick(plan, x, gy, plan.n_levels)})
    bounds = grid_bounds(net, train_kernel.prepare_forward(net, tr.params), x, t, gy)
    times = {"trainer_inference_ms": cuda_ms(lambda: tr.inference(x), 50)}
    step_ms = time_steps(tr, x, t)
    times.update(training_step_ms=step_ms,
                 training_steps_per_s={k: 1e3 / v for k, v in step_ms.items()})
    launches = {"K1": composed["K1"], "K3": rendered["K3"], "K4": composed["K4"],
                "K6": trained["K6"]}
    return launches, render_err, ms, bounds, times


def reference_sdf_slice(gen, dev, smi):
    """Phase 15: the SDF sample's HashGrid at T=2^19. K7, K8 and K9 against
    their twins on the eikonal step's inputs (B = 2^16, 2^16 - 37, 1 and
    the eikonal term's N_EIKONAL), with
    phase 7's controls at 2^16 (no level of this 3-D grid wraps its
    stride, so there is no wrap control); SDF_STEPS steps through the
    sample's `train_step` (counters), the loss fall and slice error under
    SDF19_LIMITS; the fused eikonal gradient against the composed one; the
    times of K7-K9 at 2^16 and 2^18 and of one step. Returns (errs,
    launches {K7, K8, K9}, {kernel: (ms, twin ms, None)} at 2^18, {kernel:
    (bound ms, bound_by)})."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    scfg = sdf.config("HashGrid")
    scfg["encoding"]["log2_hashmap_size"] = 19
    sm = reference_model(scfg, SEED + 35, dev, gen, d=3, n_out=1)
    snet, sparams = sm.network, sm.trainer.params
    check(snet.encoding.plan.total_rows == 3_471_664 and train_kernel.supported_ig(snet),
          "the T=2^19 SDF config's plan and fused ig route")
    errs = {}
    for B in SDF_BATCHES + (sdf.N_EIKONAL,):  # the eikonal term's points
        x = torch.rand(B, 3, generator=gen).to(dev)
        for k, v in check_ig_kernels(f"T=2^19 B={B}", snet, sparams, x, gen,
                                     control_too=B == B_SDF).items():
            errs[k] = max(errs.get(k, 0.0), v)

    model = tt.create_from_config(3, 1, scfg, seed=SEED + 36, device=dev)
    str_, mnet = model.trainer, model.network
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [torch.rand(B_SDF, 3, generator=sgen, device=dev) for _ in range(SDF_STEPS)]
    before = sdf.slice_error(mnet, str_.params)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    losses = [sdf.train_step(str_, xs) for xs in batches]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launched = counters()
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "T=2^19 SDF loss not finite")
    fall = float(losses[0] / losses[-10:].mean())
    after = sdf.slice_error(mnet, str_.params)
    per_step = {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 0, "K7": 1, "K8": 1, "K9": 1}
    fall_min, slice_max = SDF19_LIMITS
    emit({"phase": "reference sdf slice", "steps": SDF_STEPS, "B": B_SDF,
          "table_rows": mnet.encoding.plan.total_rows, "launches": launched,
          "launches_per_step_expected": per_step, "loss_first": float(losses[0]),
          "loss_last10_mean": float(losses[-10:].mean()),
          "loss_at": {str(i): float(losses[i]) for i in sorted(
              {0, SDF_STEPS // 10, SDF_STEPS // 4, SDF_STEPS // 2, SDF_STEPS - 1})},
          "loss_fall": fall, "loss_fall_min": fall_min, "slice_error_before": before,
          "slice_error": after, "slice_error_max": slice_max, "loop_seconds": loop_s})
    check(all(launched[k] == n * SDF_STEPS for k, n in per_step.items()),
          f"the T=2^19 SDF steps did not run K3, K9, K1, K7, K8 and K1, K2, K5, K4 on every step: "
          f"{launched}")
    check(fall >= fall_min, f"T=2^19 SDF loss fell only {fall}x")
    check(after <= slice_max, f"T=2^19 SDF slice error {after}")
    xe = batches[-1][: sdf.N_EIKONAL]
    eik = []
    for fused in (True, False):
        p = str_.params.detach().requires_grad_(True)
        g = sdf.eikonal_grad(mnet, p, xe, fused_ig=fused)
        e = torch.mean((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2)
        eik.append(torch.autograd.grad(e, p)[0])
    compare_norm("T=2^19 SDF eikonal gradient, fused route (K3 K9) vs composed (K1 K7)", eik[0],
                 eik[1], SDF_ROUTE_REL)

    ms, bounds = {}, {}
    for B in (B_SDF, B_MAIN):
        ms[B], bounds[B] = time_ig_kernels(snet, sparams, torch.rand(B, 3, generator=gen).to(dev),
                                           plain_iters=1)
    xs = torch.rand(B_SDF, 3, generator=gen).to(dev)
    step_ms = cuda_ms(lambda: sdf.train_step(str_, xs), 20)
    emit({"phase": "times reference sdf", "card": smi,
          "ms": {f"{k} B={b}": {"kernel": v[0], "plain": v[1], "bound": bounds[b][k][0]}
                 for b in ms for k, v in ms[b].items()},
          "sdf_train_step_ms": step_ms, "sdf_steps_per_s": 1e3 / step_ms,
          "sdf_sample_steps_per_s": SDF_STEPS / loop_s})
    launches = {k: launched[k] for k in ("K7", "K8", "K9")}
    return errs, launches, ms[B_MAIN], bounds[B_MAIN]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda import _build, grid_kernel, mlp_kernel, train_kernel
    from tcnn_tpu_torch.utils.image import psnr, sample_image, synthetic_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": card, "count": torch.cuda.device_count(), "nvidia_smi": smi})

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": lib._name,
          "flags": " ".join(_build.NVCC_FLAGS)})

    # 3. kernels against their plain twins at config_hash shapes
    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    gen = torch.Generator().manual_seed(SEED)
    model = tt.create_from_config(2, 3, cfg, seed=SEED, device=dev)
    tr, net = model.trainer, model.network
    tr.set_params(random_params(tr, gen))
    prep = train_kernel.prepare_forward(net, tr.params)
    plan, dims = prep.plan, prep.dims
    L = plan.n_levels
    enc_w = net.encoding.padded_output_width
    errs = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0.0)
    dims128 = mlp_kernel.MlpDims(enc_w, 128, 5, 16, Activation.ReLU, Activation.NONE)
    w128 = (torch.rand(dims128.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16).to(dev)
    for B in BATCHES:
        x = torch.rand(B, 2, generator=gen).to(dev)
        enc_plain = grid_kernel._grid_encode_plain(plan, prep.table, x, enc_w, L)
        errs["K1"] = max(errs["K1"], compare(
            "K1 grid_fwd", grid_kernel.grid_encode(plan, prep.table, x, enc_w, L),
            enc_plain, rel_ulp=K1_REL))
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd", mlp_kernel.mlp_forward(dims, prep.weights, enc_plain),
            mlp_kernel._mlp_forward_plain(dims, prep.weights, enc_plain), rel_max=MLP_REL))
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd 128x5", mlp_kernel.mlp_forward(dims128, w128, enc_plain),
            mlp_kernel._mlp_forward_plain(dims128, w128, enc_plain), rel_max=MLP_REL))
        errs["K3"] = max(errs["K3"], compare(
            "K3 fused_infer", train_kernel.fused_forward_prepared(prep, x),
            train_kernel._fused_forward_plain(prep, x), rel_max=MLP_REL))

        gy = torch.randn(B, enc_w, generator=gen).to(torch.bfloat16).to(dev)
        errs["K4"] = max(errs["K4"], compare_norm(
            "K4 grid_bwd", grid_kernel.grid_backward(plan, x, gy, L),
            grid_kernel._grid_backward_plain(plan, x, gy, L), GRID_BWD_REL))

        t = torch.rand(B, 3, generator=gen).to(dev)
        # K5 takes the cotangent the composed route hands it: the loss gradient
        for shape, d, w in (("config_hash", dims, prep.weights), ("128x5", dims128, w128)):
            gout = loss_cotangent(d, w, enc_plain, tr.loss_fn, t, tr.loss_scale)
            errs["K5"] = max(errs["K5"], check_mlp_bwd(
                f"K5 mlp_bwd {shape} B={B}", d, w, enc_plain, gout, K5_REL[shape],
                control_too=True))

        variants = [("", {}, t)]
        if B == B_MAIN:
            # the external dL/doutput is the loss gradient's: a random one
            # would cancel in the sums and read another error
            dl = loss_cotangent(dims, prep.weights, enc_plain, tr.loss_fn, t,
                                tr.loss_scale).float()
            variants += [
                ("pdf", {"pdf": (torch.rand(B, 3, generator=gen) + 0.5).to(dev)}, t),
                ("noise", {"noise": (0.1 * torch.randn(B, dims.out_w, generator=gen)).to(dev)}, t),
                ("ext_dl", {"ext_dl": True}, dl),
            ]
        for label, kw, tgt in variants:
            errs["K6"] = max(errs["K6"], check_train_step(
                f"{label} B={B}", net, tr.loss_fn, tr.params, x, tgt, tr.loss_scale, K6_REL,
                control_too=True, bits=not label, **kw))

    # 3b. coverage of K4, K5 and K6 beyond config_hash's main path
    for label, enc_over, net_over, max_level, losses in COVER_CASES:
        vcfg = json.loads(json.dumps(cfg))
        vcfg["encoding"].update(enc_over)
        vcfg["network"].update(net_over)
        vm = tt.create_from_config(2, 3, vcfg, seed=SEED, device=dev)
        vnet, vtr = vm.network, vm.trainer
        vnet.encoding.max_level = max_level
        vtr.set_params(random_params(vtr, gen))
        vprep = train_kernel.prepare_forward(vnet, vtr.params)
        n_active = vnet.encoding.active_levels()
        x = torch.rand(B_COVER, 2, generator=gen).to(dev)
        enc_plain = grid_kernel._grid_encode_plain(vprep.plan, vprep.table, x, enc_w, n_active)
        pred = mlp_kernel._mlp_forward_plain(vprep.dims, vprep.weights, enc_plain)[:, :3].float()
        # targets at least 0.05 max(1, |p|) from the prediction p, so that no
        # sign(p - t) turns on a flipped bf16 rounding of p
        away = torch.rand(B_COVER, 3, generator=gen).to(dev) * 0.5 + 0.05
        away = away * pred.abs().clamp_min(1)
        sign = torch.randint(0, 2, (B_COVER, 3), generator=gen).to(dev) * 2 - 1
        tgt = pred + sign * away
        for otype in losses:
            errs["K6"] = max(errs["K6"], check_train_step(
                f"{label} {otype} B={B_COVER}", vnet, tt.create_loss({"otype": otype}),
                vtr.params, x, tgt, vtr.loss_scale, {"weights": COVER_REL, "table": COVER_REL}))
        if net_over:
            gout = loss_cotangent(vprep.dims, vprep.weights, enc_plain,
                                  tt.create_loss({"otype": losses[0]}), tgt, vtr.loss_scale)
            errs["K5"] = max(errs["K5"], check_mlp_bwd(
                f"K5 mlp_bwd {label} B={B_COVER}", vprep.dims, vprep.weights, enc_plain, gout,
                {"gW": COVER_REL, "gx": COVER_REL}))
        else:
            gy = torch.randn(B_COVER, enc_w, generator=gen).to(torch.bfloat16).to(dev)
            errs["K4"] = max(errs["K4"], compare_norm(
                f"K4 grid_bwd {label}", grid_kernel.grid_backward(vprep.plan, x, gy, n_active),
                grid_kernel._grid_backward_plain(vprep.plan, x, gy, n_active), GRID_BWD_REL))

    # 3c. F = 8 through K4 and K6 (two float4 atomics a corner; the private
    #     levels' budget at 32 bytes a row)
    for k, v in check_f8(cfg, gen, dev).items():
        errs[k] = max(errs[k], v)

    # 4. the inference slice, through the entry points a user calls
    reset_counters()
    model = tt.create_from_config(2, 3, cfg, seed=SEED + 1, device="cuda")
    tr, net = model.trainer, model.network
    tr.set_params(random_params(tr, gen))
    requests = (B_MAIN, B_MAIN, B_MAIN, 100_003, 1)
    xs = [torch.rand(B, 2, generator=gen).to(dev) for B in requests]
    outs = []
    for x in xs:
        y = tr.inference(x)
        torch.cuda.synchronize()
        check(y.shape == (x.shape[0], 3) and y.dtype == torch.float32, "inference shape/dtype")
        check(bool(torch.isfinite(y).all()), "inference output not finite")
        outs.append(y)
    k3_launches = train_kernel.LAUNCHES
    composed = [net.apply(tr.params, x)[:, :3].float() for x in xs]
    torch.cuda.synchronize()
    for y, ref in zip(outs, composed):
        compare("slice inference vs model.apply", y, ref, rel_max=MLP_REL)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "snapshot.json")
        tr.save(path)
        fresh = tt.create_from_config(2, 3, cfg, seed=SEED + 2, device="cuda")
        fresh.trainer.load(path)
        for x, y in zip(xs, outs):
            check(torch.equal(fresh.trainer.inference(x), y), "save/load changed predictions")
    launches = counters()
    emit({"phase": "inference slice", "requests": list(requests), "launches": launches,
          "k3_launches_by_inference": k3_launches})
    check(k3_launches == len(requests), "trainer.inference did not run K3 once per request")
    check(launches["K1"] > 0 and launches["K2"] > 0, "model.apply did not run K1 and K2")

    # the plain twins on the CPU, on a small input, as an independent reference
    cpu = tt.create_from_config(2, 3, cfg, seed=SEED, device="cpu")
    cpu.trainer.set_params(tr.params.cpu())
    x_small = xs[3][:4096]
    compare("slice inference vs CPU plain twins", tr.inference(x_small).cpu(),
            cpu.trainer.inference(x_small.cpu()), rel_max=MLP_REL)

    # 5. the training slice: config_hash at full width, B = 2^18, targets
    #    sampled on the card from a synthetic image
    image = synthetic_image(1024, 1024, device=dev)
    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def batch(B=B_MAIN):
        x = torch.rand(B, 2, generator=dgen, device=dev)
        return x, sample_image(image, x)

    model = tt.create_from_config(2, 3, cfg, seed=SEED + 3, device="cuda")
    tr, net = model.trainer, model.network
    check(tr.use_fused(), "config_hash must take the fused train kernel")
    batches = [batch() for _ in range(N_TRAIN)]
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    losses = [tr.training_step(x, t) for x, t in batches]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    train_launches = counters()
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "training loss not finite")
    fall = float(losses[0] / losses[-10:].mean())
    x_hold, t_hold = batch(1 << 16)
    holdout_psnr = psnr(tr.inference(x_hold), t_hold)
    emit({"phase": "training slice", "steps": N_TRAIN, "B": B_MAIN, "launches": train_launches,
          "loss_first": float(losses[0]), "loss_last10_mean": float(losses[-10:].mean()),
          "loss_at": {str(i): float(losses[i])
                      for i in sorted({0, N_TRAIN // 10, N_TRAIN // 4, N_TRAIN // 2, N_TRAIN - 1})},
          "loss_fall": fall, "loss_fall_min": LOSS_FALL, "holdout_psnr_db": holdout_psnr,
          "psnr_min_db": PSNR_MIN, "loop_seconds": loop_s})
    check(train_launches["K6"] == N_TRAIN, "training_step did not run K6 once per step")
    check(all(train_launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5")),
          "the fused training steps launched another kernel")
    check(fall >= LOSS_FALL, f"loss fell only {fall}x")
    check(holdout_psnr >= PSNR_MIN, f"holdout PSNR {holdout_psnr} dB")

    # the composed route on a second model, same params, same batch
    other = tt.create_from_config(2, 3, cfg, seed=SEED + 4, device="cuda")
    other.trainer.set_params(tr.params)
    other.trainer.use_fused_train_kernel = False
    x, t = batch()
    fl, fg = tr.loss_and_grad_fn(tr.params, x, t)
    cl, cg = other.trainer.loss_and_grad_fn(other.trainer.params, x, t)
    compare_norm("composed route (K1 K2 K5 K4) vs K6 gradient", cg, fg, ROUTE_REL,
                 net.network.n_params)
    check(abs(float(cl) - float(fl)) <= TRAIN_LOSS_RTOL * abs(float(fl)), "composed loss")
    reset_counters()
    other.trainer.training_step(x, t)
    torch.cuda.synchronize()
    composed_launches = counters()
    emit({"phase": "composed step", "launches": composed_launches})
    check(all(composed_launches[k] == 1 for k in ("K1", "K2", "K4", "K5"))
          and composed_launches["K3"] == composed_launches["K6"] == 0,
          "the composed step did not run K1, K2, K5 and K4 once each")

    # save/load with the optimizer state, then one more step on each copy
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "trained.json")
        tr.save(path)
        copy = tt.create_from_config(2, 3, cfg, seed=SEED + 5, device="cuda")
        copy.trainer.load(path)
    for k, v in tr.state["opt"].items():
        check(torch.equal(copy.trainer.state["opt"][k], v), f"optimizer state {k} not restored")
    before = tr.params.clone()
    x, t = batch()
    tr.training_step(x, t)
    copy.trainer.training_step(x, t)
    compare_norm("resumed step vs original step", copy.trainer.params - before,
                 tr.params - before, RESUME_REL)

    # 6. times at B = 2^18
    model = tt.create_from_config(2, 3, cfg, seed=SEED + 6, device="cuda")
    tr, net = model.trainer, model.network
    tr.set_params(random_params(tr, gen))
    x, t = batch()
    enc = net.encoding.apply(tr.params[net.network.n_params:], x)
    prep = train_kernel.prepare_forward(net, tr.params)
    gy_enc = torch.randn(B_MAIN, enc_w, generator=gen).to(torch.bfloat16).to(dev)
    gy_out = torch.randn(B_MAIN, dims.out_w, generator=gen).to(torch.bfloat16).to(dev)
    ms = time_grid_kernels(net, tr, x, t, gy_enc, plain_iters=5,
                           library={"K4": k4_yardstick(plan, x, gy_enc, L)})
    ms["K2"] = time_pair(lambda: mlp_kernel.mlp_forward(dims, prep.weights, enc),
                         lambda: mlp_kernel._mlp_forward_plain(dims, prep.weights, enc),
                         iters=50, plain_iters=5)
    ms["K5"] = time_pair(lambda: mlp_kernel.mlp_backward(dims, prep.weights, enc, gy_out),
                         lambda: mlp_kernel._mlp_backward_plain(dims, prep.weights, enc, gy_out),
                         iters=50, plain_iters=5)
    infer_ms = cuda_ms(lambda: tr.inference(x), 50)
    step_ms = time_steps(tr, x, t)
    emit({"phase": "times", "B": B_MAIN, "card": smi,
          "ms": {k: {"kernel": v[0], "plain": v[1]} for k, v in ms.items()},
          "trainer_inference_ms": infer_ms,
          "trainer_inference_Msamples_per_s": B_MAIN / infer_ms / 1e3,
          "training_step_ms": step_ms,
          "training_steps_per_s": {k: 1e3 / v for k, v in step_ms.items()},
          "training_Msamples_per_s": {k: B_MAIN / v / 1e3 for k, v in step_ms.items()}})
    # the least time the card could take for each kernel's work at the
    # timed shapes (B = 2^18, this phase's inputs): bytes (each input read
    # once, each output written once) over 3.35 TB/s, against operations
    # over the peak of their type (989 TFLOP/s bf16 on the tensor cores,
    # 67 TFLOP/s f32)
    bounds = {
        **grid_bounds(net, prep, x, t, gy_enc),
        "K2": kernel_bound(bytes_of(enc, prep.weights) + B_MAIN * dims.out_w * 2,
                           bf16=2 * B_MAIN * dims.n_weights),
        "K5": k5_bound(dims, prep.weights, enc, gy_out),
    }

    # 7. the input-gradient kernels against their twins at the SDF config
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    for interp in ("Linear", "Smoothstep"):
        scfg = json.loads(json.dumps(sdf.CONFIG))
        scfg["encoding"]["interpolation"] = interp
        sm = tt.create_from_config(3, 1, scfg, seed=SEED + 7, device=dev)
        sm.trainer.set_params(random_params(sm.trainer, gen))
        check(train_kernel.supported_ig(sm.network), "the SDF config must take the fused ig route")
        for B in SDF_BATCHES:
            x = torch.rand(B, 3, generator=gen).to(dev)
            for k, v in check_ig_kernels(f"{interp} B={B}", sm.network, sm.trainer.params, x,
                                         gen).items():
                errs[k] = max(errs.get(k, 0.0), v)
    # K9 (and K7, K8) at 8 features per level (MLP input 96), each beside
    # its control; its own generator leaves every later input as it was
    f8_gen = torch.Generator().manual_seed(SEED + 14)
    scfg = json.loads(json.dumps(sdf.CONFIG))
    scfg["encoding"]["n_features_per_level"] = 8
    sm = tt.create_from_config(3, 1, scfg, seed=SEED + 14, device=dev)
    sm.trainer.set_params(random_params(sm.trainer, f8_gen))
    check(sm.network.encoding.plan.f == 8 and train_kernel.supported_ig(sm.network),
          "the SDF config at F = 8 must take the fused ig route")
    x = torch.rand(B_SDF, 3, generator=f8_gen).to(dev)
    for k, v in check_ig_kernels(f"F=8 B={B_SDF}", sm.network, sm.trainer.params, x,
                                 f8_gen).items():
        errs[k] = max(errs.get(k, 0.0), v)
    cover = dict.fromkeys(("gtable", "gx", "ct_gy", "gtable2", "ct_x"), COVER_IG_REL)
    for d, interp in ((2, "Smoothstep"), (4, "Linear")):
        scfg = json.loads(json.dumps(sdf.CONFIG))
        scfg["encoding"]["interpolation"] = interp
        sm = tt.create_from_config(d, 1, scfg, seed=SEED + 8, device=dev)
        sm.trainer.set_params(random_params(sm.trainer, gen))
        x = torch.rand(B_SDF - 37, d, generator=gen).to(dev)
        for k, v in check_ig_kernels(f"D={d} {interp} B={B_SDF - 37}", sm.network,
                                     sm.trainer.params, x, gen, control_too=False,
                                     bounds=cover).items():
            errs[k] = max(errs.get(k, 0.0), v)

    # 8. the SDF slice: eikonal training through the sample's own step
    sm = tt.create_from_config(3, 1, sdf.CONFIG, seed=SEED + 9, device="cuda")
    str_, snet = sm.trainer, sm.network
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    sdf_batches = [torch.rand(B_SDF, 3, generator=sgen, device=dev) for _ in range(SDF_STEPS)]
    slice_before = sdf.slice_error(snet, str_.params)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    sdf_losses = [sdf.train_step(str_, xs) for xs in sdf_batches]
    torch.cuda.synchronize()
    sdf_loop_s = time.perf_counter() - t0
    sdf_launches = counters()
    sdf_losses = torch.stack(sdf_losses).cpu()
    check(bool(torch.isfinite(sdf_losses).all()), "SDF loss not finite")
    sdf_fall = float(sdf_losses[0] / sdf_losses[-10:].mean())
    slice_after = sdf.slice_error(snet, str_.params)
    per_step = {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 0, "K7": 1, "K8": 1, "K9": 1}
    emit({"phase": "sdf slice", "steps": SDF_STEPS, "B": B_SDF, "eikonal_points": sdf.N_EIKONAL,
          "launches": sdf_launches, "launches_per_step_expected": per_step,
          "loss_first": float(sdf_losses[0]), "loss_last10_mean": float(sdf_losses[-10:].mean()),
          "loss_at": {str(i): float(sdf_losses[i])
                      for i in sorted({0, SDF_STEPS // 10, SDF_STEPS // 4, SDF_STEPS // 2,
                                       SDF_STEPS - 1})},
          "loss_fall": sdf_fall, "loss_fall_min": SDF_LOSS_FALL,
          "slice_error_before": slice_before, "slice_error": slice_after,
          "slice_error_max": SDF_SLICE_MAX, "loop_seconds": sdf_loop_s})
    check(all(sdf_launches[k] == n * SDF_STEPS for k, n in per_step.items()),
          f"the SDF steps did not run K3, K9, K1, K7, K8 and K1, K2, K5, K4 on every step: "
          f"{sdf_launches}")
    check(sdf_fall >= SDF_LOSS_FALL, f"SDF loss fell only {sdf_fall}x")
    check(slice_after <= SDF_SLICE_MAX, f"SDF slice error {slice_after}")
    # the fused route's eikonal gradient against the composed route's
    xe = sdf_batches[-1][: sdf.N_EIKONAL]
    eik_grads = []
    for fused in (True, False):
        p = str_.params.detach().requires_grad_(True)
        g = sdf.eikonal_grad(snet, p, xe, fused_ig=fused)
        eik = torch.mean((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2)
        eik_grads.append(torch.autograd.grad(eik, p)[0])
    compare_norm("SDF eikonal gradient, fused route (K3 K9) vs composed (K1 K7)", eik_grads[0],
                 eik_grads[1], SDF_ROUTE_REL)

    # 9. times of K7, K8 and K9 at the SDF config, and of one SDF step
    sm = tt.create_from_config(3, 1, sdf.CONFIG, seed=SEED + 10, device="cuda")
    sm.trainer.set_params(random_params(sm.trainer, gen))
    snet, sparams = sm.network, sm.trainer.params
    ig_ms, ig_bounds = {}, {}
    # the timings of the paths' other shapes draw from their own generator,
    # so that every later check sees the inputs it saw before they existed
    shape_gen = torch.Generator().manual_seed(SEED + 13)
    for B in (sdf.N_EIKONAL, B_SDF, B_MAIN):
        x = torch.rand(B, 3, generator=shape_gen if B == sdf.N_EIKONAL else gen).to(dev)
        ig_ms[B], ig_bounds[B] = time_ig_kernels(snet, sparams, x)
    xs = torch.rand(B_SDF, 3, generator=gen).to(dev)
    sdf_step_ms = cuda_ms(lambda: sdf.train_step(sm.trainer, xs), 20)
    emit({"phase": "times ig", "card": smi,
          "ms": {f"{k} B={b}": {"kernel": v[0], "plain": v[1], "bound": ig_bounds[b][k][0]}
                 for b in ig_ms for k, v in ig_ms[b].items()},
          "sdf_train_step_ms": sdf_step_ms, "sdf_steps_per_s": 1e3 / sdf_step_ms})
    shape_ms, shape_bounds = time_path_shapes(net, tr.params, snet, sparams, shape_gen, w128)
    emit({"phase": "times path shapes", "card": smi,
          "ms": {k: {"kernel": v[0], "plain": v[1], "bound": shape_bounds[k][0],
                     "bound_by": shape_bounds[k][1]} for k, v in shape_ms.items()}})
    ms.update(ig_ms[B_MAIN])
    bounds.update(ig_bounds[B_MAIN])

    # 10. the PPNG kernels against their twins at the factory defaults
    ppng_ms, ppng_bounds = check_ppng_kernels(gen, dev, smi, errs)

    # 11. the PPNG SDF slice: each sample config trains through the sample's step
    ppng_launches, _ = ppng_sdf_slice(gen, dev, smi)
    for k, variant in (("K10", "PPNG2"), ("K11", "PPNG2"), ("K12", "PPNG3"), ("K13", "PPNG3")):
        ms[k] = ppng_ms[(k, variant)]
        bounds[k] = ppng_bounds[(k, variant)]

    # 12. the stochastic and Rng options against their twins, and their times
    opt_errs, opt_ms, opt_bounds = check_option_kernels(cfg, gen, dev, smi, enc_w)

    # 13. the options' training slice
    opt_launches, _ = options_slice(cfg, dev, smi, batch)

    # 14. the reference-default T=2^19 grid: kernels, the image sample, times
    ref_errs = check_reference_kernels(cfg, gen, dev)
    ref_launches, render_err, ref_ms, ref_bounds, ref_times = reference_slice(cfg, gen, dev)
    ref_errs["K3"] = max(ref_errs["K3"], render_err)
    emit({"phase": "times reference", "card": smi, "B": B_MAIN,
          "ms": {f"{k} T=2^19": {"kernel": v[0], "plain": v[1], "bound": ref_bounds[k][0]}
                 for k, v in ref_ms.items()},
          "ms_config_hash": {k: {"kernel": ms[k][0], "plain": ms[k][1], "bound": bounds[k][0]}
                             for k in ref_ms},
          **ref_times, "config_hash_training_step_ms": step_ms})

    # 15. the SDF sample at T=2^19
    sdf19_errs, sdf19_launches, sdf19_ms, sdf19_bounds = reference_sdf_slice(gen, dev, smi)
    ref_errs.update(sdf19_errs)
    ref_launches.update(sdf19_launches)
    ref_ms.update(sdf19_ms)
    ref_bounds.update(sdf19_bounds)

    sources = {
        "K1": ("grid_fwd", "tcnn_tpu_torch/csrc/grid_fwd.cu",
               "tcnn_tpu/ops/pallas/grid_kernel.py:597"),
        "K2": ("mlp_fwd", "tcnn_tpu_torch/csrc/mlp_fwd.cu",
               "tcnn_tpu/ops/pallas/mlp_kernel.py:65"),
        "K3": ("fused_infer", "tcnn_tpu_torch/csrc/fused_infer.cu",
               "tcnn_tpu/ops/pallas/train_kernel.py:1412"),
        "K4": ("grid_bwd", "tcnn_tpu_torch/csrc/grid_bwd.cu",
               "tcnn_tpu/ops/pallas/grid_kernel.py:644"),
        "K5": ("mlp_bwd", "tcnn_tpu_torch/csrc/mlp_bwd.cu",
               "tcnn_tpu/ops/pallas/mlp_kernel.py:71"),
        "K6": ("fused_train", "tcnn_tpu_torch/csrc/fused_train.cu",
               "tcnn_tpu/ops/pallas/train_kernel.py:587"),
        "K7": ("grid_bwd_ig", "tcnn_tpu_torch/csrc/grid_bwd_ig.cu",
               "tcnn_tpu/ops/pallas/grid_kernel.py:815"),
        "K8": ("grid_bwd_bwd", "tcnn_tpu_torch/csrc/grid_bwd_bwd.cu",
               "tcnn_tpu/ops/pallas/grid_kernel.py:981"),
        "K9": ("fused_ig", "tcnn_tpu_torch/csrc/fused_ig.cu",
               "tcnn_tpu/ops/pallas/train_kernel.py:2106"),
        "K10": ("ext_gather", "tcnn_tpu_torch/csrc/ext_gather.cu",
                "tcnn_tpu/ops/pallas/dense_ext_kernel.py:95"),
        "K11": ("ext_scatter", "tcnn_tpu_torch/csrc/ext_scatter.cu",
                "tcnn_tpu/ops/pallas/dense_ext_kernel.py:134"),
        "K12": ("ext_lookup", "tcnn_tpu_torch/csrc/ext_gather.cu",
                "tcnn_tpu/ops/pallas/binned_kernel.py:770"),
        "K13": ("ext_lookup_bwd", "tcnn_tpu_torch/csrc/ext_scatter.cu",
                "tcnn_tpu/ops/pallas/binned_kernel.py:1717"),
    }
    # launches: K1-K3 from the inference slice, K6 from the fused training
    # loop, K4 and K5 from the composed training step, K7-K9 from the SDF
    # slice, K10-K13 from the PPNG SDF slice (all three configs); times of
    # K10 and K11 at PPNG2's defaults, of K12 and K13 at PPNG3's
    path_launches = {**{k: launches[k] for k in ("K1", "K2", "K3")},
                     "K4": composed_launches["K4"], "K5": composed_launches["K5"],
                     "K6": train_launches["K6"],
                     **{k: sdf_launches[k] for k in ("K7", "K8", "K9")},
                     **{k: sum(n[k] for n in ppng_launches.values())
                        for k in ("K10", "K11", "K12", "K13")}}
    for k in ("K7", "K8", "K9"):  # phase 12's Rng checks of the input-gradient kernels
        errs[k] = max(errs[k], opt_errs[f"{k} rng"])
    # the options: launches from phase 13's runs of each config (K6 from its
    # fused steps, K1 and K4 from its composed step, K3 from its
    # trainer.inference calls); errors, times and bounds from phase 12
    option_sources = {
        "K1": ("grid_fwd", "tcnn_tpu/ops/pallas/grid_kernel.py:597"),
        "K3": ("fused_infer", "tcnn_tpu/ops/pallas/train_kernel.py:1331"),
        "K4": ("grid_bwd", "tcnn_tpu/ops/pallas/grid_kernel.py:644"),
        "K6": ("fused_train", "tcnn_tpu/ops/pallas/train_kernel.py:968"),
    }
    entries = [(k, sources[k][0], sources[k][1], sources[k][2], path_launches[k], errs[k], ms[k],
                bounds[k]) for k in sources]
    for option in OPTIONS:
        for k, (name, replaces) in option_sources.items():
            key = f"{k} {option}"
            if key not in opt_ms:
                continue  # K1 and K3 take only the Rng option
            if k == "K4" and option in ("stochastic", "both"):
                replaces = "tcnn_tpu/ops/pallas/grid_kernel.py:734"
            run = opt_launches[option]
            n = (run["fused"]["K6"] if k == "K6" else run["inference"] if k == "K3"
                 else run["composed"][k])
            entries.append((key, f"{name} ({option})", sources[k][1], replaces, n, opt_errs[key],
                            opt_ms[key], opt_bounds[key]))
    # B12, the binned grid mode, by function: each kernel at T=2^19 (2-D
    # reference default for K1, K3, K4, K6; the SDF's 3-D grid for K7-K9).
    # Launches from phase 14's sample run (K6), render (K3) and composed
    # step (K1, K4) and from phase 15's SDF steps (K7-K9).
    binned = {"K1": "tcnn_tpu/ops/pallas/binned_kernel.py:770",
              "K3": "tcnn_tpu/ops/pallas/binned_kernel.py:770",
              "K4": "tcnn_tpu/ops/pallas/binned_kernel.py:1099",
              "K6": "tcnn_tpu/ops/pallas/binned_kernel.py:1099",
              "K7": "tcnn_tpu/ops/pallas/binned_kernel.py:1257",
              "K8": "tcnn_tpu/ops/pallas/binned_kernel.py:1348",
              "K9": "tcnn_tpu/ops/pallas/binned_kernel.py:1257"}
    for k, replaces in binned.items():
        entries.append((f"{k} T=2^19", f"{sources[k][0]} (T=2^19)", sources[k][1], replaces,
                        ref_launches[k], ref_errs[k], ref_ms[k], ref_bounds[k]))
    # K3, K5, K6 and K9, redesigned for Hopper (mma.sync layers in
    # registers, persistent blocks, the weight gradient in registers across
    # tiles)
    redesigned = dict.fromkeys(("K3", "K5", "K6", "K9"), "redesigned for Hopper")
    entries = [(key, (name[:-1] + "; " + redesigned[key.split()[0]] + ")" if name.endswith(")")
                      else f"{name} ({redesigned[key.split()[0]]})")
                if key.split()[0] in redesigned else name, *rest)
               for key, name, *rest in entries]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": n, "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": t[2]}
        for _, name, source, replaces, n, err, t, bound in entries
    ]})
    check(all(e[4] > 0 for e in entries), "a kernel or option of the path was never launched")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
