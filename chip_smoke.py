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
     forward (also at width 128 with 5 hidden layers; beside a control, its
     twin on an input whose last 16 columns are dropped, at B > 1), K3
     fused inference (also equal to K2(K1(x)) bit for bit),
     K4 grid backward, K5 fused MLP backward (also 128x5; its gW and gx
     bit-equal between two launches on the same inputs, wherever it is
     checked), K6 fused train step (also with a pdf, output noise and an
     external dL/doutput; its weight gradient bit-equal between two
     launches at each B), each gradient bound beside a control of lower
     precision that it must reject; then, at B = 2^16 - 37, K6 on all nine losses and K4, K5 and K6
     on every activation but Sine, Smoothstep and Nearest interpolation and
     max_level; K3, K4 and K6 at 8 features per level (B = 2^18,
     2^18 - 37), each beside its control; K1 bit for bit at the SDF config
     (B = 2^16, 2^16 - 37 and 1024 points), at D = 4 and with Nearest; K6
     at the SDF config (D = 3, 12 levels), at 11 levels and at config_hash
     with 15 (odd level counts), B = 2^18 - 37, beside its control;
  4. the inference slice: `create_from_config` on data/config_hash.json at
     full width, requests through `trainer.inference` (K3) checked against
     the composed `model.apply` (K1 + K2) and the plain twins on the CPU, the
     launch counters of that run, and a save/load round trip;
  5. the training slice: `training_step` at B = 2^18 on targets sampled on
     the card from a synthetic 1024^2 image, through K6 and K14, Adam's
     step, only (counters), the
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
     D = 2 and 4; 7b (`check_ig_shapes`, its own generator): K7 and K8
     (and K9) at the eikonal term's 1024 points and at 2^18, at 11 levels
     (an odd L), at a cotangent width that is not a multiple of F (F = 4,
     66 columns), and on a hot-row input (2^16 - 37 samples at one point)
     whose table gradients are held against a float64 sum, each beside its
     control;
  8. the SDF slice: `create_from_config` on that config trains SDF_STEPS
     eikonal steps through tcnn_tpu_torch.samples.learn_a_sdf (counters:
     K3, K9, K1, K7, K8 and K1, K2, K5, K4 on every step), the loss falling
     and the z = 0.5 slice error under limits set before the first run; the
     fused route's eikonal gradient against the composed route's;
  9. times of K7, K8, K9 and their twins at the eikonal term's 1024
     points (the shape the SDF step launches), B = 2^16 and 2^18 (K7 and K8
     also beside one `index_add_` of their table contributions, and their
     device time under torch.profiler with and without their wrappers'
     memsets), and of one SDF training step; K3 and K5 timed, with their bounds, at their paths'
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
     and at the sample's configs; on a hot-row input (every sample at one
     point) K11 or K13, and K12; K12 also at the eikonal term's 1024
     points (timed, "times k12"), a ragged batch, C = 3 and an idx 4 bytes
     off an 8-byte boundary, each bit-equal beside its bf16 corner-sum
     control;
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
     N_SAMPLE_STEPS steps at B = 2^18 through K6 and K14 alone (counters) and
     renders the 1024^2 image through K3, loss fall and PSNR under
     SAMPLE_LIMITS; a composed step against K6; a save/load of the trained
     state and a step on each copy; times of K1, K3, K4, K6, both routes'
     steps and `trainer.inference` beside config_hash's;
 15. the SDF sample at T=2^19 (3,471,664 rows): K7, K8 and K9 against
     their twins with controls, SDF_STEPS eikonal steps (counters as phase
     8) under SDF19_LIMITS, the fused eikonal gradient against the
     composed one, and times (K7-K9 at 2^16, 2^18 and 1024 points);
 16. fixed encodings, composite and modules: OneBlob, Frequency,
     TriangleWave and SH (degrees 1-8) on the card against the CPU in f32
     (B = 2^18); (a) data/config_oneblob.json (OneBlob 64 bins, 128 x 5)
     trains through the image sample at B = 2^18 (counters: K2, K5 and K14
     once a step, nothing else; K5 on its split plan every step, `k5.split`),
     loss fall and holdout PSNR under ONEBLOB_LIMITS, `trainer.inference`
     equal to `model.apply`, a save/load; K2 and K5 at its shape (input
     128) and K5 at 128 x 5 on input 32, both on K5's split plan, against
     their twins at 2^18, 2^18 - 37 and 1 beside their controls; the step,
     K2's device time in it and K5's split plan's (dgrad, weight gradient,
     reduce) beside K5's bound, and the CutlassMLP step; the NeRF cell's
     two networks train two steps (K5 twice a step, never split); (b) the
     module-API sample on
     config_hash (`tt.NetworkWithInputEncoding`, torch.optim.Adam, B =
     2^16): its fwd/bwd demo (K3, K9), steps (K1 K2 K5 K4 once each), render
     (K1 K2), limits MODULES_LIMITS, and `bwd` in each GradientMode against
     a CPU copy of the module; (c) an SH + HashGrid Composite (T = 2^19, the
     grid at 39 columns) on 6-D points: its forward bit for bit against the
     CPU model, K2, K5, K4, K7 and K8 on its inputs against their twins
     beside controls, the step's and an eikonal term's gradients against
     the CPU model, and training steps and eikonal gradients by the
     counters;
 17. the optimizers, the grid's plain route and compute_dtype: (a)
     config_hash under instant-ngp's NeRF optimizer (EMA of
     ExponentialDecay of Adam, NERF_OPTIMIZER) trains N_CHAIN_STEPS steps
     at B = 2^18 through K6 and K14 alone (counters), the loss falling;
     `trainer.inference` (K3 on the EMA weights) against `model.apply` on
     them; ten inference calls between two steps building K3's operands
     once; the chain decaying from step 2 every 2 steps (FAST_DECAY) fires
     twice in 6 steps; (b) one step of every otype (SGD, Novograd, Adam,
     Shampoo at a refresh and a plain step, EMA, Average, Lookahead,
     Batched, ExponentialDecay, a Composite and the chain) on config_hash's
     param vector against the same step on the CPU, every state leaf
     under OPT_STEP_REL / SHAMPOO_STEP_REL, each inside
     `torch.cuda.set_sync_debug_mode("error")`, Shampoo's refresh step
     beside its TF32 control; (c) config_hash under Shampoo,
     N_SHAMPOO_STEPS steps through K6 alone, the loss falling; (d) the SDF
     sample's HashGrid with max_level 0.5, with "fast_input_grads" false
     and with stochastic interpolation, N_ROUTE_STEPS steps each (counters:
     K1, K2, K5, K4 a step on the data term and K14; no K3, K7, K8 or K9 on the
     eikonal term's plain route), the loss falling under ROUTE_LOSS_FALL,
     its eikonal gradient against the CPU model's at f32 and at bf16; (e)
     config_hash's Trainer at compute_dtype f32, N_F32_STEPS steps through
     K1, K2, K5 and K4 once a step (their bf16 outputs cast to f32, as
     tcnn_tpu keeps its Pallas kernels at f32 on a TPU) with the loss
     falling, a step's gradient
     against the CPU twins' beside the CPU's f32 plain route; (f) K14, the
     Adam step, against its plain twin on the same card tensors, every leaf
     bit-equal or under OPT_STEP_REL: N_K14_STEPS steps on K6's gradients
     at B_K14 (exact-zero entries taking the skip rule), one step of each
     K14_CASES setting, a Composite whose second view is not 16-byte
     aligned, beside a control (the skip rule left out of the moments) that
     must fail; three Trainer steps rebuilding K3's operands once each; its
     device time beside its twin's, torch's fused Adam's and its bound;
     times of the optimizer steps alone and of a step of each path;
 18. data parallel, the native host runtime and profiling: (a) two ranks
     (gloo, both on the card) run config_hash through
     `tcnn_tpu_torch.parallel.DataParallelTrainer` at the global batch
     B = 2^18: N_DP_STEPS fused steps (K6 on each rank's 2^17 rows, then
     the all-reduce), a `step_external`, a composed step (K1 K2 K5 K4) and
     a `trainer.inference` request (K3), by each rank's counters; the
     ranks' params bit-equal after each stage and within DP_REL of the same
     run on one process; a 1-rank NCCL group's steps; `dryrun_multichip(2)`
     (config_hash under EMA(Adam), PPNG3); (b) the native host runtime
     built by g++, its streams bit-equal to the numpy fallback (uniform,
     logistic, next_uint, advance, image_batch), the image sample's
     `--native-pipeline` batches training N_NATIVE_STEPS steps through K6,
     the loss falling under NATIVE_LOSS_FALL, and its step (host batch and
     copy included) timed beside the device-sampled one; (c) `StepTimer`
     over N_TIMER_STEPS K6 steps against CUDA events within TIMER_REL, and
     `trace` writing a file that names K6's kernel.
Then a line with every kernel and option (its launches on the main path,
phase 18's ranks and processes counted in, error against its twin, time, twin's time, bound, what bounds it and its
yardstick's time; K1's, K2's, K3's, K5's, K6's and K9's entries,
redesigned for Hopper, say so; K14's, which replaces no Pallas kernel, last),
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
#: K11 and K13's table half add the same contributions as their twins in
#: another order: norm-relative EXT_SCATTER_REL (readings of the first-slice
#: kernels: PPNG1 4.4e-7 to 4.6e-7, where thousands of adds land on each of
#: its 37 K gradient floats; PPNG2 1.6e-7; K13 2.6e-8; of the redesigned
#: ones: PPNG1 1.0e-6 at 2^16 and 1.6e-6 at 2^17, the twin's own drift, as
#: the private copies sum in blocks: against float64 the kernel reads
#: 1.7e-7 and the twin 1.6e-6; PPNG2 1.7e-7 to 3.2e-7; K13 2.6e-8 to
#: 8.2e-8; H100 80GB HBM3, 700 W). Controls: PPNG1's
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
#: Phase 10's hot-row input: every sample at one point, so that every pick
#: of a column lands on one row (every K13 warp sums its lanes, K11's
#: private route sums its clashing lanes) and the batch leaves a ragged
#: last warp. Its cotangents are seeded random values: the data term's
#: would be equal for every sample. The kernels are held under the same
#: EXT_SCATTER_REL against the twin's contributions summed in float64,
#: since the twin's own f32 sum of B_HOT adds a float drifts past it (its
#: distance is reported: 4.6e-6 at PPNG1, H100 80GB HBM3, 700 W). The
#: kernels read 3.5e-7 (K11) and 2.2e-7 (K13) there.
B_HOT = (1 << 16) - 37
HOT_POINT = (0.5, 0.0, 1.0)
#: Launches per SDF step of each PPNG config: the data term's gather and its
#: table gradient (K10, K11 or K12, K13) and K2, K5; the eikonal term's
#: gather, its first order (PPNG3: K13's two halves, each a Function) and
#: its second order's table gradient (K11 or K13) and, for PPNG3, K12 for
#: the MLP chain's cotangent; the Adam step (K14).
PPNG_PER_STEP = {"PPNG1": {"K10": 2, "K11": 2, "K2": 1, "K5": 1, "K14": 1},
                 "PPNG2": {"K10": 2, "K11": 2, "K2": 1, "K5": 1, "K14": 1},
                 "PPNG3": {"K12": 3, "K13": 4, "K2": 1, "K5": 1, "K14": 1}}

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

#: Phase 16: the fixed encodings (plain torch on every device) on the card
#: against the same functions on the CPU, in f32, at B = 2^18: OneBlob at
#: config_oneblob's 64 bins, Frequency and TriangleWave at 12 frequencies,
#: SH at degrees 1-8 (on unit directions). Both devices run the same torch
#: ops in the same order, each rounding once (the card divides by a scalar
#: as a multiply by its reciprocal, one rounding more in SH's recurrence
#: from degree 4): FIXED_ABS absolute. Frequency's argument 2^k pi x
#: reaches 2^11 pi, where one f32 ulp is 2^-11; both devices form it in the
#: same two roundings, but the card's sinf/cosf and the CPU's reduce it by
#: their own methods, and a reduction that loses the argument's last bit
#: moves the value by up to that ulp: FREQUENCY_ABS.
FIXED_CASES = (("OneBlob", 2, {"n_bins": 64}), ("Frequency", 3, {"n_frequencies": 12}),
               ("TriangleWave", 3, {"n_frequencies": 12}),
               *(("SphericalHarmonics", 3, {"degree": d}) for d in range(1, 9)))
FIXED_ABS = 1e-5
FREQUENCY_ABS = 2.0**-11
#: Path (a): data/config_oneblob.json trains N_ONEBLOB_STEPS steps at
#: B = 2^18 through the image sample's `train` on the synthetic 1024^2
#: image (the composed route: OneBlob in torch, K2, K5, Adam); (least loss
#: fall, first step over the mean of the last ten; least holdout PSNR in dB
#: of `trainer.inference` on 2^16 points). Set before the first run on the
#: card from a CPU rehearsal on the twins at B = 2^14
#: (scripts/rehearse_modules_slice.py oneblob 200 14: 26.98 -> 0.0985,
#: 274x; 17.46 dB), with room for another batch size and generator.
N_ONEBLOB_STEPS = 200
ONEBLOB_LIMITS = (100.0, 15.0)
#: Path (b): the module-API sample (tcnn_tpu_torch.samples.
#: mlp_learning_an_image_modules) on data/config_hash.json,
#: N_MODULES_STEPS steps of torch.optim.Adam at B = 2^16; (least loss fall;
#: least PSNR of its render over every pixel). Set the same way
#: (rehearse_modules_slice.py modules 200 16: 27.01 -> 0.00497, 5432x;
#: 31.82 dB); the first PSNR limit, 28 dB, came from that one draw and the
#: card read 27.49 dB (H100 80GB HBM3, 700 W) on its first run. Four other
#: draws on the CPU twins (the script's SEED 1-4) read 27.43-31.74 dB and
#: 3495-5399x, so the render's PSNR after 200 steps spreads 4 dB between
#: draws: 26 dB is below that spread.
N_MODULES_STEPS = 200
MODULES_LIMITS = (1000.0, 26.0)
#: The module's `bwd` hands K9 the sample's L2 loss cotangent, which varies
#: in size and sign across a row's outputs, where the eikonal step (K9_REL)
#: hands it a column of ones. K9 carries g as bf16 hi + lo, 16 significant
#: bits (2^-17 relative a term), so a row whose dL/dx cancels k-fold reads
#: about k 2^-17: the first card reading (H100 80GB HBM3, 700 W) was 6.45e-5
#: at the 0.99 quantile (median 4.6e-6, no row over 1e-3), past K9_REL's
#: 6e-5. MODULES_GX_REL = 2.5e-4 allows 32-fold cancellation in 99% of the
#: rows; the control, dL/dx in bf16, reads about 3e-3.
MODULES_GX_REL = 2.5e-4
#: Path (c): a radiance-field shape, SH of degree 3 on the direction (dims
#: 3-5, 9 columns) concatenated with a 3-D HashGrid on the position (dims
#: 0-2; 16 levels, F = 2, T = 2^19, base 16, scale 1.5: 32 columns), 41
#: padded to the MLP's 48, so the grid is padded to 39 columns, not a
#: multiple of F; a 64 x 2 FullyFusedMLP with 4 outputs on top.
COMPOSITE_ENCODING = {"otype": "Composite", "nested": [
    {"otype": "SphericalHarmonics", "degree": 3, "n_dims_to_encode": 3, "dims_to_encode_begin": 3},
    {"otype": "HashGrid", "n_dims_to_encode": 3, "dims_to_encode_begin": 0, "n_levels": 16,
     "n_features_per_level": 2, "log2_hashmap_size": 19, "base_resolution": 16,
     "per_level_scale": 1.5}]}
COMPOSITE_CONFIG = {"loss": {"otype": "L2"},
                    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
                    "encoding": COMPOSITE_ENCODING,
                    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2}}
N_COMPOSITE_STEPS = 20
#: Phase 17 (a): instant-ngp's NeRF optimizer (configs/nerf/base.json): an
#: EMA of an ExponentialDecay of Adam, config_hash's Adam with l2_reg 1e-6.
NERF_OPTIMIZER = {"otype": "Ema", "decay": 0.95, "nested": {
    "otype": "ExponentialDecay", "decay_start": 20000, "decay_interval": 10000,
    "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                                   "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}}
#: The same chain decaying at nested steps 2, 4, ...: its decay fires in
#: N_DECAY_STEPS steps, twice.
FAST_DECAY = {**NERF_OPTIMIZER, "nested": {**NERF_OPTIMIZER["nested"], "decay_start": 2,
                                           "decay_interval": 2}}
N_DECAY_STEPS = 6
#: (c): Shampoo on config_hash's model.
SHAMPOO_OPTIMIZER = {"otype": "Shampoo", "learning_rate": 1e-2}
#: Steps of (a) the chain, (c) Shampoo, (d) each A2 SDF variant and (e) the
#: f32 Trainer.
N_CHAIN_STEPS = 200
N_SHAMPOO_STEPS = 50
N_ROUTE_STEPS = 20
N_F32_STEPS = 50
#: The least loss fall (first step's loss over the last ten's mean) of (a),
#: (c) and (e), set before the first card run: (c) and (e) from
#: scripts/rehearse_optimizers_slice.py's CPU run at B = 2^18 (44.8x and
#: 278x; (e) again on the card's route, the twins of K1 K2 K5 K4: 275x), (a)
#: at phase 5's LOSS_FALL for Adam in 100 steps (the chain trains
#: as Adam: its decay starts at step 20,000, its EMA only filters).
CHAIN_LOSS_FALL = LOSS_FALL
SHAMPOO_LOSS_FALL = 10.0
F32_LOSS_FALL = 50.0
#: (b): one step of each otype on the card against the same step on the CPU,
#: from the same weights, state and gradient: every leaf's norm-relative
#: error. The elementwise optimizers run the same torch expressions on both
#: (a pow or a reduction may differ in its last bit): 1e-5. Shampoo's
#: products sum in cuBLAS's order, and its 30 coupled-Newton iterations
#: carry those roundings into the inverse fourth roots of ill-conditioned
#: Gram factors: the first card run read 5.3e-7 on a Gram factor and
#: 1.4e-4 on a root (L_root_1, 64 x 64; NVIDIA H100 80GB HBM3, 700.00 W),
#: past the 1e-4 written before it. 1e-3, which its TF32 control (each
#: product's operands rounded to 10 bits, 2^-11) must break.
OPT_STEP_REL = 1e-5
SHAMPOO_STEP_REL = 1e-3
#: (f): K14 against its plain twin on the same card tensors, N_K14_STEPS
#: steps of config_hash's Adam on K6's gradients at B_K14, where some hash
#: rows get no sample and take the skip rule; then one step of each
#: K14_CASES setting (a tensor lr_scale: the 0-d device factor), and
#: N_K14_COMPOSITE_STEPS of a Composite whose second Adam's view starts
#: 4 bytes past a 16-byte boundary (its first covers the network and one
#: table entry). Every leaf bit-equal, or within OPT_STEP_REL.
N_K14_STEPS = 20
B_K14 = 1 << 14
N_K14_COMPOSITE_STEPS = 3
K14_CASES = {
    "AdaBound": {"adabound": True},
    "relative + absolute decay": {"relative_decay": 0.01, "absolute_decay": 1e-3},
    "clipping": {"clipping_magnitude": 0.05},
    "non-matrix factor 0.5": {"non_matrix_learning_rate_factor": 0.5},
    "matrix params frozen": {"optimize_matrix_params": False},
    "non-matrix params frozen": {"optimize_non_matrix_params": False},
    "lr_scale a device tensor": {},
}
K14_LR_SCALE = 0.37
#: (b)'s cases: (optimizer, CPU steps before the step compared). Each
#: step compared does what its otype's schedule does there: Average
#: overwrites a ring slot, Lookahead blends, Batched steps its nested
#: optimizer, ExponentialDecay decays, Shampoo refreshes every root (step
#: 1) or none (step 2).
_ADAM = NERF_OPTIMIZER["nested"]["nested"]
OPTIMIZER_STEPS = {
    "Adam": (_ADAM, 3),
    "SGD": ({"otype": "SGD", "learning_rate": 1e-2}, 3),
    "Novograd": ({"otype": "Novograd", "learning_rate": 1e-2}, 3),
    "Shampoo refresh": (SHAMPOO_OPTIMIZER, 0),
    "Shampoo plain": (SHAMPOO_OPTIMIZER, 1),
    "EMA": ({"otype": "EMA", "decay": 0.95, "nested": _ADAM}, 3),
    "Average": ({"otype": "Average", "n_samples": 4, "nested": _ADAM}, 4),
    "Lookahead": ({"otype": "Lookahead", "alpha": 0.5, "n_steps": 4, "nested": _ADAM}, 4),
    "Batched": ({"otype": "Batched", "batch_size_multiplier": 2, "nested": _ADAM}, 3),
    "ExponentialDecay": ({"otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 2,
                          "decay_base": 0.33, "nested": _ADAM}, 2),
    # Adam on the network, SGD on the grid: built with the network's size
    "Composite": (None, 3),
    "chain": (FAST_DECAY, 2),
}
#: (d): the eikonal term's parameter gradient on the card against the CPU
#: model's, same params and points. At f32 the plain route and the f32 chain
#: differ only in summation order (the table's scatter, cuBLAS): 1e-4. At
#: bf16, as the steps run, a sum in another order can flip a bf16 rounding
#: of a layer's output (2^-8 relative): 3e-2.
ROUTE_F32_REL = 1e-4
ROUTE_BF16_REL = 3e-2
#: (d)'s variants of the SDF sample's HashGrid: (encoding keys, max_level).
ROUTE_VARIANTS = {"max_level 0.5": ({}, 0.5),
                  "fast_input_grads false": ({"fast_input_grads": False}, None),
                  "stochastic": ({"stochastic_interpolation": True}, None)}
#: (d)'s least loss fall (first step's loss over the last ten's mean) in
#: N_ROUTE_STEPS steps, by variant, set before its first card run at about
#: 70% of the least of four CPU draws (scripts/rehearse_optimizers_slice.py
#: `limits 18 route`): max_level 0.5 read 2.38-3.38x, fast_input_grads
#: false 1.71-2.10x, stochastic 1.98-2.51x. A model that does not train
#: reads about 1x.
ROUTE_LOSS_FALL = {"max_level 0.5": 1.6, "fast_input_grads false": 1.2, "stochastic": 1.4}
#: (e): one f32 step's params gradient on the card (K1 K2 K5 K4) against
#: the CPU twins' on the same route, as phase 16 holds the Composite's
#: composed step (it read 4.0e-7 / 2.6e-5 there): K5's gx bound (1e-3 at
#: config_hash) on the table, 1e-4 on the weights. The control, the CPU's
#: f32 plain route (no bf16 rounding), reads 5.6e-3 to 7.6e-3 against the
#: twins on tests/test_torch_compute_dtype.py's small models.
F32_GRAD_REL = {"weights": 1e-4, "table": 1e-3}
#: Phase 18 (a): ranks (gloo, all on the one card) and fused steps of the
#: data-parallel run at the global batch B_MAIN; the 1-rank NCCL group's
#: steps.
N_DP_RANKS = 2
N_DP_STEPS = 10
N_NCCL_STEPS = 3
NCCL_BACKEND = "nccl"
#: (a): the ranks' params against one process's after the same steps at the
#: same global batch, norm-relative per part, and the losses. The sums differ
#: in order (each rank's shard, then the all-reduce) and, on the card, in
#: K6's atomics; Adam's first steps are about lr * sign(g), so a gradient
#: sum near 0 that flips its sign moves a param by 2 lr. Set before the
#: first card run at about 10x the largest of four CPU draws
#: (scripts/rehearse_parallel_slice.py `limits 4 dp`): weights 4.6e-8 to
#: 7.8e-6, table 1.1e-7 to 1.8e-4 (two draws with flips, two without),
#: losses 1.2e-7 to 1.4e-6. Control: the first rank's rows alone, with no
#: all-reduce (FirstShardOnly), must break them.
DP_REL = {"weights": 1e-4, "table": 2e-3}
DP_LOSS_RTOL = 2e-5
#: (a): the first step's reduced gradient against one process's, from the
#: same params: each sample's contribution is the same bits (the shard's
#: loss normalisation is twice the global one, exactly), so only the order
#: of the sums differs.
DP_GRAD_REL = {"weights": 1e-5, "table": 1e-5}
#: (b): the streams compared, and the native pipeline's steps and least loss
#: fall (phase 5's limit for the device-sampled batches in 100 steps; the
#: native stream draws the same uniform coordinates), and the steps each
#: pipeline is timed over, in turns.
NATIVE_N = 4096
N_NATIVE_STEPS = 100
NATIVE_LOSS_FALL = LOSS_FALL
N_PIPELINE_STEPS = 20
#: (c): StepTimer against CUDA events over N_TIMER_STEPS steps; the traced steps.
N_TIMER_STEPS = 50
TIMER_REL = 0.1
N_TRACE_STEPS = 5


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


def compare_exact(name, got, want):
    """`got` equal to `want` bit for bit (bf16 compared as its bits, so a
    zero's sign counts); the largest difference is printed either way."""
    import torch

    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bits = (lambda t: t.view(torch.int16)) if got.dtype == torch.bfloat16 else (lambda t: t)
    same = bool(torch.equal(bits(got), bits(want)))
    emit({"phase": "compare", "name": name, "B": int(got.shape[0]), "max_abs_err": err,
          "bit_equal_share": float((diff == 0).float().mean()) if diff.numel() else 1.0,
          "limit": "bit-equal", "ok": same})
    check(same, f"{name}: not bit-equal (max abs err {err})")
    return err


def drop_last_slab(x):
    """x with its last 16 columns zeroed: the input of a fused MLP chain
    that skips its last k16 slab, K2's control."""
    y = x.clone()
    y[:, -16:] = 0
    return y


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
    """Every kernel's launches since the counters were reset, by label
    (K1-K14, `_build.KERNELS`)."""
    from tcnn_tpu_torch.ops.cuda import _build

    return _build.launch_counts()


def reset_counters():
    from tcnn_tpu_torch.utils import profiling

    profiling.reset_counts()


def k5_split_count() -> int:
    """K5 calls that took the split plan since the counters were reset."""
    from tcnn_tpu_torch.utils import profiling

    return profiling.counts("k5.split").get("k5.split", 0)


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
    input; K6 at a 64-row tile; levels 0-2 private in K4 and K6): K3, K4
    and K6 against their twins at B = 2^18 and 2^18 - 37, each bound beside
    a control that must break it (K3's twin reading each row's features
    rotated by one; K4's contributions unrounded; K6 with g in bf16).
    Returns {kernel: max abs err}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel

    m = reference_model(cfg, SEED + 40, dev, gen, n_features_per_level=8)
    net, tr = m.network, m.trainer
    plan = net.encoding.plan
    check(plan.f == 8 and tr.use_fused(), "F = 8 must take K6")
    L, w = plan.n_levels, net.encoding.padded_output_width
    prep = train_kernel.prepare_forward(net, tr.params)
    errs = {"K3": 0.0, "K4": 0.0, "K6": 0.0}
    for B in BATCHES[:2]:
        x = torch.rand(B, 2, generator=gen).to(dev)
        want3 = train_kernel._fused_forward_plain(prep, x)
        errs["K3"] = max(errs["K3"], compare(
            f"K3 fused_infer F=8 B={B}", train_kernel.fused_forward_prepared(prep, x), want3,
            rel_max=MLP_REL))
        control_max(f"K3 F=8 B={B}, each row's features rotated by one",
                    train_kernel._fused_forward_plain(
                        dataclasses.replace(prep, table=prep.table.roll(1, dims=1)), x),
                    want3, MLP_REL)
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


def check_k1_shapes(cfg, dev):
    """Phase 3d: K1 bit for bit against its twin where config_hash does not
    take it: the SDF sample's 3-D grid (12 levels, T = 2^17; 24 columns
    padded to 32, the padding groups written by K1) at B = 2^16, 2^16 - 37
    and the eikonal term's 1024 points, that grid at D = 4, config_hash
    with Nearest (one corner, loaded by one lane of each pair), B = 2^16,
    and that grid's encoding at 16 levels padded to a width that is not a
    multiple of F (F = 4 at 66 columns, F = 8 at 132), B = 2^16, 2^16 - 37.
    Its own generator, so later inputs are those they were. Returns the
    max abs err."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    k1_gen = torch.Generator().manual_seed(SEED + 15)
    err = 0.0
    cases = (("SDF", sdf.CONFIG, 3, {}, (B_SDF, B_SDF - 37, sdf.N_EIKONAL)),
             ("SDF D=4", sdf.CONFIG, 4, {}, (B_SDF,)),
             ("Nearest", cfg, 2, {"interpolation": "Nearest"}, (B_SDF,)))
    for label, c, d, enc, batches in cases:
        m = reference_model(c, SEED + 15, dev, k1_gen, d=d, n_out=1, **enc)
        prep = train_kernel.prepare_forward(m.network, m.trainer.params)
        plan, w = prep.plan, m.network.encoding.padded_output_width
        for B in batches:
            x = torch.rand(B, d, generator=k1_gen).to(dev)
            err = max(err, compare_exact(
                f"K1 grid_fwd {label} B={B}", grid_kernel.grid_encode(plan, prep.table, x, w, plan.n_levels),
                grid_kernel._grid_encode_plain(plan, prep.table, x, w, plan.n_levels)))
    # padded widths that are not a multiple of F: 16 levels of F = 4 at
    # alignment 6 (64 -> 66 columns), of F = 8 at alignment 12 (128 -> 132)
    import tcnn_tpu_torch as tt

    for f, alignment in ((4, 6), (8, 12)):
        enc_cfg = dict(sdf.CONFIG["encoding"], n_levels=16, n_features_per_level=f)
        enc = tt.create_encoding(3, enc_cfg, alignment=alignment)
        plan, w = enc.plan, enc.padded_output_width
        check(w % f != 0, f"K1 width {w} is a multiple of F = {f}")
        table = (torch.rand(plan.total_rows, f, generator=k1_gen) * 2 - 1).to(torch.bfloat16)
        table = table.to(dev)
        for B in (B_SDF, B_SDF - 37):
            x = torch.rand(B, 3, generator=k1_gen).to(dev)
            err = max(err, compare_exact(
                f"K1 grid_fwd F={f} width {w} B={B}",
                grid_kernel.grid_encode(plan, table, x, w, plan.n_levels),
                grid_kernel._grid_encode_plain(plan, table, x, w, plan.n_levels)))
    return err


def check_k6_shapes(cfg, dev):
    """Phase 3e: K6 where its gather's lane map changes
    (csrc/fused_train.cuh:gather_rows), B = 2^18 - 37, each beside the
    control with g in bf16 and with its weight gradient bit-equal between
    two launches: the SDF sample's 3-D grid (12 levels: a lane's level
    changes from step to step), that grid at 11 levels (an odd L: each
    row's phantom twelfth level loads and stores nothing) and config_hash
    at 15 levels (odd, the phantom at D = 2). K9 at D = 3 and at 11 levels
    is phase 7b's. Its own generator. Returns K6's max abs error."""
    import torch
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    k6_gen = torch.Generator().manual_seed(SEED + 43)
    err = 0.0
    B = B_MAIN - 37
    for label, c, d, n_out, enc in (("SDF D=3 L=12", sdf.CONFIG, 3, 1, {}),
                                    ("SDF D=3 L=11", sdf.CONFIG, 3, 1, {"n_levels": 11}),
                                    ("config_hash L=15", cfg, 2, 3, {"n_levels": 15})):
        m = reference_model(c, SEED + 43, dev, k6_gen, d=d, n_out=n_out, **enc)
        tr = m.trainer
        check(tr.use_fused(), f"{label} must take K6")
        x = torch.rand(B, d, generator=k6_gen).to(dev)
        t = torch.rand(B, n_out, generator=k6_gen).to(dev)
        err = max(err, check_train_step(f"{label} B={B}", m.network, tr.loss_fn, tr.params, x, t,
                                        tr.loss_scale, K6_REL, control_too=True, bits=True))
    return err


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


def check_k7_k8(tag, plan, table, x, gy_enc, z, gen, control_too=True, bounds=None):
    """K7 and K8 (without and with a table cotangent drawn from `gen`)
    against their twins on the cotangents gy_enc (bf16, any width of at
    least L*F columns) and z at x; each part under its bound (`bounds`, else
    K7_REL and K8_REL), and with `control_too` a lower-precision twin that
    must break it. Returns the max abs errors {K7, K8}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

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
    return errs


def check_ig_kernels(tag, net, params, x, gen, control_too=True, bounds=None):
    """K7, K8 (without and with a table cotangent) and K9 against their
    twins on the eikonal step's inputs at x; each part under its bound, and
    with `control_too` a lower-precision twin that must break it. Returns
    the max abs errors {K7, K8, K9}."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel, train_kernel

    plan = net.encoding.plan
    table, gy_out, gy_enc, z = eikonal_inputs(net, params, x)
    errs = check_k7_k8(tag, plan, table, x, gy_enc, z, gen, control_too, bounds)
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


def ig_contributions64(plan, x, gy_enc, z=None):
    """The twin's bf16-rounded table contributions of K7 (W_c gy) or, with
    z, of K8 (zw_c gy) summed in float64."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    L, F = plan.n_levels, plan.f
    g = gy_enc[:, : L * F].float().reshape(-1, L, F)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float64, device=x.device)
    for k in grid_kernel._corners(plan, x, derivs=True):
        w = k.w if z is None else sum(z[:, None, d] * k.dw[d] for d in range(plan.d))
        out.index_add_(0, k.rows.reshape(-1),
                       (w[..., None] * g).to(torch.bfloat16).double().reshape(-1, F))
    return out


def check_ig_width(dev, gen):
    """K7 and K8 at a cotangent width that is not a multiple of F: the SDF
    grid at 16 levels of F = 4 and alignment 6 (64 level columns padded to
    66), B = 2^16 - 37, seeded random cotangents, against the twins at the
    full width; ct_gy's two padding columns must come back zero. Returns
    the max abs errors {K7, K8}."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import grid_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    enc = tt.create_encoding(3, dict(sdf.CONFIG["encoding"], n_levels=16, n_features_per_level=4),
                             alignment=6)
    plan, w = enc.plan, enc.padded_output_width
    check(w % plan.f != 0, f"K7/K8 width {w} is a multiple of F = {plan.f}")
    B = B_SDF - 37
    table = (torch.rand(plan.total_rows, plan.f, generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
    x = torch.rand(B, 3, generator=gen).to(dev)
    gy = torch.randn(B, w, generator=gen).to(torch.bfloat16).to(dev)
    z = torch.randn(B, 3, generator=gen).to(dev)
    tag = f"F=4 width {w} B={B}"
    kt, kx = grid_kernel.grid_backward_ig(plan, table, x, gy)
    pt, px = grid_kernel._grid_backward_ig_plain(plan, table, x, gy)
    errs = {"K7": max(compare_norm(f"K7 grid_bwd_ig gtable {tag}", kt, pt, K7_REL["gtable"]),
                      compare_norm(f"K7 grid_bwd_ig gx {tag}", kx, px, K7_REL["gx"]))}
    k = grid_kernel.grid_backward_bwd(plan, table, None, x, gy, z)
    q = grid_kernel._grid_backward_bwd_plain(plan, table, None, x, gy, z)
    check(tuple(k[0].shape) == (B, w) and not k[0][:, 16 * plan.f:].any(),
          f"K8 ct_gy {tag}: shape {tuple(k[0].shape)} or nonzero padding columns")
    errs["K8"] = max(compare_norm(f"K8 grid_bwd_bwd {part} {tag}", a, b, K8_REL[part])
                     for part, a, b in zip(("ct_gy", "gtable2", "ct_x"), k, q))
    return errs


def check_ig_shapes(dev):
    """Phase 7b: K7 and K8 where their shapes and lane map change, each
    beside its control: the SDF config (T = 2^17) at the eikonal term's
    1024 points (K9 there too) and at 2^18; at 11 levels (an odd L: the
    last lane pair's second level idles), B = 2^16 - 37; at F = 4 with a
    cotangent 66 columns wide (its wrappers cut it to the 64 level columns
    and pad ct_gy back), B = 2^16 - 37; and on the hot-row input, B_HOT samples at
    HOT_POINT with the eikonal step's cotangents at those points. There
    every float of a table gradient takes B_HOT equal bf16 contributions,
    which f32 sums exactly in any order (B_HOT < 2^16), so the kernels'
    table gradients are held against the float64 sum under K7_REL /
    K8_REL (one add lost or doubled moves a float by 1 / B_HOT), beside
    the unrounded contributions; dL/dx, ct_gy and ct_x against the twin.
    Its own generator, so later inputs are those they were. Returns the
    max abs errors {K7, K8, K9}."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import grid_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    ig_gen = torch.Generator().manual_seed(SEED + 41)
    errs = {}

    def note(new):
        for k, v in new.items():
            errs[k] = max(errs.get(k, 0.0), v)

    sm = tt.create_from_config(3, 1, sdf.CONFIG, seed=SEED + 41, device=dev)
    sm.trainer.set_params(random_params(sm.trainer, ig_gen))
    net, params = sm.network, sm.trainer.params
    plan = net.encoding.plan
    for B in (sdf.N_EIKONAL, B_MAIN):
        x = torch.rand(B, 3, generator=ig_gen).to(dev)
        note(check_ig_kernels(f"B={B}", net, params, x, ig_gen,
                              bounds=None if B == sdf.N_EIKONAL else {**K7_REL, **K8_REL}))
    odd = json.loads(json.dumps(sdf.CONFIG))
    odd["encoding"]["n_levels"] = 11
    om = tt.create_from_config(3, 1, odd, seed=SEED + 42, device=dev)
    om.trainer.set_params(random_params(om.trainer, ig_gen))
    x = torch.rand(B_SDF - 37, 3, generator=ig_gen).to(dev)
    note(check_ig_kernels(f"L=11 B={B_SDF - 37}", om.network, om.trainer.params, x, ig_gen,
                          bounds={**K7_REL, **K8_REL}))
    note(check_ig_width(dev, ig_gen))

    x = torch.tensor(HOT_POINT, dtype=torch.float32).expand(B_HOT, 3).contiguous().to(dev)
    table, _, gy_enc, z = eikonal_inputs(net, params, x)
    tag = f"hot B={B_HOT}"
    want7 = ig_contributions64(plan, x, gy_enc)
    kt, kx = grid_kernel.grid_backward_ig(plan, table, x, gy_enc)
    pt, px = grid_kernel._grid_backward_ig_plain(plan, table, x, gy_enc)
    note({"K7": max(compare_norm(f"K7 grid_bwd_ig gtable {tag} vs float64", kt.double(), want7,
                                 K7_REL["gtable"]),
                    compare_norm(f"K7 grid_bwd_ig gx {tag}", kx, px, K7_REL["gx"]))})
    rel, _ = norm_errors(pt, want7, {"all": 0})
    emit({"phase": "hot twin", "name": f"K7 twin gtable {tag} vs float64", "norm_rel_err": rel})
    control(f"K7 gtable {tag}, unrounded", scatter_f32(plan, x, gy_enc), want7, K7_REL["gtable"])
    want8 = ig_contributions64(plan, x, gy_enc, z)
    ct = (torch.randn(plan.total_rows, plan.f, generator=ig_gen) * 1e-2).to(torch.bfloat16).to(dev)
    for label, ct_table in (("", None), (" ct_table", ct)):
        k = grid_kernel.grid_backward_bwd(plan, table, ct_table, x, gy_enc, z)
        q = grid_kernel._grid_backward_bwd_plain(plan, table, ct_table, x, gy_enc, z)
        note({"K8": max(
            compare_norm(f"K8 grid_bwd_bwd ct_gy{label} {tag}", k[0], q[0], K8_REL["ct_gy"]),
            compare_norm(f"K8 grid_bwd_bwd gtable2{label} {tag} vs float64", k[1].double(), want8,
                         K8_REL["gtable2"]),
            compare_norm(f"K8 grid_bwd_bwd ct_x{label} {tag}", k[2], q[2], K8_REL["ct_x"]))})
    rel, _ = norm_errors(q[1], want8, {"all": 0})
    emit({"phase": "hot twin", "name": f"K8 twin gtable2 {tag} vs float64", "norm_rel_err": rel})
    control(f"K8 gtable2 {tag}, unrounded", scatter_f32(plan, x, gy_enc, z), want8,
            K8_REL["gtable2"])
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
        got = ek.ext_scatter(idx, ct, spec.n_rows, spec.n_levels)
        want = ek._ext_scatter_plain(idx, ct, spec.n_rows)
        errs["K11"] = max(errs["K11"], compare_norm(f"K11 ext_scatter {tag}", got, want,
                                                    EXT_SCATTER_REL))
        exact = ek._ext_scatter_plain(idx, ct.double(), spec.n_rows)
        emit({"phase": "float64", "name": f"K11 {tag}, kernel and twin against float64",
              "kernel": norm_errors(got, exact, {"all": 0})[0]["all"],
              "twin": norm_errors(want, exact, {"all": 0})[0]["all"]})
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
                lambda: ek.ext_scatter(idx, ct, spec.n_rows, spec.n_levels),
                lambda: ek._ext_scatter_plain(idx, ct, spec.n_rows),
                lambda: out.zero_().index_add_(0, idx.reshape(-1), ct32.reshape(P, F)))
            bounds["K10"] = kernel_bound(bytes_of(idx, tbl, picks))
            bounds["K11"] = kernel_bound(bytes_of(idx, ct, got), f32=P * F)
        return ms, bounds
    cw, gy = inp["cw"], inp["gy"]
    NL = spec.n_levels
    y = check_k12(tag, tbl, idx, cw, NL, errs)
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
        ms["K13 both"] = time_pair(
            lambda: ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL),
            lambda: ek._ext_lookup_bwd_plain(tbl, idx, cw, gy, spec.n_rows, NL, True, True))
        # the table half alone, as the data term launches it, beside index_add_
        # of the bf16-rounded contributions computed beforehand (as k4_yardstick)
        contrib = (cw.reshape(B, -1, NL, 1) * gy.reshape(B, 1, NL, F)).to(torch.bfloat16)
        contrib, rows = contrib.float().reshape(P, F), idx.reshape(-1)
        out = torch.zeros((spec.n_rows, F), device=x.device)
        ms["K13"] = time_pair(
            lambda: ek.ext_lookup_bwd(None, idx, cw, gy, spec.n_rows, NL, want_dots=False),
            lambda: ek._ext_lookup_bwd_plain(None, idx, cw, gy, spec.n_rows, NL, True, False),
            lambda: out.zero_().index_add_(0, rows, contrib))
        bounds["K12"] = k12_bound(tbl, idx, cw, y)
        bounds["K13 both"] = kernel_bound(bytes_of(idx, cw, gy, tbl, dT, dcw), f32=4 * P * F)
        bounds["K13"] = kernel_bound(bytes_of(idx, cw, gy, dT), f32=2 * P * F)
    return ms, bounds


def check_k12(tag, tbl, idx, cw, NL, errs):
    """K12 against its twin bit for bit (rel_ulp 0), beside the control
    that keeps the twin's corner sum in bf16. Adds to `errs`; returns K12's
    output."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

    B, F = idx.shape[0], tbl.shape[1]
    y = ek.ext_lookup(tbl, idx, cw, NL)
    want = ek._ext_lookup_plain(tbl, idx, cw, NL)
    errs["K12"] = max(errs["K12"], compare(f"K12 ext_lookup {tag}", y, want, rel_ulp=0.0))
    picks = tbl[idx.long()].float().reshape(B, -1, NL, F)
    wc = cw.reshape(B, -1, NL, 1)
    acc = torch.zeros_like(picks[:, 0])
    for c in range(picks.shape[1]):
        acc = (acc + wc[:, c] * picks[:, c]).to(torch.bfloat16).float()
    control_exact(f"K12 {tag}, corner sum in bf16", acc.reshape(B, -1).to(torch.bfloat16), want)
    return y


def k12_bound(tbl, idx, cw, y):
    """(bound ms, bound_by) of K12: idx and cw read once, y written once,
    each distinct table row this input picks read once; 2 f32 operations a
    pick and feature."""
    import torch

    rows = torch.unique(idx).numel() * tbl.shape[1] * tbl.element_size()
    return kernel_bound(bytes_of(idx, cw, y) + rows, f32=2 * idx.numel() * tbl.shape[1])


def check_k12_shapes(dev, smi, errs):
    """Phase 10's K12 at the other shapes of its path, PPNG3's sample
    config (its own generator, so later inputs are those they were): the
    eikonal term's N_EIKONAL points (timed, beside its bound and
    `embedding_bag`), a ragged batch (B_SDF - 37) and, at that batch, the
    first three corners of every level (C = 3) and an idx view 4 bytes off
    an 8-byte boundary (both the first-slice kernel, which every C but 8,
    an odd NL and an unaligned idx take), each bit for bit against the
    twin beside the control of check_k12. Adds to `errs`."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek
    from tcnn_tpu_torch.ops.encodings import ppng
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    k12_gen = torch.Generator().manual_seed(SEED + 17)
    enc = ppng.PPNG3Encoding(3, **{k: v for k, v in sdf.ENCODINGS["PPNG3"].items()
                                   if k != "otype"})
    spec, NL = enc.spec, enc.spec.n_levels
    tbl = (torch.rand(spec.n_rows, spec.f, generator=k12_gen) * 2 - 1).to(torch.bfloat16).to(dev)
    times = {}
    for B in (sdf.N_EIKONAL, B_SDF - 37):
        idx, cw = enc.indices(torch.rand(B, 3, generator=k12_gen).to(dev))
        y = check_k12(f"PPNG3 sample B={B}", tbl, idx, cw, NL, errs)
        if B == sdf.N_EIKONAL:
            bag_idx = idx.reshape(B, -1, NL).transpose(1, 2).reshape(B * NL, -1)
            bag_w = cw.reshape(B, -1, NL).transpose(1, 2).reshape(B * NL, -1)
            tbl32 = tbl.float()
            t = time_pair(lambda: ek.ext_lookup(tbl, idx, cw, NL),
                          lambda: ek._ext_lookup_plain(tbl, idx, cw, NL),
                          lambda: torch.nn.functional.embedding_bag(
                              bag_idx, tbl32, mode="sum", per_sample_weights=bag_w))
            times[f"K12 PPNG3 sample B={B}"] = {"kernel": t[0], "plain": t[1], "library": t[2],
                                                "bound": k12_bound(tbl, idx, cw, y)[0]}
    C3 = 3 * NL
    check_k12(f"PPNG3 sample B={B_SDF - 37} C=3", tbl, idx[:, :C3].contiguous(),
              cw[:, :C3].contiguous(), NL, errs)
    buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
    buf[1:] = idx.reshape(-1)
    check_k12(f"PPNG3 sample B={B_SDF - 37} idx at a 4-byte offset", tbl,
              buf[1:].view(idx.shape), cw, NL, errs)
    emit({"phase": "times k12", "card": smi, "ms": times})


def check_ppng_hot(variant, enc, dev, errs):
    """Phase 10's hot-row input (B_HOT samples at HOT_POINT) through K11
    (PPNG1/2, on the route its plan takes) or K13 (PPNG3: both halves and
    the table half alone), each against the float64 sum of the twin's
    contributions under EXT_SCATTER_REL (K13's dots against the twin's,
    EXT_DOTS_REL), beside a control of lower precision; and for PPNG3 K12
    bit for bit, on the encoding's weights and on seeded random ones (at
    one point the encoding's give 16 distinct outputs, too few for the
    bf16 control to break: check_k12's control is held on the random
    ones). Its own generator, so later inputs are those they were. Adds to
    `errs`."""
    import torch
    from tcnn_tpu_torch.ops.cuda import ext_kernel as ek

    hot_gen = torch.Generator().manual_seed(SEED + 16)
    spec, tag = enc.spec, f"{variant} hot B={B_HOT}"
    x = torch.tensor(HOT_POINT, dtype=torch.float32).expand(B_HOT, 3).contiguous().to(dev)
    idx, w = enc.indices(x)
    check(bool((idx == idx[:1]).all()), f"{tag}: the points do not share their rows")
    if variant != "PPNG3":
        ct32 = torch.randn(B_HOT, idx.shape[1] * spec.f, generator=hot_gen).to(dev)
        ct = ct32.to(spec.dtype)
        want = ek._ext_scatter_plain(idx, ct.double(), spec.n_rows)
        got = ek.ext_scatter(idx, ct, spec.n_rows, spec.n_levels)
        errs["K11"] = max(errs["K11"], compare_norm(f"K11 ext_scatter {tag}", got.double(), want,
                                                    EXT_SCATTER_REL))
        rel, _ = norm_errors(ek._ext_scatter_plain(idx, ct, spec.n_rows), want, {"all": 0})
        emit({"phase": "hot twin", "name": f"K11 twin {tag} vs float64", "norm_rel_err": rel})
        lower = ct32 if spec.dtype == torch.bfloat16 else ct.to(torch.bfloat16)
        control(f"K11 {tag}, " + ("unrounded" if spec.dtype == torch.bfloat16 else
                                  "rounded to bf16"),
                ek._ext_scatter_plain(idx, lower, spec.n_rows), want, EXT_SCATTER_REL)
        return
    NL, F, B = spec.n_levels, spec.f, B_HOT
    tbl = (torch.rand(spec.n_rows, F, generator=hot_gen) * 2 - 1).to(torch.bfloat16).to(dev)
    gy = torch.randn(B, NL * F, generator=hot_gen).to(torch.bfloat16).float().to(dev)
    cw = w.contiguous()
    prod = cw.reshape(B, -1, NL, 1) * gy.reshape(B, 1, NL, F)
    rows = idx.reshape(-1).long()
    want = torch.zeros((spec.n_rows, F), dtype=torch.float64, device=dev).index_add_(
        0, rows, prod.to(torch.bfloat16).double().reshape(-1, F))
    dT, dcw = ek.ext_lookup_bwd(tbl, idx, cw, gy, spec.n_rows, NL)
    alone, _ = ek.ext_lookup_bwd(None, idx, cw, gy, spec.n_rows, NL, want_dots=False)
    wT, wcw = ek._ext_lookup_bwd_plain(tbl, idx, cw, gy, spec.n_rows, NL, True, True)
    errs["K13"] = max(errs["K13"],
                      compare_norm(f"K13 ext_lookup_bwd table {tag}", dT.double(), want,
                                   EXT_SCATTER_REL),
                      compare_norm(f"K13 ext_lookup_bwd table alone {tag}", alone.double(), want,
                                   EXT_SCATTER_REL),
                      compare_norm(f"K13 ext_lookup_bwd dots {tag}", dcw, wcw, EXT_DOTS_REL))
    rel, _ = norm_errors(wT, want, {"all": 0})
    emit({"phase": "hot twin", "name": f"K13 twin {tag} vs float64", "norm_rel_err": rel})
    unrounded = torch.zeros_like(wT).index_add_(0, rows, prod.reshape(-1, F))
    control(f"K13 table {tag}, unrounded", unrounded, want, EXT_SCATTER_REL)
    y = ek.ext_lookup(tbl, idx, cw, NL)
    errs["K12"] = max(errs["K12"], compare(f"K12 ext_lookup {tag}", y,
                                           ek._ext_lookup_plain(tbl, idx, cw, NL), rel_ulp=0.0))
    cw_rand = torch.rand(cw.shape, generator=hot_gen).to(dev)
    check_k12(f"{tag}, random weights", tbl, idx, cw_rand, NL, errs)


def check_ppng_kernels(gen, dev, smi, errs):
    """Phase 10: for each PPNG variant, K10-K13 against their twins with
    their controls at the factory defaults (B_PPNG), then at the sample's
    config (B_SDF), whose kernel instantiations phase 11 launches, and on
    the hot-row input (check_ppng_hot), with K2 and K5 at its MLP input
    width; each timed (K13 with both halves, and its table half beside
    `index_add_`); then K12 at its path's other shapes (check_k12_shapes).
    Adds to `errs`; returns
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
        check_ppng_hot(variant, pnet.encoding, dev, errs)
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
    check_k12_shapes(dev, smi, errs)
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

    def scatter(idx, ct, n_rows, n_levels=1):
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


def ig_yardsticks(plan, x, gy_enc, z):
    """K7's and K8's one-call PyTorch yardsticks: `index_add_` of every
    corner's bf16-rounded table contribution into its row (K7: W_c gy; K8:
    zw_c gy, zw_c = sum_d z_d dW_c/dx_d), rows and contributions computed
    beforehand, as k4_yardstick times K4's."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    L, F = plan.n_levels, plan.f
    g = gy_enc[:, : L * F].float().reshape(-1, L, F)
    rows, c7, c8 = [], [], []
    for k in grid_kernel._corners(plan, x, derivs=True):
        rows.append(k.rows.reshape(-1))
        c7.append((k.w[..., None] * g).to(torch.bfloat16).float().reshape(-1, F))
        zw = sum(z[:, None, d] * k.dw[d] for d in range(plan.d))
        c8.append((zw[..., None] * g).to(torch.bfloat16).float().reshape(-1, F))
    rows, c7, c8 = torch.cat(rows), torch.cat(c7), torch.cat(c8)
    out = torch.zeros((plan.total_rows, F), dtype=torch.float32, device=x.device)
    return {"K7": lambda: out.zero_().index_add_(0, rows, c7),
            "K8": lambda: out.zero_().index_add_(0, rows, c8)}


def kernel_device_ms(fn, key, iters=10):
    """(device ms a call of the CUDA kernels whose name holds `key`, device
    ms a call of all its kernels and memsets) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    own = whole = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        whole += t
        own += t if key in ev.key else 0.0
    return own / 1e3 / iters, whole / 1e3 / iters


def time_ig_kernels(net, params, x, plain_iters=3):
    """K7, K8 and K9 on the eikonal step's inputs at x: ({kernel: (ms, twin
    ms, yardstick ms or None)}, {kernel: (bound ms, bound_by)}, {K7, K8:
    (the kernel's device ms, the call's device ms with its wrapper's
    memsets)}), 20 launches a turn."""
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
    library = ig_yardsticks(plan, x, gy_enc, z)
    ms = {k: time_pair(kern, plain, library.get(k), plain_iters=plain_iters)
          for k, (kern, plain) in timed.items()}
    device = {k: kernel_device_ms(timed[k][0], name)
              for k, name in (("K7", "grid_bwd_ig_kernel"), ("K8", "grid_bwd_bwd_kernel"))}
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
    return ms, bounds, device


def k5_bound(dims, weights, enc, gy):
    """K5's (bound ms, bound_by): x, gy and the weights read once, gW (f32)
    and gx written once; the recomputed forward, dgrad and wgrad products."""
    B = enc.shape[0]
    return kernel_bound(bytes_of(enc, gy, weights) + dims.n_weights * 4 + B * dims.in_w * 2,
                        bf16=6 * B * dims.n_weights)


def time_path_shapes(net, params, snet, sparams, gen, w128):
    """K1, K2, K3 and K5 at their paths' other shapes, each (ms, twin ms,
    None) beside its (bound ms, bound_by): K3 at B = 2^20 on `net` (the
    image sample's render chunk) and at the eikonal term's 1024 points on
    the SDF model `snet`; K5 at the SDF's data term (B = 2^16) and at 128 x
    5 (the weights `w128`, B = 2^18); K1 at the SDF's 2^16 and 1024 points;
    K2 at the SDF's data term, at 128 x 5 and at the PPNG sample models'
    MLP input widths 48 and 16 (B = 2^16)."""
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
    # K1 at the SDF step's two launches (the data term's 2^16 points and the
    # eikonal term's 1024), K2 at its data term, at 128 x 5 and at the PPNG
    # sample models' MLP input widths (random bf16 inputs)
    w = snet.encoding.padded_output_width
    for B in (B_SDF, sdf.N_EIKONAL):
        x = torch.rand(B, 3, generator=gen).to(dev)
        ms[f"K1 SDF B={B}"] = time_pair(
            lambda: grid_kernel.grid_encode(sprep.plan, sprep.table, x, w, sprep.plan.n_levels),
            lambda: grid_kernel._grid_encode_plain(sprep.plan, sprep.table, x, w,
                                                   sprep.plan.n_levels), iters=20)
        bounds[f"K1 SDF B={B}"] = kernel_bound(bytes_of(x, sprep.table) + B * w * 2,
                                               f32=grid_ops(B, sprep.plan, "fwd"))
    x = torch.rand(B_SDF, 3, generator=gen).to(dev)
    enc = grid_kernel.grid_encode(sprep.plan, sprep.table, x, w, sprep.plan.n_levels)
    cases = [("K2 SDF B=2^16", sprep.dims, sprep.weights, enc),
             ("K2 128x5", dims128, w128, (torch.rand(B_MAIN, dims128.in_w, generator=gen) * 2 - 1)
              .to(torch.bfloat16).to(dev))]
    for in_w in (48, 16):
        pdims = mlp_kernel.MlpDims(in_w, 64, 2, 16, Activation.ReLU, Activation.NONE)
        pw = (torch.rand(pdims.n_weights, generator=gen) * 0.2 - 0.1).to(torch.bfloat16).to(dev)
        px = (torch.rand(B_SDF, in_w, generator=gen) * 2 - 1).to(torch.bfloat16).to(dev)
        cases.append((f"K2 in_w={in_w} B=2^16", pdims, pw, px))
    for key, dims, weights, xin in cases:
        ms[key] = time_pair(lambda: mlp_kernel.mlp_forward(dims, weights, xin),
                            lambda: mlp_kernel._mlp_forward_plain(dims, weights, xin), iters=20)
        bounds[key] = kernel_bound(bytes_of(xin, weights) + xin.shape[0] * dims.out_w * 2,
                                   bf16=2 * xin.shape[0] * dims.n_weights)
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
    ig_ms, ig_bounds, _ = time_ig_kernels(snet, sparams, x, plain_iters=1)
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
        if plan.stochastic:
            rows = grid_kernel.stochastic_rows(plan, x).reshape(-1)
            grow = gy[:, : L * plan.f].float().reshape(-1, plan.f)
            out = torch.zeros((plan.total_rows, plan.f), device=dev)
            library = {"K4": lambda: out.zero_().index_add_(0, rows, grow)}
        else:  # Rng: index_add_ of the contributions at the rows it hashes to
            library = {"K4": k4_yardstick(plan, x, gy, L)}
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
        check(fused["K6"] == fused["K14"] == N_TRAIN
              and all(v == 0 for k, v in fused.items() if k not in ("K6", "K14")),
              f"the {option} training steps did not run K6 and K14 alone: {fused}")
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
    steps at B = 2^18 through the image sample's `train` (K6 and K14 alone, by
    the counters) and renders through its `render` (one K3 launch per 2^20
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
    check(trained["K6"] == trained["K14"] == N_SAMPLE_STEPS
          and all(v == 0 for k, v in trained.items() if k not in ("K6", "K14")),
          f"the sample's steps did not run K6 and K14 alone: {trained}")
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

    ms, bounds, device = {}, {}, {}
    for B in (B_SDF, B_MAIN):
        ms[B], bounds[B], device[B] = time_ig_kernels(
            snet, sparams, torch.rand(B, 3, generator=gen).to(dev), plain_iters=1)
    # the eikonal term's points, from their own generator (later inputs stay as they were)
    x = torch.rand(sdf.N_EIKONAL, 3, generator=torch.Generator().manual_seed(SEED + 43)).to(dev)
    ms[sdf.N_EIKONAL], bounds[sdf.N_EIKONAL], device[sdf.N_EIKONAL] = time_ig_kernels(
        snet, sparams, x, plain_iters=1)
    xs = torch.rand(B_SDF, 3, generator=gen).to(dev)
    step_ms = cuda_ms(lambda: sdf.train_step(str_, xs), 20)
    emit({"phase": "times reference sdf", "card": smi,
          "ms": {f"{k} B={b}": {"kernel": v[0], "plain": v[1], "library": v[2],
                                "bound": bounds[b][k][0],
                                **({"device": device[b][k][0], "device_with_memsets":
                                    device[b][k][1]} if k in device[b] else {})}
                 for b in ms for k, v in ms[b].items()},
          "sdf_train_step_ms": step_ms, "sdf_steps_per_s": 1e3 / step_ms,
          "sdf_sample_steps_per_s": SDF_STEPS / loop_s})
    launches = {k: launched[k] for k in ("K7", "K8", "K9")}
    return errs, launches, ms[B_MAIN], bounds[B_MAIN]


# ---------------------------------------------------------------------------
# Phase 16: the fixed encodings, the Composite and the module API
# ---------------------------------------------------------------------------


def check_fixed_encodings(dev):
    """Each FIXED_CASES encoding's f32 function on the card against the same
    function on the CPU, B = 2^18, inputs from its own generator (SH: unit
    directions, whose values are at most about 1, so the bound is absolute
    as for the rest)."""
    import torch
    import tcnn_tpu_torch as tt

    fgen = torch.Generator().manual_seed(SEED + 40)
    for otype, d, kw in FIXED_CASES:
        enc = tt.create_encoding(d, {"otype": otype, **kw})
        if otype == "SphericalHarmonics":  # unit directions v, stored as (v + 1) / 2
            v = torch.randn(B_MAIN, d, generator=fgen)
            x = (v / torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1.0) * 0.5
        else:
            x = torch.rand(B_MAIN, d, generator=fgen)
        limit = FREQUENCY_ABS if otype == "Frequency" else FIXED_ABS
        compare(f"{otype} {kw} f32, card vs CPU", enc.encode_f32(x.to(dev)).cpu(),
                enc.encode_f32(x), rel_max=limit)


def oneblob_slice(dev, smi):
    """Path (a): data/config_oneblob.json trains N_ONEBLOB_STEPS steps at
    B = 2^18 through the image sample's `train` (K2 and K5 once a step, by
    the counters; no grid kernel); loss fall and holdout PSNR under
    ONEBLOB_LIMITS; `trainer.inference` equal to `model.apply`; a save/load
    of the trained state; K5 on its split plan every step (`k5.split`).
    Then K2 and K5 against their twins on the trained weights at B = 2^18,
    2^18 - 37 and 1, and K5 at 128 x 5 on input 32 (OneBlob of 16 bins,
    weights U(-0.1, 0.1)), each beside its control, the latter also under
    three other activation pairs at B_COVER; and the times: K2 and
    K5 and their twins, the step (CUDA events), K2's device time inside it
    and that of K5's split plan by kernel (torch.profiler) and the same
    model's step with CutlassMLP (the torch.matmul chain). Returns
    (launches {K2, K5}, errs {K2, K5})."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.common import parse_activation
    from tcnn_tpu_torch.ops.cuda import _build, mlp_kernel
    from tcnn_tpu_torch.samples import mlp_learning_an_image as image_sample
    from tcnn_tpu_torch.utils.image import psnr, sample_image, synthetic_image

    ogen = torch.Generator().manual_seed(SEED + 41)
    cfg = tt.load_config(str(ROOT / "data" / "config_oneblob.json"))
    image = synthetic_image(1024, 1024, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    model, losses = image_sample.train(cfg, image, N_ONEBLOB_STEPS, device=dev, log=None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    trained = counters()
    split_steps = k5_split_count()
    tr, net = model.trainer, model.network
    check(bool(torch.isfinite(losses).all()), "config_oneblob loss not finite")
    fall = float(losses[0] / losses[-10:].mean())
    x_hold = torch.rand(1 << 16, 2, generator=ogen).to(dev)
    y_hold = tr.inference(x_hold)
    holdout_psnr = psnr(y_hold, sample_image(image, x_hold))
    fall_min, psnr_min = ONEBLOB_LIMITS
    emit({"phase": "oneblob slice", "steps": N_ONEBLOB_STEPS, "B": image_sample.BATCH,
          "mlp": [net.network.dims.in_w, net.network.dims.width, net.network.dims.n_hidden],
          "launches": trained,
          "loss_first": float(losses[0]), "loss_last10_mean": float(losses[-10:].mean()),
          "loss_at": {str(i): float(losses[i]) for i in sorted(
              {0, N_ONEBLOB_STEPS // 10, N_ONEBLOB_STEPS // 2, N_ONEBLOB_STEPS - 1})},
          "loss_fall": fall, "loss_fall_min": fall_min, "holdout_psnr_db": holdout_psnr,
          "psnr_min_db": psnr_min, "loop_seconds": loop_s, "k5_split": split_steps})
    check(all(v == (N_ONEBLOB_STEPS if k in ("K2", "K5", "K14") else 0)
              for k, v in trained.items()),
          f"config_oneblob's steps did not run K2, K5 and K14 once each a step, and nothing else: "
          f"{trained}")
    check(split_steps == N_ONEBLOB_STEPS,
          f"K5 took its split plan {split_steps} times in {N_ONEBLOB_STEPS} config_oneblob steps")
    check(fall >= fall_min, f"config_oneblob loss fell only {fall}x")
    check(holdout_psnr >= psnr_min, f"config_oneblob holdout PSNR {holdout_psnr} dB")
    compare_exact("config_oneblob trainer.inference vs model.apply", y_hold,
                  net.apply(tr.params, x_hold)[:, :3].float())
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "oneblob.json")
        tr.save(path)
        copied = tt.create_from_config(2, 3, cfg, seed=SEED + 42, device=dev)
        copied.trainer.load(path)
    check(torch.equal(copied.trainer.inference(x_hold), y_hold),
          "config_oneblob save/load changed predictions")
    for k, v in tr.state["opt"].items():
        check(torch.equal(copied.trainer.state["opt"][k], v), f"config_oneblob optimizer {k}")

    # K2 and K5 at config_oneblob's shape (input 128, 128 x 5), on the
    # trained weights and OneBlob encodings of seeded points
    dims = net.network.dims
    weights = net.split_params(tr.params)[0].to(torch.bfloat16).contiguous()
    errs = {"K2": 0.0, "K5": 0.0}
    for B in BATCHES:
        x = torch.rand(B, 2, generator=ogen).to(dev)
        enc = net.encoding.apply(None, x)
        want = mlp_kernel._mlp_forward_plain(dims, weights, enc)
        errs["K2"] = max(errs["K2"], compare(
            f"K2 mlp_fwd config_oneblob B={B}", mlp_kernel.mlp_forward(dims, weights, enc), want,
            rel_max=MLP_REL))
        if B > 1:
            control_max(f"K2 config_oneblob B={B}, its input's last k16 slab dropped",
                        mlp_kernel._mlp_forward_plain(dims, weights, drop_last_slab(enc)), want,
                        MLP_REL)
        gout = loss_cotangent(dims, weights, enc, tr.loss_fn, sample_image(image, x),
                              tr.loss_scale)
        errs["K5"] = max(errs["K5"], check_mlp_bwd(
            f"K5 mlp_bwd config_oneblob B={B}", dims, weights, enc, gout, K5_REL["128x5"],
            control_too=True))
    # K5's other split-plan shape, 128 x 5 at input 32 (phase 3's, there on
    # grid encodings), here on OneBlob encodings of 16 bins a dimension and
    # weights U(-0.1, 0.1)
    enc32 = tt.create_encoding(2, {"otype": "OneBlob", "n_bins": 16})
    dims32 = mlp_kernel.MlpDims(32, 128, 5, 16, dims.activation, dims.output_activation)
    w32 = (torch.rand(dims32.n_weights, generator=ogen) * 0.2 - 0.1).to(torch.bfloat16).to(dev)
    for B in BATCHES:
        x = torch.rand(B, 2, generator=ogen).to(dev)
        enc = enc32.encode_f32(x).to(torch.bfloat16).contiguous()
        gout = loss_cotangent(dims32, w32, enc, tr.loss_fn, sample_image(image, x), tr.loss_scale)
        errs["K5"] = max(errs["K5"], check_mlp_bwd(
            f"K5 mlp_bwd 128x5 input 32 B={B}", dims32, w32, enc, gout, K5_REL["128x5"],
            control_too=True))
    # the split plan's dgrad under activations other than ReLU (their
    # transfer reads h_i back from device memory), at phase 3's coverage
    # batch and bound; Exponential as a hidden activation would overflow
    # through five layers of 128 and is left out
    for act, out_act in (("Tanh", "Sigmoid"), ("LeakyReLU", "Exponential"),
                         ("Softplus", "Squareplus")):
        dact = mlp_kernel.MlpDims(32, 128, 5, 16, parse_activation(act), parse_activation(out_act))
        x = torch.rand(B_COVER, 2, generator=ogen).to(dev)
        enc = enc32.encode_f32(x).to(torch.bfloat16).contiguous()
        gout = loss_cotangent(dact, w32, enc, tr.loss_fn, sample_image(image, x), tr.loss_scale)
        errs["K5"] = max(errs["K5"], check_mlp_bwd(
            f"K5 mlp_bwd 128x5 input 32 {act}/{out_act} B={B_COVER}", dact, w32, enc, gout,
            {"gW": COVER_REL, "gx": COVER_REL}))
    plans = {f"input {d.in_w}": mlp_kernel.mlp_bwd_plan(d) for d in (dims, dims32)}
    warps = mlp_kernel.mlp_dgrad_warps(dims)
    emit({"phase": "oneblob tiles", "dims": [dims.in_w, dims.width, dims.n_hidden, dims.out_w],
          "K5_plans": plans, "K5_resident_tile_rows": mlp_kernel.mlp_bwd_tile(dims),
          "K5_dgrad_warps": warps, "K5_dgrad_smem_bytes": mlp_kernel.mlp_dgrad_smem_bytes(dims, warps),
          "K5_wgrad_smem_bytes": mlp_kernel.mlp_wgrad_smem_bytes(dims),
          "K2_tile_rows": mlp_kernel.tile_rows(dims, weights.device)})
    check(set(plans.values()) == {"split"}, f"K5 at 128 x 5 does not take its split plan: {plans}")

    # times at B = 2^18
    x = torch.rand(B_MAIN, 2, generator=ogen).to(dev)
    t = sample_image(image, x)
    enc = net.encoding.apply(None, x)
    gy = loss_cotangent(dims, weights, enc, tr.loss_fn, t, tr.loss_scale)
    ms = {"K2": time_pair(lambda: mlp_kernel.mlp_forward(dims, weights, enc),
                          lambda: mlp_kernel._mlp_forward_plain(dims, weights, enc)),
          "K5": time_pair(lambda: mlp_kernel.mlp_backward(dims, weights, enc, gy),
                          lambda: mlp_kernel._mlp_backward_plain(dims, weights, enc, gy))}
    bounds = {"K2": kernel_bound(bytes_of(enc, weights) + B_MAIN * dims.out_w * 2,
                                 bf16=2 * B_MAIN * dims.n_weights),
              "K5": k5_bound(dims, weights, enc, gy)}
    step = lambda: tr.training_step(x, t)  # noqa: E731
    step_ms = cuda_ms(step, 30)
    # K5's split plan: dgrad (A), the weight gradient (B) and the reduce
    k5_parts = {}
    for part, key in (("A", "mlp_dgrad_kernel"), ("B", "mlp_wgrad_kernel"),
                      ("reduce", "reduce_partials")):
        k5_parts[part], step_dev = kernel_device_ms(step, key)
    k5_dev = sum(k5_parts.values())
    k2_dev, _ = kernel_device_ms(step, "mlp_fwd_kernel")
    ccfg = json.loads(json.dumps(cfg))
    ccfg["network"]["otype"] = "CutlassMLP"
    ctr = tt.create_from_config(2, 3, ccfg, seed=SEED + 43, device=dev).trainer
    ctr.set_params(tr.params)
    cstep = lambda: ctr.training_step(x, t)  # noqa: E731
    cutlass_ms = cuda_ms(cstep, 30)
    _, cutlass_dev = kernel_device_ms(cstep, "gemm")
    emit({"phase": "times oneblob", "card": smi, "B": B_MAIN,
          "ms": {k: {"kernel": v[0], "plain": v[1], "bound": bounds[k][0],
                     "bound_by": bounds[k][1]} for k, v in ms.items()},
          "training_step_ms": step_ms, "training_steps_per_s": 1e3 / step_ms,
          "step_device_ms": step_dev, "K5_device_ms_in_step": k5_dev,
          "K5_split_device_ms_in_step": k5_parts, "K5_bound_ms": bounds["K5"][0],
          "K2_device_ms_in_step": k2_dev, "K5_share_of_step_device": k5_dev / step_dev,
          "cutlass_training_step_ms": cutlass_ms, "cutlass_step_device_ms": cutlass_dev})
    return {k: trained[k] for k in ("K2", "K5")}, errs


def nerf_k5_plans(dev):
    """K5 on the NeRF cell's two networks (portbench's ngp_nerf config,
    density 32 -> 64 -> 16 and colour 32 -> 64 x 2 -> 16): two training
    steps on rays of 2^18 samples launch K5 twice a step, never on its split
    plan. Returns (K5 launches, split-plan calls)."""
    import torch
    import tcnn_tpu_torch as tt
    from portbench.traffic import nerf_step
    from tcnn_tpu_torch.ops.volume import Rays

    cfg = json.loads((ROOT / "portbench" / "configs" / "ngp_nerf.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / "nerf_rays_b2e21.json").read_text())
    mix["batch"] = 1 << 18
    model = tt.create_from_config(cfg["n_input_dims"], cfg["n_output_dims"],
                                  {k: cfg[k] for k in nerf_step.BLOCKS}, device=dev)
    x, offsets, dt, background, target = nerf_step.ray_batch(SEED + 44, 0, mix, dev)
    rays = Rays(offsets, dt, background, target)
    model.trainer.training_step(x, rays)
    torch.cuda.synchronize()
    reset_counters()
    for _ in range(2):
        model.trainer.training_step(x, rays)
    torch.cuda.synchronize()
    k5, split = counters()["K5"], k5_split_count()
    emit({"phase": "nerf K5 plans", "launches_K5": k5, "k5_split": split})
    check(k5 == 4 and split == 0, f"the NeRF steps ran K5 {k5} times, {split} on its split plan")
    return k5, split


def modules_slice(dev):
    """Path (b): the module-API sample on data/config_hash.json: its
    `fwd` / `bwd` demo (K3 and K9 once each, by the counters), N_MODULES_STEPS
    steps of torch.optim.Adam at B = 2^16 (K1, K2, K5 and K4 once each a
    step) and its render (K1 and K2 once a 2^20-pixel chunk); loss fall and
    render PSNR under MODULES_LIMITS. Then the module's `fwd` and its `bwd`
    in each GradientMode against the same calls on a CPU copy of the module
    (the twins of K3 and K9), under K9's bounds (dL/dx: MODULES_GX_REL),
    beside controls. Returns
    (the demo's launches, the training's launches)."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.samples import mlp_learning_an_image_modules as msample
    from tcnn_tpu_torch.utils.image import psnr, sample_image, synthetic_image

    cfg = tt.load_config(str(ROOT / "data" / "config_hash.json"))
    module = msample.create_module(cfg, device=dev)
    image = synthetic_image(1024, 1024, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    dparams, dx = msample.demo(module, image)
    torch.cuda.synchronize()
    demo = counters()
    check(bool(torch.isfinite(dparams).all() and torch.isfinite(dx).all()),
          "the modules demo's gradients are not finite")
    reset_counters()
    t0 = time.perf_counter()
    losses = msample.train(module, image, N_MODULES_STEPS, log=None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    trained = counters()
    reset_counters()
    pred = msample.render(module, 1024, 1024)
    torch.cuda.synchronize()
    rendered = counters()
    check(bool(torch.isfinite(losses).all()), "the modules sample's loss is not finite")
    fall = float(losses[0] / losses[-10:].mean())
    render_psnr = psnr(pred, image)
    fall_min, psnr_min = MODULES_LIMITS
    chunks = -(-1024 * 1024 // msample.RENDER_CHUNK)
    emit({"phase": "modules slice", "steps": N_MODULES_STEPS, "B": msample.BATCH,
          "demo_launches": demo, "launches": trained, "render_launches": rendered,
          "loss_first": float(losses[0]), "loss_last10_mean": float(losses[-10:].mean()),
          "loss_fall": fall, "loss_fall_min": fall_min, "render_psnr_db": render_psnr,
          "psnr_min_db": psnr_min, "loop_seconds": loop_s,
          "steps_per_s": N_MODULES_STEPS / loop_s})
    check(all(v == (1 if k in ("K3", "K9") else 0) for k, v in demo.items()),
          f"the modules demo did not run K3 and K9 once each: {demo}")
    per_step = ("K1", "K2", "K4", "K5")
    check(all(v == (N_MODULES_STEPS if k in per_step else 0) for k, v in trained.items()),
          f"the modules sample's steps did not run K1, K2, K5 and K4 once a step: {trained}")
    check(all(v == (chunks if k in ("K1", "K2") else 0) for k, v in rendered.items()),
          f"the modules sample's render did not run K1 and K2 once a chunk: {rendered}")
    check(fall >= fall_min, f"the modules sample's loss fell only {fall}x")
    check(render_psnr >= psnr_min, f"the modules sample's render PSNR {render_psnr} dB")

    # fwd / bwd on the card against a CPU copy of the trained module
    cpu = msample.create_module(cfg, device="cpu")
    with torch.no_grad():
        cpu.params.copy_(module.params.detach().cpu())
    bgen = torch.Generator().manual_seed(SEED + 44)
    x = torch.rand(msample.N_DEMO, 2, generator=bgen)
    y_card, ctx_card = module.fwd(x.to(dev))
    y_cpu, ctx_cpu = cpu.fwd(x)
    compare("module fwd (K3) vs the CPU module", y_card.cpu(), y_cpu, rel_max=MLP_REL)
    dl = 2.0 * (y_cpu - sample_image(image.cpu(), x)) / y_cpu.numel()
    split = module.model.network.n_params
    bounds = {"weights": K9_REL["weights"], "table": K9_REL["table"]}
    acc = None
    for mode in (tt.GradientMode.Overwrite, tt.GradientMode.Accumulate, tt.GradientMode.Ignore):
        gp, gx = module.bwd(ctx_card, dl.to(dev), mode, None if acc is None else acc.to(dev))
        wp, wx = cpu.bwd(ctx_cpu, dl, mode, acc)
        if mode == tt.GradientMode.Ignore:
            check(gp is None and wp is None, "GradientMode.Ignore returned parameter gradients")
        else:
            compare_norm(f"module bwd {mode.value} dL/dparams (K9) vs the CPU module", gp.cpu(),
                         wp, bounds, split)
        compare_rows(f"module bwd {mode.value} dL/dx (K9) vs the CPU module", gx.cpu(), wx,
                     K9_GX_Q, MODULES_GX_REL)
        if mode == tt.GradientMode.Overwrite:
            control("module bwd dL/dparams in bf16", to_bf16(wp), wp, bounds, split)
            control_rows("module bwd dL/dx in bf16", to_bf16(wx), wx, K9_GX_Q, MODULES_GX_REL)
            acc = wp  # Accumulate adds the next gradient to an accumulated one
    return demo, trained


def composite_inputs(net, params, x):
    """Path (c)'s composed route on the twins at x: the bf16 table, the
    Composite's encoding (SH, then the grid's twin at its padded width), the
    cotangent the MLP chain hands the grid's columns for sum(out[:, 0]) (bf16,
    39 wide: K7's gy) and z = d eik / d dL/dpos for an eikonal term on the
    position's gradient (K8's)."""
    import torch
    from tcnn_tpu_torch.ops.cuda import grid_kernel

    sh, grid = net.encoding.nested
    plan, w = grid.plan, grid.padded_output_width
    net_p, enc_p = net.split_params(params)
    table = enc_p.reshape(plan.total_rows, plan.f).to(torch.bfloat16).contiguous()
    pos = x[:, :3].contiguous()
    enc = torch.cat([sh.apply(enc_p[:0], x[:, 3:].contiguous()),
                     grid_kernel._grid_encode_plain(plan, table, pos, w, plan.n_levels)], -1)
    enc = enc.requires_grad_(True)
    with torch.enable_grad():
        out = net.network.apply(net_p, enc, second_order=True)
        (gy_enc,) = torch.autograd.grad(out[:, 0].float().sum(), enc)
    gy = gy_enc[:, sh.padded_output_width:].to(torch.bfloat16).contiguous()
    gx = grid_kernel._grid_input_grad_plain(plan, table, pos, gy).requires_grad_(True)
    with torch.enable_grad():
        eik = 0.01 * torch.mean((torch.linalg.vector_norm(gx, dim=-1) - 1.0) ** 2)
        (z,) = torch.autograd.grad(eik, gx)
    return table, enc.detach(), pos, gy, z.contiguous()


def composite_points(B, gen, device):
    """B seeded 6-D points: a position in the unit cube, then a unit
    direction v stored as (v + 1) / 2."""
    import torch

    pos = torch.rand(B, 3, generator=gen, device=device)
    v = torch.randn(B, 3, generator=gen, device=device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.cat([pos, (v + 1.0) * 0.5], -1)


def radiance(x):
    """Path (c)'s target: a density blob at the cube's center and a color
    that varies with position and, less, with direction."""
    import torch

    pos, d = x[:, :3], x[:, 3:] * 2.0 - 1.0
    sigma = torch.exp(-8.0 * ((pos - 0.5) ** 2).sum(-1, keepdim=True))
    return torch.cat([sigma, 0.5 + 0.5 * torch.sin(6.0 * pos) * (0.75 + 0.25 * d[:, 2:3])], -1)


def composite_slice(dev):
    """Path (c): COMPOSITE_CONFIG at B = 2^18 and 2^18 - 37. The Composite's
    forward (SH, K1 at the grid's 39 columns) against the CPU model's
    encoding bit for bit; the composed step's kernels on the path's inputs
    against their twins (K2 under MLP_REL, K5 under its config_hash bounds,
    K4 on the grid's columns of K5's dL/dx under GRID_BWD_REL) and the
    eikonal-style second order's (K7 and K8 on the grid's 39-column
    cotangent under K7_REL and K8_REL), each beside its control; at 2^14
    points the whole step's gradient against the CPU model's under
    ROUTE_REL, and at 4096 points the eikonal term's parameter gradient under
    SDF_ROUTE_REL. Then N_COMPOSITE_STEPS training steps (K1, K2, K5 and K4
    once each a step) and N_COMPOSITE_STEPS eikonal gradients (K1, K7 and
    K8 once each), by the counters. Returns (max abs errors, the training's
    launches, the eikonal gradients' launches)."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.ops.cuda import grid_kernel, mlp_kernel

    cgen = torch.Generator().manual_seed(SEED + 45)
    model = tt.create_from_config(6, 4, COMPOSITE_CONFIG, seed=SEED + 45, device=dev)
    tr, net = model.trainer, model.network
    comp = net.encoding
    sh, grid = comp.nested
    plan = grid.plan
    check(grid.padded_output_width == 39 and comp.padded_output_width == 48
          and not tr.use_fused(), "path (c)'s Composite is not SH 9 + grid 39 on the composed route")
    tr.set_params(random_params(tr, cgen))
    cpu = tt.create_from_config(6, 4, COMPOSITE_CONFIG, seed=SEED + 45, device="cpu")
    cpu.trainer.set_params(tr.params.cpu())
    net_p, enc_p = net.split_params(tr.params)
    cpu_enc_p = cpu.network.split_params(cpu.trainer.params)[1]
    dims = net.network.dims
    weights = net_p.to(torch.bfloat16).contiguous()
    errs = dict.fromkeys(("K1", "K2", "K4", "K5", "K7", "K8"), 0.0)
    for B in (B_MAIN, B_MAIN - 37):
        xc = composite_points(B, cgen, "cpu")
        x = xc.to(dev)
        tag = f"Composite B={B}"
        enc = comp.apply(enc_p, x)
        errs["K1"] = max(errs["K1"], compare_exact(
            f"{tag}: SH + K1 at width 39, card vs the CPU model", enc.cpu(),
            cpu.network.encoding.apply(cpu_enc_p, xc)))
        table, enc_twin, pos, gy, z = composite_inputs(net, tr.params, x)
        compare_exact(f"{tag}: the encoding vs its twin", enc, enc_twin)
        want = mlp_kernel._mlp_forward_plain(dims, weights, enc)
        errs["K2"] = max(errs["K2"], compare(
            f"K2 mlp_fwd {tag}", mlp_kernel.mlp_forward(dims, weights, enc), want, rel_max=MLP_REL))
        control_max(f"K2 {tag}, its input's last k16 slab dropped",
                    mlp_kernel._mlp_forward_plain(dims, weights, drop_last_slab(enc)), want,
                    MLP_REL)
        gout = loss_cotangent(dims, weights, enc, tr.loss_fn, radiance(x), tr.loss_scale)
        errs["K5"] = max(errs["K5"], check_mlp_bwd(
            f"K5 mlp_bwd {tag}", dims, weights, enc, gout, K5_REL["config_hash"],
            control_too=True))
        _, genc = mlp_kernel._mlp_backward_plain(dims, weights, enc, gout)
        gyg = grid_kernel._level_columns(plan, genc[:, sh.padded_output_width:])
        want = grid_kernel._grid_backward_plain(plan, pos, gyg, plan.n_levels)
        errs["K4"] = max(errs["K4"], compare_norm(
            f"K4 grid_bwd {tag}", grid_kernel.grid_backward(plan, pos, gyg, plan.n_levels), want,
            GRID_BWD_REL))
        control(f"K4 {tag}, contributions unrounded", scatter_f32(plan, pos, gyg), want,
                GRID_BWD_REL)
        for k, v in check_k7_k8(f"{tag} width 39", plan, table, pos, gy, z, cgen).items():
            errs[k] = max(errs[k], v)

    # the whole composed step and the eikonal term against the CPU model
    xc = composite_points(1 << 14, cgen, "cpu")
    cl, cg = tr.loss_and_grad_fn(tr.params, xc.to(dev), radiance(xc).to(dev))
    pl, pg = cpu.trainer.loss_and_grad_fn(cpu.trainer.params, xc, radiance(xc))
    compare_norm("Composite composed step gradient (K1 K2 K5 K4) vs the CPU model", cg.cpu(), pg,
                 ROUTE_REL, net.network.n_params)
    check(abs(float(cl) - float(pl)) <= TRAIN_LOSS_RTOL * abs(float(pl)), "Composite step loss")

    def eikonal(m, params, x):
        p = params.detach().requires_grad_(True)
        xe = x.detach().requires_grad_(True)
        out = m.network.apply(p, xe, prepare_input_gradients=True)
        (g,) = torch.autograd.grad(out[:, 0].float().sum(), xe, create_graph=True)
        eik = torch.mean((torch.linalg.vector_norm(g[:, :3], dim=-1) - 1.0) ** 2)
        return torch.autograd.grad(eik, p)[0]

    xc = composite_points(4096, cgen, "cpu")
    compare_norm("Composite eikonal gradient (K1 K7 K8) vs the CPU model",
                 eikonal(model, tr.params, xc.to(dev)).cpu(),
                 eikonal(cpu, cpu.trainer.params, xc), SDF_ROUTE_REL)

    # training steps and eikonal gradients, by the counters
    dgen = torch.Generator(device=dev).manual_seed(SEED + 46)
    batches = [composite_points(B_MAIN, dgen, dev) for _ in range(N_COMPOSITE_STEPS)]
    torch.cuda.synchronize()
    reset_counters()
    losses = torch.stack([tr.training_step(x, radiance(x)) for x in batches]).cpu()
    torch.cuda.synchronize()
    trained = counters()
    reset_counters()
    for x in batches:
        eikonal(model, tr.params, x[:4096])
    torch.cuda.synchronize()
    eik_launches = counters()
    emit({"phase": "composite slice", "steps": N_COMPOSITE_STEPS, "B": B_MAIN,
          "widths": {"sh": sh.padded_output_width, "grid": grid.padded_output_width,
                     "mlp_in": comp.padded_output_width},
          "launches": trained, "eikonal_launches": eik_launches,
          "loss_first": float(losses[0]), "loss_last": float(losses[-1])})
    check(bool(torch.isfinite(losses).all()), "Composite training loss not finite")
    check(all(v == (N_COMPOSITE_STEPS if k in ("K1", "K2", "K4", "K5", "K14") else 0)
              for k, v in trained.items()),
          f"the Composite's steps did not run K1, K2, K5, K4 and K14 once a step: {trained}")
    check(all(v == (N_COMPOSITE_STEPS if k in ("K1", "K7", "K8") else 0)
              for k, v in eik_launches.items()),
          f"the Composite's eikonal gradients did not run K1, K7 and K8 once each: {eik_launches}")
    return errs, trained, eik_launches


# ---------------------------------------------------------------------------
# Phase 17: the optimizers (A6), the grid's plain route (A2), compute_dtype (A5)
# ---------------------------------------------------------------------------


def state_to(state, device):
    """A copy of an optimizer state tree on `device`."""
    if isinstance(state, dict):
        return {k: state_to(v, device) for k, v in state.items()}
    if isinstance(state, list):
        return [state_to(v, device) for v in state]
    return state.to(device, copy=True)


@contextlib.contextmanager
def no_host_sync():
    """Any CUDA call that synchronises the host raises inside."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def with_optimizer(cfg, optimizer):
    out = json.loads(json.dumps(cfg))
    out["optimizer"] = optimizer
    return out


def leaf_errors(got_w, got_state, want_w, want_state, bound):
    """{leaf: norm-relative error} of the weights and every float leaf, and
    whether the integer leaves are equal."""
    import torch
    from tcnn_tpu_torch.utils.serialization import tree_leaves

    errs = {"weights": norm_errors(got_w.cpu(), want_w, {"all": bound})[0]["all"]}
    ints_equal = True
    for i, (g, w) in enumerate(zip(tree_leaves(got_state), tree_leaves(want_state))):
        if w.dtype.is_floating_point:
            errs[f"leaf {i} {tuple(w.shape)}"] = norm_errors(g.cpu(), w, {"all": bound})[0]["all"]
        else:
            ints_equal &= torch.equal(g.cpu(), w)
    return errs, ints_equal


def check_optimizer_steps(cfg, dev, smi):
    """(b): one step of every otype on config_hash's param vector on the
    card against the same step on the CPU, from the same weights, state
    (OPTIMIZER_STEPS' CPU steps before) and gradient (seeded, x loss scale
    128, 30% exact zeros in the table), each inside no_host_sync; Shampoo's
    refresh step beside its TF32 control (`Shampoo._step`, the step without
    its pinned precision, under `shampoo.matmul_precision("high")`).
    Returns {name: max leaf error}."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.optimizers import shampoo as shampoo_mod

    net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"])
    n, sizes, n_net = net.n_params, net.layer_sizes(), net.network.n_params
    ogen = torch.Generator().manual_seed(SEED + 60)
    w0 = torch.cat([net.network.init_params(ogen), torch.rand(n - n_net, generator=ogen) * 2 - 1])

    def grad():
        g = torch.randn(n, generator=ogen) * 128.0
        g[n_net:][torch.rand(n - n_net, generator=ogen) < 0.3] = 0.0
        return g

    out = {}
    for name, (ocfg, warm) in OPTIMIZER_STEPS.items():
        if ocfg is None:
            ocfg = {"otype": "Composite", "nested": [{**_ADAM, "n_params_to_optimize": n_net},
                                                     {"otype": "SGD", "learning_rate": 1e-1}]}
        shampoo = ocfg["otype"] == "Shampoo"
        bound = SHAMPOO_STEP_REL if shampoo else OPT_STEP_REL
        ref = tt.create_optimizer(ocfg)
        ref.allocate(n, sizes)
        state, w = ref.init_state("cpu"), w0.clone()
        for _ in range(warm):
            ref.step(state, 128.0, w, grad())
        g = grad()
        runs = ["card", "TF32 control"] if name == "Shampoo refresh" else ["card"]
        got = {}
        for run in runs:
            opt = tt.create_optimizer(ocfg)
            opt.allocate(n, sizes)
            dstate, dw, dg = state_to(state, dev), w.to(dev, copy=True), g.to(dev, copy=True)
            opt.load_state(dstate)
            torch.cuda.synchronize()
            with no_host_sync():
                if run == "card":
                    opt.step(dstate, 128.0, dw, dg)
                else:
                    with shampoo_mod.matmul_precision("high"):
                        opt._step(dstate, 128.0, dw, dg, 1.0)
            torch.cuda.synchronize()
            got[run] = (opt, dstate, dw)
        if shampoo:
            check(ref.refresh_groups(warm + 1) == (list(range(3)) if warm == 0 else []),
                  f"{name}: the step compared does not refresh as planned")
        ref.step(state, 128.0, w, g)
        opt, dstate, dw = got["card"]
        errs, ints_equal = leaf_errors(dw, dstate, w, state, bound)
        cw, want_cw = opt.custom_weights(dstate, dw), ref.custom_weights(state, w)
        if want_cw is not None:
            errs["custom_weights"] = norm_errors(cw.cpu(), want_cw, {"all": bound})[0]["all"]
        worst = max(errs.values())
        emit({"phase": "optimizer step", "name": name, "warm_steps": warm,
              "norm_rel_err": errs, "integer_leaves_equal": ints_equal, "limit": bound,
              "host_syncs": 0, "ok": worst <= bound and ints_equal})
        rejected = True
        if "TF32 control" in got:
            _, cstate, cw_ = got["TF32 control"]
            cerrs, _ = leaf_errors(cw_, cstate, w, state, bound)
            rejected = any(not e <= bound for e in cerrs.values())  # a NaN root breaks it too
            emit({"phase": "control", "name": f"{name}, TF32 matmuls", "norm_rel_err": cerrs,
                  "limit": bound, "rejected": rejected})
        check(worst <= bound and ints_equal, f"{name}: the card's step disagrees with the CPU's")
        check(rejected, f"control {name}: the bound {bound} passes TF32 matmuls")
        out[name] = worst
    return out


def time_optimizer_steps(cfg, dev):
    """ms of one optimizer step alone on config_hash's param vector on the
    card: Adam, the NeRF chain, Shampoo's step 1 (every root refreshed),
    step 3 (one group's roots) and step 2 (none)."""
    import torch
    import tcnn_tpu_torch as tt

    net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"])
    n, sizes = net.n_params, net.layer_sizes()
    w = (torch.rand(n, device=dev) - 0.5) * 0.1
    g = torch.randn(n, device=dev)
    times = {}
    for name, ocfg in (("Adam", _ADAM), ("chain", NERF_OPTIMIZER)):
        opt = tt.create_optimizer(ocfg)
        opt.allocate(n, sizes)
        state = opt.init_state(dev)
        times[name] = cuda_ms(lambda: opt.step(state, 128.0, w, g), 50)
    opt = tt.create_optimizer(SHAMPOO_OPTIMIZER)
    opt.allocate(n, sizes)
    state = opt.init_state(dev)

    def shampoo_at(t):
        opt._host_step = t  # the step count before the step: its schedule
        opt.step(state, 128.0, w, g)

    for label, t in (("Shampoo step 1 (all roots)", 0), ("Shampoo step 3 (one group's roots)", 2),
                     ("Shampoo step 2 (no root)", 1)):
        times[label] = cuda_ms(lambda: shampoo_at(t), 20)
    return times


def k14_compare(tag, got_w, got_state, want_w, want_state):
    """K14's leaves against the twin's, each bit for bit (f32 as its bits)
    and by its norm-relative error; a leaf that is not bit-equal must stay
    within OPT_STEP_REL and every integer leaf must be equal. Returns (the
    worst error, whether every leaf is bit-equal)."""
    import torch
    from tcnn_tpu_torch.utils.serialization import tree_leaves

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    got, want = [got_w] + tree_leaves(got_state), [want_w] + tree_leaves(want_state)
    equal = {f"leaf {i} {tuple(w.shape)}": bool(torch.equal(bits(g), bits(w)))
             for i, (g, w) in enumerate(zip(got, want))}
    errs = {k: norm_errors(g, w, {"all": OPT_STEP_REL})[0]["all"]
            for (k, _), g, w in zip(equal.items(), got, want) if w.dtype.is_floating_point}
    ints = all(e for (k, e), w in zip(equal.items(), want) if not w.dtype.is_floating_point)
    worst = max(errs.values())
    ok = ints and worst <= OPT_STEP_REL
    emit({"phase": "K14 vs twin", "name": tag, "bit_equal": equal, "norm_rel_err": errs,
          "limit": f"bit-equal or {OPT_STEP_REL}", "ok": ok})
    check(ok, f"K14 {tag}: disagrees with its twin ({errs})")
    return worst, all(equal.values())


def k14_control_step(opt, state, loss_scale, w, g):
    """K14's control: the twin's step with the skip rule left out of the
    moments: a non-matrix entry whose gradient is exactly zero has its
    moments decayed as if it were active. Returns the entries it moved."""
    import torch

    m1, m2 = state["first_moments"].clone(), state["second_moments"].clone()
    opt._step_plain(state, loss_scale, w, g)
    skipped = torch.zeros_like(m1, dtype=torch.bool)
    skipped[opt.n_matrix_weights:] = g[opt.n_matrix_weights:] == 0
    moved = skipped & ((m1 != 0) | (m2 != 0))
    state["first_moments"].copy_(torch.where(skipped, opt.beta1 * m1, state["first_moments"]))
    state["second_moments"].copy_(torch.where(skipped, opt.beta2 * m2, state["second_moments"]))
    return int(moved.sum())


def adam_kernel_slice(cfg, dev, smi, batch):
    """(f): K14 against its plain twin (`AdamOptimizer._step_plain`) on the
    same card tensors: N_K14_STEPS steps of config_hash's Adam on K6's
    gradients at B_K14, each inside no_host_sync, then each K14_CASES
    setting for one step and the misaligned Composite, beside the control
    (k14_control_step) that has to fail; a Trainer's steps rebuilding K3's
    operands once each (K14 bumps the versions the cache keys on); K14's
    time, its twin's and torch's fused Adam's. Returns (the worst leaf
    error, K14's launches, (ms, twin ms, library ms), (bound ms, bound_by))."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils import profiling
    from tcnn_tpu_torch.utils.serialization import tree_leaves

    t0 = time.perf_counter()
    model = tt.create_from_config(2, 3, cfg, seed=SEED + 90, device=dev)
    tr, net = model.trainer, model.network
    opt, ls = tr.optimizer, tr.loss_scale
    n, n_net = opt.n_weights, opt.n_matrix_weights
    check(type(opt).__name__ == "AdamOptimizer", "config_hash's optimizer is not Adam")
    kstate, kw = tr.state["opt"], tr.state["params"]
    tstate, tw = state_to(kstate, dev), kw.clone()
    reset_counters()
    worst, bits, grads, skipped = 0.0, True, [], []
    for s in range(N_K14_STEPS):
        _, g = tr.loss_and_grad_fn(kw, *batch(B_K14))
        grads = (grads + [g])[-N_K14_COMPOSITE_STEPS:]
        skipped.append(int((g[n_net:] == 0).sum()))
        torch.cuda.synchronize()
        with no_host_sync():
            opt.step(kstate, ls, kw, g)
            opt._step_plain(tstate, ls, tw, g)
        err, same = k14_compare(f"config_hash step {s + 1}", kw, kstate, tw, tstate)
        worst, bits = max(worst, err), bits and same
    launched = counters()["K14"]
    emit({"phase": "K14 steps", "steps": N_K14_STEPS, "B": B_K14, "launches": launched,
          "skipped_entries_a_step": skipped, "bit_equal": bits})
    check(launched == N_K14_STEPS, f"K14 launched {launched} times in {N_K14_STEPS} steps")
    check(min(skipped) > 0, "no gradient entry was exactly zero: the skip rule went untested")

    g = grads[-1]
    for name, overrides in K14_CASES.items():
        case = tt.create_optimizer({**cfg["optimizer"], **overrides})
        case.allocate(n, opt.layer_sizes)
        lr_scale = (torch.tensor(K14_LR_SCALE, device=dev) if name.startswith("lr_scale")
                    else 1.0)
        cs_, cw = state_to(kstate, dev), kw.clone()
        ts_, tw_ = state_to(kstate, dev), kw.clone()
        torch.cuda.synchronize()
        with no_host_sync():
            case.step(cs_, ls, cw, g, lr_scale)
            case._step_plain(ts_, ls, tw_, g, lr_scale)
        err, same = k14_compare(name, cw, cs_, tw_, ts_)
        worst, bits = max(worst, err), bits and same

    comp_cfg = {"otype": "Composite", "nested": [
        {**cfg["optimizer"], "n_params_to_optimize": n_net + 1}, cfg["optimizer"]]}
    comp = tt.create_optimizer(comp_cfg)
    comp.allocate(n, opt.layer_sizes)
    cstate, cw = comp.init_state(dev), kw.clone()
    pstate, pw = state_to(cstate, dev), kw.clone()
    segs = comp._segments()
    check(cw[segs[1]].data_ptr() % 16 == 4, "the Composite's second view is 16-byte aligned")
    for g_ in grads:
        with no_host_sync():
            comp.step(cstate, ls, cw, g_)
            for nested, s_, seg in zip(comp.nested, pstate["nested"], segs):
                nested._step_plain(s_, ls, pw[seg], g_[seg])
    for i, seg in enumerate(segs):
        err, same = k14_compare(f"Composite segment {i} [{seg.start}, {seg.stop})",
                                cw[seg], cstate["nested"][i], pw[seg], pstate["nested"][i])
        worst, bits = max(worst, err), bits and same

    # the control: the skip rule left out of the moments, one step on
    ks_, kw_ = state_to(kstate, dev), kw.clone()
    xs_, xw_ = state_to(kstate, dev), kw.clone()
    opt.step(ks_, ls, kw_, g)
    moved = k14_control_step(opt, xs_, ls, xw_, g)
    cerrs = {f"leaf {i}": norm_errors(c, k, {"all": OPT_STEP_REL})[0]["all"]
             for i, (c, k) in enumerate(zip(tree_leaves(xs_), tree_leaves(ks_)))
             if k.dtype.is_floating_point}
    rejected = moved > 0 and max(cerrs.values()) > OPT_STEP_REL
    emit({"phase": "control", "name": "K14, the skip rule left out of the moments",
          "entries_moved": moved, "norm_rel_err": cerrs, "limit": OPT_STEP_REL,
          "rejected": rejected})
    check(rejected, f"control K14: the limit {OPT_STEP_REL} passes moments updated while skipped")

    # K3's operands: built once a step, after each step (the version bump)
    x, t = batch(B_K14)
    xq = torch.rand(4096, 2, device=dev)
    tr.inference(xq)
    built = profiling.counts("k3.operands_rebuilt").get("k3.operands_rebuilt", 0)
    for _ in range(3):
        tr.training_step(x, t)
        y = tr.inference(xq)
        tr.inference(xq)
    rebuilt = profiling.counts("k3.operands_rebuilt").get("k3.operands_rebuilt", 0) - built
    emit({"phase": "K14 operand rebuilds", "steps": 3, "rebuilds": rebuilt})
    check(rebuilt == 3, f"3 steps, each followed by two inference calls, rebuilt K3's operands "
                        f"{rebuilt} times")
    compare("trainer.inference (K3) after K14's steps vs model.apply", y,
            net.apply(tr.params, xq)[:, :3].float(), rel_max=MLP_REL)

    # times: events (host time where it sets the pace) and device time
    k_ms = kernel_device_ms(lambda: opt.step(kstate, ls, kw, g), "adam_step_kernel", 20)[0]
    t_ms = kernel_device_ms(lambda: opt._step_plain(tstate, ls, tw, g), "", 20)[1]
    p = kw.clone().requires_grad_(True)
    p.grad = g / ls
    fused = torch.optim.Adam([p], lr=opt.learning_rate, betas=(opt.beta1, opt.beta2),
                             eps=opt.epsilon, fused=torch.device(dev).type == "cuda")
    lib_ms = kernel_device_ms(fused.step, "", 20)[1]
    events = {"kernel": cuda_ms(lambda: opt.step(kstate, ls, kw, g), 50),
              "plain": cuda_ms(lambda: opt._step_plain(tstate, ls, tw, g), 20)}
    bound = (n * 40 / HBM_BPS * 1e3, "bytes")
    emit({"phase": "times K14", "card": smi, "n_params": n,
          "device_ms": {"kernel": k_ms, "plain": t_ms, "torch fused Adam": lib_ms},
          "events_ms": events, "bound_ms": {"40 B a parameter": bound[0],
                                            "28 B a parameter (the benchmark's count)":
                                            n * 28 / HBM_BPS * 1e3},
          "bit_equal": bits, "max_leaf_err": worst, "phase_seconds": time.perf_counter() - t0})
    return worst, launched, (k_ms, t_ms, lib_ms), bound


def train_loop(tr, batches):
    """Run `batches` through `training_step`; returns (losses on the CPU,
    launches, seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    losses = [tr.training_step(x, t) for x, t in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counters()
    return torch.stack(losses).cpu(), launched, seconds


def loss_report(tag, losses, fall_min):
    import torch

    check(bool(torch.isfinite(losses).all()), f"{tag}: loss not finite")
    fall = float(losses[0] / losses[-10:].mean())
    n = len(losses)
    return {"loss_first": float(losses[0]), "loss_last10_mean": float(losses[-10:].mean()),
            "loss_at": {str(i): float(losses[i]) for i in sorted({0, n // 4, n // 2, n - 1})},
            "loss_fall": fall, "loss_fall_min": fall_min}


def chain_slice(cfg, dev, batch):
    """(a): config_hash under NERF_OPTIMIZER, N_CHAIN_STEPS steps at B_MAIN
    through K6 and K14 alone, the loss falling; trainer.inference (K3 on the
    EMA weights) against model.apply on them; ten inference calls between two
    steps building K3's operands once; FAST_DECAY's N_DECAY_STEPS steps
    decaying twice. Returns (launches, ms per step)."""
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch import trainer as trainer_mod

    model = tt.create_from_config(2, 3, with_optimizer(cfg, NERF_OPTIMIZER), seed=SEED + 62,
                                  device=dev)
    tr, net = model.trainer, model.network
    check(tr.use_fused(), "config_hash under the NeRF chain must take K6")
    losses, launched, loop_s = train_loop(tr, [batch() for _ in range(N_CHAIN_STEPS)])
    report = loss_report("the NeRF chain", losses, CHAIN_LOSS_FALL)
    emit({"phase": "chain slice", "steps": N_CHAIN_STEPS, "B": B_MAIN, "launches": launched,
          **report, "loop_seconds": loop_s})
    check(launched["K6"] == launched["K14"] == N_CHAIN_STEPS
          and all(v == 0 for k, v in launched.items() if k not in ("K6", "K14")),
          f"the chain's steps did not run K6 and K14 alone: {launched}")
    check(report["loss_fall"] >= CHAIN_LOSS_FALL, f"the chain's loss fell only {report['loss_fall']}x")

    # K3 on the EMA weights against model.apply on them; its operands built
    # once across ten calls between two steps
    prepared = []
    real = trainer_mod.prepare_forward
    trainer_mod.prepare_forward = lambda m, p: prepared.append(1) or real(m, p)
    try:
        x, t = batch()
        tr.training_step(x, t)
        reset_counters()
        xq = [torch.rand(B, 2, device=dev) for B in (B_MAIN, 100_003, 1, 4096, 333, 1 << 16,
                                                     7, 65_537, 2048, 100)]
        ys = [tr.inference(q) for q in xq]
        calls = counters()
        n_prepared = len(prepared)
        ema = tr.inference_params  # the weights those calls served
        tr.training_step(x, t)
        tr.inference(xq[-1])
        n_after = len(prepared)
    finally:
        trainer_mod.prepare_forward = real
    emit({"phase": "chain inference", "requests": len(xq), "launches": calls,
          "operand_builds": n_prepared, "operand_builds_after_a_step": n_after - n_prepared})
    check(calls["K3"] == len(xq) and n_prepared == 1 and n_after == 2,
          f"ten EMA inference calls: K3 {calls['K3']}, operands built {n_prepared} times")
    for q, y in zip(xq[:3], ys[:3]):
        check(y.shape == (q.shape[0], 3) and bool(torch.isfinite(y).all()), "inference shape")
        compare(f"chain trainer.inference (K3, EMA weights) B={q.shape[0]} vs model.apply", y,
                net.apply(ema, q)[:, :3].float(), rel_max=MLP_REL)

    fast = tt.create_from_config(2, 3, with_optimizer(cfg, FAST_DECAY), seed=SEED + 63,
                                 device=dev)
    _, fast_launched, _ = train_loop(fast.trainer, [batch() for _ in range(N_DECAY_STEPS)])
    factor = float(fast.trainer.state["opt"]["nested"]["lr_factor"])
    emit({"phase": "chain decay", "steps": N_DECAY_STEPS, "lr_factor": factor,
          "expected": 0.33**2, "launches": fast_launched})
    check(abs(factor - 0.33**2) <= 1e-6 and fast_launched["K6"] == N_DECAY_STEPS,
          f"the chain decaying from step 2 every 2: factor {factor}")
    launched["K6"] += fast_launched["K6"]
    return launched, cuda_ms(lambda: tr.training_step(x, t), 30)


def shampoo_slice(cfg, dev, batch):
    """(c): config_hash under Shampoo, N_SHAMPOO_STEPS steps at B_MAIN
    through K6 alone, the loss falling. Returns (launches, ms per step)."""
    import tcnn_tpu_torch as tt

    model = tt.create_from_config(2, 3, with_optimizer(cfg, SHAMPOO_OPTIMIZER), seed=SEED + 64,
                                  device=dev)
    tr = model.trainer
    check(tr.use_fused(), "config_hash under Shampoo must take K6")
    losses, launched, loop_s = train_loop(tr, [batch() for _ in range(N_SHAMPOO_STEPS)])
    report = loss_report("Shampoo", losses, SHAMPOO_LOSS_FALL)
    emit({"phase": "shampoo slice", "steps": N_SHAMPOO_STEPS, "B": B_MAIN, "launches": launched,
          **report, "loop_seconds": loop_s})
    check(launched["K6"] == N_SHAMPOO_STEPS
          and all(v == 0 for k, v in launched.items() if k != "K6"),
          f"Shampoo's steps did not run K6 alone: {launched}")
    check(report["loss_fall"] >= SHAMPOO_LOSS_FALL,
          f"Shampoo's loss fell only {report['loss_fall']}x")
    x, t = batch()
    return launched, cuda_ms(lambda: tr.training_step(x, t), 20)


def eikonal_param_grad(net, params, xe, compute_dtype):
    """d/dparams of the SDF sample's eikonal term at the points `xe`, on the
    composed route at `compute_dtype`."""
    import torch

    p = params.detach().requires_grad_(True)
    x = xe.detach().requires_grad_(True)
    with torch.enable_grad():
        out = net.apply(p, x, prepare_input_gradients=True, compute_dtype=compute_dtype)
        (g,) = torch.autograd.grad(out[:, 0].float().sum(), x, create_graph=True)
        (grad,) = torch.autograd.grad(((g.norm(dim=-1) - 1.0) ** 2).mean(), p)
    return grad


def route_model(variant, seed, device):
    """The SDF sample's HashGrid model in the ROUTE_VARIANTS `variant`."""
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    keys, max_level = ROUTE_VARIANTS[variant]
    scfg = sdf.config("HashGrid")
    scfg["encoding"].update(keys)
    model = tt.create_from_config(3, 1, scfg, seed=seed, device=device)
    model.network.encoding.update_hyperparams({"max_level": max_level})
    return model


def route_slice(dev):
    """(d): the SDF sample's HashGrid (T = 2^17) in each ROUTE_VARIANTS
    variant, N_ROUTE_STEPS steps of the sample's train_step at B_SDF: the
    data term through K1, K2, K5 and K4, the eikonal term through the plain
    route and the matmul chain (no K3, K7, K8 or K9), by the counters; the
    loss falling under ROUTE_LOSS_FALL; the eikonal term's gradient against
    the CPU model's at bf16 and at f32. Returns (launches summed over the
    variants, {variant: ms per step})."""
    import torch
    from tcnn_tpu_torch.ops.cuda import train_kernel
    from tcnn_tpu_torch.samples import learn_a_sdf as sdf

    total, step_ms = dict.fromkeys(counters(), 0), {}
    rgen = torch.Generator(device=dev).manual_seed(SEED + 65)
    for i, variant in enumerate(ROUTE_VARIANTS):
        model, cpu = (route_model(variant, SEED + 66 + i, d) for d in (dev, "cpu"))
        tr, net = model.trainer, model.network
        check(not train_kernel.supported_ig(net), f"{variant}: K9 must not take the eikonal term")
        batches = [torch.rand(B_SDF, 3, generator=rgen, device=dev) for _ in range(N_ROUTE_STEPS)]
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        losses = torch.stack([sdf.train_step(tr, xs) for xs in batches]).cpu()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launched = counters()
        report = loss_report(variant, losses, ROUTE_LOSS_FALL[variant])
        per_step = {"K1": 1, "K2": 1, "K4": 1, "K5": 1, "K14": 1}
        emit({"phase": "route slice", "variant": variant, "steps": N_ROUTE_STEPS, "B": B_SDF,
              "eikonal_points": sdf.N_EIKONAL, "launches": launched,
              "launches_per_step_expected": per_step, **report, "loss_last": float(losses[-1]),
              "loop_seconds": loop_s})
        check(all(v == per_step.get(k, 0) * N_ROUTE_STEPS for k, v in launched.items()),
              f"{variant}: the steps did not run K1, K2, K5, K4 and K14 alone, once each: "
              f"{launched}")
        check(report["loss_fall"] >= ROUTE_LOSS_FALL[variant],
              f"{variant}: the SDF loss fell only {report['loss_fall']}x")
        for k, v in launched.items():
            total[k] += v
        xe = batches[-1][: sdf.N_EIKONAL]
        cpu.trainer.set_params(tr.params.cpu())
        for dtype, bound in ((torch.float32, ROUTE_F32_REL), (torch.bfloat16, ROUTE_BF16_REL)):
            got = eikonal_param_grad(net, tr.params, xe, dtype)
            want = eikonal_param_grad(cpu.network, cpu.trainer.params, xe.cpu(), dtype)
            compare_norm(f"{variant}: eikonal gradient at {str(dtype)[6:]} on the card vs the CPU",
                         got.cpu(), want, {"weights": bound, "table": bound},
                         net.network.n_params)
        xs = batches[0]
        step_ms[variant] = cuda_ms(lambda: sdf.train_step(tr, xs), 10)
    return total, step_ms


@contextlib.contextmanager
def card_route():
    """A compute dtype other than bf16 keeps the grid's and FullyFusedMLP's
    kernels on a CPU tensor too (their twins), as it does on the card."""
    from tcnn_tpu_torch import common

    real = common.plain_route
    common.plain_route = lambda x, compute_dtype: False
    try:
        yield
    finally:
        common.plain_route = real


def f32_slice(cfg, dev, batch):
    """(e): config_hash's Trainer at compute_dtype f32, N_F32_STEPS steps at
    B_MAIN through K1, K2, K5 and K4 once a step (K6 and K3 not chosen), the
    loss falling; inference through K1 and K2, in f32; one step's params
    gradient against the CPU Trainer's on the same route (the twins, under
    `card_route`), beside its control: the CPU's f32 plain route, what
    tcnn_tpu computes at f32 off a TPU. Returns (launches, ms per step)."""
    import torch
    import tcnn_tpu_torch as tt

    def trainer(device, seed):
        net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"])
        return tt.Trainer(net, tt.create_optimizer(cfg["optimizer"]), tt.create_loss(cfg["loss"]),
                          seed=seed, device=device, compute_dtype=torch.float32)

    tr = trainer(dev, SEED + 70)
    check(tr.loss_scale == 1.0 and not tr.use_fused(), "f32: loss scale 1, K6 not chosen")
    losses, launched, loop_s = train_loop(tr, [batch() for _ in range(N_F32_STEPS)])
    report = loss_report("f32", losses, F32_LOSS_FALL)
    per_step = {"K1": 1, "K2": 1, "K4": 1, "K5": 1, "K14": 1}
    emit({"phase": "f32 slice", "steps": N_F32_STEPS, "B": B_MAIN, "launches": launched,
          "launches_per_step_expected": per_step, **report, "loop_seconds": loop_s})
    check(all(v == per_step.get(k, 0) * N_F32_STEPS for k, v in launched.items()),
          f"the f32 steps did not run K1, K2, K5, K4 and K14 alone, once each: {launched}")
    check(report["loss_fall"] >= F32_LOSS_FALL, f"the f32 loss fell only {report['loss_fall']}x")
    x, t = batch()
    reset_counters()
    y = tr.inference(x)
    infer = counters()
    check(y.dtype == torch.float32 and all(v == (1 if k in ("K1", "K2") else 0)
                                           for k, v in infer.items()),
          f"f32 inference: {y.dtype}, launches {infer}")
    cpu = trainer("cpu", SEED + 70)
    cpu.set_params(tr.params.cpu())
    gl, gg = tr.loss_and_grad_fn(tr.params, x, t)
    with card_route():
        cl, cg = cpu.loss_and_grad_fn(cpu.params, x.cpu(), t.cpu())
    _, plain_g = cpu.loss_and_grad_fn(cpu.params, x.cpu(), t.cpu())
    n_net = tr.model.network.n_params
    compare_norm("f32 step gradient (K1 K2 K5 K4) on the card vs the CPU twins", gg.cpu(), cg,
                 F32_GRAD_REL, n_net)
    control("f32 step gradient, the CPU's f32 plain route", plain_g, cg, F32_GRAD_REL, n_net)
    check(abs(float(gl) - float(cl)) <= TRAIN_LOSS_RTOL * abs(float(cl)),
          "f32 loss on the card vs the CPU twins")
    return launched, cuda_ms(lambda: tr.training_step(x, t), 10)


def optimizers_slice(cfg, dev, smi, batch):
    """Phase 17: (a) chain_slice, (b) check_optimizer_steps, (c)
    shampoo_slice, (d) route_slice, (e) f32_slice, (f) adam_kernel_slice,
    and the times of the optimizer steps alone and of a step of each path.
    Returns (the launches of the paths that run kernels: K6 (a) and (c)'s,
    and (d) and (e)'s; K14's entry: its worst leaf error, its launches in
    (a) and (f), its times and its bound)."""
    t0 = time.perf_counter()
    chain_launches, chain_ms = chain_slice(cfg, dev, batch)
    step_errs = check_optimizer_steps(cfg, dev, smi)
    shampoo_launches, shampoo_ms = shampoo_slice(cfg, dev, batch)
    route_launches, route_ms = route_slice(dev)
    f32_launches, f32_ms = f32_slice(cfg, dev, batch)
    k14_err, k14_launches, k14_ms, k14_bound = adam_kernel_slice(cfg, dev, smi, batch)
    emit({"phase": "times optimizers", "card": smi, "B": B_MAIN,
          "optimizer_step_ms": time_optimizer_steps(cfg, dev),
          "training_step_ms": {"chain (a)": chain_ms, "Shampoo (c)": shampoo_ms,
                               **{f"SDF {k} (d), B={B_SDF}": v for k, v in route_ms.items()},
                               "f32 (e)": f32_ms},
          "optimizer_step_max_leaf_err": step_errs,
          "phase_seconds": time.perf_counter() - t0})
    launches = {k: v + f32_launches[k] for k, v in route_launches.items()}
    launches["K6"] += chain_launches["K6"] + shampoo_launches["K6"]
    return launches, (k14_err, chain_launches["K14"] + k14_launches, k14_ms, k14_bound)


# ---------------------------------------------------------------------------
# Phase 18: data parallel (A9), the native host runtime (A10), profiling
# ---------------------------------------------------------------------------


def sync(dev) -> None:
    """Wait for `dev`'s work (a CUDA device; nothing to wait for on the CPU,
    where scripts/rehearse_parallel_slice.py runs this phase)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_run(cfg, dev, dp_of=None, steps=N_DP_STEPS, batch=B_MAIN, seed=SEED + 80):
    """(a)'s run on one process: config_hash (seed `seed`) takes `steps`
    fused steps on the global batch `batch`, one external-
    gradient step and one composed-route step, then serves one
    `trainer.inference` request; through `dp_of(trainer)` (a
    DataParallelTrainer: this rank's shard, the all-reduce) or, with None,
    the plain Trainer. Every process draws the same batches. Returns numpy
    results: the losses, the params and the launches after each stage, the
    inference output and the fused loop's seconds."""
    import numpy as np
    import torch
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.utils.image import sample_image, synthetic_image

    tr = tt.create_from_config(2, 3, cfg, seed=seed, device=dev).trainer
    dp = None if dp_of is None else dp_of(tr)
    state = tr.state if dp is None else dp.replicate(tr.state)
    image = synthetic_image(1024, 1024, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batches = []
    for _ in range(steps + 2):
        x = torch.rand(batch, 2, generator=gen, device=dev)
        batches.append((x, sample_image(image, x)))
    out = {"grad": (tr.loss_and_grad_fn(tr.params, *batches[0]) if dp is None
                    else dp.loss_and_grad(tr.params, *batches[0]))[1].cpu().numpy()}

    def stage(name, fn):
        sync(dev)
        reset_counters()
        t0 = time.perf_counter()
        result = fn()
        sync(dev)
        out[f"{name} seconds"] = time.perf_counter() - t0
        out[f"{name} launches"] = counters()
        out[f"{name} params"] = state["params"].cpu().numpy().copy()
        return result

    def fused():
        if dp is None:
            return [tr.training_step(x, t) for x, t in batches[:steps]]
        return [dp.step(state, x, t)[1] for x, t in batches[:steps]]

    out["fused losses"] = torch.stack(stage("fused", fused)).cpu().numpy()
    x, t = batches[steps]
    dl = torch.zeros(batch, tr.model.padded_output_width, device=dev)
    dl[:, :3] = -2.0 * t / t.numel()  # an L2 loss's dL/doutput at a zero prediction
    stage("external", lambda: tr.training_step(x, dL_doutput=dl) if dp is None
          else dp.step_external(state, x, dl))
    tr.use_fused_train_kernel = False
    x, t = batches[steps + 1]
    stage("composed", lambda: tr.training_step(x, t) if dp is None else dp.step(state, x, t))
    out["inference"] = stage("inference", lambda: tr.inference(x[:4096])).cpu().numpy()
    return out


def dp_rank(rank, n_ranks, address, cfg, device, batch, steps, seed, results):
    """One rank of (a): gloo, every rank on the first card (NCCL refuses
    two ranks on one device); puts (rank, dp_run's results) or (rank, the
    error) on `results`."""
    try:
        import torch
        import torch.distributed as dist
        from tcnn_tpu_torch.parallel import DataParallelTrainer, create_mesh, init_distributed

        init_distributed(address, n_ranks, rank, local_device_ids=[0], backend="gloo")
        dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
        out = dp_run(cfg, dev, lambda tr: DataParallelTrainer(tr, create_mesh()), steps, batch,
                     seed)
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException as e:  # reported to the parent, which raises
        results.put((rank, f"{type(e).__name__}: {e}"))
        raise


class FirstShardOnly:
    """DataParallelTrainer's interface without the all-reduce: the first
    rank's rows alone, on one process. Its params are DP_REL's control."""

    def __init__(self, trainer):
        self.tr = trainer

    def _rows(self, a):
        return a[: a.shape[0] // N_DP_RANKS]

    def replicate(self, state):
        return state

    def loss_and_grad(self, params, x, t):
        return self.tr.loss_and_grad_fn(params, self._rows(x), self._rows(t))

    def step(self, state, x, t):
        return state, self.tr.training_step(self._rows(x), self._rows(t))

    def step_external(self, state, x, dl):
        self.tr.training_step(self._rows(x), dL_doutput=self._rows(dl))
        return state


def dp_compare(name, got, want, n_net, bounds=None):
    """A data-parallel run's params against the single process's (stage
    `name`): norm-relative per part under DP_REL."""
    import torch

    return compare_norm(f"data parallel {name} vs one process", torch.from_numpy(got),
                        torch.from_numpy(want), bounds or DP_REL, n_net)


def parallel_slice(cfg, dev, smi):
    """(a): N_DP_RANKS gloo ranks on the card run dp_run through
    DataParallelTrainer; their params bit-equal after each stage and within
    DP_REL of the same run on one process; K6 launched on each rank (K1 K2
    K5 K4 on the composed step, K3 on the request); a 1-rank NCCL group's
    N_NCCL_STEPS steps against one process; then dryrun_multichip. Returns
    the launches of the phase's runs, summed over ranks and runs."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import tcnn_tpu_torch as tt
    from tcnn_tpu_torch.parallel import (DataParallelTrainer, create_mesh, dryrun_multichip,
                                         init_distributed)
    from tcnn_tpu_torch.parallel.data_parallel import spawn_ranks

    t0 = time.perf_counter()
    n_net = tt.create_network_with_input_encoding(2, 3, cfg["encoding"], cfg["network"]) \
        .network.n_params
    ranks = spawn_ranks(dp_rank, N_DP_RANKS,
                        (cfg, torch.device(dev).type, B_MAIN, N_DP_STEPS, SEED + 80))
    spawn_s = time.perf_counter() - t0
    single = dp_run(cfg, dev, steps=N_DP_STEPS, batch=B_MAIN)
    total = dict.fromkeys(counters(), 0)
    stages = {"fused": {"K6": N_DP_STEPS, "K14": N_DP_STEPS}, "external": {"K6": 1, "K14": 1},
              "composed": {"K1": 1, "K2": 1, "K4": 1, "K5": 1, "K14": 1}, "inference": {"K3": 1}}
    for r, out in enumerate(ranks):
        emit({"phase": "data parallel rank", "rank": r, "ranks": N_DP_RANKS, "B": B_MAIN,
              "rows_a_rank": B_MAIN // N_DP_RANKS, "steps": N_DP_STEPS,
              "losses": out["fused losses"].tolist(),
              "launches": {k: out[f"{k} launches"] for k in stages},
              "fused_ms_a_step": out["fused seconds"] * 1e3 / N_DP_STEPS})
        for stage, want in stages.items():
            got = out[f"{stage} launches"]
            check(all(v == want.get(k, 0) for k, v in got.items()),
                  f"rank {r}'s {stage} stage launched {got}, not {want}")
            for k, v in got.items():
                total[k] += v
    first = dp_run(cfg, dev, FirstShardOnly, steps=N_DP_STEPS, batch=B_MAIN)
    same = all(np.array_equal(o["grad"].view(np.uint32), ranks[0]["grad"].view(np.uint32))
               for o in ranks)
    check(same, "the ranks' reduced gradients differ")
    dp_compare("reduced gradient", ranks[0]["grad"], single["grad"], n_net, DP_GRAD_REL)
    control("data parallel reduced gradient, the first rank's rows alone",
            torch.from_numpy(first["grad"]), torch.from_numpy(single["grad"]), DP_GRAD_REL, n_net)
    for stage in ("fused", "external", "composed"):
        key = f"{stage} params"
        same = all(np.array_equal(o[key].view(np.uint32), ranks[0][key].view(np.uint32))
                   for o in ranks)
        emit({"phase": "data parallel ranks bit-equal", "stage": stage, "ok": same})
        check(same, f"the ranks' params differ after the {stage} stage")
        dp_compare(f"{stage} params", ranks[0][key], single[key], n_net)
        control(f"data parallel {stage} params, the first rank's rows alone",
                torch.from_numpy(first[key]), torch.from_numpy(single[key]), DP_REL, n_net)
    same = all(np.array_equal(o["fused losses"], ranks[0]["fused losses"]) for o in ranks)
    check(same and np.array_equal(ranks[0]["inference"], ranks[1]["inference"]),
          "the ranks' losses or inference outputs differ")
    loss_rel = float(np.abs(ranks[0]["fused losses"] / single["fused losses"] - 1).max())
    emit({"phase": "data parallel losses vs one process", "losses": ranks[0]["fused losses"].tolist(),
          "one_process": single["fused losses"].tolist(), "max_rel": loss_rel, "limit": DP_LOSS_RTOL})
    check(loss_rel <= DP_LOSS_RTOL, f"data-parallel losses {loss_rel} off one process's")
    for stage in stages:
        for k, v in single[f"{stage} launches"].items():
            total[k] += v

    # a 1-rank NCCL group in this process
    rank_world = init_distributed(f"localhost:{free_port()}", 1, 0, backend=NCCL_BACKEND)
    try:
        check(rank_world == (0, 1) and dist.get_backend() == NCCL_BACKEND, "the NCCL group")
        nccl = dp_run(cfg, dev, lambda tr: DataParallelTrainer(tr, create_mesh()),
                      steps=N_NCCL_STEPS, batch=B_MAIN)
    finally:
        dist.destroy_process_group()
    one = dp_run(cfg, dev, steps=N_NCCL_STEPS, batch=B_MAIN)
    check(nccl["fused launches"]["K6"] == N_NCCL_STEPS, "the NCCL group's steps did not run K6")
    dp_compare("NCCL 1 rank params", nccl["fused params"], one["fused params"], n_net)
    for run in (nccl, one):
        for stage in stages:
            for k, v in run[f"{stage} launches"].items():
                total[k] += v

    t1 = time.perf_counter()
    dry = dryrun_multichip(N_DP_RANKS, device=torch.device(dev).type)
    for out in dry:
        check(out["launches"]["K6"] > 0 and out["launches"]["K12"] > 0
              and out["launches"]["K13"] > 0, f"the dry run did not run K6, K12, K13: "
              f"{out['launches']}")
        for k, v in out["launches"].items():
            total[k] += v
    emit({"phase": "times data parallel", "card": smi, "ranks": N_DP_RANKS, "B": B_MAIN,
          "spawn_and_run_seconds": spawn_s, "dryrun_seconds": time.perf_counter() - t1,
          "fused_ms_a_step": {"one process": single["fused seconds"] * 1e3 / N_DP_STEPS,
                              **{f"rank {r}": o["fused seconds"] * 1e3 / N_DP_STEPS
                                 for r, o in enumerate(ranks)}},
          "note": "ranks share one card: no multi-GPU speed"})
    return total


def native_slice(cfg, dev, smi):
    """(b): the native library built and its streams bit-equal to the numpy
    fallback at NATIVE_N; the image sample's native pipeline trains
    N_NATIVE_STEPS steps through K6 and K14 alone, the loss falling under
    NATIVE_LOSS_FALL; its step (host batch and copy included) timed beside
    the device-sampled step. Returns (launches, the trained trainer)."""
    import numpy as np
    import torch
    from tcnn_tpu_torch import native
    from tcnn_tpu_torch.samples import mlp_learning_an_image as sample
    from tcnn_tpu_torch.utils.image import synthetic_image
    from tcnn_tpu_torch.utils.profiling import StepTimer

    t0 = time.perf_counter()
    a = native.HostRng(1337, use_native=True)
    build_s = time.perf_counter() - t0
    b = native.HostRng(1337, use_native=False)
    image = synthetic_image(1024, 1024, device="cpu")
    host_image = image.numpy()
    bits = lambda v: np.asarray(v, np.float32).view(np.uint32)  # noqa: E731
    same = {"seed": a.state == b.state,
            "uniform": np.array_equal(bits(a.uniform(NATIVE_N)), bits(b.uniform(NATIVE_N))),
            "logistic": np.array_equal(bits(a.logistic(NATIVE_N, 0.5, 0.1)),
                                       bits(b.logistic(NATIVE_N, 0.5, 0.1))),
            "next_uint": [a.next_uint() for _ in range(16)] == [b.next_uint() for _ in range(16)]}
    a.advance(NATIVE_N * 3 + 5)
    b.advance(NATIVE_N * 3 + 5)
    same["advance"] = a.state == b.state and a.next_uint() == b.next_uint()
    batches = [r.image_batch(host_image, NATIVE_N) for r in (a, b)]
    same["image_batch"] = all(np.array_equal(bits(p), bits(q)) for p, q in zip(*batches))
    same["state after"] = a.state == b.state
    emit({"phase": "native streams", "n": NATIVE_N, "build_seconds": build_s,
          "bit_equal": same})
    check(all(same.values()), f"the native streams differ from the fallback: {same}")

    reset_counters()
    model, losses = sample.train(cfg, image, N_NATIVE_STEPS, device=dev, log=None,
                                 pipeline=sample.native_batches)
    sync(dev)
    launched = counters()
    report = loss_report("native pipeline", losses, NATIVE_LOSS_FALL)
    emit({"phase": "native pipeline", "steps": N_NATIVE_STEPS, "B": B_MAIN, "launches": launched,
          **report})
    check(launched["K6"] == launched["K14"] == N_NATIVE_STEPS
          and all(v == 0 for k, v in launched.items() if k not in ("K6", "K14")),
          f"the native pipeline's steps did not run K6 and K14 alone: {launched}")
    check(report["loss_fall"] >= NATIVE_LOSS_FALL,
          f"the native pipeline's loss fell only {report['loss_fall']}x")

    tr = model.trainer
    feeds = {name: fn(image, B_MAIN, tr.device) for name, fn in
             (("native", sample.native_batches), ("device", sample.device_batches))}
    times = {name: [] for name in feeds}
    for name in ("native", "device", "device", "native"):
        for _ in range(2):  # warm
            tr.training_step(*next(feeds[name]))
        sync(dev)
        timer = StepTimer(B_MAIN)
        for _ in range(N_PIPELINE_STEPS):
            timer.step(tr.training_step(*next(feeds[name])))
        times[name].append(timer.seconds() * 1e3 / N_PIPELINE_STEPS)
    rng = native.HostRng(1337, use_native=True)
    t0 = time.perf_counter()
    for _ in range(N_PIPELINE_STEPS):
        xy, rgb = rng.image_batch(host_image, B_MAIN)
    host_ms = (time.perf_counter() - t0) * 1e3 / N_PIPELINE_STEPS
    pinned = torch.from_numpy(xy).pin_memory() if torch.device(dev).type == "cuda" else None
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 20) if pinned is not None else 0.0
    emit({"phase": "times native pipeline", "card": smi, "B": B_MAIN,
          "training_step_ms": {f"{k} batches": v for k, v in times.items()},
          "host_image_batch_ms": host_ms, "xy_copy_ms": copy_ms,
          "note": "wall ms a step, the batch's draw and copy included, in turns"})
    return launched, tr


def profiling_slice(tr, dev, smi):
    """(c): StepTimer over N_TIMER_STEPS K6 steps against CUDA events
    around the same steps, within TIMER_REL; `trace` over N_TRACE_STEPS
    steps writes a file that names K6's kernel. Returns the launches."""
    import torch
    from tcnn_tpu_torch.samples import mlp_learning_an_image as sample
    from tcnn_tpu_torch.utils.profiling import StepTimer, trace

    x, t = next(sample.device_batches(torch.rand(64, 64, 3), B_MAIN, tr.device))
    tr.training_step(x, t)
    sync(dev)
    reset_counters()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timer = StepTimer(B_MAIN)
    start.record()
    for _ in range(N_TIMER_STEPS):
        timer.step(tr.training_step(x, t))
    end.record()
    timer_ms = 1e3 / timer.steps_per_sec
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / N_TIMER_STEPS
    rel = abs(timer_ms - event_ms) / event_ms if event_ms > 0 else float("inf")
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for _ in range(N_TRACE_STEPS):
                tr.training_step(x, t)
            sync(dev)
        files = list(pathlib.Path(tmp).glob("*.pt.trace.json"))
        text = files[0].read_text() if len(files) == 1 else ""
    k6_events = sum(1 for e in prof.events() if "fused_train_kernel" in e.name)
    launched = counters()
    emit({"phase": "profiling", "card": smi, "steps": N_TIMER_STEPS, "step_timer_ms": timer_ms,
          "cuda_event_ms": event_ms, "rel": rel, "limit": TIMER_REL,
          "samples_per_sec": timer.samples_per_sec, "trace_files": len(files),
          "trace_bytes": len(text), "trace_names_k6": "fused_train_kernel" in text,
          "k6_events": k6_events, "launches": launched})
    check(rel <= TIMER_REL, f"StepTimer {timer_ms} ms vs CUDA events {event_ms} ms")
    # the profiler may miss a launch (one of five in one card run): the trace
    # must name K6's kernel, and the counters hold every launch
    check("fused_train_kernel" in text and k6_events >= 1,
          "the trace does not name K6's kernel")
    check(launched["K6"] == N_TIMER_STEPS + N_TRACE_STEPS, f"profiled steps: {launched}")
    return launched


def parallel_native_slice(cfg, dev, smi):
    """Phase 18: (a) parallel_slice, (b) native_slice, (c)
    profiling_slice. Returns the launches of its runs, summed."""
    t0 = time.perf_counter()
    total = parallel_slice(cfg, dev, smi)
    native_launches, tr = native_slice(cfg, dev, smi)
    prof_launches = profiling_slice(tr, dev, smi)
    for part in (native_launches, prof_launches):
        for k, v in part.items():
            total[k] += v
    emit({"phase": "phase 18", "launches": total, "phase_seconds": time.perf_counter() - t0})
    return total


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
        k2_want = mlp_kernel._mlp_forward_plain(dims, prep.weights, enc_plain)
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd", mlp_kernel.mlp_forward(dims, prep.weights, enc_plain), k2_want,
            rel_max=MLP_REL))
        if B > 1:  # one sample's output need not move past the bound's absolute floor
            control_max(f"K2 B={B}, its input's last k16 slab dropped", mlp_kernel._mlp_forward_plain(
                dims, prep.weights, drop_last_slab(enc_plain)), k2_want, MLP_REL)
        errs["K2"] = max(errs["K2"], compare(
            "K2 mlp_fwd 128x5", mlp_kernel.mlp_forward(dims128, w128, enc_plain),
            mlp_kernel._mlp_forward_plain(dims128, w128, enc_plain), rel_max=MLP_REL))
        k3 = train_kernel.fused_forward_prepared(prep, x)
        errs["K3"] = max(errs["K3"], compare(
            "K3 fused_infer", k3, train_kernel._fused_forward_plain(prep, x), rel_max=MLP_REL))
        # K3 gathers with the shared walker and K1 with its lane pairs, in the
        # same corner order; both run frag_forward on the same bf16 encoding
        compare_exact(f"K3 vs K2(K1) B={B}", k3, mlp_kernel.mlp_forward(
            dims, prep.weights, grid_kernel.grid_encode(plan, prep.table, x, enc_w, L)))

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

    # 3c. F = 8 through K3, K4 and K6 (16-byte rows; two float4 atomics a
    #     corner; the private levels' budget at 32 bytes a row)
    for k, v in check_f8(cfg, gen, dev).items():
        errs[k] = max(errs[k], v)
    # 3d. K1 bit for bit beyond config_hash (its own generator)
    errs["K1"] = max(errs["K1"], check_k1_shapes(cfg, dev))
    # 3e. K6 at D = 3 and at odd level counts (its own generator)
    errs["K6"] = max(errs["K6"], check_k6_shapes(cfg, dev))

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
    k3_launches = counters()["K3"]
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
    k14_launches = train_launches["K14"]
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
          "psnr_min_db": PSNR_MIN, "loop_seconds": loop_s, "K14_launches": k14_launches})
    check(train_launches["K6"] == N_TRAIN, "training_step did not run K6 once per step")
    check(k14_launches == N_TRAIN, "training_step did not run K14 once per step")
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
    emit({"phase": "composed step", "launches": composed_launches,
          "k5_split": k5_split_count()})
    check(all(composed_launches[k] == 1 for k in ("K1", "K2", "K4", "K5"))
          and composed_launches["K3"] == composed_launches["K6"] == 0,
          "the composed step did not run K1, K2, K5 and K4 once each")
    check(k5_split_count() == 0, "the composed config_hash step took K5's split plan")

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
    # 7b. K7 and K8 at 1024 points and 2^18, at an odd L and on a hot-row input
    for k, v in check_ig_shapes(dev).items():
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
    ig_ms, ig_bounds, ig_dev = {}, {}, {}
    # the timings of the paths' other shapes draw from their own generator,
    # so that every later check sees the inputs it saw before they existed
    shape_gen = torch.Generator().manual_seed(SEED + 13)
    for B in (sdf.N_EIKONAL, B_SDF, B_MAIN):
        x = torch.rand(B, 3, generator=shape_gen if B == sdf.N_EIKONAL else gen).to(dev)
        ig_ms[B], ig_bounds[B], ig_dev[B] = time_ig_kernels(snet, sparams, x)
    xs = torch.rand(B_SDF, 3, generator=gen).to(dev)
    sdf_step_ms = cuda_ms(lambda: sdf.train_step(sm.trainer, xs), 20)
    emit({"phase": "times ig", "card": smi,
          "ms": {f"{k} B={b}": {"kernel": v[0], "plain": v[1], "library": v[2],
                                "bound": ig_bounds[b][k][0],
                                **({"device": ig_dev[b][k][0], "device_with_memsets":
                                    ig_dev[b][k][1]} if k in ig_dev[b] else {})}
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

    # 16. fixed encodings, composite and modules: the fixed encodings on the
    #     card against the CPU; (a) config_oneblob through the image sample,
    #     K2 and K5 at its shape; (b) the module-API sample; (c) the SH +
    #     HashGrid Composite, its grid at 39 columns
    check_fixed_encodings(dev)
    oneblob_launches, oneblob_errs = oneblob_slice(dev, smi)
    nerf_k5_plans(dev)
    modules_demo, modules_launches = modules_slice(dev)
    comp_errs, comp_launches, comp_eik_launches = composite_slice(dev)
    for part in (oneblob_errs, comp_errs):
        for k, v in part.items():
            errs[k] = max(errs[k], v)
    # 17. the optimizers, the grid's plain route and compute_dtype: (a) the
    #     NeRF chain, (b) one step of every otype against the CPU, (c)
    #     Shampoo, (d) the SDF grid's A2 cases, (e) config_hash at f32
    opt_launches17, (k14_err, k14_n, k14_ms, k14_bound) = optimizers_slice(cfg, dev, smi, batch)
    # 18. data parallel (a: two gloo ranks on the card, a 1-rank NCCL group,
    #     dryrun_multichip), the native host runtime (b: its streams, the
    #     image sample's native pipeline) and profiling (c: StepTimer, trace)
    launches18 = parallel_native_slice(cfg, dev, smi)
    emit({"phase": "modules launches", "oneblob_steps": oneblob_launches,
          "modules_demo": {k: v for k, v in modules_demo.items() if v},
          "modules_steps": {k: v for k, v in modules_launches.items() if v},
          "composite_steps": {k: v for k, v in comp_launches.items() if v},
          "composite_eikonal": {k: v for k, v in comp_eik_launches.items() if v}})

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
    # K10 and K11 at PPNG2's defaults, of K12 and K13 at PPNG3's (K13's
    # table half, as the data term launches it, beside index_add_)
    # phase 17's K6 steps (the chain, Shampoo), A2's data terms and the f32
    # steps (K1, K2, K5, K4) added; phase 18's on every rank and process
    # (K6 steps, the composed steps, inference, the dry run's PPNG3: K12 K13)
    path_launches = {**{k: launches[k] + opt_launches17[k] + launches18[k]
                        for k in ("K1", "K2", "K3")},
                     **{k: composed_launches[k] + opt_launches17[k] + launches18[k]
                        for k in ("K4", "K5")},
                     "K6": train_launches["K6"] + opt_launches17["K6"] + launches18["K6"],
                     **{k: sdf_launches[k] for k in ("K7", "K8", "K9")},
                     **{k: sum(n[k] for n in ppng_launches.values()) + launches18[k]
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
    # K1-K3, K5-K9, K11 and K13, redesigned for Hopper (K1: D fixed at
    # compile time, lane pairs sharing corner loads; K2, K3, K5, K6, K9:
    # mma.sync layers in registers, persistent blocks, the weight gradient
    # in registers across tiles; K7, K8: K1's lane pairs, one vector RED a
    # corner; K11: private levels summed by warps that
    # own them, vector REDs; K12: corners at compile time, every idx and cw
    # load before the rows, lane pairs on each x-pair; K13: warp sums of
    # the lanes on one row, vector REDs)
    redesigned = dict.fromkeys(("K1", "K2", "K3", "K5", "K6", "K7", "K8", "K9", "K11", "K12"),
                               "redesigned for Hopper")
    redesigned["K13"] = "redesigned for Hopper; its table half timed"
    entries = [(key, (name[:-1] + "; " + redesigned[key.split()[0]] + ")" if name.endswith(")")
                      else f"{name} ({redesigned[key.split()[0]]})")
                if key.split()[0] in redesigned else name, *rest)
               for key, name, *rest in entries]
    # K14, the Adam step, which replaces no Pallas kernel: launches from the
    # training slice, phase 17's chain and its K14 checks; device times (the
    # library: torch's fused Adam); its bound by its 40 B a parameter, and by
    # the 28 B the benchmark counts (param_steps left out)
    entries.append(("K14", "adam_step (the Adam step; device ms)",
                    "tcnn_tpu_torch/csrc/adam.cu",
                    "none: tcnn_tpu/optimizers/adam.py is one XLA computation",
                    k14_launches + k14_n, k14_err, k14_ms, k14_bound))
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": n, "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": t[2],
         **({"bound_ms_28_bytes": k14_bound[0] * 28 / 40} if key == "K14" else {})}
        for key, name, source, replaces, n, err, t, bound in entries
    ]})
    check(all(e[4] > 0 for e in entries), "a kernel or option of the path was never launched")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
