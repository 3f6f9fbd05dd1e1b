#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (spherehand_torch) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. versions, device name, power limit;
  2. build the CUDA rasterizers, sphere kernels and the hourglass's 2x
     bilinear upsample from spherehand_torch/csrc with nvcc, one process per
     source, started together;
  3. each raster kernel against its plain PyTorch version on the card: full
     mesh at B = 8 sampler poses plus the adversarial face sets; the three
     z-tile kernels (read from the projected planes) a second time and on
     the reversed face order, bit for bit, raw fast bit for bit against its
     plain version; fast against exact by the fast-mode contract (phase 5
     repeats the kernel checks at the main path's B = 128);
  4. the main path: B = 128 sampler poses -> synthesize(add_noise=True), in
     the fast (default) and the exact raster mode -> PoseEstimator with the
     shipped weights (precision "highest") -> mean joint error under 25 mm,
     the same crops served on the CPU agree within 1e-2 mm, and both
     kernels' launch counters were raised by that run;
  5. CUDA-event timings (median of 20 calls after warm-up) at B = 128 and
     1024: render_depth_64 fast and exact, each kernel alone (from the
     planes), each plain version (pre-pass included), and
     PoseEstimator.predict at B = 128;
  6. the three sphere kernels against their plain versions on the card at
     N = 225 (the projected sphere centres of a rendered 25-hand, 3-view
     batch against its depth maps), on an adversarial set (exact ties,
     a sphere centred on a pixel, all-background targets) and on the edge
     set (discs within a pixel of a tile's edge, depth >= 100 behind an
     uncovered sphere, observations of 99.0 and NaN, an all-foreground
     view): forward fields and argmins identical (NaN at the same pixels),
     weights within 1 ulp, backward within 1e-5 relative and bit-identical
     across two runs, the lowest-j tie rule;
  7. the training path at full width (EngineConfig defaults: 48 synthetic
     + 25 x 3 real, one stack, Adam lr 1e-3): render the real batch (exact
     raster), 3 synt_steps, 3 combined_steps (is_mv True, True, False) and
     1 eval_step from the shipped weights; every metric finite, the
     parameters moved, all five kernels launched by this phase;
  8. one combined_grads on the card and on the CPU at the geometry of
     tests/goldens/grad_parity_ab.npz (8 synthetic + 4 x 3 real, real batch
     read from that file) with the same draws and TF32 off: loss terms
     within 1e-3 relative, per-tensor gradient norms within 5 %;
  9. CUDA-event medians: each fused sphere kernel and plain version at
     N = 225, synt_step and combined_step (draws included) and eval_step;
     the sphere bounds count what these inputs need (covered pixel-sphere
     pairs, foreground pixels, pixels of nonzero weight);
 10. the op-level API of the JAX package (its unfused mutual projection and
     the raw fast raster):
     (a) the six one-field sphere kernels (min depth, nearest distance:
         primal, forward, backward) against their plain versions at N = 225
         (phase 6's hands, the distance reading the gathered targets) and on
         the adversarial and edge sets, held as in phase 6, and their field,
         argmin and weight planes equal to the fused kernel's bit for bit;
     (b) the per-field path at full width: the shipped estimator (TF32 off)
         on phase 7's 25 x 3 real batch -> joints -> the unfused
         mutual_projection_loss (mutual_projection + data_to_model_distance)
         under autograd, backward into the parameters, and once without
         grad: value within 1e-6 relative and joint gradient within 2e-5 of
         the largest entry of the fused loss (is_mv True and False), every
         parameter gradient finite, all six one-field kernels launched;
     (c) spherehand_torch.kernel_parity at B = 32 (raw fast IoU > 0.999 and
         p99 < 0.5 mm against the exact rule, pooled median < 0.05 mm) and
         stack_loss / its gradient norm within 2e-4 / 1e-3 relative of
         tests/goldens/tpu_sphere_parity.npz (a TPU v5e's, the correctness
         reference); raster_fast (from the planes, no pre-pass) against its
         plain version bit for bit, and again and on the reversed face
         order, at B = 128, 1024, on a non-uniform grid, on the whole 640 x
         640 canvas (B = 4) and on the adversarial face sets, where raw
         fast-vs-exact coverage flips stay under 1 %;
     (d) CUDA-event medians of each one-field sphere kernel and its plain
         version, and of raster_fast at B = 128 and 1024 on the 128 x 128
         grid and at B = 32 on the 640 x 640 canvas;
 11. launch limits: the three raster kernels at B = 65,537 (8 hands'
     planes, repeated) and the fused sphere kernels (forward, primal,
     backward) at N = 65,538 (phase 6's 25 hands repeated to B = 7,282 at V
     = 3); a few images at each end against their plain versions, held as in
     phases 3 and 6, and the first images equal to a launch of those alone;
 12. the engine on NYU-format shards (EngineConfig defaults: 48 synthetic
     + 25 x 3 real, eval batch 8, one stack, the full mesh):
     (a) a train split of 100 rendered multi-view hands in two shards and a
         test split of 16, written by data.nyu.write_shard;
     (b) 2 combined epochs (synt_iters_per_epoch 2, mv_curriculum_iters 2:
         both curriculum branches) with device_data off and on: metrics
         finite, every parameter moved, raster_fast_pooled and the fused
         sphere forward and backward launched, the first epoch's batches
         equal under on and off bit for bit, the run directory complete;
     (c) 1 epoch, resume from the rolling latest, 1 more: the restored
         state equal to the saved one bit for bit, the resumed run at epoch
         1 with (b)'s epoch-1 index plan and draws, its last logged loss
         (epoch 1's first step) equal to the saving run's own continuation
         of that step, bit for bit; its loss against (b)'s is printed
         beside (b) on's against (b) off's, the card's run-to-run spread
         (the upsample's backward adds with atomics, and Adam's first steps
         amplify the difference);
     (d) eval of (b)'s last checkpoint (TF32 off): result.npz (16, 36, 3) /
         (16, 41, 3), evaluate_result_file, the fused primal launched, and
         load_estimator's predict within 1e-2 mm of the eval's joints;
     (e) a synthetic-only and a real-only epoch of 2 steps each;
     (f) python -m spherehand_torch --mode Train --epoch 1 on (a)'s shards
         as a subprocess: exit 0 and a checkpoint;
     with steps/s by mode (StepTimer, one rate an epoch) and the host ms a
     batch of the host loader (gather, pinned copy) against the resident
     split's gather;
 13. the engine's single-card switches, combined_term_diag and the priors
     (EngineConfig defaults, the shipped weights, TF32 off where a
     comparison is made):
     (a) the lite mesh (1,700 faces) at B = 128: raster_fast_pooled and
         raster_exact bit for bit against their plain versions; lite against
         full on the same poses (IoU > 0.97, interior median < 0.5 mm, p95 <
         5 mm: tests/test_lite_mesh.py's bar); render_depth_64 CUDA-event ms,
         full and lite in turns; 3 synthetic steps on the lite mesh;
     (b) bf16: 3 combined steps from the f32 run's state and draws, losses
         finite, parameters and Adam moments float32, the fused sphere
         forward and backward launched 3 times each, the first step's loss
         within 2e-2 of the f32 run's (tests/test_torch_switches.py's bound);
     (c) depth_resample 3 and 5: a combined and a real-only step each, the
         kept share of pixels;
     (d) combined_term_diag: at the default widths its per-term gradients
         sum to combined_grads' norm within 1e-4 and the fused sphere
         backward runs once per term that reaches it; card against CPU at
         phase 8's geometry, every term's value and gradient norm within 5 %,
         the largest gap named;
     (e) train_pose_vae and train_pose_denoiser, 200 steps at batch 128, the
         last loss below the first; build_pca_prior's core over 2^16 poses,
         card against CPU (mean within 1e-3 mm, top-10 |cos| >= 0.999); the
         shipped PCA prior's loss on 128 skeletons;
     (f) segment_depth on 128 rendered hands equal to the CPU's;
     and python -m spherehand_torch --mesh lite --bf16 --depth_resample 3
     --epoch 1 on 50 rendered hands as a subprocess: exit 0, a checkpoint,
     finite records;
 14. data parallelism on the one card this script needs (NCCL between two
     cards is not run here):
     (a) 2 gloo ranks sharing the card (spawned, file rendezvous,
         spherehand_torch.parallel.check) against one device: combined_grads
         at 8 synthetic + 3 x 3 real rows, the real batch padded to 4 (one
         row at weight 0), real_aug off, TF32 off: the loss within 1e-5
         relative and each term within 1e-5 of the loss, every gradient within 5e-3 of its tensor's largest
         entry; 2 combined steps leave both ranks' parameters equal bit for
         bit; the combined step's CUDA-event ms at 48 + 25 x 3 on each rank
         and on one device, and the gloo gradient sum's;
     (b) the engine as 2 ranks on the card through the CLI under python -m
         torch.distributed.run --nproc_per_node 2 (gloo), on shards of 75 + 16
         of phase 12's rendered hands at the default widths (24 + 24
         synthetic, 13 + 13 real rows, one pad row): 3 combined steps with
         finite records, parameters equal on both ranks bit for bit, one
         checkpoint by rank 0, raster_fast_pooled and the fused sphere
         forward and backward launched in each rank; then --mode Test on 2
         ranks: result.npz of the test split's 16 rows, the fused primal
         launched in each rank, joints within 1e-2 mm of one rank's eval of
         the same checkpoint (eval_precision highest);
     (c) one NCCL rank: combined_grads' loss and terms equal the ungrouped
         call's bit for bit and NCCL's sum returns the gradients bit for
         bit (the gradients' gap to the ungrouped backward printed beside a
         second ungrouped backward's, the card's atomics);
     (d) PoseEstimator(devices=[cuda:0, cuda:0]) at B = 257, serve_chunk
         128, precision "highest": within 1e-3 mm of one device, pad rows
         gone;
     (e) python -m spherehand_torch.doctor: every check passes;
 15. python -m spherehand_torch.bench once: its line holds every key of
     bench.py plus the card's name and power limit, all numbers finite;
 16. the evidence path (spherehand_torch.tools) at the full widths, short:
     (1) train_synthetic_full, 200 steps at 48 on the StepLR thirds, its
         checkpoint, flat params and history; the mean loss of the last 20
         steps below the first 20's;
     (2) eval_synthetic on 256 held-out noisy hands from that checkpoint,
         and from the shipped weights (under phase 4's 25 mm);
     (3) the shipped weights in the reference's layout
         (convert.reference_state_from_hourglass) saved as a .pth in a
         {"state_dict"} envelope with module. prefixes, imported by
         import_torch_checkpoint: parameters equal to the shipped ones bit
         for bit, joints within 1e-4 mm of phase 4's estimator on its crops;
     (4) generate_pseudo_nyu of 256 train and 64 test hands through the
         shifted sensor (the fast raster), self-check under 0.5 mm;
     (5) selfsup_demo from the shipped weights, one epoch over those
         shards, then again with --no_mv: before and after finite;
     (6) parity_eval of (3)'s .pth over the test shards;
     (7) lite_mesh_e2e --arms lite,full --steps 100;
     (8) with the evidence tools' deterministic settings
         (utils.determinism), selfsup_demo's loop twice from one seed, 2
         epochs of (4)'s shards at the full widths (20 combined steps): the
         adapted parameters' hashes and after_mm equal, bit for bit;
     (9) interactive_viewer.render_views of three poses on the card, the
         sphere map within 1e-3 mm of the CPU's and the mesh's coverage IoU
         against the CPU's over 0.99;
     raster_fast_pooled, the fused sphere forward, backward and primal,
     min_depth_primal and both upsample kernels launched by this phase,
     each sub-step's seconds printed;
 17. the upsample kernels (csrc/upsample.cu) at the hourglass's shapes,
     (B, 256, 4, 4) and (B, 256, 8, 8) for B = 48, 75, 128 and 1,024, in
     float32 and bfloat16: the forward against upsample2x_plain bit for bit;
     the backward against the plain gather bit for bit, two launches bit for
     bit, and against autograd through the plain forward in float32 within
     1e-6 of its largest |grad| (bfloat16: within one rounding, 2^-8 of each
     element, + 1e-6 of the largest); CUDA-event medians of 20 calls of each
     kernel beside F.interpolate's forward and backward (the library
     yardstick; the port never calls it), the plain versions and the
     bound; launches a predict at B = 128, a synthetic and a combined step;
     predict at B = 128 and the three steps re-timed as phase 9 does;
 18. the recipe trio (spherehand_torch/tools/reference_recipe,
     recipe_artifact, divergence_study) under the tools' deterministic
     settings, small: pseudo-NYU 256 + 64 hands; reference_recipe 2 epochs
     uninterrupted, and stopped after its first epoch then resumed from its
     rolling checkpoint: trajectories and parameter hashes equal bit for
     bit, every eval finite; recipe_artifact over the two runs and over the
     stopped run's state file (finished false); divergence_study's
     instrumented stock probe and lr_1e-4, 1 epoch each, a diag and an eval
     every 5 steps, finite; combined_term_diag on the recipe's first 3
     samples card against CPU within phase 13d's 5 % (8 + 3 x 3, TF32 off);
     raster_fast_pooled (the pseudo-NYU writer's fast rule), the fused
     sphere forward, backward and primal and both upsample kernels launched
     by this phase, each sub-step's seconds printed.

The last three lines of standard output are the kernels JSON line, the card's
name and power limit, and the result line. Exits non-zero without a GPU. The
process sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts, so that
phase 16 can switch to deterministic algorithms.

Usage: python3 chip_smoke.py [--seed 0]
(``--rank_report DIR -- <CLI arguments>`` is phase 14(b)'s rank mode,
started by torch.distributed.run.)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "assets", "pretrained", "synthetic_params.npz")

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The z-tile kernels (raster_fast_pooled, raster_exact, raster_fast) read the
# projected planes, 9 floats a face (u, v, z of three vertices), and no
# records: their bound counts the planes, the two sample vectors and the
# canvas written once (raster_fast's binning scratch is the design's, not
# the function's). Operations, counted from csrc/raster.cu: a face's setup once
# (sort_face 35, face_box, barycentric_rows 27, the record and the binary
# searches of its box: fast 140, exact 120), each face-sample test (fast: the
# item's lookup over the drain's prefix sum 27 and its row and column 4, w0,
# w1, q 4 each + w2 2 + 3 compares + reciprocal + NaN test + key 2 + atomic
# min 22 = 53; exact: 3 barycentrics 2 each + clamps 6 + w_sum 2 + 1/z sum 5
# + divisions 2 + w_sum and NaN tests 2 + key 2 + atomic min = 26) and, in
# exact mode, each face-column (its lookup 27, edges 8, span bounds 7,
# column parts 6, two binary searches over 64 rows 36 = 84). The scan's
# repeated setup per tile is the design's cost, not the function's, and is
# not counted; raster_fast is counted as the fast kernel, raw.
PLANE_FLOATS_PER_FACE = 9
ZTILE_FAST_OPS = {"face": 140, "test": 53}
ZTILE_EXACT_OPS = {"face": 120, "test": 26, "column": 84}
MAIN_BATCH = 128
BATCHES = (MAIN_BATCH, 1024)
REPS = 20
# Kernel vs plain version, max |diff| in mm. Both kernels round operation
# for operation like their plain versions, so any difference is a fault.
FAST_MAX_ERR = 1e-3
EXACT_MAX_ERR = 1e-3
DEVICE = "cuda"
GRAD_PARITY = os.path.join(ROOT, "tests", "goldens", "grad_parity_ab.npz")
# Operations of the sphere kernels, counted from csrc/sphere.cu; built with
# -fmad=false, so each add and multiply is one instruction (sqrt and division
# count one each here, though IEEE sqrtf and division take several). Depth,
# per covered (pixel, sphere) pair (sq > 1e-2; a sphere that misses the pixel
# gives 100 without arithmetic): 2 sub, 2 mul, 2 sub, compare, max, sqrt,
# sub, select, compare = 12, plus 3 selects of the argmin update (1 in the
# primal kernel, which keeps only the minimum). Distance, per (foreground
# pixel, sphere) pair (a background pixel's result is fixed): p.c 3 mul + 2
# add, 2 p.c, sub, add, max, sqrt, sub, abs, compare = 14, plus 4 selects (1
# in the primal kernel). Backward, per pixel whose winning weight is not 0:
# depth 5 to form its four weighted terms + 4 adds into its sphere's sums,
# distance 4 + 4; per (image, sphere), depth 4 and distance 6 to combine the
# sums. Bytes: the inputs read once (the distance field's target planes
# too), the planes written once; the backward reads its cotangent and weight
# planes and the target at every pixel, but an argmin plane only where a
# term of that field is nonzero (with the cotangents of ones timed here,
# where its weight is), since the gradient needs it nowhere else.
SPHERE_OPS = {"depth": {"fwd": 15, "primal": 13, "bwd": 9},
              "dist": {"fwd": 18, "primal": 15, "bwd": 8}}
SPHERE_BWD_OPS_SPHERE = {1: 4, 2: 6, 3: 10}
# The TPU kernels each sphere kernel replaces (render/sphere_pallas.py lines).
SPHERE_SOURCES = {3: {"primal": 227, "fwd": 253, "bwd": 308},
                  1: {"primal": 99, "fwd": 70, "bwd": 118},
                  2: {"primal": 179, "fwd": 143, "bwd": 200}}
SERVING_KERNELS = ("raster_fast_pooled", "raster_exact")
FUSED_SPHERE_KERNELS = ("sphere_fused_primal", "sphere_fused_fwd", "sphere_fused_bwd")
PER_FIELD_KERNELS = tuple(f"{f}_{k}" for f in ("min_depth", "d2m") for k in ("primal", "fwd", "bwd"))
# Unfused against fused mutual-projection loss on the card
# (tests/test_sphere_pallas.py:231-235): value relative, joint gradient
# against the largest entry.
UNFUSED_LOSS_REL = 1e-6
UNFUSED_GRAD_REL = 2e-5
# kernel_parity against the TPU's recorded contract: the fast rule against
# the exact one (raster_pallas.py:81-96) and the loss-stack fixture against
# tests/goldens/tpu_sphere_parity.npz (tests/test_sphere_pallas.py:278-280).
FAST_IOU_MIN = 0.999
FAST_P99_MAX = 0.5
FASTPOOL_MEDIAN_MAX = 0.05
ADVERSARIAL_FLIP_MAX = 0.01
STACK_LOSS_REL = 2e-4
STACK_GRAD_NORM_REL = 1e-3
SPHERE_PARITY = os.path.join(ROOT, "tests", "goldens", "tpu_sphere_parity.npz")
PLAIN_REPS = 5
# raster_fast on the whole canvas: the reference renders 640 x 640
# (mesh/render.py:282-331), which JAX runs as 80 tiles of 8.
CANVAS = 640
CANVAS_BATCH = 32
CANVAS_CHECK_BATCH = 4
# Launch limits: past 65,535 images, where gridDim.y or .z would stop.
LIMIT_BATCH = 65_537
LIMIT_SPHERE_HANDS = 7_282  # N = 7,282 x 3 x 3 = 65,538
LIMIT_CHECK = 3  # images (raster) or hands (sphere) checked at each end
# GPU vs CPU combined_grads (TF32 off on the card): loss terms within 1e-3
# relative; per-tensor gradient norms within 5 %, the bound
# tests/test_grad_parity.py puts on float32 accumulation order amplified
# through GroupNorm and the mutual-projection silhouettes.
GPU_CPU_TERM_REL = 1e-3
GPU_CPU_GNORM_REL = 5e-2
TRAIN_STEPS = 3
# Phase 12: served joints against the eval step's (phase 4's serving limit).
EVAL_SERVE_MAX_MM = 1e-2
ENGINE_SPLITS = {"train": (50, 50), "test": (16,)}
FEED_EPOCHS = 5
# Phase 13. Lite against full render: tests/test_lite_mesh.py:122-160.
LITE_IOU_MIN = 0.97
LITE_MEDIAN_MAX = 0.5
LITE_P95_MAX = 5.0
# bf16 against f32, the first combined step's loss from the shipped weights:
# the bound of tests/test_torch_switches.py (BF16_LOSS_REL; measured 4e-4 to
# 3.3e-3 on the CPU at 2 + 1 x 3).
BF16_LOSS_REL = 2e-2
# combined_term_diag: the per-term gradients against combined_grads' (the
# JAX test's bound, tests/test_term_diag.py), and each term's value and
# gradient norm card against CPU (the 5 % of phase 8's gradient norms).
TERM_SUM_REL = 1e-4
TERM_GPU_CPU_REL = 5e-2
SPHERE_TERMS = ("mv_projection",)  # the terms whose backward reaches the fused sphere op
PRIOR_STEPS = 200
PRIOR_BATCH = 128
PCA_SAMPLES = 2 ** 16
PCA_BATCH = 4096
PCA_MEAN_MAX = 1e-3  # mm
PCA_COS_MIN = 0.999
# Phase 14: data parallelism on the one card. (a) 2 gloo ranks against one
# device at 8 synthetic + 3 x 3 real rows (padded to 4): the loss relative
# (each term against the loss), gradients against their tensor's largest entry (JAX's bound,
# tests/test_parallel.py:138-155); (b) the engine as 2 ranks over shards of
# phase 12's hands cut to 3 combined steps (75 train samples), eval against
# one rank's eval of the same checkpoint (phase 12's limit); (d) serving
# over 2 replicas at B = 2 x 128 + 1 against one device.
P14_SYNT = 8
P14_CHECKS = ("grads", "steps", "timing")
P14_LOSS_REL = 1e-5
P14_SPLITS = {"train": (38, 37), "test": (16,)}
P14_TRAIN_KERNELS = ("raster_fast_pooled", "sphere_fused_fwd", "sphere_fused_bwd")
P14_EVAL_KERNELS = ("sphere_fused_primal",)
P14_EVAL_MM = 1e-2
P14_SERVE = 257
P14_SERVE_CHUNK = 128
P14_SERVE_MM = 1e-3
P14_TIMEOUT_S = 300
P15_TIMEOUT_S = 600
# Phase 16: the evidence path at the full widths (synt_batch 48, real 25 x
# 3, eval batch 8), short: 200 synthetic steps (loss of the last 20 below
# the first 20's), 256 held-out hands (the shipped weights under phase 4's
# 25 mm), the reference-layout import (parameters bit for bit, joints within
# 1e-4 mm of phase 4's estimator on its crops), pseudo-NYU 256 + 64 hands
# (self-check under 0.5 mm), one adaptation epoch with and without the
# multi-view terms, the parity drill, 100 steps a lite / full arm.
P16_SYNT_STEPS = 200
P16_LOSS_WINDOW = 20
P16_HELDOUT = 256
P16_SHIPPED_MM = 25.0
P16_IMPORT_MM = 1e-4
P16_TRAIN, P16_TEST = 256, 64
P16_SELF_CHECK_MM = 0.5
P16_LITE_STEPS = 100
P16_KERNELS = ("raster_fast_pooled", "sphere_fused_fwd", "sphere_fused_bwd",
               "sphere_fused_primal", "min_depth_primal", "upsample2x_fwd", "upsample2x_bwd")
P16_REPEAT_EPOCHS = 2  # 2 x 256 / 25 = 20 combined steps
P16_VIEWER_SPHERE_MM = 1e-3
P16_VIEWER_IOU = 0.99
# Phase 18: the recipe trio at a small size under the tools' deterministic
# settings: pseudo-NYU 256 + 64 hands, reference_recipe 2 epochs (10
# combined steps each at 25) uninterrupted and stopped after its first
# epoch then resumed (equal bit for bit), recipe_artifact over the two runs
# (and over the stopped one's state file), divergence_study's instrumented
# probe and lr_1e-4, 1 epoch each (a diag and an eval every 5 steps);
# combined_term_diag on the first recipe batch, card against CPU within
# phase 13d's 5 % (at 8 synthetic + 3 x 3 real, TF32 off).
P18_TRAIN, P18_TEST = 256, 64
P18_EPOCHS = 2
P18_DIAG_EVERY = 5
P18_DIAG_REAL = 3
P18_KERNELS = ("raster_fast_pooled", "sphere_fused_fwd", "sphere_fused_bwd",
               "sphere_fused_primal", "upsample2x_fwd", "upsample2x_bwd")
P18_PROBES = ("stock_instrumented", "lr_1e-4")
# Phase 17: the upsample kernels at the hourglass's shapes: (B, 256, 4, 4)
# and (B, 256, 8, 8) (HourglassNet runs at 16 x 16 after its stem), for the
# synthetic step's 48, the eval's 25 x 3, serving's 128 and the bench's
# 1,024. Backward against autograd through the plain forward: float32
# within 1e-6 of the largest |grad| (the sums' order differs); bfloat16 one
# rounding of each element (unit roundoff 2^-8) on top. Operations, counted
# from csrc/upsample.cu: the forward 9 an output element (6 products, 3
# sums), the backward 35 an input element (4 rows of 4 products and 3 sums,
# then 4 and 3); bytes: the input read once, the output written once.
P17_BATCHES = (48, 75, MAIN_BATCH, 1024)
P17_SIZES = (4, 8)
P17_CHANNELS = 256
P17_BWD_REL = 1e-6
P17_BF16_ROUNDING = 2.0 ** -8
UPSAMPLE_OPS = {"fwd": 9, "bwd": 35}
UPSAMPLE_SOURCE = "spherehand_tpu/models/hourglass.py:86"
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "mesh", "full_exact_fps", "lite_fps",
              "lite_exact_fps", "train_combined_steps_per_sec",
              "train_combined_bf16_steps_per_sec", "train_epoch_steps_per_sec",
              "train_epoch_bf16_steps_per_sec", "batch", "health_dispatch_rtt_ms",
              "health_device_get_mbps", "gpu_name", "gpu_power_limit")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def box_samples(box, sample_x, sample_y) -> tuple[torch.Tensor, torch.Tensor]:
    """Per kept face, the sample columns and rows inside its box."""
    sx, sy = sample_x.contiguous(), sample_y.contiguous()
    nx = (torch.searchsorted(sx, box[..., 1].contiguous(), right=True)
          - torch.searchsorted(sx, box[..., 0].contiguous(), right=False)).clamp(min=0)
    ny = (torch.searchsorted(sy, box[..., 3].contiguous(), right=True)
          - torch.searchsorted(sy, box[..., 2].contiguous(), right=False)).clamp(min=0)
    return nx, ny


def ztile_bound(box, sample_x, sample_y, out_numel: int, ops: dict) -> tuple:
    """Bound of a z-tile kernel on one geometry: the planes, both sample
    vectors and the canvas once; its face setups, face-sample tests and
    (exact) face-columns, from the plain pre-pass's boxes."""
    batch, num_faces = box.shape[:2]
    nx, ny = box_samples(box, sample_x, sample_y)
    count = {"face": batch * num_faces, "test": int((nx * ny).sum()),
             "column": int((nx * (ny > 0)).sum())}
    bytes_moved = 4 * (PLANE_FLOATS_PER_FACE * batch * num_faces + sample_x.numel()
                       + sample_y.numel() + out_numel)
    return bound(bytes_moved, sum(n * count[k] for k, n in ops.items())), count


def max_abs_diff(a, b) -> float:
    """max |a - b|, where equal values (infinities too) count 0."""
    return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())


def launch_limits(raster_cuda, sc, hand_planes, samples, centers, target, radii, size: int,
                  views: int) -> None:
    """Phase 11: the raster kernels at LIMIT_BATCH images and the fused
    sphere kernels at LIMIT_SPHERE_HANDS x views x views images, past the
    65,535 that gridDim.y and .z allow. The first and last images against
    their plain versions (raster: raw fast and pooled bit for bit, exact by
    the exact contract; sphere: as phase 6, the backward against the plain
    backward on the same images), and the first against a launch of those
    images alone, bit for bit."""
    from spherehand_torch.render import contracts
    from spherehand_torch.render.raster import rasterize_depth

    _, _, few = hand_planes(8, 0)
    reps = -(-LIMIT_BATCH // 8)
    planes = tuple(p.repeat(reps, 1)[:LIMIT_BATCH].contiguous() for p in few)
    ends = torch.cat([torch.arange(LIMIT_CHECK), torch.arange(LIMIT_BATCH - LIMIT_CHECK,
                                                              LIMIT_BATCH)]).to(samples.device)
    part = tuple(p[ends].contiguous() for p in planes)
    fv = torch.stack(part, dim=-1).reshape(part[0].shape[0], -1, 3, 3)
    s = samples
    runs = {
        "raster_fast": (lambda p: raster_cuda.launch_raster_fast(p, s, s),
                        lambda: raster_cuda.raster_fast_plain(
                            *raster_cuda.prepass_fast(planes=part), s, s)),
        "raster_fast_pooled": (lambda p: raster_cuda.launch_raster_fast_pooled(p, s, s, 100.0),
                               lambda: raster_cuda.raster_fast_plain(
                                   *raster_cuda.prepass_fast(planes=part), s, s, 100.0)),
        "raster_exact": (lambda p: raster_cuda.launch_raster_exact(p, s, s, 640, 640),
                         lambda: rasterize_depth(fv, s, s)),
    }
    report = {}
    for name, (launch, plain) in runs.items():
        full = launch(planes)[ends]
        alone = launch(tuple(p[:LIMIT_CHECK].contiguous() for p in planes))
        ref = plain()
        torch.cuda.synchronize()
        if name == "raster_exact":
            st = contracts.exact_stats(full, ref)
            ok = contracts.exact_ok(st) and st["max_abs_err"] <= EXACT_MAX_ERR
        else:
            ok = contracts.same_bits(full, ref)
        ok = ok and contracts.same_bits(full[:LIMIT_CHECK], alone)
        report[name] = max_abs_diff(full, ref)
        if not ok:
            fail(f"{name} at B={LIMIT_BATCH}: images {ends.tolist()} vs plain max |diff| "
                 f"{report[name]}, or not equal to a launch of the first {LIMIT_CHECK} alone")
        del full, alone
    del planes
    torch.cuda.empty_cache()

    hands = centers.shape[0] // (views * views)
    pick = torch.arange(LIMIT_SPHERE_HANDS, device=centers.device) % hands
    big_c = centers.reshape(hands, views * views, *centers.shape[1:])[pick].reshape(
        -1, *centers.shape[1:]).contiguous()
    big_t = target.reshape(hands, views, *target.shape[1:])[pick].reshape(
        -1, *target.shape[1:]).contiguous()
    n = big_c.shape[0]
    k = sc.num_fields(sc.BOTH)
    args = (sc.BOTH, big_c, big_t, radii, size, views)
    fwd = sc.launch_fields(*args, residuals=True)
    primal = sc.launch_fields(*args, residuals=False)
    grads = [torch.ones_like(p) for p in fwd[:k]]
    bwd = sc.launch_fields_bwd(sc.BOTH, big_c, big_t, views, grads, fwd[k:])
    img = views * views
    for first_hand in (0, LIMIT_SPHERE_HANDS - LIMIT_CHECK):
        sl = slice(first_hand * img, (first_hand + LIMIT_CHECK) * img)
        tl = slice(first_hand * views, (first_hand + LIMIT_CHECK) * views)
        c, t = big_c[sl].contiguous(), big_t[tl].contiguous()
        p_fwd = sc.fields_plain(sc.BOTH, c, t, radii, size, views, residuals=True)
        p_primal = sc.fields_plain(sc.BOTH, c, t, radii, size, views, residuals=False)
        p_bwd = sc.fields_bwd_plain(sc.BOTH, c, t, views, [g[sl] for g in grads],
                                    [r[sl] for r in fwd[k:]])
        torch.cuda.synchronize()
        st = contracts.sphere_fwd_stats([x[sl] for x in fwd], p_fwd, k)
        st["primal_max_abs_err"] = max(max_abs_diff(a[sl], b) for a, b in zip(primal, p_primal))
        st["bwd_rel_plain"] = max_abs_diff(bwd[sl], p_bwd) / float(p_bwd.abs().max())
        report[f"sphere N={n} hands {first_hand}.."] = st
        if not (st["fields_max_abs_err"] == 0.0 and st["argmin_mismatch"] == 0
                and st["weight_ulps"] <= contracts.SPHERE_WEIGHT_ULPS
                and st["primal_max_abs_err"] == 0.0
                and st["bwd_rel_plain"] <= contracts.SPHERE_BWD_REL):
            fail(f"fused sphere kernels at N={n}, hands {first_hand}..: {st}")
    log(f"[11] launch limits: rasters at B={LIMIT_BATCH}, fused sphere kernels at N={n}; "
        f"end images vs plain: {json.dumps(report)}")
    del fwd, primal, bwd, big_c, big_t
    torch.cuda.empty_cache()


def engine_phase(model, dev, seed: int, smi: str) -> None:
    """Phase 12: the engine, checkpoints, eval and the CLI on NYU-format
    shards of rendered hands, at the EngineConfig defaults."""
    import shutil
    import tempfile

    from spherehand_torch.data.nyu import NyuDataset, write_shard
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.evaluation.offline import evaluate_result_file
    from spherehand_torch.infer import load_estimator
    from spherehand_torch.render import raster_cuda, sphere_cuda
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    def reset():
        torch.cuda.synchronize()
        raster_cuda.reset_launch_counts()
        sphere_cuda.reset_launch_counts()

    def launched(names, tag) -> dict:
        torch.cuda.synchronize()
        counts = {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES}
        missing = [n for n in names if counts[n] < 1]
        if missing:
            fail(f"[12{tag}] kernels {missing} were not launched: {counts}")
        return {n: counts[n] for n in names}

    def records(engine) -> list[dict]:
        with open(engine.metrics_file) as f:
            return [json.loads(line) for line in f]

    def finite(engine, tag) -> list[dict]:
        recs = records(engine)
        bad = [r for r in recs if not all(np.isfinite(v) for v in r.values()
                                          if isinstance(v, float))]
        if not recs or bad:
            fail(f"[12{tag}] metrics missing or not finite: {bad or recs}")
        return recs

    def snapshot(state) -> dict:
        opt = state.optimizer.state_dict()["state"]
        return {"network": {k: v.clone() for k, v in state.network.state_dict().items()},
                "optimizer": {f"{i}/{k}": v.clone() for i, s in opt.items() for k, v in s.items()},
                "step": state.step, "prev_skel": state.prev_skel.clone(),
                "has_prev": state.has_prev.clone()}

    def same_state(a, b) -> bool:
        return (a["step"] == b["step"] and torch.equal(a["prev_skel"], b["prev_skel"])
                and torch.equal(a["has_prev"], b["has_prev"])
                and all(a[part].keys() == b[part].keys()
                        and all(torch.equal(v, b[part][k]) for k, v in a[part].items())
                        for part in ("network", "optimizer")))

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        # ----------------------------------------------------------- (a)
        gen = torch.Generator(device=dev).manual_seed(seed + 20)
        data, small = os.path.join(tmp, "nyu"), os.path.join(tmp, "nyu_small")
        for subset, sizes in ENGINE_SPLITS.items():
            os.makedirs(os.path.join(data, subset))
            for i, n in enumerate(sizes):
                real = render_multiview_batch(model, gen, n)
                write_shard(os.path.join(data, subset), f"mv_data_{i}",
                            *(x.cpu().numpy() for x in (real.dms, real.gt_joints, real.poses)))
        shutil.copytree(os.path.join(data, "test"), os.path.join(small, "train"))
        sizes = {k: len(NyuDataset(os.path.join(data, k))) for k in ENGINE_SPLITS}
        log(f"[12a] shards: {sizes} samples, 64 x 64 x 3 views "
            f"({time.perf_counter() - t_phase:.2f} s)")

        # ----------------------------------------------------------- (b)
        model_dir = os.path.join(tmp, "runs")
        base = dict(mode="Train", model_dir=model_dir, dataset_dir=data, epoch=2,
                    synt_iters_per_epoch=2, mv_curriculum_iters=2)
        cfg = EngineConfig(**base)
        runs, rates = {}, {}
        for mode in ("off", "on"):
            eng = Engine(EngineConfig(**base, device_data=mode, tag=f"b_{mode}_"), device=dev,
                         hand=model)
            before = [p.detach().clone() for p in eng.state.network.parameters()]
            reset()
            t0 = time.perf_counter()
            eng.train()
            counts = launched(("raster_fast_pooled", "sphere_fused_fwd", "sphere_fused_bwd"),
                              f"b {mode}")
            train_s = time.perf_counter() - t0
            recs = finite(eng, f"b {mode}")
            moved = sum(not torch.equal(a, b) for a, b in zip(before, eng.state.network.parameters()))
            files = ("metrics.jsonl", "log.txt", "loss_weights.txt", "model_-1.pt", "model_0.pt",
                     "model_1.pt")
            missing = [f for f in files if not os.path.exists(os.path.join(eng.model_path, f))]
            if moved != len(before) or missing or eng.state.step != 8:
                fail(f"[12b] device_data {mode}: moved {moved}/{len(before)}, step "
                     f"{eng.state.step}, missing {missing}")
            runs[mode] = eng
            rates[f"both ({mode})"] = eng.steps_per_sec["both"]
            log(f"[12b] device_data {mode}: {eng.state.step} steps in {train_s:.2f} s, launches "
                f"{json.dumps(counts)}, parameters moved {moved}/{len(before)}; last record "
                f"{json.dumps(recs[-1])}")
        pairs = list(zip(runs["off"].batches(True, cfg.real_batch, 0),
                         runs["on"].batches(True, cfg.real_batch, 0)))
        equal = all(np.array_equal(i_off, i_on) and all(
            (x is None and y is None) or torch.equal(x, y) for x, y in zip(b_off, b_on))
            for (i_off, b_off), (i_on, b_on) in pairs)
        if len(pairs) != 4 or not equal:
            fail(f"[12b] epoch 0's batches under device_data on differ from off ({len(pairs)})")
        feed = {}
        for mode, eng in runs.items():
            feed[mode] = []
            for epoch in range(FEED_EPOCHS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = sum(1 for _ in eng.batches(True, cfg.real_batch, epoch))
                torch.cuda.synchronize()
                feed[mode].append((time.perf_counter() - t0) * 1e3 / n)
        log(f"[12b] epoch 0's {len(pairs)} batches equal under device_data on and off, bit for "
            f"bit; host ms "
            f"a batch (gather + pinned copy, off; index copy + gather on the card, on), one "
            f"value an epoch: {json.dumps(feed)}")

        # ----------------------------------------------------------- (c)
        first = Engine(EngineConfig(**{**base, "epoch": 1}, device_data="off", tag="c_"),
                       device=dev, hand=model)
        first.train()
        saved = snapshot(first.state)
        resumed = Engine(EngineConfig(**base, device_data="off",
                                      restore_from_model=first.model_name),
                         device=dev, hand=model)
        if not same_state(snapshot(resumed.state), saved) or resumed.starting_epoch != 1:
            fail(f"[12c] restored state differs from the saved one, or starts at epoch "
                 f"{resumed.starting_epoch}")
        b_off = runs["off"]
        plan, plan_b = (e.index_plan(True, cfg.real_batch, 1) for e in (resumed, b_off))
        same_plan = len(plan) == len(plan_b) and all(map(np.array_equal, plan, plan_b))

        def flat(draws):
            out = []
            for x in draws:
                if isinstance(x, torch.Tensor):
                    out.append(x)
                elif x is not None:
                    out += flat(x)
            return out

        same_draws = all(all(torch.equal(x, y) for x, y in zip(flat(resumed.step_draws(1, it)),
                                                               flat(b_off.step_draws(1, it))))
                         for it in range(len(plan)))
        if not (same_plan and same_draws):
            fail(f"[12c] epoch 1's index plan ({same_plan}) or draws ({same_draws}) differ")
        # The uninterrupted run's continuation of the saved state: its first
        # step of epoch 1, which the resumed run's last record logs.
        feed = first.batches(True, cfg.real_batch, 1)
        _, batch1 = next(feed)
        feed.close()
        twin_loss = float(first.combined_step(1, 0, batch1)[0]["loss"])
        resumed.train()
        recs_c, recs_b, recs_on = finite(resumed, "c"), records(b_off), records(runs["on"])
        loss_c, loss_b = recs_c[-1]["loss"], recs_b[-1]["loss"]
        rel_b = abs(loss_c - loss_b) / abs(loss_b)
        rel_on = abs(recs_on[-1]["loss"] - loss_b) / abs(loss_b)
        param_diff = max(float((a - b).abs().max()) for a, b in
                         zip(resumed.state.network.state_dict().values(),
                             b_off.state.network.state_dict().values()))
        rates["both (resumed)"] = resumed.steps_per_sec["both"]
        log(f"[12c] restored state equal to the saved one bit for bit; resumed at epoch 1 with "
            f"(b)'s index plan and draws; last logged loss {loss_c!r}, the uninterrupted "
            f"continuation's {twin_loss!r}; against (b) off's {loss_b!r}: rel {rel_b:.3g} "
            f"((b) on against (b) off, the same math: rel {rel_on:.3g}); final parameters max "
            f"|diff| vs (b) off {param_diff:.3g}")
        if not (recs_c[-1]["epoch"] == 1 and loss_c == twin_loss):
            fail(f"[12c] resumed run's last record {recs_c[-1]} vs the uninterrupted "
                 f"continuation's loss {twin_loss}")

        # ----------------------------------------------------------- (d)
        ckpt = os.path.join(b_off.model_path, "model_1.pt")
        ev = Engine(EngineConfig(mode="Test", model_dir=model_dir, dataset_dir=data,
                                 initial_model=ckpt, eval_precision="highest", tag="d_"),
                    device=dev, hand=model)
        reset()
        result = ev.eval()
        counts = launched(("sphere_fused_primal",), "d")
        path = os.path.join(ev.model_path, "result.npz")
        with np.load(path) as f:
            gt, est = f["gt"], f["est"]
        n_test = sizes["test"]
        if gt.shape != (n_test, 36, 3) or est.shape != (n_test, 41, 3) or not np.isfinite(est).all():
            fail(f"[12d] result.npz gt {gt.shape} est {est.shape}")
        offline = evaluate_result_file(path, make_plot=False)
        dms = NyuDataset(os.path.join(data, "test")).gather_dms(np.arange(n_test))[:, 0]
        served = load_estimator(ckpt, device=dev, precision="highest").predict(dms)
        serve_diff = float(np.abs(served - est).max())
        log(f"[12d] eval: {json.dumps(result)}; launches {json.dumps(counts)}; result.npz gt "
            f"{gt.shape} est {est.shape}; offline mean error {offline['mean_error']:.4f} mm; "
            f"load_estimator vs eval joints max |diff| {serve_diff:.3g} mm")
        if not (np.isfinite(offline["mean_error"]) and serve_diff <= EVAL_SERVE_MAX_MM):
            fail(f"[12d] offline {offline['mean_error']}, served vs eval {serve_diff} mm")

        # ----------------------------------------------------------- (e)
        no_real = dict(mv_projection=False, mv_consistency=False, collision=False,
                       bone_length=False, prior=False)
        for tag, extra, names in (
            ("synt", dict(no_real), ("raster_fast_pooled",)),
            ("real", dict(synthesize=False, dataset_dir=small),
             ("sphere_fused_fwd", "sphere_fused_bwd")),
        ):
            eng = Engine(EngineConfig(**{**base, "epoch": 1, **extra}, tag=f"e_{tag}_"),
                         device=dev, hand=model)
            reset()
            eng.train()
            counts = launched(names, f"e {tag}")
            recs = finite(eng, f"e {tag}")
            if eng.state.step != 2 or recs[-1]["mode"] != tag:
                fail(f"[12e] {tag}-only epoch: step {eng.state.step}, records {recs}")
            rates[tag] = eng.steps_per_sec[tag]
            log(f"[12e] {tag}-only epoch, 2 steps: launches {json.dumps(counts)}; "
                f"{json.dumps(recs[-1])}")

        # ----------------------------------------------------------- (f)
        cli_dir = os.path.join(tmp, "cli_runs")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "spherehand_torch", "--mode", "Train", "--epoch", "1",
             "--dataset_dir", data, "--model_dir", cli_dir, "--tag", "cli_"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        made = [os.path.join(d, f) for d in (os.listdir(cli_dir) if os.path.isdir(cli_dir) else [])
                for f in ("model_0.pt", "model_-1.pt")
                if os.path.exists(os.path.join(cli_dir, d, f))]
        if run.returncode != 0 or len(made) != 2:
            fail(f"[12f] python -m spherehand_torch exited {run.returncode}, checkpoints {made}:\n"
                 f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
        log(f"[12f] python -m spherehand_torch --mode Train --epoch 1: exit 0 in "
            f"{time.perf_counter() - t0:.2f} s, checkpoints {made}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[12] steps/s by mode (StepTimer, one rate an epoch, the first step of each epoch "
        f"not counted): {json.dumps(rates)} | {smi}; phase {time.perf_counter() - t_phase:.2f} s")


def switches_phase(model, params, samples, dev, seed: int, smi: str) -> None:
    """Phase 13: the engine's single-card switches (the lite mesh, bf16,
    depth_resample), combined_term_diag card against CPU, the prior
    trainers, the PCA prior and segment_depth, at the EngineConfig widths."""
    import shutil
    import tempfile

    from spherehand_torch.data.nyu import write_shard
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis, synthesize, synthesize_from_draws
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.hand import (apply_scale, draw_random_scale, forward_kinematics,
                                       load_hand_model, load_pose_prior_pca,
                                       project_faces_planes, skeleton_fk)
    from spherehand_torch.infer import float32_precision
    from spherehand_torch.losses.pca_prior import pca_prior_loss
    from spherehand_torch.ops.segmentation import segment_depth
    from spherehand_torch.render import contracts, raster_cuda, sphere_cuda
    from spherehand_torch.render.raster import rasterize_depth, render_depth_64
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.priors import (pca_prior_from_poses, train_pose_denoiser,
                                               train_pose_vae)
    from spherehand_torch.train.steps import RESAMPLE_RATIO, RealBatch, build_steps

    def reset():
        torch.cuda.synchronize()
        raster_cuda.reset_launch_counts()
        sphere_cuda.reset_launch_counts()

    def counts() -> dict:
        torch.cuda.synchronize()
        return {k: v for k, v in {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES}.items() if v}

    def finite(tag, metrics) -> dict:
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"[13{tag}] a metric is not finite: {vals}")
        return vals

    def gen(offset: int, device=dev) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed + offset)

    t_phase = time.perf_counter()
    launches = {}
    cfg = EngineConfig()
    real = render_multiview_batch(model, gen(40), cfg.real_batch)
    real_batch = RealBatch(*real[:4])

    # ----------------------------------------------------------- (a)
    lite = load_hand_model(device=dev, lite=True)
    g = gen(41)
    poses = sample_poses(g, MAIN_BATCH)
    sdraws = draw_synthesis(g, MAIN_BATCH)
    tr_lite = apply_scale(forward_kinematics(lite, poses), sdraws.scale_u, 0.1)
    planes = project_faces_planes(lite, tr_lite, 640.0, sdraws.rand_f)
    fv = torch.stack(planes, dim=-1).reshape(MAIN_BATCH, -1, 3, 3)
    checks = {
        "raster_fast_pooled": (raster_cuda.launch_raster_fast_pooled(planes, samples, samples, 100.0),
                               raster_cuda.raster_fast_plain(*raster_cuda.prepass_fast(planes=planes),
                                                             samples, samples, 100.0)),
        "raster_exact": (raster_cuda.launch_raster_exact(planes, samples, samples, 640, 640),
                         rasterize_depth(fv, samples, samples, 640, 640)),
    }
    torch.cuda.synchronize()
    for name, (k, p) in checks.items():
        if not contracts.same_bits(k, p):
            fail(f"[13a] lite mesh: {name} vs its plain version max |diff| "
                 f"{max_abs_diff(k, p)}, not bit for bit")
    reset()
    render_depth_64(lite, tr_lite, sdraws.rand_f)
    render_depth_64(lite, tr_lite, sdraws.rand_f, exact=True)
    launches["a render"] = counts()
    tr_full = forward_kinematics(model, poses)
    tr_plain = forward_kinematics(lite, poses)
    d_full, d_lite = render_depth_64(model, tr_full), render_depth_64(lite, tr_plain)
    fg_f, fg_l = d_full < 99.9, d_lite < 99.9
    iou = float((fg_f & fg_l).sum() / (fg_f | fg_l).sum())
    pad = d_full[:, None]
    rng3 = (torch.nn.functional.max_pool2d(pad, 3, 1, 1)
            + torch.nn.functional.max_pool2d(-pad, 3, 1, 1))[:, 0]
    sel = fg_f & fg_l & (rng3 < 10.0)
    d = (d_full - d_lite).abs()[sel]
    median, p95 = float(d.median()), float(torch.quantile(d, 0.95))
    fidelity = {"iou": iou, "interior_median_mm": median, "interior_p95_mm": p95,
                "interior_pixels": int(sel.sum()), "faces": [model.num_faces, lite.num_faces]}
    if not (iou > LITE_IOU_MIN and median < LITE_MEDIAN_MAX and p95 < LITE_P95_MAX):
        fail(f"[13a] lite against full render: {fidelity}")
    rand_f = sdraws.rand_f
    tr_scaled_full = apply_scale(tr_full, sdraws.scale_u, 0.1)
    timing = {}
    for turn, (tag, hand, tr) in enumerate((("full", model, tr_scaled_full), ("lite", lite, tr_lite),
                                            ("lite", lite, tr_lite), ("full", model, tr_scaled_full))):
        timing[f"{tag}_{turn}"] = time_ms(lambda: render_depth_64(hand, tr, rand_f), REPS)
    fns = build_steps(EngineConfig(mesh="lite"), hand=lite)
    state = train_state_from_params(fns.init_state, params)
    reset()
    for _ in range(TRAIN_STEPS):
        state, m = fns.synt_step(state, cfg.lr, fns.draw(g, real=False))
        last = finite("a", m)
    launches["a synt steps"] = counts()
    log(f"[13a] lite mesh ({lite.num_faces} faces) at B={MAIN_BATCH}: raster_fast_pooled and "
        f"raster_exact bit for bit against their plain versions; against the full mesh "
        f"{json.dumps(fidelity)}; render_depth_64 fast ms in turns (full, lite, lite, full) "
        f"{json.dumps(timing)}; {TRAIN_STEPS} synthetic steps, last {json.dumps(last)}; "
        f"launches {json.dumps({k: launches[k] for k in ('a render', 'a synt steps')})}")

    # ----------------------------------------------------------- (b)
    step_draws = [build_steps(cfg, hand=model).draw(gen(42 + i)) for i in range(TRAIN_STEPS)]
    losses = {}
    for tag, bf16 in (("f32", False), ("bf16", True)):
        fns = build_steps(EngineConfig(bf16=bf16), hand=model)
        state = train_state_from_params(fns.init_state, params)
        reset()
        with float32_precision("highest"):
            losses[tag] = [finite("b", fns.combined_step(state, cfg.lr, d, real_batch, True)[1])
                           ["loss"] for d in step_draws]
        launches[f"b {tag}"] = counts()
    opt_dtypes = {v.dtype for s in state.optimizer.state.values() for k, v in s.items()
                  if k != "step"}
    param_dtypes = {p.dtype for p in state.network.parameters()}
    gap = abs(losses["bf16"][0] - losses["f32"][0]) / abs(losses["f32"][0])
    sb = launches["b bf16"]
    log(f"[13b] bf16: {TRAIN_STEPS} combined steps from the shipped weights and the f32 run's "
        f"draws; losses f32 {losses['f32']} bf16 {losses['bf16']}; first step's relative gap "
        f"{gap:.4g} (bound {BF16_LOSS_REL}); parameters {sorted(map(str, param_dtypes))}, Adam "
        f"moments {sorted(map(str, opt_dtypes))}; launches {json.dumps(sb)}")
    if (gap > BF16_LOSS_REL or param_dtypes != {torch.float32} or opt_dtypes != {torch.float32}
            or sb.get("sphere_fused_fwd") != TRAIN_STEPS
            or sb.get("sphere_fused_bwd") != TRAIN_STEPS):
        fail(f"[13b] bf16: gap {gap}, dtypes {param_dtypes} {opt_dtypes}, launches {sb}")

    # ----------------------------------------------------------- (c)
    for k in (3, 5):
        fns = build_steps(EngineConfig(depth_resample=k), hand=model)
        state = train_state_from_params(fns.init_state, params)
        g = gen(50 + k)
        reset()
        d = fns.draw(g)
        state, m_both, _ = fns.combined_step(state, cfg.lr, d, real_batch, True)
        dr = fns.draw(g, synt=False)
        state, m_real, _ = fns.real_step(state, cfg.lr, dr, real_batch)
        vals = {"combined": finite("c", m_both)["loss"], "real": finite("c", m_real)["loss"]}
        launches[f"c k={k}"] = counts()
        kept = {"real": float((d.resample_real <= RESAMPLE_RATIO).float().mean()),
                "synt": float((d.resample_synt <= RESAMPLE_RATIO).float().mean())}
        log(f"[13c] depth_resample {k}: losses {json.dumps(vals)}; kept share of pixels "
            f"{json.dumps(kept)}; launches {json.dumps(launches[f'c k={k}'])}")

    # ----------------------------------------------------------- (d)
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, params)
    d = fns.draw(gen(60))
    with float32_precision("highest"):
        reset()
        diag = fns.combined_term_diag(state, d, real_batch, True)
        launches["d diag"] = counts()
        _, terms, grads = fns.combined_grads(state, d, real_batch, True)
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    sum_rel = abs(float(diag["total_grad_norm"]) - total) / total
    reaching = [n for n in terms if n in SPHERE_TERMS]
    sd = launches["d diag"]
    log(f"[13d] combined_term_diag at {cfg.synt_batch} + {cfg.real_batch}x3 (TF32 off): the "
        f"per-term gradients sum to combined_grads' norm within {sum_rel:.3g} (bound "
        f"{TERM_SUM_REL}); launches {json.dumps(sd)}; terms reaching the sphere op {reaching}")
    if not (sum_rel <= TERM_SUM_REL and sd.get("sphere_fused_fwd") == 1
            and sd.get("sphere_fused_bwd") == len(reaching)):
        fail(f"[13d] term diag sums {sum_rel}, launches {sd}, reaching {reaching}")
    with np.load(GRAD_PARITY) as gold:
        gp = [np.asarray(gold[k], np.float32) for k in ("real_dms", "real_poses", "real_inv_poses")]
    small = EngineConfig(synt_batch=8, real_batch=gp[0].shape[0])
    side_fns = {"gpu": build_steps(small, hand=model),
                "cpu": build_steps(small, hand=load_hand_model(device="cpu"))}
    draws = side_fns["cpu"].draw(torch.Generator().manual_seed(seed + 61))
    gpu_draws = draws.to(dev)
    synt = synthesize_from_draws(model, gpu_draws.poses, gpu_draws.synthesis)
    sides = {}
    t0 = time.perf_counter()
    for side, sdev in (("gpu", dev), ("cpu", torch.device("cpu"))):
        sfns = side_fns[side]
        sstate = train_state_from_params(sfns.init_state, params)
        sbatch = RealBatch(*(torch.as_tensor(a, device=sdev) for a in
                             (gp[0], np.zeros(gp[0].shape[:2] + (36, 3), np.float32), gp[1], gp[2])))
        with float32_precision("highest"):
            sdiag = sfns.combined_term_diag(sstate, draws.to(sdev), sbatch, True,
                                            synt=type(synt)(*(x.to(sdev) for x in synt)))
        sides[side] = {k: float(v) for k, v in sdiag.items()}
    gaps = {}
    for key, ref in sides["cpu"].items():
        if key.endswith("/cos_total"):
            continue
        got = sides["gpu"][key]
        gaps[key] = 0.0 if got == ref else abs(got - ref) / max(abs(ref), 1e-30)
    worst = max(gaps, key=gaps.get)
    log(f"[13d] card against CPU at 8 + {gp[0].shape[0]}x3 (grad_parity_ab's real batch, TF32 "
        f"off, {time.perf_counter() - t0:.2f} s): relative gaps {json.dumps(gaps)}; largest "
        f"{worst} {gaps[worst]:.4g} (bound {TERM_GPU_CPU_REL}); card {json.dumps(sides['gpu'])}")
    if gaps[worst] > TERM_GPU_CPU_REL:
        fail(f"[13d] card against CPU term gap {worst} {gaps[worst]}")

    # ----------------------------------------------------------- (e)
    t0 = time.perf_counter()
    trained = {}
    for tag, train in (("vae", train_pose_vae), ("denoiser", train_pose_denoiser)):
        _, loss = train(model, steps=PRIOR_STEPS, batch=PRIOR_BATCH, seed=seed, log_every=0)
        loss = loss.cpu()
        trained[tag] = [float(loss[0]), float(loss[-1])]
        if not (bool(torch.isfinite(loss).all()) and loss[-1] < loss[0]):
            fail(f"[13e] {tag}: losses {loss.tolist()[:3]} ... {loss.tolist()[-3:]}")
    train_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(seed + 62)
    batches = [sample_poses(g, PCA_BATCH) for _ in range(PCA_SAMPLES // PCA_BATCH)]
    t0 = time.perf_counter()
    pca = {"gpu": pca_prior_from_poses(model, batches, 30)}
    pca_s = time.perf_counter() - t0
    pca["cpu"] = pca_prior_from_poses(load_hand_model(device="cpu"), batches, 30)
    mean_diff = float(np.abs(pca["gpu"][0] - pca["cpu"][0]).max())
    cos = np.abs(np.sum(pca["gpu"][1][:10] * pca["cpu"][1][:10], axis=1))
    mean, comp = load_pose_prior_pca(device=dev)
    g = gen(63)
    skel = skeleton_fk(model, sample_poses(g, PRIOR_BATCH), draw_random_scale(g, PRIOR_BATCH))
    prior = float(pca_prior_loss(mean, comp, skel))
    prior_cpu = float(pca_prior_loss(mean.cpu(), comp.cpu(), skel.cpu()))
    log(f"[13e] {PRIOR_STEPS} steps at batch {PRIOR_BATCH} (first, last loss): "
        f"{json.dumps(trained)} in {train_s:.2f} s; build_pca_prior over {PCA_SAMPLES} samples "
        f"({pca_s:.2f} s on the card): mean max |diff| card vs CPU {mean_diff:.3g} mm, top-10 "
        f"|cos| min {float(cos.min()):.6f}; the shipped PCA prior's loss on {PRIOR_BATCH} "
        f"skeletons {prior!r} (CPU {prior_cpu!r})")
    if not (mean_diff <= PCA_MEAN_MAX and cos.min() >= PCA_COS_MIN and np.isfinite(prior)
            and abs(prior - prior_cpu) <= 1e-4 * abs(prior_cpu)):
        fail(f"[13e] PCA card vs CPU: mean {mean_diff}, cos {cos}, prior {prior} {prior_cpu}")

    # ----------------------------------------------------------- (f)
    g = gen(64)
    synt = synthesize(model, g, sample_poses(g, MAIN_BATCH))
    dms_mm = synt.dms * 100.0
    seg = segment_depth(dms_mm, synt.xyz)
    seg_cpu = segment_depth(dms_mm.cpu(), synt.xyz.cpu())
    differ = int((seg.cpu() != seg_cpu).sum())
    cut = float(((seg == 100.0) & (dms_mm < 100.0)).float().sum() / (dms_mm < 100.0).sum())
    log(f"[13f] segment_depth on {MAIN_BATCH} rendered hands: {differ} pixels differ from the "
        f"CPU's; share of foreground cut to background {cut:.4g}")
    if differ:
        fail(f"[13f] segment_depth card vs CPU: {differ} pixels differ")

    # ------------------------------------------------------------- CLI
    tmp = tempfile.mkdtemp(prefix="chip_smoke_switches_")
    try:
        g = gen(65)
        data = os.path.join(tmp, "nyu")
        for subset, n in (("train", 2 * cfg.real_batch), ("test", cfg.eval_batch)):
            os.makedirs(os.path.join(data, subset))
            shard = render_multiview_batch(model, g, n)
            write_shard(os.path.join(data, subset), "mv_data_0",
                        *(x.cpu().numpy() for x in (shard.dms, shard.gt_joints, shard.poses)))
        cli_dir = os.path.join(tmp, "runs")
        argv = ["--mode", "Train", "--epoch", "1", "--dataset_dir", data, "--model_dir", cli_dir,
                "--tag", "sw_", "--mesh", "lite", "--bf16", "--depth_resample", "3"]
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "spherehand_torch"] + argv, cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        runs = os.listdir(cli_dir) if os.path.isdir(cli_dir) else []
        made = [r for r in runs if os.path.exists(os.path.join(cli_dir, r, "model_0.pt"))]
        if run.returncode != 0 or len(made) != 1:
            fail(f"[13] python -m spherehand_torch {' '.join(argv[10:])} exited {run.returncode}, "
                 f"runs {runs}:\n{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
        with open(os.path.join(cli_dir, made[0], "config.json")) as f:
            saved = json.load(f)
        with open(os.path.join(cli_dir, made[0], "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if (saved["mesh"], saved["bf16"], saved["depth_resample"]) != ("lite", True, 3) or not (
                recs and all(np.isfinite(v) for r in recs for v in r.values()
                             if isinstance(v, float))):
            fail(f"[13] CLI run config {saved}, records {recs}")
        log(f"[13] python -m spherehand_torch {' '.join(argv[10:])} --epoch 1 on "
            f"{2 * cfg.real_batch} rendered hands: exit 0 in {time.perf_counter() - t0:.2f} s; "
            f"last record {json.dumps(recs[-1])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[13] launches by sub-phase (each counted from 0): {json.dumps(launches)} | {smi}; "
        f"phase {time.perf_counter() - t_phase:.2f} s")


def engine_rank_child(report_dir: str, argv: list[str]) -> int:
    """One rank of phase 14(b), started by ``torch.distributed.run``: the
    CLI (``spherehand_torch.train.cli.main``) with the kernels' launch
    counts set to 0 before it; writes the rank's parameters and counts."""
    sys.path.insert(0, ROOT)
    from spherehand_torch.render import raster_cuda, sphere_cuda
    from spherehand_torch.train import cli

    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    engine = cli.main(argv)
    torch.cuda.synchronize()
    rank = int(os.environ["RANK"])
    torch.save({"network": {k: v.cpu() for k, v in engine.state.network.state_dict().items()},
                "launches": {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES},
                "backend": engine.group.backend, "device": str(engine.group.device)},
               os.path.join(report_dir, f"rank{rank}_{argv[argv.index('--mode') + 1]}.pt"))
    return 0


def parallel_phase(model, params, dev, seed: int, smi: str) -> None:
    """Phase 14: data parallelism on the one card (TF32 off where numbers
    are compared)."""
    import concurrent.futures
    import shutil
    import tempfile

    from spherehand_torch.data.nyu import NyuDataset, write_shard
    from spherehand_torch.data.pseudo_real import render_multiview_batch
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.infer import PoseEstimator
    from spherehand_torch.parallel import check
    from spherehand_torch.render.raster import render_depth_64
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.engine import Engine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    doctor = side = None
    try:
        # ----------------------------------------------------------- (a)
        t0 = time.perf_counter()
        out = os.path.join(tmp, "a")
        os.makedirs(out)
        ranks = check.launch(2, out, device="cuda", checks=P14_CHECKS, backend="gloo",
                             synt_batch=P14_SYNT, timeout_s=P14_TIMEOUT_S)
        ref = check.reference(dev, checks=P14_CHECKS, hand=model, synt_batch=P14_SYNT)
        timing = {f"rank{r}": {k.split("/")[1]: float(v) for k, v in got.items()
                               if k.startswith("timing/")} for r, got in enumerate(ranks)}
        timing["one device"] = float(ref["timing/step_ms"])
        log(f"[14a] combined step at 48 + 25 x 3 (TF32 default), median CUDA-event ms of "
            f"{check.TIMING_STEPS} after {check.TIMING_WARMUP}, each of 2 gloo ranks on the one "
            f"card against one device, and the gloo gradient sum: {json.dumps(timing)} | {smi}")
        try:
            worst = check.compare(ranks, ref, loss_rtol=P14_LOSS_REL, terms_against_loss=True)
        except AssertionError as exc:
            fail(f"[14a] two gloo ranks against one device: {exc}")
        log(f"[14a] 2 gloo ranks on one card, {P14_SYNT} synthetic + {check.REAL_SAMPLES} x 3 "
            f"real padded to 4 (one row at weight 0), real_aug off: worst gaps "
            f"{json.dumps(worst)} (loss <= {P14_LOSS_REL}, gradients <= "
            f"{check.GRAD_SCALE_TOL} of scale, parameters after 2 steps equal across ranks) "
            f"in {time.perf_counter() - t0:.2f} s")

        # (c) and (e) run beside (b), which times nothing: (a) ran alone.
        t_side = time.perf_counter()
        out_c = os.path.join(tmp, "c")
        os.makedirs(out_c)
        side = concurrent.futures.ThreadPoolExecutor(1)
        nccl_future = side.submit(check.launch, 1, out_c, device="cuda", checks=("identity",),
                                  backend="nccl", synt_batch=P14_SYNT, timeout_s=P14_TIMEOUT_S)
        doctor = subprocess.Popen([sys.executable, "-m", "spherehand_torch.doctor"], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # ----------------------------------------------------------- (b)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed + 20)  # phase 12's hands
        data = os.path.join(tmp, "nyu")
        for subset, sizes in P14_SPLITS.items():
            os.makedirs(os.path.join(data, subset))
            for i, n in enumerate(sizes):
                real = render_multiview_batch(model, gen, n)
                write_shard(os.path.join(data, subset), f"mv_data_{i}",
                            *(x.cpu().numpy() for x in (real.dms, real.gt_joints, real.poses)))
        model_dir, report = os.path.join(tmp, "runs"), os.path.join(tmp, "report")
        os.makedirs(report)

        def torchrun(argv) -> None:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", os.path.abspath(__file__), "--rank_report", report,
                   "--", *argv, "--dataset_dir", data, "--model_dir", model_dir,
                   "--eval_precision", "highest"]
            run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                 timeout=P14_TIMEOUT_S)
            if run.returncode != 0:
                fail(f"[14b] torchrun {' '.join(argv)} exited {run.returncode}:\n"
                     f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")

        torchrun(["--mode", "Train", "--epoch", "1", "--tag", "dp_"])
        runs = sorted(os.listdir(model_dir))
        ckpts = [os.path.join(model_dir, r, "model_0.pt") for r in runs
                 if os.path.exists(os.path.join(model_dir, r, "model_0.pt"))]
        if len(runs) != 1 or len(ckpts) != 1:
            fail(f"[14b] run directories {runs}, checkpoints {ckpts}")
        with open(os.path.join(model_dir, runs[0], "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(model_dir, runs[0], "log.txt")) as f:
            run_log = f.read()
        steps = len(NyuDataset(os.path.join(data, "train"))) // EngineConfig().real_batch
        bad = [r for r in recs if not all(np.isfinite(v) for v in r.values()
                                          if isinstance(v, float))]
        if not recs or bad or "data-parallel over 2 ranks (gloo)" not in run_log:
            fail(f"[14b] records {recs}, log:\n{run_log[-2000:]}")
        eval_dir = os.path.join(tmp, "eval")
        torchrun(["--mode", "Test", "--initial_model", ckpts[0], "--tag", "dpev_"])
        reports = {(r, m): torch.load(os.path.join(report, f"rank{r}_{m}.pt"), weights_only=True)
                   for r in range(2) for m in ("Train", "Test")}
        same = all(torch.equal(v, reports[(1, "Train")]["network"][k])
                   for k, v in reports[(0, "Train")]["network"].items())
        missing = {f"rank{r} {m}": [n for n in names if reports[(r, m)]["launches"][n] < 1]
                   for r in range(2) for m, names in
                   (("Train", P14_TRAIN_KERNELS), ("Test", P14_EVAL_KERNELS))}
        if not same or any(missing.values()):
            fail(f"[14b] parameters equal across ranks: {same}; kernels not launched: {missing}")
        ev_runs = [r for r in os.listdir(model_dir) if r.startswith("dpev_")]
        with np.load(os.path.join(model_dir, ev_runs[0], "result.npz")) as f:
            gt, est = f["gt"], f["est"]
        test_rows = len(NyuDataset(os.path.join(data, "test")))
        one = Engine(EngineConfig(mode="Test", dataset_dir=data, model_dir=eval_dir,
                                  initial_model=ckpts[0], eval_precision="highest",
                                  tag="one_"), device=dev)
        one.eval()
        with np.load(os.path.join(one.model_path, "result.npz")) as f:
            ref_gt, ref_est = f["gt"], f["est"]
        gap = float(np.abs(est - ref_est).max()) if est.shape == ref_est.shape else float("inf")
        if (len(ev_runs) != 1 or gt.shape != (test_rows, 36, 3) or est.shape != (test_rows, 41, 3)
                or not np.array_equal(gt, ref_gt) or gap > P14_EVAL_MM):
            fail(f"[14b] eval runs {ev_runs}: gt {gt.shape}, est {est.shape} against "
                 f"{ref_est.shape}, joints gap {gap} mm (limit {P14_EVAL_MM})")
        launches = {f"rank{r} {m}": {n: reports[(r, m)]["launches"][n] for n in names}
                    for r in range(2) for m, names in
                    (("Train", P14_TRAIN_KERNELS), ("Test", P14_EVAL_KERNELS))}
        log(f"[14b] torchrun --nproc_per_node 2 -m spherehand_torch on one card "
            f"({reports[(0, 'Train')]['backend']}, {reports[(0, 'Train')]['device']} and "
            f"{reports[(1, 'Train')]['device']}): {steps} combined steps at 48 + 25 x 3 (24 + 24 "
            f"synthetic, 13 + 13 real rows, one at weight 0), parameters equal across ranks bit "
            f"for bit, checkpoint {os.path.relpath(ckpts[0], model_dir)} by rank 0, records "
            f"{[r['it'] for r in recs]} (last {json.dumps(recs[-1])}); --mode Test: result.npz "
            f"{est.shape}, joints within {gap:.3g} mm of one rank's eval of the same "
            f"checkpoint; launches by rank {json.dumps(launches)} in "
            f"{time.perf_counter() - t0:.2f} s")

        # ----------------------------------------------------------- (c)
        (nccl,) = nccl_future.result(timeout=P14_TIMEOUT_S)
        log(f"[14c] one NCCL rank: combined_grads' loss and terms equal the ungrouped call's "
            f"bit for bit, NCCL's sum of the gradients returns them bit for bit; the group's "
            f"gradients {float(nccl['identity/grad_gap']):.3g} of each tensor's largest entry "
            f"from the ungrouped call's, a second ungrouped backward "
            f"{float(nccl['identity/spread']):.3g} (the card's run-to-run spread); beside (b), "
            f"{time.perf_counter() - t_side:.2f} s since (a)")

        # ----------------------------------------------------------- (d)
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(seed + 140)
        with torch.no_grad():
            crops = render_depth_64(model, forward_kinematics(model, sample_poses(g, P14_SERVE)),
                                    torch.ones(P14_SERVE, device=dev)).cpu().numpy()
        single = PoseEstimator(params, serve_chunk=P14_SERVE_CHUNK, precision="highest",
                               device=dev)
        split = PoseEstimator(params, serve_chunk=P14_SERVE_CHUNK, precision="highest",
                              devices=[dev, dev])
        joints, ref_joints = split.predict(crops), single.predict(crops)
        serve_gap = float(np.abs(joints - ref_joints).max())
        if joints.shape != (P14_SERVE, 41, 3) or serve_gap > P14_SERVE_MM:
            fail(f"[14d] serving over 2 replicas: {joints.shape}, gap {serve_gap} mm")
        log(f"[14d] PoseEstimator(devices=[{dev}, {dev}]) at B = {P14_SERVE}, serve_chunk "
            f"{P14_SERVE_CHUNK}: {joints.shape}, within {serve_gap:.3g} mm of one device "
            f"(limit {P14_SERVE_MM}) in {time.perf_counter() - t0:.2f} s")

        # ----------------------------------------------------------- (e)
        try:
            doc_out, doc_err = doctor.communicate(timeout=P14_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"[14e] doctor did not end within {P14_TIMEOUT_S} s")
        summary = [line for line in doc_out.splitlines() if "checks passed" in line]
        counts = summary[0].split()[0].split("/") if summary else ["0", "1"]
        if doctor.returncode != 0 or counts[0] != counts[1]:
            fail(f"[14e] doctor exited {doctor.returncode}:\n{doc_out[-3000:]}\n"
                 f"{doc_err[-2000:]}")
        log(f"[14e] python -m spherehand_torch.doctor: {summary[0]}, beside (b) "
            f"({time.perf_counter() - t_side:.2f} s since (a)): "
            + "; ".join(line.strip() for line in doc_out.splitlines() if "PASS" in line))
    finally:
        if doctor is not None and doctor.poll() is None:
            doctor.kill()
            doctor.communicate()
        if side is not None:
            side.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[14] data parallelism on one card | {smi}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")


def bench_phase(smi: str) -> None:
    """Phase 15: ``python -m spherehand_torch.bench`` once; its line holds
    every key of ``bench.py`` (and the card's name and limit), all finite."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "spherehand_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=P15_TIMEOUT_S)
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or not lines:
        fail(f"[15] bench exited {run.returncode}:\n{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    record = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in record]
    bad = [k for k, v in record.items()
           if isinstance(v, (int, float)) and not np.isfinite(v)]
    if missing or bad:
        fail(f"[15] bench keys missing {missing}, not finite {bad}: {lines[-1]}")
    log(lines[-1])
    log(f"[15] python -m spherehand_torch.bench: {len(record)} keys, all finite | {smi}; "
        f"phase {time.perf_counter() - t0:.2f} s")


def evidence_phase(model, params, crops_mm, joints, dev, seed: int, smi: str) -> None:
    """Phase 16: the evidence path (``spherehand_torch.tools``) at the full
    widths, short; ``crops_mm`` and ``joints`` are phase 4's fast crops and
    its estimator's joints, ``model`` the card's hand model."""
    import shutil
    import tempfile

    from spherehand_torch import convert
    from spherehand_torch.data.pseudo_real import generate_pseudo_nyu
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.infer import PoseEstimator
    from spherehand_torch.models.estimator import make_network
    from spherehand_torch.ops import upsample
    from spherehand_torch.render import raster_cuda, sphere_cuda
    from spherehand_torch.tools import (
        eval_synthetic,
        import_torch_checkpoint,
        interactive_viewer,
        lite_mesh_e2e,
        parity_eval,
        selfsup_demo,
        train_synthetic_full,
    )
    from spherehand_torch.utils import determinism

    t_phase = time.perf_counter()
    secs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_evidence_")
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    upsample.reset_launch_counts()
    try:
        # (1) synthetic pretraining, 200 steps
        t0 = time.perf_counter()
        run = train_synthetic_full.train_synthetic(P16_SYNT_STEPS, device=dev, log_every=100)
        paths = train_synthetic_full.save_run(os.path.join(tmp, "synthetic"), run)
        first = float(run.losses[:P16_LOSS_WINDOW].mean())
        last = float(run.losses[-P16_LOSS_WINDOW:].mean())
        secs["train_synthetic_full"] = time.perf_counter() - t0
        log(f"[16] (1) train_synthetic_full {P16_SYNT_STEPS} steps at 48: mean loss of the first "
            f"{P16_LOSS_WINDOW} {first:.2f}, of the last {last:.2f}; error {run.errors[0]:.2f} -> "
            f"{run.errors[-1]:.2f} mm; {P16_SYNT_STEPS / run.seconds:.2f} steps/s")
        if not (np.isfinite(run.losses).all() and last < first):
            fail(f"[16] synthetic loss did not fall: {first} -> {last}")

        # (2) held-out eval of that checkpoint and of the shipped weights
        t0 = time.perf_counter()
        trained = eval_synthetic.evaluate(paths["model_final.pt"], P16_HELDOUT, 128, dev)
        shipped = float(eval_synthetic.heldout_errors(
            eval_synthetic.load_network(PARAMS, dev), load_hand_model(device=dev),
            P16_HELDOUT).mean())
        secs["eval_synthetic"] = time.perf_counter() - t0
        log(f"[16] (2) eval_synthetic on {P16_HELDOUT} held-out hands: the {P16_SYNT_STEPS}-step "
            f"checkpoint {trained['mean_mm']:.3f} mm, the shipped weights {shipped:.3f} mm")
        if not (trained["errors"].shape == (P16_HELDOUT, 41) and np.isfinite(trained["mean_mm"])
                and shipped < P16_SHIPPED_MM):
            fail(f"[16] held-out eval: trained {trained['mean_mm']}, shipped {shipped} mm")

        # (3) the reference-layout import round trip
        t0 = time.perf_counter()
        network = convert.load_hourglass(make_network(1), params)
        reference = convert.reference_state_from_hourglass(network)
        pth = os.path.join(tmp, "reference.pth")
        torch.save({"state_dict": {"module." + k: v for k, v in reference.items()}}, pth)
        imported = import_torch_checkpoint.import_checkpoint(
            pth, os.path.join(tmp, "imported.npz"), num_stacks=1)
        want, got = convert.flatten_params(params), convert.flatten_params(imported)
        same = want.keys() == got.keys() and all(
            want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]) for k in want)
        served = PoseEstimator(imported, num_stacks=1, denoise=True, precision="highest",
                               device=dev).predict(crops_mm)
        gap = float(np.abs(served - joints).max())
        secs["import_torch_checkpoint"] = time.perf_counter() - t0
        log(f"[16] (3) import round trip: {len(got)} arrays equal bit for bit {same}; joints "
            f"{gap:.3g} mm from phase 4's")
        if not (same and gap <= P16_IMPORT_MM):
            fail(f"[16] import round trip: bit for bit {same}, joints {gap} mm")

        # (4) pseudo-NYU through the shifted sensor
        t0 = time.perf_counter()
        out = os.path.join(tmp, "selfsup")
        checks = [generate_pseudo_nyu(os.path.join(out, "data", split), n, seed + off, dev)
                  for split, n, off in (("train", P16_TRAIN, 0),
                                        ("test", P16_TEST, selfsup_demo.TEST_SEED_OFFSET))]
        secs["generate_pseudo_nyu"] = time.perf_counter() - t0
        log(f"[16] (4) pseudo-NYU {P16_TRAIN} + {P16_TEST} hands x 3 views, self-check "
            f"{max(checks):.4g} mm")
        if not max(checks) < P16_SELF_CHECK_MM:
            fail(f"[16] pseudo-NYU self-check {checks} mm")

        # (5) one adaptation epoch, with and without the multi-view terms
        results = {}
        for no_mv in (False, True):
            t0 = time.perf_counter()
            results[no_mv] = selfsup_demo.run(out=out, samples=P16_TRAIN, test=P16_TEST,
                                              epochs=1, no_mv=no_mv, seed=seed, device=dev)
            secs["selfsup_demo" + ("_no_mv" if no_mv else "")] = time.perf_counter() - t0
        for no_mv, r in results.items():
            log(f"[16] (5) selfsup_demo no_mv={no_mv}: {r['steps']} steps, before "
                f"{r['before_mm']} mm, after {r['after_mm']} mm ({r['backend']})")
            if not (np.isfinite([r["before_mm"], r["after_mm"]]).all() and r["steps"] > 0):
                fail(f"[16] selfsup_demo no_mv={no_mv}: {r}")

        # (6) the parity drill on the imported .pth
        t0 = time.perf_counter()
        drill = parity_eval.run_parity_eval(pth, os.path.join(out, "data"), 1,
                                            os.path.join(tmp, "parity"), device=dev)
        secs["parity_eval"] = time.perf_counter() - t0
        log(f"[16] (6) parity_eval: {json.dumps(drill)}")
        if not (drill["num_samples"] == P16_TEST and np.isfinite(drill["avg_joint_error_mm"])):
            fail(f"[16] parity_eval: {drill}")

        # (7) lite against full
        t0 = time.perf_counter()
        arms = lite_mesh_e2e.run_arms(["lite", "full"], P16_LITE_STEPS,
                                      os.path.join(tmp, "lite_mesh_e2e.json"), device=dev)
        secs["lite_mesh_e2e"] = time.perf_counter() - t0
        log(f"[16] (7) lite_mesh_e2e {P16_LITE_STEPS} steps: {json.dumps(arms)}")
        if not all(np.isfinite(arms[a]["heldout_mm"]) for a in ("lite", "full")):
            fail(f"[16] lite_mesh_e2e: {arms}")

        # (8) two deterministic runs of one seed, bit for bit
        t0 = time.perf_counter()
        saved = determinism.enable()
        try:
            repeats = [selfsup_demo.run(out=out, samples=P16_TRAIN, test=P16_TEST,
                                        epochs=P16_REPEAT_EPOCHS, seed=seed, device=dev,
                                        artifact=os.path.join(tmp, f"repeat{i}.json"))
                       for i in range(2)]
        finally:
            determinism.restore(saved)
        secs["determinism_repeat"] = time.perf_counter() - t0
        keys = ("steps", "after_mm", "after_raw_mm", "params_sha256")
        log(f"[16] (8) deterministic repeat of {repeats[0]['steps']} adaptation steps: "
            + json.dumps([{k: r[k] for k in keys} for r in repeats]))
        if not (repeats[0]["steps"] == P16_REPEAT_EPOCHS * (P16_TRAIN // 25)
                and all(repeats[0][k] == repeats[1][k] for k in keys)):
            fail(f"[16] the deterministic repeat differs: {repeats}")

        # (9) the viewer's renders on the card against the CPU's
        t0 = time.perf_counter()
        poses = np.concatenate([np.zeros((1, 26), np.float32), sample_poses(
            torch.Generator().manual_seed(seed + 30), 2).numpy()])
        views = [[v.cpu() for v in interactive_viewer.render_views(m, poses)]
                 for m in (model, load_hand_model(device="cpu"))]
        sphere_gap = float((views[0][0] - views[1][0]).abs().max())
        fg_card, fg_cpu = views[0][1] < 99.9, views[1][1] < 99.9
        iou = float((fg_card & fg_cpu).sum() / max(int((fg_card | fg_cpu).sum()), 1))
        secs["interactive_viewer"] = time.perf_counter() - t0
        log(f"[16] (9) interactive_viewer.render_views of 3 poses: sphere map {sphere_gap:.3g} mm "
            f"from the CPU's, mesh coverage IoU {iou:.4f}")
        if not (sphere_gap <= P16_VIEWER_SPHERE_MM and iou > P16_VIEWER_IOU):
            fail(f"[16] viewer renders: sphere {sphere_gap} mm, IoU {iou}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES,
                                  **upsample.LAUNCHES}.items() if v}
    missing = [k for k in P16_KERNELS if not launches.get(k)]
    if missing:
        fail(f"[16] kernels not launched by the evidence path: {missing} ({launches})")
    log(f"[16] seconds by sub-step: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    log(f"[16] launches (counted from 0): {json.dumps(launches)} | {smi}; "
        f"phase {time.perf_counter() - t_phase:.2f} s")


def recipe_phase(model, params, dev, seed: int, smi: str) -> None:
    """Phase 18: the recipe trio (``reference_recipe``, ``recipe_artifact``,
    ``divergence_study``) at a small size under the tools' deterministic
    settings, and ``combined_term_diag`` on the recipe's data, card against
    CPU."""
    import shutil
    import tempfile

    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.nyu import NyuDataset
    from spherehand_torch.data.synthesizer import synthesize_from_draws
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.infer import float32_precision
    from spherehand_torch.ops import upsample
    from spherehand_torch.render import raster_cuda, sphere_cuda
    from spherehand_torch.tools import divergence_study, recipe_artifact, reference_recipe
    from spherehand_torch.train import engine as engine_mod
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps
    from spherehand_torch.utils import determinism

    class Stop(Exception):
        pass

    t_phase = time.perf_counter()
    secs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    upsample.reset_launch_counts()
    saved = determinism.enable()
    try:
        # (1) the recipe, uninterrupted and stopped after its first epoch then resumed
        t0 = time.perf_counter()
        small = dict(samples=P18_TRAIN, test=P18_TEST, epochs=P18_EPOCHS, seed=seed, device=dev)
        whole = reference_recipe.run(out=os.path.join(tmp, "whole"), **small)
        os.makedirs(os.path.join(tmp, "resumed"))
        os.symlink(os.path.join(tmp, "whole", "data"), os.path.join(tmp, "resumed", "data"))
        real_epoch = engine_mod.Engine._epoch_combined

        def stop_at_1(self, epoch):
            if epoch == 1:
                raise Stop
            return real_epoch(self, epoch)

        engine_mod.Engine._epoch_combined = stop_at_1
        try:
            reference_recipe.run(out=os.path.join(tmp, "resumed"), **small)
        except Stop:
            pass
        finally:
            engine_mod.Engine._epoch_combined = real_epoch
        unfinished = recipe_artifact._load_run(os.path.join(tmp, "resumed"))
        resumed = reference_recipe.run(out=os.path.join(tmp, "resumed"), **small)
        secs["reference_recipe"] = time.perf_counter() - t0
        mm = [p[k] for r in (whole, resumed) for p in r["trajectory"]
              for k in ("avg_joint_error", "avg_joint_error_raw")]
        same = (whole["trajectory"] == resumed["trajectory"]
                and whole["params_sha256"] == resumed["params_sha256"])
        evals = [p["avg_joint_error"] for p in whole["trajectory"]]
        log(f"[18] (1) reference_recipe {P18_EPOCHS} epochs of {P18_TRAIN} + {P18_TEST}: "
            f"{whole['steps']} steps, evals {json.dumps(evals)} mm; "
            f"stopped after epoch 0 ({len(unfinished['trajectory'])} evals, finished "
            f"{unfinished['finished']}) and resumed: equal bit for bit {same}")
        if not (np.isfinite(mm).all() and same and whole["steps"] == P18_EPOCHS * (P18_TRAIN // 25)
                and not unfinished["finished"] and len(unfinished["trajectory"]) == 2):
            fail(f"[18] reference_recipe: {whole}, resumed {resumed}, unfinished {unfinished}")

        # (2) the record of the two runs
        art = recipe_artifact.build(os.path.join(tmp, "whole"), os.path.join(tmp, "resumed"))
        log(f"[18] (2) recipe_artifact: keys {sorted(art)}; finished "
            f"{[art[k]['finished'] for k in ('stock', 'companion')]}")
        if not (art["eval_precision"] == "highest" and art["stock"]["finished"]
                and art["stock"]["trajectory"] == art["companion"]["trajectory"]):
            fail(f"[18] recipe_artifact: {art}")

        # (3) two divergence probes, one epoch each
        t0 = time.perf_counter()
        skip = ",".join(n for n in divergence_study.probe_names() if n not in P18_PROBES)
        study = divergence_study.run(
            data=os.path.join(tmp, "whole", "data"), samples=P18_TRAIN, test=P18_TEST, epochs=1,
            stock_epochs=1, diag_every=P18_DIAG_EVERY, eval_every_steps=P18_DIAG_EVERY,
            lrs="1e-4", skip=skip, out=os.path.join(tmp, "study"), seed=seed, device=dev,
            artifact=os.path.join(tmp, "study", "torch_divergence_study.json"))
        secs["divergence_study"] = time.perf_counter() - t0
        collapse = study["conclusions"]["collapse"]
        diag = study["probes"]["stock_instrumented"]["diag"]
        finite = all(np.isfinite(row["trajectory_mm"]).all() for row in collapse.values())
        log(f"[18] (3) divergence_study {sorted(collapse)}: "
            + json.dumps({k: v["trajectory_mm"] for k, v in collapse.items()})
            + f"; {len(diag)} diag records, mv_projection cos "
            f"{study['conclusions']['diag_summary']['mv_projection']['cos_total_median']:.3f}")
        if not (sorted(collapse) == sorted(P18_PROBES) and finite
                and len(diag) == -(-(P18_TRAIN // 25) // P18_DIAG_EVERY)):
            fail(f"[18] divergence_study: {study['conclusions']}")
    finally:
        determinism.restore(saved)

    # (4) combined_term_diag on the recipe's first batch, card against CPU
    t0 = time.perf_counter()
    ds = NyuDataset(os.path.join(tmp, "whole", "data", "train"))
    host = ds.gather(np.arange(P18_DIAG_REAL))
    cfg = EngineConfig(synt_batch=8, real_batch=P18_DIAG_REAL)
    sides = {}
    draws = build_steps(cfg, hand=load_hand_model(device="cpu")).draw(
        torch.Generator().manual_seed(seed + 180))
    gpu_draws = draws.to(dev)
    synt = synthesize_from_draws(model, gpu_draws.poses, gpu_draws.synthesis)
    for side, sdev in (("gpu", dev), ("cpu", torch.device("cpu"))):
        fns = build_steps(cfg, hand=model if side == "gpu" else load_hand_model(device="cpu"))
        state = train_state_from_params(fns.init_state, params)
        batch = RealBatch(*(torch.as_tensor(a, device=sdev) for a in host))
        with float32_precision("highest"):
            diag = fns.combined_term_diag(state, draws.to(sdev), batch, True,
                                          synt=type(synt)(*(x.to(sdev) for x in synt)))
        sides[side] = {k: float(v) for k, v in diag.items()}
    gaps = {}
    for key, ref in sides["cpu"].items():
        if not key.endswith("/cos_total"):
            got = sides["gpu"][key]
            gaps[key] = 0.0 if got == ref else abs(got - ref) / max(abs(ref), 1e-30)
    worst = max(gaps, key=gaps.get)
    secs["term_diag_card_vs_cpu"] = time.perf_counter() - t0
    log(f"[18] (4) combined_term_diag on the recipe's first {P18_DIAG_REAL} samples, card against "
        f"CPU (8 + {P18_DIAG_REAL}x3, TF32 off): largest gap {worst} {gaps[worst]:.4g} (bound "
        f"{TERM_GPU_CPU_REL})")
    shutil.rmtree(tmp, ignore_errors=True)
    if gaps[worst] > TERM_GPU_CPU_REL:
        fail(f"[18] card against CPU term gap {worst} {gaps[worst]}: {json.dumps(gaps)}")
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES,
                                  **upsample.LAUNCHES}.items() if v}
    missing = [k for k in P18_KERNELS if not launches.get(k)]
    if missing:
        fail(f"[18] kernels not launched by the recipe trio: {missing} ({launches})")
    log(f"[18] seconds by sub-step: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    log(f"[18] launches (counted from 0): {json.dumps(launches)} | {smi}; "
        f"phase {time.perf_counter() - t_phase:.2f} s")


def upsample_phase(fns, state, cfg, real_batch, estimator, dms_mm, dev, seed: int,
                   smi: str) -> tuple[dict, dict]:
    """Phase 17: the upsample kernels against their plain versions at the
    hourglass's shapes, timed beside F.interpolate (the library yardstick)
    and their bounds; launches a predict and a step; predict and the steps
    re-timed. Returns (times, checks) by shape."""
    import torch.nn.functional as F

    from spherehand_torch.ops import upsample as up
    from spherehand_torch.render import contracts

    t_phase = time.perf_counter()
    checks, times = {}, {}
    for batch in P17_BATCHES:
        for hw in P17_SIZES:
            gen = torch.Generator(device=dev).manual_seed(seed + 40 + batch + hw)
            shape = (batch, P17_CHANNELS, hw, hw)
            x32 = torch.randn(shape, generator=gen, device=dev)
            g32 = torch.randn((batch, P17_CHANNELS, 2 * hw, 2 * hw), generator=gen, device=dev)
            for dt in (torch.float32, torch.bfloat16):
                x, g = x32.to(dt), g32.to(dt)
                fwd, plain = up.launch_fwd(x), up.upsample2x_plain(x)
                bwd, again, gather = up.launch_bwd(g), up.launch_bwd(g), up.upsample2x_bwd_plain(g)
                leaf = x.detach().float().clone().requires_grad_(True)
                up.upsample2x_plain(leaf).backward(g.float())
                ref = leaf.grad
                torch.cuda.synchronize()
                gap = (bwd.float() - ref).abs()
                limit = P17_BWD_REL * float(ref.abs().max())
                if dt == torch.bfloat16:
                    limit = limit + P17_BF16_ROUNDING * ref.abs()
                key = f"B{batch}_{hw}x{hw}_{str(dt).split('.')[-1]}"
                checks[key] = {
                    "fwd_bits": contracts.same_bits(fwd, plain),
                    "bwd_bits_plain": contracts.same_bits(bwd, gather),
                    "bwd_bits_again": contracts.same_bits(bwd, again),
                    "bwd_rel": float(gap.max()) / float(ref.abs().max()),
                    "bwd_max_abs_err": float(gap.max()),
                    "fwd_max_abs_err": max_abs_diff(fwd.float(), plain.float()),
                }
                ok = checks[key]
                if not (ok["fwd_bits"] and ok["bwd_bits_plain"] and ok["bwd_bits_again"]
                        and bool((gap <= limit).all())):
                    fail(f"[17] upsample kernels at {key}: {ok}")
            # times in float32, the path's dtype by default
            x, g = x32, g32
            lib_in = x.clone().requires_grad_(True)
            lib_out = F.interpolate(lib_in, scale_factor=2, mode="bilinear", align_corners=False)
            numel = x.numel()
            times[f"B{batch}_{hw}x{hw}"] = {
                "fwd_ms": time_ms(lambda: up.launch_fwd(x), REPS),
                "bwd_ms": time_ms(lambda: up.launch_bwd(g), REPS),
                "plain_fwd_ms": time_ms(lambda: up.upsample2x_plain(x), REPS),
                "plain_bwd_ms": time_ms(lambda: up.upsample2x_bwd_plain(g), REPS),
                "library_fwd_ms": time_ms(lambda: F.interpolate(
                    x, scale_factor=2, mode="bilinear", align_corners=False), REPS),
                "library_bwd_ms": time_ms(lambda: torch.autograd.grad(
                    lib_out, lib_in, g, retain_graph=True), REPS),
                "fwd_bound": bound(4 * 5 * numel, UPSAMPLE_OPS["fwd"] * 4 * numel),
                "bwd_bound": bound(4 * 5 * numel, UPSAMPLE_OPS["bwd"] * numel),
            }
    log("[17] upsample kernels against their plain versions: " + json.dumps(checks))
    log("[17] upsample CUDA-event ms (float32) beside F.interpolate and the bound: "
        + json.dumps(times))

    # launches of one predict, one synthetic and one combined step
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    per_call = {}
    calls = {
        "predict": lambda: estimator.predict(dms_mm),
        "synt_step": lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)),
        "combined_step": lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch,
                                                   True),
    }
    for name, call in calls.items():
        torch.cuda.synchronize()
        up.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        per_call[name] = dict(up.LAUNCHES)
    step_ms = {
        "predict_ms": time_ms(lambda: estimator.predict(dms_mm), REPS),
        "synt_step_ms": time_ms(
            lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)), REPS),
        "combined_step_ms": time_ms(
            lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch, True), REPS),
        "eval_step_ms": time_ms(
            lambda: fns.eval_step(state, fns.draw(gen, synt=False), real_batch), REPS),
    }
    log(f"[17] launches a call: {json.dumps(per_call)}; re-timed (B = {MAIN_BATCH} predict, "
        f"steps at {cfg.synt_batch} + {cfg.real_batch}x3): {json.dumps(step_ms)} | {smi}; "
        f"phase {time.perf_counter() - t_phase:.2f} s")
    for name, counts in per_call.items():
        if counts["upsample2x_fwd"] < 1 or (name != "predict" and counts["upsample2x_bwd"] < 1):
            fail(f"[17] the upsample kernels were not launched by {name}: {counts}")
    return times, checks


def upsample_rows(train_launches: dict, times: dict, checks: dict) -> list[dict]:
    """The kernels-line rows of the two upsample kernels: per network
    forward at B = 128, both calls' times and bounds summed."""
    rows = []
    for kind in ("fwd", "bwd"):
        keys = [f"B{MAIN_BATCH}_{hw}x{hw}" for hw in P17_SIZES]
        b_ms = sum(times[k][f"{kind}_bound"][0] for k in keys)
        err_key = f"{kind}_max_abs_err"
        rows.append({
            "name": f"upsample2x_{kind}", "route": "cuda",
            "source": "spherehand_torch/csrc/upsample.cu", "replaces": UPSAMPLE_SOURCE,
            "launches": train_launches[f"upsample2x_{kind}"],
            "max_abs_err": max(checks[f"{k}_float32"][err_key] for k in keys),
            "ms": sum(times[k][f"{kind}_ms"] for k in keys),
            "plain_ms": sum(times[k][f"plain_{kind}_ms"] for k in keys),
            "bound_ms": b_ms, "bound_by": times[keys[0]][f"{kind}_bound"][1],
            "library_ms": sum(times[k][f"library_{kind}_ms"] for k in keys),
        })
    return rows


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sphere_work(sc, fields: int, centers, target, radii, size: int, views: int,
                weights) -> dict:
    """What these inputs need of the sphere kernels of ``fields``: covered
    (pixel, sphere) pairs (depth), foreground pixels of the observation (not
    z > 99) times J (distance), and pixels with a nonzero weight per field
    (``weights`` the forward's weight planes, depth before distance)."""
    n_img, num_j = centers.shape[:2]
    work = {"covered_pairs": 0, "foreground_updates": 0, "live_pixels": {}}
    if fields & sc.DEPTH:
        for a in range(0, n_img, 25):
            _, sq = sc._depth_fields(centers[a:a + 25], radii, size)
            work["covered_pairs"] += int((sq > 1e-2).sum())
    if fields & sc.DIST:
        z = sc.gathered_target(target, n_img, views)
        work["foreground_updates"] = int((~(z > 99.0)).sum()) * num_j
    names = [f for f, bit in (("depth", sc.DEPTH), ("dist", sc.DIST)) if fields & bit]
    for name, w in zip(names, weights):
        work["live_pixels"][name] = int((w != 0).sum())
    return work


def sphere_timings(sc, fields: int, centers, target, radii, size: int, views: int) -> dict:
    """CUDA-event medians of the three kernels of ``fields`` and their plain
    versions, with their bounds from what these inputs need
    (:func:`sphere_work`, the counts above)."""
    prefix = sc.LAUNCH_PREFIX[fields]
    k = sc.num_fields(fields)
    args = (fields, centers, target, radii, size, views)
    fwd = sc.launch_fields(*args, residuals=True)
    bwd_args = (fields, centers, target, views, [torch.ones_like(p) for p in fwd[:k]], fwd[k:])
    t = {
        f"{prefix}_fwd_ms": time_ms(lambda: sc.launch_fields(*args, residuals=True), REPS),
        f"{prefix}_primal_ms": time_ms(lambda: sc.launch_fields(*args, residuals=False), REPS),
        f"{prefix}_bwd_ms": time_ms(lambda: sc.launch_fields_bwd(*bwd_args), REPS),
        f"{prefix}_plain_fwd_ms": time_ms(
            lambda: sc.fields_plain(*args, residuals=True), PLAIN_REPS, warmup=1),
        f"{prefix}_plain_primal_ms": time_ms(
            lambda: sc.fields_plain(*args, residuals=False), PLAIN_REPS, warmup=1),
        f"{prefix}_plain_bwd_ms": time_ms(lambda: sc.fields_bwd_plain(*bwd_args), PLAIN_REPS,
                                          warmup=1),
    }
    n_img, num_j = centers.shape[:2]
    work = sphere_work(sc, fields, centers, target, radii, size, views, fwd[k + 1::2])
    t[f"{prefix}_work"] = work
    plane_bytes = 4 * n_img * size * size
    target_bytes = 4 * target.numel() if fields & sc.DIST else 0
    in_bytes = 4 * (centers.numel() + radii.numel()) + target_bytes

    def forward_ops(kind):
        return (work["covered_pairs"] * SPHERE_OPS["depth"][kind]
                + work["foreground_updates"] * SPHERE_OPS["dist"][kind])

    t[f"{prefix}_fwd_bound"] = bound(in_bytes + 3 * k * plane_bytes, forward_ops("fwd"))
    t[f"{prefix}_primal_bound"] = bound(in_bytes + k * plane_bytes, forward_ops("primal"))
    t[f"{prefix}_bwd_bound"] = bound(
        8 * centers.numel() + target_bytes + 2 * k * plane_bytes
        + 4 * sum(work["live_pixels"].values()),
        sum(n * SPHERE_OPS[f]["bwd"] for f, n in work["live_pixels"].items())
        + n_img * num_j * SPHERE_BWD_OPS_SPHERE[fields])
    return t


def sphere_rows(sc, fields: int, t: dict, stats: dict, launches: dict) -> list[dict]:
    """The kernels-line rows of the three kernels of ``fields``."""
    prefix = sc.LAUNCH_PREFIX[fields]
    rows = []
    for kind, err_key in (("primal", "primal_max_abs_err"), ("fwd", "fields_max_abs_err"),
                          ("bwd", "bwd_max_abs_err")):
        name = f"{prefix}_{kind}"
        b_ms, b_by = t[f"{name}_bound"]
        rows.append({
            "name": name, "route": "cuda", "source": "spherehand_torch/csrc/sphere.cu",
            "replaces": f"spherehand_tpu/render/sphere_pallas.py:{SPHERE_SOURCES[fields][kind]}",
            "launches": launches[name], "max_abs_err": stats[err_key], "ms": t[f"{name}_ms"],
            "plain_ms": t[f"{prefix}_plain_{kind}_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank_report", default=None,
                    help="phase 14(b)'s rank mode: run the CLI (the arguments after --) as "
                         "one rank and write its report into this directory")
    ap.add_argument("cli", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    if args.rank_report is not None:
        return engine_rank_child(args.rank_report, args.cli)
    sys.path.insert(0, ROOT)
    from spherehand_torch.utils import determinism

    # cuBLAS reads this when its first handle is made: phase 16 switches to
    # the evidence tools' deterministic algorithms later in this process.
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = determinism.CUBLAS_WORKSPACE_CONFIG
    from spherehand_torch import cuda_build
    from spherehand_torch.convert import train_state_from_params
    from spherehand_torch.data.pseudo_real import render_multiview_batch, sphere_inputs
    from spherehand_torch.data.sampler import sample_poses
    from spherehand_torch.data.synthesizer import draw_synthesis, synthesize, synthesize_from_draws
    from spherehand_torch.hand.assets import load_hand_model
    from spherehand_torch.hand.kinematics import forward_kinematics
    from spherehand_torch.hand.skinning import apply_scale, project_faces_planes
    from spherehand_torch.infer import PoseEstimator, float32_precision, load_params_npz
    from spherehand_torch import kernel_parity
    from spherehand_torch.constants import Constants
    from spherehand_torch.losses.multiview import mutual_projection_loss
    from spherehand_torch.models.estimator import forward as estimator_forward
    from spherehand_torch.ops import upsample
    from spherehand_torch.render import contracts, raster_cuda, sphere_cuda
    from spherehand_torch.render.adversarial import (
        adversarial_cases,
        sphere_adversarial_case,
        sphere_edge_case,
    )
    from spherehand_torch.train.config import EngineConfig
    from spherehand_torch.train.steps import RealBatch, build_steps
    from spherehand_torch.render.raster import (
        bilinear_sample_positions,
        pool_2x2,
        rasterize_depth,
        render_depth_64,
    )

    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1
    smi = nvidia_smi_line()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi}")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    built = cuda_build.build_all(cuda_build.SOURCES)
    log(f"[2] built {[os.path.relpath(p, ROOT) for p, _ in built.values()]} "
        f"in {time.perf_counter() - t0:.2f} s")
    for _, ptxas in built.values():
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    model = load_hand_model(device=dev)
    samples = torch.as_tensor(bilinear_sample_positions(64, 10), device=dev)

    def hand_planes(batch: int, seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        poses = sample_poses(gen, batch)
        draws = draw_synthesis(gen, batch)
        tr = apply_scale(forward_kinematics(model, poses), draws.scale_u, 0.1)
        return tr, draws.rand_f, project_faces_planes(model, tr, 640.0, draws.rand_f)

    def face_vertices(planes):
        u, v, z = planes
        return torch.stack([u, v, z], dim=-1).reshape(u.shape[0], -1, 3, 3)

    def reversed_faces(planes):
        batch = planes[0].shape[0]
        return tuple(p.reshape(batch, -1, 3).flip(1).reshape(batch, -1).contiguous()
                     for p in planes)

    def compare(fv, s, size, tag):
        """The three z-tile kernels, from the planes, vs their plain versions
        on one geometry (raw fast bit for bit), then again and on the
        reversed face order, bit for bit; returns the exact and pooled
        kernels' max |diff| to the plain versions, the pooled kernel's
        canvas and the plain exact and raw fast ones."""
        planes = raster_cuda.planes_of(fv)
        launches = {
            "exact": lambda p: raster_cuda.launch_raster_exact(p, s, s, size, size),
            "fast": lambda p: raster_cuda.launch_raster_fast_pooled(p, s, s, 100.0),
            "raw": lambda p: raster_cuda.launch_raster_fast(p, s, s),
        }
        k_exact = launches["exact"](planes)
        p_exact = rasterize_depth(fv, s, s, size, size)
        st = contracts.exact_stats(k_exact, p_exact)
        if not (contracts.exact_ok(st) and st["max_abs_err"] <= EXACT_MAX_ERR):
            fail(f"{tag}: exact kernel vs plain exact {st}")
        rec_f, box_f = raster_cuda.prepass_fast(fv)
        k_fast = launches["fast"](planes)
        p_fast = raster_cuda.raster_fast_plain(rec_f, box_f, s, s, 100.0)
        torch.cuda.synchronize()
        fast_err = float((k_fast - p_fast).abs().max())
        if not fast_err <= FAST_MAX_ERR:
            fail(f"{tag}: fast kernel vs plain fast max |diff| {fast_err}")
        k_raw = launches["raw"](planes)
        p_raw = raster_cuda.raster_fast_plain(rec_f, box_f, s, s)
        torch.cuda.synchronize()
        if not contracts.same_bits(k_raw, p_raw):
            fail(f"{tag}: raster_fast vs plain max |diff| {float((k_raw - p_raw).abs().max())}, "
                 "not bit for bit")
        for mode, first in (("exact", k_exact), ("fast", k_fast), ("raw", k_raw)):
            again, flipped = launches[mode](planes), launches[mode](reversed_faces(planes))
            torch.cuda.synchronize()
            if not (contracts.same_bits(first, again) and contracts.same_bits(first, flipped)):
                fail(f"{tag}: {mode} kernel not bit-identical across launches "
                     f"({contracts.same_bits(first, again)}) or face orders "
                     f"({contracts.same_bits(first, flipped)})")
        return st["max_abs_err"], fast_err, k_fast, p_exact, p_raw

    # ---------------------------------------------------------------- 3
    _, _, planes8 = hand_planes(8, args.seed)
    fv8 = face_vertices(planes8)
    e_err, f_err, k_fast, p_exact, fast_raw = compare(fv8, samples, 640, "hand B=8")
    exact_pooled = pool_2x2(torch.clamp(p_exact, max=100.0))
    fst = contracts.fast_stats(k_fast, exact_pooled, fast_raw, p_exact)
    if not contracts.fast_ok(fst):
        fail(f"fast kernel vs plain exact: {fst}")
    log(f"[3] hand B=8: exact |diff| max {e_err:.3g}, fast |diff| max {f_err:.3g}, raw fast "
        f"bit for bit; all three identical across two launches and the reversed face order, "
        f"fast vs exact {json.dumps(fst)}")
    for name, faces, size in adversarial_cases():
        s = samples if size == 640 else torch.arange(size, dtype=torch.float32, device=dev)
        e_err, f_err, *_ = compare(torch.as_tensor(faces, device=dev), s, size, name)
        log(f"    {name}: exact max {e_err:.3g}, fast max {f_err:.3g}")

    # ---------------------------------------------------------------- 4
    params = load_params_npz(PARAMS)
    estimator = PoseEstimator(params, num_stacks=1, denoise=True, precision="highest",
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    poses = sample_poses(gen, MAIN_BATCH)
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    upsample.reset_launch_counts()
    errors = {}
    crops = {}
    for mode, exact in (("fast", False), ("exact", True)):
        synt = synthesize(model, torch.Generator(device=dev).manual_seed(args.seed + 2),
                          poses, add_noise=True, exact=exact)
        joints = estimator.predict(synt.dms * 100.0)
        gt = synt.xyz.cpu().numpy()
        if not (joints.shape == gt.shape == (MAIN_BATCH, 41, 3)):
            fail(f"{mode}: joints shape {joints.shape}")
        errors[mode] = float(np.linalg.norm(joints - gt, axis=-1).mean())
        crops[mode] = (synt.dms * 100.0, joints)
    torch.cuda.synchronize()
    launches = {**raster_cuda.LAUNCHES, **upsample.LAUNCHES}
    log(f"[4] B={MAIN_BATCH} mean joint error fast {errors['fast']:.3f} mm, exact "
        f"{errors['exact']:.3f} mm; launches {launches}")
    for mode, err in errors.items():
        if not err < 25.0:
            fail(f"{mode} mean joint error {err} mm >= 25")
    for name in SERVING_KERNELS + ("upsample2x_fwd",):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the main path")
    cpu_est = PoseEstimator(params, num_stacks=1, denoise=True, precision="highest",
                            device="cpu")
    dms_fast, joints_fast = crops["fast"]
    cpu_joints = cpu_est.predict(dms_fast.cpu())
    cpu_diff = float(np.abs(cpu_joints - joints_fast).max())
    log(f"    same crops on the CPU: max |diff| {cpu_diff:.3g} mm")
    if not cpu_diff <= 1e-2:
        fail(f"GPU vs CPU serving max |diff| {cpu_diff} mm > 1e-2")

    # ---------------------------------------------------------------- 5
    kernel_rows = []
    for batch in BATCHES:
        tr, rand_f, planes = hand_planes(batch, args.seed + 3)
        fv = face_vertices(planes)
        _, box_f = raster_cuda.prepass_fast(planes=planes)
        _, box_e = raster_cuda.prepass_exact(planes=planes)
        t = {
            "render_fast_ms": time_ms(lambda: render_depth_64(model, tr, rand_f), REPS),
            "render_exact_ms": time_ms(
                lambda: render_depth_64(model, tr, rand_f, exact=True), REPS),
            "raster_fast_pooled_ms": time_ms(lambda: raster_cuda.launch_raster_fast_pooled(
                planes, samples, samples, 100.0), REPS),
            "raster_exact_ms": time_ms(lambda: raster_cuda.launch_raster_exact(
                planes, samples, samples, 640, 640), REPS),
            "plain_fast_ms": time_ms(lambda: raster_cuda.raster_fast_plain(
                *raster_cuda.prepass_fast(planes=planes), samples, samples, 100.0),
                REPS, warmup=1),
            "plain_exact_ms": time_ms(
                lambda: rasterize_depth(fv, samples, samples), REPS, warmup=1),
            "prepass_fast_ms": time_ms(
                lambda: raster_cuda.prepass_fast(planes=planes), REPS),
            "prepass_exact_ms": time_ms(
                lambda: raster_cuda.prepass_exact(planes=planes), REPS),
        }
        if batch == MAIN_BATCH:
            dms_mm = dms_fast
            t["predict_ms"] = time_ms(lambda: estimator.predict(dms_mm), REPS)
        # bounds: the planes, samples and canvas once; operations from the
        # face setups, face-sample tests and face-columns these hands need
        n = samples.numel()
        t["raster_fast_pooled_bound"], t["fast_counts"] = ztile_bound(
            box_f, samples, samples, batch * (n // 2) ** 2, ZTILE_FAST_OPS)
        t["raster_exact_bound"], t["exact_counts"] = ztile_bound(
            box_e, samples, samples, batch * n * n, ZTILE_EXACT_OPS)
        log(f"[5] B={batch} " + json.dumps(t))
        if batch != MAIN_BATCH:
            continue
        # the kernels at the main path's batch, held to the same limits as
        # in phase 3
        exact_err, fast_err, *_ = compare(fv, samples, 640, f"main batch B={batch}")
        log(f"    B={batch}: exact |diff| max {exact_err:.3g}, fast |diff| max {fast_err:.3g}")
        for name, err, plain_key, src in (
            ("raster_fast_pooled", fast_err, "plain_fast_ms", 633),
            ("raster_exact", exact_err, "plain_exact_ms", 756),
        ):
            b_ms, b_by = t[f"{name}_bound"]
            kernel_rows.append({
                "name": name, "route": "cuda", "source": "spherehand_torch/csrc/raster.cu",
                "replaces": f"spherehand_tpu/render/raster_pallas.py:{src}",
                "launches": launches[name], "max_abs_err": err, "ms": t[f"{name}_ms"],
                "plain_ms": t[plain_key], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })

    # ---------------------------------------------------------------- 6
    size = 64
    real = render_multiview_batch(model, torch.Generator(device=dev).manual_seed(args.seed + 4),
                                  EngineConfig().real_batch)
    sph_centers, sph_target, sph_radii, num_views = sphere_inputs(model, real)
    adv = [torch.as_tensor(a, device=dev) for a in sphere_adversarial_case(views=num_views)]
    edge = [torch.as_tensor(a, device=dev) for a in sphere_edge_case(views=num_views)]
    sphere_stats = {}
    for tag, (c, t, r) in (("hands N=%d" % sph_centers.shape[0], (sph_centers, sph_target, sph_radii)),
                           ("adversarial", adv), ("edge", edge)):
        st = contracts.sphere_kernel_stats(c, t, r, size, num_views,
                                           torch.Generator(device=dev).manual_seed(args.seed + 5))
        ties = contracts.sphere_tie_violations(st) if tag == "adversarial" else 0
        st.pop("kernel")
        log(f"[6] sphere kernels, {tag}: {json.dumps(st)}; tie violations {ties}")
        if not contracts.sphere_ok(st) or ties:
            fail(f"sphere kernels vs plain versions ({tag}): {st}, tie violations {ties}")
        sphere_stats[tag] = st
    main_sphere = sphere_stats["hands N=%d" % sph_centers.shape[0]]

    # ---------------------------------------------------------------- 7
    cfg = EngineConfig()
    fns = build_steps(cfg, hand=model)
    state = train_state_from_params(fns.init_state, params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    before = [p.detach().clone() for p in state.network.parameters()]
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    sphere_cuda.reset_launch_counts()
    upsample.reset_launch_counts()
    t0 = time.perf_counter()
    train_real = render_multiview_batch(model, gen, cfg.real_batch)
    real_batch = RealBatch(*train_real[:4])
    train_metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = fns.synt_step(state, cfg.lr, fns.draw(gen, real=False))
        train_metrics.append(("synt", m))
    for is_mv in (True, True, False):
        state, m, _ = fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch, is_mv)
        train_metrics.append((f"combined is_mv={is_mv}", m))
    eval_metrics, denoised = fns.eval_step(state, fns.draw(gen, synt=False), real_batch)
    train_metrics.append(("eval", eval_metrics))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {**raster_cuda.LAUNCHES, **sphere_cuda.LAUNCHES, **upsample.LAUNCHES}
    for name, m in train_metrics:
        vals = {k: float(v) for k, v in m.items()}
        log(f"[7] {name}: {json.dumps(vals)}")
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{name}: a metric is not finite: {vals}")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, state.network.parameters()))
    log(f"    {train_s:.2f} s; parameters moved {moved}/{len(before)}; launches {train_launches}")
    if moved != len(before) or tuple(denoised.shape) != (cfg.real_batch, 41, 3):
        fail(f"training moved {moved}/{len(before)} parameters, eval shape {tuple(denoised.shape)}")
    for name in SERVING_KERNELS + FUSED_SPHERE_KERNELS + tuple(upsample.LAUNCHES):
        if train_launches[name] < 1:
            fail(f"kernel {name} was not launched on the training path")

    # ---------------------------------------------------------------- 8
    with np.load(GRAD_PARITY) as gold:
        gp_dms, gp_poses, gp_inv = (np.asarray(gold[k], np.float32)
                                    for k in ("real_dms", "real_poses", "real_inv_poses"))
    small = EngineConfig(synt_batch=8, real_batch=gp_dms.shape[0])
    side_fns = {"gpu": build_steps(small, hand=model),
                "cpu": build_steps(small, hand=load_hand_model(device="cpu"))}
    draws = side_fns["cpu"].draw(torch.Generator().manual_seed(args.seed + 7))
    # one synthetic batch, rendered on the card, handed to both sides
    gpu_draws = draws.to(dev)
    synt = synthesize_from_draws(model, gpu_draws.poses, gpu_draws.synthesis)
    sides = {}
    for side, sdev in (("gpu", dev), ("cpu", torch.device("cpu"))):
        sfns = side_fns[side]
        sstate = train_state_from_params(sfns.init_state, params)
        sbatch = RealBatch(*(torch.as_tensor(a, device=sdev) for a in
                             (gp_dms, np.zeros(gp_dms.shape[:2] + (36, 3), np.float32),
                              gp_poses, gp_inv)))
        with float32_precision("highest"):
            _, terms, grads = sfns.combined_grads(
                sstate, draws.to(sdev), sbatch, True,
                synt=type(synt)(*(x.to(sdev) for x in synt)))
        sides[side] = ({k: float(v) for k, v in terms.items()},
                       {k: float(g.norm()) for k, g in grads.items()})
    term_rel = max(abs(sides["gpu"][0][k] - v) / max(abs(v), 1e-12)
                   for k, v in sides["cpu"][0].items() if v != 0.0)
    gnorm_rel = max(abs(sides["gpu"][1][k] - v) / max(v, 1e-30)
                    for k, v in sides["cpu"][1].items())
    log(f"[8] combined_grads GPU vs CPU (8 + {gp_dms.shape[0]}x{gp_dms.shape[1]}, TF32 off): "
        f"terms max rel {term_rel:.3g}, gradient norms max rel {gnorm_rel:.3g}; "
        f"GPU terms {json.dumps(sides['gpu'][0])}")
    if not (term_rel <= GPU_CPU_TERM_REL and gnorm_rel <= GPU_CPU_GNORM_REL):
        fail(f"GPU vs CPU combined_grads: terms {term_rel}, gradient norms {gnorm_rel}")

    # ---------------------------------------------------------------- 9
    sph = sphere_timings(sphere_cuda, sphere_cuda.BOTH, sph_centers, sph_target, sph_radii,
                         size, num_views)
    sph.update({
        "synt_step_ms": time_ms(
            lambda: fns.synt_step(state, cfg.lr, fns.draw(gen, real=False)), REPS),
        "combined_step_ms": time_ms(
            lambda: fns.combined_step(state, cfg.lr, fns.draw(gen), real_batch, True), REPS),
        "eval_step_ms": time_ms(
            lambda: fns.eval_step(state, fns.draw(gen, synt=False), real_batch), REPS),
    })
    n_img, num_j = sph_centers.shape[:2]
    log(f"[9] N={n_img} J={num_j} S={size}; steps at {cfg.synt_batch} + {cfg.real_batch}x"
        f"{num_views}: " + json.dumps(sph))
    kernel_rows += sphere_rows(sphere_cuda, sphere_cuda.BOTH, sph, main_sphere, train_launches)

    # --------------------------------------------------------------- 10 (a)
    sc = sphere_cuda
    gathered = sc.gathered_target(sph_target, n_img, num_views).contiguous()
    field_sets = {
        f"hands N={n_img}": {sc.DEPTH: (sph_centers, None, sph_radii, 1),
                             sc.DIST: (sph_centers, gathered, sph_radii, 1),
                             sc.BOTH: (sph_centers, sph_target, sph_radii, num_views)},
        "adversarial": {f: (adv[0], adv[1], adv[2], num_views) for f in (sc.DEPTH, sc.DIST, sc.BOTH)},
        "edge": {f: (edge[0], edge[1], edge[2], num_views) for f in (sc.DEPTH, sc.DIST, sc.BOTH)},
    }
    field_stats = {}
    for tag, by_fields in field_sets.items():
        fused_planes = contracts.split_fused_planes(sc.launch_fields(
            sc.BOTH, *by_fields[sc.BOTH][:3], size, by_fields[sc.BOTH][3], residuals=True))
        for fields in (sc.DEPTH, sc.DIST):
            c, t, r, views = by_fields[fields]
            st = contracts.sphere_kernel_stats(
                c, t, r, size, views, torch.Generator(device=dev).manual_seed(args.seed + 8),
                fields)
            ties = contracts.sphere_tie_violations(st) if tag == "adversarial" else 0
            same = all(contracts.same_bits(a, b)
                       for a, b in zip(st.pop("kernel")["fwd"], fused_planes[fields]))
            name = sc.LAUNCH_PREFIX[fields]
            log(f"[10a] {name} kernels, {tag}: {json.dumps(st)}; tie violations {ties}; "
                f"planes equal to the fused kernel's: {same}")
            if not (contracts.sphere_ok(st) and ties == 0 and same):
                fail(f"{name} kernels ({tag}): {st}, tie violations {ties}, equal to fused {same}")
            field_stats[(tag, fields)] = st

    # --------------------------------------------------------------- 10 (b)
    net = train_state_from_params(fns.init_state, params).network
    mp_args = (train_real.poses, train_real.inv_poses)
    with float32_precision("highest"):
        joints = estimator_forward(
            net, real_dms=train_real.dms * Constants().depth_scale).real_xyz[-1]
        torch.cuda.synchronize()
        sphere_cuda.reset_launch_counts()
        checks = {}
        for is_mv in (True, False):
            loss_u, _ = mutual_projection_loss(*mp_args, joints, train_real.dms, sph_radii,
                                               is_mv=is_mv, fused=False)
            (g_u,) = torch.autograd.grad(loss_u, joints, retain_graph=True)
            loss_f, _ = mutual_projection_loss(*mp_args, joints, train_real.dms, sph_radii,
                                               is_mv=is_mv, fused=True)
            (g_f,) = torch.autograd.grad(loss_f, joints, retain_graph=True)
            checks[is_mv] = (float(loss_u.detach()), float(loss_f.detach()),
                             abs(float(loss_u.detach()) - float(loss_f.detach())) / abs(float(loss_f.detach())),
                             float((g_u - g_f).abs().max() / g_f.abs().max()))
            if is_mv:
                net.zero_grad(set_to_none=True)
                loss_u.backward(retain_graph=True)
        with torch.no_grad():
            mutual_projection_loss(*mp_args, joints, train_real.dms, sph_radii, fused=False)
        torch.cuda.synchronize()
    field_launches = dict(sphere_cuda.LAUNCHES)
    grads_finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                       for p in net.parameters())
    log(f"[10b] unfused vs fused mutual projection at {tuple(joints.shape)} (TF32 off), "
        f"is_mv -> (unfused, fused, value rel, joint grad rel): {json.dumps(checks)}; "
        f"parameter gradients finite {grads_finite}; launches {field_launches}")
    for is_mv, (_, _, v_rel, g_rel) in checks.items():
        if not (v_rel <= UNFUSED_LOSS_REL and g_rel <= UNFUSED_GRAD_REL):
            fail(f"unfused vs fused loss (is_mv {is_mv}): value {v_rel}, joint gradient {g_rel}")
    if not grads_finite:
        fail("a parameter gradient of the per-field path is not finite")
    for name in PER_FIELD_KERNELS:
        if field_launches[name] < 1:
            fail(f"kernel {name} was not launched on the per-field path")

    # --------------------------------------------------------------- 10 (c)
    torch.cuda.synchronize()
    raster_cuda.reset_launch_counts()
    parity = kernel_parity.run(dev, args.seed + 9)
    torch.cuda.synchronize()
    fast_launches = raster_cuda.LAUNCHES["raster_fast"]
    with np.load(SPHERE_PARITY) as gold:
        tpu_loss, tpu_norm = float(gold["stack_loss"]), float(gold["stack_grad_norm"])
    loss_rel = abs(parity["stack_loss"] - tpu_loss) / abs(tpu_loss)
    norm_rel = abs(parity["stack_grad_norm"] - tpu_norm) / abs(tpu_norm)
    log(f"[10c] kernel_parity: {json.dumps(parity)}; against the TPU's stack_loss {loss_rel:.3g}, "
        f"gradient norm {norm_rel:.3g}; raster_fast launches {fast_launches}")
    sphere_rel = max(parity[k] for k in parity if k.endswith(("_fwd_rel", "_grad_rel", "_val_rel")))
    if not (parity["fast_iou"] > FAST_IOU_MIN and parity["fast_p99_diff"] < FAST_P99_MAX
            and parity["fastpool_median"] < FASTPOOL_MEDIAN_MAX
            and parity["exact_coverage_match"] == 1.0 and parity["exact_median_diff"] == 0.0
            and sphere_rel <= contracts.SPHERE_BWD_REL
            and loss_rel <= STACK_LOSS_REL and norm_rel <= STACK_GRAD_NORM_REL):
        fail(f"kernel_parity out of contract: {parity}; stack loss {loss_rel}, norm {norm_rel}")

    def check_fast(planes, sx, sy, tag):
        """raster_fast from the planes against its plain version on the
        fast pre-pass's records, bit for bit, then again and on the
        reversed face order."""
        kern = raster_cuda.launch_raster_fast(planes, sx, sy)
        plain = raster_cuda.raster_fast_plain(*raster_cuda.prepass_fast(planes=planes), sx, sy)
        again = raster_cuda.launch_raster_fast(planes, sx, sy)
        flipped = raster_cuda.launch_raster_fast(reversed_faces(planes), sx, sy)
        torch.cuda.synchronize()
        err = max_abs_diff(kern, plain)
        same = [contracts.same_bits(kern, x) for x in (plain, again, flipped)]
        if not all(same):
            fail(f"{tag}: raster_fast vs plain max |diff| {err}; "
                 f"bit for bit against plain, again, reversed: {same}")
        return kern, err

    fast_rows, fast_err = {}, {}
    for batch in BATCHES:
        _, _, planes = hand_planes(batch, args.seed + 3)
        _, fast_err[batch] = check_fast(planes, samples, samples, f"hands B={batch}")
        fast_rows[batch] = planes
    gen_grid = torch.Generator(device=dev).manual_seed(args.seed + 10)
    grid_x = torch.sort(torch.rand(100, generator=gen_grid, device=dev) * 640.0).values
    grid_y = (torch.linspace(0.0, 1.0, 77, device=dev) ** 2) * 639.0
    check_fast(fast_rows[MAIN_BATCH], grid_x, grid_y, "non-uniform 100 x 77 grid")
    canvas = torch.arange(CANVAS, dtype=torch.float32, device=dev)
    _, _, canvas_planes = hand_planes(CANVAS_BATCH, args.seed + 11)
    check_fast(tuple(p[:CANVAS_CHECK_BATCH].contiguous() for p in canvas_planes), canvas, canvas,
               f"{CANVAS} x {CANVAS} canvas B={CANVAS_CHECK_BATCH}")
    flips = {}
    for name, faces, fsize in adversarial_cases():
        s_adv = samples if fsize == 640 else torch.arange(fsize, dtype=torch.float32, device=dev)
        fv_adv = torch.as_tensor(faces, device=dev)
        kern, _ = check_fast(raster_cuda.planes_of(fv_adv), s_adv, s_adv, name)
        exact_adv = rasterize_depth(fv_adv, s_adv, s_adv, fsize, fsize)
        flips[name] = float(((kern < 999) != (exact_adv < 999)).float().mean())
    log(f"[10c] raster_fast vs plain: bit for bit, again and on the reversed face order, at "
        f"B={', '.join(map(str, BATCHES))}, on the non-uniform grid, on the {CANVAS} x {CANVAS} "
        f"canvas and on the adversarial sets; fast-vs-exact flips {json.dumps(flips)}")
    if not max(flips.values()) < ADVERSARIAL_FLIP_MAX:
        fail(f"raster_fast vs exact coverage flips on the adversarial sets: {flips}")
    if fast_launches < 1:
        fail("kernel raster_fast was not launched by kernel_parity")

    # --------------------------------------------------------------- 10 (d)
    timings = {}
    for fields, target, views in ((sc.DEPTH, None, 1), (sc.DIST, gathered, 1)):
        timings.update(sphere_timings(sc, fields, sph_centers, target, sph_radii, size, views))
    fast_shapes = {f"B{b}": (planes, samples) for b, planes in fast_rows.items()}
    fast_shapes[f"B{CANVAS_BATCH}_canvas{CANVAS}"] = (canvas_planes, canvas)
    for key, (planes, grid) in fast_shapes.items():
        batch, num_faces = planes[0].shape[0], planes[0].shape[1] // 3
        timings[f"raster_fast_ms_{key}"] = time_ms(
            lambda: raster_cuda.launch_raster_fast(planes, grid, grid), REPS)
        if grid is samples:
            timings[f"plain_raster_fast_ms_{key}"] = time_ms(
                lambda: raster_cuda.raster_fast_plain(
                    *raster_cuda.prepass_fast(planes=planes), grid, grid),
                PLAIN_REPS if batch == MAIN_BATCH else 2, warmup=1)
        # the planes, both sample vectors and the raw canvas once; the face
        # setups and face-sample tests these hands need
        _, box_f = raster_cuda.prepass_fast(planes=planes)
        timings[f"raster_fast_bound_{key}"], timings[f"raster_fast_counts_{key}"] = ztile_bound(
            box_f, grid, grid, batch * grid.numel() ** 2, ZTILE_FAST_OPS)
        tiles_x, tiles_y = raster_cuda.ztiles(grid.numel(), grid.numel())
        if raster_cuda.bins_faces(grid.numel(), grid.numel()):
            timings[f"raster_fast_scratch_bytes_{key}"] = 4 * batch * tiles_x * tiles_y * (
                num_faces + 1)
    log(f"[10d] N={n_img} J={num_j} S={size}; raster_fast on 128 x 128 samples and the "
        f"{CANVAS} x {CANVAS} canvas: " + json.dumps(timings))
    for fields in (sc.DEPTH, sc.DIST):
        kernel_rows += sphere_rows(sc, fields, timings, field_stats[(f"hands N={n_img}", fields)],
                                   field_launches)
    b_ms, b_by = timings[f"raster_fast_bound_B{MAIN_BATCH}"]
    kernel_rows.append({
        "name": "raster_fast", "route": "cuda", "source": "spherehand_torch/csrc/raster.cu",
        "replaces": "spherehand_tpu/render/raster_pallas.py:524", "launches": fast_launches,
        "max_abs_err": fast_err[MAIN_BATCH], "ms": timings[f"raster_fast_ms_B{MAIN_BATCH}"],
        "plain_ms": timings[f"plain_raster_fast_ms_B{MAIN_BATCH}"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    })

    # --------------------------------------------------------------- 11
    launch_limits(raster_cuda, sphere_cuda, hand_planes, samples, sph_centers, sph_target,
                  sph_radii, size, num_views)

    # --------------------------------------------------------------- 12
    engine_phase(model, dev, args.seed, smi)

    # --------------------------------------------------------------- 13
    switches_phase(model, params, samples, dev, args.seed, smi)

    # --------------------------------------------------------------- 14
    parallel_phase(model, params, dev, args.seed, smi)

    # --------------------------------------------------------------- 15
    bench_phase(smi)

    # --------------------------------------------------------------- 16
    evidence_phase(model, params, *crops["fast"], dev, args.seed, smi)

    # --------------------------------------------------------------- 17
    up_times, up_checks = upsample_phase(fns, state, cfg, real_batch, estimator, dms_fast, dev,
                                         args.seed, smi)
    kernel_rows += upsample_rows(train_launches, up_times, up_checks)

    # --------------------------------------------------------------- 18
    recipe_phase(model, params, dev, args.seed, smi)

    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
