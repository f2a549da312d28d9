#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each timed; any failure exits non-zero and prints no result:

1. environment: torch, CUDA, and the card's name and power limit;
2. build: one nvcc for each of ``isbfsar_tpu_torch/csrc/fused_i420.cu``
   and ``csrc/head_pose.cu``, started together, with ptxas's register and
   spill report;
3. kernels: the fused I420 kernel against its plain PyTorch version on the
   card at every ``KERNEL_SHAPES`` entry, at its batch and at B=1 (BGR
   bit-equal, YOLO atol 1e-5), with its time at B=16 and at B=1, the plain
   version's time and the bounds; the focus-geometry kernel (the head-pose
   solve and the geometry after it) against its plain version
   (``ops/head_pose.py::focus_geometry_reference``) in all six outputs at
   B=1, 8 and 16 on random face landmarks, on the committed face frames'
   landmarks and on six landmarks at one pixel, with its Newton steps, its
   time at B=16 and B=1, the plain version's (a synchronised host loop:
   ``torch.linalg.svd`` waits for the host, so no graph holds it) and its
   bound;
4. small input: the whole slice with focus at the trained CI operating
   point (pose-ci-motions, focus-ci at ``CI_FOCUS_CFG``, float32) with
   CUDA graphs on the card, on smoke and face frames, against the same
   slice on the CPU (which the tests hold against the JAX package), its
   ``stream_batched`` (B=8) against its ``step``, and both against the
   eager step on the card (``cuda_graphs=False``); at least one frame must
   find a face; both kernels' launches are counted under graph replay;
5. the slice at full width: 640x480 I420 -> YOLOv4 @ 256 -> EfficientNetV2-L
   @ 256 crop -> TRX match, bf16, and focus (``FocusConfig()``: gaze crop
   224, bf16) through ``FusedPipeline.step`` (20 frames) and
   ``stream_batched`` (64 frames, B=16) with CUDA graphs, built by
   ``profile_slice.build_slice``: the calibrated production detector (the
   124 MB pose-prod-256-calib bundle entry) with EfficientNetV2-L and the
   head random from seed 0, at the 0.3 gate, and the trained focus-ci
   nets. The 351 MB pose-prod-256 base does not fit the card machine's
   copy of the repo. At least one frame must fire at the gate and one find
   a face, and the ``step`` p50 must be under one 30 FPS frame period
   (33 ms). Launch counts are zeroed just before the graphs drive the path
   and read just after; the same frames then run eagerly
   (``cuda_graphs=False``) as the oracle of the graphs, and the eager p50
   is printed for the record, as are the focus-off ``step`` p50 and the
   device ms and kernels per frame with focus on and off;
6. serve, at the same widths: (a) ``python -m
   isbfsar_tpu_torch.runtime.serve --fused --weights random --yolo-thresh
   0.0`` as a subprocess behind a queue hub in this process, driven by
   ``run_source`` over synthetic 640x480 frames with add, save, remove,
   load, a bogus command and quit, each sent once the previous one's log
   line has come (and, after add, its action has scored): the ACK must
   come before the acquisition, every log line must come, the service must
   exit 0 within a deadline, and it must count launches of both kernels;
   (b) on ``build_slice`` and BGR camera frames: the orchestrator's
   overlapped and synchronous ``get_frame`` (p50 of the overlapped under
   33 ms; overlapped equal to synchronous one frame late, exactly),
   ``get_frame_batch(overlap=True)`` at B=16, the eager module path, and
   ``MultiStreamPipeline`` with 4 streams at B=16, each stream against a
   single-stream twin that keeps its frames in their rows of the
   multi-stream step (``TOL_BATCHED``); both kernels' launches are counted
   on every path and held to the dispatches;
7. train: the recognizer's trainer and offline evaluation at the
   production ``ARConfig`` (way 5, seq_len 16, 30 joints, DISC head, batch
   32, lr 1e-2) on two synthetic trees written by ``train/synthetic.py``
   (30 classes x 4 clips to train on: the train CLI's 80/20 split then
   leaves 6 validation classes, which a 5-way episode and its unknown class
   need; 5 classes x 4 clips held out). ``Trainer.fit`` runs 3 epochs of 5
   steps (``TRAIN_N_TASK``; epoch 0 validates), its ``train/fs_loss`` must
   fall from epoch 1 to 2, and it must write {1,2}.msgpack, which
   ``load_checkpoint`` reads back as the trained weights. The first 5 train
   steps run on the card and on the CPU from one init on the same batches
   (losses and every parameter within ``TOL_TRAIN``, ``fs_correct`` and the
   gate equal; the CPU takes the card's side of each ReLU whose input the
   two put on either side of zero within ``RELU_TIE``), and so do ``evaluate_fsos`` (k 5, 3 repeats, batch 8) and
   ``calibrate_os_threshold`` with the trained weights (scores within
   ``TOL_FSOS_SCORE``; ``known``, ``fs_correct``, the metrics and the
   threshold equal). The train and eval CLIs run on the card as
   subprocesses, beside those comparisons. It prints the train step's p50
   and episodes/s (the card synchronised around each step of ``fit``), the
   loader's time per batch beside it, and FSOS queries/s. Neither kernel is
   on this path: both counts must stay 0;
8. rgb and hybrid: (a) each at the trained CI operating point with focus
   and the ResNet-50 RGB extractor at a 64 crop (``build_ci``, float32),
   with CUDA graphs on the card, against the same pipeline on the CPU
   (which the tests hold against the JAX package) in the packed fields
   and the final feature ring, and its ``stream_batched`` (B=8) against
   its ``step`` (``TOL_CI_RGB``); (b) each at full width
   (``build_slice(input_type=...)``: 640x480 I420, the calibrated
   detector, the ResNet-50 at 224 in float32 from seed 0, seq_len 8, two
   random support actions, focus on; rgb runs the detector alone, hybrid
   adds the random EfficientNetV2-L) through ``step`` (16 frames) and
   ``stream_batched`` (64 frames, B=16) with CUDA graphs: graphs equal to
   the eager oracle exactly, batched within ``TOL_BATCHED_RGB``
   of per-frame, the ``step`` p50 under 33 ms, rgb's ``decode`` without a
   pose, each kernel launched once per dispatch; (c) the orchestrator's
   module path on BGR camera frames in each mode (the eager estimator and
   focus, the host crop, 8 ResNet-50 forwards a frame), its p50 recorded
   without a limit, and one ``add`` acquisition on a fake clock that the
   recognizer then scores; the I420 kernel launches 0 times there and
   the focus kernel once a frame.
9. rgb and hybrid training: (a) at the CI size (a 32 crop, batch 2,
   ``episodic_batch``) 3 train steps on the card and on the CPU, each from
   the card's state, with the losses, every parameter and every running
   stat within ``TOL_TRAIN_RGB`` and ``fs_correct`` and the gate equal;
   (b) at full width (``ARConfig.for_input``: the ResNet-50 at 224 in
   float32, seq_len 8, way 5; batch 4, cut from 32 for memory) on batches
   of the loader over a synthetic tree of 224x224 PNG crops: one step
   without remat and one with from one init and batch (cuDNN
   deterministic; peak memory, the remat peak at most ``REMAT_PEAK_RATIO``
   of the other, the two steps equal within ``TOL_REMAT``), then 5 timed
   steps (p50 and episodes/s) with the loader's p50 per batch beside them,
   every loss finite; (c) ``train_cli --input-type rgb --remat`` on a
   30-class tree of 64x64 crops and ``eval_cli fsos --input-type rgb`` on
   its checkpoint, which must hold the ResNet-50's running stats, as
   subprocesses beside (a). Neither kernel is on this path: both counts
   must stay 0.
10. the estimator's other options and the synthetic humanoid: (a) a
   rendered ``wave`` clip (the port's renderer, numpy, no cv2) at the CI
   size through the module-path estimator on ``pose-ci-motions`` in
   float32 at num_aug 0, 4 ("aug0") and 5 ("mean"), card against CPU
   (``TOL_TTA_CI``; boxes, found and visible equal; a frame must fire at
   0.3), and ``postprocess_yolo`` at ``HPEConfig``'s NMS threshold and
   max_det 64 on the card's YOLO outputs, card against CPU exactly, with
   its time and the kernel nodes of one call's CUDA graph; (b) 32
   frames of ``HumanoidSource(640, 480)`` (bench.py's headline wave
   traffic) as I420 through ``build_slice`` with num_aug=5 ("mean"), focus
   on, bf16 at full width: ``step`` on 16 frames and ``stream_batched`` on
   64 at B=16 with CUDA graphs, equal to the eager oracle, batched within
   ``TOL_BATCHED_TTA`` of per-frame (the detector's box and conf equal to
   num_aug=0's at each batch size, and num_aug=0's held to the same box
   limit), a frame firing at 0.3, each kernel once a dispatch; the ``step`` p50 beside num_aug=0's on the same nets and
   frames, frames/s, device ms and kernels a frame; (c) the offline
   workflow (render, extract with 122 joints at the 0.3 gate, train,
   FSOS) at CI size on ``pose-diverse-256``, cut as ``WORKFLOW_KW`` says,
   with its stage walls and receipt, and one clip's extraction card
   against CPU in float32 (``TOL_EXTRACT``). Neither kernel runs in (a)
   and (c): both counts must stay 0 there.

11. the synthetic trainers: (a) at the CI size, one step of each of the
   five trainers on the card and on the CPU from one init and one batch
   (``YoloTrainer`` at width 0.25 and 128, ``HeatmapTrainer`` at
   ``V2_TINY`` with a 128 crop, the three focus trainers at
   ``CI_FOCUS_CFG``): the loss, the gradients (Adam's first moment), the
   parameter update and the running stats within that trainer's
   ``TOL_SYNTH_TRAIN``; the heatmap step again with TF32 on, which must
   fail its limits (a check that they see such a fault); the gaze crop
   and labels at ``FocusConfig()``, batch 8, made through the
   focus-geometry kernel on the card and held against
   ``focus_geometry_reference`` (``TOL_GAZE_CROP``, ``TOL_GAZE_LABELS``);
   and ``evaluate_pose_stack`` on ``pose-ci-motions`` (a few scenes,
   float32) card against CPU, found and false-positive counts exact; (b)
   at the tool's ``--production`` sizes on 480x640 frames, batch 8:
   YoloTrainer at width 1.0 and 256 and HeatmapTrainer at ``V2_L`` with a
   256 crop, each one step without remat and one with from one init and
   batch (cuDNN deterministic; peak memory of each, the two steps equal
   within ``TOL_REMAT``), then a warm-up step and ``SYNTH_TIMED_STEPS``
   timed steps (p50, fastest and slowest) with the host sampler's time
   per batch beside them; ``finetune_detector`` from the bundled ``pose-prod-256-calib``
   YOLO branch (bf16 cast up to float32) and ``train_focus_params`` at
   ``FocusConfig()`` (224, bf16), each cut to ``SYNTH_FIT_STEPS`` steps
   a phase; every loss finite. 11a's path launches neither kernel (the
   gaze crop's check launches the focus-geometry kernel once, a
   comparison, not counted); 11b launches it once per gaze batch and the
   I420 kernel never.

The four weight files are required (``pose-ci-motions``, ``focus-ci``, the
``pose-prod-256-calib`` delta and ``pose-diverse-256``): a missing one
fails the run; phase 11 reads no other.

The ``[phases]`` line gives each phase's seconds, and the ``kernels``
line each kernel's launches by path, the paths of phase 10 included. The
last three lines are the card's ``nvidia-smi`` name and power limit, the
``kernels`` JSON object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from isbfsar_tpu_torch import weights
from isbfsar_tpu_torch.kernel_bench import (TOL_HEAD, face_cases, graph_ms, head_pose_bound,
                                            head_pose_errors, launch_ms, loop_ms, newton_steps)
from isbfsar_tpu_torch.models.layers import pin_float32_matmul
from isbfsar_tpu_torch.ops import build, fused_input, head_pose
from isbfsar_tpu_torch.ops.image import bgr_to_i420, i420_to_bgr
from isbfsar_tpu_torch.profile_slice import (build_ci, build_slice, ci_frames, profile_steps,
                                             slice_frames, twin)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_SHAPES = ((480, 640, 256, 16), (240, 320, 128, 8), (120, 160, 128, 3))  # H, W, S, B
TOL_BGR, TOL_YOLO = 0.0, 1e-5
# The focus-geometry kernel against its plain version on the card, field by
# field: kernel_bench.TOL_HEAD says how each is measured and why (the
# rotation 1e-5, the center 5e-6 of its distance).
# Phase 4 in float32 at CI size, the card against the CPU and the card's
# stream_batched (B=8) against its step. The homography is bit-equal on
# both and at every batch size (ops/geometry.py), so the crop gather takes
# the same pixels; what is left are the float32 convolutions' summation
# orders (stage_trace.py: the raw YOLO outputs are the first stage that
# differs between B=8 and B=1; box, homography and crop are equal). An H100
# read 2.4e-7 m in pose, 3.6e-7 m in pose_abs, 9.5e-7 m in distance, 5.4e-7
# in probs, 8.9e-8 in is_true, conf and bbox equal; and in the focus fields
# f_score 0, f_bbox 4.6e-5 px, f_landmarks 1.5e-4 px, f_head_position
# 8.6e-7 m, f_head_rotvec 4.6e-6, f_norm_head_rot2d 4.4e-6 and the gaze
# vectors 3.7e-6 (the landmark refiner's convolutions are the first focus
# stage that differs, stage_trace.py). The limits are two to four times that.
TOL_CI = {"pose": 1e-6, "pose_abs": 1e-6, "distance": 2e-6, "conf": 1e-6, "bbox": 0.0,
          "probs": 1.5e-6, "is_true": 5e-7, "f_score": 1e-6, "f_bbox": 2e-4,
          "f_landmarks": 6e-4, "f_head_position": 4e-6, "f_head_rotvec": 2e-5,
          "f_norm_head_rot2d": 2e-5, "f_gaze": 1.5e-5, "f_norm_gaze": 1.5e-5}
# Phase 4's and 5's graph replays against the eager step on the card:
# the same kernels on the same inputs, so bit-equal (an H100 read 0).
TOL_GRAPH = {k: 0.0 for k in TOL_CI}
# Phase 5, stream_batched vs step in bf16 at full width, a few times what an
# H100 read: the random trunk gathers the joints near one point, which leaves
# the absolute position ill-conditioned, so pose_abs and distance read
# millimetres there. The focus fields read f_score and f_bbox 0,
# f_landmarks 1.4e-3 px, f_head_position 6.6e-6 m, f_head_rotvec and
# f_norm_head_rot2d 8.9e-6, and the gaze vectors 1.2e-3 (the bf16 gaze net).
TOL_BATCHED = {"pose": 1e-6, "pose_abs": 1e-2, "distance": 2.5e-2, "conf": 1e-6, "bbox": 0.0,
               "probs": 2e-6, "is_true": 2e-6, "f_score": 1e-6, "f_bbox": 1e-3,
               "f_landmarks": 5e-3, "f_head_position": 3e-5, "f_head_rotvec": 4e-5,
               "f_norm_head_rot2d": 4e-5, "f_gaze": 5e-3, "f_norm_gaze": 5e-3}
FRAME_PERIOD_MS = 1e3 / 30  # the step must keep up with a 30 FPS camera
# Phase 6a: the service's command script, each command sent once the one
# before it has its log line and at least SPACING frames have passed (a
# command sent during an acquisition is swallowed, as in the reference).
SERVE_SCRIPT = (("add a", "Action a learned successfully!"),
                ("save", "Classes saved successfully in "),
                ("remove a", "Action a removed"),
                ("load", "Loaded 1 classes"),
                ("bogus", "Not a valid command!"),
                ("quit", None))
SPACING = 120
SERVE_DEADLINE_S = 420  # the service's start, warm-up and whole script
SERVING_FRAMES = 40
STREAMS, STREAM_BATCH, STREAM_TICKS = 4, 16, 64
# Phase 7: the card against the CPU on the first 5 train steps from one
# init and batch (float32, no TF32), and on the FSOS evaluation with the
# trained weights. Two runs on an H100 read at most 1.19e-7 in fs_loss,
# 5.96e-8 in os_loss and in the parameters, and 1.19e-7 in the FSOS scores;
# tests/test_torch_cuda.py's accumulated gradients (accumulation over 2)
# read 6.71e-8. The limits are three to five times that.
TOL_TRAIN = {"fs_loss": 3e-7, "os_loss": 3e-7, "params": 3e-7, "acc_grads": 3e-7}
# A ReLU whose input lies within rounding of zero can fall on one side on
# the card and on the other on the CPU, and that one decision moves the
# step's update far past TOL_TRAIN. ``python -m tests.torch_relu_ties
# --card`` on an H100 host: a step puts 4-5 ReLU inputs within 1e-6 of
# zero; flipping one of them in one CPU step moves the parameters by
# 4.9e-7 to 1.85e-5; over 8 sets of 5 loader batches one set split one
# input between the card and the CPU, and free-running from there the
# parameters parted by 8.57e-6 and fs_loss by 5.84e-6 (the 7 others read
# 1.49e-8-2.98e-8 and 1.19e-7). So the CPU's step takes the card's side
# of each ReLU whose input the two split while both lie within RELU_TIE of
# zero, and a split wider than that fails. The same run read the two
# runs' ReLU inputs at most 8.64e-7 apart, each step from one state; the
# bound is about five times that.
RELU_TIE = 4e-6
TOL_FSOS_SCORE = 5e-7
TRAIN_STEPS_CHECKED = 5
# 5 steps of 32 episodes an epoch (the JAX defaults' epoch is 10000 // 32):
# the loader reads 3,584 .npy files a batch, 1.8 s on the card machine's host
TRAIN_N_TASK = 160
FSOS_KW = dict(k=5, n_repeats=3, batch_size=8, collect_raw=True)
# Phase 8, rgb and hybrid. (a) The card against the CPU at the CI operating
# point (ResNet-50 at a 64 crop, float32), and the card's stream_batched
# (B=8) against its step, in the packed fields and the final feature ring.
# An H100 read, card against CPU, probs 1.32e-5 (rgb) and 4.3e-6 (hybrid),
# is_true 2.4e-7, the ring 1.01e-6 (of 0.91), the other fields within
# TOL_CI; batched against step probs 3.8e-6. The ResNet-50's convolutions
# sum in other orders on the card and the CPU, and the random recognizer's
# scores move with its features. The limits are about three times that.
TOL_CI_RGB = {**TOL_CI, "probs": 4e-5, "is_true": 1e-6, "window": 4e-6}
# (b) stream_batched (B=16) against step at full width: cuDNN's float32
# ResNet-50 algorithms depend on the batch size. An H100 read probs 1.52e-5
# (rgb) and 4.8e-7 (hybrid), is_true 1.2e-7; the other fields as in phase 5.
TOL_BATCHED_RGB = {**TOL_BATCHED, "probs": 5e-5}
RGB_MODES = ("rgb", "hybrid")
# frames per path at full width; within the whole run phase 8 took 19.8 s
# of its 30 s aim with 8 eager and 32 batched frames on an H100, so neither
# is cut (if it must be: the eager oracle to 8 frames, stream_batched to 32,
# then the module path to hybrid alone)
RGB_STEPS, RGB_BATCHED, RGB_EAGER = 16, 64, 16
RGB_MODULE_FRAMES = 12  # timed module-path frames per mode
# Phase 9, rgb and hybrid training, float32 without TF32. (a) The card
# against the CPU at the CI size (ARConfig.for_input(mode, rgb_size=32,
# batch_size=2), episodic_batch batches), 3 train steps with the
# discriminator on, each from the card's state: the losses, every parameter
# and every running-stat leaf after it. Each step starts from the same
# state because free-running trajectories part at this size: the random
# ResNet-50's batch statistics over 1x1 maps make its float32 gradients
# ill-conditioned, and two CPU runs that differ only in their thread count
# part by orders of magnitude a step (``python -m tests.torch_rgb_parity``).
# Four runs on an H100 read, rgb / hybrid: fs_loss up to 1.87e-3 / 1.23e-3
# (of 1-10), os_loss 1.5e-6 to 1.49e-5 / up to 6.3e-6 (it moves from run to
# run: cuDNN's backward convolutions are not deterministic), parameters
# 2.36e-2 / 4.1e-3 (the stem's updates, lr 3e-4 times gradients in the
# thousands, reach 0.75: the float32 gradient there is a few percent off in
# any two summation orders), running stats 1.68e-5 / 1.56e-5. The limits
# are three to four times the largest reading.
TOL_TRAIN_RGB = {"fs_loss": 6e-3, "os_loss": 6e-5, "params": 8e-2, "batch_stats": 6e-5}
RGB_TRAIN_CI_STEPS = 3
# (b) At full width (the ResNet-50 at 224, seq_len 8, way 5, the lr of
# for_input) on a synthetic tree with 224x224 PNG crops, 6 classes x 1 clip
# (a 5-way episode and its unknown class). Cut: batch 4, not the production
# 32: an episode pushes (5 + 1 + 1) x 8 = 56 frames through the ResNet-50
# with gradients, and at about 0.1-0.16 GB of float32 activations a frame
# batch 32 would need 190 GB or more. One step with remat against one
# without on the same batch (cuDNN deterministic), then 5 timed steps.
RGB_TRAIN_BATCH, RGB_TRAIN_STEPS = 4, 5
REMAT_PEAK_RATIO = 0.7  # remat's peak memory at most this share of the peak without
# With cuDNN deterministic the step with remat and the one without ran the
# same kernels on the same values: an H100 read 0 in both modes at 224 and
# at 112, so they must be bit-equal.
TOL_REMAT = {"params": 0.0, "batch_stats": 0.0}
# Phase 10, the estimator's other options on rendered humanoids. (a) The
# module-path estimator at the CI size (pose-ci-motions, float32) on the
# card against the CPU, at num_aug 0, 4 ("aug0") and 5 ("mean"): the
# homographies and crops are bit-equal on both (ops/geometry.py), so what
# is left are the float32 convolutions' summation orders: an H100 read
# 2.98e-7 m, 4.17e-7 m and 2.98e-7 m in pose and 0 in conf at the three
# settings. The limits are about five times that; boxes, found and
# visible must be equal.
TTA_MODES = ((0, "mean"), (4, "aug0"), (5, "mean"))
TOL_TTA_CI = {"pose": 2e-6, "conf": 5e-7}
TTA_CI_FRAMES = 8
# (b) Full width: num_aug=5 "mean" through build_slice with focus, on the
# HumanoidSource stream's wave clip (bench.py's headline traffic): 16 step
# frames, 64 stream_batched frames at B=16.
TTA_FULL = {"num_aug": 5, "tta_aggregate": "mean"}
TTA_STEPS, TTA_BATCHED = 16, 64
# stream_batched (B=16) against step (B=1) there: as TOL_BATCHED, but on
# these frames cuDNN's bf16 YOLO regresses a box edge 2 px apart at B=16
# and at B=1 (an H100 read 2 px at num_aug=5 and at num_aug=0; conf
# equal), and the crop, and so the pose, follow the box. The head's raw
# outputs are bf16 and a box's width and height are exp of two of them, so
# one bf16 place of such a logit (2^-8 to 2^-7 of it for logits in [0.5,
# 2)) moves an edge by that share of half the box: 0.6-1.2 px on a 300 px
# box, and 4 px is a few places. The smoke holds the cause too: the
# detector's box and conf equal num_aug=0's exactly at each batch size
# (TTA starts after the box), and num_aug=0's box and conf are held to the
# same limit between B=16 and B=1.
TOL_BATCHED_TTA = {**TOL_BATCHED, "bbox": 4.0}
# (c) The offline workflow at CI size on pose-diverse-256, cut from the
# tool's defaults (6 clips a class, 2 exemplar clips, 25 epochs of 160
# tasks, 5 FSOS repeats) to fit the run: 2 clips a class, 1 exemplar clip,
# 2 epochs of 16 tasks, 1 repeat. One clip's extraction on the card
# against the CPU in float32 (the workflow runs bf16, as JAX's does): the
# estimator's poses as in (a), smoothed on the host in float64; an H100
# read 1.94e-7 m, the limit is about five times that.
# On an H100 phase 10 read 45.7-48.2 s, the workflow 24.1-34.9 s of it
# (its host render and eager extraction), against a 45 s aim.
WORKFLOW_KW = dict(clips_per_class=2, exemplar_clips=1, n_epochs=2, n_task=16, fsos_repeats=1)
TOL_EXTRACT = 1e-6
EXACT = ("pose_ok", "ar_ready", "f_found")
KERNELS = (fused_input.fused_i420_inputs, head_pose.focus_geometry)

# Phase 11: the synthetic trainers. TOL_SYNTH_TRAIN holds one CI-size step
# on the card against the CPU from one init and batch: the loss, the
# gradient (Adam's first moment after the step) and the step's parameter
# update, each as one vector in relative L2, and the running stats (largest
# difference). Not each parameter: Adam's first update is about lr *
# sign(g), and in float32 YOLO's gradient entries that lie near zero take
# opposite signs on the two devices (on an H100 80GB HBM3 at 700 W: a full
# 2 lr apart while the gradient read 3.5e-3 in relative L2). Each trainer
# has its own limits, each about four times that trainer's reading on that
# card (the readings were the same in two runs; LandmarkRefiner's loss read
# 0 and is held to about seven float32 ulps of its 0.15):
#   yolo     loss 3.8e-6  grad 3.5e-3  update 5.9e-2  stats 9.1e-6
#   heatmap  loss 6.0e-8  grad 3.6e-6  update 9.3e-4  stats 3.6e-7
#   blaze    loss 2.4e-7  grad 1.1e-6  update 1.3e-5  stats 4.8e-7
#   lm       loss 0       grad 3.2e-6  update 1.6e-4  stats 1.2e-7
#   gaze     loss 2.9e-6  grad 1.7e-5  update 8.0e-4  stats 1.2e-6
TOL_SYNTH_TRAIN = {
    "yolo": {"loss": 1.5e-5, "grad_l2": 1.5e-2, "update_l2": 0.25, "stats": 4e-5},
    "heatmap": {"loss": 2.5e-7, "grad_l2": 1.5e-5, "update_l2": 4e-3, "stats": 1.5e-6},
    "blaze": {"loss": 1e-6, "grad_l2": 5e-6, "update_l2": 6e-5, "stats": 2e-6},
    "lm": {"loss": 1e-7, "grad_l2": 1.3e-5, "update_l2": 7e-4, "stats": 5e-7},
    "gaze": {"loss": 1.2e-5, "grad_l2": 7e-5, "update_l2": 3.2e-3, "stats": 5e-6},
}
# the kernel's gaze crops (RGB / 255) against the plain geometry's on the
# card: the approximate reciprocals move a sample point by about 1e-4 px
# (read 1.65e-4 at a 64 px crop on an H100 80GB HBM3 at 700 W); the gaze
# labels through the kernel's normalizing rotation (read 1.8e-7 rad)
TOL_GAZE_CROP = 7e-4
TOL_GAZE_LABELS = 1e-6
# evaluate_pose_stack card against CPU, in metres and IoU (read 6.0e-8 at
# most on that card); found and false-positive rates exact
TOL_EVAL = {"iou_mean": 1e-6, "rel_err_m": 1e-6, "abs_err_m": 1e-6, "dist_err_m": 1e-6}
SYNTH_BATCH = 8  # the tool's --batch default at --production
SYNTH_TIMED_STEPS = 10  # each timed trainer's steps (3 swung their p50 by 30%)
SYNTH_FIT_STEPS = 3  # finetune_detector's and train_focus_params' steps a phase
SYNTH_EVAL = dict(n_scenes=4, n_empty=3, n_hard_empty=2)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_bound(h: int, w: int, s: int, b: int):
    """(bound_ms, bound_by): bytes moved once over HBM rate vs the plain
    version's float32 operations over the non-tensor-core rate."""
    nbytes = b * (h * w * 3 // 2 + 12 * h * w + 12 * s * s)
    kr = fused_input.band_tables(h, s)[2]
    kc = fused_input.band_tables(w, s)[2]
    ops = b * (18 * h * w + 6 * (s * w * kr + s * s * kc) + 3 * s * s)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(rng) -> dict:
    """Every KERNEL_SHAPES entry at its batch and at B=1 against the plain
    version; times at the first shape, at B=16 and at B=1."""
    kern = fused_input.fused_i420_inputs
    entry = {"max_abs_err": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h, w, s, batch in KERNEL_SHAPES:
        for b in (batch, 1):
            plan = fused_input.choose_plan(h, w, s, b, sms)
            yuv = torch.from_numpy(rng.integers(0, 256, (b, h * 3 // 2, w), np.uint8)).cuda()
            bgr, yolo = kern(yuv, h, s)
            ref_bgr, ref_yolo = fused_input.fused_i420_reference(yuv, h, s)
            torch.cuda.synchronize()
            err_bgr = float((bgr - ref_bgr).abs().max())
            err_yolo = float((yolo - ref_yolo).abs().max())
            log(f"[kernel] {b}x{h}x{w} S={s} (G={plan.g}, {plan.smem_bytes} B shared): max|err| "
                f"bgr {err_bgr:.3g} (tol {TOL_BGR}), yolo {err_yolo:.3g} (tol {TOL_YOLO})")
            if not (err_bgr <= TOL_BGR and err_yolo <= TOL_YOLO):
                raise AssertionError("fused_i420_inputs disagrees with its plain version")
            entry["max_abs_err"] = max(entry["max_abs_err"], err_bgr, err_yolo)
            if (h, w, s) != KERNEL_SHAPES[0][:3]:
                continue
            # device time per launch from a CUDA graph of launches; a host
            # loop of launches reads the host's launch rate at B=1
            ms = graph_ms(lambda: kern(yuv, h, s))
            loop = loop_ms(lambda: kern(yuv, h, s))
            bound_ms, bound_by = kernel_bound(h, w, s, b)
            if b == 1:
                entry.update(ms_b1=ms, bound_ms_b1=bound_ms)
                log(f"[kernel] B=1 time {ms:.5f} ms (host loop {loop:.5f} ms), bound "
                    f"{bound_ms:.5f} ms ({bound_by}): launch latency, not bytes, sets it")
                continue
            plain_ms = loop_ms(lambda: fused_input.fused_i420_reference(yuv, h, s), reps=20)
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         shape=f"B={b} {h}x{w} S={s}")
            log(f"[kernel] time {ms:.5f} ms (host loop {loop:.5f} ms; {bound_ms / ms:.0%} of the "
                f"bound), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return entry


def check_head_pose(rng) -> dict:
    """The focus-geometry kernel against its plain version, all six outputs,
    at B=1, 8 and 16 on random face landmarks, on the face frames'
    landmarks at both sizes and on six landmarks at one pixel; times and
    bounds at B=16 and B=1."""
    launch = launch_ms()
    entry = {"err": dict.fromkeys(TOL_HEAD, 0.0)}
    cases = face_cases(rng)
    k = cases[0][2]
    pts = torch.tensor([[320.0, 240.0], [100.3, 50.7], [float(k[0, 2]), float(k[1, 2])]])
    cases.append(("six landmarks at one pixel", pts[:, None].expand(-1, 6, -1).contiguous().cuda(),
                  k, 224))
    for name, lms, kk, size in cases:
        err = head_pose_errors(lms, kk, size)
        out = head_pose.focus_geometry(lms, kk, out_size=size)
        steps = newton_steps(lms, kk, size)
        torch.cuda.synchronize()
        per_iteration = float(steps[:, 0].float().mean()) / 40
        log(f"[head pose] {name}, crop {size}: Newton steps {per_iteration:.2f} per iteration "
            f"(most {int(steps[:, 1].max())}); max|err| "
            + " ".join(f"{f} {v:.3g} (tol {TOL_HEAD[f]})" for f, v in err.items()))
        if not all(torch.isfinite(t).all() for t in out):
            raise AssertionError(f"focus_geometry: non-finite output on {name}")
        if not all(err[f] <= TOL_HEAD[f] for f in TOL_HEAD):
            raise AssertionError("focus_geometry disagrees with its plain version")
        if int(steps[:, 1].max()) >= head_pose.MAX_NEWTON:
            raise AssertionError(f"focus_geometry: a Newton solve reached its cap on {name}")
        entry["err"] = {f: max(entry["err"][f], err[f]) for f in TOL_HEAD}
        if not name.startswith(("B=1 ", "B=16 ")):
            continue
        ms = graph_ms(lambda: head_pose.focus_geometry(lms, kk, out_size=size))
        bound_ms = head_pose_bound(lms, kk, launch, size)
        log(f"[head pose] {name}: time {ms:.5f} ms, bound {bound_ms:.5f} ms (launch {launch:.5f} "
            f"ms + float64 operations)")
        if name.startswith("B=1 "):
            entry.update(ms_b1=ms, bound_ms_b1=bound_ms)
            continue
        # no graph holds the plain version: torch.linalg.svd waits for the host
        plain_ms = loop_ms(lambda: head_pose.focus_geometry_reference(lms, kk, out_size=size),
                           reps=5)
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, shape="B=16, 40 iterations")
        log(f"[head pose] {name}: plain {plain_ms:.3f} ms (synchronised host loop)")
    entry["max_abs_err"] = max(entry["err"].values())
    return entry


def check_close(what: str, got: list, want: list, tol: Optional[dict]) -> None:
    """Field-wise max |got - want| over paired packed outputs, logged beside
    each field's largest |value|; raises if a field is over its limit (the
    booleans must be equal). ``tol=None`` logs the differences only."""
    diff, mag = {}, {}
    for a, b in zip(got, want, strict=True):
        for key in b:
            x, y = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
            diff[key] = max(diff.get(key, 0.0), float(np.max(np.abs(x - y))))
            mag[key] = max(mag.get(key, 0.0), float(np.max(np.abs(y))))
    log(f"[{what}] max|diff| (max|value|): "
        + " ".join(f"{k}={diff[k]:.3g} ({mag[k]:.3g})" for k in diff))
    if tol is None:
        return
    over = [f"{k} {diff[k]} > {tol.get(k, 0.0)}" for k in diff
            if not diff[k] <= (0.0 if k in EXACT else tol[k])]
    if over:
        raise AssertionError(f"{what}: " + "; ".join(over))


def drive(pipe, step_frames: list, batch_frames: list, batch: int):
    """``step`` over ``step_frames``, a fresh stream, then ``stream_batched``
    over ``batch_frames``; returns (per-frame outputs, batched outputs, step
    latencies in s, stream_batched seconds)."""
    pipe.start()
    seq, lat = [], []
    for f in step_frames:
        t = time.perf_counter()
        seq.append(pipe.step(f))
        lat.append(time.perf_counter() - t)
    pipe.start()
    t = time.perf_counter()
    batched = list(pipe.stream_batched(batch_frames, batch))
    return seq, batched, lat, time.perf_counter() - t


def dispatches(n_steps: int, n_batched: int, batch: int) -> int:
    """Kernel launches of ``drive``: one per step, per batch and per tail frame."""
    return n_steps + n_batched // batch + n_batched % batch


def zero_launches() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launches() -> dict:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


def check_launches(where: str, counts: dict, want) -> None:
    """Each kernel launched ``want`` times: one per dispatch, or the given
    count per kernel."""
    want = want if isinstance(want, dict) else dict.fromkeys(counts, want)
    if counts != want:
        raise AssertionError(f"{where}: kernel launches {counts}, not {want}")


def check_small_input() -> None:
    """The slice with focus at the trained CI operating point
    (pose-ci-motions: V2_TINY, YOLO width 0.25 at 128, crop 128, 240x320;
    focus-ci at CI_FOCUS_CFG; float32) on the card with CUDA graphs,
    against the same slice on the CPU, batched against per-frame, and the
    graphs against the eager step. Its trained trunks give spread-out poses
    and real faces, so a batched step that misorders the smoothing state
    or the feature ring shows here."""
    params, focus_params = weights.load_bundle("pose-ci-motions"), weights.load_bundle("focus-ci")
    frames = ci_frames(18, faces=True)
    cpu = build_ci("cpu", params=params, focus_params=focus_params)
    outs_cpu = [cpu.step(f) for f in frames]
    card = build_ci("cuda", cuda_graphs=True, params=params, focus_params=focus_params)
    zero_launches()
    seq, batched, _, _ = drive(card, frames, frames, 8)  # two batches of 8 and a tail of 2
    counts = launches()
    eager_seq, eager_batched, _, _ = drive(twin(card, cuda_graphs=False), frames, frames, 8)
    fired = sum(int(o["conf"] > 0) for o in seq)
    faces = sum(int(o["f_found"] > 0) for o in seq)
    log(f"[small] pose-ci-motions and focus-ci, 18 frames 240x320 float32, {fired}/18 fired at "
        f"0.3, a face found on {faces}/18; graphs at B={sorted(card._graphs)}; launches {counts}")
    if fired == 0:
        raise AssertionError("the CI-size detector fired on no frame")
    if faces == 0:
        raise AssertionError("the CI-size face detector found no face")
    check_launches("small", counts, dispatches(18, 18, 8))
    check_close("small: CUDA graphs vs CPU", seq, outs_cpu, TOL_CI)
    check_close("small: CUDA graphs stream_batched vs step", batched, seq, TOL_CI)
    check_close("small: CUDA graphs vs eager, step", seq, eager_seq, TOL_GRAPH)
    check_close("small: CUDA graphs vs eager, stream_batched", batched, eager_batched, TOL_GRAPH)


def warm(pipe, frames: list) -> None:
    """Bounded warm-up: cuDNN heuristics, lazy CUDA init, the B=1 and B=16 captures."""
    for f in frames[:2]:
        pipe.step(f)
    for _ in pipe.stream_batched(frames[:16], 16):
        pass
    torch.cuda.synchronize()


def run_slice(card: str, clip) -> dict:
    """Drive the full-width main path with CUDA graphs, then eagerly, then
    with focus off; returns the kernels' launch counts on the graphs' run."""
    t0 = time.perf_counter()
    pipe = build_slice(seed=0, cuda_graphs=True)
    eager = twin(pipe, cuda_graphs=False)
    no_focus = twin(pipe, cuda_graphs=True, with_focus=False)
    gate = pipe.config.hpe.yolo_thresh
    log(f"[slice] weights: pose-prod-256-calib detector, EfficientNetV2-L and head random "
        f"from seed 0; gate {gate}; focus-ci at crop {pipe.config.focus.gaze_image_size}, "
        f"{pipe.config.focus.compute_dtype}; built in {time.perf_counter() - t0:.1f} s")
    frames = [clip[i % len(clip)] for i in range(64)]

    t0 = time.perf_counter()
    for p in (pipe, eager, no_focus):
        warm(p, frames)
    log(f"[slice] warm-up and graph capture at B={sorted(pipe._graphs)} in "
        f"{time.perf_counter() - t0:.1f} s")

    zero_launches()
    seq, batched, lat, t_batched = drive(pipe, frames[:20], frames, 16)
    counts = launches()
    eager_seq, eager_batched, eager_lat, _ = drive(eager, frames[:20], frames, 16)
    _, _, off_lat, t_off = drive(no_focus, frames[:20], frames, 16)

    check_launches("the main path", counts, dispatches(20, 64, 16))
    if len(batched) != 64:
        raise AssertionError(f"stream_batched gave {len(batched)} results for 64 frames")
    for out in seq + batched:
        for key, v in out.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"non-finite {key!r} in the slice's output")
    fired = sum(int(o["conf"] > 0) for o in seq)
    pose_ok = sum(int(o["pose_ok"] > 0) for o in seq)
    faces = sum(int(o["f_found"] > 0) for o in seq)
    log(f"[slice] {fired}/20 frames fired at the {gate} gate, {pose_ok}/20 with a visible pose, "
        f"ar_ready on {sum(int(o['ar_ready']) for o in seq)}, a face found on {faces}/20")
    if fired == 0:
        raise AssertionError("no detection fired over 20 frames")
    if faces == 0:
        raise AssertionError("no face found over 20 frames")
    check_close("slice: stream_batched vs step, 20 frames", batched[:20], seq, TOL_BATCHED)
    check_close("slice: CUDA graphs vs eager, step", seq, eager_seq, TOL_GRAPH)
    check_close("slice: CUDA graphs vs eager, stream_batched", batched, eager_batched, TOL_GRAPH)
    p50 = float(np.percentile(lat, 50)) * 1e3
    eager_p50 = float(np.percentile(eager_lat, 50)) * 1e3
    off_p50 = float(np.percentile(off_lat, 50)) * 1e3
    log(f"[slice] step latency p50 {p50:.2f} ms (min {min(lat) * 1e3:.2f} ms) over 20 frames "
        f"with CUDA graphs and focus, limit {FRAME_PERIOD_MS:.1f} ms; eager p50 {eager_p50:.2f} ms "
        f"(min {min(eager_lat) * 1e3:.2f} ms); focus off p50 {off_p50:.2f} ms (min "
        f"{min(off_lat) * 1e3:.2f} ms); stream_batched B=16: {64 / t_batched:.1f} FPS with "
        f"focus, {64 / t_off:.1f} FPS without, over 64 frames; {card}")
    on = profile_steps("slice, focus on", pipe, frames, 4, top=0)
    off = profile_steps("slice, focus off", no_focus, frames, 4, top=0)
    log(f"[slice] focus adds {on[0] - off[0]:.3f} device ms and {on[1] - off[1]:.0f} kernels per "
        f"frame at B=1 ({on[0]:.3f} ms, {on[1]:.0f} kernels against {off[0]:.3f} ms, "
        f"{off[1]:.0f}; torch.profiler, CUDA graphs)")
    log(f"[slice] kernel launches on the main path: {counts}")
    if not p50 < FRAME_PERIOD_MS:
        raise AssertionError(f"step p50 {p50:.2f} ms is over the {FRAME_PERIOD_MS:.1f} ms frame period")
    return counts


def serve_commands(shown: list, sent: list):
    """The command stream of phase 6a: each command of SERVE_SCRIPT once the
    previous one's log line is in ``shown`` and SPACING frames have passed;
    after ``add a``, also once ``a`` is among the actions. Records
    (command, len(shown) when it was sent) in ``sent``."""
    frames = 0
    for i, (cmd, _) in enumerate(SERVE_SCRIPT):
        if i:
            prev_cmd, want = SERVE_SCRIPT[i - 1]
            since = sent[-1][1]
            while not (frames >= SPACING
                       and any(e.get("log", "").startswith(want) for e in shown[since:])
                       and (prev_cmd != "add a"
                            or any("a" in e.get("actions", {}) for e in shown[since:]))):
                frames += 1
                yield ""
        sent.append((cmd, len(shown)))
        frames = 0
        yield cmd


def run_service(card: str) -> dict:
    """Phase 6a: ``python -m isbfsar_tpu_torch.runtime.serve --fused`` on the
    card, at full width with random weights, behind a queue hub in this
    process, driven by ``run_source`` with SERVE_SCRIPT; returns the
    kernels' launches the service counted while serving."""
    from isbfsar_tpu_torch.runtime.ipc import QueueHub
    from isbfsar_tpu_torch.runtime.source import SyntheticSource, run_source

    hub = QueueHub(("127.0.0.1", 0)).start_background()
    host, port = hub._server.address
    work = tempfile.mkdtemp(prefix="isbfsar_serve_")
    save_dir = os.path.join(work, "saved")
    cmd = [sys.executable, "-m", "isbfsar_tpu_torch.runtime.serve", "--fused", "--weights",
           "random", "--yolo-thresh", "0.0", "--save-dir", save_dir, "--hub", host,
           "--hub-port", str(port)]
    log_path = os.path.join(work, "serve.log")
    t0 = time.perf_counter()
    shown, sent, pushed, failure = [], [], [], []

    class Collect:
        def show(self, elements):
            shown.append({k: v for k, v in elements.items() if k != "img"})

    def source():
        try:
            pushed.append(run_source(SyntheticSource(640, 480), hub_host=host, hub_port=port,
                                     visualizer=Collect(), command_stream=serve_commands(shown, sent)))
        except Exception as e:  # reported by the phase below
            failure.append(repr(e))

    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            feeder = threading.Thread(target=source, daemon=True)
            feeder.start()
            deadline = time.perf_counter() + SERVE_DEADLINE_S
            while feeder.is_alive() and time.perf_counter() < deadline:
                feeder.join(timeout=1.0)
                if feeder.is_alive() and proc.poll() is not None:
                    failure.append(f"the service exited {proc.returncode} mid-script")
                    break
            if feeder.is_alive() or failure:
                raise AssertionError(f"the service did not answer the script within "
                                     f"{SERVE_DEADLINE_S} s (sent {sent}, {len(shown)} frames "
                                     f"shown, {failure})")
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            hub.stop()
            with open(log_path) as f:
                service_log = f.read()
            shutil.rmtree(work, ignore_errors=True)
            if proc.returncode != 0 or failure or len(sent) < len(SERVE_SCRIPT):
                log("[serve] service log:\n" + service_log[-4000:])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the service exited {rc}")
    logs = [e["log"] for e in shown if e.get("log")]
    for _, want in SERVE_SCRIPT[:-1]:
        if not any(line.startswith(want) for line in logs):
            raise AssertionError(f"the service never logged {want!r}")
    add_at = sent[0][1]
    # the add frame's reply is the ACK, which run_source does not show: the
    # next frame shown is the countdown's first
    if shown[add_at].get("log") != "WAIT..." or pushed != [len(shown) + 2]:
        raise AssertionError(f"no ACK before the acquisition ({shown[add_at].get('log')!r}, "
                             f"{pushed} frames pushed, {len(shown)} shown)")
    fired = [e for e in shown if "a" in e.get("actions", {})]
    counts = None
    for line in service_log.splitlines():
        if "kernel launches while serving:" in line:
            counts = json.loads(line.split("serving: ", 1)[1].replace("'", '"'))
    if not counts or not all(counts.values()):
        raise AssertionError(f"the service launched a kernel no time: {counts}")
    starts = [line for line in service_log.splitlines() if line.startswith("[isbfsar-tpu]")]
    log(f"[serve] python -m isbfsar_tpu_torch.runtime.serve --fused --weights random "
        f"--yolo-thresh 0.0 (640x480 I420, YOLOv4 @ 256, EfficientNetV2-L @ 256, bf16, focus "
        f"on): {' | '.join(starts)}")
    log(f"[serve] {pushed[0]} frames pushed through the TCP hub in {seconds:.1f} s with the "
        f"service's start; commands at frames {[(c, n) for c, n in sent]}; 'a' scored on "
        f"{len(fired)} frames; logs: {sorted(set(logs) - {'WAIT...', 'GO!'}, key=logs.index)[:8]}"
        f"; exit 0; {card}")
    return counts


def bgr_frames() -> list:
    """The smoke and face frames as the BGR uint8 frames a camera gives."""
    return [torch.round(i420_to_bgr(torch.from_numpy(f), 480)).to(torch.uint8).numpy()
            for f in slice_frames()]


def p50_ms(lat: list) -> float:
    return float(np.percentile(lat, 50)) * 1e3


def timed(fn, items) -> tuple:
    """fn over items: (results, per-call seconds)."""
    out, lat = [], []
    for x in items:
        t = time.perf_counter()
        out.append(fn(x))
        lat.append(time.perf_counter() - t)
    return out, lat


SERVED_FIELDS = ("pose", "distance", "bbox", "edges", "actions", "is_true", "requires_focus",
                 "focus", "face_bbox")


def check_lagged(overlapped: list, sync: list, frames: list) -> None:
    """The overlapped results, one frame late, equal the synchronous ones exactly."""
    for i, (got, want) in enumerate(zip(overlapped[1:], sync, strict=True)):
        if got["img"] is not frames[i]:
            raise AssertionError(f"overlapped result {i + 1} is not paired with frame {i}")
        keys = set(want) - {"fps"}
        if set(got) - {"fps"} != keys:
            raise AssertionError(f"frame {i}: overlapped keys {sorted(got)} != {sorted(want)}")
        for key in keys & set(SERVED_FIELDS):
            a, b = got[key], want[key]
            same = (a == b if isinstance(b, (dict, tuple, bool)) else
                    np.array_equal(np.asarray(a), np.asarray(b)))
            if not same:
                raise AssertionError(f"frame {i} {key}: overlapped {a!r} != synchronous {b!r}")


def yolo_row_shift(pipe, frames: list) -> float:
    """Max |difference| of the YOLO confidences of the same I420 frames when
    they sit STREAM_BATCH rows further down one batch."""
    with torch.inference_mode():
        _, yolo_in = pipe._decode_frame(torch.from_numpy(np.stack(frames)).cuda())
        shift = torch.arange(len(frames), device="cuda").roll(STREAM_BATCH)
        yolo = pipe._params()["hpe"]["yolo"]
        a = yolo(yolo_in[:, 0].permute(0, 3, 1, 2))[1]
        b = yolo(yolo_in[shift][:, 0].permute(0, 3, 1, 2))[1]
        return float((a[shift] - b).abs().max())


def run_serving(card: str) -> dict:
    """Phase 6b: the serving surface in process at full width (build_slice),
    on BGR camera frames; returns each path's kernel launches."""
    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator
    from isbfsar_tpu_torch.serving import MultiStreamPipeline

    pipe = build_slice(seed=0, cuda_graphs=True)
    clip = bgr_frames()
    frames = [clip[i % len(clip)] for i in range(SERVING_FRAMES)]
    by_path = {}

    def orchestrator(**kw):
        pipe.focus.focuses = []
        return Orchestrator(pipe.config, fused=pipe, **kw)

    orchestrator(fused_overlap=False).get_frame_batch(frames[:STREAM_BATCH])  # warm: B=16
    warm = orchestrator()
    for f in frames[:3]:
        warm.get_frame(img=f)
    torch.cuda.synchronize()

    zero_launches()
    overlapped, lat_ov = timed(orchestrator().get_frame, frames + frames[:1])
    by_path["get_frame overlapped"] = launches()
    check_launches("get_frame overlapped", by_path["get_frame overlapped"], SERVING_FRAMES + 1)
    zero_launches()
    sync, lat_sync = timed(orchestrator(fused_overlap=False).get_frame, frames)
    by_path["get_frame sync"] = launches()
    check_launches("get_frame sync", by_path["get_frame sync"], SERVING_FRAMES)
    check_lagged(overlapped, sync, frames)
    scored = sum(bool(e["actions"]) for e in sync)
    faces = sum("face_bbox" in e for e in sync)
    if not (scored and faces):
        raise AssertionError(f"the served frames scored no action ({scored}) or found no face "
                             f"({faces})")

    batches = [[clip[(i + j) % len(clip)] for j in range(STREAM_BATCH)] for i in range(6)]
    orch = orchestrator()
    zero_launches()
    t = time.perf_counter()
    batched = [e for b in batches for e in orch.get_frame_batch(b, overlap=True)]
    batch_fps = len(batched) / (time.perf_counter() - t)
    by_path["get_frame_batch B=16 overlapped"] = launches()
    check_launches("get_frame_batch", by_path["get_frame_batch B=16 overlapped"], len(batches))

    module = Orchestrator(pipe.config, hpe=pipe.hpe, focus=pipe.focus, ar=pipe.ar)
    for f in frames[:3]:
        module.get_frame(img=f)
    torch.cuda.synchronize()
    zero_launches()
    module_out, lat_module = timed(module.get_frame, frames)
    by_path["module path get_frame"] = launches()
    # BGR frames take no I420 kernel; focus launches once a frame
    check_launches("module path get_frame", by_path["module path get_frame"],
                   {"fused_i420_inputs": 0, "focus_geometry": SERVING_FRAMES})
    if not any("pose" in e for e in module_out):
        raise AssertionError("the module path found no pose")

    # S streams at B frames each: stream s sees the clip from its own phase
    i420 = slice_frames()
    ticks = [np.stack([i420[(i + 2 * s) % len(i420)] for s in range(STREAMS)])
             for i in range(STREAM_TICKS)]
    multi = MultiStreamPipeline(n_streams=STREAMS, pipe=pipe)
    multi.start()
    list(multi.stream_batched(iter(ticks[:STREAM_BATCH]), STREAM_BATCH))  # capture (S, B)
    multi.start()
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    streamed = list(multi.stream_batched(iter(ticks), STREAM_BATCH))
    multi_fps = STREAMS * len(streamed) / (time.perf_counter() - t)
    by_path[f"MultiStreamPipeline S={STREAMS} B={STREAM_BATCH}"] = launches()
    check_launches("MultiStreamPipeline", by_path[f"MultiStreamPipeline S={STREAMS} "
                                                  f"B={STREAM_BATCH}"], STREAM_TICKS // STREAM_BATCH)
    # Each stream's twin is a single-stream pipeline fed that stream's frames
    # in the rows they hold in the multi-stream step, at its batch of S*B,
    # with empty frames in the other rows: they find no person, so they leave
    # the twin's recurrent state alone. cuDNN's bf16 YOLO at a batch of 64
    # gives a frame a result that depends on its row (yolo_row_shift logs
    # how much), so only the same rows make the twin a test of the stream axis.
    row_shift = yolo_row_shift(pipe, [t[0] for t in ticks])
    blank = bgr_to_i420(np.zeros(pipe.hpe.frame_shape + (3,), np.uint8))
    b = STREAM_BATCH
    for s in range(STREAMS):
        pipe.start()
        twin_out = []
        for k in range(0, STREAM_TICKS, b):
            batch = np.stack([blank] * (STREAMS * b))
            batch[s * b:(s + 1) * b] = [t[s] for t in ticks[k:k + b]]
            rows = [pipe.layout.unpack(r) for r in pipe.dispatch_batch(batch).numpy()]
            if any(r["pose_ok"] > 0 for j, r in enumerate(rows) if not s * b <= j < (s + 1) * b):
                raise AssertionError("an empty frame found a person: the twin's state moved")
            twin_out += rows[s * b:(s + 1) * b]
        check_close(f"serving: stream {s} of {STREAMS} vs its single-stream twin",
                    [tick[s] for tick in streamed], twin_out, TOL_BATCHED)
    pipe.start()
    check_close(f"serving: stream 0 of {STREAMS} vs a single-stream pipeline at B={b}, for the "
                f"record (other rows, another batch)", [tick[0] for tick in streamed],
                list(pipe.stream_batched([t[0] for t in ticks], b)), None)

    log(f"[serving] Orchestrator.get_frame over {SERVING_FRAMES} BGR frames (I420-encoded on the "
        f"host): p50 {p50_ms(lat_ov):.2f} ms overlapped (min {min(lat_ov) * 1e3:.2f} ms), "
        f"{p50_ms(lat_sync):.2f} ms synchronous (min {min(lat_sync) * 1e3:.2f} ms), limit "
        f"{FRAME_PERIOD_MS:.1f} ms on the overlapped; an action scored on {scored}, a face on "
        f"{faces}; overlapped = synchronous one frame late, exactly")
    log(f"[serving] get_frame_batch(overlap=True) B={STREAM_BATCH}: {batch_fps:.1f} FPS over "
        f"{len(batched)} frames; module path get_frame p50 {p50_ms(lat_module):.2f} ms (min "
        f"{min(lat_module) * 1e3:.2f} ms, eager, no limit); MultiStreamPipeline S={STREAMS} "
        f"B={STREAM_BATCH}: {multi_fps:.1f} frames/s across the streams over "
        f"{STREAMS * len(streamed)} frames; {card}")
    log(f"[serving] YOLO conf of the same {STREAM_TICKS} frames moved {STREAM_BATCH} rows down "
        f"one batch: max|diff| {row_shift:.3g} (cuDNN, bf16)")
    log(f"[serving] kernel launches by path: {by_path}")
    if not p50_ms(lat_ov) < FRAME_PERIOD_MS:
        raise AssertionError(f"overlapped get_frame p50 {p50_ms(lat_ov):.2f} ms is over the "
                             f"{FRAME_PERIOD_MS:.1f} ms frame period")
    return by_path


def final_window(pipe) -> list:
    """The pipeline's feature ring as one packed-like output, for check_close."""
    return [{"window": pipe._state.window.detach().cpu().numpy()}]


def check_rgb_small(mode: str, params, focus_params) -> dict:
    """Phase 8a: ``mode`` at the trained CI operating point with focus, on
    the card with CUDA graphs against the same pipeline on the CPU (which
    the tests hold against the JAX package), and the card's stream_batched
    (B=8) against its step; returns the kernels' launches on the card."""
    frames = ci_frames(18, faces=True)
    kw = dict(params=params, focus_params=focus_params, input_type=mode)
    cpu = build_ci("cpu", **kw)
    cpu_seq = [cpu.step(f) for f in frames]
    card = build_ci("cuda", cuda_graphs=True, **kw)
    zero_launches()
    seq, batched, _, _ = drive(card, frames, frames, 8)  # two batches of 8 and a tail of 2
    counts = launches()
    fired = sum(int(o["pose_ok"] > 0) for o in seq)
    log(f"[rgb small] {mode}: pose-ci-motions, focus-ci, ResNet-50 at "
        f"{card.config.ar.rgb_size}, 18 frames 240x320 float32: {fired}/18 good frames, "
        f"ar_ready on {sum(int(o['ar_ready']) for o in seq)}; launches {counts}")
    if not any(o["ar_ready"] for o in seq):
        raise AssertionError(f"{mode}: the CI-size ring never filled")
    check_launches(f"small {mode}", counts, dispatches(18, 18, 8))
    check_close(f"rgb small {mode}: CUDA graphs vs CPU, step", seq, cpu_seq, TOL_CI_RGB)
    # the same 18 frames filled both rings, the card's through stream_batched
    check_close(f"rgb small {mode}: CUDA graphs vs CPU, the feature ring", final_window(card),
                final_window(cpu), TOL_CI_RGB)
    check_close(f"rgb small {mode}: CUDA graphs stream_batched vs step", batched, seq, TOL_CI_RGB)
    return counts


def run_rgb_slice(mode: str, card: str, clip: list):
    """Phase 8b: ``mode`` at full width (build_slice: the calibrated detector,
    ResNet-50 at 224 in float32 from seed 0; hybrid adds the random
    EfficientNetV2-L) with focus, through step and stream_batched with CUDA
    graphs, then eagerly; returns (the pipeline, its launches, step p50 ms)."""
    t0 = time.perf_counter()
    pipe = build_slice(seed=0, cuda_graphs=True, input_type=mode)
    eager = twin(pipe, cuda_graphs=False)
    built = time.perf_counter() - t0
    frames = [clip[i % len(clip)] for i in range(RGB_BATCHED)]
    for p in (pipe, eager):
        warm(p, frames)
    log(f"[rgb slice] {mode}: built in {built:.1f} s, warmed and captured at "
        f"B={sorted(pipe._graphs)} in {time.perf_counter() - t0 - built:.1f} s")
    zero_launches()
    seq, batched, lat, t_batched = drive(pipe, frames[:RGB_STEPS], frames, 16)
    counts = launches()
    eager_seq, eager_batched, eager_lat, _ = drive(eager, frames[:RGB_EAGER], frames, 16)
    check_launches(f"{mode} main path", counts, dispatches(RGB_STEPS, RGB_BATCHED, 16))
    for out in seq + batched:
        for key, v in out.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"non-finite {key!r} in the {mode} slice's output")
    good = [o for o in seq if o["pose_ok"] > 0]
    faces = sum(int(o["f_found"] > 0) for o in seq)
    log(f"[rgb slice] {mode}: {len(good)}/{RGB_STEPS} good frames, ar_ready on "
        f"{sum(int(o['ar_ready']) for o in seq)}, a face found on {faces}")
    if not good or not faces:
        raise AssertionError(f"{mode}: no good frame ({len(good)}) or no face ({faces})")
    published = pipe.decode(good[0])
    if ("pose" in published) == (mode == "rgb") or "bbox" not in published:
        raise AssertionError(f"{mode}: decode published {sorted(published)}")
    check_close(f"rgb slice {mode}: stream_batched vs step", batched[:RGB_STEPS], seq,
                TOL_BATCHED_RGB)
    check_close(f"rgb slice {mode}: CUDA graphs vs eager, step", seq[:RGB_EAGER], eager_seq,
                TOL_GRAPH)
    check_close(f"rgb slice {mode}: CUDA graphs vs eager, stream_batched", batched,
                eager_batched, TOL_GRAPH)
    p50 = p50_ms(lat)
    log(f"[rgb slice] {mode}: step p50 {p50:.2f} ms (min {min(lat) * 1e3:.2f} ms) over "
        f"{RGB_STEPS} frames with CUDA graphs and focus, limit {FRAME_PERIOD_MS:.1f} ms; eager "
        f"p50 {p50_ms(eager_lat):.2f} ms; stream_batched B=16 {RGB_BATCHED / t_batched:.1f} FPS "
        f"over {RGB_BATCHED} frames; launches {counts}; {card}")
    if not p50 < FRAME_PERIOD_MS:
        raise AssertionError(f"{mode} step p50 {p50:.2f} ms is over the {FRAME_PERIOD_MS:.1f} ms "
                             f"frame period")
    return pipe, counts, p50


class FakeClock:
    """A clock that advances 0.25 s a call: the acquisition's countdown and
    pacing take no real time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class FrameCycle:
    """An in-queue that hands out ``frames`` in a cycle, without commands."""

    def __init__(self, frames: list):
        self.frames, self.i = frames, 0

    def get(self):
        self.i += 1
        return {"rgb": self.frames[(self.i - 1) % len(self.frames)], "msg": ""}


def run_rgb_module(mode: str, card: str, pipe) -> dict:
    """Phase 8c: the orchestrator's module path on BGR camera frames in
    ``mode`` with ``pipe``'s nets: the eager estimator (the detector alone
    in rgb) and focus, the host crop and the recognizer, which embeds the
    whole window (8 ResNet-50 forwards) each frame; then one ``add``
    acquisition on a fake clock over the frames that held a person.
    Returns the kernels' launches on the timed frames."""
    from isbfsar_tpu_torch.runtime.orchestrator import Orchestrator

    clip = bgr_frames()
    frames = [clip[i % len(clip)] for i in range(RGB_MODULE_FRAMES)]
    pipe.focus.focuses = []
    orch = Orchestrator(pipe.config, hpe=pipe.hpe, focus=pipe.focus, ar=pipe.ar,
                        clock=FakeClock())
    for f in frames[:2]:
        orch.get_frame(img=f)
    torch.cuda.synchronize()
    zero_launches()
    out, lat = timed(orch.get_frame, frames)
    counts = launches()
    # BGR frames take no I420 kernel; focus launches once a frame
    check_launches(f"{mode} module path", counts,
                   {"fused_i420_inputs": 0, "focus_geometry": RGB_MODULE_FRAMES})
    need = "img_preprocessed" if mode == "rgb" else "pose"
    people = [f for f, e in zip(frames, out) if need in e]
    crops = [e["img_preprocessed"] for e in out if "img_preprocessed" in e]
    size = pipe.config.ar.rgb_size
    if not people or any(c.shape != (size, size, 3) or c.dtype != np.float32
                         or not np.isfinite(c).all() for c in crops):
        raise AssertionError(f"{mode} module path: {len(people)} frames with a {need}, crops "
                             f"{[(c.shape, c.dtype) for c in crops[:2]]}")
    orch._in_queue = FrameCycle(people)
    t = time.perf_counter()
    said = orch.learn_command(["acquired"])
    acquire_s = time.perf_counter() - t
    after = [orch.get_frame(img=people[i % len(people)]) for i in range(2)]
    if said != "Action acquired learned successfully!" or "acquired" not in after[-1]["actions"]:
        raise AssertionError(f"{mode} module path add: {said!r}, then {after[-1]['actions']}")
    log(f"[rgb module] {mode}: Orchestrator.get_frame (eager module path, host crop, "
        f"{pipe.config.ar.seq_len} ResNet-50 forwards a frame) p50 {p50_ms(lat):.2f} ms (min "
        f"{min(lat) * 1e3:.2f} ms, no limit) over {RGB_MODULE_FRAMES} BGR frames, "
        f"{len(people)} with a {need}; add acquisition on a fake clock: {said!r} in "
        f"{acquire_s:.2f} s, then scored {sorted(after[-1]['actions'])}; launches {counts}; "
        f"{card}")
    return counts


def run_rgb(card: str) -> dict:
    """Phase 8: rgb and hybrid (small input, full width, the module path);
    returns each path's kernel launches."""
    t = time.perf_counter()
    params, focus_params = weights.load_bundle("pose-ci-motions"), weights.load_bundle("focus-ci")
    by_path = {}
    for mode in RGB_MODES:
        by_path[f"{mode} small, CI size"] = check_rgb_small(mode, params, focus_params)
    log(f"[rgb] 8a in {time.perf_counter() - t:.1f} s")
    clip = slice_frames()
    p50 = {}
    for mode in RGB_MODES:
        t = time.perf_counter()
        pipe, by_path[f"{mode} FusedPipeline step and stream_batched"], p50[mode] = \
            run_rgb_slice(mode, card, clip)
        log(f"[rgb] 8b {mode} in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        by_path[f"{mode} module path get_frame"] = run_rgb_module(mode, card, pipe)
        log(f"[rgb] 8c {mode} in {time.perf_counter() - t:.1f} s")
        del pipe
    log(f"[rgb] step p50 with CUDA graphs and focus: "
        + ", ".join(f"{m} {v:.2f} ms" for m, v in p50.items()) + f"; {card}")
    return by_path


def train_trees(root: str) -> tuple:
    """Phase 7's synthetic trees: (training tree, held-out tree)."""
    from isbfsar_tpu_torch.train.synthetic import generate_dataset

    train, held = os.path.join(root, "train"), os.path.join(root, "held")
    generate_dataset(train, n_classes=30, clips_per_class=4, seed=0)
    generate_dataset(held, n_classes=5, clips_per_class=4, seed=1)
    return train, held


def relu_inputs(model) -> list:
    """The skeleton recognizer's layers whose outputs go through a ReLU."""
    mods = [model.sk_extractor.fc1, model.sk_extractor.fc2]
    if hasattr(model, "discriminator"):
        mods += [model.discriminator.fc1, model.discriminator.fc2]
    return mods


def step_card_then_cpu(card, cpu, batch: dict) -> tuple:
    """One train step of the trainer ``card``, then one of ``cpu`` on the same
    batch that takes the card's side of every ReLU tie (``RELU_TIE``);
    returns both steps' metrics (numpy) and the number of ties taken."""
    seen = [[] for _ in relu_inputs(card.model)]
    hooks = [m.register_forward_hook(lambda mod, args, out, rec=rec: rec.append(out.detach().cpu()))
             for m, rec in zip(relu_inputs(card.model), seen)]
    try:
        got_card = card.step(batch)
    finally:
        for h in hooks:
            h.remove()
    ties = [0]

    def align(out, rec):
        theirs, ours = rec.pop(0), out.detach()
        split = (theirs > 0) != (ours > 0)
        if not split.any():
            return None
        wide = float(torch.maximum(theirs.abs(), ours.abs())[split].max())
        if wide > RELU_TIE:
            raise AssertionError(f"a ReLU input {wide:.3g} from zero lies on one side on the "
                                 f"card and on the other on the CPU (ties up to {RELU_TIE:g})")
        ties[0] += int(split.sum())
        return torch.where(split, out + (theirs - ours), out)  # the card's value, our gradient

    hooks = [m.register_forward_hook(lambda mod, args, out, rec=rec: align(out, rec))
             for m, rec in zip(relu_inputs(cpu.model), seen)]
    try:
        got_cpu = cpu.step(batch)
    finally:
        for h in hooks:
            h.remove()
    return tuple({k: v.detach().cpu().numpy() for k, v in m.items()}
                 for m in (got_card, got_cpu)) + (ties[0],)


def check_train_steps(cfg, batches: list, root: str) -> tuple:
    """The first train steps on the card and on the CPU from one init on the
    same batches; returns the largest differences and the ReLU ties the CPU
    took from the card."""
    from isbfsar_tpu_torch.train.trainer import Trainer

    pair = {d: Trainer(cfg, log_dir=os.path.join(root, f"pair_{d}"), use_wandb=False, seed=1,
                       device=d) for d in ("cuda", "cpu")}
    err = {k: 0.0 for k in ("fs_loss", "os_loss", "params")}
    ties = 0
    for i, batch in enumerate(batches):
        card, cpu, n = step_card_then_cpu(pair["cuda"], pair["cpu"], batch)
        got = {"cuda": card, "cpu": cpu}
        ties += n
        for k in ("fs_correct", "os_weights"):
            if not np.array_equal(got["cuda"][k], got["cpu"][k]):
                raise AssertionError(f"train step {i}: {k} differs between the card and the CPU")
        for k in ("fs_loss", "os_loss"):
            err[k] = max(err[k], float(abs(got["cuda"][k] - got["cpu"][k])))
    cpu = pair["cpu"].model.state_dict()
    for name, t in pair["cuda"].model.state_dict().items():
        err["params"] = max(err["params"], float((t.cpu() - cpu[name]).abs().max()))
    return err, ties


def check_fsos(cfg, params, card: dict, train: str, held: str) -> tuple:
    """The card's evaluate_fsos results against the CPU's, and
    calibrate_os_threshold on both; returns (max score difference, the
    card's calibration)."""
    from isbfsar_tpu_torch.train.fsos import calibrate_os_threshold, evaluate_fsos

    cpu = evaluate_fsos(cfg, params, held, held, device="cpu", **FSOS_KW)
    err = 0.0
    for a, b in zip(card["_raw"], cpu["_raw"], strict=True):
        for k in ("known", "fs_correct"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"FSOS: {k} differs between the card and the CPU")
        err = max(err, float(np.max(np.abs(a["scores"] - b["scores"]))))
    for k in ("FSOS-ACC", "FS-ACC", "OS-ACC"):
        if card[k] != cpu[k]:
            raise AssertionError(f"FSOS: {k} {card[k]} on the card, {cpu[k]} on the CPU")
    calib = {d: calibrate_os_threshold(cfg, params, train, k=5, n_repeats=2, batch_size=8,
                                       device=d) for d in ("cuda", "cpu")}
    if calib["cuda"] != calib["cpu"]:
        raise AssertionError(f"calibration: {calib['cuda']} on the card, {calib['cpu']} on the CPU")
    return err, calib["cuda"]


def run_cli(args: list, timeout: float) -> str:
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def run_train(card: str) -> dict:
    """Phase 7: train and evaluate the recognizer on the card; returns the
    kernels' launches on this path (0 each)."""
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator
    from isbfsar_tpu_torch.train.fsos import evaluate_fsos, summarize
    from isbfsar_tpu_torch.train.trainer import Trainer
    from isbfsar_tpu_torch.utils import checkpoint

    cfg = ARConfig(n_task=TRAIN_N_TASK)
    load_s, step_s, first = [], [], []

    def timed_batches(sampler, epoch):
        """The loader's batches, timing each batch's load and, with the card
        synchronised around it, each train step."""
        train = sampler is samplers[0]
        it = batch_iterator(sampler, cfg.batch_size, seed=epoch)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            if train:
                load_s.append(time.perf_counter() - t)
                first.extend([batch][:TRAIN_STEPS_CHECKED - len(first)])
            torch.cuda.synchronize()
            t = time.perf_counter()
            yield batch
            torch.cuda.synchronize()
            if train:
                step_s.append(time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        train, held = train_trees(root)
        log(f"[train] synthetic trees written in {time.perf_counter() - t:.2f} s")
        samplers = [EpisodicSampler(train, k=cfg.way, n_task=cfg.n_task, l=cfg.seq_len, seed=s)
                    for s in (0, 1)]
        zero_launches()
        run = os.path.join(root, "run")
        trainer = Trainer(cfg, *samplers, log_dir=run, use_wandb=False)
        t = time.perf_counter()
        trainer.fit(n_epochs=3, batches_fn=timed_batches)
        fit_s = time.perf_counter() - t
        with open(os.path.join(run, "metrics.jsonl")) as f:
            history = [json.loads(line) for line in f]
        loss = [h.get("train/fs_loss") for h in history]
        log(f"[train] fit: 3 epochs x {cfg.n_task // cfg.batch_size} steps at batch "
            f"{cfg.batch_size} in {fit_s:.2f} s; epoch summaries: {history}")
        if not (loss[0] is None and loss[2] < loss[1]):
            raise AssertionError(f"train/fs_loss did not fall from epoch 1 to 2: {loss}")
        files = sorted(os.listdir(trainer.ckpt_dir))
        if files != ["1.json", "1.msgpack", "2.json", "2.msgpack"]:
            raise AssertionError(f"fit wrote {files}")
        newest = checkpoint.latest_checkpoint(trainer.ckpt_dir)
        state = checkpoint.load_checkpoint(newest, {"params": None, "batch_stats": None,
                                                    "opt_state": None})
        restored = weights.convert_variables({"params": state["params"]})
        for name, value in trainer.model.state_dict().items():
            if not torch.equal(restored[name], value.cpu()):
                raise AssertionError(f"{newest}: {name} is not the trained value")

        params = {"params": state["params"]}
        t = time.perf_counter()
        fsos_card = evaluate_fsos(cfg, params, held, held, device="cuda", **FSOS_KW)
        qps = sum(r["scores"].size for r in fsos_card["_raw"]) / (time.perf_counter() - t)

        # the CLIs run beside the untimed comparisons with the CPU
        def clis():
            cli_log = os.path.join(root, "cli")
            t = time.perf_counter()
            run_cli(["isbfsar_tpu_torch.train.train_cli", "--data", train, "--epochs", "2",
                     "--n-task", "32", "--log-dir", cli_log], 300)
            out = run_cli(["isbfsar_tpu_torch.train.eval_cli", "fsos", "--data", held,
                           "--checkpoint", checkpoint.latest_checkpoint(cli_log + "/checkpoints"),
                           "--calibrate", train, "--repeats", "2"], 300)
            return out, time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=1) as pool:
            cli = pool.submit(clis)
            err_fsos, calib = check_fsos(cfg, params, fsos_card, train, held)
            err_train, ties = check_train_steps(cfg, first, root)
            out, cli_s = cli.result(timeout=660)
        lines = [json.loads(line) for line in out.strip().splitlines()]
        if len(lines) != 3 or "os_calibration" not in lines[1]:
            raise AssertionError(f"eval_cli printed {out!r}")
        counts = launches()

    step_ms, load_ms = p50_ms(step_s), p50_ms(load_s)
    log(f"[train] train step at batch {cfg.batch_size} (way {cfg.way}, seq_len {cfg.seq_len}, "
        f"the card synchronised around each): p50 {step_ms:.3f} ms (min {min(step_s) * 1e3:.3f} "
        f"ms) over the {len(step_s)} steps of fit, {cfg.batch_size / step_ms * 1e3:.1f} "
        f"episodes/s; batch_iterator p50 {load_ms:.3f} ms per batch ({cfg.batch_size} x 7 clips "
        f"x 16 np.load) = {load_ms / step_ms:.2f}x the step, {load_ms / (load_ms + step_ms):.3f} "
        f"of the loop; {card}")
    log(f"[train] the card vs the CPU over {len(first)} steps: max|diff| "
        + " ".join(f"{k}={v:.3g} (limit {TOL_TRAIN[k]:g})" for k, v in err_train.items())
        + f"; fs_correct and the gate equal; {ties} ReLU ties (inputs within {RELU_TIE:g} of "
        "zero) taken from the card")
    log(f"[train] FSOS on the card (k 5, 3 repeats, batch 8, trained weights): "
        f"{summarize(fsos_card)}, "
        f"{qps:.1f} queries/s (host loading included); scores vs the CPU max|diff| "
        f"{err_fsos:.3g} (limit {TOL_FSOS_SCORE:g}); known, fs_correct, metrics equal; "
        f"calibrated {calib}, equal on the CPU; {card}")
    log(f"[train] train_cli (2 epochs, n_task 32) and eval_cli fsos --calibrate on the card: "
        f"exit 0 in {cli_s:.1f} s; {lines}")
    over = [f"{k} {v} > {TOL_TRAIN[k]}" for k, v in err_train.items() if not v <= TOL_TRAIN[k]]
    if not err_fsos <= TOL_FSOS_SCORE:
        over.append(f"FSOS scores {err_fsos} > {TOL_FSOS_SCORE}")
    if over:
        raise AssertionError("the card vs the CPU: " + "; ".join(over))
    check_launches("train and offline eval", counts, 0)
    return counts


def state_errors(a: dict, b: dict) -> dict:
    """Largest differences between two trainers' parameters and running
    stats (their models' state dicts)."""
    b = b.model.state_dict()
    err = {"params": 0.0, "batch_stats": 0.0}
    for name, t in a.model.state_dict().items():
        key = "batch_stats" if name.endswith((".mean", ".var")) else "params"
        err[key] = max(err[key], float((t.cpu() - b[name].cpu()).abs().max()))
    return err


def check_rgb_train_small(mode: str, root: str) -> dict:
    """Phase 9a: RGB_TRAIN_CI_STEPS train steps in ``mode`` at the CI size on
    the card and on the CPU on the same batches, each step from the card's
    state; returns the largest differences. fs_correct and the gate must be
    equal."""
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.synthetic import episodic_batch
    from isbfsar_tpu_torch.train.trainer import Trainer

    cfg = ARConfig.for_input(mode, rgb_size=32, batch_size=2)
    pair = {d: Trainer(cfg, log_dir=os.path.join(root, f"{mode}_{d}"), use_wandb=False, seed=1,
                       device=d) for d in ("cuda", "cpu")}
    err = dict.fromkeys(("fs_loss", "os_loss", "params", "batch_stats"), 0.0)
    for i in range(RGB_TRAIN_CI_STEPS):
        pair["cpu"].load_state(pair["cuda"].state())
        batch = episodic_batch(cfg, cfg.batch_size, cfg.rgb_size, mode, seed=i)
        got = {d: {k: v.detach().cpu().numpy() for k, v in t.step(batch).items()}
               for d, t in pair.items()}
        for k in ("fs_correct", "os_weights"):
            if not np.array_equal(got["cuda"][k], got["cpu"][k]):
                raise AssertionError(f"{mode} train step {i}: {k} differs between the card and "
                                     "the CPU")
        for k in ("fs_loss", "os_loss"):
            err[k] = max(err[k], float(abs(got["cuda"][k] - got["cpu"][k])))
        for k, v in state_errors(pair["cuda"], pair["cpu"]).items():
            err[k] = max(err[k], v)
    return err


def remat_pair(cfg, batch: dict, root: str) -> tuple:
    """One train step without remat and one with, from one init on
    ``batch`` with cuDNN deterministic: (the trainer without remat, the
    peak memory of each step, their parameters' and running stats' largest
    differences after it, both steps' losses)."""
    import dataclasses

    from isbfsar_tpu_torch.train.trainer import Trainer

    trainers = {remat: Trainer(dataclasses.replace(cfg, remat=remat), use_wandb=False,
                               log_dir=os.path.join(root, f"remat_{remat}"), seed=0)
                for remat in (False, True)}
    peak, losses = {}, []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat, trainer in trainers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            peak[remat] = torch.cuda.max_memory_allocated()
            losses.append({k: float(metrics[k]) for k in ("fs_loss", "os_loss")})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return trainers[False], peak, state_errors(trainers[False], trainers[True]), losses


def run_rgb_train_full(mode: str, tree: str) -> dict:
    """Phase 9b: ``mode`` at full width, batch RGB_TRAIN_BATCH, on the
    loader's batches: ``remat_pair`` on the first batch, then the steps after
    it timed, the card synchronised around each."""
    from isbfsar_tpu_torch.configs import ARConfig
    from isbfsar_tpu_torch.train.dataloader import EpisodicSampler, batch_iterator

    cfg = ARConfig.for_input(mode, batch_size=RGB_TRAIN_BATCH,
                             n_task=RGB_TRAIN_BATCH * (RGB_TRAIN_STEPS + 1))
    sampler = EpisodicSampler(tree, k=cfg.way, n_task=cfg.n_task, l=cfg.seq_len,
                              input_type=mode, seed=0)
    load_s, batches = [], []
    it = batch_iterator(sampler, cfg.batch_size)
    while True:
        t = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        load_s.append(time.perf_counter() - t)
        batches.append(batch)
    with tempfile.TemporaryDirectory() as root:
        trainer, peak, remat_err, losses = remat_pair(cfg, batches[0], root)
        step_s = []
        for batch in batches[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append({k: float(metrics[k]) for k in ("fs_loss", "os_loss")})
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"{mode}: a non-finite loss at full width: {losses}")
    return {"step_ms": p50_ms(step_s), "load_ms": p50_ms(load_s), "steps": len(step_s),
            "peak_gib": {k: v / 2**30 for k, v in peak.items()}, "remat_err": remat_err,
            "losses": losses}


def count_leaves(tree: dict) -> int:
    return sum(count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def run_rgb_train_clis(root: str) -> tuple:
    """Phase 9c: train_cli in rgb with --remat on a 30-class tree of 64x64
    PNG crops (the loader resizes them to 224), then eval_cli fsos in rgb on
    its checkpoint; returns (the checkpoint's running-stat leaves, the FSOS
    line, seconds)."""
    from isbfsar_tpu_torch.train.synthetic import generate_dataset
    from isbfsar_tpu_torch.utils import checkpoint

    t = time.perf_counter()
    train, held = os.path.join(root, "cli_train"), os.path.join(root, "cli_held")
    generate_dataset(train, n_classes=30, clips_per_class=1, with_images=True, image_size=64,
                     seed=0)
    generate_dataset(held, n_classes=5, clips_per_class=1, with_images=True, image_size=64,
                     seed=1)
    log_dir = os.path.join(root, "cli_log")
    run_cli(["isbfsar_tpu_torch.train.train_cli", "--data", train, "--input-type", "rgb",
             "--remat", "--epochs", "2", "--batch-size", "2", "--n-task", "4",
             "--log-dir", log_dir], 300)
    ckpt = checkpoint.latest_checkpoint(os.path.join(log_dir, "checkpoints"))
    state = checkpoint.load_checkpoint(ckpt, {"params": None, "batch_stats": None,
                                              "opt_state": None})
    n_stats = count_leaves(state["batch_stats"])
    if n_stats != 2 * 53:  # mean and var of the ResNet-50's 53 BatchNorms
        raise AssertionError(f"{ckpt}: {n_stats} running-stat leaves")
    out = run_cli(["isbfsar_tpu_torch.train.eval_cli", "fsos", "--input-type", "rgb", "--data",
                   held, "--checkpoint", ckpt, "--repeats", "2"], 300)
    line = json.loads(out.strip().splitlines()[-1])
    if set(line) != {"FSOS-ACC", "FS-ACC", "OS-ACC"}:
        raise AssertionError(f"eval_cli printed {out!r}")
    return n_stats, line, time.perf_counter() - t


def run_rgb_train(card: str) -> dict:
    """Phase 9: rgb and hybrid training and evaluation on the card; returns
    the kernels' launches on this path (0 each)."""
    from isbfsar_tpu_torch.train.synthetic import generate_dataset

    zero_launches()
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        # the CLIs run beside the untimed comparisons with the CPU
        with ThreadPoolExecutor(max_workers=1) as pool:
            cli = pool.submit(run_rgb_train_clis, root)
            small = {mode: check_rgb_train_small(mode, root) for mode in RGB_MODES}
            n_stats, fsos, cli_s = cli.result(timeout=660)
        log(f"[rgb train] 9a and 9c in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        tree = os.path.join(root, "tree224")
        generate_dataset(tree, n_classes=6, clips_per_class=1, with_images=True, seed=0)
        log(f"[rgb train] a tree of 6 x 1 clips of 16 224x224 PNG crops written in "
            f"{time.perf_counter() - t:.2f} s")
        full = {}
        for mode in RGB_MODES:
            t = time.perf_counter()
            full[mode] = run_rgb_train_full(mode, tree)
            log(f"[rgb train] 9b {mode} in {time.perf_counter() - t:.1f} s")
    counts = launches()

    for mode in RGB_MODES:
        log(f"[rgb train] {mode}, the card vs the CPU over {RGB_TRAIN_CI_STEPS} steps at "
            f"rgb_size 32, batch 2: max|diff| " + " ".join(
                f"{k}={v:.3g} (limit {TOL_TRAIN_RGB[k]:g})" for k, v in small[mode].items())
            + "; fs_correct and the gate equal")
    for mode, r in full.items():
        log(f"[rgb train] {mode} at full width (ResNet-50 at 224, seq_len 8, way 5, batch "
            f"{RGB_TRAIN_BATCH}): train step p50 {r['step_ms']:.2f} ms over {r['steps']} steps "
            f"(the card synchronised around each), {RGB_TRAIN_BATCH / r['step_ms'] * 1e3:.1f} "
            f"episodes/s; batch_iterator p50 {r['load_ms']:.1f} ms per batch "
            f"({RGB_TRAIN_BATCH} x 7 clips x 16 PNG decodes) = "
            f"{r['load_ms'] / r['step_ms']:.2f}x the step; peak memory "
            f"{r['peak_gib'][False]:.2f} GiB without remat, {r['peak_gib'][True]:.2f} GiB with "
            f"({r['peak_gib'][True] / r['peak_gib'][False]:.3f}x, limit {REMAT_PEAK_RATIO}); "
            f"remat vs not after one step: " + " ".join(
                f"{k}={v:.3g} (limit {TOL_REMAT[k]:g})" for k, v in r["remat_err"].items())
            + f"; losses {r['losses']}; {card}")
    log(f"[rgb train] train_cli --input-type rgb --remat (2 epochs, n_task 4, batch 2) and "
        f"eval_cli fsos --input-type rgb: exit 0 and exit 0 in {cli_s:.1f} s; the checkpoint "
        f"holds {n_stats} running-stat leaves; FSOS {fsos}")
    over = [f"{mode} {k} {v} > {TOL_TRAIN_RGB[k]}" for mode, e in small.items()
            for k, v in e.items() if not v <= TOL_TRAIN_RGB[k]]
    for mode, r in full.items():
        over += [f"{mode} remat {k} {v} > {TOL_REMAT[k]}" for k, v in r["remat_err"].items()
                 if not v <= TOL_REMAT[k]]
        ratio = r["peak_gib"][True] / r["peak_gib"][False]
        if not ratio <= REMAT_PEAK_RATIO:
            over.append(f"{mode} remat peak {ratio:.3f}x > {REMAT_PEAK_RATIO}")
    if over:
        raise AssertionError("rgb and hybrid training: " + "; ".join(over))
    check_launches("rgb and hybrid training", counts, 0)
    return counts


def tta_estimators(params, device: str, num_aug: int, aggregate: str):
    """The module-path estimator at the CI operating point with TTA."""
    from isbfsar_tpu_torch.configs import HPEConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS

    cfg = HPEConfig(yolo_input_size=128, crop_size=128, yolo_thresh=0.3, compute_dtype="float32",
                    num_aug=num_aug, tta_aggregate=aggregate)
    return HumanPoseEstimator(cfg, CI_INTRINSICS, params=params, backbone_stages=V2_TINY,
                              frame_shape=CI_FRAME_HW, yolo_width=0.25, device=device)


def run_tta_small(card: str) -> dict:
    """Phase 10a: the module-path estimator with TTA at the CI size on the
    card against the CPU, and the full YOLO postprocessing on the same
    YOLO outputs; returns both kernels' launches (none are on this path)."""
    from isbfsar_tpu_torch.ops.nms import postprocess_yolo
    from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS, render_motion_clip

    params = weights.load_bundle("pose-ci-motions")
    clip, _ = render_motion_clip("wave", n_frames=TTA_CI_FRAMES, frame_hw=CI_FRAME_HW,
                                 intrinsics=CI_INTRINSICS, cycles=2.0)
    batch = torch.from_numpy(np.stack(clip).astype(np.float32))
    zero_launches()
    yolo = None
    for num_aug, aggregate in TTA_MODES:
        outs = {}
        for device in ("cuda", "cpu"):
            est = tta_estimators(params, device, num_aug, aggregate)
            stages = {}
            with torch.inference_mode():
                out = est._estimate_impl(est.nets, batch.to(device), stages=stages)
            outs[device] = [t.cpu().numpy() for t in out]
            if device == "cuda" and yolo is None:
                yolo = (stages["yolo_boxes"], stages["yolo_confs"])
        (pose, bbox, conf, found, vis), (cpose, cbbox, cconf, cfound, cvis) = outs["cuda"], outs["cpu"]
        err = {"pose": float(np.abs(pose - cpose).max()), "conf": float(np.abs(conf - cconf).max())}
        fired = int(found.sum())
        log(f"[tta small] num_aug={num_aug} {aggregate}: {TTA_CI_FRAMES} rendered wave frames "
            f"{CI_FRAME_HW}, pose-ci-motions float32, {fired} fired at 0.3, {int(vis.sum())} "
            f"visible; card vs CPU max|diff| pose {err['pose']:.3g} m, conf {err['conf']:.3g} "
            f"(limits {TOL_TTA_CI})")
        if fired == 0:
            raise AssertionError(f"num_aug={num_aug}: no frame fired at 0.3")
        if not (np.array_equal(bbox, cbbox) and np.array_equal(found, cfound)
                and np.array_equal(vis, cvis)):
            raise AssertionError(f"num_aug={num_aug}: bbox, found or visible differ card vs CPU")
        over = [f"{k} {v} > {TOL_TTA_CI[k]}" for k, v in err.items() if not v <= TOL_TTA_CI[k]]
        if over:
            raise AssertionError(f"num_aug={num_aug} card vs CPU: " + "; ".join(over))
    # the full postprocessing on the card's YOLO outputs, on the card and on
    # the CPU, at the estimator's HPEConfig thresholds and capacity
    boxes, confs, cfg = *yolo, est.config
    post = lambda b, c: postprocess_yolo(b, c, cfg.yolo_thresh, cfg.nms_thresh, cfg.max_detections)
    dets, keep = post(boxes, confs)
    cdets, ckeep = post(boxes.cpu(), confs.cpu())
    if not (torch.equal(keep.cpu(), ckeep) and torch.equal(dets.cpu(), cdets)):
        raise AssertionError("postprocess_yolo: keep or detections differ card vs CPU")
    call = lambda: post(boxes, confs)
    ms, device_ms = loop_ms(call, reps=10), graph_ms(call, reps=4)
    nodes = graph_nodes(call)
    log(f"[tta small] postprocess_yolo B={boxes.shape[0]} x {confs.shape[1]} anchors, "
        f"max_det={cfg.max_detections}: {int(keep.sum())} kept of "
        f"{int((dets[..., 4] > 0).sum())} candidates, equal card vs CPU; {ms:.3f} ms a call "
        f"(CUDA events around a host loop: {cfg.max_detections} sequential NMS steps of device "
        f"ops, no sync), {device_ms:.3f} ms a call on the device (a CUDA graph of the calls); "
        f"one call's CUDA graph holds {nodes}; {card}")
    counts = launches()
    check_launches("tta small (module path, BGR)", counts, 0)
    return counts


def graph_nodes(fn) -> dict:
    """What one call of ``fn`` puts on the card, by kind: the nodes of a
    CUDA graph captured from that call, read with the CUDA driver's
    cuGraphGetNodes and cuGraphNodeGetType (the same every call, where
    torch.profiler's tally of device events is not)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if driver.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if driver.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds, counts = {0: "kernel", 1: "memcpy", 2: "memset"}, {}
    for node in nodes:
        kind = ctypes.c_int()
        if driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = kinds.get(kind.value, f"type {kind.value}")
        counts[name] = counts.get(name, 0) + 1
    return counts


def run_tta_slice(card: str) -> dict:
    """Phase 10b: num_aug=5 "mean" at full width with focus, on the
    HumanoidSource wave clip as I420, through step and stream_batched with
    CUDA graphs against the eager oracle; the num_aug=0 step p50 beside it
    on the same nets and frames. Returns the kernels' launches."""
    import copy
    import dataclasses

    from isbfsar_tpu_torch.pipeline import FusedPipeline
    from isbfsar_tpu_torch.runtime.source import HumanoidSource

    t0 = time.perf_counter()
    source = HumanoidSource(640, 480)
    clip = [bgr_to_i420(source.read()[1]) for _ in range(32)]
    rendered = time.perf_counter() - t0
    pipe = build_slice(seed=0, cuda_graphs=True, hpe_overrides=TTA_FULL)
    eager = twin(pipe, cuda_graphs=False)
    # the same nets, support set and focus without TTA
    hpe0 = copy.copy(pipe.hpe)
    hpe0.config, hpe0._tta = dataclasses.replace(pipe.hpe.config, num_aug=0), None
    base = FusedPipeline(dataclasses.replace(pipe.config, hpe=hpe0.config), hpe=hpe0, ar=pipe.ar,
                         focus=pipe.focus, device=str(pipe.device), cuda_graphs=True)
    base.start()
    frames = [clip[i % len(clip)] for i in range(TTA_BATCHED)]
    built = time.perf_counter() - t0 - rendered
    for p in (pipe, eager, base):
        warm(p, frames)
    log(f"[tta slice] HumanoidSource(640, 480) wave clip rendered in {rendered:.1f} s; num_aug=5 "
        f"mean slice built in {built:.1f} s, warmed and captured at B={sorted(pipe._graphs)} in "
        f"{time.perf_counter() - t0 - rendered - built:.1f} s")
    zero_launches()
    seq, batched, lat, t_batched = drive(pipe, frames[:TTA_STEPS], frames, 16)
    counts = launches()
    eager_seq, eager_batched, _, _ = drive(eager, frames[:TTA_STEPS], frames, 16)
    base_seq, base_batched, base_lat, t_base = drive(base, frames[:TTA_STEPS], frames, 16)
    check_launches("tta slice", counts, dispatches(TTA_STEPS, TTA_BATCHED, 16))
    for out in seq + batched:
        for key, v in out.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"non-finite {key!r} in the TTA slice's output")
    fired = sum(int(o["conf"] > 0) for o in seq)
    log(f"[tta slice] {fired}/{TTA_STEPS} frames fired at the 0.3 gate, "
        f"{sum(int(o['pose_ok'] > 0) for o in seq)} with a visible pose, a face on "
        f"{sum(int(o['f_found'] > 0) for o in seq)}")
    if fired == 0:
        raise AssertionError("the TTA slice fired on no frame")
    check_close("tta slice num_aug=0: stream_batched vs step", base_batched[:TTA_STEPS],
                base_seq, None)
    # the batch-size difference is the detector's (TOL_BATCHED_TTA)
    detector = lambda outs: [{k: o[k] for k in ("bbox", "conf")} for o in outs]
    check_close("tta slice num_aug=0: stream_batched vs step, the detector",
                detector(base_batched[:TTA_STEPS]), detector(base_seq), TOL_BATCHED_TTA)
    for what, got, want in (("step", seq, base_seq), ("stream_batched", batched, base_batched)):
        check_close(f"tta slice: num_aug=5 vs num_aug=0, the detector, {what}", detector(got),
                    detector(want), {"bbox": 0.0, "conf": 0.0})
    check_close("tta slice: stream_batched vs step", batched[:TTA_STEPS], seq, TOL_BATCHED_TTA)
    check_close("tta slice: CUDA graphs vs eager, step", seq, eager_seq, TOL_GRAPH)
    check_close("tta slice: CUDA graphs vs eager, stream_batched", batched, eager_batched,
                TOL_GRAPH)
    on = profile_steps("tta slice num_aug=5", pipe, frames, 4, top=0)
    off = profile_steps("tta slice num_aug=0", base, frames, 4, top=0)
    log(f"[tta slice] step p50 {p50_ms(lat):.2f} ms (min {min(lat) * 1e3:.2f} ms) with num_aug=5 "
        f"against {p50_ms(base_lat):.2f} ms with num_aug=0 on the same {TTA_STEPS} frames, CUDA "
        f"graphs and focus, no limit; stream_batched B=16 {TTA_BATCHED / t_batched:.1f} FPS "
        f"(num_aug=0 {TTA_BATCHED / t_base:.1f} FPS) over {TTA_BATCHED} frames; device "
        f"{on[0]:.3f} ms and {on[1]:.0f} kernels per frame at B=1 (num_aug=0 {off[0]:.3f} ms, "
        f"{off[1]:.0f}; torch.profiler); launches {counts}; {card}")
    return counts


def run_tta_workflow(card: str) -> dict:
    """Phase 10c: the offline workflow at CI size (WORKFLOW_KW) on the card,
    and one clip's extraction card against CPU; returns the launches."""
    import dataclasses

    from isbfsar_tpu_torch.configs import HPEConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.tools.extract_dataset import extract_clip, load_clip_frames
    from isbfsar_tpu_torch.tools.synth_workflow import run_workflow
    from isbfsar_tpu_torch.train.posestack import CI_FRAME_HW, CI_INTRINSICS

    params = weights.load_bundle("pose-diverse-256")
    root = tempfile.mkdtemp(prefix="synthwf_")
    try:
        zero_launches()
        receipt = run_workflow(params, root, CI_FRAME_HW, CI_INTRINSICS, device="cuda",
                               **WORKFLOW_KW)
        counts = launches()
        log(f"[workflow] stage walls (s): {receipt['wall_s']}; receipt {json.dumps(receipt)}")
        # one clip's extraction, card against CPU, in float32
        cfg = HPEConfig(yolo_input_size=128, crop_size=256, yolo_thresh=0.3, skeleton=None,
                        compute_dtype="float32")
        frames = load_clip_frames(os.path.join(root, "videos_train", "wave", "0"))
        poses = {}
        for device in ("cuda", "cpu"):
            est = HumanPoseEstimator(cfg, CI_INTRINSICS, params=params, backbone_stages=V2_TINY,
                                     frame_shape=CI_FRAME_HW, yolo_width=0.25, device=device)
            res = extract_clip(est, frames, 16, with_images=False, smooth=True)
            poses[device] = None if res is None else np.stack(res[0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if poses["cuda"] is None or poses["cpu"] is None:
        raise AssertionError(f"extraction skipped the clip: card {poses['cuda'] is None}, "
                             f"CPU {poses['cpu'] is None}")
    err = float(np.abs(poses["cuda"] - poses["cpu"]).max())
    log(f"[workflow] videos_train/wave/0 extracted (16 frames, 122 joints, smoothed) card vs CPU "
        f"in float32: max|diff| {err:.3g} m (limit {TOL_EXTRACT}); launches {counts}; {card}")
    if not err <= TOL_EXTRACT:
        raise AssertionError(f"extraction card vs CPU {err} > {TOL_EXTRACT}")
    if receipt["train_classes"] != 8 or set(receipt["fsos"]) != {"FSOS-ACC", "FS-ACC", "OS-ACC"}:
        raise AssertionError(f"workflow receipt {receipt}")
    check_launches("workflow", counts, 0)
    return counts


def run_tta(card: str) -> dict:
    """Phase 10: the estimator's other options and the synthetic humanoid;
    returns each path's kernel launches."""
    by_path = {}
    for name, fn in (("TTA module path and postprocess_yolo, CI size", run_tta_small),
                     ("TTA num_aug=5 FusedPipeline step and stream_batched", run_tta_slice),
                     ("offline workflow (render, extract, train, FSOS), CI size",
                      run_tta_workflow)):
        t = time.perf_counter()
        by_path[name] = fn(card)
        log(f"[tta] {name} in {time.perf_counter() - t:.1f} s")
    return by_path


def synth_trainer(kind: str, device: str, variables=None):
    """Phase 11a: the CI-size trainer of ``kind`` on ``device`` (the port's
    seeded init, or ``variables``)."""
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.train import gazefocus as gf
    from isbfsar_tpu_torch.train import posestack as ps

    if kind == "yolo":
        return ps.YoloTrainer(width=0.25, input_size=128, lr=1e-3, variables=variables,
                              device=device)
    if kind == "heatmap":
        return ps.HeatmapTrainer(ps.CI_INTRINSICS, crop_size=128, stages=V2_TINY,
                                 variables=variables, device=device)
    cls = {"blaze": gf.BlazeFaceTrainer, "lm": gf.LandmarkRefinerTrainer,
           "gaze": gf.GazeTrainer}[kind]
    return cls(gf.CI_FOCUS_CFG, variables=variables, device=device)


def synth_batch(kind: str) -> dict:
    """Phase 11a: one CI-size batch of 2 for ``kind``, made on the host (the
    gaze crops through the plain geometry on the CPU)."""
    from isbfsar_tpu_torch.train import gazefocus as gf
    from isbfsar_tpu_torch.train import posestack as ps

    if kind in ("yolo", "heatmap"):
        sampler = ps.SyntheticHumanSampler(ps.CI_FRAME_HW, ps.CI_INTRINSICS, seed=1)
        if kind == "yolo":
            return ps.detector_batch(sampler, 2, 128, np.asarray([320, 240, 320, 240],
                                                                 np.float32), 0.5)
        return ps.pose_batch(sampler, 2, 0.08)
    sampler = gf.SyntheticFaceSampler(seed=1)
    if kind == "blaze":
        return gf.face_detector_batch(sampler, 2)
    if kind == "lm":
        return gf.refiner_batch(sampler, 2)
    frames, lms, gazes = gf.gaze_batch(sampler, 2, 0.005)
    crops, r_norm = gf.make_normalized_crop_fn(gf.CI_FOCUS_CFG, with_rnorm=True,
                                               device="cpu")(frames, lms)
    return {"crop": crops.numpy(), "pitchyaw": gf.gaze_labels(gazes, r_norm).numpy()}


def synth_state(trainer) -> tuple:
    """(parameters, Adam's first moments, running stats) of a trainer, as
    CPU float64 tensors in its optimizer's order (the stats by name)."""
    mods = ([trainer.bbone, trainer.head] if hasattr(trainer, "bbone") else [trainer.net])
    stats = {f"{i}.{k}": v.detach().double().cpu() for i, m in enumerate(mods)
             for k, v in m.state_dict().items() if k.endswith((".mean", ".var"))}
    opt = trainer.optimizer
    return ([p.detach().double().cpu() for p in opt.params],
            [m.detach().double().cpu() for m in opt.mu], stats)


def rel_l2(got: list, want: list) -> float:
    got, want = torch.cat([t.ravel() for t in got]), torch.cat([t.ravel() for t in want])
    return float((got - want).norm() / want.norm())


def synth_step_errors(kind: str, tf32: bool = False) -> dict:
    """Phase 11a: one CI-size step of ``kind`` on the card against the CPU
    from one init and batch (on the card with TF32 on if ``tf32``);
    returns the differences."""
    cpu = synth_trainer(kind, "cpu")
    card = synth_trainer(kind, "cuda", variables=cpu.variables)  # pins TF32 off
    p0 = synth_state(cpu)[0]
    b = synth_batch(kind)
    loss = {"cpu": cpu.train_step(b)}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        loss["card"] = card.train_step(b)
    finally:
        pin_float32_matmul()
    (p_cpu, mu_cpu, st_cpu), (p_card, mu_card, st_card) = synth_state(cpu), synth_state(card)
    return {"loss": abs(loss["cpu"] - loss["card"]),
            "grad_l2": rel_l2(mu_card, mu_cpu),
            "update_l2": rel_l2([a - o for a, o in zip(p_card, p0)],
                                [a - o for a, o in zip(p_cpu, p0)]),
            "stats": max(float((st_card[k] - v).abs().max()) for k, v in st_cpu.items()),
            "finite": bool(np.isfinite(loss["card"]))}


def check_gaze_crop() -> dict:
    """Phase 11a: one gaze batch's crops at ``FocusConfig()`` and batch 8,
    as 11b's ``train_focus_params`` makes them, through the focus-geometry
    kernel on the card against the plain geometry's on the card, and the
    labels; returns the largest differences (the kernel's launch is a
    comparison: it is not counted on a path)."""
    from isbfsar_tpu_torch.configs import CameraIntrinsics, FocusConfig
    from isbfsar_tpu_torch.ops.warp import warp_image_bilinear
    from isbfsar_tpu_torch.train import gazefocus as gf

    cfg = FocusConfig()
    frames, lms, gazes = gf.gaze_batch(gf.SyntheticFaceSampler(seed=2), SYNTH_BATCH, 0.005)
    crops, r_norm = gf.make_normalized_crop_fn(cfg, with_rnorm=True, device="cuda")(frames, lms)
    k = torch.from_numpy(CameraIntrinsics().matrix()).cuda()
    dist, size = cfg.normalized_camera_distance, cfg.gaze_image_size
    ref = head_pose.focus_geometry_reference(torch.from_numpy(lms).cuda(), k, dist, dist, size)
    ref_crops = warp_image_bilinear(torch.from_numpy(frames).cuda().float(), ref.warp,
                                    size).flip(-1) / 255.0
    torch.cuda.synchronize()
    return {"crop": float((crops - ref_crops).abs().max()),
            "labels": float((gf.gaze_labels(gazes, r_norm)
                             - gf.gaze_labels(gazes, ref.r_norm)).abs().max())}


def check_synth_eval() -> dict:
    """Phase 11a: ``evaluate_pose_stack`` on pose-ci-motions in float32 on
    the card and on the CPU (the module-path estimator)."""
    from isbfsar_tpu_torch.configs import HPEConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.train import posestack as ps

    params = weights.load_bundle("pose-ci-motions")
    out = {}
    for device in ("cuda", "cpu"):
        est = HumanPoseEstimator(HPEConfig(yolo_input_size=128, crop_size=128,
                                           compute_dtype="float32"),
                                 ps.CI_INTRINSICS, params=params, backbone_stages=V2_TINY,
                                 frame_shape=ps.CI_FRAME_HW, yolo_width=0.25, device=device)
        out["card" if device == "cuda" else "cpu"] = ps.evaluate_pose_stack(
            est, ps.CI_FRAME_HW, ps.CI_INTRINSICS, **SYNTH_EVAL)
    return out


def timed_steps(trainer, make_batch, n: int) -> tuple:
    """One warm-up step, then n timed steps, each batch made on the host
    first: (step seconds, sampler seconds per batch, losses); the card
    synchronised around each step. The warm-up is the first step after the
    remat pair's deterministic cuDNN: without it, 10 timed steps on an H100
    80GB HBM3 at 700 W read a slowest step 2.5-4.3 times their p50."""
    losses = [trainer.train_step(make_batch())]
    step_s, load_s = [], []
    for _ in range(n):
        t = time.perf_counter()
        b = make_batch()
        load_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(trainer.train_step(b))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    return step_s, load_s, losses


def synth_remat_pair(make_trainer, b: dict) -> tuple:
    """One step without remat and one with from one init and batch, cuDNN
    deterministic: (the trainer without remat, each step's peak GiB above
    the memory held before it, the largest parameter and running-stat
    difference after it, both losses)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trainers, peak, losses = {}, {}, []
    try:
        for remat in (False, True):
            trainer = make_trainer(remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            losses.append(trainer.train_step(b))
            torch.cuda.synchronize()
            # the step's own peak: above what the trainers held before it
            # (both trainers' parameters and Adam moments stay allocated)
            peak[remat] = (torch.cuda.max_memory_allocated() - held) / 2**30
            trainers[remat] = trainer
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, other = synth_state(trainers[False]), synth_state(trainers[True])
    err = {"params": max(float((a - b_).abs().max()) for a, b_ in zip(plain[0], other[0])),
           "batch_stats": max(float((plain[2][k] - v).abs().max()) for k, v in other[2].items())}
    return trainers[False], peak, err, losses


def run_synth_full(card: str) -> dict:
    """Phase 11b: the trainers at the tool's --production sizes; returns the
    readings. The caller reads the launch counts around this."""
    from isbfsar_tpu_torch.configs import CameraIntrinsics, FocusConfig
    from isbfsar_tpu_torch.models.effnetv2 import V2_L
    from isbfsar_tpu_torch.train import gazefocus as gf
    from isbfsar_tpu_torch.train import posestack as ps

    hw, intr = ps.PROD_FRAME_HW, CameraIntrinsics()
    norm = np.asarray([hw[1], hw[0], hw[1], hw[0]], np.float32)
    yolo_kw = dict(width=1.0, input_size=256)
    pose_kw = dict(crop_size=256, stages=V2_L, huber_beta=0.02)
    out = {}
    det_sampler = ps.SyntheticHumanSampler(hw, intr, seed=3)
    make_det = lambda: ps.detector_batch(det_sampler, SYNTH_BATCH, 256, norm, 0.12)  # noqa
    init = ps.YoloTrainer(device="cpu", **yolo_kw).variables
    trainer, peak, err, losses = synth_remat_pair(
        lambda remat: ps.YoloTrainer(variables=init, remat=remat, device="cuda", **yolo_kw),
        make_det())
    step, load, more = timed_steps(trainer, make_det, SYNTH_TIMED_STEPS)
    out["YoloTrainer width 1.0 @256"] = dict(step_s=step, load_s=load, peak_gib=peak,
                                             remat_err=err, losses=losses + more)
    del trainer, init
    pose_sampler = ps.SyntheticHumanSampler(hw, intr, seed=4)
    make_pose = lambda: ps.pose_batch(pose_sampler, SYNTH_BATCH, 0.08)  # noqa: E731
    init = ps.HeatmapTrainer(intr, device="cpu", **pose_kw).variables
    trainer, peak, err, losses = synth_remat_pair(
        lambda remat: ps.HeatmapTrainer(intr, variables=init, remat=remat, device="cuda",
                                        **pose_kw), make_pose())
    step, load, more = timed_steps(trainer, make_pose, SYNTH_TIMED_STEPS)
    out["HeatmapTrainer V2_L crop 256"] = dict(step_s=step, load_s=load, peak_gib=peak,
                                               remat_err=err, losses=losses + more)
    del trainer, init
    t = time.perf_counter()
    delta = weights.load_bundle("pose-prod-256-calib")
    yolo = ps.finetune_detector(delta, hw, intr, n_steps=SYNTH_FIT_STEPS,
                                batch_size=SYNTH_BATCH, yolo_width=1.0, yolo_input_size=256,
                                log_every=1, device="cuda")
    torch.cuda.synchronize()
    out["finetune_detector from pose-prod-256-calib"] = dict(
        seconds=time.perf_counter() - t, steps=SYNTH_FIT_STEPS,
        finite=all(bool(torch.isfinite(x).all()) for x in _leaves(yolo)))
    t = time.perf_counter()
    focus = gf.train_focus_params(FocusConfig(), n_steps_det=SYNTH_FIT_STEPS,
                                  n_steps_gaze=SYNTH_FIT_STEPS, n_steps_lm=SYNTH_FIT_STEPS,
                                  batch_size=SYNTH_BATCH, device="cuda")
    torch.cuda.synchronize()
    out["train_focus_params FocusConfig() (224, bf16)"] = dict(
        seconds=time.perf_counter() - t, steps=SYNTH_FIT_STEPS,
        finite=all(bool(torch.isfinite(x).all()) for x in _leaves(focus)))
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def spread_ms(seconds: list) -> str:
    return (f"p50 {p50_ms(seconds):.2f} ms (fastest {min(seconds) * 1e3:.2f}, slowest "
            f"{max(seconds) * 1e3:.2f})")


def run_synth(card: str) -> dict:
    """Phase 11: the synthetic trainers; returns each path's kernel launches."""
    zero_launches()
    t = time.perf_counter()
    small = {kind: synth_step_errors(kind) for kind in TOL_SYNTH_TRAIN}
    evals = check_synth_eval()
    counts_small = launches()
    # comparisons, not paths: the TF32 control launches no kernel of ours,
    # the crop check the focus-geometry kernel once
    tf32 = synth_step_errors("heatmap", tf32=True)
    crop = check_gaze_crop()
    log(f"[synth] 11a in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    zero_launches()
    full = run_synth_full(card)
    counts = launches()
    log(f"[synth] 11b in {time.perf_counter() - t:.1f} s")

    def readings(e: dict, tol: dict) -> str:
        return " ".join(f"{k}={e[k]:.3g} (limit {v:g})" for k, v in tol.items())

    for kind, e in small.items():
        log(f"[synth] {kind} one CI-size step, card vs CPU: "
            + readings(e, TOL_SYNTH_TRAIN[kind]))
    tf32_over = [k for k, v in TOL_SYNTH_TRAIN["heatmap"].items() if not tf32[k] <= v]
    log("[synth] heatmap one CI-size step with TF32 on the card (must fail its limits), card "
        f"vs CPU: {readings(tf32, TOL_SYNTH_TRAIN['heatmap'])}; over: {tf32_over}")
    log(f"[synth] gaze crop at FocusConfig(), batch {SYNTH_BATCH}, through focus_geometry "
        f"(kernel) vs focus_geometry_reference on the card: crops {crop['crop']:.3g} (limit "
        f"{TOL_GAZE_CROP:g}), labels {crop['labels']:.3g} (limit {TOL_GAZE_LABELS:g})")
    log(f"[synth] evaluate_pose_stack on pose-ci-motions ({SYNTH_EVAL}), card {evals['card']}; "
        f"CPU {evals['cpu']}")
    for name, r in full.items():
        if "step_s" in r:
            log(f"[synth] {name}, batch {SYNTH_BATCH} on 480x640 frames, {SYNTH_TIMED_STEPS} "
                f"steps after a warm-up: train step {spread_ms(r['step_s'])} (the card "
                f"synchronised around each); host sampler {spread_ms(r['load_s'])} per batch = "
                f"{p50_ms(r['load_s']) / p50_ms(r['step_s']):.2f}x the step (steps, ms: "
                f"{[round(x * 1e3, 2) for x in r['step_s']]}); the step's peak "
                f"memory above what was held before it {r['peak_gib'][False]:.2f} GiB without "
                f"remat, {r['peak_gib'][True]:.2f} GiB with; remat vs not after one step: "
                + " ".join(f"{k}={v:.3g} (limit {TOL_REMAT[k]:g})"
                           for k, v in r["remat_err"].items())
                + f"; losses {r['losses']}; {card}")
        else:
            log(f"[synth] {name}: {r['steps']} steps a phase, batch {SYNTH_BATCH}, in "
                f"{r['seconds']:.1f} s; {card}")
    log(f"[synth] launches in 11a {counts_small}, in 11b {counts}")

    over = [f"{kind} {k} {e[k]} > {v}" for kind, e in small.items()
            for k, v in TOL_SYNTH_TRAIN[kind].items() if not e[k] <= v]
    over += [f"{kind}: a non-finite loss" for kind, e in small.items() if not e["finite"]]
    if not tf32_over:
        over.append("the heatmap step with TF32 on passed every limit: they cannot see it")
    if not crop["crop"] <= TOL_GAZE_CROP:
        over.append(f"gaze crop {crop['crop']} > {TOL_GAZE_CROP}")
    if not crop["labels"] <= TOL_GAZE_LABELS:
        over.append(f"gaze labels {crop['labels']} > {TOL_GAZE_LABELS}")
    for key in ("found_rate", "empty_fp_rate", "hard_empty_fp_rate"):
        if evals["card"][key] != evals["cpu"][key]:
            over.append(f"evaluate_pose_stack {key}: card {evals['card'][key]}, CPU "
                        f"{evals['cpu'][key]}")
    for key, tol in TOL_EVAL.items():
        if not abs(evals["card"][key] - evals["cpu"][key]) <= tol:
            over.append(f"evaluate_pose_stack {key} differs by more than {tol}")
    for name, r in full.items():
        if "losses" in r and not all(np.isfinite(r["losses"])):
            over.append(f"{name}: a non-finite loss {r['losses']}")
        if "finite" in r and not r["finite"]:
            over.append(f"{name}: a non-finite parameter")
        over += [f"{name} remat {k} {v} > {TOL_REMAT[k]}"
                 for k, v in r.get("remat_err", {}).items() if not v <= TOL_REMAT[k]]
    if over:
        raise AssertionError("synthetic trainers: " + "; ".join(over))
    # 11a runs neither kernel (its gaze batch is made on the CPU); 11b
    # launches the focus-geometry kernel once per gaze batch, the I420
    # kernel never
    check_launches("synthetic trainers, CI size", counts_small, 0)
    check_launches("synthetic trainers at full width", counts,
                   {"fused_i420_inputs": 0, "focus_geometry": SYNTH_FIT_STEPS})
    return {"synthetic trainers, CI size, card vs CPU (11a)": counts_small,
            "synthetic trainers at full width (11b)": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 1
    phases = {}
    t = time.perf_counter()
    card = nvidia_smi()
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    phases["env"] = time.perf_counter() - t

    t = time.perf_counter()
    for name, info in build.build_all().items():
        ptxas = [ln.strip() for ln in info.log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {info.path} in {info.seconds:.1f} s; " + " | ".join(ptxas))
    phases["build"] = time.perf_counter() - t

    rng = np.random.default_rng(0)
    t = time.perf_counter()
    entry = check_kernel(rng)
    pose_entry = check_head_pose(rng)
    phases["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    check_small_input()
    phases["small"] = time.perf_counter() - t

    t = time.perf_counter()
    counts = run_slice(card, slice_frames())
    phases["slice"] = time.perf_counter() - t

    t = time.perf_counter()
    by_path = {"FusedPipeline step and stream_batched": counts,
               "serve --fused (the service process)": run_service(card)}
    phases["serve"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path.update(run_serving(card))
    phases["serving"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path["Trainer.fit/step, evaluate_fsos, calibrate_os_threshold, CLIs"] = run_train(card)
    phases["train"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path.update(run_rgb(card))
    phases["rgb"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path["rgb and hybrid Trainer.step, train_cli, eval_cli"] = run_rgb_train(card)
    phases["rgb_train"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path.update(run_tta(card))
    phases["tta"] = time.perf_counter() - t
    t = time.perf_counter()
    by_path.update(run_synth(card))
    phases["synth"] = time.perf_counter() - t
    log("[phases] " + " ".join(f"{k}={v:.1f}s" for k, v in phases.items()))

    kernels = [{"name": "fused_i420_inputs", "route": "cuda",
                "source": "isbfsar_tpu_torch/csrc/fused_i420.cu",
                "replaces": "isbfsar_tpu/ops/pallas_input.py:118",
                "launches": counts["fused_i420_inputs"],
                "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
                "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
                "bound_by": entry["bound_by"], "library_ms": None, "shape": entry["shape"],
                "ms_b1": entry["ms_b1"], "bound_ms_b1": entry["bound_ms_b1"],
                "launches_by_path": {k: v["fused_i420_inputs"] for k, v in by_path.items()}},
               {"name": "focus_geometry", "route": "cuda",
                "source": "isbfsar_tpu_torch/csrc/head_pose.cu",
                # replaces no Pallas kernel: the JAX functions are
                # isbfsar_tpu/focus/geometry.py:106 and the geometry after
                # it, which XLA compiles
                "replaces": None, "launches": counts["focus_geometry"],
                "max_abs_err": pose_entry["max_abs_err"], "ms": pose_entry["ms"],
                "plain_ms": pose_entry["plain_ms"], "bound_ms": pose_entry["bound_ms"],
                "bound_by": "operations", "library_ms": None, "shape": pose_entry["shape"],
                "ms_b1": pose_entry["ms_b1"], "bound_ms_b1": pose_entry["bound_ms_b1"],
                "launches_by_path": {k: v["focus_geometry"] for k, v in by_path.items()},
                **{f"err_{f}": v for f, v in pose_entry["err"].items()}}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
