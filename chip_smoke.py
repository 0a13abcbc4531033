#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (s2r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, each of which must pass:

1. Build the hand-written kernels (s2r_tpu_torch/csrc/*.cu) with plain nvcc
   and the host libraries (csrc/host/imaging.cpp, the native pipeline
   csrc/host/pipeline.cpp) with g++, one process per source, all at once,
   into s2r_tpu_torch/_build/.
2. Hold each kernel against its plain PyTorch version on the card, at every
   shape the serving path (2048x1024 batch 8, 513x513 batch 1), the train
   step (512x1024 batch 8) and the train_adapt driver of phase 5 (512x512:
   the step and validation at batch 8, image logging at batch 3) give it,
   and time kernel, plain version and, where one exists, the one PyTorch
   call that computes the same function (library_ms, a yardstick only).
   Tolerances: depthwise forward and dx float32 max|diff| <= 1e-5 *
   max(1, max|ref|), bfloat16 |diff| <= 1e-2 * max(1, |ref|) elementwise;
   depthwise dk max|diff| <=
   1e-4 * max|ref| (a reduction over ~1e7 terms in another order); the
   four BatchNorm entries (statistics with the running statistics, y, the
   backward sums, dx; phase 2d) max|diff| <= 1e-5 (float32) and 1e-4
   (bfloat16) of max|ref| for each per-channel row and each output, and
   the whole composite timed against native_batch_norm + its backward;
   disc_conv1 (bfloat16 on the tensor cores, float32 on the CUDA cores) as
   the depthwise forward; requant bit-exact; the BatchNorm entries and dk,
   which fold in a fixed order, bit-identical on a repeated call.  The
   depthwise tile sweeps are also held at edge shapes (phases 2a, 2c:
   tiles wider than the image, H = W = 1, odd H at dilation 2, dilations
   4 and 40, tile edges inside a halo, blocks streaming many tiny images,
   C = 7 and unaligned inputs), and their kernels-line entries list each
   path's shapes (per_shape: C, H, W, d, launches, ms, library_ms,
   bound_ms a launch) with the count of shapes where the kernel is slower
   than its cuDNN call (slower_than_library).
   bound_ms is the larger of the bytes over 3.35 TB/s and the flops over
   the published peak for the operands' arithmetic (bfloat16 989 TFLOP/s
   on the tensor cores, float32 67 TFLOP/s).  Phase 2f runs each kernel
   that indexed in 32 bits on one input of more than 2^31 elements (the
   depthwise forward and requant split the batch, dk and disc_conv1 index
   in 64 bits) and compares the batch items at each side of the split and
   the last with the plain version.
3. Serve DeepLab-V3+ MobileNetV2 (output stride 16, 19 classes, full width,
   weights from a seeded torch.Generator, BatchNorm statistics perturbed):
   batch-1 513x513 float32 logits against the same model on the CPU through
   the plain versions (max|diff| <= 1e-4 * max(1, max|ref|), labels >= 99.9%
   equal), decoder-int8 labels likewise (>= 99%), then rgb8 2048x1024 batch 8
   to labels in exact and decoder-int8 mode in bfloat16, timed with CUDA
   events.  The launch counts of one exact and one int8 batch-8 call show
   that the serving path went through its kernels.
4. Train: the output-space adaptation step built by
   s2r_tpu_torch.train.setup.build_method.  (a) One step at 128x128 batch 2
   float32, dropout off, on the card and on the CPU (plain versions) from
   the same weights (BatchNorm scale and bias perturbed too, off the kink
   tie of the initial point; perturb_batchnorm in
   s2r_tpu_torch/tools/step_conditioning.py says why), and on the CPU in
   float64 as the exact reference: losses rtol 1e-4, BatchNorm running
   statistics within 1e-3 of each layer's largest, D's update of the same
   sign on >= 99% of elements, and G's gradient per leaf (read from SGD's
   momentum buffer) within 3e-2 relative L2 of the float64 one, or within
   3x the CPU float32 gradient's distance from it for that leaf if larger;
   leaves whose float64 gradient is zero up to rounding are left out.
   Float32 rounding alone moves the leaves by 0.5-1.1% at this size (the
   tool s2r_tpu_torch/tools/step_conditioning.py measures it; the tests
   in tests/test_torch_port_train_step_f64.py hold the float64 step to the
   JAX package's leaf by leaf).  (b) 512x1024 batch 8 bfloat16, the
   bench.py train configuration: 2 warm-up and 5 timed steps
   (CUDA events), ms/step, source images/s and peak memory, finite losses,
   and the launch counts of one step, with the BatchNorm layout copies.
5. The train_adapt driver: ``s2r_tpu_torch.cli.train_adapt.main`` in this
   process, --dataset synthetic --device-aug, 512x512 batch 8 bf16, two
   epochs (8 steps and 4 validation batches each), in a temporary run
   root.  Finite losses, mIoU in [0, 1], checkpoint.ckpt, best_pred.txt
   and model_best.ckpt on disk, and each kernel's launches in the run
   equal to what the step count and the eval forwards predict.  Then a
   checkpoint of the final state (timed: the save's hold on the loop, and
   saver.wait()), a Trainer resumed from it with ft off (weights,
   BatchNorm statistics, optimizer buffers, step, dropout generator and
   start_epoch bit-equal to the live state) and one more epoch with
   finite losses; val_adapt on model_best.ckpt within 1e-4 of the
   Trainer's best mIoU; the device augmentation on the card against the
   CPU on the same sampled parameters (images within 1e-4, labels equal);
   validation ms/image and the step-only images/s at 512x512 beside each
   epoch's images/s.
6. The feature-space adaptation and source-only methods (build_method
   'feature_adapt' and 'source_only': G with the DomainClassifier on the
   ASPP feature, one gradient of task + d + d_inv, three optimizer steps).
   (a) One 128x128 batch-2 float32 step of each on the card against the
   CPU (float32 and the float64 reference), from phase 4a's weights with
   the domain classifier's BatchNorms perturbed too, dropout off: losses
   rtol 1e-4, running statistics of G and D within 1e-3 of each layer's
   largest, G's gradient (from the 'task' buffer) and D's (from 'd') per
   leaf within LEAF_BOUND of the float64 run as in 4a; source-only leaves
   D, its statistics and buffers untouched and its domain metrics zero.
   (b) bench.py's feature cell (512x1024 batch 8 bf16) and source-only
   cell (513x513 batch 4 bf16): median of 5 steps by CUDA events after 2
   warm-up, ms/step, images/s, peak memory, and the launches of one step:
   depthwise 56/28, dk 28/14, BatchNorm stats and apply 124/60, grad_sums
   and dx 121/60 (the target logits feed no loss, so the decoder's three
   BatchNorms of the target forward take no backward), disc_conv1 and
   requant 0 (step_launches).  (c) The kernels at this path's new
   shapes against their plain versions: depthwise forward, dx and dk at
   the 513x513 batch-4 layers; the BatchNorm entries (in phase 2d's loop)
   at the source-only cell's inputs and the domain classifier's C = 1024
   rows without a ring (8x32x64, and the driver's 8x32x32).  (d) The
   train driver, ``s2r_tpu_torch.cli.train.main`` (feature_adapt,
   --dataset synthetic --device-aug, 512x512 batch 8 bf16, one epoch),
   its launches as predicted; a Trainer resumed from its final state
   with ft off (bit-equal) for one more epoch; ``cli.val`` on
   model_best.ckpt with the per-image export (mIoU within 1e-4 of the
   Trainer's, one labelId and one color PNG an image at 1280x640) and
   ``cli.test`` (the same PNGs), each with its depthwise launches counted.
7. The real datasets, from full-size PNG fixtures written in a temporary
   directory by s2r_tpu_torch/tools/fixtures.py (16 GTA5-sized 1914x1052
   sources with P-mode labels, 16 Cityscapes-sized 2048x1024 targets, 8 val
   pairs with L-mode labelIds, 8 test frames; synthetic scenes scaled up,
   each file cycling the five PNG filter types).  The host imaging library
   (s2r_tpu_torch/csrc/host/imaging.cpp, built with g++ beside the kernels)
   hashes its outputs on seeded resize, box-resize, blur and train-transform
   calls to IMAGING_DIGEST, the SHA-256 that
   tests/test_torch_port_imaging.py holds PIL's outputs to (the card has no
   PIL), and decodes every fixture to the array it was written from.  Then,
   at the phase 5 cell: (a) train_adapt --dataset gtav2cityscapes on the
   default host path, one epoch of 2 steps, the loader alone at 4 and 8
   workers, and val_adapt with the per-image export; (b) the same with
   --device-aug, GTA5-sized sources and Cityscapes-sized targets in one
   batch (ROADMAP C.9); (c) with --data-cache for two epochs, the decodes
   counted against the loader's draws (the second epoch decodes no source
   or label, only the targets it draws first); (d) train --dataset gtav
   (source-only) and test, one PNG pair per frame of the GTA5 test split.
   Each run's launches as predicted, its epoch images/s, and one more
   epoch profiled for its idle share.
8. Checkpoints in, frames out, at the phase 5 cell and the serving width.
   (a) Phase 5's final output_adapt state written in the JAX package's
   msgpack format (io/checkpoint.py save_jax_checkpoint) and read back
   bit-equal leaf by leaf (weights, statistics, optimizer buffers, step,
   dropout generator); a Trainer resumed from it with ft off, bit-equal,
   and one epoch with finite losses and launches as predicted.  (b)
   cli.export --format torch: the single schema from that file, the four
   schema from phase 6d's best checkpoint; each .pth.tar resumed gives G
   (and the domain classifier) bit-equal, and val_adapt / val on it give
   phase 5's / 6d's mIoU within 1e-4.  (c) cli.export --format servable
   at 2048x1024 batch 8 rgb8, exact and decoder-int8 (calibrated on 4
   synthetic val batches).  (d) cli.infer over 16 Cityscapes-sized and 8
   GTA5-sized PNG fixtures (three batches; the GTA5 frames resized on the
   host) with each servable: labels identical to make_serving_fn on the
   same decoded, resized batch in this process, every PNG decoding to what
   _save_prediction maps the labels to, 14 depthwise launches a batch and
   1 requant a batch in int8 mode; ms/image including host IO, steady
   state after batch 0, and the decode/device/save split (host clock,
   unprofiled).
9. The other backbones at full width, with seeded weights and perturbed
   BatchNorm statistics: ResNet-101 and -50, Aligned Xception-65 (os 16)
   and DRN-D-54 (os 8).  (a) The depthwise forward, dx and dk kernels at
   Xception's 56 stride-1 depthwise shapes (C 64-1536, dilations 1 and 2)
   of the 512x1024 batch-8 train cell and the 2048x1024 batch-8 serving
   forward, and at 513x513 batch 1 at os 16 (33x33 at dilation 2) and os
   8 (65x65 at dilation 4), at phase 2's tolerances, timed against cuDNN
   (per_shape under serve_xception and train_step_xception); each
   backbone's BatchNorm inputs at the train cell in phase 2d's loop (C up
   to 2048).  (b) ResNet-101, Xception and DRN served as phase 3 serves
   MobileNetV2 (513x513 float32 against the CPU, exact and int8; rgb8
   2048x1024 batch 8 bf16 timed, with peak memory, and for ResNet-101 and
   Xception the exact call's eval-BatchNorm share: the call timed again
   with every BatchNorm the identity, tools/profile_serving.py
   eval_bn_share; DRN, ~3.2 s a call, over 2 calls after 1 warm-up).
   (c) The output step of each backbone at 512x1024 batch 8 bf16 as
   phase 4b, its launches
   against step_launches (LAYERS: each backbone's stride-1 depthwise convs
   and BatchNorms, held to the modules' own counts); the 64x64 batch-2
   float32 step of Xception and ResNet-50 on the card against the CPU
   and float64 as phase 4a; Xception's feature step at the same cell.
   (d) ``cli.train_adapt --backbone xception`` for one epoch at the phase
   5 cell, launches as predicted, its state written in the JAX format and
   read back bit-equal, exported as a 2048x1024 batch-8 rgb8 servable
   (``cli.export --format servable``) and swept over phase 8's 24 frames
   by ``cli.infer``: labels equal to make_serving_fn in this process, 56
   depthwise launches a batch.
10. Data-parallel training and the model's two flags (ROADMAP A.8, A.5).
   (a) The split entries of synchronized BatchNorm (batch_norm_sums and
   batch_norm_finish_apply forward, grad_sums_local and grad_finish
   backward) at phase 2d's train-cell shapes at a rank's batch (BATCH /
   2): on all rows bit-equal to the fused entries (y, the statistics
   rows, the running statistics, the backward rows), two row halves'
   sums added and finished against the fused entries on all rows (the
   cotangent of shift split between them; their y bit-equal to
   batch_norm_apply on their own rows), each against its plain
   version, at phase 2d's tolerances; timed (CUDA events; the card's
   time by torch.profiler and the host's a call,
   tools/profile_bn_split.py) against the one-card entries on the same
   rows, the plain versions and batch_norm_stats /
   gather_stats_with_counts + batch_norm_elemt /
   batch_norm_backward_reduce.
   (b) Two ranks on the one card, each a process of
   s2r_tpu_torch/tools/dist_check.py with a gloo group (NCCL refuses two
   ranks on one device, "Duplicate GPU detected": tools/profile_dist.py;
   gloo all-reduces CUDA tensors through the host):
   the output step at 256x512 global batch 4 float32, dropout off, 2
   steps, against one process at the whole batch (losses rel 1e-5 at the
   first step, 1e-4 after; G's update per leaf within LEAF_BOUND or 3x
   its float32 spread, card against CPU; D's update signs >= 99%; running
   statistics within 1e-3 of each layer's largest, every rank's state
   bit-equal, 249 all-reduces a step, launches as predicted); then timed
   at the train cell (512x1024 global batch 8 bf16, 4 a rank): ms/step,
   launches and all-reduces a step, peak memory a rank (not a time of
   NCCL across cards).  (c) cli.train_adapt at the phase 5 cell for one
   epoch with torchrun's world-1 environment (NCCL), bit-equal to the
   same run without a group (cuDNN deterministic in both), no collective
   call, the fused entries.  (d) Serving with split_concat at 2048x1024
   batch 8, exact and decoder-int8: float32 labels >= 99.9% equal to the
   concat model's, bf16 labels moved no more than bf16 moves them from
   float32; timed in bf16, in turns; the output step at the train cell
   with --logits-dtype bf16 against float32 logits, in turns;
   cli.export --serve-split-concat of phase 5's final state and cli.infer
   over phase 8's frames, labels equal to make_serving_fn in this process.
11. The native data path (--data-backend native) on phase 7's fixture
   recipe.  (a) The pipeline's outputs on seeded PNGs hash to
   NATIVE_DIGEST, which tests/test_torch_port_native.py holds the port to
   on the CPU and ties to the JAX package's native library.  (b) Every
   fixture decodes through the native decoder to the array written, the
   P-mode GTA5 labels to their palette indices (ROADMAP C.12).  (c)
   train_adapt --data-backend native for one epoch at phase 7's argv
   (finite losses, mIoU in [0, 1]), then val_adapt with the per-image
   export and test_adapt through NativeEvalLoader, launches as predicted.
   (d) The native loader alone at 4 and 8 threads and a profiled epoch's
   images/s and idle share, beside phase 7's host route; bench.py's
   train_e2e configuration (TRAIN_HW crops, blur off, uint8, batch 8
   bf16, the output step): images/s end to end and the loader's alone.
   None of these is a gate.  (e) train_adapt with --profile-dir writes
   one trace file that names the hand-written kernels; one more traced
   epoch's host memory and trace size.
12. The memory and padding arms (ROADMAP A.9).  (a) The output step at
   the train cell with --remat against the same step without, from the
   same weights, batch and generator, cuDNN deterministic: losses and
   parameters within tests/test_remat.py's bounds (rtol 1e-5, atol
   1e-6), running statistics, num_batches_tracked and the dropout
   generator bit-equal.  (b) Phase 4a's small step with --fast-pad-stats
   (card against the CPU and float64, 4a's bounds).  The output step at
   the train cell timed in turns (ABCDDCBA) by default, with --remat
   (depthwise 84 and BatchNorm apply 238 a step: the recompute reuses
   the forward's statistics), with --fast-pad-stats and with the
   discriminator's s2d_convs=2, each with its peak memory and launches as
   predicted.  (c) The space-to-depth convs (ops/s2d.py) against
   F.conv2d at D's conv2 input and the stem's 2048x1024 batch-8 input;
   serving with stem_s2d at 2048x1024 batch 8, exact and decoder-int8,
   against the default model as phase 10d holds split_concat, timed in
   turns, 14 depthwise and 1 requant a call.  (d) The output step with
   masked batch padding (3 samples padded to 4, 128x128 float32, dropout
   on) against the unpadded step at tests/test_batch_pad.py's bounds,
   the generator bit-equal.  (e) train_adapt and train with --remat
   --fast-pad-stats for one epoch at the phase 5 cell, val_adapt and val
   on their best checkpoints, and cli.export of the first as a servable
   that records pad_stats False and serves ring-free; launches as
   predicted.
13. Print the kernels line (each kernel's launches, and by the paths
   that launched it, phase 11's runs under 'native', phase 14's under
   'spatial_*' and 'uneven_*', phase 15's under 'idle_*' and
   'infer_jpeg_*'; floats to 6 significant digits), the card's name and
   power limit, and as the last line {"ok": true, "device": {...}}.
14. The spatial arms (--spatial-shard, --eval-spatial-shard; ROADMAP
   A.8), run before phase 13's line.  (a) Each kernel of the spatial
   output step against its plain version at a rank's band plus halo of
   the train cell (all 8 samples, 256 of the 512 rows), float32 and
   bfloat16, at phase 2's tolerances: the depthwise forward, dx and dk
   on the band plus d rows a side, the split BatchNorm entries and dx on
   the band's rows with the global image's ring count, disc_conv1 on the
   band plus 2 rows a side.  (b) Two gloo ranks on the one card (1 data
   x 2 bands of rows), as phase 10b runs them: 10b's check at
   --spatial-shard 2 against 10b's one-process runs, at its bounds (after
   the first step a loss may also lie within 3x its float32 spread, one
   process on the card against the CPU, as G's leaves may), the
   launches as step_launches(world=2, spatial=2) predicts (ASPP's pooled
   BatchNorm on the one-card entries); then timed at the train cell
   (512x1024 batch 8 bf16): ms/step, launches, all-reduces and halo
   gathers a step with the halo elements, peak memory a rank.  (c) The
   same check at 4 ranks (2 data x 2 bands), which runs the batch-axis
   softmax over the 'data' group.  (d) --eval-spatial-shard over the 2
   ranks: a 2048x1024 validation batch of 2 in float32 against one
   process: loss rtol 1e-5 and labels > 0.999 equal
   (tests/test_spatial_shard.py's bounds), the confusion matrix equal
   but for labels at float32 near-ties of the one-process logits (top
   two within 1e-4; tests/test_torch_port_eval.py's rule: at 2048x1024
   float32 flips a few of 4M labels); the Trainer with
   --spatial-shard 2 --eval-spatial-shard --device-aug for one epoch
   (512x512 batch 4 bf16) and its validation: finite losses, mIoU in
   [0, 1] and the same on every rank, rank 0 alone writing the run
   directory.  (e) The output step at 2048x1024 global batch 4 bf16:
   peak memory a rank at --spatial-shard 2 against one process.
   Uneven bands and padding under a mesh (ROADMAP A.8, A.9), 513 rows
   over 2 ranks (bands of 272 and 241 at the source-only path's stride
   16, 288 and 225 at the output path's 32): (a) every kernel against
   its plain version at the short band (batch 4, float32 and bfloat16):
   the depthwise forward, dx and dk, all eight BatchNorm entries,
   disc_conv1; the zero-row calls of an empty band return their empty
   results with no launch (batch_norm_finish_apply finishes the
   statistics in one).  (f) The source-only step at 513x513 batch 4
   bf16 over 1 x 2 gloo ranks against one process, at (b)'s bounds with
   the bf16 spread (one process in bf16 against float32 on the card).
   (g) --eval-spatial-shard at 513x513 batch 2 float32 against one
   process, at (d)'s bounds.  (h) The padded output step at world 2 (4
   real samples padded to 8, the second rank padding only) at 10b's
   check against one process's padded step, at 10b's bounds; the second
   rank launches no BatchNorm sums.
15. The devices JAX idles (ROADMAP A.10) and the rest of the data path
   (A.4), after phase 14.  (a) Three gloo ranks on the one card at 10b's
   check (global batch 4: JAX's count 2): ranks 0-1 against 10b's one
   process at its bounds, launches as step_launches(world=2) predicts,
   249 all-reduces a step; rank 2 issues no collective after set-up,
   launches nothing, allocates nothing (the allocator's peak 0 bytes)
   and exits 0; the output step at the train cell timed on ranks 0-1
   beside 10b's world of 2.  (b) The Trainer with --num-devices 2 in
   that world of 3 (one epoch and its validation, 128x128 batch 4
   float32): the initial validation against one process, best_pred the
   same on both ranks, rank 0 alone writing the run directory.  (c) Four
   ranks at --spatial-shard 2 and batch 3 (JAX: 1 data row x 2 bands):
   10b's check at that batch against one process on the card and the
   CPU, launches as predicted; ranks 2-3 silent as in (a).  (d) The host
   library built here: every JPEG fixture
   (s2r_tpu_torch/data/jpeg_fixtures) to the SHA-256 of PIL's decode;
   RandomRotate, 16-bit gray and gamma-chunk gray to REST_DIGEST (PIL's
   and libpng's results, tests/test_torch_port_data_rest.py); the
   2048x1024 JPEG's decode timed; cli.infer over .jpg frames with phase
   5's final state served exact and decoder-int8 at 2048x1024 batch 8,
   labels equal to make_serving_fn on the same batch, launches as
   predicted, ms/image.

Without a CUDA device, or outside a checkout holding s2r_tpu_torch, it exits
non-zero and prints no result.  Float32 convs run with TF32 off.  It writes
the kernel build directory, and phase 5's run root in the temporary
directory (and phase 6d's, 7's, 8's, 9's, 10's, 11's, 12e's and 14d's, the
checkpoints phases 5 and 6d hand to phases 8 and 10 and the frames phase 8
hands to phases 9 and 10), which it removes.
"""

import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# Published dense peaks of the H100 SXM by operand type: bfloat16 on the
# tensor cores, float32 outside them (TF32 is off here).
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
FULL_HW = (1024, 2048)
BATCH = 8
CHECK_HW = (513, 513)
TRAIN_HW = (512, 1024)      # bench.py's train crop
TRAIN_CHECK_HW = (128, 128)
# phase 5: the train_adapt driver (8 steps and 4 validation batches an
# epoch).  Phases 2a-2e also hold the kernels at the shapes it gives them:
# its crop at its batch (the step and validation), and the image-logging
# forward on the first ADAPT_LOG_BATCH images of a batch (train/trainer.py
# _log_train_images).
ADAPT_HW, ADAPT_BATCH, ADAPT_LOG_BATCH = (512, 512), 8, 3
ADAPT_ARGV = ["--dataset", "synthetic", "--device-aug",
              "--crop-size", str(ADAPT_HW[0]), "--base-size", str(ADAPT_HW[0]),
              "--batch-size", str(ADAPT_BATCH), "--epochs", "2",
              "--precision", "bf16", "--workers", "4"]
LEAF_BOUND = 3e-2           # phases 4a and 6a, per gradient leaf (float32)
# phase 6: bench.py's source-only cell (config 2; the feature cell, config
# 3, is TRAIN_HW at BATCH), and the train driver (feature_adapt), one epoch
# of 8 steps and 4 validation batches, then a resumed one
SOURCE_HW, SOURCE_BATCH = (513, 513), 4
TRAIN_ARGV = ["--dataset", "synthetic", "--device-aug",
              "--crop-size", str(ADAPT_HW[0]), "--base-size", str(ADAPT_HW[0]),
              "--batch-size", str(ADAPT_BATCH), "--epochs", "1",
              "--precision", "bf16", "--workers", "4"]
_BN = ("batch_norm_stats", "batch_norm_apply", "batch_norm_grad_sums",
       "batch_norm_dx")
# the split entries of synchronized BatchNorm (phase 10), in place of
# stats and apply (sums, finish_apply) and grad_sums (grad_sums_local,
# grad_finish) at a world of more than one process
_BN_SPLIT = ("batch_norm_sums", "batch_norm_finish_apply",
             "batch_norm_grad_sums_local", "batch_norm_grad_finish")
# (stride-1 depthwise convs, BatchNorms of G) in one forward of each
# backbone at output stride 16: MobileNetV2's 14 inverted residuals'
# depthwise convs; Xception's separable convs at stride 1 (1 in each of
# blocks 1-3, 48 in the middle flow, 2 in block 20 and the exit flow's 3).
# G's BatchNorms: the backbone's, ASPP's 6 and the decoder's 3.  Phase 9
# holds each model's modules (layer_counts) to these.
LAYERS = {"mobilenet": (14, 60), "resnet101": (0, 113), "resnet50": (0, 62),
          "xception": (56, 133), "drn": (0, 65)}


def step_launches(method, backbone="mobilenet", world=1, remat=False,
                  spatial=1):
    """Each kernel's launches in one step of `method` on `backbone`: the
    depthwise forward and dx of the source and target forwards and their
    dk, the four BatchNorm entries of each G forward (the feature
    methods' domain classifier adds 2 BatchNorms a forward, and its target
    logits feed no loss, so the decoder's 3 BatchNorms of the target
    forward take no backward), the discriminator's first conv on 3
    softmax maps (output_adapt).  At `world` > 1 (a rank's step) the
    split entries replace stats and apply (sums and finish_apply; apply
    stays only in a remat recompute) and grad_sums (grad_sums_local and
    grad_finish).  With `remat` the backward
    recomputes the wrapped regions of each G forward that takes one (the
    feature step's target decoder takes none): each wrapped BatchNorm
    applies again on its forward's statistics (MobileNetV2's all but the
    stem's; ASPP's 6 and the decoder's 3 on every backbone) and each
    wrapped depthwise conv runs again (MobileNetV2's, all in blocks).
    Under --spatial-shard `spatial` == `world` (one data row) ASPP's
    pooled branch, the same on every rank, takes its BatchNorm on the
    one-card entries (no other rank holds other samples); with more data
    rows it is synchronized over them, as the others are."""
    dw, bn = LAYERS[backbone]
    out = {"depthwise_conv3x3": 4 * dw, "requant_s32_to_s8": 0,
           "depthwise_dk": 2 * dw, **dict.fromkeys(_BN, 2 * bn),
           "disc_conv1": 3, **dict.fromkeys(_BN_SPLIT, 0)}
    if method == "feature_adapt":
        out.update({**dict.fromkeys(_BN[:2], 2 * bn + 4),
                    **dict.fromkeys(_BN[2:], 2 * bn + 1), "disc_conv1": 0})
    elif method == "source_only":
        out.update({"depthwise_conv3x3": 2 * dw, "depthwise_dk": dw,
                    **dict.fromkeys(_BN, bn), "disc_conv1": 0})
    if remat:
        mobilenet = backbone == "mobilenet"
        fwd = 1 if method == "source_only" else 2
        out["batch_norm_apply"] += (fwd * (bn - 1 if mobilenet else 9)
                                    - 3 * (method == "feature_adapt"))
        out["depthwise_conv3x3"] += fwd * dw * mobilenet
    if world > 1:
        fwd, bwd = out["batch_norm_stats"], out["batch_norm_grad_sums"]
        out.update(batch_norm_stats=0, batch_norm_sums=fwd,
                   batch_norm_finish_apply=fwd,
                   batch_norm_apply=out["batch_norm_apply"] - fwd,
                   batch_norm_grad_sums=0, batch_norm_grad_sums_local=bwd,
                   batch_norm_grad_finish=bwd)
        if spatial == world:
            pooled = 1 if method == "source_only" else 2
            out.update(batch_norm_stats=pooled, batch_norm_sums=fwd - pooled,
                       batch_norm_finish_apply=fwd - pooled,
                       batch_norm_apply=out["batch_norm_apply"] + pooled,
                       batch_norm_grad_sums=pooled,
                       batch_norm_grad_sums_local=bwd - pooled,
                       batch_norm_grad_finish=bwd - pooled)
    return out

# phase 7: the real datasets, from full-size PNG fixtures (tools/fixtures.py:
# 16 GTA5-sized sources with P-mode labels, 16 Cityscapes-sized targets, 8
# val pairs, 8 test frames), the drivers at the phase 5 cell.  GTA5's
# 70/20/10 split of 16 frames leaves 11 / 3 / 2: one train step, and val and
# test at batches of 3 and REAL_TEST_BATCH (--no-val-drop-last).
REAL_FRAMES = dict(n_gta=16, n_city=16, n_val=8, n_test=8)
REAL_TEST_BATCH = 2
REAL_ARGV = ["--crop-size", str(ADAPT_HW[0]), "--base-size", str(ADAPT_HW[0]),
             "--batch-size", str(ADAPT_BATCH), "--epochs", "1",
             "--precision", "bf16", "--workers", "4"]
# phase 8: checkpoints in, frames out.  The frames: 16 Cityscapes-sized
# and 8 GTA5-sized PNGs (tools/fixtures.py), three servable batches of
# BATCH at FULL_HW; the GTA5 frames take the host resize.
INFER_FRAMES = dict(n_gta=8, n_city=16, n_val=0, n_test=0)
# phase 9: the other backbones at full width (os 16; DRN's ASPP at 8):
# served at CHECK_HW against the CPU and at FULL_HW batch BATCH, the
# output step at TRAIN_HW batch BATCH, the small float32 step against the
# CPU and float64 at BACKBONE_CHECK_HW, and train_adapt on Xception at the
# phase 5 cell for one epoch
SERVE_BACKBONES = ("resnet101", "xception", "drn")
STEP_BACKBONES = ("resnet101", "resnet50", "xception", "drn")
CHECK_BACKBONES = ("xception", "resnet50")
BACKBONE_CHECK_HW = (64, 64)
DEV = "cuda"


class Failed(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def significant(obj, digits=6):
    """`obj` with every float rounded to `digits` significant digits (the
    kernels line stays well inside the 24,000 bytes a run's tail keeps)."""
    if isinstance(obj, float):
        return float(f"{obj:.{digits}g}")
    if isinstance(obj, dict):
        return {k: significant(v, digits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [significant(v, digits) for v in obj]
    return obj


def bound_ms(nbytes, flops, dtype):
    """The least time for moving `nbytes` and doing `flops` on operands of
    `dtype`, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dw_shapes(hw, block_plan):
    """(C, H, W, dilation) of each stride-1 depthwise conv of one forward."""
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1  # the 3x3/s2 stem
    shapes = []
    for in_ch, _, stride, dilation, t in block_plan(16):
        if stride == 1:
            shapes.append((in_ch * t, h, w, dilation))
        else:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return shapes


def dw_check(dw, x, k, d):
    """Kernel against plain version; returns max_abs_err or raises."""
    got = dw.depthwise_conv3x3(x, k, d)
    ref = dw.depthwise_conv3x3_plain(x, k, d)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().clamp(min=1.0)
    if x.dtype == torch.float32:
        ok = float(diff.max()) <= 1e-5 * float(scale.max())
    else:
        ok = bool((diff <= 1e-2 * scale).all())
    err = float(diff.max())
    require(ok, f"depthwise {tuple(x.shape)} d={d} {x.dtype}: max_abs_err {err}")
    return err


def randn(shape, dtype, gen, offset=0):
    """A contiguous tensor whose data starts `offset` elements into its
    buffer (offset 1 breaks 16-byte alignment)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, device=DEV, generator=gen).to(dtype)
    return buf[offset:].view(shape)


# Edge shapes (N, C, H, W, d) of the depthwise tile sweeps, phases 2a and
# 2c (the layouts each takes: tests/test_torch_port_depthwise_plan.py).
EDGE_SHAPES = [(2, 64, 5, 3, 1), (1, 16, 1, 1, 1), (1, 16, 1, 1, 3),
               (1, 24, 13, 11, 2), (1, 3, 5, 5, 2), (1, 960, 33, 33, 2),
               (2, 40, 9, 37, 4), (1, 256, 45, 90, 40), (2, 48, 12, 70, 2),
               (1, 144, 40, 200, 2), (2500, 16, 2, 3, 1)]


def slower(per_shape):
    """How many shapes of a per_shape list the kernel loses to its library
    call at."""
    return sum(r["ms"] > r["library_ms"] for r in per_shape)


def dk_check(dw, x, g, d):
    """dk kernel against its plain version (max|diff| <= 1e-4 * max|ref|)
    and bit-identical on a repeated call; returns (dk, ref, rel err)."""
    dk = dw.depthwise_dk(x, g, d)
    ref = dw.depthwise_dk_plain(x, g, d)
    require(torch.equal(dk, dw.depthwise_dk(x, g, d)),
            f"depthwise_dk {tuple(x.shape)} d={d} {x.dtype}: a repeated "
            "call differs")
    torch.cuda.synchronize()
    err = rel_err(dk, ref)
    require(dk.dtype == torch.float32 and err <= 1e-4,
            f"depthwise_dk {tuple(x.shape)} d={d} {x.dtype}: rel err {err}")
    return dk, ref, err


def check_depthwise(dw):
    """Phase 2a.  Returns the kernels-line entry for one batch-8 2048x1024
    bfloat16 forward (14 launches)."""
    import torch.nn.functional as F

    from s2r_tpu_torch.models.mobilenet import block_plan

    main = dw_shapes(FULL_HW, block_plan)
    require(len(main) == 14, f"expected 14 stride-1 depthwise convs, {main}")
    cases = [(BATCH,) + s for s in sorted(set(main))]
    cases += [(1,) + s for s in sorted(set(dw_shapes(CHECK_HW, block_plan)))]
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    per_shape = {}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    log("[depthwise] N C H W d dtype: max_abs_err | kernel_ms plain_ms "
        "library_ms bound_ms")
    for n, c, h, w, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            err = dw_check(dw, x, k, d)
            worst[dtype] = max(worst[dtype], err)
            wt = k.permute(2, 0, 1).unsqueeze(1)
            xv = x.permute(0, 3, 1, 2)
            kern = cuda_ms(lambda: dw.depthwise_conv3x3(x, k, d))
            plain = cuda_ms(lambda: dw.depthwise_conv3x3_plain(x, k, d))
            lib = cuda_ms(lambda: F.conv2d(xv, wt, padding=d, dilation=d,
                                           groups=c))
            isz = x.element_size()
            bnd, by = bound_ms(2 * x.numel() * isz + k.numel() * isz,
                               18 * x.numel(), dtype)
            per_shape[(n, c, h, w, d, dtype)] = (kern, plain, lib, bnd, by, err)
            log(f"[depthwise] {n} {c} {h} {w} {d} {str(dtype)[6:]}: {err:.3g} "
                f"| {kern:.4f} {plain:.4f} {lib:.4f} {bnd:.4f}")
            del x, k, xv
    # Edge shapes of the tile sweep (N, C, H, W, d, element offset): W and
    # H under one tile, H = W = 1, odd H at d = 2 (ROADMAP C.1's shapes),
    # d = 4, a halo wider than the tile (d = 40), tile boundaries inside a
    # dilation-2 halo, blocks that stream several images shorter than the
    # rows staged ahead (N = 2500), and the one-channel path: C off the
    # vector (7, 20) and an unaligned (but contiguous) input.
    edges = [(n, c, h, w, d, 0) for n, c, h, w, d in EDGE_SHAPES]
    edges += [(2, 7, 33, 65, 2, 0), (2, 20, 17, 19, 1, 0), (1, 24, 17, 19, 2, 1),
              (2, 7, 9, 37, 4, 1)]
    # the train_adapt driver's forwards: the step and validation at its
    # batch, image logging at ADAPT_LOG_BATCH
    # (phase 7's GTA5 test split: REAL_TEST_BATCH)
    adapt = [(n, c, h, w, d, 0)
             for n in (ADAPT_BATCH, ADAPT_LOG_BATCH, REAL_TEST_BATCH)
             for c, h, w, d in sorted(set(dw_shapes(ADAPT_HW, block_plan)))]
    for n, c, h, w, d, offset in edges + adapt:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen, offset)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            err = dw_check(dw, x, k, d)
            worst[dtype] = max(worst[dtype], err)
    log(f"[depthwise] {len(edges)} edge shapes (tiles, halos, C=7, C=20, "
        f"unaligned input) and {len(adapt)} driver shapes "
        f"({ADAPT_HW[1]}x{ADAPT_HW[0]}, batch {ADAPT_BATCH}, "
        f"{ADAPT_LOG_BATCH} and {REAL_TEST_BATCH}) pass")
    rows = [per_shape[(BATCH,) + s + (torch.bfloat16,)] for s in main]
    serve = [{"C": c, "H": h, "W": w, "d": d, "launches": main.count((c, h, w, d)),
              "ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][0],
              "library_ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][2],
              "bound_ms": per_shape[(BATCH, c, h, w, d, torch.bfloat16)][3]}
             for c, h, w, d in sorted(set(main))]
    entry = {"name": "depthwise_conv3x3", "route": "cuda",
             "source": "s2r_tpu_torch/csrc/depthwise.cu",
             "replaces": "s2r_tpu/ops/pallas/depthwise.py:155",
             "launches": None,
             "max_abs_err": max(r[5] for r in rows),
             "ms": sum(r[0] for r in rows),
             "plain_ms": sum(r[1] for r in rows),
             "bound_ms": sum(r[3] for r in rows),
             "bound_by": "bytes" if all(r[4] == "bytes" for r in rows)
             else "operations",
             "library_ms": sum(r[2] for r in rows),
             "ms_covers": "one 2048x1024 batch-8 bf16 serving forward: 14 "
                          "launches; by_path.train_step: one train step; "
                          "per_shape: ms, library_ms and bound_ms a launch",
             "per_shape": {"serve": serve},
             "slower_than_library": {"serve": slower(serve)}}
    log(f"[depthwise] all checks passed; worst max_abs_err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"2048x1024 batch-8 bf16 forward (14 launches): kernel "
        f"{entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, cuDNN "
        f"{entry['library_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms; "
        f"slower than cuDNN at {entry['slower_than_library']['serve']} of "
        f"{len(serve)} shapes")
    return entry


def requant_inputs(shape, gen):
    """Accumulators in the int8 convs' range, with channels that land on
    exact .5 ties (m = 0.5 on odd x; m = 1, b = 0.5) and past both clamp
    ends."""
    c = shape[-1]
    x = torch.randint(-2 ** 20, 2 ** 20, shape, device=DEV, generator=gen,
                      dtype=torch.int32)
    m = torch.rand(c, device=DEV, generator=gen) * 1e-4
    b = torch.randn(c, device=DEV, generator=gen)
    q = c // 4
    x[..., :q] = torch.randint(-41, 300, shape[:-1] + (q,), device=DEV,
                               generator=gen, dtype=torch.int32)
    m[:q], b[:q] = 0.5, 0.0
    x[..., q:2 * q] = torch.randint(-20, 150, shape[:-1] + (q,),
                                    device=DEV, generator=gen,
                                    dtype=torch.int32)
    m[q:2 * q], b[q:2 * q] = 1.0, 0.5
    return x, m, b


def check_requant(rq):
    """Phase 2b.  Returns the kernels-line entry at the batch-8 2048x1024
    decoder shape (one launch per int8 forward)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    main = (BATCH, FULL_HW[0] // 4, FULL_HW[1] // 4, 256)
    entry = None
    for shape in (main, (3, 65, 129, 200), (2, 9, 11, 30)):  # C=30: scalar
        x, m, b = requant_inputs(shape, gen)
        got = rq.requant_s32_to_s8(x, m, b)
        ref = rq.requant_plain(x, m, b)
        torch.cuda.synchronize()
        require(got.dtype == torch.int8 and torch.equal(got, ref),
                f"requant {shape}: not bit-exact, "
                f"{int((got != ref).sum())} elements differ")
        ties = int((x[..., :shape[-1] // 4] % 2 != 0).sum())
        kern = cuda_ms(lambda: rq.requant_s32_to_s8(x, m, b))
        plain = cuda_ms(lambda: rq.requant_plain(x, m, b))
        # int32 in, int8 out; the arithmetic is float32
        bnd, by = bound_ms(5 * x.numel() + 8 * shape[-1], 2 * x.numel(),
                           torch.float32)
        log(f"[requant] {shape}: bit-exact ({ties} exact .5 ties) | kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms")
        if shape == main:
            entry = {"name": "requant_s32_to_s8", "route": "cuda",
                     "source": "s2r_tpu_torch/csrc/requant.cu",
                     "replaces": "s2r_tpu/ops/pallas/requant.py:69",
                     "launches": None,
                     "max_abs_err": float((got.int() - ref.int()).abs().max()),
                     "ms": kern,
                     "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                     "library_ms": None}
        del x, m, b, got, ref
    return entry


_WARM = {}  # backbone -> its BatchNorm statistics, warmed on the CPU


def build_model(dtype, device, backbone="mobilenet"):
    """DeepLab on `backbone` from seed SEED: MobileNetV2 with its BatchNorm
    statistics perturbed; the other backbones with the statistics of a
    seeded 2x3x129x129 batch (warm_batchnorm, on the CPU in float32, the
    same for every copy)."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.tools.step_conditioning import (perturb_batchnorm,
                                                       warm_batchnorm)

    def make(dtype, device):
        return DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                       device=device, backbone=backbone,
                       generator=torch.Generator().manual_seed(SEED))

    if backbone == "mobilenet":
        model = make(dtype, device)
        perturb_batchnorm(model, SEED + 1)
        return model
    if backbone not in _WARM:
        cpu = make("f32", "cpu")
        images = np.random.RandomState(SEED + 5).randn(2, 3, 129, 129)
        warm_batchnorm(cpu, torch.from_numpy(images.astype(np.float32)))
        _WARM[backbone] = cpu.state_dict()
        del cpu
    model = make(dtype, "cpu")
    model.load_state_dict(_WARM[backbone], strict=True)
    return model.to(device)


def layer_counts(model):
    """(stride-1 depthwise convs, train-mode BatchNorms) of one forward of
    `model`, counted from its modules."""
    from s2r_tpu_torch.models.layers import BatchNorm, Conv2d

    mods = list(model.modules())
    return (sum(isinstance(m, Conv2d) and m.dw_stride1_3x3 for m in mods),
            sum(isinstance(m, BatchNorm) for m in mods))


def reset(counted):
    for fn in counted:
        fn.launches = 0


def serve_check_513(dw, rq, backbone="mobilenet"):
    """Phase 3a (and 9b): 513x513 batch 1 float32, card against CPU."""
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import make_serving_fn

    gpu = build_model("f32", DEV, backbone)
    cpu = build_model("f32", "cpu", backbone)
    sd_g, sd_c = gpu.state_dict(), cpu.state_dict()
    require(all(torch.equal(sd_g[k].cpu(), sd_c[k]) for k in sd_c),
            "card and CPU models hold different weights")
    tag = "serve 513" if backbone == "mobilenet" else f"9b {backbone} 513"
    rs = np.random.RandomState(SEED)
    image = rs.randn(1, *CHECK_HW, 3).astype(np.float32)
    reset((dw.depthwise_conv3x3, rq.requant_s32_to_s8))
    got = make_serving_fn(gpu, output="logits")(image)
    torch.cuda.synchronize()
    n_dw = LAYERS[backbone][0]
    require(dw.depthwise_conv3x3.launches == n_dw,
            f"{tag} forward: {dw.depthwise_conv3x3.launches} depthwise "
            f"launches, expected {n_dw}")
    got = got.cpu()
    ref = make_serving_fn(cpu, output="logits")(image)
    require(got.shape == ref.shape == (1, *CHECK_HW, 19)
            and bool(torch.isfinite(got).all()), "513 logits shape/finite")
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"[{tag}] float32 logits card vs CPU: max_abs_err {err:.3g} "
        f"(tol {tol:.3g}, max|logit| {float(ref.abs().max()):.3g}), "
        f"label agreement {100 * agree:.4f}%")
    require(err <= tol and agree >= 0.999,
            f"{tag} logits disagree with the CPU")

    calib = [rs.randn(1, *CHECK_HW, 3).astype(np.float32) for _ in range(2)]
    scales = calibrate_decoder_int8(cpu, calib)
    scales_g = calibrate_decoder_int8(gpu, calib)
    rel = max(abs(scales_g[k] - scales[k]) / scales[k] for k in scales)
    reset((dw.depthwise_conv3x3, rq.requant_s32_to_s8))
    lab_g = make_serving_fn(gpu, quant="decoder_int8",
                            quant_scales=scales)(image)
    torch.cuda.synchronize()
    require(rq.requant_s32_to_s8.launches == 1,
            f"{tag} int8: requant not run")
    lab_c = make_serving_fn(cpu, quant="decoder_int8",
                            quant_scales=scales)(image)
    agree8 = float((lab_g.cpu() == lab_c).float().mean())
    log(f"[{tag}] decoder-int8 labels card vs CPU: agreement "
        f"{100 * agree8:.4f}%; calibration scales card vs CPU rel diff "
        f"{rel:.3g}")
    require(agree8 >= 0.99 and rel <= 1e-3,
            f"{tag} int8 disagrees with the CPU")
    del gpu, cpu


def serve_full(counted, backbone="mobilenet", timed=5, warmup=2,
               bn_share=False):
    """Phase 3b (and 9b): rgb8 2048x1024 batch 8 to labels, bf16, exact and
    int8, `warmup` and `timed` calls of each.  Returns ({mode: ms/image},
    the launches of one call of each, peak GiB, and with `bn_share` the
    exact call's eval-BatchNorm share, else None)."""
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import make_serving_fn
    from s2r_tpu_torch.tools.profile_serving import eval_bn_share

    model = build_model("bf16", DEV, backbone)
    tag = ("serve 2048x1024" if backbone == "mobilenet"
           else f"9b {backbone} 2048x1024")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)

    def rgb8():
        return torch.randint(0, 256, (BATCH, *FULL_HW, 3), device=DEV,
                             generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(model, [rgb8(), rgb8()], input="rgb8")
    log(f"[{tag}] calibration scales {scales}")
    images = rgb8()
    fns = {"exact": make_serving_fn(model, input="rgb8"),
           "decoder_int8": make_serving_fn(model, input="rgb8",
                                           quant="decoder_int8",
                                           quant_scales=scales)}
    labels = {}
    for mode, fn in fns.items():
        out = fn(images)
        torch.cuda.synchronize()
        require(out.shape == (BATCH, *FULL_HW) and out.dtype == torch.int32
                and int(out.min()) >= 0 and int(out.max()) < 19,
                f"{mode} labels: {tuple(out.shape)} {out.dtype}")
        labels[mode] = out
    agree = float((labels["exact"] == labels["decoder_int8"]).float().mean())
    log(f"[{tag}] int8 vs exact label agreement {100 * agree:.3f}% "
        "(random weights; informational)")
    del labels

    ms = {}
    torch.cuda.reset_peak_memory_stats()
    for mode, fn in fns.items():
        for _ in range(warmup):
            fn(images)
        runs = []
        for _ in range(timed):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(images)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / BATCH)
        ms[mode] = statistics.median(runs)
        log(f"[{tag}] {mode}: {ms[mode]:.3f} ms/image (median of "
            f"{timed} batch-{BATCH} calls: "
            f"{', '.join(f'{r:.3f}' for r in runs)})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] peak device memory {peak:.2f} GiB")
    share = None
    if bn_share:
        with_bn, without, share = eval_bn_share(fns["exact"], images)
        log(f"[{tag}] eval BatchNorm: the exact call {with_bn / BATCH:.3f} "
            f"ms/image, {without / BATCH:.3f} with every BatchNorm the "
            f"identity: share {share:.3f} (CUDA events, 3 calls each)")

    # The main-path run that the kernels line counts: one call per mode.
    reset(counted)
    for fn in fns.values():
        fn(images)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"[{tag}] launches in one exact + one int8 call: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update(depthwise_conv3x3=2 * LAYERS[backbone][0],
                requant_s32_to_s8=1)
    require(launches == want, f"{tag}: launches {launches}, expected {want}")
    del model, fns, images
    return ms, launches, peak, share


def rel_err(got, ref):
    """max|got - ref| / max|ref| in float64."""
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def check_depthwise_bwd(dw):
    """Phase 2c: the depthwise VJP at the train step's 14 layer shapes.  dx
    is the forward kernel on the cotangent with the taps flipped; dk is the
    dk kernel.  Returns (the depthwise_dk entry for one train step: 28
    launches, 2 per layer; the depthwise kernel's times on the train step:
    28 forward and 28 dx launches)."""
    import torch.nn.functional as F

    from s2r_tpu_torch.models.mobilenet import block_plan

    main = dw_shapes(TRAIN_HW, block_plan)
    require(len(main) == 14, f"expected 14 stride-1 depthwise convs, {main}")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    per_shape = {}
    log("[depthwise bwd] N C H W d dtype: dx err, dk rel err | dk kernel_ms "
        "plain_ms library_ms bound_ms | fwd+dx kernel_ms plain_ms "
        "library_ms bound_ms")
    for c, h, w, d in sorted(set(main)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((BATCH, h, w, c), dtype, gen)
            g = randn((BATCH, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            kf = k.flip((0, 1)).contiguous()
            dx_err = dw_check(dw, g, kf, d)
            dk, dk_ref, dk_err = dk_check(dw, x, g, d)
            xv, gv = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            kern = cuda_ms(lambda: dw.depthwise_dk(x, g, d))
            plain = cuda_ms(lambda: dw.depthwise_dk_plain(x, g, d))
            lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xv, (c, 1, 3, 3), gv, padding=d, dilation=d, groups=c))
            # forward on x and dx on g: the kernel's two launches a layer
            wt = k.permute(2, 0, 1).unsqueeze(1)
            wtf = kf.permute(2, 0, 1).unsqueeze(1)
            fx = [cuda_ms(lambda: dw.depthwise_conv3x3(x, k, d))
                  + cuda_ms(lambda: dw.depthwise_conv3x3(g, kf, d)),
                  cuda_ms(lambda: dw.depthwise_conv3x3_plain(x, k, d))
                  + cuda_ms(lambda: dw.depthwise_conv3x3_plain(g, kf, d)),
                  cuda_ms(lambda: F.conv2d(xv, wt, padding=d, dilation=d,
                                           groups=c))
                  + cuda_ms(lambda: F.conv2d(gv, wtf, padding=d, dilation=d,
                                             groups=c))]
            isz = x.element_size()
            bnd, by = bound_ms(2 * x.numel() * isz + 9 * c * 4,
                               18 * x.numel(), dtype)
            fx_bnd, fx_by = bound_ms(2 * (2 * x.numel() * isz + 9 * c * isz),
                                     2 * 18 * x.numel(), dtype)
            per_shape[(c, h, w, d, dtype)] = (kern, plain, lib, bnd, by,
                                              float((dk - dk_ref).abs().max()),
                                              fx, fx_bnd, fx_by, dx_err)
            log(f"[depthwise bwd] {BATCH} {c} {h} {w} {d} {str(dtype)[6:]}: "
                f"{dx_err:.3g}, {dk_err:.3g} | {kern:.4f} {plain:.4f} "
                f"{lib:.4f} {bnd:.4f} | {fx[0]:.4f} {fx[1]:.4f} {fx[2]:.4f} "
                f"{fx_bnd:.4f}")
            del x, g, xv, gv
    # the edge shapes of phase 2a, dk and dx, and dk on the one-channel
    # path (C off the vector, an unaligned input)
    edges = [(n, c, h, w, d, 0) for n, c, h, w, d in EDGE_SHAPES]
    edges += [(2, 7, 33, 65, 2, 0), (1, 24, 17, 19, 2, 1), (2, 7, 9, 37, 4, 1)]
    # the train_adapt driver's step
    adapt = [(ADAPT_BATCH, c, h, w, d, 0)
             for c, h, w, d in sorted(set(dw_shapes(ADAPT_HW, block_plan)))]
    for n, c, h, w, d, offset in edges + adapt:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dtype, gen, offset)
            g = randn((n, h, w, c), dtype, gen, offset)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            dw_check(dw, g, k.flip((0, 1)).contiguous(), d)
            dk_check(dw, x, g, d)
    log(f"[depthwise bwd] {len(edges)} edge shapes and {len(adapt)} "
        f"train_adapt shapes ({ADAPT_HW[1]}x{ADAPT_HW[0]} batch "
        f"{ADAPT_BATCH}) pass (dx, and dk bit-identical on a repeated call)")
    rows = [per_shape[s + (torch.bfloat16,)] for s in main]
    # per launch: dk one a layer and image set; forward + dx two
    dk_rows, fx_rows = [], []
    for c, h, w, d in sorted(set(main)):
        r = per_shape[(c, h, w, d, torch.bfloat16)]
        mult = 2 * main.count((c, h, w, d))  # src and tgt
        dk_rows.append({"C": c, "H": h, "W": w, "d": d, "launches": mult,
                        "ms": r[0], "library_ms": r[2], "bound_ms": r[3]})
        fx_rows.append({"C": c, "H": h, "W": w, "d": d, "launches": 2 * mult,
                        "ms": r[6][0] / 2, "library_ms": r[6][2] / 2,
                        "bound_ms": r[7] / 2})
    entry = {"name": "depthwise_dk", "route": "cuda",
             "source": "s2r_tpu_torch/csrc/depthwise.cu",
             "replaces": "s2r_tpu/ops/pallas/depthwise.py:165",
             "launches": None,
             "max_abs_err": max(r[5] for r in rows),
             "ms": 2 * sum(r[0] for r in rows),
             "plain_ms": 2 * sum(r[1] for r in rows),
             "bound_ms": 2 * sum(r[3] for r in rows),
             "bound_by": "bytes" if all(r[4] == "bytes" for r in rows)
             else "operations",
             "library_ms": 2 * sum(r[2] for r in rows),
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 14 layers "
                          "x (src, tgt) = 28 launches; per_shape: ms, "
                          "library_ms and bound_ms a launch",
             "per_shape": {"train_step": dk_rows},
             "slower_than_library": {"train_step": slower(dk_rows)}}
    train = {"ms": 2 * sum(r[6][0] for r in rows),
             "plain_ms": 2 * sum(r[6][1] for r in rows),
             "library_ms": 2 * sum(r[6][2] for r in rows),
             "bound_ms": 2 * sum(r[7] for r in rows),
             "bound_by": "bytes" if all(r[8] == "bytes" for r in rows)
             else "operations",
             "max_abs_err": max(r[9] for r in rows),
             "ms_covers": "one 512x1024 batch-8 bf16 train step: 14 layers "
                          "x (src, tgt) x (forward, dx) = 56 launches",
             "per_shape": fx_rows, "slower_than_library": slower(fx_rows)}
    log(f"[depthwise bwd] all checks passed; one train step (bf16): dk (28 "
        f"launches) kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, cuDNN weight grad "
        f"{entry['library_ms']:.3f}, bound {entry['bound_ms']:.3f}; forward "
        f"+ dx (56 launches) kernel {train['ms']:.3f} ms, plain "
        f"{train['plain_ms']:.3f}, cuDNN {train['library_ms']:.3f}, bound "
        f"{train['bound_ms']:.3f}; slower than cuDNN at "
        f"{entry['slower_than_library']['train_step']} (dk) and "
        f"{train['slower_than_library']} (forward + dx) of {len(dk_rows)} "
        "shapes")
    return entry, train


def layer_shapes(hw, backbone="mobilenet", output_stride=16):
    """(dw, bn) of one train-mode forward of `backbone` at `hw`, in call
    order, read by hooks on a throwaway model: dw the (C, H, W, d) of each
    stride-1 depthwise conv, bn the (C, H, W) of each BatchNorm input."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.models.layers import BatchNorm, Conv2d

    model = DeepLab(dtype="bf16", device=DEV, backbone=backbone,
                    output_stride=output_stride,
                    generator=torch.Generator().manual_seed(SEED))
    model.train()
    dw, bn = [], []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: bn.append(tuple(args[0].shape[1:])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    hooks += [m.register_forward_pre_hook(
        lambda mod, args: dw.append(tuple(args[0].shape[1:])
                                    + (mod.dilation[0],)))
        for m in model.modules()
        if isinstance(m, Conv2d) and m.dw_stride1_3x3]
    with torch.no_grad():
        model(torch.zeros((1, 3) + tuple(hw), device=DEV))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return dw, bn


def bn_input_shapes(hw, backbone="mobilenet"):
    """(C, H, W) of every train-mode BatchNorm input of one forward at
    `hw`, in call order."""
    return layer_shapes(hw, backbone)[1]


def bn_rel(got, ref):
    """max|got - ref| / max|ref| per row of [rows, C] results, in float64."""
    got, ref = got.double(), ref.double()
    return [float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
            for g, r in zip(got.reshape(len(got), -1), ref.reshape(len(ref), -1))]


def check_batchnorm(bn):
    """Phase 2d: the four BatchNorm entries at every train-mode BatchNorm
    input shape of one 512x1024 batch-8 forward and of the train_adapt
    driver's step, bfloat16 and float32: the statistics (with the running
    statistics), y, the backward sums (with a cotangent of shift) and dx,
    each against its plain version on the same inputs, and each
    bit-identical on a repeated call.  Times (bf16, 512x1024 batch 8): each
    entry, its plain version and its one-call PyTorch counterpart; the
    composite (all four, as one BatchNorm's forward and backward) against
    native_batch_norm + native_batch_norm_backward.  Returns the four
    entries for one train step (60 BNs x (src, tgt) = 120 calls each) and
    the composite's row."""
    from collections import Counter

    shapes = bn_input_shapes(TRAIN_HW)
    adapt = sorted(set(bn_input_shapes(ADAPT_HW)))
    source = sorted(set(bn_input_shapes(SOURCE_HW)))
    require(len(shapes) == 60, f"expected 60 BatchNorms, got {len(shapes)}")
    # phase 9a: each other backbone's BatchNorm inputs at the train cell
    others = {}
    for b in STEP_BACKBONES:
        bs = bn_input_shapes(TRAIN_HW, b)
        require(len(bs) == LAYERS[b][1],
                f"{b}: {len(bs)} BatchNorms, expected {LAYERS[b][1]}")
        others.update(dict.fromkeys(bs))
    counts = Counter(shapes)
    # (batch, (C, H, W), count in one forward, timed, ring width)
    cases = [(BATCH, s, mult, True, 1) for s, mult in sorted(counts.items())]
    cases += [(ADAPT_BATCH, s, 0, False, 1) for s in adapt]
    # phase 6c: the source-only cell's BatchNorm inputs, and the domain
    # classifier's two (C = 1024, no ring) at the feature cell's and the
    # train driver's ASPP resolution
    cases += [(SOURCE_BATCH, s, 0, False, 1) for s in source]
    cases += [(n, (1024, hw[0] // 16, hw[1] // 16), 0, False, 0)
              for n, hw in ((BATCH, TRAIN_HW), (ADAPT_BATCH, ADAPT_HW))]
    cases += [(BATCH, s, 0, False, 0) for s in sorted(others)]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    names = ("batch_norm_stats", "batch_norm_apply", "batch_norm_grad_sums",
             "batch_norm_dx")
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "max_abs_err": 0.0} for k in names}
    comp = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    sums_lib = 0.0
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    eps, mom = 1e-5, 0.1
    log("[batchnorm] N C H W x count: worst rel err f32, bf16 | bf16 ms "
        "kernel/plain/library: stats, apply, grad_sums, dx | composite "
        "kernel plain native bound")
    for n, (c, h, w), mult, timed, ring in cases:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            x4 = randn((n, h, w, c), dtype, gen).permute(0, 3, 1, 2)
            g4 = randn((n, h, w, c), dtype, gen).permute(0, 3, 1, 2)
            x = x4.permute(0, 2, 3, 1).reshape(-1, c)
            g = g4.permute(0, 2, 3, 1).reshape(-1, c)
            weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
            bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
            gshift = torch.randn(c, device=DEV, generator=gen)
            rm0 = 0.1 * torch.randn(c, device=DEV, generator=gen)
            rv0 = 0.5 + torch.rand(c, device=DEV, generator=gen)
            count = n * (h + 2 * ring) * (w + 2 * ring)  # the ring's count
            rm, rv = rm0.clone(), rv0.clone()
            rm_p, rv_p = rm0.clone(), rv0.clone()
            st = bn.batch_norm_stats(x, weight, bias, count, eps, rm, rv, mom)
            st_p = bn.batch_norm_stats_plain(x, weight, bias, count, eps,
                                             rm_p, rv_p, mom)
            inv, shift = st[bn.INV], st[bn.SHIFT]
            gr = bn.batch_norm_grad_sums(g, x, st, gshift, count)
            coef = (gr[bn.COEF_B], gr[bn.COEF_C0])
            # each entry's inputs; the plain versions get the kernels'
            # statistics, so each kernel is held against its own function
            args = {"batch_norm_stats": (x, weight, bias, count, eps, rm, rv,
                                         mom),
                    "batch_norm_apply": (x, inv, shift),
                    "batch_norm_grad_sums": (g, x, st, gshift, count),
                    "batch_norm_dx": (g, x, inv, *coef)}
            y = bn.batch_norm_apply(*args["batch_norm_apply"])
            y_p = bn.batch_norm_apply_plain(*args["batch_norm_apply"])
            gr_p = bn.batch_norm_grad_sums_plain(*args["batch_norm_grad_sums"])
            dx = bn.batch_norm_dx(*args["batch_norm_dx"])
            dx_p = bn.batch_norm_dx_plain(*args["batch_norm_dx"])
            again = (bn.batch_norm_stats(x, weight, bias, count, eps),
                     bn.batch_norm_apply(*args["batch_norm_apply"]),
                     bn.batch_norm_grad_sums(*args["batch_norm_grad_sums"]),
                     bn.batch_norm_dx(*args["batch_norm_dx"]))
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in
                        zip(again, (st, y, gr, dx))),
                    f"batchnorm {(n, c, h, w)} {dtype}: a repeated call "
                    "differs")
            require(y.dtype == dx.dtype == dtype
                    and st.dtype == gr.dtype == torch.float32,
                    f"batchnorm {(n, c, h, w)} {dtype}: output types")
            e = {"stats": max(bn_rel(st, st_p)),
                 "running": max(bn_rel(torch.stack([rm, rv]),
                                       torch.stack([rm_p, rv_p]))),
                 "apply": max(bn_rel(y.view(1, -1), y_p.view(1, -1))),
                 "grad_sums": max(bn_rel(gr, gr_p)),
                 "dx": max(bn_rel(dx.view(1, -1), dx_p.view(1, -1)))}
            require(max(e.values()) <= tol, f"batchnorm {(n, c, h, w)} "
                    f"{dtype}: rel errs {e} > {tol}")
            errs[dtype] = max(e.values())
            worst[dtype] = max(worst[dtype], errs[dtype])
            if dtype != torch.bfloat16 or not timed:
                del x4, g4, x, g, y, y_p, dx, dx_p, again, args
                continue
            abs_err = dict(zip(names, (
                float((u.float() - v.float()).abs().max())
                for u, v in ((st, st_p), (y, y_p), (gr, gr_p), (dx, dx_p)))))
            mean, invstd = st[bn.MEAN], st[bn.RSTD]
            cnt = torch.full((1,), count, dtype=torch.int32, device=DEV)
            library = {
                "batch_norm_stats": lambda: torch.batch_norm_stats(x4, eps),
                "batch_norm_apply": lambda: torch.batch_norm_elemt(
                    x4, weight, bias, mean, invstd, eps),
                "batch_norm_grad_sums":
                    lambda: torch.batch_norm_backward_reduce(
                        g4, x4, mean, invstd, weight, True, True, True),
                "batch_norm_dx": lambda: torch.batch_norm_backward_elemt(
                    g4, x4, mean, invstd, weight, gr[bn.SUM_G],
                    gr[bn.SUM_GX], cnt)}
            t = {name: (functools.partial(getattr(bn, name), *args[name]),
                        functools.partial(getattr(bn, name + "_plain"),
                                          *args[name]),
                        library[name]) for name in names}
            isz = x.element_size()
            mc = x.numel()
            # bytes (each input read once, each output written once) and
            # flops of each entry; per-channel vectors are float32
            work = {"batch_norm_stats": (mc * isz + 4 * 4 * c + 9 * 4 * c,
                                         3 * mc),
                    "batch_norm_apply": (2 * mc * isz + 8 * c, 2 * mc),
                    "batch_norm_grad_sums": (2 * mc * isz + 40 * c, 3 * mc),
                    "batch_norm_dx": (3 * mc * isz + 12 * c, 4 * mc)}
            row = []
            k = 2 * mult  # src and tgt
            for name, fns in t.items():
                ms = [cuda_ms(f) for f in fns]
                # float32 math on the CUDA cores: the float32 peak
                bnd, _ = bound_ms(*work[name], torch.float32)
                tot = totals[name]
                tot["ms"] += k * ms[0]
                tot["plain_ms"] += k * ms[1]
                tot["library_ms"] += k * ms[2]
                tot["bound_ms"] += k * bnd
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err[name])
                row.append("/".join(f"{v:.4f}" for v in ms))
            sums_lib += k * (cuda_ms(library["batch_norm_stats"])
                             + cuda_ms(lambda: torch.batch_norm_backward_reduce(
                                 g4, x4, mean, invstd, weight, True, False,
                                 False)))

            def composite(stats, apply, grad_sums, dxf, rm_, rv_):
                s_ = stats(x, weight, bias, count, eps, rm_, rv_, mom)
                apply(x, s_[bn.INV], s_[bn.SHIFT])
                r_ = grad_sums(g, x, s_, gshift, count)
                dxf(g, x, s_[bn.INV], r_[bn.COEF_B], r_[bn.COEF_C0])

            def native():
                out = torch.ops.aten.native_batch_norm(
                    x4, weight, bias, rm_p, rv_p, True, mom, eps)
                torch.ops.aten.native_batch_norm_backward(
                    g4, x4, weight, rm_p, rv_p, out[1], out[2], True, eps,
                    [True, True, True])

            cm = [cuda_ms(lambda: composite(
                      bn.batch_norm_stats, bn.batch_norm_apply,
                      bn.batch_norm_grad_sums, bn.batch_norm_dx, rm, rv)),
                  cuda_ms(lambda: composite(
                      bn.batch_norm_stats_plain, bn.batch_norm_apply_plain,
                      bn.batch_norm_grad_sums_plain, bn.batch_norm_dx_plain,
                      rm_p, rv_p)),
                  cuda_ms(native)]
            # x and g read once, y and dx written once
            cb, _ = bound_ms(4 * mc * isz + 56 * c, 12 * mc, torch.float32)
            for key, v in zip(("ms", "plain_ms", "library_ms"), cm):
                comp[key] += k * v
            comp["bound_ms"] += k * cb
            log(f"[batchnorm] {n} {c} {h} {w} x{mult}: "
                f"{errs[torch.float32]:.3g}, {errs[torch.bfloat16]:.3g} | "
                f"{' '.join(row)} | {cm[0]:.4f} {cm[1]:.4f} {cm[2]:.4f} "
                f"{cb:.4f}")
            del x4, g4, x, g, y, y_p, dx, dx_p, again, args, t, library
    entries = []
    for name in names:
        tot = totals[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "s2r_tpu_torch/csrc/batchnorm.cu",
            "replaces": ("s2r_tpu/ops/pallas/batchnorm.py:77"
                         if name in ("batch_norm_stats", "batch_norm_grad_sums")
                         else "s2r_tpu/ops/pallas/batchnorm.py:111"),
            "launches": None, "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"],
            "ms_covers": "one 512x1024 batch-8 bf16 train step: 60 "
                         "BatchNorms x (src, tgt) = 120 calls"})
    composite_row = dict(comp, sums_ms=totals["batch_norm_stats"]["ms"]
                         + totals["batch_norm_grad_sums"]["ms"],
                         sums_library_ms=sums_lib)
    log(f"[batchnorm] {len(adapt)} train_adapt shapes ({ADAPT_HW[1]}x"
        f"{ADAPT_HW[0]} batch {ADAPT_BATCH}) pass")
    log(f"[9a batchnorm] {len(others)} shapes of {', '.join(STEP_BACKBONES)} "
        f"({TRAIN_HW[1]}x{TRAIN_HW[0]} batch {BATCH}, C up to "
        f"{max(c for c, _, _ in others)}) pass, f32 and bf16")
    log(f"[6c batchnorm] {len(source)} source-only shapes ({SOURCE_HW[1]}x"
        f"{SOURCE_HW[0]} batch {SOURCE_BATCH}) and the domain classifier's "
        f"C=1024 rows ({BATCH}x{TRAIN_HW[0] // 16}x{TRAIN_HW[1] // 16}, "
        f"{ADAPT_BATCH}x{ADAPT_HW[0] // 16}x{ADAPT_HW[1] // 16}; no ring) "
        "pass, f32 and bf16")
    log(f"[batchnorm] all checks passed; worst rel err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; one "
        f"train step (bf16, 120 BatchNorm calls): sums (stats + grad_sums) "
        f"{composite_row['sums_ms']:.3f} ms against batch_norm_stats + "
        f"backward_reduce {sums_lib:.3f}; composite {comp['ms']:.3f} ms, "
        f"plain {comp['plain_ms']:.3f}, native_batch_norm + backward "
        f"{comp['library_ms']:.3f}, bound {comp['bound_ms']:.3f}; "
        + "; ".join(f"{n} {totals[n]['ms']:.3f} (plain "
                    f"{totals[n]['plain_ms']:.3f}, library "
                    f"{totals[n]['library_ms']:.3f}, bound "
                    f"{totals[n]['bound_ms']:.3f})" for n in names))
    return entries, composite_row


def disc_check(dc, x, k, b):
    """disc_conv1 against its plain version; returns (output, max_abs_err)
    or raises.  Tolerances as the depthwise forward's."""
    got = dc.disc_conv1(x, k, b)
    ref = dc.disc_conv1_plain(x, k, b)
    torch.cuda.synchronize()
    n, h, c, w = x.shape
    require(got.shape == (n, h // 2, w // 2, k.shape[3])
            and got.dtype == x.dtype and got.is_contiguous(),
            f"disc_conv1 output {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().clamp(min=1.0)
    if x.dtype == torch.float32:
        ok = float(diff.max()) <= 1e-5 * float(scale.max())
    else:
        ok = bool((diff <= 1e-2 * scale).all())
    err = float(diff.max())
    require(ok, f"disc_conv1 {tuple(x.shape)} {x.dtype}: max_abs_err {err}")
    return got, err


def disc_inputs(n, c, h, w, ndf, dtype, gen, nchw=True):
    """A softmax map as the step makes it (NCHW, seen as [N,H,C,W]; or a
    contiguous [N,H,C,W] tensor), an HWIO kernel and a bias."""
    logits = torch.randn((n, c, h, w), device=DEV, generator=gen)
    x_nchw = torch.softmax(logits, dim=0).to(dtype)
    del logits
    x = x_nchw.permute(0, 2, 1, 3)
    if not nchw:
        x = x.contiguous()
    k = (torch.rand((4, 4, c, ndf), device=DEV, generator=gen) * 2 - 1
         ).mul_(1 / (16 * c) ** 0.5).to(dtype)
    b = (torch.rand((ndf,), device=DEV, generator=gen) * 0.2 - 0.1).to(dtype)
    return x_nchw, x, k, b


def check_disc_conv1(dc):
    """Phase 2e: disc_conv1 at the step's shape, 8x19x512x1024 (the NCHW
    softmax map seen as [N,H,C,W]) -> 8x256x512x64: bfloat16 on the tensor
    cores and float32 on the CUDA cores; then bfloat16 at edge shapes (a
    width off the 16-byte grid, a partial column strip and an odd number of
    output rows; three input channels).  Returns the bf16 entry for one
    train step (3 launches), with the f32 row beside it."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    n, c, (h, w), ndf = BATCH, 19, TRAIN_HW, 64
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x_nchw, x, k, b = disc_inputs(n, c, h, w, ndf, dtype, gen)
        got, err = disc_check(dc, x, k, b)
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        kern = cuda_ms(lambda: dc.disc_conv1(x, k, b))
        plain = cuda_ms(lambda: dc.disc_conv1_plain(x, k, b))
        lib = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b, stride=2,
                                       padding=1))
        isz = x.element_size()
        nbytes = (x.numel() + got.numel() + k.numel() + ndf) * isz
        flops = 2 * got.numel() * 16 * c
        bnd, by = bound_ms(nbytes, flops, dtype)
        rows[dtype] = {"ms": kern, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
        log(f"[disc_conv1] {str(dtype)[6:]} "
            f"({'tensor cores' if dtype == torch.bfloat16 else 'CUDA cores'})"
            f": max_abs_err {err:.3g} | kernel {kern:.4f} ms, plain "
            f"{plain:.4f}, F.conv2d {lib:.4f}, bound {bnd:.4f} ({by}; bytes "
            f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms for {nbytes / 1e6:.1f} "
            f"MB, {flops / 1e9:.1f} GFLOP at the {str(dtype)[6:]} peak "
            f"{1e3 * flops / PEAK_FLOP_PER_S[dtype]:.4f} ms)")
        del x_nchw, x, got
    for (en, ec, eh, ew), nchw in (((2, 19, 18, 1030), False),
                                   ((1, 3, 22, 256), True),
                                   ((3, 19, 6, 300), True),
                                   ((ADAPT_BATCH, c) + ADAPT_HW, True)):
        _, x, k, b = disc_inputs(en, ec, eh, ew, ndf, torch.bfloat16, gen,
                                 nchw)
        disc_check(dc, x, k, b)
    log("[disc_conv1] bf16 edge shapes (W=1030 staged element by element, "
        "C=3, 3 output rows, partial strips) and the train_adapt step's "
        f"{ADAPT_BATCH}x{c}x{ADAPT_HW[0]}x{ADAPT_HW[1]} pass")
    r = rows[torch.bfloat16]
    f32 = {key: 3 * v if key.endswith("ms") else v
           for key, v in rows[torch.float32].items()}
    return {"name": "disc_conv1", "route": "cuda",
            "source": "s2r_tpu_torch/csrc/disc_conv.cu",
            "replaces": "s2r_tpu/ops/pallas/disc_conv.py:174",
            "launches": None, "max_abs_err": r["max_abs_err"],
            "ms": 3 * r["ms"], "plain_ms": 3 * r["plain_ms"],
            "bound_ms": 3 * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": 3 * r["library_ms"], "float32": f32,
            "ms_covers": "one 512x1024 batch-8 bf16 train step: D's three "
                         "forwards = 3 launches (bf16, tensor cores); "
                         "float32: the CUDA-core kernel at the same shape"}


def check_index_limits(dw, rq, dc):
    """Phase 2f: each kernel that indexed in 32 bits on one input just over
    2^31 elements: the depthwise forward and requant split the batch (two
    launches), dk and disc_conv1 index in 64 bits (one launch).  Each is
    compared with its plain version on the batch items at each side of the
    split, or of element 2^31, and on the last."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    lim = 2 ** 31

    # depthwise bf16 [114, 256, 512, 144]: 113 images a launch
    x = randn((114, 256, 512, 144), torch.bfloat16, gen)
    k = (randn((3, 3, 144), torch.float32, gen) / 3).to(torch.bfloat16)
    require(x.numel() >= lim, "depthwise input under 2^31")
    before = dw.depthwise_conv3x3.launches
    y = dw.depthwise_conv3x3(x, k, 1)
    torch.cuda.synchronize()
    made = dw.depthwise_conv3x3.launches - before
    require(made == 2, f"depthwise over 2^31: {made} launches, not 2")
    for i in (112, 113):
        ref = dw.depthwise_conv3x3_plain(x[i:i + 1], k, 1)
        diff = (y[i:i + 1].float() - ref.float()).abs()
        require(bool((diff <= 1e-2 * ref.float().abs().clamp(min=1.0)).all()),
                f"depthwise over 2^31, image {i}: max_abs_err "
                f"{float(diff.max())}")
    del y
    # dk on the same x and a cotangent: one launch; the plain version
    # summed over runs of 16 images in float64
    g = randn((114, 256, 512, 144), torch.bfloat16, gen)
    before = dw.depthwise_dk.launches
    dk = dw.depthwise_dk(x, g, 1)
    torch.cuda.synchronize()
    require(dw.depthwise_dk.launches - before == 1, "dk over 2^31: launches")
    ref = sum(dw.depthwise_dk_plain(x[a:a + 16], g[a:a + 16], 1).double()
              for a in range(0, 114, 16))
    dk_err = rel_err(dk, ref)
    require(dk_err <= 1e-4, f"dk over 2^31: rel err {dk_err}")
    log(f"[limits] depthwise bf16 {tuple(x.shape)} ({x.numel()} elements): "
        f"2 launches, images 112 and 113 match; dk 1 launch, rel err "
        f"{dk_err:.3g}")
    del x, g, dk, ref

    # requant int32 [65, 256, 512, 256]: rows split at (2^31 - 1) // 256
    xq, m, b = requant_inputs((65, 256, 512, 256), gen)
    require(xq.numel() >= lim, "requant input under 2^31")
    before = rq.requant_s32_to_s8.launches
    yq = rq.requant_s32_to_s8(xq, m, b)
    torch.cuda.synchronize()
    made = rq.requant_s32_to_s8.launches - before
    require(made == 2, f"requant over 2^31: {made} launches, not 2")
    for i in (63, 64):  # the split row lies in image 63; 64 is the last
        require(torch.equal(yq[i], rq.requant_plain(xq[i], m, b)),
                f"requant over 2^31, image {i}: not bit-exact")
    log(f"[limits] requant int32 {tuple(xq.shape)} ({xq.numel()} elements): "
        "2 launches, images 63 and 64 bit-exact")
    del xq, yq

    # disc_conv1 at batch 256 of 512x1024 bf16: input element 2^31 lies in
    # image 215, the output has exactly 2^31 elements
    _, xd, kd, bd = disc_inputs(256, 19, 512, 1024, 64, torch.bfloat16, gen)
    before = dc.disc_conv1.launches
    yd = dc.disc_conv1(xd, kd, bd)
    torch.cuda.synchronize()
    require(dc.disc_conv1.launches - before == 1, "disc_conv1: launches")
    require(yd.numel() >= lim, "disc_conv1 output under 2^31")
    worst = 0.0
    for i in (215, 216, 255):
        ref = dc.disc_conv1_plain(xd[i:i + 1], kd, bd)
        diff = (yd[i:i + 1].float() - ref.float()).abs()
        require(bool((diff <= 1e-2 * ref.float().abs().clamp(min=1.0)).all()),
                f"disc_conv1 at batch 256, image {i}: max_abs_err "
                f"{float(diff.max())}")
        worst = max(worst, float(diff.max()))
    log(f"[limits] disc_conv1 bf16 batch 256 ({xd.numel()} input, "
        f"{yd.numel()} output elements): 1 launch, images 215, 216, 255 "
        f"match (max_abs_err {worst:.3g})")
    del xd, yd


def train_method(precision, device, affine=False, name="output_adapt",
                 s2d_convs=0, **fields):
    """build_method for the method `name` (Config `fields` set), weights
    from seed SEED, BatchNorm statistics perturbed as in phase 3 (and the
    BatchNorm scale and bias, if `affine`: perturb_batchnorm says why), the
    domain classifier's too; `s2d_convs`: the discriminator's (phase
    12c)."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.tools.step_conditioning import perturb_batchnorm
    from s2r_tpu_torch.train.setup import build_method

    method = build_method(Config(precision=precision, **fields),
                          iters_per_epoch=1000, method=name, device=device,
                          generator=torch.Generator().manual_seed(SEED))
    if s2d_convs:
        method.aux_model.s2d_convs = s2d_convs
    perturb_batchnorm(method.deeplab, SEED + 1, SEED + 2 if affine else None)
    if name != "output_adapt":
        perturb_batchnorm(method.aux_model, SEED + 3,
                          SEED + 4 if affine else None)
    return method


def snapshot(method):
    """(G params, D params, G's and D's running stats) as float64 CPU
    tensors (D's statistics keyed 'D.')."""
    g = {k: v.detach().double().cpu() for k, v in
         method.deeplab.named_parameters()}
    d = {k: v.detach().double().cpu() for k, v in
         method.aux_model.named_parameters()}
    s = {p + k: v.detach().double().cpu()
         for p, m in (("", method.deeplab), ("D.", method.aux_model))
         for k, v in m.named_buffers() if k.endswith(("_mean", "_var"))}
    return g, d, s


def train_check_small(counted, backbone="mobilenet", hw=None, **fields):
    """Phase 4a (and 9c, 12b): one `hw` (TRAIN_CHECK_HW when None) batch-2
    float32 step on the card against the CPU (float32 and the float64
    reference), dropout off, from weights with the BatchNorm scale and
    bias perturbed (perturb_batchnorm says why); Config `fields` set."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.io.convert import deeplab_param_order
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.tools.step_conditioning import sgd_gradients

    rs = np.random.RandomState(SEED)
    n, (h, w) = 2, hw or TRAIN_CHECK_HW
    tag = f"train {h}x{w}" + ("" if backbone == "mobilenet" else
                              f" {backbone}") + "".join(
        f" {k}={v}" for k, v in fields.items())
    label = rs.randint(0, 19, (n, h, w)).astype(np.int64)
    label[:, :3] = 255
    batch = {"src_image": rs.randn(n, h, w, 3).astype(np.float32),
             "src_label": label,
             "tgt_image": rs.randn(n, h, w, 3).astype(np.float32)}
    wd = Config().weight_decay
    runs = {}
    for name, device, precision in (("card", DEV, "f32"), ("cpu", "cpu", "f32"),
                                    ("exact", "cpu", "f64")):
        method = train_method(precision, device, affine=True,
                              backbone=backbone, **fields)
        set_dropout(method.deeplab, False)
        state = method.init_state()
        before = snapshot(method)
        reset(counted)
        state, metrics = method.step_fn(state, batch)
        if name == "card":
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
        runs[name] = ({k: float(v) for k, v in metrics.items()}, before,
                      snapshot(method),
                      sgd_gradients(state.opt_state["G"]["momentum"],
                                    before[0], wd,
                                    order=deeplab_param_order(backbone)))
        del method, state
    log(f"[{tag}] launches in the card's step: {launches}")
    require(launches == step_launches("output_adapt", backbone),
            f"{tag} step: launches {launches}")
    (m_card, b_card, a_card, gr_card), (m_cpu, b_cpu, a_cpu, gr_cpu), \
        (_, b_ex, a_ex, gr_ex) = runs["card"], runs["cpu"], runs["exact"]
    for k in ("seg_loss", "adv_loss", "d_loss"):
        err = abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
        require(np.isfinite(m_card[k]) and err <= 1e-4,
                f"{tag} {k}: card {m_card[k]} cpu {m_cpu[k]}")
    stats_err = max(float((a_card[2][k] - a_cpu[2][k]).abs().max()
                          / a_cpu[2][k].abs().max()) for k in a_cpu[2])
    require(stats_err <= 1e-3, f"{tag} BN running stats: {stats_err}")

    def upd(before, after, i):
        return torch.cat([(after[i][k] - before[i][k]).reshape(-1)
                          for k in sorted(before[i])])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    # G, per leaf: the card's gradient against the float64 one, within
    # LEAF_BOUND or 3x the CPU's own float32 distance from it for that
    # leaf, whichever is larger.  Leaves the float64 run leaves unresolved
    # (gradient zero up to rounding) are left out.
    kept = [k for k in gr_ex if gr_ex[k] is not None]
    leaf = {k: (rel(gr_card[k], gr_ex[k]), rel(gr_cpu[k], gr_ex[k]))
            for k in kept}
    bad = {k: v for k, v in leaf.items()
           if v[0] > max(LEAF_BOUND, 3 * v[1])}
    worst = max(leaf, key=lambda k: leaf[k][0])
    worst_cpu = max(leaf, key=lambda k: leaf[k][1])
    g_card, g_cpu, g_ex = (torch.cat([g[k].reshape(-1) for k in kept])
                           for g in (gr_card, gr_cpu, gr_ex))
    d_card, d_cpu = upd(b_card, a_card, 1), upd(b_cpu, a_cpu, 1)
    sign = float((torch.sign(d_card) == torch.sign(d_cpu)).double().mean())
    log(f"[{tag}] losses card {m_card} vs cpu {m_cpu}; BN running "
        f"stats rel err {stats_err:.3g}; G gradient, {len(kept)} of "
        f"{len(gr_ex)} leaves resolved: worst leaf card-exact "
        f"{leaf[worst][0]:.3g} ({worst}; cpu-exact {leaf[worst][1]:.3g}), "
        f"worst leaf cpu-exact {leaf[worst_cpu][1]:.3g} ({worst_cpu}), "
        f"median leaf card-exact "
        f"{statistics.median(v[0] for v in leaf.values()):.3g}; global "
        f"card-exact {rel(g_card, g_ex):.3g}, cpu-exact "
        f"{rel(g_cpu, g_ex):.3g}, card-cpu {rel(g_card, g_cpu):.3g}; D "
        f"update sign agreement card-cpu {100 * sign:.3f}%")
    require(not bad, f"{tag} G gradient: leaves off the float64 run {bad}")
    require(sign >= 0.99, f"{tag} D update sign agreement {sign}")


def time_step(name, counted, hw, n, **fields):
    """A bf16 step of method `name` at `hw` batch `n` (train_method's
    `fields`): 2 warm-up and 5 timed steps by CUDA events, then the
    launch counts of one step, which must be step_launches(name, the
    backbone, remat).  Returns (median ms, the 5 ms, peak GiB, the last
    metrics as floats, launches, BatchNorm layout copies of the counted
    step)."""
    from s2r_tpu_torch.ops.kernels.batchnorm import channels_last_rows
    from s2r_tpu_torch.tools.profile_train import bench_batch

    method = train_method("bf16", DEV, name=name, **fields)
    backbone = fields.get("backbone", "mobilenet")
    require(layer_counts(method.deeplab) == LAYERS[backbone],
            f"{backbone}: (depthwise, BatchNorm) layers "
            f"{layer_counts(method.deeplab)}, expected {LAYERS[backbone]}")
    state = method.init_state()
    batch = bench_batch(name, n, hw, DEV,
                        torch.Generator(device=DEV).manual_seed(SEED + 6))
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, metrics = method.step_fn(state, batch)
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = method.step_fn(state, batch)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    values = {k: float(v) for k, v in metrics.items()}
    require(all(np.isfinite(v) for v in values.values()),
            f"{name} {hw} metrics not finite: {values}")

    # The main-path run that the kernels line counts: one step.
    reset(counted)
    channels_last_rows.copies = 0
    state, metrics = method.step_fn(state, batch)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    want = step_launches(name, backbone, remat=fields.get("remat", False))
    require(launches == want,
            f"{name} {backbone} step: launches {launches}, expected {want}")
    del method, state, batch
    return (statistics.median(runs), runs, peak, values, launches,
            channels_last_rows.copies)


def train_full(counted):
    """Phase 4b: the 512x1024 batch-8 bf16 step, timed; then the launch
    counts of one step."""
    ms, runs, peak, losses, launches, copies = time_step(
        "output_adapt", counted, TRAIN_HW, BATCH)
    log(f"[train 512x1024] {ms:.3f} ms/step (median of 5 batch-{BATCH} "
        f"bf16 steps: {', '.join(f'{r:.3f}' for r in runs)}), "
        f"{BATCH * 1e3 / ms:.2f} source images/s (bench.py's '1024x512 "
        f"train images/sec/chip (output-space adaption)'), peak device "
        f"memory {peak:.2f} GiB; losses after 7 steps {losses}")
    log(f"[train 512x1024] launches in one step: {launches}; BatchNorm "
        f"layout copies (an NCHW tensor made channels-last for the kernels):"
        f" {copies}")
    return ms, launches, copies


def read_scalars(exp_dir):
    """{tag: [(step, value), ...]} from a run's scalars.jsonl."""
    out = {}
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            out.setdefault(row["tag"], []).append((row["step"], row["value"]))
    return out


def trees_equal(a, b):
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(trees_equal(a[k], b[k]) for k in a))
    return a == b


def check_device_aug(loader, cfg):
    """Phase 5d: the warp on the card against the CPU, same parameters."""
    from s2r_tpu_torch.data import device_aug as DA

    batch = next(iter(loader))
    n, sh, sw = batch["src_image"].shape[:3]
    params = DA.sample_params(DA.batch_generator(cfg.seed, 0, 0), n,
                              cfg.base_size, cfg.crop_size, sh, sw)
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    cpu = DA.warp_paired_batch(host, params, cfg.crop_size)
    card = DA.warp_paired_batch({k: v.to(DEV) for k, v in host.items()},
                                params, cfg.crop_size)
    err = max(float((card[k].cpu() - cpu[k]).abs().max())
              for k in ("src_image", "tgt_image"))
    same = torch.equal(card["src_label"].cpu(), cpu["src_label"])
    log(f"[train_adapt] device augmentation card vs CPU ({n}x{sh}x{sw} -> "
        f"{cfg.crop_size}, {int(params['blur_gate'].sum())} of {n} blurred, "
        f"{int(params['flip'].sum())} flipped): images max_abs_err "
        f"{err:.3g}, labels {'equal' if same else 'DIFFER'}")
    require(err <= 1e-4 and same, "device augmentation: card disagrees "
            "with the CPU")
    return card


def predicted(method, steps, eval_fwd, backbone="mobilenet", remat=False):
    """Each kernel's launches in `steps` steps of `method` and `eval_fwd`
    eval forwards (14 depthwise each on MobileNetV2) on `backbone`."""
    want = {k: v * steps for k, v in
            step_launches(method, backbone, remat=remat).items()}
    want["depthwise_conv3x3"] += LAYERS[backbone][0] * eval_fwd
    return want


def fit_eval_forwards(trainer):
    """Eval forwards of Trainer.fit from epoch 0: an image-logging forward
    every vis_every steps and the validation batches, each epoch."""
    n_tr, n_val = len(trainer.train_loader), len(trainer.val_loader)
    vis_every = max(n_tr // 10, 1) if n_tr >= 10 else max(n_tr, 1)
    return trainer.cfg.epochs * (len(range(0, n_tr, vis_every)) + n_val)


def train_adapt_phase(counted, carry):
    """Phase 5: the train_adapt driver, resume, val_adapt, the device
    augmentation, and the driver's rates beside the bare step's.  Puts
    the final state's checkpoint and its mIoU in carry['adapt'] (for
    phase 8)."""
    from s2r_tpu_torch.cli import _eval_common, train_adapt, val_adapt
    from s2r_tpu_torch.io.checkpoint import host_tree
    from s2r_tpu_torch.train.trainer import Trainer

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_train_adapt_")
    try:
        argv = ADAPT_ARGV + ["--run-root", root]
        reset(counted)
        t0 = time.perf_counter()
        trainer = train_adapt.main(argv)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        cfg = trainer.cfg
        steps, n_tr = trainer.state.step, len(trainer.train_loader)
        n_val = len(trainer.val_loader)
        want = predicted("output_adapt", steps, fit_eval_forwards(trainer))
        log(f"[train_adapt] {cfg.epochs} epochs of {n_tr} steps, {n_val} "
            f"validation batches and one image-logging forward an epoch in "
            f"{fit_s:.1f} s; launches {launches}")
        require(steps == cfg.epochs * n_tr, f"train_adapt ran {steps} steps")
        require(launches == want, f"train_adapt launches {launches}, "
                f"expected {want}")
        exp = trainer.saver.experiment_dir
        for path in (os.path.join(exp, "checkpoint.ckpt"),
                     os.path.join(exp, "best_pred.txt"),
                     os.path.join(trainer.saver.directory, "model_best.ckpt")):
            require(os.path.isfile(path), f"train_adapt wrote no {path}")
        sc = read_scalars(exp)
        for tag in ("train/seg_loss", "train/adv_loss", "train/d_loss",
                    "val/total_loss_epoch"):
            require(len(sc[tag]) == cfg.epochs
                    and all(np.isfinite(v) for _, v in sc[tag]),
                    f"train_adapt {tag}: {sc.get(tag)}")
        mious = [v for _, v in sc["val/mIoU"]]
        require(all(0.0 <= v <= 1.0 for v in mious)
                and trainer.best_pred == max(mious),
                f"train_adapt mIoU {mious}, best {trainer.best_pred}")
        epoch_rate = [v for _, v in sc["train/images_per_sec"]]
        log(f"[train_adapt] epoch images/s (data + augmentation + step) "
            f"{', '.join(f'{v:.2f}' for v in epoch_rate)}; losses "
            + "; ".join(f"{t[6:]} {', '.join(f'{v:.4f}' for _, v in sc[t])}"
                        for t in ("train/seg_loss", "train/adv_loss",
                                  "train/d_loss"))
            + f"; val mIoU {', '.join(f'{v:.4f}' for v in mious)}")

        # validation alone, on the trained model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou_again, _ = _eval_common.validation(
            cfg, trainer.state.G, trainer.eval_step, trainer.val_loader,
            trainer.nclass)
        torch.cuda.synchronize()
        val_ms = 1e3 * (time.perf_counter() - t0) / (n_val * cfg.batch_size)
        log(f"[train_adapt] validation {val_ms:.3f} ms/image (data + "
            f"normalization + eval step, {n_val} batches of "
            f"{cfg.batch_size}); mIoU {miou_again:.6f} (last epoch's "
            f"{mious[-1]:.6f})")

        # a checkpoint of the final state, timed; resume from it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = trainer.saver.save_checkpoint(trainer.state, cfg.epochs,
                                             trainer.best_pred, is_best=False,
                                             filename="final.ckpt")
        hold_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        trainer.saver.wait()
        wait_ms = 1e3 * (time.perf_counter() - t0)
        log(f"[train_adapt] checkpoint save: holds the loop {hold_ms:.3f} "
            f"ms (the device snapshot), saver.wait() {wait_ms:.3f} ms (to "
            f"host, torch.save, {os.path.getsize(path) / 2 ** 20:.1f} MiB)")
        live = host_tree(trainer.state)
        carry["adapt"] = {"ckpt": os.path.join(carry["dir"],
                                               "adapt_final.ckpt"),
                          "miou": miou_again, "cfg": cfg}
        shutil.copyfile(path, carry["adapt"]["ckpt"])
        resumed = Trainer(dataclasses.replace(cfg, resume=path, ft=False),
                          method="output_adapt")
        got = host_tree(resumed.state)
        require(resumed.start_epoch == cfg.epochs
                and trees_equal(got, live),
                "resume: the restored state differs from the saved one")
        means = resumed.training(resumed.start_epoch)
        resumed.saver.wait()
        resumed.writer.close()
        require(all(np.isfinite(means[k]) for k in ("seg_loss", "adv_loss",
                                                    "d_loss")),
                f"resumed epoch losses {means}")
        log(f"[train_adapt] resume (ft off): weights, BatchNorm statistics, "
            f"optimizer buffers, step {got['step']}, dropout generator and "
            f"start_epoch {resumed.start_epoch} bit-equal; one more epoch: "
            f"seg_loss {means['seg_loss']:.4f}, adv_loss "
            f"{means['adv_loss']:.4f}, d_loss {means['d_loss']:.4f}, "
            f"{means['images_per_sec']:.2f} images/s")

        best = os.path.join(trainer.saver.directory, "model_best.ckpt")
        miou_val, _ = val_adapt.main(argv + ["--resume", best, "--skip-sep",
                                             "--out-dir",
                                             os.path.join(root, "val")])
        log(f"[train_adapt] val_adapt on model_best.ckpt: mIoU "
            f"{miou_val:.6f}, the Trainer's best {trainer.best_pred:.6f}")
        require(abs(miou_val - trainer.best_pred) <= 1e-4,
                "val_adapt disagrees with the Trainer's mIoU")

        batch = check_device_aug(trainer.train_loader, cfg)
        step, state = resumed.train_step, resumed.state
        for _ in range(2):
            state, _ = step(state, batch)
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, batch)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        step_ms = statistics.median(runs)
        step_rate = cfg.batch_size * 1e3 / step_ms
        log(f"[train_adapt] step alone at {cfg.crop_size}x{cfg.crop_size} "
            f"batch {cfg.batch_size} {cfg.precision}: {step_ms:.3f} ms (median of 5: "
            f"{', '.join(f'{r:.3f}' for r in runs)}), {step_rate:.2f} "
            f"images/s; the driver's epochs reach "
            f"{', '.join(f'{100 * v / step_rate:.1f}' for v in epoch_rate)}% "
            "of it")
        del trainer, resumed, state, batch
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def feature_check_small(counted):
    """Phase 6a: one 128x128 batch-2 float32 feature_adapt step and one
    source_only step on the card against the CPU (float32, and float64 as
    the exact reference), dropout off, from the weights of phase 4a with
    the domain classifier's BatchNorms perturbed too.  Returns each step's
    launches on the card."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.io.convert import domain_param_order
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.tools.step_conditioning import sgd_gradients

    rs = np.random.RandomState(SEED + 7)
    n, (h, w) = 2, TRAIN_CHECK_HW
    label = rs.randint(0, 19, (n, h, w)).astype(np.int64)
    label[:, :3] = 255
    src = rs.randn(n, h, w, 3).astype(np.float32)
    tgt = rs.randn(n, h, w, 3).astype(np.float32)
    batches = {"feature_adapt": {"src_image": src, "src_label": label,
                                 "tgt_image": tgt},
               "source_only": {"image": src, "label": label}}
    wd = Config().weight_decay
    all_launches = {}
    for name, batch in batches.items():
        runs = {}
        for run, device, precision in (("card", DEV, "f32"),
                                       ("cpu", "cpu", "f32"),
                                       ("exact", "cpu", "f64")):
            method = train_method(precision, device, affine=True, name=name)
            set_dropout(method.deeplab, False)
            set_dropout(method.aux_model, False)
            state = method.init_state()
            before = snapshot(method)
            reset(counted)
            state, metrics = method.step_fn(state, batch)
            if run == "card":
                torch.cuda.synchronize()
                all_launches[name] = {fn.__name__: fn.launches
                                      for fn in counted}
            opt = state.opt_state
            grads = {"G": sgd_gradients(opt["task"]["momentum"], before[0],
                                        wd)}
            if name == "feature_adapt":
                grads["D"] = sgd_gradients(opt["d"]["momentum"], before[1],
                                           wd, order=domain_param_order())
            else:
                require(all(float(opt[k]["momentum"].abs().max()) == 0
                            for k in ("d", "d_inv", "c")),
                        f"{name}: a D, d_inv or c buffer moved")
            runs[run] = ({k: float(v) for k, v in metrics.items()}, before,
                         snapshot(method), grads)
            del method, state
        launches = all_launches[name]
        want = step_launches(name)
        require(all(launches[k] > 0 for k in want if want[k]),
                f"{name} {h}x{w} step missed a kernel: {launches}")
        (m_card, b_card, a_card, gr_card), (m_cpu, _, a_cpu, gr_cpu), \
            (_, _, _, gr_ex) = runs["card"], runs["cpu"], runs["exact"]
        losses = (("task_loss", "d_loss", "d_inv_loss")
                  if name == "feature_adapt" else ("task_loss",))
        for k in losses:
            err = abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
            require(np.isfinite(m_card[k]) and err <= 1e-4,
                    f"{name} {h}x{w} {k}: card {m_card[k]} cpu {m_cpu[k]}")
        if name == "source_only":
            require(all(m_card[k] == 0.0 for k in ("d_loss", "d_inv_loss",
                                                    "d_acc")),
                    f"source_only domain metrics {m_card}")
            require(all(torch.equal(b_card[1][k], a_card[1][k])
                        for k in b_card[1])
                    and all(torch.equal(b_card[2][k], a_card[2][k])
                            for k in b_card[2] if k.startswith("D.")),
                    "source_only moved the domain classifier")
        stats_err = max(float((a_card[2][k] - a_cpu[2][k]).abs().max()
                              / a_cpu[2][k].abs().max()) for k in a_cpu[2])
        require(stats_err <= 1e-3, f"{name} {h}x{w} BN running stats: "
                f"{stats_err}")

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        parts = []
        for net in grads:
            ex, card_g, cpu_g = gr_ex[net], gr_card[net], gr_cpu[net]
            kept = [k for k in ex if ex[k] is not None]
            leaf = {k: (rel(card_g[k], ex[k]), rel(cpu_g[k], ex[k]))
                    for k in kept}
            bad = {k: v for k, v in leaf.items()
                   if v[0] > max(LEAF_BOUND, 3 * v[1])}
            worst = max(leaf, key=lambda k: leaf[k][0])
            parts.append(
                f"{net} gradient, {len(kept)} of {len(ex)} leaves resolved: "
                f"worst leaf card-exact {leaf[worst][0]:.3g} ({worst}; "
                f"cpu-exact {leaf[worst][1]:.3g}), median "
                f"{statistics.median(v[0] for v in leaf.values()):.3g}")
            require(not bad, f"{name} {h}x{w} {net} gradient: leaves off the "
                    f"float64 run {bad}")
        log(f"[6a {name} {h}x{w}] metrics card {m_card} vs cpu {m_cpu}; BN "
            f"running stats (G and D) rel err {stats_err:.3g}; "
            + "; ".join(parts) + f"; launches on the card {launches}")
    return all_launches


def feature_full(counted):
    """Phase 6b: bench.py's feature cell (512x1024 batch 8 bf16) and
    source-only cell (513x513 batch 4 bf16), timed, and the launch counts
    of one step of each."""
    from s2r_tpu_torch.tools.profile_train import BENCH

    out = {}
    for name in ("feature_adapt", "source_only"):
        hw, n, fields = BENCH[name]
        ms, runs, peak, values, launches, _ = time_step(name, counted, hw, n,
                                                        **fields)
        log(f"[6b {name} {hw[1]}x{hw[0]}] {ms:.3f} ms/step (median of 5 "
            f"batch-{n} bf16 steps: {', '.join(f'{r:.3f}' for r in runs)}), "
            f"{n * 1e3 / ms:.2f} source images/s, peak device memory "
            f"{peak:.2f} GiB; metrics after 7 steps {values}; launches in "
            f"one step {launches}")
        out[name] = (ms, n * 1e3 / ms, peak, launches)
        torch.cuda.empty_cache()
    return out


def check_source_shapes(dw):
    """Phase 6c (depthwise; the BatchNorm shapes are in phase 2d's loop):
    forward, dx and dk at the source-only cell's 14 layers (513x513 batch
    4: 33x33 at dilation 2, odd H), f32 and bf16, against the plain
    versions at phase 2's tolerances."""
    from s2r_tpu_torch.models.mobilenet import block_plan

    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    shapes = sorted(set(dw_shapes(SOURCE_HW, block_plan)))
    worst = 0.0
    for c, h, w, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((SOURCE_BATCH, h, w, c), dtype, gen)
            g = randn((SOURCE_BATCH, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            dw_check(dw, x, k, d)
            dw_check(dw, g, k.flip((0, 1)).contiguous(), d)
            worst = max(worst, dk_check(dw, x, g, d)[2])
    log(f"[6c depthwise] {len(shapes)} source-only shapes ({SOURCE_HW[1]}x"
        f"{SOURCE_HW[0]} batch {SOURCE_BATCH}: "
        f"{', '.join(f'C{c} {h}x{w} d{d}' for c, h, w, d in shapes)}) pass "
        f"forward, dx and dk; worst dk rel err {worst:.3g}")


# Phase 7: the SHA-256 of the host imaging library's outputs on the seeded
# calls of imaging_digest; tests/test_torch_port_imaging.py holds PIL's
# outputs on the same calls to the same constant.
IMAGING_DIGEST = ("f1fe458d3373a00780bc5f622587d69c"
                  "dbd9121e95e6db07dc485613188b8336")
DIGEST_BASE, DIGEST_CROP = 40, 48  # the digest's train transforms


def imaging_digest(resize, blur, transform):
    """SHA-256 over BILINEAR resizes (whole frame and box= windows), Gaussian
    blurs and train transforms of seeded uint8 frames, RGB and gray:
    resize(img, (w, h), box), blur(img, radius) and transform(sample, rng)
    return uint8 arrays (the sample's entries in its key order)."""
    import hashlib
    import random

    rs, rr = np.random.RandomState(SEED), random.Random(SEED)
    h = hashlib.sha256()
    for i in range(16):
        ih, iw = (int(v) for v in rs.randint(8, 160, 2))
        img = rs.randint(0, 256, (ih, iw, 3)).astype(np.uint8)
        if i % 2:
            img = np.ascontiguousarray(img[..., 0])
        ow, oh = (int(v) for v in rs.randint(4, 320, 2))
        x0, y0 = rs.uniform(0, iw / 2), rs.uniform(0, ih / 2)
        box = (x0, y0, rs.uniform(x0 + 1, iw), rs.uniform(y0 + 1, ih))
        for out in (resize(img, (ow, oh), None), resize(img, (ow, oh), box),
                    blur(img, rr.random()), blur(img, 4 * rr.random())):
            h.update(np.ascontiguousarray(out, np.uint8).tobytes())
    for i in range(6):
        sh, sw = (int(v) for v in rs.randint(24, 96, 2))
        th, tw = (int(v) for v in rs.randint(24, 96, 2))
        sample = {"src_image": rs.randint(0, 256, (sh, sw, 3)).astype(np.uint8),
                  "tgt_image": rs.randint(0, 256, (th, tw, 3)).astype(np.uint8),
                  "src_label": rs.randint(0, 256, (sh, sw)).astype(np.uint8)}
        for v in transform(sample, random.Random(i)).values():
            h.update(np.ascontiguousarray(v, np.uint8).tobytes())
    return h.hexdigest()


# Phase 11: the SHA-256 of the native pipeline's outputs on the seeded
# calls of native_digest; tests/test_torch_port_native.py holds the port
# to it on the CPU, and those outputs to the JAX package's native library
# (bytes equal, float32 within one ulp).
NATIVE_DIGEST = ("61fe09e61b8f75eb151edb3e0509280f"
                 "cd098e408ad6b02f7755c7463bdd211a")


def native_digest(native, root):
    """(SHA-256, outputs) of native.train_batch (seeded draws, blur on,
    forced off, with and without targets, float32 and emit_u8, a square
    and a rectangular crop) and native.eval_batch (with labels and
    without) over PNGs made from SEED and written under `root` (L-mode
    labels of labelIds; the frames from 24x40 up to 120x200, some smaller
    than the crops)."""
    import hashlib

    from s2r_tpu_torch.data.datasets import _LUT
    from s2r_tpu_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD
    from s2r_tpu_torch.utils.png import write_png

    rs = np.random.RandomState(SEED)
    paths = {"src": [], "lbl": [], "tgt": []}
    for i in range(6):
        h, th = (int(v) for v in rs.randint(24, 121, 2))
        w, tw = (int(v) for v in rs.randint(40, 201, 2))
        frames = {"src": rs.randint(0, 256, (h, w, 3)),
                  "lbl": rs.randint(0, 34, (h, w)),
                  "tgt": rs.randint(0, 256, (th, tw, 3))}
        for kind, a in frames.items():
            paths[kind].append(os.path.join(root, f"{kind}{i}.png"))
            write_png(paths[kind][-1], a.astype(np.uint8),
                      filters=(0, 1, 2, 3, 4))
    outs = []
    for crop, tgt, u8 in ((64, True, False), ((48, 80), True, True),
                          (64, False, True), ((48, 80), False, False)):
        outs += [a for a in native.train_batch(
            paths["src"], paths["lbl"], paths["tgt"] if tgt else None, 56,
            crop, _LUT, IMAGENET_MEAN, IMAGENET_STD,
            seeds=rs.randint(0, 2 ** 62, 6).astype(np.uint64), blur=True,
            emit_u8=u8, threads=3) if a is not None]
    outs += list(native.eval_batch(paths["src"], paths["lbl"], 72, _LUT,
                                   IMAGENET_MEAN, IMAGENET_STD, 4))
    outs += list(native.eval_batch(paths["tgt"], None, 40, _LUT,
                                   IMAGENET_MEAN, IMAGENET_STD, 2))
    h = hashlib.sha256()
    for a in outs:
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest(), outs


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                               "big")


def check_exports(out_dir, n_images, with_miou):
    """One labelId PNG and one color PNG an image, each 1280x640."""
    names = sorted(os.listdir(out_dir))
    gray = [p for p in names if p.endswith("_labelId.png")]
    color = [p for p in names if ("_color_" in p if with_miou
                                  else p.endswith("_color.png"))]
    require(len(gray) == len(color) == n_images
            and len(names) == 2 * n_images,
            f"{out_dir}: {len(gray)} labelId and {len(color)} color PNGs "
            f"for {n_images} images")
    sizes = {png_size(os.path.join(out_dir, p)) for p in names}
    require(sizes == {(1280, 640)}, f"{out_dir}: PNG sizes {sizes}")


def train_phase(counted, carry):
    """Phase 6d: the train driver (feature_adapt) for one epoch, a resume
    with ft off for one more, then val with the per-image export and test
    on its best checkpoint.  Returns the launches of each entry point, and
    puts the best checkpoint and its mIoU in carry['feature'] (for phase
    8)."""
    from s2r_tpu_torch.cli import test, train, val
    from s2r_tpu_torch.io.checkpoint import host_tree
    from s2r_tpu_torch.train.trainer import Trainer

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_train_")
    by_path = {}
    try:
        argv = TRAIN_ARGV + ["--run-root", root]
        reset(counted)
        t0 = time.perf_counter()
        trainer = train.main(argv)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        by_path["train"] = {fn.__name__: fn.launches for fn in counted}
        cfg = trainer.cfg
        steps, n_tr = trainer.state.step, len(trainer.train_loader)
        n_val, n_test = len(trainer.val_loader), len(trainer.test_loader)
        want = predicted("feature_adapt", steps, fit_eval_forwards(trainer))
        log(f"[6d train] {cfg.epochs} epoch of {n_tr} steps, {n_val} "
            f"validation batches and one image-logging forward in "
            f"{fit_s:.1f} s; launches {by_path['train']}")
        require(trainer.method.name == "feature_adapt"
                and steps == cfg.epochs * n_tr,
                f"train ran {trainer.method.name}, {steps} steps")
        require(by_path["train"] == want,
                f"train launches {by_path['train']}, expected {want}")
        sc = read_scalars(trainer.saver.experiment_dir)
        for tag in ("train/task_loss", "train/d_loss", "train/d_inv_loss",
                    "train/d_acc", "val/total_loss_epoch", "val/mIoU"):
            require(len(sc[tag]) == cfg.epochs
                    and all(np.isfinite(v) for _, v in sc[tag]),
                    f"train {tag}: {sc.get(tag)}")
        best = os.path.join(trainer.saver.directory, "model_best.ckpt")
        require(os.path.isfile(best)
                and 0.0 <= trainer.best_pred <= 1.0,
                f"train: best mIoU {trainer.best_pred}, {best}")
        epoch_rate = sc["train/images_per_sec"][0][1]

        # resume with ft off from a checkpoint of the final state
        path = trainer.saver.save_checkpoint(trainer.state, cfg.epochs,
                                             trainer.best_pred, is_best=False,
                                             filename="final.ckpt")
        trainer.saver.wait()
        live = host_tree(trainer.state)
        resumed = Trainer(dataclasses.replace(cfg, resume=path, ft=False),
                          method="feature_adapt")
        require(resumed.start_epoch == cfg.epochs
                and trees_equal(host_tree(resumed.state), live),
                "train resume: the restored state differs from the saved one")
        means = resumed.training(resumed.start_epoch)
        resumed.saver.wait()
        resumed.writer.close()
        require(all(np.isfinite(means[k]) for k in ("task_loss", "d_loss",
                                                    "d_inv_loss")),
                f"resumed epoch {means}")
        log(f"[6d train] epoch {epoch_rate:.2f} images/s (data + "
            f"augmentation + step + image logging); losses "
            + "; ".join(f"{t[6:]} {sc[t][0][1]:.4f}" for t in
                        ("train/task_loss", "train/d_loss",
                         "train/d_inv_loss", "train/d_acc"))
            + f"; val mIoU {trainer.best_pred:.6f}; resume (ft off) "
            f"bit-equal at step {live['step']}, one more epoch: task_loss "
            f"{means['task_loss']:.4f}, d_loss {means['d_loss']:.4f}, "
            f"d_inv_loss {means['d_inv_loss']:.4f}, "
            f"{means['images_per_sec']:.2f} images/s")
        del trainer, resumed, live

        # val with the per-image export, then test, on the best checkpoint
        out = os.path.join(root, "val")
        reset(counted)
        t0 = time.perf_counter()
        miou_val, _ = val.main(argv + ["--resume", best, "--out-dir", out])
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        by_path["val"] = {fn.__name__: fn.launches for fn in counted}
        log(f"[6d val] mIoU {miou_val:.6f} against the Trainer's best "
            f"{sc['val/mIoU'][0][1]:.6f}; {val_s:.1f} s with the "
            f"export; launches {by_path['val']}")
        require(abs(miou_val - sc["val/mIoU"][0][1]) <= 1e-4,
                "val disagrees with the Trainer's mIoU")
        carry["feature"] = {"ckpt": os.path.join(carry["dir"],
                                                 "feature_best.ckpt"),
                            "miou": miou_val}
        shutil.copyfile(best, carry["feature"]["ckpt"])
        # validation_sep and validation: one forward a batch each
        require(by_path["val"] == dict(
            dict.fromkeys(by_path["val"], 0),
            depthwise_conv3x3=14 * 2 * n_val),
            f"val launches {by_path['val']}")
        check_exports(os.path.join(out, "predictions"),
                      n_val * cfg.batch_size, True)
        out = os.path.join(root, "test")
        reset(counted)
        test.main(argv + ["--resume", best, "--out-dir", out])
        torch.cuda.synchronize()
        by_path["test"] = {fn.__name__: fn.launches for fn in counted}
        require(by_path["test"] == dict(
            dict.fromkeys(by_path["test"], 0),
            depthwise_conv3x3=14 * n_test),
            f"test launches {by_path['test']}")
        check_exports(out, n_test * cfg.batch_size, False)
        log(f"[6d val, test] {n_val * cfg.batch_size} and "
            f"{n_test * cfg.batch_size} images: one labelId and one color "
            f"PNG each at 1280x640; test launches {by_path['test']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path


def drive(counted, main, argv):
    """main(argv) with the launch counts set to 0 just before; (its result,
    the counts just after, seconds)."""
    reset(counted)
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return out, {fn.__name__: fn.launches for fn in counted}, \
        time.perf_counter() - t0


def profiled_epoch(trainer, epoch):
    """(wall s, device s, idle share) of Trainer.training(epoch) under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.training(epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return wall, dev, max(0.0, 1.0 - dev / wall)


def real_data_phase(counted, smi, carry):
    """Phase 7: the real datasets.  Returns the launches of each entry
    point it drives, and puts the host route's loader and epoch rates in
    carry['host_route'] (for phase 11)."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    from s2r_tpu_torch.cli import test, train, train_adapt, val_adapt
    from s2r_tpu_torch.data import imaging
    from s2r_tpu_torch.data import transforms as T
    from s2r_tpu_torch.tools import fixtures

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    digest = imaging_digest(imaging.resize_bilinear, imaging.gaussian_blur,
                            T.train_transforms(DIGEST_BASE, DIGEST_CROP))
    log(f"[7 imaging] golden digest {digest[:16]}..: "
        f"{'equal' if digest == IMAGING_DIGEST else 'DIFFERENT'} to PIL's")
    require(digest == IMAGING_DIGEST, "imaging digest differs from PIL's")
    root = tempfile.mkdtemp(prefix="s2r_real_")
    by_path, profiled = {}, {}
    carry["host_route"] = host = {"loader": {}}
    try:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        files = fixtures.write_fixtures(data, **REAL_FRAMES)
        write_s = time.perf_counter() - t0

        def decodes_back(f):
            load = imaging.load_rgb if f[1] == "rgb" else imaging.load_raw
            return np.array_equal(load(f[0]), f[2])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            same = list(pool.map(decodes_back, files))
        dec_s = time.perf_counter() - t0
        mb = sum(os.path.getsize(f[0]) for f in files) / 2 ** 20
        log(f"[7 fixtures] {len(files)} PNGs ({mb:.1f} MiB, the five filter "
            f"types row by row, P-mode GTA5 labels) written in {write_s:.2f} "
            f"s; decoded on 8 threads in {dec_s:.2f} s, {sum(same)} equal "
            "to the arrays written")
        require(all(same), "a fixture decodes to other pixels than written")
        del files
        argv = list(REAL_ARGV)
        for k, v in fixtures.roots(data).items():
            argv += [f"--{k}", v]
        run = lambda name: ["--run-root", os.path.join(root, name)]  # noqa: E731

        def train_check(key, trainer, launches, seconds, method):
            steps = trainer.state.step
            want = predicted(method, steps, fit_eval_forwards(trainer))
            rate = [v for _, v in read_scalars(
                trainer.saver.experiment_dir)["train/images_per_sec"]]
            require(trainer.method.name == method, f"{key}: {method}?")
            require(launches == want,
                    f"{key} launches {launches}, expected {want}")
            sc = read_scalars(trainer.saver.experiment_dir)
            loss = "seg_loss" if method == "output_adapt" else "task_loss"
            require(all(np.isfinite(v) for _, v in sc[f"train/{loss}"]),
                    f"{key} {loss}: {sc[f'train/{loss}']}")
            by_path[key] = launches
            trainer.writer = trainer.summary.create_summary()  # fit closed it
            wall, dev, idle = profiled_epoch(trainer, trainer.cfg.epochs)
            n_img = len(trainer.train_loader) * trainer.cfg.batch_size
            profiled[key] = (rate, n_img / wall, idle)
            log(f"[7 {key}] {steps} steps in {seconds:.1f} s, launches as "
                f"predicted; epoch images/s {', '.join(f'{v:.2f}' for v in rate)}"
                f"; a profiled epoch {n_img / wall:.2f} images/s, device "
                f"{dev:.3f} of {wall:.3f} s, idle {idle:.3f} ({smi})")
            trainer.saver.wait()
            trainer.writer.close()
            return rate

        # (a) train_adapt on the default host path, then val_adapt with the
        # per-image export from a checkpoint of its final state
        trainer, launches, sec = drive(counted, train_adapt.main,
                                       argv + run("a"))
        train_check("real_train_adapt", trainer, launches, sec,
                    "output_adapt")
        host["epoch"] = profiled["real_train_adapt"]
        loader = trainer.train_loader
        n_img = len(loader) * loader.batch_size
        for w in (4, 8):
            loader.num_workers = w
            t0 = time.perf_counter()
            for _ in loader:
                pass
            s = time.perf_counter() - t0
            host["loader"][w] = n_img / s
            log(f"[7 loader] host path alone, {w} workers: {n_img / s:.2f} "
                f"images/s ({n_img} GTA5 + Cityscapes pairs: decode, "
                f"scale-crop, blur) ({smi})")
        final = trainer.saver.save_checkpoint(trainer.state, 1,
                                              trainer.best_pred, False,
                                              filename="final.ckpt")
        trainer.saver.wait()
        out = os.path.join(root, "val_a")
        (miou, _), launches, sec = drive(
            counted, val_adapt.main,
            argv + run("a") + ["--resume", final, "--out-dir", out])
        n_val = REAL_FRAMES["n_val"] // ADAPT_BATCH
        require(launches == predicted("output_adapt", 0, 2 * n_val),
                f"real val_adapt launches {launches}")
        require(0.0 <= miou <= 1.0, f"real val_adapt mIoU {miou}")
        check_exports(os.path.join(out, "predictions"), REAL_FRAMES["n_val"],
                      True)
        by_path["real_val_adapt"] = launches
        log(f"[7 val_adapt] mIoU {miou:.6f}, {REAL_FRAMES['n_val']} "
            f"Cityscapes val pairs exported at 1280x640 in {sec:.1f} s")
        del trainer, loader

        # (b) --device-aug: GTA5-sized sources, Cityscapes-sized targets
        trainer, launches, sec = drive(
            counted, train_adapt.main, argv + run("b") + ["--device-aug"])
        batch = next(iter(trainer.train_loader))
        shapes = {k: tuple(batch[k].shape[1:3]) for k in ("src_image",
                                                         "tgt_image")}
        require(shapes == {"src_image": fixtures.GTA5_HW,
                           "tgt_image": fixtures.CITYSCAPES_HW},
                f"staged frames {shapes}")
        train_check("real_device_aug", trainer, launches, sec,
                    "output_adapt")
        del trainer, batch

        # (c) --data-cache, two epochs: the second decodes only the target
        # frames that the first did not draw (a random target a sample)
        trainer, launches, sec = drive(
            counted, train_adapt.main,
            argv + run("c") + ["--data-cache", "--epochs", "2"])
        ds = trainer.train_loader.dataset
        drawn = [{random.Random((trainer.cfg.seed, e, i).__hash__())
                  .randint(0, len(ds.targets) - 1) for i in range(len(ds))}
                 for e in range(2)]
        want_misses = 2 * len(ds) + len(drawn[0] | drawn[1])
        lookups = 2 * 3 * len(ds)
        log(f"[7 data-cache] {ds.cache.misses} decodes, {ds.cache.hits} hits "
            f"in 2 epochs ({lookups} lookups); epoch 2 decoded "
            f"{len(drawn[1] - drawn[0])} targets first drawn in it, no "
            f"source or label; {ds.cache.nbytes() / 2 ** 20:.0f} MiB held")
        require(ds.cache.misses == want_misses
                and ds.cache.hits == lookups - want_misses,
                f"data cache: {ds.cache.misses} decodes, expected "
                f"{want_misses}")
        train_check("real_data_cache", trainer, launches, sec,
                    "output_adapt")
        del trainer, ds

        # (d) train --dataset gtav (source-only), then test on its split
        gtav = argv + ["--dataset", "gtav", "--no-val-drop-last"]
        trainer, launches, sec = drive(counted, train.main, gtav + run("d"))
        train_check("real_train_gtav", trainer, launches, sec, "source_only")
        final = trainer.saver.save_checkpoint(trainer.state, 1,
                                              trainer.best_pred, False,
                                              filename="final.ckpt")
        trainer.saver.wait()
        names = [os.path.basename(p) for p in trainer.test_loader.dataset.files]
        del trainer
        out = os.path.join(root, "test_d")
        _, launches, sec = drive(counted, test.main, gtav + run("d") + [
            "--resume", final, "--out-dir", out])
        require(len(names) == REAL_TEST_BATCH
                and launches == predicted("source_only", 0, 1),
                f"real test launches {launches}, {names}")
        check_exports(out, REAL_TEST_BATCH, False)
        require(sorted(os.listdir(out)) == sorted(
            f"{n[:-4]}{t}.png" for n in names
            for t in ("_labelId", "_color")),
            f"test PNG names {sorted(os.listdir(out))}")
        by_path["real_test_gtav"] = launches
        log(f"[7 test] {len(names)} GTA5 test frames exported at 1280x640 "
            f"({', '.join(names)}) in {sec:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path


def checkpoint_phase(counted, smi, carry):
    """Phase 8: checkpoints in, frames out, from what phases 5 and 6d put
    in `carry`.  Returns the launches of each path it drives."""
    from s2r_tpu_torch.cli import export, infer, val, val_adapt
    from s2r_tpu_torch.cli._eval_common import (_TRAINID_TO_LABELID,
                                                EXPORT_SIZE)
    from s2r_tpu_torch.data import imaging
    from s2r_tpu_torch.data.palette import decode_segmap_u8
    from s2r_tpu_torch.io.checkpoint import (host_tree, load_checkpoint,
                                             save_jax_checkpoint)
    from s2r_tpu_torch.io.serving import load_servable, make_serving_fn
    from s2r_tpu_torch.tools import fixtures
    from s2r_tpu_torch.train.setup import build_method
    from s2r_tpu_torch.train.trainer import Trainer, resume_into

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_ckpt_")
    run = ["--run-root", os.path.join(root, "run")]
    by_path = {}
    try:
        # (a) phase 5's final output_adapt state, written in the JAX
        # package's format, read back, resumed with ft off for an epoch
        adapt, feat = carry["adapt"], carry["feature"]
        cfg = dataclasses.replace(adapt["cfg"], run_root=run[1],
                                  resume=adapt["ckpt"], ft=False)
        source = Trainer(cfg, method="output_adapt")
        live = host_tree(source.state)
        jpath = os.path.join(root, "adapt.ckpt")
        t0 = time.perf_counter()
        save_jax_checkpoint(jpath, source.state, cfg.epochs,
                            source.best_pred, seed=cfg.seed,
                            prng_impl=cfg.prng_impl)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        payload = load_checkpoint(jpath)
        read_s = time.perf_counter() - t0
        require(payload["format"] == "jax" and payload["epoch"] == cfg.epochs
                and trees_equal(payload["state"], live),
                "the JAX-format checkpoint reads back other than written")
        t0 = time.perf_counter()
        resumed = Trainer(dataclasses.replace(cfg, resume=jpath),
                          method="output_adapt")
        resume_s = time.perf_counter() - t0
        require(resumed.start_epoch == cfg.epochs
                and trees_equal(host_tree(resumed.state), live),
                "resume from the JAX-format checkpoint: the state differs")
        n_tr, n_val = len(resumed.train_loader), len(resumed.val_loader)
        vis_every = max(n_tr // 10, 1) if n_tr >= 10 else max(n_tr, 1)
        means, launches, epoch_s = drive(counted, resumed.training,
                                         resumed.start_epoch)
        resumed.saver.wait()
        resumed.writer.close()
        want = predicted("output_adapt", n_tr, len(range(0, n_tr, vis_every)))
        require(launches == want, f"resumed epoch launches {launches}, "
                f"expected {want}")
        require(all(np.isfinite(means[k]) for k in ("seg_loss", "adv_loss",
                                                    "d_loss")),
                f"resumed epoch losses {means}")
        by_path["resume_jax_ckpt"] = launches
        log(f"[8a JAX .ckpt] {os.path.getsize(jpath) / 2 ** 20:.1f} MiB "
            f"written in {write_s:.3f} s, read back in {read_s:.3f} s: "
            f"weights, statistics, optimizer buffers, step {live['step']} "
            f"and generator bit-equal; Trainer resumed (ft off) in "
            f"{resume_s:.2f} s, bit-equal, start_epoch {cfg.epochs}; one "
            f"epoch of {n_tr} steps in {epoch_s:.2f} s: seg_loss "
            f"{means['seg_loss']:.4f}, adv_loss {means['adv_loss']:.4f}, "
            f"d_loss {means['d_loss']:.4f}, launches as predicted ({smi})")
        del resumed

        # (b) cli.export --format torch, each schema; each file resumed
        # gives the source bit for bit, and its val mIoU is phase 5's / 6d's
        single = os.path.join(root, "single.pth.tar")
        four = os.path.join(root, "four.pth.tar")
        t0 = time.perf_counter()
        export.main(ADAPT_ARGV + run + ["--resume", jpath, "--out", single])
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        export.main(TRAIN_ARGV + run + ["--resume", feat["ckpt"], "--out",
                                        four, "--schema", "four",
                                        "--method", "feature_adapt"])
        four_s = time.perf_counter() - t0
        feature_src = build_method(cfg, 1, method="feature_adapt",
                                   device=DEV).init_state()
        resume_into(feature_src, feat["ckpt"], ft=False)
        for method, path, src in (("output_adapt", single, live),
                                  ("feature_adapt", four,
                                   host_tree(feature_src))):
            got = build_method(cfg, 1, method=method, device=DEV).init_state()
            resume_into(got, path, ft=False)
            got = host_tree(got)
            nets = ("G",) if method == "output_adapt" else ("G", "D")
            require(all(trees_equal(got[k], src[k]) for k in nets),
                    f"{os.path.basename(path)} resumed: {nets} differ from "
                    "the source")
        del feature_src, source
        (miou_s, _), launches, val_s = drive(
            counted, val_adapt.main, ADAPT_ARGV + run + [
                "--resume", single, "--skip-sep", "--out-dir",
                os.path.join(root, "val_single")])
        require(launches == predicted("output_adapt", 0, n_val),
                f"val_adapt of the .pth.tar: launches {launches}")
        by_path["val_pth_single"] = launches
        (miou_f, _), launches, val_f = drive(
            counted, val.main, TRAIN_ARGV + run + [
                "--resume", four, "--skip-sep", "--out-dir",
                os.path.join(root, "val_four")])
        require(launches == predicted("feature_adapt", 0, n_val),
                f"val of the .pth.tar: launches {launches}")
        by_path["val_pth_four"] = launches
        log(f"[8b export torch] single schema from the JAX .ckpt in "
            f"{single_s:.2f} s, four from phase 6d's in {four_s:.2f} s; "
            f"each resumed bit-equal (G; G and D); val_adapt mIoU "
            f"{miou_s:.6f} against phase 5's {adapt['miou']:.6f} "
            f"({val_s:.1f} s), val {miou_f:.6f} against phase 6d's "
            f"{feat['miou']:.6f} ({val_f:.1f} s)")
        require(abs(miou_s - adapt["miou"]) <= 1e-4
                and abs(miou_f - feat["miou"]) <= 1e-4,
                "the exported checkpoints validate to another mIoU")

        # (c) servables at full width, exact and decoder-int8
        serve_argv = ADAPT_ARGV + run + [
            "--resume", jpath, "--format", "servable", "--serve-shape",
            str(BATCH), str(FULL_HW[0]), str(FULL_HW[1]), "--serve-input",
            "rgb8"]
        servables = {"exact": os.path.join(root, "exact.s2rt"),
                     "int8": os.path.join(root, "int8.s2rt")}
        t0 = time.perf_counter()
        export.main(serve_argv + ["--out", servables["exact"]])
        exact_s = time.perf_counter() - t0
        info, launches, int8_s = drive(
            counted, export.main, serve_argv + [
                "--out", servables["int8"], "--serve-quant", "decoder-int8"])
        calib = min(4, n_val)  # --calib-batches 4 of the val loader
        require(launches == predicted("output_adapt", 0, calib)
                and info["quant"] == "decoder_int8",
                f"int8 export: launches {launches}, {info['quant']}")
        by_path["export_int8_calibration"] = launches
        log(f"[8c export servable] {BATCH}x{FULL_HW[0]}x{FULL_HW[1]} rgb8: "
            f"exact in {exact_s:.2f} s, decoder-int8 in {int8_s:.2f} s "
            f"(calibrated on {calib} synthetic val batches: "
            f"{info['quant_scales']}), "
            f"{os.path.getsize(servables['exact']) / 2 ** 20:.1f} MiB")

        # (d) cli.infer over 24 full-size frames, three batches (kept in
        # carry['frames'] for phase 9d)
        frames = carry["frames"] = os.path.join(carry["dir"], "frames")
        t0 = time.perf_counter()
        fixtures.write_fixtures(frames, **INFER_FRAMES)
        shutil.rmtree(os.path.join(frames, "gta5", "labels"))
        fx_s = time.perf_counter() - t0
        log(f"[8d fixtures] {INFER_FRAMES['n_city']} Cityscapes-sized and "
            f"{INFER_FRAMES['n_gta']} GTA5-sized frames written in "
            f"{fx_s:.2f} s")
        paths = infer.list_frames(frames)
        n_frames = INFER_FRAMES["n_gta"] + INFER_FRAMES["n_city"]
        n_batches = -(-n_frames // BATCH)
        require(len(paths) == n_frames, f"{len(paths)} frames")
        workers = os.cpu_count() or 1
        for mode, path in servables.items():
            out = os.path.join(root, f"infer_{mode}")
            res, launches, _ = drive(
                counted, lambda a: infer.main(a, keep_predictions=True),
                ["--servable", path, "--images", frames, "--out-dir", out])
            want = dict.fromkeys(launches, 0)
            want.update(depthwise_conv3x3=14 * n_batches,
                        requant_s32_to_s8=n_batches if mode == "int8" else 0)
            require(res["images"] == n_frames and launches == want,
                    f"infer {mode}: {res['images']} images, launches "
                    f"{launches}, expected {want}")
            by_path[f"infer_{mode}"] = launches
            serve = load_servable(path, DEV)
            fn = make_serving_fn(serve.model, input="rgb8",
                                 quant=serve.meta["quant"],
                                 quant_scales=serve.meta["quant_scales"])
            for i in range(0, n_frames, BATCH):
                chunk = paths[i:i + BATCH]
                batch = np.stack([infer.decode_frame(p, *FULL_HW, "rgb8")
                                  for p in chunk])
                labels = fn(torch.from_numpy(batch)).cpu().numpy()
                require(all(np.array_equal(res["predictions"][p], labels[j])
                            for j, p in enumerate(chunk)),
                        f"infer {mode}: labels differ from make_serving_fn "
                        "on the same frames")
            for p in paths:
                pred = res["predictions"][p]
                stem = os.path.join(out, os.path.basename(p)[:-4])
                gray = imaging.resize_nearest(
                    _TRAINID_TO_LABELID[pred.astype(np.uint8)], EXPORT_SIZE)
                color = imaging.resize_nearest(
                    decode_segmap_u8(pred, "cityscapes"), EXPORT_SIZE)
                require(np.array_equal(imaging.load_raw(
                    stem + "_labelId.png"), gray) and np.array_equal(
                    imaging.load_rgb(stem + "_color.png"), color),
                    f"infer {mode}: {stem} PNGs decode to other labels")
            del serve, fn, res["predictions"]
            sec = res["seconds"]
            per = {"decode": 1e3 * sec["decode"] / n_frames / workers,
                   "device": 1e3 * sec["device"] / n_frames,
                   "save": 1e3 * sec["save"] / n_frames / 2}
            later = res["device_batches"][1:]
            dev_later = 1e3 * sum(later) / max(1, len(later) * BATCH)
            log(f"[8d infer {mode}] {n_frames} frames (16 Cityscapes-sized, "
                f"8 GTA5-sized resized on the host) in {n_batches} batches "
                f"of {BATCH}: {res['ms_per_image']:.3f} ms/image including "
                f"host IO, steady-state {res['steady_ms_per_image']:.3f} "
                f"after batch 0 (wall {res['wall']:.3f} s, unprofiled); per "
                f"image, summed over threads: decode+resize "
                f"{1e3 * sec['decode'] / n_frames:.3f} ms ({workers} "
                f"threads), device {1e3 * sec['device'] / n_frames:.3f} ms "
                f"(H2D + forward + D2H; {dev_later:.3f} after batch 0), "
                f"save {1e3 * sec['save'] / n_frames:.3f}"
                f" ms (2 threads); per image of wall by stage "
                + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
                + f": paced by {max(per, key=per.get)}; labels equal to "
                f"make_serving_fn, every PNG as _save_prediction maps it, "
                f"launches as predicted ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path


def check_xception_depthwise(dw):
    """Phase 9a (depthwise): the forward, dx and dk kernels at Xception's
    stride-1 depthwise shapes against their plain versions, at phase 2's
    tolerances: the 512x1024 batch-8 train cell (forward, dx, dk), the
    2048x1024 batch-8 serving forward, and 513x513 batch 1 at output
    stride 16 (33x33 at dilation 2) and 8 (65x65 at dilation 4).  Times
    (bf16) each train and serving shape's kernels against cuDNN.  Returns
    {'serve': per_shape rows of the forward, 'train_step': forward + dx
    rows, 'dk': dk rows} (ms, library_ms and bound_ms a launch) and the
    totals of one forward, one step's forward + dx, and one step's dk."""
    import torch.nn.functional as F

    serve = layer_shapes(FULL_HW, "xception")[0]
    train = layer_shapes(TRAIN_HW, "xception")[0]
    s16 = layer_shapes(CHECK_HW, "xception")[0]
    s8 = layer_shapes(CHECK_HW, "xception", 8)[0]
    require(len(serve) == len(train) == len(s16) == 56 and len(s8) == 57,
            f"xception stride-1 depthwise convs: {len(serve)}, {len(train)}, "
            f"{len(s16)}, {len(s8)} (os 8)")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    rows = {"serve": [], "train_step": [], "dk": []}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    log("[9a depthwise] N C H W d: bf16 ms kernel / cuDNN (forward; "
        "forward + dx; dk)")
    for path, shapes in (("serve", serve), ("train_step", train)):
        for c, h, w, d in sorted(set(shapes)):
            count = shapes.count((c, h, w, d))
            for dtype in (torch.float32, torch.bfloat16):
                x = randn((BATCH, h, w, c), dtype, gen)
                k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
                worst[dtype] = max(worst[dtype], dw_check(dw, x, k, d))
                g = kf = None
                if path == "train_step":
                    g = randn((BATCH, h, w, c), dtype, gen)
                    kf = k.flip((0, 1)).contiguous()
                    worst[dtype] = max(worst[dtype], dw_check(dw, g, kf, d))
                    dk_check(dw, x, g, d)
                if dtype == torch.float32:
                    del x, k, g, kf
                    continue
                xv = x.permute(0, 3, 1, 2)
                wt = k.permute(2, 0, 1).unsqueeze(1)
                isz = x.element_size()
                fwd = (cuda_ms(lambda: dw.depthwise_conv3x3(x, k, d)),
                       cuda_ms(lambda: F.conv2d(xv, wt, padding=d, dilation=d,
                                                groups=c)))
                bnd, _ = bound_ms(2 * x.numel() * isz + k.numel() * isz,
                                  18 * x.numel(), dtype)
                row = {"C": c, "H": h, "W": w, "d": d, "ms": fwd[0],
                       "library_ms": fwd[1], "bound_ms": bnd}
                if path == "serve":
                    rows["serve"].append(dict(row, launches=count))
                    log(f"[9a depthwise] {BATCH} {c} {h} {w} {d} x{count} "
                        f"serve: {fwd[0]:.4f} / {fwd[1]:.4f}")
                    del x, k, xv
                    continue
                # forward on x and dx on g: the kernel's two launches a
                # layer, for the source and target forwards
                gv = g.permute(0, 3, 1, 2)
                wtf = kf.permute(2, 0, 1).unsqueeze(1)
                dx = (cuda_ms(lambda: dw.depthwise_conv3x3(g, kf, d)),
                      cuda_ms(lambda: F.conv2d(gv, wtf, padding=d,
                                               dilation=d, groups=c)))
                dk = (cuda_ms(lambda: dw.depthwise_dk(x, g, d)),
                      cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                          xv, (c, 1, 3, 3), gv, padding=d, dilation=d,
                          groups=c)))
                dk_bnd, _ = bound_ms(2 * x.numel() * isz + 9 * c * 4,
                                     18 * x.numel(), dtype)
                rows["train_step"].append(dict(
                    row, launches=4 * count, ms=(fwd[0] + dx[0]) / 2,
                    library_ms=(fwd[1] + dx[1]) / 2))
                rows["dk"].append({"C": c, "H": h, "W": w, "d": d,
                                   "launches": 2 * count, "ms": dk[0],
                                   "library_ms": dk[1], "bound_ms": dk_bnd})
                log(f"[9a depthwise] {BATCH} {c} {h} {w} {d} x{count} train: "
                    f"{fwd[0] + dx[0]:.4f} / {fwd[1] + dx[1]:.4f}; dk "
                    f"{dk[0]:.4f} / {dk[1]:.4f}")
                del x, k, xv, g, kf, gv
    for c, h, w, d in sorted(set(s16) | set(s8)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((1, h, w, c), dtype, gen)
            g = randn((1, h, w, c), dtype, gen)
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            worst[dtype] = max(worst[dtype], dw_check(dw, x, k, d),
                               dw_check(dw, g, k.flip((0, 1)).contiguous(),
                                        d))
            dk_check(dw, x, g, d)
    totals = {p: {key: sum(r[key] * r["launches"] for r in rs)
                  for key in ("ms", "library_ms", "bound_ms")}
              for p, rs in rows.items()}
    log(f"[9a depthwise] Xception's shapes pass (forward, dx, dk; "
        f"{len(set(s16) | set(s8))} 513x513 shapes at os 16 and 8); worst "
        f"max_abs_err f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g}; one 2048x1024 batch-8 forward (56 "
        f"launches) {totals['serve']['ms']:.3f} ms, cuDNN "
        f"{totals['serve']['library_ms']:.3f}; one 512x1024 batch-8 step: "
        f"forward + dx (224) {totals['train_step']['ms']:.3f}, cuDNN "
        f"{totals['train_step']['library_ms']:.3f}, dk (112) "
        f"{totals['dk']['ms']:.3f}, cuDNN {totals['dk']['library_ms']:.3f}; "
        f"slower than cuDNN at {slower(rows['serve'])} / "
        f"{slower(rows['train_step'])} / {slower(rows['dk'])} of "
        f"{len(rows['serve'])} / {len(rows['train_step'])} / "
        f"{len(rows['dk'])} shapes")
    return rows, totals


def backbones_phase(counted, smi, dw, rq, carry):
    """Phase 9: the other backbones.  (b) serving, (c) the train steps, (d)
    the train_adapt driver on Xception with a JAX-format checkpoint, a
    servable and cli.infer.  Returns the launches of each path it drives
    and a summary of its numbers."""
    from s2r_tpu_torch.cli import export, infer, train_adapt
    from s2r_tpu_torch.io.checkpoint import (host_tree, load_checkpoint,
                                             save_jax_checkpoint)
    from s2r_tpu_torch.io.serving import load_servable, make_serving_fn

    by_path, summary = {}, {}
    # (b) serving.  DRN's call takes ~3.2 s a batch (its ASPP's dilated
    # convs at os 8 run cuDNN's grouped direct kernel; PERF.md §5), so it
    # is timed over fewer calls, and its eval-BatchNorm share is not taken
    for b in SERVE_BACKBONES:
        serve_check_513(dw, rq, b)
        torch.cuda.empty_cache()
        depth = dict(timed=2, warmup=1) if b == "drn" else {}
        ms, launches, peak, share = serve_full(counted, b, bn_share=b != "drn",
                                               **depth)
        by_path[f"serve_{b}"] = launches
        summary[f"serve_{b}"] = dict(ms, peak_gib=peak, eval_bn_share=share)
        torch.cuda.empty_cache()
    # (c) the output step of each backbone, the small float32 checks, and
    # the feature step on Xception
    for b in STEP_BACKBONES:
        ms, runs, peak, values, launches, copies = time_step(
            "output_adapt", counted, TRAIN_HW, BATCH, backbone=b)
        log(f"[9c {b} train {TRAIN_HW[1]}x{TRAIN_HW[0]}] {ms:.3f} ms/step "
            f"(median of 5 batch-{BATCH} bf16 steps: "
            f"{', '.join(f'{r:.3f}' for r in runs)}), "
            f"{BATCH * 1e3 / ms:.2f} source images/s, peak device memory "
            f"{peak:.2f} GiB; losses after 7 steps {values}; launches in "
            f"one step {launches} (as predicted); BatchNorm layout copies "
            f"{copies}")
        by_path[f"train_step_{b}"] = launches
        summary[f"train_step_{b}"] = {"ms": ms, "peak_gib": peak}
        torch.cuda.empty_cache()
    for b in CHECK_BACKBONES:
        train_check_small(counted, b, BACKBONE_CHECK_HW)
        torch.cuda.empty_cache()
    ms, runs, peak, values, launches, _ = time_step(
        "feature_adapt", counted, TRAIN_HW, BATCH, backbone="xception",
        epochs=200)
    log(f"[9c xception feature_adapt {TRAIN_HW[1]}x{TRAIN_HW[0]}] {ms:.3f} "
        f"ms/step (median of 5: {', '.join(f'{r:.3f}' for r in runs)}), "
        f"peak device memory {peak:.2f} GiB; metrics {values}; launches "
        f"{launches} (as predicted)")
    by_path["feature_step_xception"] = launches
    summary["feature_step_xception"] = {"ms": ms, "peak_gib": peak}
    torch.cuda.empty_cache()

    # (d) train_adapt --backbone xception for one epoch, its state in the
    # JAX format, a servable of it, and cli.infer over phase 8's frames
    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_backbone_")
    try:
        argv = TRAIN_ARGV + ["--backbone", "xception", "--run-root", root]
        trainer, launches, fit_s = drive(counted, train_adapt.main, argv)
        steps, n_tr = trainer.state.step, len(trainer.train_loader)
        want = predicted("output_adapt", steps, fit_eval_forwards(trainer),
                         "xception")
        require(steps == n_tr and launches == want,
                f"9d train_adapt xception: {steps} steps, launches "
                f"{launches}, expected {want}")
        by_path["train_adapt_xception"] = launches
        sc = read_scalars(trainer.saver.experiment_dir)
        require(all(np.isfinite(v) for _, v in sc["train/seg_loss"])
                and all(0.0 <= v <= 1.0 for _, v in sc["val/mIoU"]),
                f"9d train_adapt xception: {sc['train/seg_loss']}, "
                f"{sc['val/mIoU']}")
        cfg = trainer.cfg
        live = host_tree(trainer.state)
        jpath = os.path.join(root, "xception.ckpt")
        save_jax_checkpoint(jpath, trainer.state, 1, trainer.best_pred,
                            seed=cfg.seed, prng_impl=cfg.prng_impl)
        payload = load_checkpoint(jpath, "xception")
        require(payload["format"] == "jax"
                and trees_equal(payload["state"], live),
                "9d: the Xception JAX-format checkpoint reads back other "
                "than written")
        log(f"[9d train_adapt xception] one epoch of {n_tr} steps and "
            f"{len(trainer.val_loader)} validation batches in {fit_s:.1f} s, "
            f"epoch {sc['train/images_per_sec'][0][1]:.2f} images/s, "
            f"seg_loss {sc['train/seg_loss'][0][1]:.4f}, val mIoU "
            f"{sc['val/mIoU'][0][1]:.4f}; launches {launches} (as "
            f"predicted); its state as a JAX .ckpt "
            f"({os.path.getsize(jpath) / 2 ** 20:.1f} MiB) read back "
            "bit-equal")
        trainer.saver.wait()
        trainer.writer.close()
        del trainer, payload, live

        servable = os.path.join(root, "xception.s2rt")
        export.main(argv + ["--resume", jpath, "--format", "servable",
                            "--serve-shape", str(BATCH), str(FULL_HW[0]),
                            str(FULL_HW[1]), "--serve-input", "rgb8",
                            "--out", servable])
        frames = carry["frames"]
        paths = infer.list_frames(frames)
        n_batches = -(-len(paths) // BATCH)
        res, launches, _ = drive(
            counted, lambda a: infer.main(a, keep_predictions=True),
            ["--servable", servable, "--images", frames, "--out-dir",
             os.path.join(root, "infer")])
        want = dict.fromkeys(launches, 0)
        want.update(depthwise_conv3x3=56 * n_batches)
        require(res["images"] == len(paths) and launches == want,
                f"9d infer xception: {res['images']} images, launches "
                f"{launches}, expected {want}")
        by_path["infer_xception"] = launches
        serve = load_servable(servable, DEV)
        require(serve.meta["backbone"] == "xception"
                and serve.model.backbone_name == "xception",
                f"9d servable meta {serve.meta['backbone']}")
        fn = make_serving_fn(serve.model, input="rgb8")
        for i in range(0, len(paths), BATCH):
            chunk = paths[i:i + BATCH]
            batch = np.stack([infer.decode_frame(p, *FULL_HW, "rgb8")
                              for p in chunk])
            labels = fn(torch.from_numpy(batch)).cpu().numpy()
            require(all(np.array_equal(res["predictions"][p], labels[j])
                        for j, p in enumerate(chunk)),
                    "9d infer xception: labels differ from make_serving_fn "
                    "on the same frames")
        log(f"[9d infer xception] {len(paths)} frames in {n_batches} "
            f"batches: {res['ms_per_image']:.3f} ms/image including host "
            f"IO; labels equal to make_serving_fn; launches as predicted "
            f"({smi})")
        summary["infer_xception_ms_per_image"] = res["ms_per_image"]
        del serve, fn, res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path, summary


# phase 10: data-parallel training (two ranks on the one card under gloo;
# one NCCL rank) and the model's --split-concat and --logits-dtype
DIST_WORLD = 2
DIST_CHECK_HW, DIST_CHECK_BATCH, DIST_STEPS = (256, 512), 4, 2
# all-reduces of a rank's output step: 120 BatchNorm sums each way, the
# batch-axis softmax of the target (max and sum, and one in its backward)
# and of the source (max and sum), the CE normalizer, the count of D's
# real outputs (the BCE means' normalizer), the gradients, the logged
# losses
DIST_COLLECTIVES = 249


def check_split_batchnorm(bn):
    """Phase 10a: the split entries of synchronized BatchNorm at phase 2d's
    BatchNorm input shapes of the train cell, at a rank's share of its
    batch (BATCH / DIST_WORLD), float32 and bfloat16.  On all rows,
    batch_norm_sums + batch_norm_finish_apply give y, the five statistics
    rows and the running statistics bit-equal to the fused
    batch_norm_stats + batch_norm_apply, and batch_norm_grad_sums_local +
    batch_norm_grad_finish the rows of the fused batch_norm_grad_sums
    (required).  Two row halves' sums, added, then finished (the cotangent
    of shift split between the halves, each half's added once) against
    the fused entries on all rows (y bit-equal to batch_norm_apply on the
    halves' own rows: one bf16 rounding of y may flip where the rows
    differ in their last bit), and each entry against its plain
    version on the same inputs: tolerances as phase 2d.  Times (bf16) each
    entry, its plain version, one PyTorch call or pair for the same work
    (batch_norm_stats; gather_stats_with_counts + batch_norm_elemt, what
    SyncBatchNorm runs; batch_norm_backward_reduce; none for the backward
    finish) and the one-card entry on the same rows (batch_norm_stats,
    batch_norm_apply, batch_norm_grad_sums) by CUDA events (the kernel,
    the library and the one-card entry in turns, three rounds, the median
    of each), and those three also by the card's time and the host's a
    call (tools/profile_bn_split.py split_times), with each entry's
    bound.  Returns the four entries for one rank's
    step (60 BatchNorms x (src, tgt) = 120 calls each)."""
    from collections import Counter

    from s2r_tpu_torch.tools.profile_bn_split import split_times

    counts = Counter(bn_input_shapes(TRAIN_HW))
    n = BATCH // DIST_WORLD
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    names = _BN_SPLIT
    sides = ("", "library_", "fused_")
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "fused_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                  **{f"{p}{t}": 0.0 for p in sides
                     for t in ("device_ms", "host_ms")}}
              for k in names}
    device_by = set()
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    eps, mom = 1e-5, 0.1
    log("[10a split batchnorm] N C H W x count: worst rel err f32, bf16 | "
        "bf16 ms kernel/plain/library/fused, then device ms and host us a "
        "call of kernel/library/fused: sums, finish_apply, "
        "grad_sums_local, grad_finish")
    for (c, h, w), mult in sorted(counts.items()):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            where = f"10a split batchnorm {(n, c, h, w)} {dtype}"
            x4 = randn((n, h, w, c), dtype, gen)
            x, g = x4.view(-1, c), randn((n, h, w, c), dtype, gen).view(-1, c)
            weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
            bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
            gshift = torch.randn(c, device=DEV, generator=gen)
            gs_b = torch.randn(c, device=DEV, generator=gen)
            gs_a = gshift - gs_b
            rm0 = 0.1 * torch.randn(c, device=DEV, generator=gen)
            rv0 = 0.5 + torch.rand(c, device=DEV, generator=gen)
            count = n * (h + 2) * (w + 2)  # a ring of 1
            half = x.shape[0] // 2
            run = {k: (rm0.clone(), rv0.clone()) for k in ("f", "s", "h")}
            st = bn.batch_norm_stats(x, weight, bias, count, eps,
                                     *run["f"], mom)
            y_f = bn.batch_norm_apply(x, st[bn.INV], st[bn.SHIFT])
            gr = bn.batch_norm_grad_sums(g, x, st, gshift, count)
            want_g = gr.clone()
            want_g[bn.SUM_G] = gr[bn.DBIAS]  # G: sum g with d(shift)
            # split, all rows
            sums = bn.batch_norm_sums(x)
            sums_in = sums.clone()
            y1 = bn.batch_norm_finish_apply(x, sums, weight, bias, count, eps,
                                            *run["s"], mom)
            local = bn.batch_norm_grad_sums_local(g, x, st, gshift)
            local_in = local.clone()
            l1 = bn.batch_norm_grad_finish(local, st, count)
            # two halves, summed between the calls
            sa = bn.batch_norm_sums(x[:half])
            sa[:2] += bn.batch_norm_sums(x[half:])[:2]
            y2 = bn.batch_norm_finish_apply(x, sa, weight, bias, count, eps,
                                            *run["h"], mom)
            la = bn.batch_norm_grad_sums_local(g[:half], x[:half], st, gs_a)
            lb = bn.batch_norm_grad_sums_local(g[half:], x[half:], st, gs_b)
            shares = la[bn.DWEIGHT:bn.DBIAS + 1] + lb[bn.DWEIGHT:bn.DBIAS + 1]
            la[:2] += lb[:2]
            l2 = bn.batch_norm_grad_finish(la, st, count)
            # the plain versions: the rows from the reduced sums; y from the
            # kernel's own rows (as phase 2d holds apply), since one bf16
            # rounding of y flips where the rows differ in their last bit
            sums_p = sums_in.clone()
            bn.batch_norm_finish_apply_plain(x, sums_p, weight, bias, count,
                                             eps)
            y_p = bn.batch_norm_apply_plain(x, sums[bn.INV], sums[bn.SHIFT])
            torch.cuda.synchronize()
            require(torch.equal(y1, y_f) and torch.equal(sums, st)
                    and all(torch.equal(u, v)
                            for u, v in zip(run["s"], run["f"])),
                    f"{where}: sums + finish_apply not bit-equal to the "
                    "fused stats + apply (y, rows, running statistics)")
            require(torch.equal(y2, bn.batch_norm_apply(x, sa[bn.INV],
                                                        sa[bn.SHIFT])),
                    f"{where}: the halves' finish_apply y is not apply's on "
                    "its own rows")
            require(torch.equal(local_in[:bn.DBIAS + 1],
                                want_g[:bn.DBIAS + 1])
                    and torch.equal(l1, want_g),
                    f"{where}: grad_sums_local (+ grad_finish) rows not "
                    "bit-equal to the fused grad_sums'")
            plain = {
                "batch_norm_sums": (sums_in[:2],
                                    bn.batch_norm_sums_plain(x)[:2]),
                "batch_norm_finish_apply": (sums, sums_p),
                "finish_apply y": (y1.view(1, -1), y_p.view(1, -1)),
                "batch_norm_grad_sums_local": (
                    local_in[:4],
                    bn.batch_norm_grad_sums_local_plain(g, x, st,
                                                        gshift)[:4]),
                "batch_norm_grad_finish": (l1, bn.batch_norm_grad_finish_plain(
                    local_in, st, count))}
            e = {"halves": max(bn_rel(sa, st)),
                 "running": max(bn_rel(torch.stack([*run["h"]]),
                                       torch.stack([*run["f"]]))),
                 "grad halves": max(bn_rel(
                     l2[[bn.SUM_G, bn.SUM_GX, bn.COEF_B, bn.COEF_C0]],
                     want_g[[bn.SUM_G, bn.SUM_GX, bn.COEF_B, bn.COEF_C0]])),
                 "grad shares": max(bn_rel(shares,
                                           gr[bn.DWEIGHT:bn.DBIAS + 1])),
                 **{k: max(bn_rel(u, v)) for k, (u, v) in plain.items()}}
            require(max(e.values()) <= tol, f"{where}: rel errs {e} > {tol}")
            errs[dtype] = max(e.values())
            worst[dtype] = max(worst[dtype], errs[dtype])
            if dtype != torch.bfloat16:
                continue
            for k, (u, v) in plain.items():
                k = "batch_norm_finish_apply" if k == "finish_apply y" else k
                totals[k]["max_abs_err"] = max(
                    totals[k]["max_abs_err"],
                    float((u.float() - v.float()).abs().max()))
            isz = x.element_size()
            mc = x.numel()
            mean, invstd = st[bn.MEAN], st[bn.RSTD]
            mean2 = torch.stack([mean, mean])
            invstd2 = torch.stack([invstd, invstd])
            cnt2 = torch.full((2,), count / 2, device=DEV)
            rm, rv = rm0.clone(), rv0.clone()
            x4n = x4.permute(0, 3, 1, 2)
            g4n = g.view(n, h, w, c).permute(0, 3, 1, 2)

            def gather_elemt():
                m_, i_ = torch.batch_norm_gather_stats_with_counts(
                    x4n, mean2, invstd2, rm, rv, mom, eps, cnt2)
                torch.batch_norm_elemt(x4n, weight, bias, m_, i_, eps)

            # (kernel, plain, library, one-card entry) of each entry
            fns = {
                "batch_norm_sums": (
                    lambda: bn.batch_norm_sums(x),
                    lambda: bn.batch_norm_sums_plain(x),
                    lambda: torch.batch_norm_stats(x4n, eps),
                    lambda: bn.batch_norm_stats(x, weight, bias, count, eps,
                                                rm, rv, mom)),
                "batch_norm_finish_apply": (
                    lambda: bn.batch_norm_finish_apply(
                        x, sums, weight, bias, count, eps, rm, rv, mom),
                    lambda: bn.batch_norm_finish_apply_plain(
                        x, sums_p, weight, bias, count, eps, rm, rv, mom),
                    gather_elemt,
                    lambda: bn.batch_norm_apply(x, st[bn.INV],
                                                st[bn.SHIFT])),
                "batch_norm_grad_sums_local": (
                    lambda: bn.batch_norm_grad_sums_local(g, x, st, gshift),
                    lambda: bn.batch_norm_grad_sums_local_plain(g, x, st,
                                                                gshift),
                    lambda: torch.batch_norm_backward_reduce(
                        g4n, x4n, mean, invstd, weight, True, True, True),
                    lambda: bn.batch_norm_grad_sums(g, x, st, gshift,
                                                    count)),
                "batch_norm_grad_finish": (
                    lambda: bn.batch_norm_grad_finish(local, st, count),
                    lambda: bn.batch_norm_grad_finish_plain(local_in, st,
                                                            count),
                    None, None)}
            # bytes (each input read once, each output written once; the
            # per-channel rows float32) and flops of each entry
            work = {"batch_norm_sums": (mc * isz + 8 * c, 3 * mc),
                    "batch_norm_finish_apply": (2 * mc * isz + 52 * c,
                                                2 * mc + 15 * c),
                    "batch_norm_grad_sums_local": (2 * mc * isz + 28 * c,
                                                   3 * mc),
                    "batch_norm_grad_finish": (28 * c, 10 * c)}
            k2 = 2 * mult  # src and tgt
            row, split = [], []
            for name in names:
                kern, pl, lib, fused = fns[name]
                # kernel, library and one-card entry in turns, three rounds
                # (order rotating), each the median of its three
                turns = [f for f in (kern, lib, fused) if f is not None]
                runs = {id(f): [] for f in turns}
                for r in range(3):
                    for f in turns[r % len(turns):] + turns[:r % len(turns)]:
                        runs[id(f)].append(cuda_ms(f))
                ms = [None if f is None else
                      cuda_ms(f) if f is pl else statistics.median(runs[id(f)])
                      for f in (kern, pl, lib, fused)]
                bnd, bnd_by = bound_ms(*work[name], torch.float32)
                tot = totals[name]
                tot["bound_by"] = bnd_by
                tot["bound_ms"] += k2 * bnd
                for key, v in zip(("ms", "plain_ms", "library_ms",
                                   "fused_ms"), ms):
                    if v is not None:
                        tot[key] += k2 * v
                cells = []
                for prefix, f in zip(sides, (kern, lib, fused)):
                    if f is None:
                        cells.append("-")
                        continue
                    t = split_times(f)
                    device_by.add(t["device_by"])
                    tot[prefix + "device_ms"] += k2 * t["device_ms"]
                    tot[prefix + "host_ms"] += k2 * t["host_us"] / 1e3
                    cells.append(f"{t['device_ms']:.4f}/{t['host_us']:.1f}")
                row.append("/".join("-" if v is None else f"{v:.4f}"
                                    for v in ms))
                split.append(" ".join(cells))
            log(f"[10a split batchnorm] {n} {c} {h} {w} x{mult}: "
                f"{errs[torch.float32]:.3g}, {errs[torch.bfloat16]:.3g} | "
                + " ".join(row) + " | " + "; ".join(split))
            del fns
    calls = 2 * sum(counts.values())
    entries = []
    for name in names:
        tot = totals[name]
        has_lib = name != "batch_norm_grad_finish"
        entry = {
            "name": name, "route": "cuda",
            "source": "s2r_tpu_torch/csrc/batchnorm.cu",
            "replaces": ("s2r_tpu/ops/pallas/batchnorm.py:77"
                         if name in ("batch_norm_sums",
                                     "batch_norm_grad_sums_local")
                         else "s2r_tpu/ops/pallas/batchnorm.py:111"),
            "launches": None, "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"] if has_lib else None,
            "fused_ms": tot["fused_ms"] if has_lib else None}
        for prefix in sides:
            if prefix and not has_lib:
                continue
            entry[prefix + "device_ms"] = tot[prefix + "device_ms"]
            entry[prefix + "host_us"] = 1e3 * tot[prefix + "host_ms"] / calls
        entry["ms_covers"] = (
            f"a rank's output step at world {DIST_WORLD} ({TRAIN_HW[1]}x"
            f"{TRAIN_HW[0]}, {n} a rank, bf16): {calls} calls; device_ms by "
            f"{'/'.join(sorted(device_by))}; host_us a call; library and "
            "fused: phase 10a")
        entries.append(entry)
    log(f"[10a split batchnorm] all checks passed at {len(counts)} shapes "
        f"(batch {n}); worst rel err f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g}; sums + finish_apply and "
        "grad_sums_local + grad_finish on all rows bit-equal to the fused "
        f"entries; one rank's step ({calls} calls each, bf16; device ms by "
        f"{'/'.join(sorted(device_by))}): "
        + "; ".join(f"{e['name']} {e['ms']:.3f} ms (device "
                    f"{e['device_ms']:.3f}, host {e['host_us']:.1f} us a "
                    f"call; plain {e['plain_ms']:.3f}, library "
                    f"{e['library_ms']}, fused {e['fused_ms']}, bound "
                    f"{e['bound_ms']:.4f})" for e in entries))
    return entries


def _leaf_updates(snaps, net):
    """{leaf: after - before} of a steps task's snapshots (float64)."""
    before, after = snaps[0][net], snaps[-1][net]
    return {k: after[k].double() - before[k].double() for k in after
            if after[k].is_floating_point()
            and not k.endswith(("running_mean", "running_var"))}


def against_one_process(tag, got_all, ref, cpu, loss_spread=False,
                        spread_first=False,
                        losses=("seg_loss", "adv_loss", "d_loss")):
    """A steps task of every rank (`got_all`, by rank) against one process
    on the card (`ref`) and on the CPU (`cpu`) at the whole batch: every
    rank's state bit-equal; losses rel 1e-5 at the first step and 1e-4
    after (tests/test_steps.py:85's bound for the JAX package's sharded
    step), or with `loss_spread` after the first step 3x the loss's
    float32 spread if larger (one process on the card against the CPU, as
    G's leaves are bounded: D's first Adam step moves each weight by the
    learning rate times the sign of its gradient, so float32 rounding
    alone flips a few and moves the next step's losses by ~1e-4); G's
    update per leaf within LEAF_BOUND (relative L2) or 3x the
    leaf's float32 spread (the one-process step on the card against the
    CPU); D's update of the same sign on >= 99% of elements (phase 4a's
    bounds); the BatchNorm running statistics within 1e-3 of each layer's
    largest.  With `spread_first` (a bfloat16 run, `cpu` then one process
    in float32 on the card) the spread bounds the first step's losses too,
    and the statistics within 3x their spread if larger.  Returns ({leaf:
    (rel err, spread)}, the worst leaf, D's sign agreement, G's worst leaf
    after the steps, the statistics' error)."""
    got = got_all[0]
    require(all(r["ranks_equal"] for r in got_all),
            f"{tag}: the ranks' states differ")
    for i in range(len(ref["metrics"])):
        # step 0 starts from one state; later steps also carry the first
        # step's float32 rounding
        for k in losses:
            a, b = got["metrics"][i][k], ref["metrics"][i][k]
            tol = 1e-5 if i == 0 else 1e-4
            if (i or spread_first) and loss_spread:
                tol = max(tol, 3 * abs(cpu["metrics"][i][k] - b) / abs(b))
            require(np.isfinite(a) and abs(a - b) <= tol * abs(b),
                    f"{tag} step {i} {k}: {len(got_all)} ranks {a}, one "
                    f"process {b} (CPU {cpu['metrics'][i][k]}), rel bound "
                    f"{tol:.3g}")

    def rel(a, b):
        den = float(b.norm())
        return float((a - b).norm()) / den if den else float(a.norm())

    gu, wu, cu = (_leaf_updates(r["snapshots"], "G") for r in (got, ref, cpu))
    # G per leaf, as phase 4a bounds the card against float64: within
    # LEAF_BOUND of one process, or 3x that leaf's float32 spread (one
    # process on the card against one on the CPU) if larger
    leaf = {k: (rel(gu[k], wu[k]), rel(cu[k], wu[k])) for k in wu}
    bad = {k: v for k, v in leaf.items() if v[0] > max(LEAF_BOUND, 3 * v[1])}
    worst = max(leaf, key=lambda k: leaf[k][0])
    require(not bad, f"{tag} G update per leaf off one process: {bad}")
    d_got, d_ref = (torch.cat([v.reshape(-1) for v in _leaf_updates(
        r["snapshots"], "D").values()]) for r in (got, ref))
    sign = float((torch.sign(d_got) == torch.sign(d_ref)).double().mean())
    require(sign >= 0.99, f"{tag} D update sign agreement {sign}")
    value = max(rel(got["snapshots"][-1]["G"][k].double(),
                    ref["snapshots"][-1]["G"][k].double()) for k in wu)
    stats = [k for k in ref["snapshots"][-1]["G"]
             if k.endswith(("running_mean", "running_var"))]
    def stats_off(run):
        return max(float((run["snapshots"][-1]["G"][k].double()
                          - ref["snapshots"][-1]["G"][k].double()).abs().max()
                         / ref["snapshots"][-1]["G"][k].abs().max())
                   for k in stats)

    stats_err = stats_off(got)
    bound = max(1e-3, 3 * stats_off(cpu)) if spread_first else 1e-3
    require(stats_err <= bound, f"{tag} BatchNorm running stats {stats_err}"
            f" > {bound:.3g}")
    return leaf, worst, sign, value, stats_err


def dist_phase(smi):
    """Phase 10b: two ranks on the one card (gloo, each its own process,
    s2r_tpu_torch/tools/dist_check.py) against one process.  (i) The
    output step at DIST_CHECK_HW, global batch DIST_CHECK_BATCH float32
    (half a rank), dropout off, DIST_STEPS steps, against one process at
    the whole batch from the same weights: losses rel 1e-5 at the first
    step and 1e-4 after (tests/test_steps.py:85's bound for the JAX
    package's sharded step), G's update per leaf within LEAF_BOUND
    (relative L2) or 3x the leaf's float32 spread (the one-process step
    on the card against the CPU), D's update of the same sign on >= 99%
    of elements (phase 4a's bounds), the BatchNorm running statistics
    within 1e-3 of each layer's largest, every rank's state
    bit-equal, the all-reduces a step (DIST_COLLECTIVES) and each kernel's
    launches as step_launches(world=2) predicts.  (ii) The output step at
    the train cell (global batch BATCH, bf16): ms/step, each BatchNorm
    entry's launches and the all-reduces a step, peak memory per rank.
    Gloo stages every all-reduce through the host: the time is not
    NCCL's across cards.  Returns ({path: launches summed over the
    ranks}, summary)."""
    from s2r_tpu_torch.tools import dist_check

    check = dict(kind="steps", method="output_adapt",
                 hw=list(DIST_CHECK_HW), batch=DIST_CHECK_BATCH,
                 steps=DIST_STEPS, precision="f32")
    timing = dict(kind="timing", method="output_adapt", hw=list(TRAIN_HW),
                  batch=BATCH, precision="bf16", warmup=2, timed=5)
    t0 = time.perf_counter()
    ranks = dist_check.spawn({"tasks": [check, timing]}, DIST_WORLD, "cuda",
                             backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    ref = dist_check.run_tasks({"tasks": [check]}, torch.device(DEV, 0))[0]
    torch.cuda.empty_cache()
    cpu = dist_check.run_tasks({"tasks": [check]}, "cpu")[0]
    got = ranks[0][0]
    require(all(r[0]["ranks_equal"] and r[1]["ranks_equal"] for r in ranks),
            "10b: the ranks' states differ")
    leaf, worst, sign, value, stats_err = against_one_process(
        "10b", [r[0] for r in ranks], ref, cpu)
    per_step = step_launches("output_adapt", world=DIST_WORLD)
    for r in ranks:
        for task, steps in ((0, DIST_STEPS), (1, 7)):
            want = {k: v * steps for k, v in per_step.items()}
            require(r[task]["kernel_launches"] == want,
                    f"10b rank launches {r[task]['kernel_launches']}, "
                    f"expected {want}")
            require(r[task]["collectives_per_step"] == DIST_COLLECTIVES,
                    f"10b all-reduces a step "
                    f"{r[task]['collectives_per_step']}")
    require(ref["collectives_per_step"] == 0, "10b: one process all-reduced")
    log(f"[10b dist check] {DIST_WORLD} ranks on one card (gloo), "
        f"{DIST_CHECK_HW[1]}x{DIST_CHECK_HW[0]} global batch "
        f"{DIST_CHECK_BATCH} f32, {DIST_STEPS} steps against one process: "
        "losses " + "; ".join(
            f"step {i} " + ", ".join(
                f"{k} {got['metrics'][i][k]:.7g}/{ref['metrics'][i][k]:.7g}"
                for k in ("seg_loss", "adv_loss", "d_loss"))
            for i in range(DIST_STEPS))
        + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}; one "
        f"process card against CPU {leaf[worst][1]:.3g}), median "
        f"{statistics.median(v[0] for v in leaf.values()):.3g}, G after "
        f"the steps worst leaf {value:.3g}; D update sign agreement "
        f"{100 * sign:.3f}%; BatchNorm running stats {stats_err:.3g}; "
        f"ranks bit-equal; {DIST_COLLECTIVES} all-reduces a step; launches "
        f"as predicted ({spawn_s:.1f} s for both tasks, both ranks)")
    tm = [r[1] for r in ranks]
    ms = [statistics.median(t["ms"]) for t in tm]
    bn_step = {k: v for k, v in tm[0]["launches_per_step"].items() if v}
    log(f"[10b dist step] {DIST_WORLD} ranks, {TRAIN_HW[1]}x{TRAIN_HW[0]} "
        f"global batch {BATCH} ({BATCH // DIST_WORLD} a rank) bf16: "
        + ", ".join(f"rank {i} {m:.3f} ms/step (median of 5: "
                    + ", ".join(f"{v:.3f}" for v in t["ms"]) + ")"
                    for i, (m, t) in enumerate(zip(ms, tm)))
        + f"; a rank's BatchNorm launches a step {bn_step}; "
        f"{tm[0]['collectives_per_step']:.0f} all-reduces "
        f"({tm[0]['elements_per_step'] / 1e6:.3f}M elements) a step; peak "
        + ", ".join(f"{t['peak_gib'] or 0:.2f}" for t in tm)
        + " GiB a rank; "
        "gloo all-reduces through the host, so this is not a time of NCCL "
        f"across cards ({smi})")
    paths = {"dist_step_check": {}, "dist_step": {}}
    for r in ranks:
        for path, task in (("dist_step_check", 0), ("dist_step", 1)):
            for k, v in r[task]["kernel_launches"].items():
                paths[path][k] = paths[path].get(k, 0) + v
    return paths, {"dist_ms_per_step": max(ms),
                   "dist_peak_gib": max(t["peak_gib"] or 0 for t in tm),
                   "check_refs": (ref, cpu)}


def nccl_world1_phase(counted):
    """Phase 10c: cli.train_adapt at the phase 5 cell for one epoch, once
    without a process group and once with the environment torchrun sets
    at a world of 1 (NCCL), cuDNN's deterministic algorithms on for both:
    the states bit-equal, no collective call, the fused entries' launches
    as predicted.  Returns the second run's launches."""
    import torch.distributed as dist

    from s2r_tpu_torch.cli import train_adapt
    from s2r_tpu_torch.io.checkpoint import host_tree
    from s2r_tpu_torch.tools.dist_check import _free_port

    os.environ.pop("S2R_PLATFORM", None)
    root = tempfile.mkdtemp(prefix="s2r_nccl1_")
    argv = [a if a != "2" else "1" for a in ADAPT_ARGV]  # --epochs 1
    require(argv[argv.index("--epochs") + 1] == "1", "10c: epochs")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = train_adapt.main(argv + ["--run-root",
                                         os.path.join(root, "a")])
        plain_state = host_tree(plain.state)
        del plain
        os.environ.update(env)
        ranked, launches, fit_s = drive(
            counted, train_adapt.main,
            argv + ["--run-root", os.path.join(root, "b")])
        require(dist.is_initialized() and dist.get_world_size() == 1
                and dist.get_backend() == "nccl",
                "10c: no NCCL group of one")
        require(ranked.mesh.size == 1 and ranked.mesh.calls == 0,
                f"10c: {ranked.mesh.calls} collective calls at world 1")
        want = predicted("output_adapt", ranked.state.step,
                         fit_eval_forwards(ranked))
        require(launches == want, f"10c launches {launches}, expected {want}")
        require(trees_equal(host_tree(ranked.state), plain_state),
                "10c: the NCCL world-1 state differs from the run without "
                "a group")
        log(f"[10c nccl world 1] train_adapt, {ranked.state.step} steps at "
            f"{ADAPT_HW[1]}x{ADAPT_HW[0]} batch {ADAPT_BATCH} with RANK=0 "
            f"WORLD_SIZE=1 (NCCL) in {fit_s:.1f} s: state bit-equal to the "
            "run without a group (cuDNN deterministic in both), 0 "
            "collective calls, the fused BatchNorm entries' launches")
        del ranked
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k in env:
            os.environ.pop(k, None)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    return launches


def split_concat_phase(counted, smi, carry):
    """Phase 10d: (i) serving with split_concat, rgb8 2048x1024 batch 8,
    exact and decoder-int8, against the concat model on the same weights
    and inputs: float32 labels >= 99.9% equal; bfloat16 labels moved by
    split_concat no more than bfloat16 moves the concat model's from
    float32 (these random weights' labels are near ties); timed in bf16
    as phase 3, in turns (concat, split, split, concat); (ii) the output step at the train cell
    with --logits-dtype bf16 against float32 logits, in turns; (iii)
    cli.export --serve-split-concat of phase 5's final state and cli.infer
    over phase 8's frames: labels equal to make_serving_fn on the loaded
    servable in this process.  Returns ({path: launches}, summary)."""
    from s2r_tpu_torch.cli import export, infer
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import load_servable, make_serving_fn
    from s2r_tpu_torch.models.deeplab import DeepLab

    by_path, summary = {}, {}
    concat = build_model("bf16", DEV)

    def copy(dtype, split_concat):
        model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                        device=DEV, split_concat=split_concat)
        model.load_state_dict(concat.state_dict(), strict=True)
        return model

    split = copy("bf16", True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)

    def rgb8():
        return torch.randint(0, 256, (BATCH, *FULL_HW, 3), device=DEV,
                             generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(concat, [rgb8(), rgb8()], input="rgb8")
    images = rgb8()

    def serving(models):
        return {(name, mode): make_serving_fn(
            model, input="rgb8", **({} if mode == "exact" else dict(
                quant="decoder_int8", quant_scales=scales)))
            for name, model in models.items()
            for mode in ("exact", "decoder_int8")}

    # float32: split and concat differ by the order of float32 sums alone;
    # bfloat16: also by each part's rounding, which the labels of these
    # random weights are as sensitive to as to bfloat16 itself, so the
    # bf16 split may move no more labels than bf16 moves from float32
    labels = {key: fn(images) for key, fn in serving(
        {"concat32": copy("f32", False), "split32": copy("f32", True),
         "concat": concat, "split": split}).items()}
    torch.cuda.synchronize()
    agree = {}
    for mode in ("exact", "decoder_int8"):
        for a, b in (("split32", "concat32"), ("split", "concat"),
                     ("concat", "concat32")):
            agree[(a, b, mode)] = float(
                (labels[(a, mode)] == labels[(b, mode)]).float().mean())
        require(agree[("split32", "concat32", mode)] >= 0.999,
                f"10d split_concat float32 {mode}: labels "
                f"{100 * agree[('split32', 'concat32', mode)]:.3f}% equal")
        require(1 - agree[("split", "concat", mode)]
                <= 1 - agree[("concat", "concat32", mode)],
                f"10d split_concat bf16 {mode}: moves "
                f"{100 * (1 - agree[('split', 'concat', mode)]):.3f}% of "
                f"labels, bf16 itself "
                f"{100 * (1 - agree[('concat', 'concat32', mode)]):.3f}%")
    del labels
    torch.cuda.empty_cache()
    fns = serving({"concat": concat, "split": split})
    runs = {key: [] for key in fns}
    for name in ("concat", "split", "split", "concat"):
        for mode in ("exact", "decoder_int8"):
            fn = fns[(name, mode)]
            fn(images)
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(images)
                end.record()
                end.synchronize()
                runs[(name, mode)].append(start.elapsed_time(end) / BATCH)
    ms = {key: statistics.median(v) for key, v in runs.items()}
    reset(counted)
    for mode in ("exact", "decoder_int8"):
        fns[("split", mode)](images)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    want = dict.fromkeys(launches, 0)
    want.update(depthwise_conv3x3=2 * LAYERS["mobilenet"][0],
                requant_s32_to_s8=1)
    require(launches == want, f"10d serve split: launches {launches}")
    by_path["serve_split_concat"] = launches
    summary.update({f"serve_split_{m}_ms": ms[("split", m)]
                    for m in ("exact", "decoder_int8")})
    log(f"[10d split_concat serve] rgb8 {FULL_HW[1]}x{FULL_HW[0]} batch "
        f"{BATCH} bf16, ms/image (median of 6 in turns concat, split, "
        "split, concat): " + ", ".join(
            f"{m} concat {ms[('concat', m)]:.3f} split "
            f"{ms[('split', m)]:.3f}" for m in ("exact", "decoder_int8"))
        + "; labels equal, split against concat, float32 / bfloat16 (and "
        "bfloat16 concat against float32 concat): " + ", ".join(
            f"{m} {100 * agree[('split32', 'concat32', m)]:.3f}% / "
            f"{100 * agree[('split', 'concat', m)]:.3f}% "
            f"({100 * agree[('concat', 'concat32', m)]:.3f}%)"
            for m in ("exact", "decoder_int8"))
        + f"; launches of one call of each {launches} ({smi})")
    del concat, split, fns, images
    torch.cuda.empty_cache()

    steps = {}
    for logits in ("f32", "bf16", "bf16", "f32"):
        ms_, _, peak, losses, step_l, _ = time_step(
            "output_adapt", counted, TRAIN_HW, BATCH, logits_dtype=logits)
        steps.setdefault(logits, []).append((ms_, peak))
        by_path[f"train_step_logits_{logits}"] = step_l
        torch.cuda.empty_cache()
    med = {k: statistics.median(m for m, _ in v) for k, v in steps.items()}
    summary.update(step_bf16_logits_ms=med["bf16"],
                   step_f32_logits_ms=med["f32"])
    log(f"[10d logits dtype] output step {TRAIN_HW[1]}x{TRAIN_HW[0]} batch "
        f"{BATCH} bf16 compute, in turns f32, bf16, bf16, f32 logits: "
        + "; ".join(f"{k} logits " + ", ".join(f"{m:.3f} ms ({p:.2f} GiB "
                                                  "peak)" for m, p in v)
                    for k, v in steps.items())
        + f"; median bf16 {med['bf16']:.3f} against f32 {med['f32']:.3f} "
        f"({smi})")

    os.environ.pop("S2R_PLATFORM", None)
    root = tempfile.mkdtemp(prefix="s2r_split_")
    try:
        path = os.path.join(root, "split.s2rt")
        info = export.main(ADAPT_ARGV + [
            "--run-root", os.path.join(root, "run"), "--resume",
            carry["adapt"]["ckpt"], "--format", "servable", "--serve-shape",
            str(BATCH), str(FULL_HW[0]), str(FULL_HW[1]), "--serve-input",
            "rgb8", "--serve-split-concat", "--out", path])
        require(info["split_concat"], "10d export: split_concat not recorded")
        frames = carry["frames"]
        paths = infer.list_frames(frames)
        res, launches, _ = drive(
            counted, lambda a: infer.main(a, keep_predictions=True),
            ["--servable", path, "--images", frames, "--out-dir",
             os.path.join(root, "out")])
        n_batches = -(-len(paths) // BATCH)
        want = dict.fromkeys(launches, 0)
        want.update(depthwise_conv3x3=14 * n_batches)
        require(res["images"] == len(paths) and launches == want,
                f"10d infer split: launches {launches}, expected {want}")
        by_path["infer_split_concat"] = launches
        serve = load_servable(path, DEV)
        require(serve.model.split_concat, "10d: servable rebuilt without "
                "split_concat")
        fn = make_serving_fn(serve.model, input="rgb8")
        for i in range(0, len(paths), BATCH):
            chunk = paths[i:i + BATCH]
            batch = np.stack([infer.decode_frame(p, *FULL_HW, "rgb8")
                              for p in chunk])
            labels = fn(torch.from_numpy(batch)).cpu().numpy()
            require(all(np.array_equal(res["predictions"][p], labels[j])
                        for j, p in enumerate(chunk)),
                    "10d infer split: labels differ from make_serving_fn")
        log(f"[10d split_concat infer] cli.export --serve-split-concat of "
            f"phase 5's final state, cli.infer over {len(paths)} frames "
            f"({n_batches} batches): {res['ms_per_image']:.3f} ms/image "
            f"including host IO; labels equal to make_serving_fn in this "
            f"process; launches as predicted ({smi})")
        del serve, fn, res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path, summary


# phase 11: the native data path (--data-backend native) on phase 7's
# fixtures, at the phase 5 cell; bench.py's train_e2e at the train cell
# (TRAIN_HW crops, blur off, uint8 batches, BATCH, bf16, the output step)
NATIVE_E2E_STEPS = 5  # timed, after 2 warm-up steps (bench.py --quick)
TRACE_KERNELS = ("dw3x3_sweep", "dw3x3_dk_sweep", "bn_sums",
                 "bn_elementwise", "disc_conv1_tc")


def rss_mb():
    """This process's resident memory, MiB (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise Failed("no VmRSS in /proc/self/status")


def native_e2e(counted, roots, smi):
    """bench.py's train_e2e (bench.py:274-349) on the port: the native
    train loader at TRAIN_HW crops, blur off, emit_u8, 2 x cores threads,
    through the prefetch to the card and normalize_u8_batch into the
    output step (BATCH, bf16).  Returns (images/s, the loader's alone,
    launches)."""
    import itertools

    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.data.datasets import recursive_glob
    from s2r_tpu_torch.data.device_aug import normalize_u8_batch
    from s2r_tpu_torch.data.native_loader import NativeTrainLoader
    from s2r_tpu_torch.parallel.feed import prefetch_to_device
    from s2r_tpu_torch.train.setup import build_method

    h, w = TRAIN_HW
    threads = 2 * (os.cpu_count() or 1)
    loader = NativeTrainLoader(
        recursive_glob(roots["src_img_root"], ".png"),
        roots["src_label_root"], recursive_glob(roots["tgt_img_root"], ".png"),
        base_size=h, crop_size=(h, w), batch_size=BATCH, threads=threads,
        blur=False, emit_u8=True)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n_host = sum(len(b["src_image"]) for b in it)
    host_rate = n_host / (time.perf_counter() - t0)
    cfg = Config(crop_size=h, base_size=h, batch_size=BATCH, precision="bf16",
                 dataset="synthetic")
    method = build_method(cfg, 1000, method="output_adapt", device=DEV)
    state = method.init_state()

    def batches():
        for ep in itertools.count():
            loader.set_epoch(ep)
            yield from prefetch_to_device(loader, DEV)

    feed = batches()
    try:
        for _ in range(2):
            state, _ = method.step_fn(state, normalize_u8_batch(next(feed)))
        reset(counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NATIVE_E2E_STEPS):
            state, _ = method.step_fn(state, normalize_u8_batch(next(feed)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        feed.close()
    launches = {fn.__name__: fn.launches for fn in counted}
    require(launches == predicted("output_adapt", NATIVE_E2E_STEPS, 0),
            f"train_e2e launches {launches}")
    log(f"[11 train_e2e] {BATCH * NATIVE_E2E_STEPS / dt:.2f} images/s end "
        f"to end ({TRAIN_HW[1]}x{TRAIN_HW[0]} crops, blur off, uint8, "
        f"batch {BATCH} bf16, the output step, {NATIVE_E2E_STEPS} steps "
        f"after 2); the native loader alone {host_rate:.2f} images/s on "
        f"{threads} threads; launches as predicted ({smi})")
    return BATCH * NATIVE_E2E_STEPS / dt, host_rate, launches


def native_phase(counted, smi, carry):
    """Phase 11: the native data path.  Returns the launches of its runs,
    summed under 'native'."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    from s2r_tpu_torch.cli import test_adapt, train_adapt, val_adapt
    from s2r_tpu_torch.data import native
    from s2r_tpu_torch.data.native_loader import (NativeEvalLoader,
                                                  NativeTrainLoader)
    from s2r_tpu_torch.tools import fixtures
    from s2r_tpu_torch.utils import profiling

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_native_")
    runs = []
    try:
        # (a) the library against the JAX package's, through the digest
        os.makedirs(os.path.join(root, "digest"))
        digest, _ = native_digest(native, os.path.join(root, "digest"))
        log(f"[11 digest] native pipeline {digest[:16]}..: "
            f"{'equal' if digest == NATIVE_DIGEST else 'DIFFERENT'} to the "
            "CPU's, which tests/test_torch_port_native.py holds to the JAX "
            "package's native library")
        require(digest == NATIVE_DIGEST, "native digest differs")

        # (b) the fixtures decode to what was written; P-mode GTA5 labels
        # to their palette indices
        data = os.path.join(root, "data")
        files = fixtures.write_fixtures(data, **REAL_FRAMES)

        def decodes_back(f):
            return np.array_equal(
                native.decode_png(f[0], 3 if f[1] == "rgb" else 1), f[2])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            same = list(pool.map(decodes_back, files))
        dec_s = time.perf_counter() - t0
        n_p = sum(1 for f in files if f[1] == "raw" and "gta5" in f[0])
        log(f"[11 decode] {len(files)} fixture PNGs through the native "
            f"decoder on 8 threads in {dec_s:.2f} s, {sum(same)} equal to "
            f"the arrays written; {n_p} P-mode GTA5 labels give their "
            "palette indices (ROADMAP C.12)")
        require(all(same), "a fixture decodes to other pixels than written")
        del files
        argv = list(REAL_ARGV) + ["--data-backend", "native"]
        for k, v in fixtures.roots(data).items():
            argv += [f"--{k}", v]
        run = ["--run-root", os.path.join(root, "run")]

        # (c) train_adapt one epoch, val_adapt, test_adapt
        trainer, launches, sec = drive(counted, train_adapt.main, argv + run)
        cfg = trainer.cfg
        require(isinstance(trainer.train_loader, NativeTrainLoader)
                and isinstance(trainer.val_loader, NativeEvalLoader)
                and isinstance(trainer.test_loader, NativeEvalLoader),
                "train_adapt --data-backend native: not the native loaders")
        steps = trainer.state.step
        want = predicted("output_adapt", steps, fit_eval_forwards(trainer))
        require(launches == want,
                f"native train_adapt launches {launches}, expected {want}")
        runs.append(launches)
        sc = read_scalars(trainer.saver.experiment_dir)
        for tag in ("train/seg_loss", "train/adv_loss", "train/d_loss",
                    "val/total_loss_epoch"):
            require(all(np.isfinite(v) for _, v in sc[tag]),
                    f"native train_adapt {tag}: {sc[tag]}")
        require(0.0 <= trainer.best_pred <= 1.0,
                f"native train_adapt mIoU {trainer.best_pred}")
        rate = sc["train/images_per_sec"][0][1]
        loader = trainer.train_loader
        n_img = len(loader) * loader.batch_size
        alone = {}
        for w in (4, 8):
            loader.threads = w
            t0 = time.perf_counter()
            for _ in loader:
                pass
            alone[w] = n_img / (time.perf_counter() - t0)
        trainer.writer = trainer.summary.create_summary()  # fit closed it
        wall, dev, idle = profiled_epoch(trainer, cfg.epochs)
        log(f"[11 train_adapt] {steps} steps in {sec:.1f} s, launches as "
            f"predicted; seg_loss {sc['train/seg_loss'][0][1]:.4f}, mIoU "
            f"{trainer.best_pred:.6f}; epoch {rate:.2f} images/s; a "
            f"profiled epoch {n_img / wall:.2f} images/s, device {dev:.3f} "
            f"of {wall:.3f} s, idle {idle:.3f} ({smi})")
        final = trainer.saver.save_checkpoint(trainer.state, 1,
                                              trainer.best_pred, False,
                                              filename="final.ckpt")
        trainer.saver.wait()
        trainer.writer.close()
        n_val = len(trainer.val_loader)
        n_test = len(trainer.test_loader)
        del trainer, loader
        out = os.path.join(root, "val")
        (miou, _), launches, sec = drive(
            counted, val_adapt.main,
            argv + run + ["--resume", final, "--out-dir", out])
        require(launches == predicted("output_adapt", 0, 2 * n_val),
                f"native val_adapt launches {launches}")
        require(0.0 <= miou <= 1.0, f"native val_adapt mIoU {miou}")
        check_exports(os.path.join(out, "predictions"), REAL_FRAMES["n_val"],
                      True)
        runs.append(launches)
        out = os.path.join(root, "test")
        _, launches, sec_t = drive(
            counted, test_adapt.main,
            argv + run + ["--resume", final, "--out-dir", out])
        require(launches == predicted("output_adapt", 0, n_test),
                f"native test_adapt launches {launches}")
        check_exports(out, n_test * cfg.batch_size, False)
        runs.append(launches)
        log(f"[11 val_adapt, test_adapt] mIoU {miou:.6f}, "
            f"{REAL_FRAMES['n_val']} val pairs exported at 1280x640 in "
            f"{sec:.1f} s; {n_test * cfg.batch_size} test frames in "
            f"{sec_t:.1f} s; launches as predicted")

        # (d) the native route beside phase 7's host route, this run
        host = carry["host_route"]
        for w in (4, 8):
            log(f"[11 loader] alone, {w} threads: native "
                f"{alone[w]:.2f} images/s, host route "
                f"{host['loader'][w]:.2f} ({n_img} GTA5 + Cityscapes pairs, "
                f"phase 5 cell) ({smi})")
        log(f"[11 epoch] native {rate:.2f} images/s, profiled "
            f"{n_img / wall:.2f}, idle {idle:.3f}; host route "
            f"{host['epoch'][0][0]:.2f}, profiled {host['epoch'][1]:.2f}, "
            f"idle {host['epoch'][2]:.3f} ({smi})")
        _, _, e2e_launches = native_e2e(counted, fixtures.roots(data), smi)
        runs.append(e2e_launches)

        # (e) --profile-dir: the driver writes a trace holding the kernels;
        # then one more epoch traced directly, its host memory measured
        prof = os.path.join(root, "prof")
        trainer, launches, sec = drive(
            counted, train_adapt.main,
            argv + ["--run-root", os.path.join(root, "run_prof"),
                    "--profile-dir", prof])
        require(launches == predicted("output_adapt", trainer.state.step,
                                      fit_eval_forwards(trainer)),
                f"--profile-dir launches {launches}")
        runs.append(launches)
        traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
        require(len(traces) == 1, f"--profile-dir wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e.get("name", "") for e in events
                   if e.get("cat") == "kernel"}
        found = {k: sum(k in n for n in kernels) for k in TRACE_KERNELS}
        require(all(found.values()),
                f"trace kernels: {found} of {len(kernels)} names")
        trace_mb = os.path.getsize(traces[0]) / 2 ** 20
        del events, kernels
        trainer.writer = trainer.summary.create_summary()
        prof2 = os.path.join(root, "prof2")
        rss0 = rss_mb()
        with profiling.trace(prof2):
            trainer.training(trainer.cfg.epochs)
            torch.cuda.synchronize()
            held = rss_mb() - rss0
        trainer.saver.wait()
        trainer.writer.close()
        epoch_mb = sum(os.path.getsize(p) for p in glob.glob(
            os.path.join(prof2, "*.pt.trace.json"))) / 2 ** 20
        log(f"[11 profile-dir] train_adapt --profile-dir: one trace file of "
            f"{trace_mb:.1f} MiB (one epoch and validation), the kernels "
            + ", ".join(f"{k} x{v}" for k, v in found.items())
            + f" by name; one traced epoch held {held:.0f} MiB of host "
            f"memory before its export and wrote {epoch_mb:.1f} MiB ({smi})")
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    return {"native": total}


# phase 12: the memory and padding arms.  The padded step: PAD_REAL real
# samples padded to PAD_TO at TRAIN_CHECK_HW, float32, dropout on.
PAD_REAL, PAD_TO = 3, 4
# the output step's arms timed at the train cell, in turns (ABCDDCBA)
ARMS = (("default", {}), ("remat", {"remat": True}),
        ("fast_pad_stats", {"pad_stats": False}),
        ("s2d_convs", {"s2d_convs": 2}))


def remat_check(smi):
    """Phase 12a: one output step at the train cell (TRAIN_HW, BATCH,
    bf16) with --remat against the same step without, from the same
    weights, batch and dropout generator, cuDNN deterministic in both:
    losses and parameters within tests/test_remat.py's bounds (rtol 1e-5,
    atol 1e-6); running statistics, every num_batches_tracked and the
    generator's state bit-equal.  It logs whether the losses and the
    parameters came out bit-equal too."""
    from s2r_tpu_torch.tools.profile_train import bench_batch

    batch = bench_batch("output_adapt", BATCH, TRAIN_HW, DEV,
                        torch.Generator(device=DEV).manual_seed(SEED + 6))
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            method = train_method("bf16", DEV, remat=remat)
            require(method.deeplab.remat == remat, "12a: remat not set")
            state = method.init_state()
            state, metrics = method.step_fn(state, batch)
            torch.cuda.synchronize()
            g, d, stats = snapshot(method)
            tracked = {k: int(v) for k, v in method.deeplab.named_buffers()
                       if k.endswith("num_batches_tracked")}
            runs[remat] = ({k: float(v) for k, v in metrics.items()},
                           {**g, **{"D." + k: v for k, v in d.items()}},
                           stats, tracked, state.generator.get_state())
            del method, state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m0, p0, s0, t0, r0), (m1, p1, s1, t1, r1) = runs[False], runs[True]
    loss_err = {k: abs(m1[k] - m0[k]) - 1e-5 * abs(m0[k]) for k in m0}
    param_err = max(float(((p1[k] - p0[k]).abs() - 1e-5 * p0[k].abs()).max())
                    for k in p0)
    bit_equal = m1 == m0 and all(torch.equal(p1[k], p0[k]) for k in p0)
    stats_equal = all(torch.equal(s1[k], s0[k]) for k in s0)
    log(f"[12a remat] output step {TRAIN_HW[1]}x{TRAIN_HW[0]} batch {BATCH} "
        f"bf16, --remat against without: losses {m1} / {m0}; parameters "
        f"max(|diff| - 1e-5|ref|) {param_err:.3g}; losses and parameters "
        f"{'bit-equal' if bit_equal else 'not bit-equal'}; running "
        f"statistics {'bit-equal' if stats_equal else 'DIFFERENT'}, "
        f"num_batches_tracked {sorted(set(t1.values()))} / "
        f"{sorted(set(t0.values()))}, the dropout generator "
        f"{'bit-equal' if torch.equal(r1, r0) else 'DIFFERENT'} ({smi})")
    require(all(v <= 1e-6 for v in loss_err.values()),
            f"12a remat losses {m1} against {m0}")
    require(param_err <= 1e-6, f"12a remat parameters: {param_err}")
    require(stats_equal, "12a remat: running statistics differ")
    require(t1 == t0 and set(t0.values()) == {2},
            f"12a remat: num_batches_tracked {set(t1.values())}")
    require(torch.equal(r1, r0), "12a remat: the dropout generator moved")


def s2d_conv_checks(smi):
    """Phase 12c (i): the space-to-depth convs (s2r_tpu_torch/ops/s2d.py)
    against F.conv2d at D's conv2 input in the train cell ([BATCH, 64,
    TRAIN_HW / 2], kernel [128, 64, 4, 4]) and at the stem's FULL_HW
    batch-BATCH rgb input (kernel [32, 3, 3, 3]), in float32 (max|diff| <=
    1e-4 * max|ref|) and bfloat16 (|diff| <= 1e-2 * max(1, |ref|)
    elementwise), timed against F.conv2d in bfloat16."""
    import torch.nn.functional as F

    from s2r_tpu_torch.ops.s2d import conv3x3s2_via_s2d, conv4x4s2_via_s2d

    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    for name, x_shape, k_shape, fn in (
            ("disc_conv2", (BATCH, 64, TRAIN_HW[0] // 2, TRAIN_HW[1] // 2),
             (128, 64, 4, 4), conv4x4s2_via_s2d),
            ("stem", (BATCH, 3, *FULL_HW), (32, 3, 3, 3), conv3x3s2_via_s2d)):
        x = torch.randn(x_shape, device=DEV, generator=gen)
        k = torch.randn(k_shape, device=DEV, generator=gen) * 0.1
        ref32 = F.conv2d(x, k, stride=2, padding=1)
        err32 = rel_err(fn(x, k), ref32)
        xb, kb = x.bfloat16(), k.bfloat16()
        ref = F.conv2d(xb, kb, stride=2, padding=1)
        got = fn(xb, kb)
        worst = float(((got.float() - ref.float()).abs()
                       / ref.float().abs().clamp(min=1)).max())
        ms = cuda_ms(lambda: fn(xb, kb))
        ms_direct = cuda_ms(lambda: F.conv2d(xb, kb, stride=2, padding=1))
        log(f"[12c s2d {name}] x {list(x_shape)}, kernel {list(k_shape)}: "
            f"float32 rel err {err32:.3g}, bfloat16 worst |diff| / max(1, "
            f"|ref|) {worst:.3g}; bf16 s2d {ms:.3f} ms, direct F.conv2d "
            f"{ms_direct:.3f} ms ({smi})")
        require(err32 <= 1e-4 and worst <= 1e-2,
                f"12c s2d {name} disagrees with F.conv2d")
        del x, k, xb, kb, ref32, ref, got


def stem_s2d_serve(counted, smi):
    """Phase 12c (ii): serving with stem_s2d, rgb8 FULL_HW batch BATCH,
    exact and decoder-int8, against the default model on the same weights
    and inputs, as phase 10d holds split_concat: float32 labels >= 99.9%
    equal, bfloat16 labels moved by stem_s2d no more than bfloat16 moves
    the default model's from float32; timed in bf16 in turns (default,
    s2d, s2d, default); one call of each mode launches 14 depthwise and 1
    requant.  Returns those launches."""
    from s2r_tpu_torch.io.quant import calibrate_decoder_int8
    from s2r_tpu_torch.io.serving import make_serving_fn
    from s2r_tpu_torch.models.deeplab import DeepLab

    default = build_model("bf16", DEV)

    def copy(dtype, stem_s2d):
        model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                        device=DEV, stem_s2d=stem_s2d)
        model.load_state_dict(default.state_dict(), strict=True)
        return model

    s2d = copy("bf16", True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)

    def rgb8():
        return torch.randint(0, 256, (BATCH, *FULL_HW, 3), device=DEV,
                             generator=gen, dtype=torch.uint8)

    scales = calibrate_decoder_int8(default, [rgb8(), rgb8()], input="rgb8")
    images = rgb8()

    def serving(models):
        return {(name, mode): make_serving_fn(
            model, input="rgb8", **({} if mode == "exact" else dict(
                quant="decoder_int8", quant_scales=scales)))
            for name, model in models.items()
            for mode in ("exact", "decoder_int8")}

    labels = {key: fn(images) for key, fn in serving(
        {"default32": copy("f32", False), "s2d32": copy("f32", True),
         "default": default, "s2d": s2d}).items()}
    torch.cuda.synchronize()
    agree = {}
    for mode in ("exact", "decoder_int8"):
        for a, b in (("s2d32", "default32"), ("s2d", "default"),
                     ("default", "default32")):
            agree[(a, b, mode)] = float(
                (labels[(a, mode)] == labels[(b, mode)]).float().mean())
        require(agree[("s2d32", "default32", mode)] >= 0.999,
                f"12c stem_s2d float32 {mode}: labels "
                f"{100 * agree[('s2d32', 'default32', mode)]:.3f}% equal")
        require(1 - agree[("s2d", "default", mode)]
                <= 1 - agree[("default", "default32", mode)],
                f"12c stem_s2d bf16 {mode}: moves "
                f"{100 * (1 - agree[('s2d', 'default', mode)]):.3f}% of "
                f"labels, bf16 itself "
                f"{100 * (1 - agree[('default', 'default32', mode)]):.3f}%")
    del labels
    torch.cuda.empty_cache()
    fns = serving({"default": default, "s2d": s2d})
    runs = {key: [] for key in fns}
    for name in ("default", "s2d", "s2d", "default"):
        for mode in ("exact", "decoder_int8"):
            fn = fns[(name, mode)]
            fn(images)
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(images)
                end.record()
                end.synchronize()
                runs[(name, mode)].append(start.elapsed_time(end) / BATCH)
    ms = {key: statistics.median(v) for key, v in runs.items()}
    reset(counted)
    for mode in ("exact", "decoder_int8"):
        fns[("s2d", mode)](images)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    want = dict.fromkeys(launches, 0)
    want.update(depthwise_conv3x3=2 * LAYERS["mobilenet"][0],
                requant_s32_to_s8=1)
    require(launches == want, f"12c serve stem_s2d: launches {launches}")
    log(f"[12c stem_s2d serve] rgb8 {FULL_HW[1]}x{FULL_HW[0]} batch {BATCH} "
        f"bf16, ms/image (median of 6 in turns default, s2d, s2d, "
        "default): " + ", ".join(
            f"{m} default {ms[('default', m)]:.3f} s2d "
            f"{ms[('s2d', m)]:.3f}" for m in ("exact", "decoder_int8"))
        + "; labels equal, s2d against default, float32 / bfloat16 (and "
        "bfloat16 default against float32 default): " + ", ".join(
            f"{m} {100 * agree[('s2d32', 'default32', m)]:.3f}% / "
            f"{100 * agree[('s2d', 'default', m)]:.3f}% "
            f"({100 * agree[('default', 'default32', m)]:.3f}%)"
            for m in ("exact", "decoder_int8"))
        + f"; launches of one call of each {launches} ({smi})")
    del default, s2d, fns, images
    return launches


def padded_step_check(counted, smi):
    """Phase 12d: the output step with masked batch padding (PAD_REAL
    real samples padded to PAD_TO; build_method's _step_pad_to patched, as
    tests/test_batch_pad.py reaches the JAX package's) at TRAIN_CHECK_HW
    float32, dropout on, against the unpadded step from the same weights
    and generator, at that test's bounds: metrics rtol 1e-4 atol 1e-5,
    parameters rtol 1e-2 atol 2e-3, running statistics rtol 1e-2 atol
    1e-4; the generator's state bit-equal; the padded step's launches
    those of an unpadded step.  Returns those launches."""
    from s2r_tpu_torch.train import setup

    rs = np.random.RandomState(SEED + 7)
    h, w = TRAIN_CHECK_HW
    batch = {"src_image": rs.randn(PAD_REAL, h, w, 3).astype(np.float32),
             "src_label": rs.randint(0, 19, (PAD_REAL, h, w)),
             "tgt_image": rs.randn(PAD_REAL, h, w, 3).astype(np.float32)}
    runs = {}
    step_pad_to = setup._step_pad_to
    try:
        for pad in (None, PAD_TO):
            setup._step_pad_to = lambda cfg, n, pad=pad: pad
            method = train_method("f32", DEV)
            state = method.init_state()
            reset(counted)
            state, metrics = method.step_fn(state, batch)
            torch.cuda.synchronize()
            runs[pad] = ({k: float(v) for k, v in metrics.items()},
                         snapshot(method), state.generator.get_state(),
                         {fn.__name__: fn.launches for fn in counted})
            del method, state
    finally:
        setup._step_pad_to = step_pad_to
    (m0, snap0, r0, _), (m1, snap1, r1, launches) = runs[None], runs[PAD_TO]

    def excess(a, b, rtol, atol):
        return max(float(((a[k] - b[k]).abs() - rtol * b[k].abs()).max())
                   for k in b) - atol

    met_ok = all(abs(m1[k] - m0[k]) <= 1e-5 + 1e-4 * abs(m0[k]) for k in m0)
    over = {"G": excess(snap1[0], snap0[0], 1e-2, 2e-3),
            "D": excess(snap1[1], snap0[1], 1e-2, 2e-3),
            "stats": excess(snap1[2], snap0[2], 1e-2, 1e-4)}
    log(f"[12d padded step] {PAD_REAL} samples padded to {PAD_TO}, "
        f"{w}x{h} float32, dropout on, against unpadded: metrics {m1} / "
        f"{m0}; bound excess (<= 0 passes) {over}; generator "
        f"{'bit-equal' if torch.equal(r1, r0) else 'DIFFERENT'}; launches "
        f"{launches} ({smi})")
    require(met_ok, f"12d padded step metrics {m1} against {m0}")
    require(all(v <= 0 for v in over.values()), f"12d padded step: {over}")
    require(torch.equal(r1, r0), "12d padded step: the generator moved")
    require(launches == step_launches("output_adapt"),
            f"12d padded step: launches {launches}")
    return launches


def arms_drivers(counted, smi):
    """Phase 12e: the drivers with --remat and --fast-pad-stats at the
    phase 5 cell for one epoch (TRAIN_ARGV): train_adapt, val_adapt
    --skip-sep on its best checkpoint (the Trainer's mIoU within 1e-4)
    and cli.export of it as a FULL_HW batch-BATCH rgb8 servable, whose
    meta records pad_stats False and whose load_servable model is
    ring-free (one call: 14 depthwise launches); then train
    (feature_adapt) and val --skip-sep likewise.  Finite losses and
    launches as predicted (the steps' with the recompute, the eval
    forwards' as always).  Returns {path: launches}."""
    from s2r_tpu_torch.cli import export, train, train_adapt, val, val_adapt
    from s2r_tpu_torch.io.serving import load_servable

    os.environ.pop("S2R_PLATFORM", None)  # the card, as a user runs it
    root = tempfile.mkdtemp(prefix="s2r_arms_")
    by_path = {}
    try:
        for name, fit, vmain, method, losses in (
                ("train_adapt", train_adapt.main, val_adapt.main,
                 "output_adapt", ("seg_loss", "adv_loss", "d_loss")),
                ("train", train.main, val.main, "feature_adapt",
                 ("task_loss", "d_loss", "d_inv_loss"))):
            argv = TRAIN_ARGV + ["--remat", "--fast-pad-stats", "--run-root",
                                 root, "--checkname", name]
            trainer, launches, sec = drive(counted, fit, argv)
            model = trainer.method.deeplab
            require(model.remat and not model.pad_stats
                    and trainer.method.name == method,
                    f"12e {name}: remat {model.remat}, pad_stats "
                    f"{model.pad_stats}, {trainer.method.name}")
            want = predicted(method, trainer.state.step,
                             fit_eval_forwards(trainer), remat=True)
            require(launches == want,
                    f"12e {name} launches {launches}, expected {want}")
            by_path[f"{name}_remat_fast_pad_stats"] = launches
            sc = read_scalars(trainer.saver.experiment_dir)
            require(all(np.isfinite(v) for k in losses
                        for _, v in sc[f"train/{k}"]),
                    f"12e {name} losses not finite")
            best = os.path.join(trainer.saver.directory, "model_best.ckpt")
            n_val, best_pred = len(trainer.val_loader), trainer.best_pred
            rate = sc["train/images_per_sec"][0][1]
            del trainer, model
            (miou, _), launches, _ = drive(
                counted, vmain, argv + ["--resume", best, "--skip-sep",
                                        "--out-dir",
                                        os.path.join(root, f"val_{name}")])
            require(launches == predicted(method, 0, n_val),
                    f"12e val after {name}: launches {launches}")
            require(abs(miou - best_pred) <= 1e-4,
                    f"12e val after {name}: mIoU {miou} against {best_pred}")
            by_path[f"val_{name}_fast_pad_stats"] = launches
            log(f"[12e {name}] --remat --fast-pad-stats: one epoch in "
                f"{sec:.1f} s, {rate:.2f} images/s, launches as predicted; "
                f"val mIoU {miou:.6f} (the Trainer's {best_pred:.6f}) "
                f"({smi})")
            if name != "train_adapt":
                continue
            out = os.path.join(root, "arms.s2rt")
            export.main(argv + ["--resume", best, "--out", out, "--format",
                                "servable", "--serve-input", "rgb8",
                                "--serve-shape", str(BATCH),
                                str(FULL_HW[0]), str(FULL_HW[1])])
            servable = load_servable(out)
            require(servable.meta["pad_stats"] is False
                    and not servable.model.pad_stats
                    and not any(b.pad_stats for b in
                                servable.model.backbone.features[1:]),
                    "12e export --fast-pad-stats: the servable keeps the "
                    "ring")
            frames = torch.randint(0, 256, (BATCH, *FULL_HW, 3), device=DEV,
                                   dtype=torch.uint8,
                                   generator=torch.Generator(
                                       device=DEV).manual_seed(SEED + 15))
            reset(counted)
            labels = servable(frames)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
            require(labels.shape == (BATCH, *FULL_HW)
                    and launches == dict(dict.fromkeys(launches, 0),
                                         depthwise_conv3x3=14),
                    f"12e servable: {tuple(labels.shape)}, {launches}")
            by_path["serve_fast_pad_stats"] = launches
            log(f"[12e export] the --fast-pad-stats servable records "
                f"pad_stats False and serves ring-free; one call "
                f"{launches['depthwise_conv3x3']} depthwise launches")
            del servable, frames, labels
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path


def arms_phase(counted, smi):
    """Phase 12: --remat, --fast-pad-stats, the space-to-depth convs and
    masked batch padding.  Returns ({path: launches}, summary)."""
    by_path, summary = {}, {}
    remat_check(smi)
    train_check_small(counted, pad_stats=False)
    runs, peaks = {name: [] for name, _ in ARMS}, {}
    for name, fields in ARMS + ARMS[::-1]:
        ms, _, peak, _, launches, _ = time_step(
            "output_adapt", counted, TRAIN_HW, BATCH, **fields)
        runs[name].append(ms)
        peaks[name] = peak
        if name != "default":
            by_path[f"{name}_step"] = launches
        torch.cuda.empty_cache()
    log(f"[12 arms] output step {TRAIN_HW[1]}x{TRAIN_HW[0]} batch {BATCH} "
        "bf16, in turns ABCDDCBA, ms/step (the two medians of 5) and peak "
        "GiB: " + "; ".join(
            f"{name} {runs[name][0]:.3f} / {runs[name][1]:.3f}, "
            f"{peaks[name]:.3f} GiB" for name, _ in ARMS)
        + f"; launches as predicted ({smi})")
    summary.update({f"{name}_step_ms": statistics.mean(runs[name])
                    for name, _ in ARMS})
    summary.update({f"{name}_step_peak_gib": peaks[name]
                    for name, _ in ARMS})
    s2d_conv_checks(smi)
    torch.cuda.empty_cache()
    by_path["serve_stem_s2d"] = stem_s2d_serve(counted, smi)
    torch.cuda.empty_cache()
    by_path["padded_step"] = padded_step_check(counted, smi)
    torch.cuda.empty_cache()
    by_path.update(arms_drivers(counted, smi))
    return by_path, summary


# phase 14: the spatial arms (--spatial-shard, --eval-spatial-shard).  Two
# bands of rows a sample; the checks reuse phase 10b's one-process runs of
# its check (DIST_CHECK_HW, DIST_CHECK_BATCH, float32, DIST_STEPS steps).
SPATIAL = 2
SPATIAL_EVAL_BATCH = 2          # at FULL_HW, float32
SPATIAL_PEAK_BATCH = 4          # at FULL_HW, bf16: two ranks on one card
SPATIAL_TRAINER_HW, SPATIAL_TRAINER_BATCH = 512, 4


def check_spatial_shapes(dw, bn, dc):
    """Phase 14a: each kernel of the spatial output step against its plain
    version at a rank's band plus halo of the train cell (TRAIN_HW, all
    BATCH samples of the one data row, TRAIN_HW[0] / SPATIAL rows), float32
    and bfloat16, at phase 2's tolerances: the depthwise forward, dx and dk
    on the band plus d rows a side (dk's cotangent zero on the cropped
    rows); the four split BatchNorm entries and dx on the band's rows
    with the global image's ring count; disc_conv1 on the band plus 2 rows
    a side."""
    from s2r_tpu_torch.models.mobilenet import block_plan

    gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
    n, eps, mom = BATCH, 1e-5, 0.1
    shapes = sorted(set(dw_shapes(TRAIN_HW, block_plan)))
    worst_dk = 0.0
    for c, h, w, d in shapes:
        hb = h // SPATIAL + 2 * d
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, hb, w, c), dtype, gen)
            g = randn((n, hb, w, c), dtype, gen)
            g[:, :d] = 0
            g[:, hb - d:] = 0
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            dw_check(dw, x, k, d)
            dw_check(dw, g, k.flip((0, 1)).contiguous(), d)
            worst_dk = max(worst_dk, dk_check(dw, x, g, d)[2])
    bn_shapes = sorted(set(s for s in bn_input_shapes(TRAIN_HW) if s[1] > 1))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for c, h, w in bn_shapes:
        m, count = n * (h // SPATIAL) * w, n * (h + 2) * (w + 2)
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            x = randn((m, c), dtype, gen)
            g = randn((m, c), dtype, gen)
            weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
            bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
            gshift = torch.randn(c, device=DEV, generator=gen)
            run = [0.1 * torch.randn(c, device=DEV, generator=gen),
                   0.5 + torch.rand(c, device=DEV, generator=gen)]
            run_p = [t.clone() for t in run]
            sums = bn.batch_norm_sums(x)
            sums_in = sums.clone()
            sums_p = sums.clone()
            y = bn.batch_norm_finish_apply(x, sums, weight, bias, count, eps,
                                           *run, mom)
            bn.batch_norm_finish_apply_plain(x, sums_p, weight, bias, count,
                                             eps, *run_p, mom)
            local = bn.batch_norm_grad_sums_local(g, x, sums, gshift)
            local_in = local.clone()
            fin = bn.batch_norm_grad_finish(local, sums, count)
            dx = bn.batch_norm_dx(g, x, sums[bn.INV], fin[bn.COEF_B],
                                  fin[bn.COEF_C0])
            torch.cuda.synchronize()
            pairs = {
                "sums": (sums_in[:2], bn.batch_norm_sums_plain(x)[:2]),
                "finish_apply": (sums, sums_p),
                "finish_apply y": (y.view(1, -1), bn.batch_norm_apply_plain(
                    x, sums[bn.INV], sums[bn.SHIFT]).view(1, -1)),
                "running": (torch.stack(run), torch.stack(run_p)),
                "grad_sums_local": (local_in[:4],
                                    bn.batch_norm_grad_sums_local_plain(
                                        g, x, sums, gshift)[:4]),
                "grad_finish": (fin, bn.batch_norm_grad_finish_plain(
                    local_in, sums, count)),
                "dx": (dx.view(1, -1), bn.batch_norm_dx_plain(
                    g, x, sums[bn.INV], fin[bn.COEF_B],
                    fin[bn.COEF_C0]).view(1, -1))}
            e = {k: max(bn_rel(u, v)) for k, (u, v) in pairs.items()}
            require(max(e.values()) <= tol,
                    f"14a batchnorm {(n, c, h // SPATIAL, w)} {dtype}: rel "
                    f"errs {e} > {tol}")
            worst[dtype] = max(worst[dtype], max(e.values()))
    disc_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, x, k, b = disc_inputs(n, 19, TRAIN_HW[0] // SPATIAL + 4,
                                 TRAIN_HW[1], 64, dtype, gen)
        disc_err[dtype] = disc_check(dc, x, k, b)[1]
    log(f"[14a halo shapes] depthwise forward, dx and dk at "
        f"{len(shapes)} bands plus halo ("
        + ", ".join(f"C{c} {h // SPATIAL + 2 * d}x{w} d{d}"
                    for c, h, w, d in shapes)
        + f"; worst dk rel err {worst_dk:.3g}); the split BatchNorm "
        f"entries and dx at {len(bn_shapes)} band shapes, worst rel err "
        f"f32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}"
        f"; disc_conv1 at {n}x{TRAIN_HW[0] // SPATIAL + 4}x19x{TRAIN_HW[1]}"
        f" max_abs_err f32 {disc_err[torch.float32]:.3g}, bf16 "
        f"{disc_err[torch.bfloat16]:.3g}: all at phase 2's tolerances")


def spatial_phase(smi, check_refs):
    """Phase 14b-e: the spatial arms through tools/dist_check.py, gloo
    ranks on the one card.  (c) 4 ranks (2 data rows x 2 bands) and (b) 2
    ranks (1 x 2) take phase 10b's check (its one-process runs on the
    card and the CPU are `check_refs`) at --spatial-shard 2, at 10b's
    bounds (against_one_process); (b) then times the output step at the
    train cell (ms/step, launches, all-reduces and halo gathers a step,
    halo elements, peak memory a rank).  (d) --eval-spatial-shard over
    the 2 ranks: a FULL_HW validation batch of SPATIAL_EVAL_BATCH float32
    against one process (loss rtol 1e-5, labels > 0.999 equal; the
    confusion matrix equal but for labels at near-ties); then the
    Trainer with --spatial-shard 2 --eval-spatial-shard for one epoch and
    its validation (finite losses, mIoU in [0, 1], rank 0 alone writes
    the run directory).  (e) The output step at FULL_HW bf16, global
    batch SPATIAL_PEAK_BATCH: peak memory a rank against one process at
    that batch.  Returns ({path: launches summed over the ranks},
    summary)."""
    from s2r_tpu_torch.tools import dist_check

    ref, cpu = check_refs
    check = dict(kind="steps", method="output_adapt",
                 hw=list(DIST_CHECK_HW), batch=DIST_CHECK_BATCH,
                 steps=DIST_STEPS, precision="f32", spatial=SPATIAL)
    timing = dict(kind="timing", method="output_adapt", hw=list(TRAIN_HW),
                  batch=BATCH, precision="bf16", warmup=2, timed=5,
                  spatial=SPATIAL)
    evals = dict(kind="eval", method="output_adapt", hw=list(FULL_HW),
                 batch=SPATIAL_EVAL_BATCH, precision="f32", spatial=SPATIAL,
                 eval_spatial=True)
    root = tempfile.mkdtemp(prefix="s2r_spatial_")
    trainer = dict(kind="trainer", hw=SPATIAL_TRAINER_HW,
                   batch=SPATIAL_TRAINER_BATCH, precision="bf16",
                   train_steps=2, run_root=root, spatial=SPATIAL,
                   eval_spatial=True, device_aug=True)
    peak = dict(kind="timing", method="output_adapt", hw=list(FULL_HW),
                batch=SPATIAL_PEAK_BATCH, precision="bf16", warmup=1, timed=2,
                spatial=SPATIAL)
    try:
        t0 = time.perf_counter()
        four = dist_check.start({"tasks": [check]}, 2 * SPATIAL, DEV,
                                backend="gloo", timeout=600)
        # one process meanwhile: the eval reference and the peak at (e)
        one_eval = dist_check.run_tasks({"tasks": [dict(
            evals, spatial=1, eval_spatial=False, ties=True)]},
            torch.device(DEV, 0))[0]
        torch.cuda.empty_cache()
        one_peak = dist_check.run_tasks({"tasks": [dict(peak, spatial=1)]},
                                        torch.device(DEV, 0))[0]
        torch.cuda.empty_cache()
        four = four.results()
        four_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = dist_check.spawn({"tasks": [check, timing, evals, trainer,
                                          peak]}, SPATIAL, DEV,
                               backend="gloo", timeout=900)
        two_s = time.perf_counter() - t0
        runs = os.listdir(os.path.join(root, "synthetic",
                                       "deeplab-mobilenet"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {}
    for tag, ranks in (("14c", four), ("14b", two)):
        leaf, worst, sign, value, stats_err = against_one_process(
            tag, [r[0] for r in ranks], ref, cpu, loss_spread=True)
        got = ranks[0][0]
        world = len(ranks)
        want = {k: v * DIST_STEPS for k, v in step_launches(
            "output_adapt", world=world, spatial=SPATIAL).items()}
        for r in ranks:
            require(r[0]["kernel_launches"] == want,
                    f"{tag} rank launches {r[0]['kernel_launches']}, "
                    f"expected {want}")
        out[tag] = got
        log(f"[{tag} spatial check] {world} ranks ({world // SPATIAL} data "
            f"x {SPATIAL} bands) on one card (gloo), {DIST_CHECK_HW[1]}x"
            f"{DIST_CHECK_HW[0]} global batch {DIST_CHECK_BATCH} f32, "
            f"{DIST_STEPS} steps against one process: losses (ranks / one "
            "process / one process on the CPU) " + "; ".join(
                f"step {i} " + ", ".join(
                    f"{k} {got['metrics'][i][k]:.7g}/"
                    f"{ref['metrics'][i][k]:.7g}/{cpu['metrics'][i][k]:.7g}"
                    for k in ("seg_loss", "adv_loss", "d_loss"))
                for i in range(DIST_STEPS))
            + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}; one "
            f"process card against CPU {leaf[worst][1]:.3g}), G after the "
            f"steps worst leaf {value:.3g}; D update sign agreement "
            f"{100 * sign:.3f}%; BatchNorm running stats {stats_err:.3g}; "
            f"ranks bit-equal; {got['collectives_per_step']:.0f} all-reduces"
            f" ({got['world_collectives_per_step']:.0f} over the world) and "
            f"{got['gathers_per_step']:.0f} halo gathers a step; launches as "
            f"predicted ({four_s if tag == '14c' else two_s:.1f} s the "
            "spawn)")
    tm = [r[1] for r in two]
    per_step = step_launches("output_adapt", world=SPATIAL, spatial=SPATIAL)
    for r in two:
        want = {k: v * 7 for k, v in per_step.items()}
        require(r[1]["kernel_launches"] == want,
                f"14b timed rank launches {r[1]['kernel_launches']}, "
                f"expected {want}")
        require(r[1]["ranks_equal"] and all(
            np.isfinite(v) for v in r[1]["losses"].values()),
            f"14b timed: ranks differ or losses not finite {r[1]['losses']}")
    ms = [statistics.median(t["ms"]) for t in tm]
    log(f"[14b spatial step] {SPATIAL} ranks (1 data x {SPATIAL} bands), "
        f"{TRAIN_HW[1]}x{TRAIN_HW[0]} batch {BATCH} ({TRAIN_HW[0] // SPATIAL}"
        " rows a rank) bf16: " + ", ".join(
            f"rank {i} {m:.3f} ms/step (median of 5: "
            + ", ".join(f"{v:.3f}" for v in t["ms"]) + ")"
            for i, (m, t) in enumerate(zip(ms, tm)))
        + f"; launches a step {per_step}; "
        f"{tm[0]['collectives_per_step']:.0f} all-reduces "
        f"({tm[0]['elements_per_step'] / 1e6:.3f}M elements) and "
        f"{tm[0]['gathers_per_step']:.0f} halo gathers "
        f"({tm[0]['halo_elements_per_step'] / 1e6:.3f}M elements sent) a "
        "step; peak " + ", ".join(f"{t['peak_gib'] or 0:.3f}" for t in tm)
        + " GiB a rank; gloo moves every collective through the host, so "
        f"this is not a time of NCCL across cards ({smi})")
    # (d) --eval-spatial-shard against one process
    ev = [r[2] for r in two]
    loss = sum(e["loss"] for e in ev)
    cm = sum(e["confusion"] for e in ev)
    pred = torch.cat([e["pred"] for e in ev], dim=1)
    differ = pred != one_eval["pred"]
    agree = 1.0 - float(differ.double().mean())
    flips, cm_l1 = int(differ.sum()), int((cm - one_eval["confusion"]).abs()
                                          .sum())
    require(abs(loss - one_eval["loss"]) <= 1e-5 * abs(one_eval["loss"]),
            f"14d eval loss {loss}, one process {one_eval['loss']}")
    require(agree > 0.999, f"14d label agreement {agree}")
    # the confusion matrix equal but for labels at float32 near-ties of
    # the one-process logits (tests/test_torch_port_eval.py's rule)
    require(not (differ & ~one_eval["ties"]).any()
            and cm_l1 <= 2 * flips,
            f"14d confusion matrix off one process's by {cm_l1} counts; "
            f"{int((differ & ~one_eval['ties']).sum())} of {flips} "
            "differing labels are not near-ties")
    tr = [r[3] for r in two]
    means = tr[0]["train_means"][0]
    require(all(np.isfinite(means[k]) for k in ("seg_loss", "adv_loss",
                                                "d_loss"))
            and 0.0 <= tr[0]["miou"] <= 1.0
            and all(t["ranks_equal"] and t["miou"] == tr[0]["miou"]
                    for t in tr)
            and sorted(runs) == ["experiment_0", "model_best.ckpt"],
            f"14d trainer: losses {means}, mIoU {tr[0]['miou']}, run "
            f"directory {runs}")
    log(f"[14d eval-spatial-shard] {SPATIAL} ranks, {FULL_HW[1]}x"
        f"{FULL_HW[0]} batch {SPATIAL_EVAL_BATCH} f32, each "
        f"{FULL_HW[0] // SPATIAL} rows: loss {loss:.9g} against one "
        f"process {one_eval['loss']:.9g}, labels {100 * agree:.5f}% equal "
        f"({flips} differ, all at near-ties of the one-process logits, of "
        f"{int(one_eval['ties'].sum())} near-ties), confusion matrix off by "
        f"{cm_l1} counts, {ev[0]['gathers']} halo gathers and "
        f"{ev[0]['collectives']} all-reduces a forward; the Trainer with "
        f"--spatial-shard {SPATIAL} --eval-spatial-shard at "
        f"{SPATIAL_TRAINER_HW}x{SPATIAL_TRAINER_HW} batch "
        f"{SPATIAL_TRAINER_BATCH} bf16 --device-aug, one epoch of 2 steps: "
        f"seg_loss {means['seg_loss']:.4f}, adv_loss {means['adv_loss']:.4f}"
        f", d_loss {means['d_loss']:.4f}, mIoU {tr[0]['miou']:.4f} on every"
        f" rank, run directory {sorted(runs)} (rank 0's)")
    pk = [r[4] for r in two]
    log(f"[14e spatial peak] output step {FULL_HW[1]}x{FULL_HW[0]} global "
        f"batch {SPATIAL_PEAK_BATCH} bf16: peak "
        + ", ".join(f"{t['peak_gib'] or 0:.3f}" for t in pk)
        + f" GiB a rank at --spatial-shard {SPATIAL} ({SPATIAL} ranks on "
        f"one card), against {one_peak['peak_gib'] or 0:.3f} GiB one "
        "process; "
        "ms/step a rank " + ", ".join(
            f"{statistics.median(t['ms']):.3f}" for t in pk)
        + f" (gloo), one process {statistics.median(one_peak['ms']):.3f} "
        f"(run beside 14c's four ranks) ({smi})")
    paths = {"spatial_step_check": {}, "spatial_2x2_step_check": {},
             "spatial_step": {}, "spatial_eval": {}, "spatial_train_adapt": {},
             "spatial_step_fullres": {}}
    for ranks, tasks in ((two, (("spatial_step_check", 0),
                                ("spatial_step", 1), ("spatial_eval", 2),
                                ("spatial_train_adapt", 3),
                                ("spatial_step_fullres", 4))),
                         (four, (("spatial_2x2_step_check", 0),))):
        for r in ranks:
            for path, task in tasks:
                for k, v in r[task]["kernel_launches"].items():
                    paths[path][k] = paths[path].get(k, 0) + v
    for path in ("spatial_eval", "spatial_train_adapt"):
        require(paths[path]["depthwise_conv3x3"] > 0,
                f"14: {path} launched no depthwise kernel")
    return paths, {"spatial_ms_per_step": max(ms),
                   "spatial_peak_gib": max(t["peak_gib"] or 0 for t in pk),
                   "one_peak_gib": one_peak["peak_gib"] or 0}


# phase 14, uneven bands: 513 rows over SPATIAL = 2 ranks, bench.py's
# 513x513 cell.  The band rule (core/mesh.py band_rows) cuts bands of 272
# and 241 rows at the source-only path's stride 16 (feature maps of
# ceil(513 / k) rows, bands of 272 / k), 288 and 225 at the output path's
# 32 (the discriminator's maps floor(513 / k) rows); the padded step pads
# a global batch of UNEVEN_PAD_REAL real samples to UNEVEN_PAD_TO over 2
# data ranks, the second holding padding only.
UNEVEN_HW, UNEVEN_BATCH, UNEVEN_EVAL_BATCH = 513, 4, 2
UNEVEN_PAD_REAL, UNEVEN_PAD_TO = 4, 8


def short_band(height, level_rows, unit):
    """The rows of the last (short) of SPATIAL bands at a level of
    `level_rows` rows of an image of `height` at the band rule's `unit`,
    and the level's full band (the level's stride read off its rows:
    ceil(height / k) or floor(height / k))."""
    from s2r_tpu_torch.core.mesh import band_bounds, band_rows

    band = band_rows(height, SPATIAL, unit)
    k = next(k for k in (1, 2, 4, 8, 16, 32)
             if level_rows in (-(-height // k), height // k))
    r0, r1 = band_bounds(level_rows, band // k, SPATIAL - 1)
    return r1 - r0, band // k


def check_uneven_shapes(dw, bn, dc):
    """Phase 14a, uneven bands: each kernel against its plain version at
    the short band of UNEVEN_HW rows over SPATIAL ranks, batch
    UNEVEN_BATCH, float32 and bfloat16, at phase 2's tolerances: the
    depthwise forward, dx and dk on the short band plus d rows a side of
    every stride-1 depthwise conv of the source-only forward (bands of
    241 / k rows); all eight BatchNorm entries on the short band's rows
    of every BatchNorm input with the global image's ring count;
    disc_conv1 on the output step's short band plus 2 rows a side (225 +
    4 rows).  Then the zero-row calls of an empty band: the depthwise
    forward and dk, batch_norm_sums, apply, grad_sums_local and dx
    return their empty (or zero) results with no launch, and
    batch_norm_finish_apply on no rows finishes the statistics and the
    running update alone (one launch, equal to its plain version);
    disc_conv1 with no output row returns it with no launch."""
    from s2r_tpu_torch.models.mobilenet import block_plan

    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    n, eps, mom = UNEVEN_BATCH, 1e-5, 0.1
    hw = (UNEVEN_HW, UNEVEN_HW)
    dw_at, bn_at = layer_shapes(hw)
    worst_dk, dw_rows = 0.0, []
    for c, h, w, d in sorted(set(dw_at)):
        rows = short_band(UNEVEN_HW, h, 16)[0] + 2 * d
        dw_rows.append(f"C{c} {rows}x{w} d{d}")
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((n, rows, w, c), dtype, gen)
            g = randn((n, rows, w, c), dtype, gen)
            g[:, :d] = 0
            g[:, rows - d:] = 0
            k = (randn((3, 3, c), torch.float32, gen) / 3).to(dtype)
            dw_check(dw, x, k, d)
            dw_check(dw, g, k.flip((0, 1)).contiguous(), d)
            worst_dk = max(worst_dk, dk_check(dw, x, g, d)[2])
    bn_shapes = sorted(set(s for s in bn_at if s[1] > 1))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for c, h, w in bn_shapes:
        rows = short_band(UNEVEN_HW, h, 16)[0]
        m, count = n * rows * w, n * (h + 2) * (w + 2)
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 1e-4
            x = randn((m, c), dtype, gen)
            g = randn((m, c), dtype, gen)
            weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
            bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
            gshift = torch.randn(c, device=DEV, generator=gen)
            run = [0.1 * torch.randn(c, device=DEV, generator=gen),
                   0.5 + torch.rand(c, device=DEV, generator=gen)]
            run_p = [t.clone() for t in run]
            stats = bn.batch_norm_stats(x, weight, bias, count, eps, *run,
                                        mom)
            stats_p = bn.batch_norm_stats_plain(x, weight, bias, count, eps,
                                                *run_p, mom)
            y = bn.batch_norm_apply(x, stats[bn.INV], stats[bn.SHIFT])
            grads = bn.batch_norm_grad_sums(g, x, stats, gshift, count)
            sums = bn.batch_norm_sums(x)
            sums_in = sums.clone()
            fin_y = bn.batch_norm_finish_apply(x, sums, weight, bias, count,
                                               eps)
            local = bn.batch_norm_grad_sums_local(g, x, sums, gshift)
            local_in = local.clone()
            fin = bn.batch_norm_grad_finish(local, sums, count)
            dx = bn.batch_norm_dx(g, x, stats[bn.INV], grads[bn.COEF_B],
                                  grads[bn.COEF_C0])
            torch.cuda.synchronize()
            pairs = {
                "stats": (stats, stats_p),
                "running": (torch.stack(run), torch.stack(run_p)),
                "apply": (y.view(1, -1), bn.batch_norm_apply_plain(
                    x, stats[bn.INV], stats[bn.SHIFT]).view(1, -1)),
                "grad_sums": (grads, bn.batch_norm_grad_sums_plain(
                    g, x, stats, gshift, count)),
                "sums": (sums_in[:2], bn.batch_norm_sums_plain(x)[:2]),
                "finish_apply": (sums, bn.batch_norm_finish_plain(
                    sums_in, weight, bias, count, eps)),
                "finish_apply y": (fin_y.view(1, -1),
                                   bn.batch_norm_apply_plain(
                                       x, sums[bn.INV],
                                       sums[bn.SHIFT]).view(1, -1)),
                "grad_sums_local": (local_in[:4],
                                    bn.batch_norm_grad_sums_local_plain(
                                        g, x, sums, gshift)[:4]),
                "grad_finish": (fin, bn.batch_norm_grad_finish_plain(
                    local_in, sums, count)),
                "dx": (dx.view(1, -1), bn.batch_norm_dx_plain(
                    g, x, stats[bn.INV], grads[bn.COEF_B],
                    grads[bn.COEF_C0]).view(1, -1))}
            e = {key: max(bn_rel(u, v)) for key, (u, v) in pairs.items()}
            require(max(e.values()) <= tol,
                    f"14a uneven batchnorm {(n, c, rows, w)} {dtype}: rel "
                    f"errs {e} > {tol}")
            worst[dtype] = max(worst[dtype], max(e.values()))
    disc_rows = short_band(UNEVEN_HW, UNEVEN_HW, 32)[0] + 4
    disc_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, x, k, b = disc_inputs(n, 19, disc_rows, UNEVEN_HW, 64, dtype, gen)
        disc_err[dtype] = disc_check(dc, x, k, b)[1]
    # the zero-row calls of an empty band
    wrappers = (dw.depthwise_conv3x3, dw.depthwise_dk, bn.batch_norm_sums,
                bn.batch_norm_apply, bn.batch_norm_grad_sums_local,
                bn.batch_norm_dx, bn.batch_norm_finish_apply, dc.disc_conv1)
    before = {f.__name__: f.launches for f in wrappers}
    c, w = 96, UNEVEN_HW
    x0 = torch.empty((n, 0, w, c), device=DEV)
    k = torch.randn((3, 3, c), device=DEV, generator=gen)
    require(dw.depthwise_conv3x3(x0, k, 2).shape == x0.shape
            and not dw.depthwise_dk(x0, x0, 2).any(),
            "14a zero rows: depthwise")
    e0 = torch.empty((0, c), device=DEV)
    weight = 1 + 0.1 * torch.randn(c, device=DEV, generator=gen)
    bias = 0.1 * torch.randn(c, device=DEV, generator=gen)
    gshift = torch.randn(c, device=DEV, generator=gen)
    sums = torch.zeros((bn.STAT_ROWS, c), device=DEV)
    sums[:2] = torch.rand((2, c), device=DEV, generator=gen) + 1
    sums_p = sums.clone()
    run = [torch.zeros(c, device=DEV), torch.ones(c, device=DEV)]
    run_p = [t.clone() for t in run]
    count = n * (UNEVEN_HW + 2) * (w + 2)
    require(not bn.batch_norm_sums(e0).any(), "14a zero rows: sums")
    y0 = bn.batch_norm_finish_apply(e0, sums, weight, bias, count, 1e-5,
                                    *run, 0.1)
    bn.batch_norm_finish_apply_plain(e0, sums_p, weight, bias, count, 1e-5,
                                     *run_p, 0.1)
    local = bn.batch_norm_grad_sums_local(e0, e0, sums, gshift)
    local_p = bn.batch_norm_grad_sums_local_plain(e0, e0, sums, gshift)
    torch.cuda.synchronize()
    zero_err = max(max(bn_rel(sums, sums_p)),
                   max(bn_rel(torch.stack(run), torch.stack(run_p))),
                   max(bn_rel(local[:4], local_p[:4])))
    require(y0.shape == e0.shape and zero_err <= 1e-5
            and bn.batch_norm_apply(e0, weight, bias).shape == e0.shape
            and bn.batch_norm_dx(e0, e0, weight, bias, gshift).shape
            == e0.shape, f"14a zero rows: batchnorm rel err {zero_err}")
    _, x1, kd, bd = disc_inputs(n, 19, 1, w, 64, torch.bfloat16, gen)
    require(dc.disc_conv1(x1, kd, bd).shape == (n, 0, w // 2, 64),
            "14a zero rows: disc_conv1")
    moved = {f.__name__: f.launches - before[f.__name__] for f in wrappers}
    require(moved == {**dict.fromkeys(before, 0),
                      "batch_norm_finish_apply": 1},
            f"14a zero rows: launches {moved}")
    log(f"[14a uneven shapes] the short band of {UNEVEN_HW} rows over "
        f"{SPATIAL} ranks, batch {n}: depthwise forward, dx and dk at "
        f"{len(dw_rows)} bands plus halo ({', '.join(dw_rows)}; worst dk "
        f"rel err {worst_dk:.3g}); all eight BatchNorm entries at "
        f"{len(bn_shapes)} short-band shapes, worst rel err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; "
        f"disc_conv1 at {n}x{disc_rows}x19x{UNEVEN_HW} max_abs_err f32 "
        f"{disc_err[torch.float32]:.3g}, bf16 "
        f"{disc_err[torch.bfloat16]:.3g}: all at phase 2's tolerances; "
        "zero rows: the depthwise forward and dk, batch_norm_sums, apply, "
        "grad_sums_local, dx and disc_conv1 returned their empty results "
        "with no launch, finish_apply finished the statistics in one "
        f"(rel err {zero_err:.3g} against its plain version)")


def uneven_phase(smi, check_refs):
    """Phase 14f-h through tools/dist_check.py, 2 gloo ranks on the one
    card, one spawn.  (f) The source-only step at UNEVEN_HW x UNEVEN_HW
    batch UNEVEN_BATCH bf16, 2 steps, over 1 x 2 ranks (bands of 272 and
    241 rows) against one process on the card, at 14b's bounds with the
    bf16 spread (one process in bf16 against float32, both on the card) in
    the place of the float32 one.  (g) --eval-spatial-shard at UNEVEN_HW
    (bands of 288 and 225 rows, the output method's stride 32), batch
    UNEVEN_EVAL_BATCH float32, against one process: loss rtol 1e-5,
    labels > 0.999 equal, the confusion matrix equal but for labels at
    near-ties.  (h) The padded output step at world 2 (UNEVEN_PAD_REAL
    real samples padded to UNEVEN_PAD_TO; rank 0 holds the real ones,
    rank 1 padding only) at phase 10b's check (DIST_CHECK_HW float32,
    DIST_STEPS steps) against one process's padded step on the card, at
    10b's bounds (its CPU run gives the float32 spread); rank 1 launches
    no BatchNorm sums (no real rows).  Then (f) timed: ms/step a rank
    (median of 5 after 2 warm-up, host clock around synchronized steps),
    all-reduces and halo gathers a step, peak memory a rank, against one
    process timed alone after the ranks.  Returns {path: launches summed
    over the ranks}."""
    from s2r_tpu_torch.core.mesh import band_bounds, band_rows
    from s2r_tpu_torch.tools import dist_check

    _, cpu = check_refs
    bands = {u: [b1 - b0 for b0, b1 in (band_bounds(
        UNEVEN_HW, band_rows(UNEVEN_HW, SPATIAL, u), s)
        for s in range(SPATIAL))] for u in (16, 32)}
    so = dict(kind="steps", method="source_only", hw=UNEVEN_HW,
              batch=UNEVEN_BATCH, steps=DIST_STEPS, precision="bf16",
              spatial=SPATIAL)
    evals = dict(kind="eval", method="output_adapt", hw=UNEVEN_HW,
                 batch=UNEVEN_EVAL_BATCH, precision="f32", spatial=SPATIAL,
                 eval_spatial=True)
    pad = dict(kind="steps", method="output_adapt", hw=list(DIST_CHECK_HW),
               batch=UNEVEN_PAD_REAL, steps=DIST_STEPS, precision="f32",
               pad_to=UNEVEN_PAD_TO)
    timing = dict(kind="timing", method="source_only", hw=UNEVEN_HW,
                  batch=UNEVEN_BATCH, precision="bf16", warmup=2, timed=5,
                  spatial=SPATIAL)
    t0 = time.perf_counter()
    ranks = dist_check.start({"tasks": [so, evals, pad, timing]}, SPATIAL,
                             DEV, backend="gloo", timeout=600)
    one = dist_check.run_tasks({"tasks": [
        dict(so, spatial=1), dict(so, spatial=1, precision="f32"),
        dict(evals, spatial=1, eval_spatial=False, ties=True),
        dict(pad)]}, torch.device(DEV, 0))
    torch.cuda.empty_cache()
    ranks = ranks.results()
    spawn_s = time.perf_counter() - t0
    # one process timed alone, after the ranks
    one_tm = dist_check.run_tasks({"tasks": [dict(timing, spatial=1)]},
                                  torch.device(DEV, 0))[0]
    torch.cuda.empty_cache()
    # (f) bf16 against one process, the bf16 spread for float32's
    leaf, worst, _, value, stats_err = against_one_process(
        "14f", [r[0] for r in ranks], one[0], one[1], loss_spread=True,
        spread_first=True, losses=("task_loss",))
    want = {k: v * DIST_STEPS for k, v in step_launches(
        "source_only", world=SPATIAL, spatial=SPATIAL).items()}
    for r in ranks:
        require(r[0]["kernel_launches"] == want,
                f"14f rank launches {r[0]['kernel_launches']}, expected "
                f"{want}")
    got, ref = ranks[0][0], one[0]
    log(f"[14f uneven step] source-only {UNEVEN_HW}x{UNEVEN_HW} batch "
        f"{UNEVEN_BATCH} bf16 over 1 x {SPATIAL} ranks (bands of "
        f"{bands[16]} rows) on one card (gloo), {DIST_STEPS} steps against "
        "one process on the card: task_loss (ranks / one process bf16 / f32) "
        + "; ".join(f"step {i} {got['metrics'][i]['task_loss']:.7g}/"
                    f"{ref['metrics'][i]['task_loss']:.7g}/"
                    f"{one[1]['metrics'][i]['task_loss']:.7g}"
                    for i in range(DIST_STEPS))
        + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}; bf16 "
        f"against f32 {leaf[worst][1]:.3g}), G after the steps worst leaf "
        f"{value:.3g}; BatchNorm running stats {stats_err:.3g}; ranks "
        f"bit-equal; {got['gathers_per_step']:.0f} halo gathers a step; "
        f"launches as predicted ({spawn_s:.1f} s the spawn and the "
        f"one-process runs) ({smi})")
    # (g) --eval-spatial-shard at 513 against one process
    ev, one_eval = [r[1] for r in ranks], one[2]
    loss = sum(e["loss"] for e in ev)
    cm = sum(e["confusion"] for e in ev)
    pred = torch.cat([e["pred"] for e in ev], dim=1)
    differ = pred != one_eval["pred"]
    agree = 1.0 - float(differ.double().mean())
    flips = int(differ.sum())
    cm_l1 = int((cm - one_eval["confusion"]).abs().sum())
    require([e["pred"].shape[1] for e in ev] == bands[32],
            f"14g bands {[e['pred'].shape[1] for e in ev]}")
    require(abs(loss - one_eval["loss"]) <= 1e-5 * abs(one_eval["loss"]),
            f"14g eval loss {loss}, one process {one_eval['loss']}")
    require(agree > 0.999, f"14g label agreement {agree}")
    require(not (differ & ~one_eval["ties"]).any() and cm_l1 <= 2 * flips,
            f"14g confusion matrix off one process's by {cm_l1} counts; "
            f"{int((differ & ~one_eval['ties']).sum())} of {flips} "
            "differing labels are not near-ties")
    log(f"[14g uneven eval] --eval-spatial-shard over {SPATIAL} ranks, "
        f"{UNEVEN_HW}x{UNEVEN_HW} batch {UNEVEN_EVAL_BATCH} f32 (bands of "
        f"{bands[32]} rows): loss {loss:.9g} against one process "
        f"{one_eval['loss']:.9g}, labels {100 * agree:.5f}% equal ({flips} "
        f"differ, all at near-ties), confusion matrix off by {cm_l1} "
        f"counts, {ev[0]['gathers']} halo gathers and {ev[0]['collectives']}"
        " all-reduces a forward")
    # (h) the padded step at world 2 against one process's
    leaf, worst, sign, value, stats_err = against_one_process(
        "14h", [r[2] for r in ranks], one[3], cpu)
    per_step = step_launches("output_adapt", world=SPATIAL)
    for i, r in enumerate(ranks):
        want = {k: v * DIST_STEPS for k, v in per_step.items()}
        if i:  # padding only: no real rows to sum, nor their dx
            want.update(batch_norm_sums=0, batch_norm_grad_sums_local=0,
                        batch_norm_dx=0)
        require(r[2]["kernel_launches"] == want,
                f"14h rank {i} launches {r[2]['kernel_launches']}, "
                f"expected {want}")
    got, ref = ranks[0][2], one[3]
    log(f"[14h padded step] output step at {DIST_CHECK_HW[1]}x"
        f"{DIST_CHECK_HW[0]}, {UNEVEN_PAD_REAL} real samples padded to "
        f"{UNEVEN_PAD_TO} over {SPATIAL} ranks (rank 1 padding only) f32, "
        f"{DIST_STEPS} steps against one process's padded step: losses "
        + "; ".join(f"step {i} " + ", ".join(
            f"{k} {got['metrics'][i][k]:.7g}/{ref['metrics'][i][k]:.7g}"
            for k in ("seg_loss", "adv_loss", "d_loss"))
            for i in range(DIST_STEPS))
        + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}), D sign "
        f"agreement {100 * sign:.3f}%, BatchNorm running stats "
        f"{stats_err:.3g}; ranks bit-equal; rank 1 launched no "
        "batch_norm_sums, grad_sums_local or dx")
    tm = [r[3] for r in ranks]
    per_step = step_launches("source_only", world=SPATIAL, spatial=SPATIAL)
    for r in tm:
        want = {k: v * 7 for k, v in per_step.items()}
        require(r["kernel_launches"] == want,
                f"14f timed rank launches {r['kernel_launches']}, expected "
                f"{want}")
        require(r["ranks_equal"] and all(np.isfinite(v) for v in
                                         r["losses"].values()),
                f"14f timed: ranks differ or losses not finite "
                f"{r['losses']}")
    ms = [statistics.median(t["ms"]) for t in tm]
    log(f"[14f uneven step timed] source-only {UNEVEN_HW}x{UNEVEN_HW} "
        f"batch {UNEVEN_BATCH} bf16: " + ", ".join(
            f"rank {i} ({rows} rows) {m:.3f} ms/step (median of 5: "
            + ", ".join(f"{v:.3f}" for v in t["ms"]) + ")"
            for i, (rows, m, t) in enumerate(zip(bands[16], ms, tm)))
        + f"; one process {statistics.median(one_tm['ms']):.3f} (median "
        "of 5: " + ", ".join(f"{v:.3f}" for v in one_tm["ms"]) + "); "
        f"{tm[0]['collectives_per_step']:.0f} all-reduces "
        f"({tm[0]['elements_per_step'] / 1e6:.3f}M elements) and "
        f"{tm[0]['gathers_per_step']:.0f} halo gathers "
        f"({tm[0]['halo_elements_per_step'] / 1e6:.3f}M elements sent) a "
        "step; peak " + ", ".join(f"{t['peak_gib'] or 0:.3f}" for t in tm)
        + f" GiB a rank, one process {one_tm['peak_gib'] or 0:.3f}; gloo "
        f"moves every collective through the host ({smi})")
    paths = {"uneven_source_only_step": {}, "uneven_eval": {},
             "padded_step_world2": {}, "uneven_source_only_timed": {}}
    for r in ranks:
        for path, task in zip(paths, range(4)):
            for k, v in r[task]["kernel_launches"].items():
                paths[path][k] = paths[path].get(k, 0) + v
    require(paths["uneven_eval"]["depthwise_conv3x3"] > 0,
            "14g: the eval launched no depthwise kernel")
    return paths


# phase 15: the devices JAX idles (ROADMAP A.10) and the rest of the data
# path (A.4).  A world of IDLE_WORLD ranks at 10b's global batch of 4: JAX
# takes 2 devices, the port ranks 0-1; --spatial-shard 2 at batch 3 over 4
# ranks (3 does not divide the 2 data rows): one data row x 2 bands, ranks
# 2-3 idle.  (At batch 1 ASPP's pooled BatchNorm would normalize one value
# a channel, where float32 rounding alone moves the step past 10b's
# bounds.)
IDLE_WORLD = 3
IDLE_SPATIAL_WORLD, IDLE_SPATIAL_BATCH = 4, 3
IDLE_TRAINER_HW = 128
# the SHA-256 of rest_digest's calls; tests/test_torch_port_data_rest.py
# holds PIL's and the JAX package's libpng decoder's outputs on the same
# calls to it
REST_DIGEST = ("c9fd42758381a50ed1fca7ed18b6e1af"
               "d531f64ffa136642de13af6a0f743a5d")
REST_ROTATE = 20  # RandomRotate's degree in rest_digest
# gamma chunks of rest_digest's RGB labels: gAMA 45455, 100000 and
# 220000, sRGB, cHRM with gAMA
_CHRM = (31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)
REST_GAMMA = ((("gAMA", (45455,)),), (("gAMA", (100000,)),),
              (("gAMA", (220000,)),), (("sRGB", None),),
              (("cHRM", _CHRM), ("gAMA", (45455,))))
JPEG_COPIES = 16  # copies of the 2048x1024 JPEG fixture among the frames


def png_bytes(samples, color, depth, chunks=()):
    """A PNG of `samples` ([H, W] or [H, W, C], values below 2**depth, at
    8 or 16 bits), rows unfiltered, with `chunks` ((kind, big-endian
    uint32 fields or None for sRGB's one byte 0), ...) after IHDR."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w = samples.shape[:2]
    rows = np.ascontiguousarray(samples.astype(
        ">u2" if depth == 16 else np.uint8)).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    extra = b"".join(chunk(k.encode(), b"\0" if v is None else
                           struct.pack(f">{len(v)}I", *v))
                     for k, v in chunks)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, 0)) + extra
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def rest_digest(rotate, decode16, gray):
    """SHA-256 over RandomRotate(REST_ROTATE) of seeded samples
    (rotate(sample, rng) -> {key: uint8 array}, an RGB image and a label),
    16-bit gray and gray+alpha PNGs as raw samples and as RGB
    (decode16(data, rgb)), and the one channel of 8-bit RGB and RGBA PNGs
    under each of REST_GAMMA's chunks (gray(data))."""
    import hashlib
    import random

    rs, h = np.random.RandomState(SEED), hashlib.sha256()
    for i in range(6):
        ih, iw = (int(v) for v in rs.randint(9, 80, 2))
        sample = {"image": rs.randint(0, 256, (ih, iw, 3)).astype(np.uint8),
                  "label": rs.randint(0, 19, (ih, iw)).astype(np.uint8)}
        for v in rotate(sample, random.Random(i)).values():
            h.update(np.ascontiguousarray(v, np.uint8).tobytes())
    for i in range(4):
        ih, iw = (int(v) for v in rs.randint(1, 40, 2))
        v = rs.randint(0, 65536, (ih, iw))
        la = np.stack([v, rs.randint(0, 65536, (ih, iw))], -1)
        for data in (png_bytes(v, 0, 16), png_bytes(la, 4, 16)):
            for rgb in (False, True):
                h.update(np.ascontiguousarray(decode16(data, rgb),
                                              np.uint8).tobytes())
    for chunks in REST_GAMMA:
        for color, ch in ((2, 3), (6, 4)):
            ih, iw = (int(v) for v in rs.randint(1, 40, 2))
            data = png_bytes(rs.randint(0, 256, (ih, iw, ch)), color, 8,
                             chunks)
            h.update(np.ascontiguousarray(gray(data), np.uint8).tobytes())
    return h.hexdigest()


def idle_phase(smi, check_refs, dist_ms):
    """Phase 15a-c: gloo ranks on the one card, tools/dist_check.py
    ``subworld`` specs.  (a) IDLE_WORLD ranks at 10b's check (global
    batch 4, which 3 does not divide: JAX's count 2): ranks 0-1 against
    10b's one-process runs at 10b's bounds, launches as
    step_launches(world=2) predicts, 249 all-reduces a step; then the
    output step at the train cell timed (ms/step a rank beside 10b's two
    ranks, `dist_ms`).  (b) The Trainer with --num-devices 2 (one epoch
    and its validation, IDLE_TRAINER_HW batch 4 float32): the initial
    validation's confusion matrix against one process (the same pixels,
    labels differing on at most 0.2% at float32 near-ties), best_pred
    the same on both ranks, rank 0 alone writing the run directory.  (c)
    IDLE_SPATIAL_WORLD ranks at --spatial-shard 2, batch 3 (JAX: one data
    row x 2 bands): 10b's check at that batch against one process on the
    card and the CPU, at 10b's bounds (after the first step a loss
    within 3x its float32 spread), launches as step_launches(world=2,
    spatial=2) predicts.  Every idle rank: no collective after set-up,
    no kernel launch, no device memory (the allocator's peak 0), the end
    barrier passed once a Trainer, exit 0.  Returns ({path: launches
    summed over the ranks}, summary)."""
    from s2r_tpu_torch.tools import dist_check

    ref, cpu = check_refs
    check = dict(kind="steps", method="output_adapt",
                 hw=list(DIST_CHECK_HW), batch=DIST_CHECK_BATCH,
                 steps=DIST_STEPS, precision="f32")
    timing = dict(kind="timing", method="output_adapt", hw=list(TRAIN_HW),
                  batch=BATCH, precision="bf16", warmup=2, timed=5)
    sp = dict(check, batch=IDLE_SPATIAL_BATCH, spatial=SPATIAL)
    root = tempfile.mkdtemp(prefix="s2r_idle_")
    trainer = dict(kind="trainer", hw=IDLE_TRAINER_HW,
                   batch=DIST_CHECK_BATCH, precision="f32", train_steps=2,
                   run_root=os.path.join(root, "three"), num_devices=2)
    try:
        t0 = time.perf_counter()
        three = dist_check.spawn(
            {"subworld": {"batch": DIST_CHECK_BATCH},
             "tasks": [check, trainer, timing]}, IDLE_WORLD, DEV,
            backend="gloo", timeout=600)
        three_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = dist_check.start(
            {"subworld": {"batch": IDLE_SPATIAL_BATCH, "spatial": SPATIAL},
             "tasks": [sp]}, IDLE_SPATIAL_WORLD, DEV, backend="gloo",
            timeout=600)
        one_tr = dist_check.run_tasks({"tasks": [dict(
            trainer, run_root=os.path.join(root, "one"), num_devices=None)]},
            torch.device(DEV, 0))[0]
        one_sp = dist_check.run_tasks({"tasks": [dict(sp, spatial=1)]},
                                      torch.device(DEV, 0))[0]
        torch.cuda.empty_cache()
        cpu_sp = dist_check.run_tasks({"tasks": [dict(sp, spatial=1)]},
                                      "cpu")[0]
        four = four.results()
        four_s = time.perf_counter() - t0
        runs = sorted(os.listdir(os.path.join(root, "three", "synthetic",
                                              "deeplab-mobilenet")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    zero = dict.fromkeys(ref["kernel_launches"], 0)
    for tag, idle, fits in (("15a", three[2:], 1), ("15c", four[2:], 0)):
        for r in idle:
            for t in r:
                require(t["idle"] and t["collectives"] == 0
                        and t["peak_bytes"] == 0
                        and t["end_barriers"] == fits
                        and t["kernel_launches"] == zero,
                        f"{tag} idle rank: {t}")
    # (a) the sub-world's check and its timed step
    active = three[:2]
    leaf, worst, sign, value, stats_err = against_one_process(
        "15a", [r[0] for r in active], ref, cpu)
    per_step = step_launches("output_adapt", world=2)
    for r in active:
        for task, steps in ((0, DIST_STEPS), (2, 7)):
            want = {k: v * steps for k, v in per_step.items()}
            require(r[task]["kernel_launches"] == want,
                    f"15a rank launches {r[task]['kernel_launches']}, "
                    f"expected {want}")
            require(r[task]["collectives_per_step"] == DIST_COLLECTIVES,
                    f"15a all-reduces a step "
                    f"{r[task]['collectives_per_step']}")
    got = active[0][0]
    log(f"[15a idle check] {IDLE_WORLD} gloo ranks on one card, global "
        f"batch {DIST_CHECK_BATCH} (JAX's count 2: ranks 0-1 step, rank 2 "
        f"idles), {DIST_CHECK_HW[1]}x{DIST_CHECK_HW[0]} f32, {DIST_STEPS} "
        "steps against 10b's one process: losses " + "; ".join(
            f"step {i} " + ", ".join(
                f"{k} {got['metrics'][i][k]:.7g}/{ref['metrics'][i][k]:.7g}"
                for k in ("seg_loss", "adv_loss", "d_loss"))
            for i in range(DIST_STEPS))
        + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}), G after "
        f"the steps {value:.3g}; D sign agreement {100 * sign:.3f}%; "
        f"BatchNorm running stats {stats_err:.3g}; ranks bit-equal; "
        f"{DIST_COLLECTIVES} all-reduces a step; the idle rank: 0 "
        "collectives after set-up, 0 launches, allocator peak 0 bytes, one "
        f"end barrier ({three_s:.1f} s the spawn of all three tasks)")
    tm = [r[2] for r in active]
    ms = [statistics.median(t["ms"]) for t in tm]
    log(f"[15a idle step] {TRAIN_HW[1]}x{TRAIN_HW[0]} global batch {BATCH} "
        f"bf16 over ranks 0-1 of {IDLE_WORLD}: " + ", ".join(
            f"rank {i} {m:.3f} ms/step (median of 5: "
            + ", ".join(f"{v:.3f}" for v in t["ms"]) + ")"
            for i, (m, t) in enumerate(zip(ms, tm)))
        + f"; 10b's world of 2 {dist_ms:.3f}; peak "
        + ", ".join(f"{t['peak_gib'] or 0:.3f}" for t in tm)
        + f" GiB a rank; gloo through the host ({smi})")
    # (b) the Trainer at --num-devices 2 of 3
    trs = [r[1] for r in active]
    cm1 = one_tr["confusion"]
    for t in trs:
        off = int(np.abs(t["confusion"] - cm1).sum())
        require(int(t["confusion"].sum()) == int(cm1.sum()) > 0
                and off <= 2 * 2e-3 * int(cm1.sum()),
                f"15b validation confusion off one process's by {off}")
        require(t["best_pred"] == trs[0]["best_pred"] and t["ranks_equal"]
                and all(np.isfinite(v) for m in t["train_means"]
                        for v in m.values()),
                f"15b ranks differ or losses not finite: {t['train_means']}")
    require("experiment_0" in runs, f"15b run directory {runs}")
    log(f"[15b idle trainer] Trainer --num-devices 2 of {IDLE_WORLD} ranks, "
        f"{IDLE_TRAINER_HW}x{IDLE_TRAINER_HW} batch {DIST_CHECK_BATCH} f32, "
        "one epoch and its validation: initial confusion matrix off one "
        f"process's by {int(np.abs(trs[0]['confusion'] - cm1).sum())} of "
        f"{int(cm1.sum())} counts, best_pred {trs[0]['best_pred']:.6g} on "
        f"both ranks (one process {one_tr['best_pred']:.6g}), losses "
        + ", ".join(f"{k} {v:.5g}" for k, v in trs[0]["train_means"][0]
                    .items() if k != "images_per_sec")
        + f"; run directory {runs} written by rank 0")
    # (c) --spatial-shard 2 at batch 1 over 4: 1 x 2 and two idle
    leaf, worst, sign, value, stats_err = against_one_process(
        "15c", [r[0] for r in four[:2]], one_sp, cpu_sp, loss_spread=True)
    want = {k: v * DIST_STEPS for k, v in step_launches(
        "output_adapt", world=2, spatial=SPATIAL).items()}
    for r in four[:2]:
        require(r[0]["kernel_launches"] == want,
                f"15c rank launches {r[0]['kernel_launches']}, expected "
                f"{want}")
    got = four[0][0]
    log(f"[15c idle spatial] {IDLE_SPATIAL_WORLD} gloo ranks at "
        f"--spatial-shard {SPATIAL}, batch {IDLE_SPATIAL_BATCH} (JAX: 1 data"
        f" x {SPATIAL} bands, ranks 2-3 idle), {DIST_CHECK_HW[1]}x"
        f"{DIST_CHECK_HW[0]} f32, {DIST_STEPS} steps against one process "
        "(card / CPU): losses " + "; ".join(
            f"step {i} " + ", ".join(
                f"{k} {got['metrics'][i][k]:.7g}/{one_sp['metrics'][i][k]:.7g}"
                f"/{cpu_sp['metrics'][i][k]:.7g}"
                for k in ("seg_loss", "adv_loss", "d_loss"))
            for i in range(DIST_STEPS))
        + f"; G update worst leaf {leaf[worst][0]:.3g} ({worst}), D sign "
        f"agreement {100 * sign:.3f}%, BatchNorm running stats "
        f"{stats_err:.3g}; {got['gathers_per_step']:.0f} halo gathers a "
        f"step; idle ranks silent ({four_s:.1f} s with the references)")
    paths = {"idle_step_check": {}, "idle_trainer": {}, "idle_step": {},
             "idle_spatial_check": {}}
    for ranks, tasks in ((active, ("idle_step_check", "idle_trainer",
                                   "idle_step")),
                         (four[:2], ("idle_spatial_check",))):
        for r in ranks:
            for task, path in enumerate(tasks):
                for k, v in r[task]["kernel_launches"].items():
                    paths[path][k] = paths[path].get(k, 0) + v
    return paths, {"idle_ms_per_step": max(ms)}


def host_rest_phase(counted, smi, carry):
    """Phase 15d: the host library built on the card against PIL's and
    libpng's results recorded here.  Every JPEG fixture
    (s2r_tpu_torch/data/jpeg_fixtures) decodes to the SHA-256 of PIL's
    decode in digests.json; rest_digest of RandomRotate, 16-bit gray and
    gamma-chunk gray is REST_DIGEST; the 2048x1024 fixture's decode timed
    (median of 10, host clock).  Then cli.infer over .jpg frames (JPEG_COPIES
    copies of that frame and the smaller fixtures, resized on the host)
    with phase 5's final state exported at FULL_HW batch BATCH rgb8, exact
    and decoder-int8: labels equal to make_serving_fn on the same decoded,
    resized batch, 14 depthwise launches a batch and 1 requant a batch in
    int8 mode, ms/image including host IO.  Returns ({path: launches},
    summary)."""
    import hashlib

    from s2r_tpu_torch.cli import export, infer
    from s2r_tpu_torch.data import imaging, native
    from s2r_tpu_torch.data.transforms import RandomRotate
    from s2r_tpu_torch.io.serving import load_servable, make_serving_fn

    fixtures = os.path.join(REPO, "s2r_tpu_torch", "data", "jpeg_fixtures")
    with open(os.path.join(fixtures, "digests.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        got = imaging.load_rgb(os.path.join(fixtures, name))
        require(list(got.shape) == want["shape"] and hashlib.sha256(
            got.tobytes()).hexdigest() == want["sha256"],
            f"15d: {name} decodes to other bytes than PIL's")
    big = os.path.join(fixtures, "frame_2048x1024.jpg")
    with open(big, "rb") as f:
        data = f.read()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        imaging.decode_jpeg(data)
        times.append(1e3 * (time.perf_counter() - t0))
    decode_ms = statistics.median(times)
    rotate = RandomRotate(REST_ROTATE)
    rest = rest_digest(rotate, imaging.decode_png,
                       lambda d: native.decode_png(d, 1))
    require(rest == REST_DIGEST, f"15d rest digest {rest}")
    log(f"[15d host] {len(digests)} JPEG fixtures decode to PIL's bytes "
        "(digests.json); RandomRotate, 16-bit gray and gamma-chunk gray "
        f"hash to REST_DIGEST; the 2048x1024 JPEG decodes in {decode_ms:.3f}"
        " ms (median of 10: " + ", ".join(f"{t:.3f}" for t in times)
        + ", host clock, one thread)")
    os.environ.pop("S2R_PLATFORM", None)
    root = tempfile.mkdtemp(prefix="s2r_jpeg_")
    by_path = {}
    summary = {"jpeg_decode_ms": decode_ms}
    try:
        frames = os.path.join(root, "frames")
        os.makedirs(frames)
        for i in range(JPEG_COPIES):
            shutil.copyfile(big, os.path.join(frames, f"city{i:02d}.jpg"))
        for name in digests:
            if name != "frame_2048x1024.jpg":
                shutil.copyfile(os.path.join(fixtures, name),
                                os.path.join(frames, name))
        paths = infer.list_frames(frames)
        n_batches = -(-len(paths) // BATCH)
        argv = ADAPT_ARGV + [
            "--run-root", os.path.join(root, "run"), "--resume",
            carry["adapt"]["ckpt"], "--format", "servable", "--serve-shape",
            str(BATCH), str(FULL_HW[0]), str(FULL_HW[1]), "--serve-input",
            "rgb8"]
        for mode, extra in (("exact", []),
                            ("int8", ["--serve-quant", "decoder-int8"])):
            path = os.path.join(root, f"{mode}.s2rt")
            export.main(argv + extra + ["--out", path])
            res, launches, _ = drive(
                counted, lambda a: infer.main(a, keep_predictions=True),
                ["--servable", path, "--images", frames, "--out-dir",
                 os.path.join(root, f"out_{mode}")])
            want = dict.fromkeys(launches, 0)
            want.update(depthwise_conv3x3=14 * n_batches,
                        requant_s32_to_s8=n_batches if mode == "int8" else 0)
            require(res["images"] == len(paths) and launches == want,
                    f"15d infer {mode}: {res['images']} images, launches "
                    f"{launches}, expected {want}")
            by_path[f"infer_jpeg_{mode}"] = launches
            serve = load_servable(path, DEV)
            fn = make_serving_fn(serve.model, input="rgb8",
                                 quant=serve.meta["quant"],
                                 quant_scales=serve.meta["quant_scales"])
            for i in range(0, len(paths), BATCH):
                chunk = paths[i:i + BATCH]
                batch = np.stack([infer.decode_frame(p, *FULL_HW, "rgb8")
                                  for p in chunk])
                if len(chunk) < BATCH:
                    batch = np.concatenate([batch, np.repeat(
                        batch[-1:], BATCH - len(chunk), 0)])
                labels = fn(torch.from_numpy(batch)).cpu().numpy()
                require(all(np.array_equal(res["predictions"][p], labels[j])
                            for j, p in enumerate(chunk)),
                        f"15d infer {mode}: labels differ from "
                        "make_serving_fn on the same frames")
            del serve, fn, res["predictions"]
            sec = res["seconds"]
            summary[f"infer_jpeg_{mode}_ms_per_image"] = res["ms_per_image"]
            log(f"[15d infer jpeg {mode}] {len(paths)} .jpg frames "
                f"({JPEG_COPIES} at 2048x1024, {len(paths) - JPEG_COPIES} "
                f"small fixtures resized on the host) in {n_batches} batches"
                f" of {BATCH}: {res['ms_per_image']:.3f} ms/image including "
                f"host IO, steady-state {res['steady_ms_per_image']:.3f} "
                f"after batch 0; per image summed over threads: decode+resize"
                f" {1e3 * sec['decode'] / len(paths):.3f} ms, device "
                f"{1e3 * sec['device'] / len(paths):.3f} ms, save "
                f"{1e3 * sec['save'] / len(paths):.3f} ms; labels equal to "
                f"make_serving_fn; launches as predicted ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path, summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from s2r_tpu_torch.ops.kernels import batchnorm as bn
        from s2r_tpu_torch.ops.kernels import build
        from s2r_tpu_torch.ops.kernels import depthwise as dw
        from s2r_tpu_torch.ops.kernels import disc_conv as dc
        from s2r_tpu_torch.ops.kernels import requant as rq
    except ImportError as e:
        print(f"chip_smoke: s2r_tpu_torch not found beside {__file__}: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counted = (dw.depthwise_conv3x3, rq.requant_s32_to_s8, dw.depthwise_dk,
               bn.batch_norm_stats, bn.batch_norm_apply,
               bn.batch_norm_grad_sums, bn.batch_norm_dx, dc.disc_conv1,
               bn.batch_norm_sums, bn.batch_norm_finish_apply,
               bn.batch_norm_grad_sums_local, bn.batch_norm_grad_finish)
    t_start = time.perf_counter()
    # phases 5 and 6d hand phase 8 their checkpoints in this directory
    carry = {"dir": tempfile.mkdtemp(prefix="s2r_carry_")}
    try:
        t0 = time.perf_counter()
        libs = build.build_all()
        log(f"[build] {len(libs)} libraries built at once: the kernels "
            f"with nvcc ({' '.join(build.NVCC_FLAGS)}), the host libraries "
            f"{', '.join(build.HOST_SOURCES)} with g++ "
            f"({' '.join(build.GXX_FLAGS + build.GXX_LIBS)}), in "
            f"{time.perf_counter() - t0:.1f} s")
        smi = card()
        log(f"[card] {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        dw_entry = check_depthwise(dw)
        kernels = [dw_entry, check_requant(rq)]
        dk_entry, dw_train = check_depthwise_bwd(dw)
        bn_entries, bn_composite = check_batchnorm(bn)
        kernels += [dk_entry, *bn_entries, check_disc_conv1(dc)]
        torch.cuda.empty_cache()
        check_index_limits(dw, rq, dc)
        torch.cuda.empty_cache()
        serve_check_513(dw, rq)
        torch.cuda.empty_cache()
        ms, serve_launches, _, _ = serve_full(counted)
        torch.cuda.empty_cache()
        train_check_small(counted)
        torch.cuda.empty_cache()
        step_ms, train_launches, bn_copies = train_full(counted)
        torch.cuda.empty_cache()
        adapt_launches = train_adapt_phase(counted, carry)
        torch.cuda.empty_cache()
        feature_check_small(counted)
        torch.cuda.empty_cache()
        full = feature_full(counted)
        check_source_shapes(dw)
        torch.cuda.empty_cache()
        driver_launches = train_phase(counted, carry)
        torch.cuda.empty_cache()
        driver_launches.update(real_data_phase(counted, smi, carry))
        torch.cuda.empty_cache()
        driver_launches.update(checkpoint_phase(counted, smi, carry))
        torch.cuda.empty_cache()
        xdw_rows, xdw_totals = check_xception_depthwise(dw)
        torch.cuda.empty_cache()
        backbone_launches, backbones = backbones_phase(counted, smi, dw, rq,
                                                       carry)
        driver_launches.update(backbone_launches)
        torch.cuda.empty_cache()
        t10 = time.perf_counter()
        split_entries = check_split_batchnorm(bn)
        kernels += split_entries
        torch.cuda.empty_cache()
        dist_launches, dist_summary = dist_phase(smi)
        driver_launches.update(dist_launches)
        driver_launches["train_adapt_nccl_world1"] = nccl_world1_phase(
            counted)
        torch.cuda.empty_cache()
        split_launches, split_summary = split_concat_phase(counted, smi,
                                                           carry)
        driver_launches.update(split_launches)
        log(f"[10] phase 10 in {time.perf_counter() - t10:.1f} s")
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        driver_launches.update(native_phase(counted, smi, carry))
        log(f"[11] phase 11 in {time.perf_counter() - t11:.1f} s")
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        arms_launches, arms = arms_phase(counted, smi)
        driver_launches.update(arms_launches)
        log(f"[12] phase 12 in {time.perf_counter() - t12:.1f} s")
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        check_spatial_shapes(dw, bn, dc)
        torch.cuda.empty_cache()
        check_refs = dist_summary.pop("check_refs")
        spatial_launches, spatial = spatial_phase(smi, check_refs)
        driver_launches.update(spatial_launches)
        t14u = time.perf_counter()
        check_uneven_shapes(dw, bn, dc)
        torch.cuda.empty_cache()
        driver_launches.update(uneven_phase(smi, check_refs))
        torch.cuda.empty_cache()
        log(f"[14] phase 14 in {time.perf_counter() - t14:.1f} s, its "
            f"uneven bands and padding {time.perf_counter() - t14u:.1f} s")
        t15 = time.perf_counter()
        idle_launches, idle = idle_phase(
            smi, check_refs, dist_summary["dist_ms_per_step"])
        driver_launches.update(idle_launches)
        torch.cuda.empty_cache()
        rest_launches, rest = host_rest_phase(counted, smi, carry)
        driver_launches.update(rest_launches)
        torch.cuda.empty_cache()
        log(f"[15] phase 15 in {time.perf_counter() - t15:.1f} s")
        bn_entries[0]["composite"] = dict(
            bn_composite, ms_covers="one 512x1024 batch-8 bf16 train step: "
            "all four entries of 120 BatchNorm calls; library_ms: "
            "native_batch_norm + native_batch_norm_backward; sums_ms: "
            "batch_norm_stats + batch_norm_grad_sums against "
            "sums_library_ms: torch.batch_norm_stats + "
            "batch_norm_backward_reduce")
        bn_entries[2]["layout_copies_per_step"] = bn_copies
        for k in kernels:
            paths = {"serve": serve_launches[k["name"]],
                     "train_step": train_launches[k["name"]],
                     "train_adapt": adapt_launches[k["name"]],
                     "feature_step": full["feature_adapt"][3][k["name"]],
                     "source_only_step": full["source_only"][3][k["name"]],
                     **{p: v[k["name"]] for p, v in driver_launches.items()}}
            k["launches"] = sum(paths.values())
            # the paths that launched it (the others: 0)
            k["launches_by_path"] = {p: v for p, v in paths.items() if v}
        dw_entry["per_shape"]["train_step"] = dw_train.pop("per_shape")
        dw_entry["slower_than_library"]["train_step"] = dw_train.pop(
            "slower_than_library")
        dw_entry["by_path"] = {
            "serve": {key: dw_entry[key] for key in
                      ("ms", "plain_ms", "bound_ms", "library_ms")},
            "train_step": dw_train,
            "serve_xception": xdw_totals["serve"],
            "train_step_xception": xdw_totals["train_step"]}
        dk_entry["by_path"] = {"train_step_xception": xdw_totals["dk"]}
        for entry, key, path in ((dw_entry, "serve", "serve_xception"),
                                 (dw_entry, "train_step",
                                  "train_step_xception"),
                                 (dk_entry, "dk", "train_step_xception")):
            entry["per_shape"][path] = xdw_rows[key]
            entry["slower_than_library"][path] = slower(xdw_rows[key])
    except (Failed, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(carry["dir"], ignore_errors=True)
    log("[9 summary] " + "; ".join(
        f"{k}: " + ", ".join(f"{n} {v:.3f}" for n, v in d.items()
                             if v is not None)
        if isinstance(d, dict) else f"{k}: {d:.3f}"
        for k, d in backbones.items()) + f" ({smi})")
    log(f"[done] ms/image exact {ms['exact']:.3f}, decoder-int8 "
        f"{ms['decoder_int8']:.3f} (bf16, rgb8 {FULL_HW[1]}x{FULL_HW[0]} "
        f"batch {BATCH}); train step {step_ms:.3f} ms ({TRAIN_HW[1]}x"
        f"{TRAIN_HW[0]} batch {BATCH} bf16); feature step "
        f"{full['feature_adapt'][0]:.3f} ms, source-only step "
        f"{full['source_only'][0]:.3f} ms ({SOURCE_HW[1]}x{SOURCE_HW[0]} "
        f"batch {SOURCE_BATCH}); data parallel, {DIST_WORLD} ranks on one "
        f"card (gloo): {dist_summary['dist_ms_per_step']:.3f} ms/step; "
        f"split_concat serving exact "
        f"{split_summary['serve_split_exact_ms']:.3f} ms/image; output "
        f"step with bf16 logits {split_summary['step_bf16_logits_ms']:.3f} "
        f"ms against {split_summary['step_f32_logits_ms']:.3f} with f32; "
        f"output step --remat {arms['remat_step_ms']:.3f} ms, "
        f"{arms['remat_step_peak_gib']:.2f} GiB, against "
        f"{arms['default_step_ms']:.3f} ms, "
        f"{arms['default_step_peak_gib']:.2f} GiB; --spatial-shard "
        f"{SPATIAL} over {SPATIAL} gloo ranks on one card: "
        f"{spatial['spatial_ms_per_step']:.3f} ms/step at the train cell, "
        f"peak {spatial['spatial_peak_gib']:.3f} GiB a rank against "
        f"{spatial['one_peak_gib']:.3f} one process at {FULL_HW[1]}x"
        f"{FULL_HW[0]} batch {SPATIAL_PEAK_BATCH}; ranks 0-1 of "
        f"{IDLE_WORLD} (one idle): {idle['idle_ms_per_step']:.3f} ms/step; "
        f"a 2048x1024 JPEG decoded in {rest['jpeg_decode_ms']:.3f} ms, "
        f"cli.infer over .jpg frames exact "
        f"{rest['infer_jpeg_exact_ms_per_image']:.3f} and decoder-int8 "
        f"{rest['infer_jpeg_int8_ms_per_image']:.3f} ms/image, "
        f"on {smi}; {time.perf_counter() - t_start:.1f} s after imports")
    print(json.dumps({"kernels": significant(kernels)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
