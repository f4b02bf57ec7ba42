"""Smoke run of the PyTorch port (``vrdone_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --only kernels  # the build and the kernel checks
                                          # of 1, 2, 7 and 8 (with their
                                          # bf16 ones); no ``ok`` line
    python3 chip_smoke.py --only detector_train    # phase 14 alone
    python3 chip_smoke.py --only detector_methods  # phase 15 alone
    python3 chip_smoke.py --only retinanet_heads   # phase 16 alone
    python3 chip_smoke.py --only sequence_parallel # phase 17 alone

Builds the hand-written CUDA kernels from ``vrdone_tpu_torch/csrc`` (nvcc,
one process per source, all started together, into
``build/vrdone_tpu_torch``), then:

  1. holds each forward kernel against its plain PyTorch version at the
     shapes of the VidVRD eval forward, and times both and the one-call
     library equivalent (``F.scaled_dot_product_attention``), the band
     kernel (K1) alone at each eval shape (T = 96, 48, 24, 12) beside its
     bound, the full-attention kernel (K7) also at the largest eval bucket
     (768) and at VidOR's S/O cross-attention (B=8, H=8, T=512, d=64),
     each timed alone; then the bf16 instances of K1 and K7 against their
     bf16 plain versions (``BF16_KERNEL_TOL``) at the shapes of the bf16
     forward at VidVRD B=128 T=96 and VidOR B=16 T=512 (K7 also at the
     eval runner's 384 and 768 buckets), each timed alone beside SDPA in
     bf16 and its bound at the dense bf16 rate (K7 bf16, the tensor-core
     kernel, with its instance's registers and spills where this run built
     it); and K1 and K7 at VrdONE-X's eval shapes (``configs/vidor_x.yaml``
     at B=16: K1 B*H=16*8, d=64, w=4, T=512, 256, 128, 64; K7 512x512 at
     d=64 and the predictor's 10 queries at d=32 against 10 and 64 keys),
     each against its plain version and timed alone beside SDPA and its
     bound;
  2. holds the band attention's lse and its dQ and dK/dV backward kernels
     against autograd of the plain version at the train step's shapes
     (B*H = 24*4, d = 128, w = 3), with a nonzero upstream gradient on
     invalid query rows, times K1 with its lse alone and the dQ (K2) and
     dK/dV (K3) kernels alone at each train shape (T = 96, 48, 24, 12)
     beside plain autograd, SDPA's backward and their bounds, with the
     instance the C side picked; then the bf16 instances of K2 and K3
     (the tensor-core kernel ``band_backward_mma_kernel``) against
     ``band_backward_plain`` on the same bf16 streams
     (``BF16_KERNEL_TOL``) and K1 bf16's lse at the same shapes, at the
     96-pair step's T=96 and at the bf16 rel-PE train step's local S/O
     mutual layers (B*H=48*8, T=512, d=64, w=4), each timed alone beside
     its fp32 instance, the plain version, SDPA's bf16 backward and the
     bound at the dense bf16 rate, with both instances' registers and
     spills where this run built them; then K7 with its lse and the full
     attention's backward, K8 (dQ) and K9 (dK, dV) in
     ``csrc/masked_attention_bwd.cu`` (bf16 on the tensor cores:
     ``masked_attention_bwd_mma_kernel``), in fp32 and bf16 at every full
     attention's shape of phase 18's step (``FLASH_SHAPES``: B*H=48*8,
     512x512 at d=64; 9x9 and 9x64 at d=32) against ``full_attention_plain``,
     ``full_attention_lse_plain`` and ``full_attention_backward_plain``,
     each timed alone beside the plain version, SDPA (its backward for K8
     and K9) and the bound;
  3. runs the full-width VidVRD ``MaskVRD`` eval forward
     (``configs/vidvrd.yaml``, random seeded weights) on the card against
     the same weights on the CPU, counts the kernel launches of one forward
     at B=128 and times it;
  4. drives ``InferenceRunner`` + ``decode_video`` over synthetic videos
     whose pairs fall into the 96, 192, 384 and 768 frame buckets;
  5. runs three full-width VidVRD train steps at 8 pairs on the card and
     on the CPU from the same weights, batch and drop-path draws (losses,
     matches, parameters and EMA compared), counts the launches of one step
     at 24 pairs; then in bf16 (``compute_dtype: bfloat16``) three steps at
     8 pairs on the card against the port's bf16 CPU steps (losses within
     ``BF16_LOSS_TOL``, matchings equal or near-ties within
     ``MATCH_TIE_TOL``), the launches of one bf16 step at 24 pairs (K1, K2
     and K3 bf16, 7 each; K1 14 under remat; the profiles show no FMA band
     kernel on bf16 streams), one fp32 remat step under
     each policy against the plain step (losses within ``LOSS_TOL``, drop
     path on), and fp32 and bf16 steps at 24 and 96 pairs timed in turns
     and profiled;
  6. runs ``train_torch.py --compute_dtype bfloat16`` with ``use_rel_pe``
     and ``use_local`` for one epoch on a tiny synthetic corpus on the card
     (``train_torch.py`` -> ``eval_torch.py`` in fp32 on the card runs in
     12's chain, and under ``torchrun`` in 13);
  7. holds MEGA's position-bias kernel (K6) and the ``bias_factors``
     kernel (the torch ``pe_setup``'s port) against their plain versions
     at a frame's three local-stage shapes and times each alone beside its
     wrapper, its plain version and its bound; holds the fused
     set-attention kernel (K5) against its plain version at the detector's
     shapes and times it alone at each of a frame's five shapes beside its
     wrapper, SDPA and its bound, and K5's bf16 instance (the tensor-core
     kernel, its rows, groups a block, bucket and splits printed) against
     its bf16 plain version (``BF16_KERNEL_TOL``) at the five shapes with
     and without the bias, each timed alone beside the fp32 instance, SDPA
     in bf16 and its bound (right after 2, with every other kernel check);
     runs ``detect_video`` at full width (R-101-C4, 608x1088, 300 key / 75
     reference proposals, window 25, global 10, 16 frames, random seeded
     weights) through the fused attention, again through the
     position-bias kernel and in bf16 (``compute_dtype="bfloat16"``: K5's
     bf16 instance only, and no FMA kernel in its profile), with the
     launches of each (one ``bias_factors``
     before each biased K5 or K6 call), each route's phase times (fp32 and
     bf16 in turns) and its stream phase's kernels a frame; checks a small
     detector on the card against the CPU, stage by stage and whole, and
     in bf16 against the port's bf16 CPU run stage by stage
     (``BF16_DETECT_MAX``, ``BF16_DETECT_MEAN``) (``detect_torch.py`` on
     the card, bf16 by default, runs in 12's chain and in 14);
  8. holds the band kernel with the relative-position bias (K4) against
     its plain version at the streamed stem's and branches' shapes,
     ``BandAttentionPE``'s gradients against plain autograd, K4's bf16
     instance against its bf16 plain version (``BF16_KERNEL_TOL``, a bf16
     table) at VidOR local width's shapes (B*H=16*8, d=64, window 9,
     T=512, 256, 128, 64) and the stream's, at a T off the row tile and
     an even window, and with a zero table against K1 bf16 bit for bit,
     each path shape timed alone beside K4 fp32, the bf16 plain version,
     SDPA in bf16 with the band and bias mask and the bound, and the band
     (K1) and full-attention (K7) kernels against theirs at the shapes the
     stream gives them and times each kernel alone, K4 and K1 beside SDPA
     and their bounds (these checks too right after 2), then streams
     a synthetic SO-pair sequence of 6,000 positions through
     ``StreamingRunner`` at VidOR local-attention width
     (``configs/vidor_local.yaml`` with ``use_rel_pe``, random seeded
     weights), counts its launches, holds the first chunk group against the
     CPU and times it;
  9. (run right after 4) bf16 serving at VidVRD B=128 T=96, VidOR B=16
     T=512, VidOR local-attention width with ``use_rel_pe`` B=16 T=512 and
     VrdONE-X B=16 T=512 (``configs/vidvrd.yaml``, ``configs/vidor.yaml``,
     ``configs/vidor_local.yaml``, ``configs/vidor_x.yaml``, random seeded
     weights): the ``cast_floating`` copy of each fp32 model, its bf16
     forward held against the port's bf16 CPU run (B=8, B=2, B=2, B=2)
     within
     ``BF16_MODEL_TOL`` with the gap to the fp32 forward printed, the
     launches of one bf16 eval step (the forward and bench.py's decode-side
     softmax, top-k and mask sigmoid: only bf16 instances of K1, K4 and K7,
     in the counts the config gives, K4 bf16 7 with ``use_rel_pe``, and no
     dense band form), and the pairs a second of fp32 and bf16 eval steps,
     timed in turns and profiled (the bf16 step's profile shows K7's
     tensor-core kernel, never its fp32 FMA kernel);
 10. (run right after 5) bf16 training with ``use_rel_pe`` at VidOR
     local-attention width: three steps at 2 pairs on the card against
     the port's bf16 CPU steps (``BF16_LOSS_TOL``, ``MATCH_TIE_TOL``, every
     ``rel_pe`` moved), the launches of one step at 48 pairs (K4 bf16 7,
     14 under remat, its backward the dense form 7 times; K1, K2 and K3
     bf16 8 each, K1 16 under remat; K2/K3 at the shape phase 2 times)
     and bf16 steps at 48 pairs timed and profiled;
 11. (run right after 10) VrdONE-X, the CLIP-fused backbone, at full width
     (``configs/vidor_x.yaml``, 3,093 packed channels, random seeded
     weights): the fp32 forward against the CPU at B=2, the launches of
     one fp32 eval step at B=16 (K1 fp32 7 and K7 fp32 16, nothing else,
     no dense band or full-attention form; phase 9 holds its bf16 forward
     and times both dtypes' steps in turns), the reference checkpoint
     converter on the card (the model's parameters in the torch
     reference's layout, saved as a ``.pth``, through
     ``convert_reference_checkpoint_torch.py`` and ``eval_torch.py``'s
     loader into a fresh model whose forward is the first's bit for bit),
     and fp32 train steps at 4 pairs against the CPU (losses within
     ``LOSS_TOL``), the launches of a step at the config's 20 pairs (K1
     with lse, K2, K3 7 each, full attention dense) and its time and
     profile.
 12. (run right after 7) ``detect_video_tta`` at full width (MEGA's
     defaults, 8 frames of 608x1088, ``scales=(0.75,)`` with flips: four
     views) in fp32 and bf16: its K5 (K5 bf16) and ``bias_factors``
     launches equal to the sum of the four views' single ``detect_video``
     launches, every merged box on the canvas, both dtypes timed in turns;
     the small detector's TTA on the card against the CPU on the frames
     where no view's proposals flipped (``DETECT_TOL``); then raw frames to
     triplets with the port alone on a synthetic VidVRD-layout corpus (two
     train videos and one test video of 40 frames of 576x1024, a drifting
     still image each): ``extract_gt_features_torch.py`` (its R-101
     defaults), ``train_torch.py`` for one epoch of ``configs/vidvrd.yaml``,
     ``detect_torch.py``, ``extract_proposal_features_torch.py`` and
     ``eval_torch.py`` (six finite metrics), each a subprocess on the card;
     the extraction's frames a second at full width in fp32 and bf16, and
     ``extract_gt_features_torch.py`` on the card against the CPU at a
     small configuration (``DETECT_TOL``).

 13. (run right after 6) data parallelism on the card: two ranks sharing it
     over a gloo group on CUDA tensors (NCCL refuses two ranks on one
     card), each three full-width ``configs/vidvrd.yaml`` train steps on its
     12 of the global batch's 24 pairs (TF32 off, drop path as configured),
     against one process's three steps on the whole batches: losses within
     ``LOSS_TOL``, the ranks' parameters equal bit for bit, the largest
     parameter gap to one process and both step times printed, a rank's
     launches (K1 with lse, K2, K3 once a band layer: one process's step at
     half the batch); then ``train_torch.py`` under ``torchrun --standalone
     --nproc_per_node 1`` (NCCL at world size 1, its all-reduces included)
     for one epoch of phase 6's corpus, and ``eval_torch.py --multihost`` on
     its checkpoint with two ranks sharing the card beside one process's
     ``eval_torch.py``: the merged predictions and metrics equal.
 14. (run right after 13) MEGA detector training: three steps of
     ``configs/detector/mega_vidvrd.yaml`` at full width (R-101-C4,
     608x1088, 2 local, 3 memory and 2 global frames, 128 key and 75
     reference proposals, 16 GT slots; random seeded weights with the
     frozen norms' statistics calibrated on a frame) at a batch of 1:
     finite losses, every parameter group moved, the step time, peak
     memory, busy share and launches (no K5, K6 or ``bias_factors``: the
     dense route); the small detector's losses and gradients on the card
     against the CPU (``LOSS_TOL``, ``DET_GRAD_TOL``); two ranks sharing
     the card over gloo, a sample each, against one process's step; then
     ``train_detector_torch.py`` for 4 iterations on phase 12's corpus and
     ``detect_torch.py --ckpt_path`` on the ``.npz`` it wrote.
 15. (run right after 14) the base, RDN, FGFA and DFF detectors
     (``configs/detector/{base,rdn,fgfa,dff}_vidvrd.yaml``) at full width:
     two train steps each (finite losses, every parameter group moved,
     times, peak memory, busy share, launches: all 0), bf16 held block by
     block, each method's detection over 8 frames in fp32 and bf16; the
     small detectors on the card against the CPU (losses, gradients with
     the CPU's branches replayed where rounding flips one, detection, bf16
     maps); ``train_detector_torch.py --cfg rdn/fgfa_vidvrd.yaml`` with
     ``--resume``.
 16. (run right after 15) RetinaNet and the mask / keypoint RoI heads, no
     kernel built for them: RetinaNet at full width (R-101, FPN at 256
     channels, 4 convs a tower, 9 anchors, VidVRD's 35 classes, 608x1088,
     random seeded weights; the body's frozen norms calibrated on the
     batch, and the class logits' kernel scaled by 100 and their bias
     raised until 1% of the anchor-class logits pass ``score_thresh``, as
     at the prior bias every logit lies under it and the NMS would see
     nothing): bf16 held piece by piece (stem, each block, FPN, head, each
     fed the bf16 run's own input; ``BF16_DETECT_MAX`` / ``_MEAN``), one
     forward and backward of ``retinanet_losses`` at a batch of 2 (finite
     losses, a nonzero gradient in every parameter group, times, peak
     memory, busy share), ``detect_image`` in fp32, in bf16 on the fp32
     parameters and on a ``cast_floating`` copy, timed in turns (every box
     on the canvas, fp32 outputs); ``MaskHead(num_classes=36)`` and
     ``KeypointHead(17)`` over 512 RoIs of (14, 14, 256), each loss on its
     targets forward and backward (finite, every kernel moved, times), and
     inference at 100 RoIs through ``select_mask_probs`` ->
     ``paste_masks_in_image`` and ``heatmaps_to_keypoints``; a small
     RetinaNet and small heads on the card against the CPU (forward
     ``DETECT_TOL``, losses ``LOSS_TOL``, gradients ``DET_GRAD_TOL`` with
     phase 15's flip rule, ``detect_image``'s keep, valid and labels equal,
     the bf16 copy ``BF16_DETECT_MAX`` / ``_MEAN``). Every path launches
     none of K1-K7 and no ``bias_factors``.
 17. (run right after 13) sequence and tensor parallelism: two ranks
     sharing the card over gloo (``par_rank_main``), each taking three
     fp32 steps (TF32 off, drop path as configured) against one process's
     three steps on the whole batches: 17a dp 1 x sp 2 on
     ``configs/vidor_local.yaml`` (T = 512, window 9, ``use_local``: the
     S/O mutual layers are band layers too), 256 columns a rank of the
     config's global batch of 48 pairs; 17b dp 1 x tp 2 on
     ``configs/vidvrd.yaml`` at width 512 (``tp_min_size`` at its default)
     at 24 pairs. Losses within ``LOSS_TOL``, the ranks' parameters equal
     bit for bit, the largest parameter gap to one process within the most
     three Adam steps move a leaf; step times, peak memory, parameter and
     optimizer memory of each rank against one process's; under sp each
     rank's launches (K1 with its lse, K2 and K3 once a band layer at
     T_local + 2w, no dense band form), under tp the sharded leaves and
     elements.
 18. (run right after 17) flash training (``VRDONE_FLASH_TRAIN=1``) at
     ``configs/vidor.yaml``'s full width (T=512, 8 heads, ``use_local``
     off, random seeded weights): three fp32 steps at 4 pairs on the card
     and the CPU (losses, step-0 gradients, drift) and the launches of a
     step at the config's 48 pairs (K7 with its lse, K8 and K9 once each of
     the 16 full attentions, no dense form), the kernels held on that
     step's own inputs; three bf16 steps under remat at 4 pairs against the
     port's bf16 CPU steps (``BF16_LOSS_TOL``, step-0 gradients within
     ``BF16_STEP_GRAD_TOL``) and the kernels on a 48-pair step's inputs;
     the card's flash step against its dense step at 48 pairs in fp32 and
     in bf16 under remat (losses, step-0 gradients, launches), both timed
     in turns with their peak memory.

Any failed check raises. The second-to-last line of output is a JSON object
of per-kernel results; the last is ``{"ok": true, "device": {...}}``. With
``--only kernels`` the last line is the per-kernel JSON object, without
launch counts.
Without a CUDA device it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vrdone_tpu_torch.data.batching import packed_channels

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-5   # kernel vs plain, fp32, TF32 off: summation order only
GRAD_TOL = 1e-5     # backward kernels vs plain autograd, times max |grad|
LSE_TOL = 1e-5      # forward lse vs plain logsumexp, times 1 + |lse|
MODEL_TOL = 5e-4    # CUDA vs CPU forward through some forty chained layers
LOSS_TOL = 1e-4     # CUDA vs CPU train-step losses, times 1 + |loss|
STEP_GRAD_TOL = 1e-4  # CUDA vs CPU step-0 gradients, |dg| / |g| over all
DRIFT_TOL = 5e-2    # CUDA vs CPU params after 3 steps / (leaf max + sum lr)
MEGA_TOL = 1e-4     # fused set-attention vs plain, times 1 + max |out|
# bf16 kernel vs its bf16 plain version, times 1 + max |plain|: both round
# P and the output to bf16 (K7's P unnormalised, the plain version's
# normalised), so one bf16 step of the largest value is the expected gap;
# on an H100 the largest seen at the serving shapes was 5.1e-3 (K7 at
# 512x512, an error of one step, 2^-6, at values near 2), half the limit
BF16_KERNEL_TOL = 1e-2
# bf16 forward, card vs the port's CPU run, times max |ref|: the limit the
# CPU parity test holds the port's bf16 forward to against JAX's
# (tests/test_torch_bf16.py::MODEL_TOL); both sides round to bf16 in their
# own places
BF16_MODEL_TOL = 5e-2
# bf16 train step, card vs the port's CPU run, each loss term times
# 1 + |loss|: the limit JAX's own test holds its bf16 step to against fp32
# (tests/test_train_step.py::test_bf16_train_step; the CPU parity test,
# tests/test_torch_bf16_train.py, holds the port to JAX's at it); both
# sides round to bf16 in their own places, and the card's backward keeps
# P in fp32 where autograd of the plain version reads the rounded one
BF16_LOSS_TOL = 5e-2
# a matching that bf16 flips on a near-tie: its cost under the CPU's cost
# matrix within this share of the CPU's optimum
# (tests/test_torch_bf16_train.py::MATCH_TIE_TOL)
MATCH_TIE_TOL = 1e-2
BIAS_RTOL, BIAS_ATOL = 2e-5, 1e-5   # position bias vs plain, gate space
DETECT_TOL = 1e-3   # small detector, CUDA vs CPU, times max |x|
# small bf16 detector, card vs the port's bf16 CPU run, times max |ref|: the
# largest and the mean gap JAX's own tests allow its bf16 precompute and
# stream against fp32 (tests/test_detector.py::test_bf16_precompute_parity,
# test_bf16_stream_parity); both sides round to bf16 in their own places
BF16_DETECT_MAX, BF16_DETECT_MEAN = 5e-2, 5e-3
DETECT_FRAMES, CANVAS = 16, (608, 1088)
B_CHECK, B_RATE, T = 8, 128, 96
TRAIN_PAIRS = (8, 24, 96)   # checked on both devices; timed; timed
STREAM_T = 6000             # feature positions of the streamed sequence
PEAK_FLOPS = 67e12          # H100 SXM fp32 without tensor cores
PEAK_FP16_MMA = 989e12      # H100 SXM dense fp16 on the tensor cores
PEAK_BF16_MMA = 989e12      # H100 SXM dense bf16 on the tensor cores
# bf16 serving at the two widths the JAX bench serves (bench.py:127-129,
# 244-265), and at VidOR local-attention width with use_rel_pe (the bf16
# path K4's bf16 instance opens): config, pairs held against the CPU, pairs
# timed, top-k, use_rel_pe
BF16_SERVING = (("vidvrd.yaml", 8, 128, 8, False),
                ("vidor.yaml", 2, 16, 6, False),
                ("vidor_local.yaml", 2, 16, 6, True),
                ("vidor_x.yaml", 2, 16, 4, False))
# VrdONE-X (configs/vidor_x.yaml, the CLIP-fused backbone): pairs held
# against the CPU, pairs served (VidOR's eval width, bench.py:239-265)
VRDONE_X_CHECK, VRDONE_X_RATE = 2, 16
VRDONE_X_TRAIN_CHECK = 4   # pairs of its train steps held against the CPU
RELPE_TRAIN_PAIRS = (2, 48)  # bf16 rel-PE steps: on both devices; timed
# K2/K3 bf16 held and timed alone, (B, H, d, w, T): the bf16 train step's
# band shapes (24 pairs, T = 96, 48, 24, 12) and its 96-pair T = 96, and
# the bf16 rel-PE train step's local S/O mutual layers at VidOR local width
# (48 pairs at max_seq_len 512, 8 heads of 64, window 9)
BWD_BF16_SHAPES = tuple((TRAIN_PAIRS[1], 4, 128, 3, t) for t in (96, 48, 24,
                                                                 12)) + (
    (TRAIN_PAIRS[2], 4, 128, 3, 96), (RELPE_TRAIN_PAIRS[1], 8, 64, 4, 512))
# phase 18, flash training (VRDONE_FLASH_TRAIN=1) at configs/vidor.yaml's
# width: pairs held against the CPU, and the config's global batch (3 items
# of 16 pairs), at which the card's steps are counted, held dense against
# flash and timed
FLASH_PAIRS = (4, 48)
# (B, H, d, Tq, Tk) of the full attentions of that step: the 8 S/O
# cross-attentions, and the predictor's self-attention (9 queries) and
# cross-attention (9 queries over the coarsest level's 64 frames), 4 each
FLASH_SHAPES = ((FLASH_PAIRS[1], 8, 64, 512, 512),
                (FLASH_PAIRS[1], 8, 32, 9, 9), (FLASH_PAIRS[1], 8, 32, 9, 64))
# bf16 train step's first gradients, card vs the port's CPU run (or the
# card's dense step), |dg| / |g| over the model: the bound the CPU parity
# test holds the port's bf16 step to against JAX's
# (tests/test_torch_bf16_train.py::BF16_GRAD_NORM); both round to bf16 in
# their own places
BF16_STEP_GRAD_TOL = 0.15
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FLOPS
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of the type they run in
    (fp32 by default)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def ptxas_usage(log: str) -> list[str]:
    """Each kernel instance's registers and spills from nvcc's
    ``-Xptxas -v`` output, as "name<template arguments>: N registers, S/L
    bytes spilled" (stores/loads); nothing when the library was already
    built."""
    lines, entry, spill = [], None, ""
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            entry, spill = m[1], ""
            if k := re.search(r"([a-z_]+_kernel)"
                              r"(I(?:L\w\d+E|f|13__nv_bfloat16)+E)?", entry):
                args = re.findall(r"L(\w)(\d+)E|(f|13__nv_bfloat16)",
                                  k[2] or "")
                entry = k[1] + (("<" + ", ".join(
                    ("float" if e == "f" else "bf16") if e
                    else v if t != "b" else ("true" if v == "1" else "false")
                    for t, v, e in args) + ">") if args else "")
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            spill = f"{m[1]}/{m[2]} bytes spilled"
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            lines.append(f"{entry}: {m[1]} registers, {spill}")
            entry = None
    return lines


def band_pairs(mask: torch.Tensor, w: int) -> int:
    """(valid query, in-sequence band key) pairs of a (B, T) mask: the work
    the band attention's output needs."""
    t = mask.shape[1]
    i = torch.arange(t, device=mask.device)
    keys = (i + w).clamp(max=t - 1) - (i - w).clamp(min=0) + 1
    return int((mask * keys).sum())


def band_library_mask(mask: torch.Tensor, w: int) -> torch.Tensor:
    """The band attention's masking as one additive (B, 1, T, T) mask for
    ``F.scaled_dot_product_attention``."""
    t = mask.shape[1]
    i = torch.arange(t, device=mask.device)
    out = torch.where(mask, 0.0, -1e4)[:, None, None, :].expand(
        -1, 1, t, -1).clone()
    out[:, :, (i[None] - i[:, None]).abs() > w] = float("-inf")
    return out


def heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.view(b, t, h, c // h).transpose(1, 2)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(event) -> float:
    """A ``torch.profiler`` event's own device time in microseconds (the
    attribute's name differs between torch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_events(prof) -> list:
    """The kernels of a ``torch.profiler`` run, averaged by name."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]


def queued_device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``, whose work on the card is one
    kernel, with the host's part kept out and no profiler: the card first
    spins for some 25 ms, so that all ``iters`` calls are queued before the
    first runs, and the two events around them then time the kernels back
    to back. Raises if the card woke before the last call was queued."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the card ran out of queued work: the times "
                             "would hold the host's")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(kernel, plain) -> tuple[float, float, float]:
    """(max abs error, kernel ms, plain ms), timed plain, kernel, kernel,
    plain so that drift over the run falls on both."""
    err = (kernel() - plain()).abs().max().item()
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    return err, (k1 + k2) / 2, (p1 + p2) / 2


def band_row(ba, label, kernel, plain_ms, library, q, mask, h, w, *,
             pe: torch.Tensor | None = None, with_lse: bool = False) -> dict:
    """One shape of K1 (K4 with ``pe``): the kernel alone (queued behind a
    device sleep) beside ``plain_ms``, the library call and the bound, with
    the instance the C side picked. Returns the row for the JSON line."""
    b, t, c = q.shape
    dev_ms = queued_device_ms(kernel)
    lib_ms = time_ms(library)
    n_bytes = (4 * (4 * q.numel() + (0 if pe is None else pe.numel())
                    + (b * h * t if with_lse else 0)) + mask.numel())
    bms, by = bound_ms(n_bytes, 4 * (c // h) * h * band_pairs(mask, w))
    i = ba.forward_instance(q.device.index or 0, b, t, h, c // h, 2 * w + 1,
                            pe is not None)
    inst = (f" (instance {i['rows']} rows a tile, {i['per_block']} of "
            f"{i['tiles']} tiles a block, d bucket {i['bucket']}"
            f"{'' if i['vec'] else ', scalar'})")
    name = "band_attention" if pe is None else "band_attention_pe"
    print(f"{name} {label}{inst}: the kernel alone {dev_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library (SDPA) {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    return dict(shape=label, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by)


def instance_usage(lib: str) -> dict:
    """Registers and spills of each kernel instance of ``csrc/<lib>.cu``,
    by name, where this run built it."""
    from vrdone_tpu_torch.ops import _build
    return dict(ln.split(": ", 1) for ln in ptxas_usage(
        _build.BUILD_LOG.get(lib, (0.0, ""))[1]))


def mma_band_instance(ba, usage, device, b, t, h, d, ws, pe) -> str:
    """The bf16 band forward's instance for a shape, as text: the
    tensor-core kernel's name and template arguments (bucket, vector
    copies, bias, n8 key tiles a warp), rows a tile (a tile a block), the
    block's warps and those that own 16 rows, and ptxas' registers and
    spills."""
    i = ba.forward_instance(device.index or 0, b, t, h, d, ws, pe=pe,
                            dtype=torch.bfloat16)
    name = (f"band_forward_mma_kernel<{i['bucket']}, "
            f"{str(i['vec']).lower()}, {str(pe).lower()}, "
            f"{i['key_tiles']}>")
    return (f"instance {name}: {i['rows']} rows a tile, {i['tiles']} "
            f"tiles a sequence, a tile a block of {i['warps']} warps, "
            f"{i['rows'] // 16} of them 16 rows each, d bucket "
            f"{i['bucket']}, {'vector' if i['vec'] else 'scalar'} copies; "
            f"{usage.get(name, 'registers not reported, already built')}")


def refuse_fma_band(events, label: str) -> None:
    """Fail if a profile's kernels hold an FMA band kernel on bf16 streams
    (``band_forward_kernel<..., __nv_bfloat16>`` or
    ``band_backward_kernel<..., __nv_bfloat16>``): bf16 runs the
    tensor-core kernels alone. Prints how often the profiler saw those
    (it misses some ctypes launches)."""
    fma = [e.key for e in events
           if re.search(r"band_(forward|backward)_kernel<", e.key)
           and "__nv_bfloat16" in e.key]
    seen = {k: sum(e.count for e in events if f"band_{k}_mma_kernel" in e.key)
            for k in ("forward", "backward")}
    print(f"  the profiler saw band_forward_mma_kernel {seen['forward']} and "
          f"band_backward_mma_kernel {seen['backward']} times in the "
          f"{label}, an FMA band kernel on bf16 streams {len(fma)} times")
    if fma:
        raise AssertionError(f"{label} ran {fma}")


def attention_inputs(rng, b, tq, tk, c, device):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, c))
                                .astype(np.float32)).to(device)
               for t in (tq, tk, tk))
    lens = rng.integers(1, tk + 1, size=b)
    lens[0] = tk
    mask = torch.from_numpy(np.arange(tk)[None] < lens[:, None]).to(device)
    return q, k, v, mask


def check_kernels(cuda, ba, fa) -> dict:
    """The forward kernels at the eval forward's shapes, VidVRD's and
    VrdONE-X's (``configs/vidor_x.yaml`` at B=16). Returns, per kernel, its
    entry of the JSON line (all but ``launches``), with the times at B=128,
    T=96, d=128; each ``by_shape`` holds the kernel's time alone at each
    timed shape (K1's train and stream shapes are added by
    ``check_band_backward`` and ``check_stream_kernels``)."""
    rng = np.random.default_rng(0)
    h, w, d = 4, 3, 128
    x_band, x_full = bf16_shapes(vrdone_x_config()[0], VRDONE_X_RATE)
    worst = {"band_attention": 0.0, "masked_attention": 0.0}
    entries, band_rows, full_rows = {}, [], []
    for b, hh, dd, ww, t in [(128, h, d, w, t) for t in (96, 48, 24, 12,
                                                         768)] + x_band:
        q, k, v, mask = attention_inputs(rng, b, t, t, hh * dd, cuda)
        kw = dict(n_head=hh, window_size=2 * ww + 1)
        shape = f"B*H={b}*{hh} T={t} d={dd} w={ww}"
        err, ms, plain_ms = compare(
            lambda: ba.band_attention_cuda(q, k, v, mask, **kw),
            lambda: ba.band_attention_plain(q, k, v, mask, **kw))
        print(f"band_attention {shape}: max_abs_err {err:.3e}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"band kernel off by {err} at {shape}")
        worst["band_attention"] = max(worst["band_attention"], err)
        if t == 768:   # a check only: the timed forward is at T=96
            continue
        lib_mask = band_library_mask(mask, ww)
        row = band_row(
            ba, shape, lambda: ba.band_attention_cuda(q, k, v, mask, **kw),
            plain_ms, lambda: F.scaled_dot_product_attention(
                heads(q, hh), heads(k, hh), heads(v, hh),
                attn_mask=lib_mask),
            q, mask, hh, ww)
        band_rows.append(row)
        if (b, t) == (128, T):
            entries["band_attention"] = {**row, "ms": ms,
                                         "by_shape": band_rows}
    # K7 at the eval forward's shapes (the cross-attention at 96 up to the
    # largest bucket, 768; the predictor's 9 queries), at VidOR's S/O
    # cross-attention (B=8, H=8, T=512, d=64) and at VrdONE-X's (its S/O
    # cross-attention at B=16 and the predictor's 10 queries); the ones
    # marked are also timed alone and against the library
    for b, hh, dd, tq, tk, alone in (
            (128, h, 128, 96, 96, True), (128, h, 128, 9, 9, False),
            (128, h, 128, 9, 12, False), (128, h, 128, 384, 384, True),
            (128, h, 128, 768, 768, True), (128, h, 64, 96, 96, False),
            (128, h, 64, 9, 9, False), (128, h, 64, 9, 12, False),
            (128, h, 64, 384, 384, False), (8, 8, 64, 512, 512, True),
            *(x + (True,) for x in x_full)):
        q, k, v, mask = attention_inputs(rng, b, tq, tk, hh * dd, cuda)
        err, ms, plain_ms = compare(
            lambda: fa.full_attention_cuda(q, k, v, mask, n_head=hh),
            lambda: fa.full_attention_plain(q, k, v, mask, n_head=hh))
        shape = f"B*H={b}*{hh} Tq={tq} Tk={tk} d={dd}"
        rows, bucket = fa._variant(tq, dd)
        print(f"masked_attention {shape} (instance {rows} rows, d bucket "
              f"{bucket}): max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"full kernel off by {err} at {shape}")
        worst["masked_attention"] = max(worst["masked_attention"], err)
        if not alone:
            continue
        dev_ms = queued_device_ms(
            lambda: fa.full_attention_cuda(q, k, v, mask, n_head=hh))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            heads(q, hh), heads(k, hh), heads(v, hh),
            attn_mask=mask[:, None, None, :]))
        bms, by = bound_ms(4 * (2 * q.numel() + 2 * k.numel()) + mask.numel(),
                           4 * dd * hh * tq * int(mask.sum()))
        print(f"masked_attention {shape}: the kernel alone {dev_ms:.4f} ms "
              f"(queued behind a sleep), library (SDPA) {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
        full_rows.append(dict(shape=shape, max_abs_err=err, ms=ms,
                              device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=bms, bound_by=by))
        if (b, tq, dd) == (128, T, 128):
            entries["masked_attention"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, device_ms=dev_ms,
                shape="B*H=128*4 Tq=Tk=96 d=128", by_shape=full_rows)
        del q, k, v, mask
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
        print(f"{name} at {e['shape']}: the kernel alone "
              f"{e['device_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}), library {e['library_ms']:.4f} ms")
    return entries


def bf16_shapes(cfg, b: int) -> tuple[list, list]:
    """The shapes the forward of ``cfg`` at ``b`` pairs gives its band (K1)
    and full-attention (K7) kernels, in either dtype, read from the config
    as the forward derives them: K1 (b, h, d, w, T) at each stem and
    branch level, K7 (b, h, d, Tq, Tk) for the S/O cross-attention at T
    and the predictor's queries against themselves and the coarsest
    level."""
    t, arch, sf = cfg.max_seq_len, cfg.backbone_arch, cfg.scale_factor
    w = cfg.mha_win_size[0] // 2
    band = [(b, cfg.n_head, cfg.embd_dim // cfg.n_head, w, t // sf ** i)
            for i in range(arch[2] + 1)]
    p = cfg.predictor
    dp, q = p.n_embd // p.n_head, p.num_queries
    full = [(b, cfg.fuse_head, cfg.embd_dim // cfg.fuse_head, t, t),
            (b, p.n_head, dp, q, q), (b, p.n_head, dp, q, t // sf ** arch[2])]
    return band, full


def bf16_case(name, label, kernel, plain, library, n_bytes, flops) -> dict:
    """One shape of a bf16 kernel: its error against the bf16 plain version
    (held to BF16_KERNEL_TOL), its wrapper and alone times, the plain
    version's, SDPA's in bf16 and the bound at the dense bf16 rate."""
    out, ref = kernel(), plain()
    if not out.dtype == ref.dtype == torch.bfloat16:
        raise AssertionError(f"{name} {label}: {out.dtype} output, plain "
                             f"{ref.dtype}")
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    limit = BF16_KERNEL_TOL * (1 + ref.abs().max().item())
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    dev_ms, lib_ms = queued_device_ms(kernel), time_ms(library)
    bms, by = bound_ms(n_bytes, flops, PEAK_BF16_MMA)
    print(f"{name} {label}: max_abs_err {err:.3e} (limit {limit:.3e}), "
          f"kernel {(k1 + k2) / 2:.4f} ms, alone {dev_ms:.4f} ms, plain "
          f"{(p1 + p2) / 2:.4f} ms, library (SDPA, bf16) {lib_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    if not err <= limit:
        raise AssertionError(f"{name} off by {err} at {label}")
    return dict(shape=label, max_abs_err=err, ms=(k1 + k2) / 2,
                device_ms=dev_ms, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                bound_ms=bms, bound_by=by)


def check_bf16_kernels(cuda, ba, fa) -> dict:
    """The bf16 instances of K1 and K7 against their bf16 plain versions at
    the shapes of the bf16 forward at VidVRD B=128 T=96 and VidOR B=16
    T=512 (K7 also at the eval runner's 384 and 768 buckets), each timed
    alone beside SDPA in bf16 and the bound. Returns the JSON entries
    ``band_attention_bf16`` and ``masked_attention_bf16`` (all but
    ``launches``) at VidVRD's T=96, each with ``by_shape``."""
    from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    usage = instance_usage("masked_attention")
    band, full = [], []
    for yaml, _, b, _, rel_pe in BF16_SERVING:
        if rel_pe:   # K4 bf16's shapes: check_band_pe_bf16
            continue
        cfg = model_config_from_yaml(load_yaml_config(
            str(ROOT / "configs" / yaml)))
        k1, k7 = bf16_shapes(cfg, b)
        band += k1
        full += k7
        if yaml == "vidvrd.yaml":   # the eval runner's larger buckets
            b0, h0, d0 = k7[0][:3]
            full += [(b0, h0, d0, t, t) for t in (384, 768)]
    # VrdONE-X repeats VidOR's shapes but for its predictor's 10 queries
    band, full = list(dict.fromkeys(band)), list(dict.fromkeys(full))
    rows = {"band_attention_bf16": [], "masked_attention_bf16": []}
    band_regs = instance_usage("band_attention")
    for b, h, d, w, t in band:
        q, k, v, mask = (x.to(bf) if x.is_floating_point() else x
                         for x in attention_inputs(rng, b, t, t, h * d, cuda))
        kw = dict(n_head=h, window_size=2 * w + 1)
        inst = mma_band_instance(ba, band_regs, cuda, b, t, h, d, 2 * w + 1,
                                 False)
        lib_mask = band_library_mask(mask, w).to(bf)
        rows["band_attention_bf16"].append(bf16_case(
            "band_attention_bf16", f"B*H={b}*{h} T={t} d={d} w={w} ({inst})",
            lambda: ba.band_attention_cuda(q, k, v, mask, **kw),
            lambda: ba.band_attention_plain(q, k, v, mask, **kw),
            lambda: F.scaled_dot_product_attention(
                heads(q, h), heads(k, h), heads(v, h), attn_mask=lib_mask),
            2 * 4 * q.numel() + mask.numel(),
            4 * d * h * band_pairs(mask, w)))
    for b, h, d, tq, tk in full:
        q, k, v, mask = (x.to(bf) if x.is_floating_point() else x
                         for x in attention_inputs(rng, b, tq, tk, h * d,
                                                   cuda))
        r, bucket = fa._variant(tq, d, bf)
        tiles = 2 if r > 64 else 1   # 16-row tiles a warp
        inst = f"masked_attention_mma_kernel<{bucket}, {r // 16 // tiles}, " \
               f"{tiles}>"
        rows["masked_attention_bf16"].append(bf16_case(
            "masked_attention_bf16",
            f"B*H={b}*{h} Tq={tq} Tk={tk} d={d} (instance {inst}: "
            f"{usage.get(inst, 'registers not reported, already built')})",
            lambda: fa.full_attention_cuda(q, k, v, mask, n_head=h),
            lambda: fa.full_attention_plain(q, k, v, mask, n_head=h),
            lambda: F.scaled_dot_product_attention(
                heads(q, h), heads(k, h), heads(v, h),
                attn_mask=mask[:, None, None, :]),
            2 * (2 * q.numel() + 2 * k.numel()) + mask.numel(),
            4 * d * h * tq * int(mask.sum())))
    entries = {}
    for name, by_shape in rows.items():
        main = by_shape[0]   # VidVRD's first shape: T=96 (K1), 96x96 (K7)
        entries[name] = {**main, "max_abs_err": max(
            r["max_abs_err"] for r in by_shape), "by_shape": by_shape}
    return entries


def band_backward_instance(ba, q, h, w, dkv, dtype=torch.float32,
                           usage: dict | None = None) -> str:
    """The backward instance the C side picks for q's shape, as text: the
    kernel's name and template arguments (the tensor-core kernel
    ``band_backward_mma_kernel`` where a warp owns 16 rows, else the FMA
    body ``band_backward_kernel``), its tiling and, from ``usage``
    (``instance_usage``), ptxas' registers and spills."""
    b, t, c = q.shape
    i = ba.backward_instance(q.device.index or 0, b, t, h, c // h, 2 * w + 1,
                             dkv, dtype)
    vec, kv = str(i["vec"]).lower(), str(dkv).lower()
    if i["rows_warp"] == 16:
        name = (f"band_backward_mma_kernel<{i['bucket']}, {vec}, {kv}, "
                f"{i['key_tiles']}>")
    else:
        elem = "float" if dtype == torch.float32 else "bf16"
        name = (f"band_backward_kernel<{i['bucket']}, {vec}, {kv}, "
                f"{i['rows_warp']}, {elem}>")
    regs = ("" if usage is None else "; " + usage.get(
        name, "registers not reported, already built"))
    return (f" (instance {name}: {i['rows_warp']} rows a warp, {i['rows']} "
            f"rows a tile, {i['per_block']} of {i['tiles']} tiles a block, d "
            f"bucket {i['bucket']}{'' if i['vec'] else ', scalar'}{regs})")


# (B, H, d, w) and the T of each level of the fp32 train steps' band
# layers: VidVRD's at 24 pairs (T=768 a check only, no step runs it) and
# VrdONE-X's at its 20 pairs
BWD_SHAPES = (((TRAIN_PAIRS[1], 4, 128, 3), (96, 48, 24, 12, 768)),
              ((20, 8, 64, 4), (512, 256, 128, 64)))


def check_band_backward(cuda, ba, mops, band_rows: list) -> dict:
    """K1's lse and the K2 (dQ) and K3 (dK, dV) kernels through
    ``BandAttention`` against autograd of the plain version, at the fp32
    train steps' band shapes (``BWD_SHAPES``), with a nonzero upstream
    gradient everywhere (invalid query rows included). Returns the JSON
    entries of ``band_attention_dq`` and ``band_attention_dkv``, timed at
    VidVRD's T=96, with each kernel alone at every train shape beside plain
    autograd, SDPA's backward and the bound in ``by_shape``, and appends K1
    with its lse, timed alone at VidVRD's T=96 and at VrdONE-X's four train
    shapes, to ``band_rows``."""
    rng = np.random.default_rng(3)
    worst = {"band_attention_dq": 0.0, "band_attention_dkv": 0.0}
    entries = {name: {"by_shape": []} for name in worst}
    for (b, h, d, w), t in ((s, t) for s, ts in BWD_SHAPES for t in ts):
        kw = dict(n_head=h, window_size=2 * w + 1)
        shape = f"B*H={b}*{h} T={t} d={d} w={w}"
        headline = (b, t) == (TRAIN_PAIRS[1], T)
        q, k, v, mask = attention_inputs(rng, b, t, t, h * d, cuda)
        mask[1, t // 3] = False   # an invalid key inside a valid stretch
        dout = torch.from_numpy(rng.standard_normal(q.shape)
                                .astype(np.float32)).to(cuda)
        with torch.no_grad():
            out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True,
                                              **kw)
            lse_err = ((lse - ba.band_lse_plain(q, k, mask, **kw)).abs()
                       / (1 + ba.band_lse_plain(q, k, mask, **kw).abs())
                       ).max().item()
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(mops.band_attention(*qkv, mask, **kw), qkv,
                                  dout)
        ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
        ref_out = ba.band_attention_plain(*ref_in, mask, **kw)
        want = torch.autograd.grad(ref_out, ref_in, dout, retain_graph=True)
        abs_errs = [(g - r).abs().max().item() for g, r in zip(got, want)]
        errs = [e / max(1.0, r.abs().max().item())
                for e, r in zip(abs_errs, want)]
        print(f"band backward {shape}: lse rel err "
              f"{lse_err:.3e}; dQ, dK, dV err / max|grad| "
              f"{errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e}")
        if not (lse_err <= LSE_TOL and max(errs) <= GRAD_TOL):
            raise AssertionError(f"band backward off at {shape}: lse "
                                 f"{lse_err}, grads {errs}")
        invalid = ~mask
        if not all((g[invalid] == 0).all() for g in got[:1]):
            raise AssertionError("dQ of an invalid query row is not 0")
        worst["band_attention_dq"] = max(worst["band_attention_dq"],
                                         abs_errs[0])
        worst["band_attention_dkv"] = max(worst["band_attention_dkv"],
                                          *abs_errs[1:])
        if t == 768:   # a check only: VidVRD's train step runs T <= 96
            continue
        lib_mask = band_library_mask(mask, w)
        with torch.no_grad():
            dr = ba.band_rowsum(dout, out, h)
            if headline or (b, h) == BWD_SHAPES[1][0][:2]:
                # K1 with its lse at VidVRD's T=96 and at each of
                # VrdONE-X's train levels
                band_rows.append(band_row(
                    ba, f"{shape} with lse",
                    lambda: ba.band_attention_cuda(q, k, v, mask,
                                                   with_lse=True, **kw),
                    time_ms(lambda: (ba.band_attention_plain(q, k, v, mask,
                                                             **kw),
                                     ba.band_lse_plain(q, k, mask, **kw))),
                    lambda: F.scaled_dot_product_attention(
                        heads(q, h), heads(k, h), heads(v, h),
                        attn_mask=lib_mask),
                    q, mask, h, w, with_lse=True))
        args = (q, k, v, mask, lse, dr, dout)
        lib_in = [heads(x, h).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in,
                                                 attn_mask=lib_mask)
        lib_dout = heads(dout, h)
        n, bht = q.numel(), b * h * t
        pairs = h * band_pairs(mask, w)
        for name, kernel, plain_wrt, lib_wrt, out_elems, ops in (
                ("band_attention_dq",
                 lambda: ba.band_attention_dq_cuda(*args, **kw),
                 ref_in[:1], lib_in[:1], n, 6 * d * pairs),
                ("band_attention_dkv",
                 lambda: ba.band_attention_dkv_cuda(*args, **kw),
                 ref_in[1:], lib_in[1:], 2 * n, 8 * d * pairs)):
            def plain(wrt=plain_wrt):
                return torch.autograd.grad(ref_out, wrt, dout,
                                           retain_graph=True)

            def library(wrt=lib_wrt):
                return torch.autograd.grad(lib_out, wrt, lib_dout,
                                           retain_graph=True)

            p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel,
                                                   plain))
            bms, by = bound_ms(4 * (4 * n + 2 * bht + out_elems) + b * t, ops)
            row = dict(shape=shape, device_ms=queued_device_ms(kernel),
                       plain_ms=(p1 + p2) / 2, library_ms=time_ms(library),
                       bound_ms=bms, bound_by=by)
            inst = band_backward_instance(ba, q, h, w,
                                          name == "band_attention_dkv")
            print(f"{name} {shape}{inst}: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"the kernel alone {row['device_ms']:.4f} ms, plain "
                  f"autograd {row['plain_ms']:.4f} ms, library (SDPA) "
                  f"backward {row['library_ms']:.4f} ms, bound {bms:.4f} ms "
                  f"({by})")
            entries[name]["by_shape"].append(row)
            if headline:
                entries[name].update(row, ms=(k1 + k2) / 2)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    return entries


def check_band_backward_bf16(cuda, ba, band_rows: list) -> dict:
    """The bf16 instances of K2 (dQ) and K3 (dK, dV), the tensor-core
    kernel ``band_backward_mma_kernel``, against ``band_backward_plain`` on
    the same bf16 streams, fp32 lse and Dr, and K1 bf16's lse against the
    plain logsumexp, at every ``BWD_BF16_SHAPES`` shape, with a nonzero
    upstream gradient everywhere (invalid query rows included); beside
    each error, that of the FMA body (the fp32 instance on the same values,
    lse and Dr, its gradients rounded to bf16) and the share of elements
    each leaves off the plain version's bf16 gradients. Each kernel
    is timed alone beside its fp32 instance on the same values, the plain
    version, SDPA's bf16 backward and the bound at the dense bf16 rate, and
    its instance printed beside the fp32 one, with registers and spills
    where this run built them. Returns the JSON entries
    ``band_attention_dq_bf16`` and ``band_attention_dkv_bf16`` (all but
    ``launches``), timed at B*H=24*4 T=96, and appends K1 bf16 with its
    lse, alone there, to ``band_rows``."""
    rng = np.random.default_rng(6)
    bf = torch.bfloat16
    usage = instance_usage("band_attention")
    names = ("band_attention_dq_bf16", "band_attention_dkv_bf16")
    entries = {name: {"by_shape": [], "max_abs_err": 0.0} for name in names}
    for b, h, d, w, t in BWD_BF16_SHAPES:
        kw = dict(n_head=h, window_size=2 * w + 1)
        q32, k32, v32, mask = attention_inputs(rng, b, t, t, h * d, cuda)
        mask[1, t // 3] = False   # an invalid key inside a valid stretch
        dout32 = torch.from_numpy(rng.standard_normal(q32.shape)
                                  .astype(np.float32)).to(cuda)
        q, k, v, dout = (x.to(bf) for x in (q32, k32, v32, dout32))
        q32, k32, v32, dout32 = (x.float() for x in (q, k, v, dout))
        with torch.no_grad():
            out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True,
                                              **kw)
            ref_lse = ba.band_lse_plain(q, k, mask, **kw)
            lse_err = ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max(
                ).item()
            dr = ba.band_rowsum(dout, out, h)
            out32, lse32 = ba.band_attention_cuda(q32, k32, v32, mask,
                                                  with_lse=True, **kw)
            dr32 = ba.band_rowsum(dout32, out32, h)
        args = (q, k, v, mask, lse, dr, dout)
        args32 = (q32, k32, v32, mask, lse32, dr32, dout32)
        got = (ba.band_attention_dq_cuda(*args, **kw),
               *ba.band_attention_dkv_cuda(*args, **kw))
        # the FMA body on the same values, lse and Dr (the fp32 instance,
        # its gradients rounded to bf16 once): the error the bf16 kernel's
        # arithmetic is compared with
        fma = [g.to(bf) for g in (
            ba.band_attention_dq_cuda(q32, k32, v32, mask, lse, dr, dout32,
                                      **kw),
            *ba.band_attention_dkv_cuda(q32, k32, v32, mask, lse, dr,
                                        dout32, **kw))]
        want = ba.band_backward_plain(*args, **kw)
        errs, limits, fma_errs, off, fma_off = [], [], [], [], []
        for g, f, r in zip(got, fma, want):
            if not g.dtype == r.dtype == bf:
                raise AssertionError(f"bf16 backward: {g.dtype} gradient, "
                                     f"plain {r.dtype}")
            errs.append((g.float() - r.float()).abs().max().item())
            fma_errs.append((f.float() - r.float()).abs().max().item())
            off.append((g != r).float().mean().item())
            fma_off.append((f != r).float().mean().item())
            limits.append(BF16_KERNEL_TOL * (1 + r.float().abs().max()
                                             .item()))
        del want, fma
        shape = f"B*H={b}*{h} T={t} d={d} w={w}"
        print(f"band backward bf16 {shape}: lse rel err {lse_err:.3e}; "
              f"dQ, dK, dV max_abs_err {errs[0]:.3e}, {errs[1]:.3e}, "
              f"{errs[2]:.3e} (limits {limits[0]:.3e}, {limits[1]:.3e}, "
              f"{limits[2]:.3e}); the FMA body on the same values, rounded "
              f"to bf16: {fma_errs[0]:.3e}, {fma_errs[1]:.3e}, "
              f"{fma_errs[2]:.3e}; share of elements off the plain "
              f"version's bf16 {off[0]:.2e}, {off[1]:.2e}, {off[2]:.2e} "
              f"(FMA body {fma_off[0]:.2e}, {fma_off[1]:.2e}, "
              f"{fma_off[2]:.2e})")
        if not (lse_err <= LSE_TOL
                and all(e <= lim for e, lim in zip(errs, limits))):
            raise AssertionError(f"bf16 band backward off at {shape}: lse "
                                 f"{lse_err}, grads {errs}")
        if not (got[0][~mask] == 0).all():
            raise AssertionError("bf16 dQ of an invalid query row is not 0")
        entries[names[0]]["max_abs_err"] = max(
            entries[names[0]]["max_abs_err"], errs[0])
        entries[names[1]]["max_abs_err"] = max(
            entries[names[1]]["max_abs_err"], *errs[1:])
        lib_mask = band_library_mask(mask, w).to(bf)
        main = (b, h, t) == (24, 4, T)
        if main:
            band_rows.append(bf16_case(
                "band_attention_bf16", f"{shape} with lse",
                lambda: ba.band_attention_cuda(q, k, v, mask, with_lse=True,
                                               **kw)[0],
                lambda: ba.band_attention_plain(q, k, v, mask, **kw),
                lambda: F.scaled_dot_product_attention(
                    heads(q, h), heads(k, h), heads(v, h),
                    attn_mask=lib_mask),
                2 * 4 * q.numel() + 4 * b * h * t + mask.numel(),
                4 * d * h * band_pairs(mask, w)))
        lib_in = [heads(x, h).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=lib_mask)
        lib_dout = heads(dout, h)
        n, bht = q.numel(), b * h * t
        pairs = h * band_pairs(mask, w)
        for name, kernel, kernel32, plain, lib_wrt, out_elems, ops in (
                (names[0], lambda: ba.band_attention_dq_cuda(*args, **kw),
                 lambda: ba.band_attention_dq_cuda(*args32, **kw),
                 lambda: ba.band_backward_plain(*args, **kw)[0],
                 lib_in[:1], n, 6 * d * pairs),
                (names[1], lambda: ba.band_attention_dkv_cuda(*args, **kw),
                 lambda: ba.band_attention_dkv_cuda(*args32, **kw),
                 lambda: ba.band_backward_plain(*args, **kw)[1:],
                 lib_in[1:], 2 * n, 8 * d * pairs)):
            def library(wrt=lib_wrt):
                return torch.autograd.grad(lib_out, wrt, lib_dout,
                                           retain_graph=True)

            p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel,
                                                   plain))
            alone = [queued_device_ms(f) for f in (kernel32, kernel, kernel,
                                                   kernel32)]
            bms, by = bound_ms(2 * (4 * n + out_elems) + 4 * 2 * bht + b * t,
                               ops, PEAK_BF16_MMA)
            row = dict(shape=shape, device_ms=(alone[1] + alone[2]) / 2,
                       fp32_device_ms=(alone[0] + alone[3]) / 2,
                       plain_ms=(p1 + p2) / 2, library_ms=time_ms(library),
                       bound_ms=bms, bound_by=by)
            dkv = name == names[1]
            inst = band_backward_instance(ba, q, h, w, dkv, bf, usage)
            inst32 = band_backward_instance(ba, q, h, w, dkv,
                                            torch.float32, usage)
            print(f"{name} {shape}{inst}: kernel {(k1 + k2) / 2:.4f} ms, "
                  f"the kernel alone {alone[1]:.4f} / {alone[2]:.4f} ms "
                  f"(fp32 instance alone {alone[0]:.4f} / {alone[3]:.4f}"
                  f"{inst32}), plain {row['plain_ms']:.4f} ms, library "
                  f"(SDPA, bf16) backward {row['library_ms']:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})")
            entries[name]["by_shape"].append(row)
            if main:
                entries[name].update(row, ms=(k1 + k2) / 2)
        del lib_in, lib_out
    return entries


def full_backward_bound(kernel: str, b, h, d, tq, tk, mask, esize,
                        peak) -> tuple[float, str]:
    """The bound of K7 with its lse ("fwd"), K8 ("dq") or K9 ("dkv") at a
    shape: each input read once and each output written once (streams of
    ``esize`` bytes, lse and Dr fp32, the mask a byte a key), against 4, 6
    or 8 operations a (query, valid key) pair a channel at ``peak``."""
    nq, nk, stats = b * tq * h * d, b * tk * h * d, 4 * b * h * tq
    n_bytes, per = {"fwd": (esize * (2 * nq + 2 * nk) + stats, 4),
                    "dq": (esize * (3 * nq + 2 * nk) + 2 * stats, 6),
                    "dkv": (esize * (2 * nq + 4 * nk) + 2 * stats, 8)}[kernel]
    return bound_ms(n_bytes + mask.numel(),
                    per * d * h * tq * int(mask.sum()), peak)


def hold_full_backward(fa, label: str, q, k, v, mask, lse, dr, dout,
                       h: int) -> list:
    """K7 (output and lse, launched again), K8 and K9 on one set of inputs
    (``lse`` the one the backward reads) against their plain versions: K7's
    output within KERNEL_TOL, its lse within LSE_TOL (+inf exactly where a
    row has no valid key) and equal to ``lse``; dQ, dK, dV within GRAD_TOL
    of max(1, max |grad|) in fp32, everything within BF16_KERNEL_TOL of 1 +
    max |plain| in bf16; an invalid key's dK and dV exactly 0. Prints the
    gaps and raises on any; returns the max abs errors of K7's output, dQ,
    dK and dV."""
    fp32 = q.dtype == torch.float32
    with torch.no_grad():
        out, lse2 = fa.full_attention_cuda(q, k, v, mask, n_head=h,
                                           with_lse=True)
        ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
        ref_lse = fa.full_attention_lse_plain(q, k, mask, n_head=h)
    got = (fa.full_attention_dq_cuda(q, k, v, mask, lse, dr, dout, n_head=h),
           *fa.full_attention_dkv_cuda(q, k, v, mask, lse, dr, dout,
                                       n_head=h))
    want = (ref, *fa.full_attention_backward_plain(q, k, v, mask, lse, dr,
                                                   dout, n_head=h))
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_lse)
    lse_err = ((lse2 - ref_lse).abs()[fin]
               / (1 + ref_lse.abs()[fin])).max().item()
    errs, limits = [], []
    for i, (g, w) in enumerate(zip((out, *got), want)):
        w = w.float()
        errs.append((g.float() - w).abs().max().item())
        limits.append(BF16_KERNEL_TOL * (1 + w.abs().max().item()) if not fp32
                      else KERNEL_TOL if i == 0
                      else GRAD_TOL * max(1.0, w.abs().max().item()))
    zero = bool((got[1][~mask] == 0).all() and (got[2][~mask] == 0).all())
    same = torch.equal(lse, lse2)
    print(f"{label} {q.dtype}: K7 out, dQ, dK, dV max_abs_err "
          + ", ".join(f"{e:.3e}" for e in errs) + " (limits "
          + ", ".join(f"{x:.3e}" for x in limits) + f"); lse rel err "
          f"{lse_err:.3e}, equal to the backward's: {same}; invalid keys' "
          f"dK, dV all 0: {zero}")
    if not (lse_err <= LSE_TOL and same and zero
            and torch.equal(torch.isposinf(lse2), ~fin)
            and all(e <= x for e, x in zip(errs, limits))):
        raise AssertionError(f"{label} {q.dtype}: kernels off their plain "
                             "versions")
    return errs


def full_backward_kernel(inst: dict, fp32: bool, dkv: bool) -> str:
    """The name and template arguments of the K8 (``dkv`` False) or K9
    kernel an instance (``ops/full_attention.py::backward_instance``)
    launches, as ptxas and the profiler print it: the FMA body in fp32, the
    tensor-core kernel in bf16."""
    if fp32:
        return (f"masked_attention_bwd_kernel<{inst['bucket']}, "
                f"{inst['rows'] // 16}, {str(dkv).lower()}>")
    return (f"masked_attention_bwd_mma_kernel<{inst['bucket']}, "
            f"{inst['rows'] // 16}, {inst['tile']}, {str(dkv).lower()}>")


def check_full_backward(cuda, fa, full_rows: dict) -> dict:
    """K7 with its lse, K8 (dQ) and K9 (dK, dV) at every full attention's
    shape of the flash train step (``FLASH_SHAPES``), in fp32 and bf16, on
    streams with a key mask of random lengths: each against its plain
    version on the same streams (``hold_full_backward``). Each timed alone (queued behind a device sleep) beside the
    plain version (K8 and K9: the whole plain backward), the one library
    call (SDPA's forward with the key mask for K7, its backward for K8 and
    K9) and the bound (the fp32 FMA rate, or the bf16 tensor-core rate),
    with the instance and, where this run built it, its registers. Returns
    the JSON entries ``masked_attention_dq`` / ``_dkv`` and their bf16
    twins (headline: the S/O cross-attention), and appends K7 with its lse
    to ``full_rows`` (the by_shape rows of ``masked_attention`` and
    ``masked_attention_bf16``); returns their worst errors too, under
    those names."""
    rng = np.random.default_rng(11)
    usage = instance_usage("masked_attention_bwd")
    names = {torch.float32: ("masked_attention", "masked_attention_dq",
                             "masked_attention_dkv"),
             torch.bfloat16: ("masked_attention_bf16",
                              "masked_attention_dq_bf16",
                              "masked_attention_dkv_bf16")}
    entries = {n: {"by_shape": [], "max_abs_err": 0.0}
               for trio in names.values() for n in trio[1:]}
    worst_fwd = {trio[0]: 0.0 for trio in names.values()}
    for dtype, (n_fwd, n_dq, n_dkv) in names.items():
        fp32 = dtype == torch.float32
        peak, esize = (PEAK_FLOPS, 4) if fp32 else (PEAK_BF16_MMA, 2)
        for b, h, d, tq, tk in FLASH_SHAPES:
            q, k, v, mask = attention_inputs(rng, b, tq, tk, h * d, cuda)
            mask[1, tk // 3] = False   # an invalid key inside a valid stretch
            dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
                np.float32)).to(cuda)
            q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
            shape = f"B*H={b}*{h} Tq={tq} Tk={tk} d={d}"
            kw = dict(n_head=h)
            with torch.no_grad():
                out, lse = fa.full_attention_cuda(q, k, v, mask,
                                                  with_lse=True, **kw)
                dr = fa.band_rowsum(dout, out, h)
            args = (q, k, v, mask, lse, dr, dout)
            out_err, *errs = hold_full_backward(
                fa, f"full attention backward {shape}", *args, h)
            worst_fwd[n_fwd] = max(worst_fwd[n_fwd], out_err)
            entries[n_dq]["max_abs_err"] = max(entries[n_dq]["max_abs_err"],
                                               errs[0])
            entries[n_dkv]["max_abs_err"] = max(
                entries[n_dkv]["max_abs_err"], *errs[1:])
            # K7 with its lse alone, beside its plain versions and SDPA
            lib_in = [heads(x, h).detach().requires_grad_() for x in (q, k, v)]
            lib_mask = mask[:, None, None, :]
            fwd = lambda: fa.full_attention_cuda(q, k, v, mask, with_lse=True,
                                                 **kw)
            bms, by = full_backward_bound("fwd", b, h, d, tq, tk, mask, esize,
                                          peak)
            with torch.no_grad():
                row = dict(shape=f"{shape} with lse", max_abs_err=out_err,
                           ms=time_ms(fwd), device_ms=queued_device_ms(fwd),
                           plain_ms=time_ms(lambda: (
                               fa.full_attention_plain(q, k, v, mask, **kw),
                               fa.full_attention_lse_plain(q, k, mask,
                                                           **kw))),
                           library_ms=time_ms(
                               lambda: F.scaled_dot_product_attention(
                                   *lib_in, attn_mask=lib_mask)),
                           bound_ms=bms, bound_by=by)
            full_rows[n_fwd].append(row)
            print(f"{n_fwd} {shape} with lse: the kernel alone "
                  f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                  f"ms, library (SDPA) {row['library_ms']:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})")
            lib_out = F.scaled_dot_product_attention(*lib_in,
                                                     attn_mask=lib_mask)
            lib_dout = heads(dout, h)
            plain_ms = time_ms(lambda: fa.full_attention_backward_plain(
                *args, **kw), iters=5)
            for name, kernel, lib_wrt, part, n_own in (
                    (n_dq, lambda: fa.full_attention_dq_cuda(*args, **kw),
                     lib_in[:1], "dq", tq),
                    (n_dkv, lambda: fa.full_attention_dkv_cuda(*args, **kw),
                     lib_in[1:], "dkv", tk)):
                def library(wrt=lib_wrt):
                    return torch.autograd.grad(lib_out, wrt, lib_dout,
                                               retain_graph=True)

                bms, by = full_backward_bound(part, b, h, d, tq, tk, mask,
                                              esize, peak)
                row = dict(shape=shape, ms=time_ms(kernel),
                           device_ms=queued_device_ms(kernel),
                           plain_ms=plain_ms, library_ms=time_ms(library),
                           bound_ms=bms, bound_by=by)
                i = fa.backward_instance(cuda.index or 0, n_own, d, dtype)
                inst = full_backward_kernel(i, fp32, part == "dkv")
                row["instance"] = inst
                regs = usage.get(inst, "registers not reported, already "
                                 "built")
                print(f"{name} {shape} (instance {inst}: {i['rows']} owner "
                      f"rows a block, {i['tile']}-row partner tiles; {regs})"
                      ": the kernel alone "
                      f"{row['device_ms']:.4f} ms, plain backward (all three "
                      f"gradients) {plain_ms:.4f} ms, library (SDPA) "
                      f"backward {row['library_ms']:.4f} ms, bound "
                      f"{bms:.4f} ms ({by})")
                entries[name]["by_shape"].append(row)
                if (tq, tk) == (512, 512):
                    entries[name].update(row)
            del lib_in, lib_out, args
    return entries, worst_fwd


def build_models(cfg, cuda):
    from vrdone_tpu_torch.models.layers import AffineDropPath
    from vrdone_tpu_torch.models.maskvrd import MaskVRD
    gen = torch.Generator().manual_seed(0)
    cpu_model = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        # drop-path scales near 1 (trained weights grow them) so that every
        # attention branch moves the output; the reference init of 1e-4
        # would hide a wrong branch under the tolerance
        for m in cpu_model.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu_model = MaskVRD(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, gpu_model


def packed_batch(rng, cfg, b, t):
    c = packed_channels(cfg)
    lens = rng.integers(2, t + 1, size=b)
    lens[0] = t
    mask = np.arange(t)[None] < lens[:, None]
    x = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    return torch.from_numpy(x), torch.from_numpy(mask)


def serve(model, x, mask, topk: int):
    """One eval step as the JAX bench times it (bench.py:130-140): the
    forward and the decode-side math (class softmax, top-k, mask
    sigmoid > 0.5)."""
    out = model(x, mask)
    probs = torch.softmax(out["pred_logits"], dim=-1)
    scores, catids = torch.topk(probs[..., 1:], topk, dim=-1)
    return out, scores, catids, torch.sigmoid(out["pred_masks"]) > 0.5


def forward_ms(fn, iters: int = 10) -> float:
    """Host-clock ms of one call of ``fn`` (three warm-up calls, then
    ``iters`` calls ended by a synchronize)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def dense_band_calls(ba):
    """Counts the calls of the band attention's dense form (its plain
    version, and ``BandAttentionPE``'s recomputed backward) while open."""
    calls, plain = [0], ba._band_plain

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    ba._band_plain = counted
    try:
        yield calls
    finally:
        ba._band_plain = plain


@contextlib.contextmanager
def backward_shapes(ba):
    """Records, while open, the (B, H, d, w, T) of each dQ kernel launch
    (``band_attention_dq_cuda``, which ``BandAttention`` calls beside its
    dK/dV launch on the same streams)."""
    shapes, dq = set(), ba.band_attention_dq_cuda

    def recorded(q, *args, n_head, window_size):
        b, t, c = q.shape
        shapes.add((b, n_head, c // n_head, window_size // 2, t))
        return dq(q, *args, n_head=n_head, window_size=window_size)

    ba.band_attention_dq_cuda = recorded
    try:
        yield shapes
    finally:
        ba.band_attention_dq_cuda = dq


def check_bf16_serving(cuda, ba, fa) -> dict:
    """bf16 serving at VidVRD B=128 T=96, VidOR B=16 T=512 and VidOR
    local-attention width with use_rel_pe B=16 T=512: the fp32 model of
    each config and its ``cast_floating`` copy, the bf16 forward held
    against the port's bf16 CPU run (B=8, B=2, B=2) within BF16_MODEL_TOL,
    its gap to the fp32 forward on the card printed, the launches of one
    bf16 eval step (only bf16 instances of K1, K4 and K7, in the counts
    the config gives, and no dense band form) and the rates of fp32 and
    bf16 eval steps, timed in turns. Returns the launches of each width's
    bf16 step by kernel (the fp32 names count fp32 instances only)."""
    from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
    from vrdone_tpu_torch.utils.precision import cast_floating
    bf = torch.bfloat16
    rng = np.random.default_rng(4)
    counts = {}
    for yaml, b_check, b_rate, topk, rel_pe in BF16_SERVING:
        width = yaml.split(".")[0] + ("_rel_pe" if rel_pe else "")
        cfg = dataclasses.replace(model_config_from_yaml(load_yaml_config(
            str(ROOT / "configs" / yaml))), use_rel_pe=rel_pe)
        t = cfg.max_seq_len
        cpu32, gpu32 = build_models(cfg, cuda)
        cpu16, gpu16 = cast_floating(cpu32), cast_floating(gpu32)
        del cpu32
        x, mask = packed_batch(rng, cfg, b_check, t)
        with torch.inference_mode():
            ref = cpu16(x.to(bf), mask)
            out16 = gpu16(x.to(cuda, bf), mask.to(cuda))
            out32 = gpu32(x.to(cuda), mask.to(cuda))
            for key in ("pred_logits", "pred_masks"):
                if out16[key].dtype != torch.float32:
                    raise AssertionError(f"{key} is {out16[key].dtype}")
                err = (out16[key].cpu() - ref[key]).abs().max().item()
                top = ref[key].abs().max().item()
                gap = ((out16[key] - out32[key]).abs().max().item()
                       / out32[key].abs().max().item())
                print(f"{width} bf16 forward B={b_check} T={t} {key} "
                      f"{tuple(out16[key].shape)}: CUDA vs CPU max_abs_err "
                      f"{err:.3e} (limit {BF16_MODEL_TOL * top:.3e}, "
                      f"{err / top:.3e} of max |ref|); bf16 vs fp32 on the "
                      f"card {gap:.3e} of max |fp32|")
                if not err <= BF16_MODEL_TOL * top:
                    raise AssertionError(f"{width} bf16 {key} off by {err}")
            del cpu16, ref, out16, out32

            x, mask = packed_batch(rng, cfg, b_rate, t)
            x, mask = x.to(cuda), mask.to(cuda)
            x16 = x.to(bf)
            zero_counts(ba, fa)
            with dense_band_calls(ba) as dense:
                _, scores, catids, masks_bin = serve(gpu16, x16, mask, topk)
                torch.cuda.synchronize()
            got = {"band_attention": ba.launches - ba.bf16_launches,
                   "band_attention_bf16": ba.bf16_launches,
                   "band_attention_pe": ba.pe_launches - ba.pe_bf16_launches,
                   "band_attention_pe_bf16": ba.pe_bf16_launches,
                   "masked_attention": fa.launches - fa.bf16_launches,
                   "masked_attention_bf16": fa.bf16_launches,
                   "dense band form": dense[0]}
            # the stem's and branches' blocks take K4 with use_rel_pe, else
            # K1; the S/O mutual layers K1 with use_local, else K7; the
            # predictor K7
            arch, nq = cfg.backbone_arch, cfg.predictor.num_queries
            blocks, mutual = 2 * arch[1] + arch[2], 4 * arch[1]
            expect = {name: 0 for name in got}
            expect.update(
                band_attention_bf16=(0 if rel_pe else blocks)
                + (mutual if cfg.use_local else 0),
                band_attention_pe_bf16=blocks if rel_pe else 0,
                masked_attention_bf16=(0 if cfg.use_local else mutual)
                + 2 * cfg.predictor.num_layers)
            print(f"{width} bf16 eval step B={b_rate} T={t}: kernel "
                  f"launches {got}")
            if got != expect:
                raise AssertionError(f"launches {got}, expected {expect}")
            del got["dense band form"]
            if (scores.shape != (b_rate, nq, topk)
                    or masks_bin.shape != (b_rate, nq, t)
                    or not torch.isfinite(scores).all()):
                raise AssertionError(f"{width} bf16 step: scores "
                                     f"{tuple(scores.shape)}, masks "
                                     f"{tuple(masks_bin.shape)}")
            counts[width] = got
            steps = {"fp32": lambda: serve(gpu32, x, mask, topk),
                     "bf16": lambda: serve(gpu16, x16, mask, topk)}
            ms = {k: [] for k in steps}
            for k in ("fp32", "bf16", "bf16", "fp32"):
                ms[k].append(forward_ms(steps[k]))
            for k, v in ms.items():
                print(f"{width} {k} eval step B={b_rate} T={t}: "
                      f"{v[0]:.2f} / {v[1]:.2f} ms, "
                      f"{1e3 * b_rate / v[0]:.1f} / "
                      f"{1e3 * b_rate / v[1]:.1f} pairs/s")
                _, _, events = profile_device(steps[k], 3, "step")
                if k != "bf16":
                    continue
                # K7 bf16 is the tensor-core kernel; the FMA kernel is
                # fp32's alone (the profiler may miss some ctypes launches)
                mma = sum(e.count for e in events
                          if "masked_attention_mma_kernel" in e.key)
                fma = [e.key for e in events
                       if "masked_attention_fwd_kernel" in e.key]
                print(f"  the profiler saw masked_attention_mma_kernel "
                      f"{mma} times in 3 bf16 steps, the FMA kernel "
                      f"{len(fma)} times")
                if fma:
                    raise AssertionError(f"bf16 step ran {fma}")
                refuse_fma_band(events, f"3 {width} bf16 eval steps")
        del gpu16, gpu32
        torch.cuda.empty_cache()
    return counts


def vrdone_x_config():
    """VrdONE-X's model config and the raw YAML (``configs/vidor_x.yaml``:
    VidOR's widths with 2 x 512 CLIP channels a pair and 10 queries)."""
    from vrdone_tpu_torch.config import (load_yaml_config,
                                         model_config_from_yaml)
    raw = load_yaml_config(str(ROOT / "configs" / "vidor_x.yaml"))
    cfg = model_config_from_yaml(raw)
    if packed_channels(cfg) != 2 * 1024 + 2 * 512 + 5 + 2 * 8:
        raise AssertionError(f"VrdONE-X packs {packed_channels(cfg)} "
                             "channels, not 3093")
    return cfg, raw


def check_vrdone_x(cuda, ba, fa) -> dict:
    """VrdONE-X at full width (``configs/vidor_x.yaml``, random seeded
    weights): the fp32 forward on the card against the CPU at B=2 within
    MODEL_TOL; the launches of one fp32 eval step at B=16 (K1 fp32 and K7
    fp32 only, no dense band or full-attention form); the reference
    converter's round trip on the card (the model's parameters in the
    reference's layout, saved as a ``.pth``, through
    ``convert_reference_checkpoint_torch.py`` and ``eval_torch.py``'s
    loader into a fresh model, whose forward is the first's bit for bit);
    ``check_train_step`` at VRDONE_X_TRAIN_CHECK pairs (three steps on the
    card and the CPU: losses, step-0 gradients, parameter and EMA drift;
    the launches of a fourth at the config's 20 pairs), and the step at 20
    pairs timed and profiled. Returns the
    launches of the eval step and of the train step by kernel."""
    from convert_reference_checkpoint_torch import convert
    from eval_torch import load_weights
    from tests.reference_state_dicts import relation_state_dict
    from vrdone_tpu_torch.convert import params_to_jax
    from vrdone_tpu_torch.models.maskvrd import MaskVRD
    from vrdone_tpu_torch.train.loop import (batch_to_device,
                                             step_generator, train_step)
    cfg, raw = vrdone_x_config()
    t = cfg.max_seq_len
    arch, layers = cfg.backbone_arch, cfg.predictor.num_layers
    rng = np.random.default_rng(8)
    cpu_model, gpu_model = build_models(cfg, cuda)
    x, mask = packed_batch(rng, cfg, VRDONE_X_CHECK, t)
    with torch.inference_mode():
        ref = cpu_model(x, mask)
        out = gpu_model(x.to(cuda), mask.to(cuda))
        for key in ("pred_logits", "pred_masks"):
            err = (out[key].cpu() - ref[key]).abs().max().item()
            print(f"vidor_x forward B={VRDONE_X_CHECK} T={t} {key} "
                  f"{tuple(out[key].shape)}: CUDA vs CPU max_abs_err "
                  f"{err:.3e}")
            if not err <= MODEL_TOL:
                raise AssertionError(f"vidor_x {key} off by {err}")
        del cpu_model, ref

        x, mask = packed_batch(rng, cfg, VRDONE_X_RATE, t)
        x, mask = x.to(cuda), mask.to(cuda)
        zero_counts(ba, fa)
        with dense_band_calls(ba) as dense:
            out, scores, _, masks_bin = serve(gpu_model, x, mask, 4)
            torch.cuda.synchronize()
        serve_launches = band_counts(ba, fa)
        got = {**serve_launches, "dense band form": dense[0],
               "dense full attention": fa.dense_calls}
        expect = {name: 0 for name in got}
        expect.update(band_attention=2 * arch[1] + arch[2],
                      masked_attention=4 * arch[1] + 2 * layers)
        print(f"vidor_x fp32 eval step B={VRDONE_X_RATE} T={t}: kernel "
              f"launches {got}")
        if got != expect:
            raise AssertionError(f"vidor_x launches {got}, expected {expect}")
        nq = cfg.predictor.num_queries
        if (scores.shape != (VRDONE_X_RATE, nq, 4)
                or masks_bin.shape != (VRDONE_X_RATE, nq, t)
                or not all(torch.isfinite(out[k]).all()
                           for k in ("pred_logits", "pred_masks"))):
            raise AssertionError(f"vidor_x step: scores "
                                 f"{tuple(scores.shape)}, masks "
                                 f"{tuple(masks_bin.shape)}")

    # the reference converter on the card's own parameters, the fresh
    # model built and loaded as eval_torch.py does, outside inference mode
    # (parameters made inside it are inference tensors, and with them some
    # Dense products round otherwise: the first branch block's query
    # projection first differed by 3e-6); the EMA entry is the one taken,
    # so the other holds other values
    sd = {k: torch.from_numpy(v) for k, v in relation_state_dict(
        params_to_jax(gpu_model.state_dict())).items()}
    with tempfile.TemporaryDirectory() as tmp:
        pth, npz = os.path.join(tmp, "x.pth"), os.path.join(tmp, "x.npz")
        torch.save({"epoch": 15, "model_state_dict_ema": sd,
                    "model_state_dict": {k: v + 1 for k, v in sd.items()}},
                   pth)
        t0 = time.perf_counter()
        flat = convert(pth, npz)
        fresh = MaskVRD(cfg, device=cuda)
        load_weights(fresh, npz)
        seconds = time.perf_counter() - t0
    del sd
    with torch.inference_mode():
        again = fresh(x, mask)
    same = all(torch.equal(again[k], out[k])
               for k in ("pred_logits", "pred_masks"))
    print(f"vidor_x reference checkpoint round trip: {len(flat)} arrays "
          f"converted and loaded strictly in {seconds:.1f} s; forward at "
          f"B={VRDONE_X_RATE} bit for bit the same: {same}")
    if not same:
        raise AssertionError("the converted VrdONE-X forward differs")
    del fresh, again, gpu_model, out
    torch.cuda.empty_cache()

    # three train steps on both devices, checked as VidVRD's are, at
    # VRDONE_X_TRAIN_CHECK pairs (the CPU's three full-width steps at the
    # config's 20 took most of this phase), the launches of a step at the
    # config's pairs, then the card's step timed at those pairs
    n_pairs = raw["training_dataset_config"]["num_pairs"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    state, train_launches = check_train_step(
        cfg, raw, cuda, ba, fa, pairs=(VRDONE_X_TRAIN_CHECK, n_pairs),
        label="vidor_x ")
    tb = batch_to_device(train_batch(rng, cfg, n_pairs, num_gt), cuda)

    def step():
        return train_step(state, tb, step_generator(0, state.step))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = forward_ms(step, iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"vidor_x fp32 train step at {n_pairs} pairs: {ms:.2f} ms, "
          f"{1e3 * n_pairs / ms:.1f} pairs/s, peak {peak:.2f} GiB")
    profile_device(step, 2, "step")
    del state, tb
    torch.cuda.empty_cache()
    return {"serve_vidor_x": serve_launches,
            "train_step_vidor_x": train_launches}


def train_pairs(rng, cfg, n, num_gt):
    """n synthetic SO pairs with ground truth, as datasets.get_train_item
    yields them."""
    c = packed_channels(cfg)
    pairs = []
    for _ in range(n):
        t = int(rng.integers(8, cfg.max_seq_len + 1))
        ng = int(rng.integers(1, num_gt + 1))
        segs = np.sort(rng.integers(0, t, (ng, 2)), axis=1)
        segs[:, 1] += 1
        masks = np.zeros((ng, cfg.max_seq_len), np.float32)
        for j, (s, e) in enumerate(segs):
            masks[j, s:e] = 1
        pairs.append({"so_feat": rng.standard_normal((t, c))
                      .astype(np.float32),
                      "preds": rng.integers(1, cfg.num_classes + 1, ng),
                      "segs": segs, "masks": masks})
    return pairs


def train_batch(rng, cfg, n, num_gt):
    from vrdone_tpu_torch.data.batching import pack_train_batch
    return pack_train_batch(train_pairs(rng, cfg, n, num_gt), n,
                            cfg.max_seq_len, num_gt, packed_channels(cfg))


class PoolReplay:
    """Stands in for ``ops.masked.max_pool1d`` in the step-0 comparison:
    on the card it records the position each window picks, on the CPU it
    takes the card's picks and counts the windows where its own pick
    differs. Activations agree only to about 1e-6 across devices, so a
    near-tie in a window can pick another position on each, and the
    gradient then flows to another element: a real difference of the two
    forwards, not an error of either backward. Replaying the card's picks
    compares the two backwards on one set of choices."""

    def __init__(self):
        self.picks, self.replay = [], False
        self.flips = self.windows = 0

    def __call__(self, x, *, kernel, stride, padding):
        xt = x.transpose(1, 2)
        out, idx = F.max_pool1d(xt, kernel, stride, padding,
                                return_indices=True)
        if self.replay:
            pick = self.picks.pop(0).to(x.device)
            self.flips += int((pick != idx).sum())
            out = xt.gather(-1, pick)
        else:
            self.picks.append(idx.cpu())
            self.windows += idx.numel()
        return out.transpose(1, 2)


def check_step0_gradients(label: str, names, got, want,
                          tol: float = STEP_GRAD_TOL) -> float:
    """The step-0 gradients (the first moments after step 0, 0.1 g) ``got``
    against ``want``: over the whole model by norm within ``tol``
    (STEP_GRAD_TOL by default), and the three leaves furthest off printed
    for the record (a leaf whose gradient is a sum that nearly cancels, as
    softmax makes of the key projections', carries a larger share of
    rounding). Returns the gap."""
    num = sum(((a - b) ** 2).sum() for a, b in zip(got, want))
    den = sum((b ** 2).sum() for b in want)
    rel = (num / den).sqrt().item()
    top = max(g.abs().max().item() for g in want)
    leaves = sorted(((a - b).abs().max().item()
                     / max(b.abs().max().item(), 1e-30), n,
                     b.abs().max().item() / top)
                    for n, a, b in zip(names, got, want))[-3:]
    print(f"{label}: |dg| / |g| over the model {rel:.3e}; worst leaves (max "
          f"err / leaf max, leaf max / model max): " + "; ".join(
              f"{n} {e:.2e}, {m:.2e}" for e, n, m in reversed(leaves)))
    if not rel <= tol:
        raise AssertionError(f"{label}: off by {rel}")
    return rel


def check_train_step(cfg, raw, cuda, ba, fa, pairs=TRAIN_PAIRS[:2],
                     label: str = "", flash: bool = False):
    """Three full-width fp32 train steps at ``pairs[0]`` pairs on the card
    and on the CPU from the same weights, batch and drop-path draws: losses
    within LOSS_TOL, step-0 gradients within STEP_GRAD_TOL, parameters and
    EMA within DRIFT_TOL; then the launches of one step at ``pairs[1]``
    pairs (K1, K2 and K3 fp32 once a band layer, the dense full attention,
    no K7 and no dense band form; with ``flash``, which the caller has set
    in ``ops.masked.FLASH_TRAIN``, K7 with its lse, K8 and K9 once a full
    attention and no dense full attention). Returns the card's train state
    and the launches of that one step per kernel."""
    from vrdone_tpu_torch.models.layers import AffineDropPath
    from vrdone_tpu_torch.models.maskvrd import match
    from vrdone_tpu_torch.ops import masked as mops
    from vrdone_tpu_torch.train.loop import (batch_to_device,
                                             create_train_state,
                                             step_generator, train_step)
    tc = raw["training_config"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    steps_per_epoch = 100
    states = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        gen = torch.Generator().manual_seed(0)
        state, _ = create_train_state(cfg, tc, steps_per_epoch, device=dev,
                                      generator=gen)
        with torch.no_grad():
            # drop-path scales near 1 so that every branch moves the loss
            for m in state.model.modules():
                if isinstance(m, AffineDropPath):
                    m.scale.copy_(torch.empty_like(m.scale, device="cpu")
                                  .uniform_(0.5, 1.5, generator=gen))
        state.ema_params = [p.detach().clone() for p in state.params()]
        states[name] = state
    rng = np.random.default_rng(5)
    batch = train_batch(rng, cfg, pairs[0], num_gt)
    first_grads = {}
    max_pool1d, pool = mops.max_pool1d, PoolReplay()
    for step in range(3):
        rows, losses = {}, {}
        # the card first: step 0's CPU run replays its max-pool picks
        for name in ("cuda", "cpu"):
            state = states[name]
            dev = next(state.model.parameters()).device
            tb = batch_to_device(batch, dev)
            with torch.no_grad():
                state.model.train()
                preds = state.model(tb["feats"], tb["seq_mask"],
                                    step_generator(0, step))
                logits = torch.stack([preds["pred_logits"], *[
                    a["pred_logits"] for a in preds["aux_outputs"]]])
                masks = torch.stack([preds["pred_masks"], *[
                    a["pred_masks"] for a in preds["aux_outputs"]]])
                rows[name] = match(cfg, logits, masks, tb)[0].cpu()
            if step == 0:
                pool.replay = name == "cpu"
                mops.max_pool1d = pool
            try:
                _, losses[name] = train_step(state, tb,
                                             step_generator(0, step))
            finally:
                mops.max_pool1d = max_pool1d
            if step == 0:
                first_grads[name] = [m.detach().cpu().clone() for m in
                                     state.optimizer.moments["mu"]]
        if step == 0:
            print(f"{label}step 0: max-pool windows whose pick differs "
                  f"between the devices (a near-tie; the CPU replays the "
                  f"card's): "
                  f"{pool.flips} of {pool.windows}")
        flips = int((rows["cuda"] != rows["cpu"]).any(-1).sum())
        errs = {k: abs(losses["cuda"][k].item() - v.item())
                / (1 + abs(v.item())) for k, v in losses["cpu"].items()}
        worst = max(errs, key=errs.get)
        print(f"{label}train step {step} at {pairs[0]} pairs: total_loss "
              f"cpu {losses['cpu']['total_loss'].item():.6f} cuda "
              f"{losses['cuda']['total_loss'].item():.6f}; worst loss term "
              f"{worst} rel err {errs[worst]:.3e}; matchings that differ: "
              f"{flips} of {rows['cpu'].shape[0] * rows['cpu'].shape[1]}")
        if flips:
            print(f"  NOTE: {flips} matchings differ between CPU and CUDA "
                  "(a near-tie in the cost flips the assignment)")
        if errs[worst] > LOSS_TOL:
            raise AssertionError(f"{label}train step {step}: {worst} off by "
                                 f"{errs[worst]}")
    names = [n for n, _ in states["cpu"].model.named_parameters()]
    check_step0_gradients(f"{label}step 0 gradients CUDA vs CPU", names,
                          first_grads["cuda"], first_grads["cpu"])
    # parameters and EMA, against each leaf's largest value plus the total
    # learning rate, the most Adam moves a coordinate: a zero-initialised
    # leaf holds only its steps, and Adam's (0.09 g0 + 0.1 g1) can cancel
    # and magnify last-bit gradient differences into a share of a step
    lr_sum = sum(states["cpu"].optimizer.schedule(t) for t in range(3))
    for kind, get in (("params", lambda s: s.params()),
                      ("ema", lambda s: s.ema_params)):
        drift, where = 0.0, ""
        for n, a, b, g in zip(names, get(states["cuda"]),
                              get(states["cpu"]), first_grads["cpu"]):
            if g.abs().max() < 1e-9:   # gradient-free leaf: noise vs noise
                continue
            rel = ((a.detach().cpu() - b.detach()).abs().max()
                   / (b.detach().abs().max() + lr_sum)).item()
            if rel > drift:
                drift, where = rel, n
        print(f"{label}after 3 steps, {kind}: worst drift CUDA vs CPU / (leaf "
              f"max + sum of lr {lr_sum:.3e}) {drift:.3e} ({where})")
        if drift > DRIFT_TOL:
            raise AssertionError(f"{label}{kind} drift {drift} at {where}")
    del states["cpu"]

    state = states["cuda"]
    tb = batch_to_device(train_batch(rng, cfg, pairs[1], num_gt), cuda)
    torch.cuda.synchronize()
    zero_counts(ba, fa)
    with dense_band_calls(ba) as dense:
        train_step(state, tb, step_generator(0, state.step))
        torch.cuda.synchronize()
    launches = band_counts(ba, fa)
    got = {**launches, "K7 with lse": fa.lse_launches,
           "dense band form": dense[0],
           "dense full attention": fa.dense_calls}
    blocks = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    full = 4 * cfg.backbone_arch[1] + 2 * cfg.predictor.num_layers
    expect = {name: 0 for name in got}
    expect.update(band_attention=blocks, band_attention_dq=blocks,
                  band_attention_dkv=blocks)
    if flash:
        expect.update(masked_attention=full, masked_attention_dq=full,
                      masked_attention_dkv=full, **{"K7 with lse": full})
    else:
        expect["dense full attention"] = full
    print(f"{label}train step at {pairs[1]} pairs: kernel launches {got}")
    if got != expect:
        raise AssertionError(f"{label}train launches {got}, expected "
                             f"{expect}")
    return state, launches


def band_counts(ba, fa) -> dict:
    """The launches of the band kernels (K1, K4, K2, K3), fp32 and bf16
    instances apart, of K7 and of the full attention's backward (K8, K9),
    fp32 and bf16 apart, since the counts were last set to 0."""
    return {"band_attention": ba.launches - ba.bf16_launches,
            "band_attention_bf16": ba.bf16_launches,
            "band_attention_pe": ba.pe_launches - ba.pe_bf16_launches,
            "band_attention_pe_bf16": ba.pe_bf16_launches,
            "band_attention_dq": ba.dq_launches - ba.bf16_dq_launches,
            "band_attention_dq_bf16": ba.bf16_dq_launches,
            "band_attention_dkv": ba.dkv_launches - ba.bf16_dkv_launches,
            "band_attention_dkv_bf16": ba.bf16_dkv_launches,
            "masked_attention": fa.launches - fa.bf16_launches,
            "masked_attention_bf16": fa.bf16_launches,
            "masked_attention_dq": fa.dq_launches - fa.bf16_dq_launches,
            "masked_attention_dq_bf16": fa.bf16_dq_launches,
            "masked_attention_dkv": fa.dkv_launches - fa.bf16_dkv_launches,
            "masked_attention_dkv_bf16": fa.bf16_dkv_launches}


def zero_counts(ba, fa) -> None:
    ba.launches = ba.bf16_launches = 0
    ba.pe_launches = ba.pe_bf16_launches = 0
    ba.dq_launches = ba.bf16_dq_launches = 0
    ba.dkv_launches = ba.bf16_dkv_launches = 0
    fa.launches = fa.bf16_launches = fa.dense_calls = fa.lse_launches = 0
    fa.dq_launches = fa.bf16_dq_launches = 0
    fa.dkv_launches = fa.bf16_dkv_launches = 0


def level_costs(cfg, preds, tb):
    """The matching costs (L, B, Q, G) of every level of ``preds`` and the
    rows the matcher assigns them (L, B, G), on the CPU."""
    from vrdone_tpu_torch.models import losses as LO
    from vrdone_tpu_torch.models.maskvrd import match
    logits = torch.stack([preds["pred_logits"], *[
        a["pred_logits"] for a in preds["aux_outputs"]]])
    masks = torch.stack([preds["pred_masks"], *[
        a["pred_masks"] for a in preds["aux_outputs"]]])
    cost = LO.matching_cost(
        logits, masks, tb["gt_labels"], tb["gt_masks"], tb["gt_segs"],
        tb["gt_valid"], tb["seq_mask"], cost_class=cfg.cost_class,
        cost_mask=cfg.cost_mask, cost_dice=cfg.cost_dice,
        scale_range=cfg.scale_range if cfg.with_fuzzy else None)
    return cost.cpu(), match(cfg, logits, masks, tb)[0].cpu()


def bf16_steps_vs_cpu(cfg16, tc, cuda, batch, label: str,
                      must_move: str | None = None,
                      grads: dict | None = None) -> dict:
    """Three bf16 train steps of ``cfg16`` on ``batch`` on the card against
    the port's bf16 CPU steps from the same weights, batch and drop-path
    draws: losses within BF16_LOSS_TOL, matchings equal or near-ties
    within MATCH_TIE_TOL, step 0's CPU run replaying the card's max-pool
    picks; the masters, EMA and moments stay fp32, and on both devices
    every parameter whose name ends with ``must_move`` has moved. With
    ``grads``, each device's first moments after step 0 (0.1 g) go there
    by device name. Returns the train states by device."""
    from vrdone_tpu_torch.models.layers import AffineDropPath
    from vrdone_tpu_torch.ops import masked as mops
    from vrdone_tpu_torch.train.loop import (batch_to_device,
                                             create_train_state,
                                             step_generator, train_step)
    from vrdone_tpu_torch.utils.precision import cast_tensors
    states = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        gen = torch.Generator().manual_seed(0)
        state, _ = create_train_state(cfg16, tc, 100, device=dev,
                                      generator=gen)
        with torch.no_grad():
            for m in state.model.modules():
                if isinstance(m, AffineDropPath):
                    m.scale.copy_(torch.empty_like(m.scale, device="cpu")
                                  .uniform_(0.5, 1.5, generator=gen))
        state.ema_params = [p.detach().clone() for p in state.params()]
        states[name] = state
    watched = {n: p.detach().clone()
               for n, p in states["cpu"].model.named_parameters()
               if must_move and n.endswith(must_move)}
    n_pairs = batch["feats"].shape[0]
    valid = batch["gt_valid"]
    max_pool1d, pool = mops.max_pool1d, PoolReplay()
    for step in range(3):
        costs, rows, losses, seconds = {}, {}, {}, {}
        # the card first: step 0's CPU run replays its max-pool picks
        for name in ("cuda", "cpu"):
            state = states[name]
            dev = next(state.model.parameters()).device
            tb = batch_to_device(batch, dev)
            model = state.model.train()
            with torch.no_grad():
                preds = torch.func.functional_call(
                    model, cast_tensors(model),
                    (tb["feats"].to(torch.bfloat16), tb["seq_mask"],
                     step_generator(0, step)))
                costs[name], rows[name] = level_costs(cfg16, preds, tb)
            if step == 0:
                pool.replay = name == "cpu"
                mops.max_pool1d = pool
            t0 = time.perf_counter()
            try:
                _, losses[name] = train_step(state, tb,
                                             step_generator(0, step))
            finally:
                mops.max_pool1d = max_pool1d
            seconds[name] = time.perf_counter() - t0
            if step == 0 and grads is not None:
                grads[name] = [m.detach().cpu().clone()
                               for m in state.optimizer.moments["mu"]]
        errs = {k: abs(losses["cuda"][k].item() - v.item())
                / (1 + abs(v.item())) for k, v in losses["cpu"].items()}
        worst = max(errs, key=errs.get)
        flips, ties = 0, 0.0
        for lvl in range(rows["cpu"].shape[0]):
            for b in range(valid.shape[0]):
                cols = torch.from_numpy(np.nonzero(valid[b])[0])
                mine, ref = rows["cuda"][lvl, b, cols], rows["cpu"][lvl, b,
                                                                    cols]
                if torch.equal(mine, ref):
                    continue
                flips += 1
                cost = costs["cpu"][lvl, b][:, cols]
                idx = torch.arange(len(cols))
                best = cost[ref, idx].sum().item()
                gap = (cost[mine, idx].sum().item() - best) / abs(best)
                ties = max(ties, gap)
                if gap > MATCH_TIE_TOL:
                    raise AssertionError(f"bf16 matching at step {step} "
                                         f"level {lvl} item {b} costs {gap} "
                                         "above the CPU's")
        replayed = (f"; max-pool picks replayed that differ {pool.flips} of "
                    f"{pool.windows}" if step == 0 else "")
        print(f"{label} bf16 train step {step} at {n_pairs} pairs (the CPU "
              f"bf16 step {seconds['cpu']:.1f} s): total_loss cpu "
              f"{losses['cpu']['total_loss'].item():.6f} cuda "
              f"{losses['cuda']['total_loss'].item():.6f}; worst loss term "
              f"{worst} rel err {errs[worst]:.3e} (limit {BF16_LOSS_TOL})"
              f"{replayed}; matchings that differ {flips} of "
              f"{rows['cpu'].shape[0] * valid.shape[0]}, the worst "
              f"{ties:.2e} above the CPU's optimum (limit {MATCH_TIE_TOL})")
        if errs[worst] > BF16_LOSS_TOL:
            raise AssertionError(f"bf16 train step {step}: {worst} off by "
                                 f"{errs[worst]}")
    if not all(p.dtype == torch.float32 for s in states.values()
               for p in [*s.params(), *s.ema_params,
                         *s.optimizer.moments["mu"]]):
        raise AssertionError("bf16 step: masters, EMA or moments not fp32")
    if must_move:
        moved = {dev: min((p.detach().cpu() - watched[n]).abs().max().item()
                          for n, p in s.model.named_parameters()
                          if n in watched) for dev, s in states.items()}
        print(f"{label}: the {len(watched)} {must_move} leaves moved in 3 "
              f"steps by at least {moved} (largest change of each leaf)")
        if not watched or min(moved.values()) <= 0:
            raise AssertionError(f"{must_move} did not move: {moved}")
    return states


def check_train_step_bf16(cfg, raw, cuda, ba, fa, state32) -> dict:
    """The bf16 train step at full width (``compute_dtype: bfloat16``):
    three steps at 8 pairs on the card against the port's bf16 CPU steps
    (``bf16_steps_vs_cpu``); the launches of one bf16 step at 24 pairs
    (only bf16 instances of K1, K2 and K3, 7 each, no K7) and of one under
    remat (K1 14); one remat step under each policy against the plain step
    from the same fp32 state (losses within LOSS_TOL, drop path on), with
    peak memory; then fp32 and bf16 steps at 24 and 96 pairs, timed in
    turns and profiled. Returns the launches of the bf16 step at 24 pairs
    by kernel."""
    import copy

    from vrdone_tpu_torch.train.loop import (batch_to_device, step_generator,
                                             train_step)
    tc = raw["training_config"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    rng = np.random.default_rng(7)
    states = bf16_steps_vs_cpu(cfg16, tc, cuda,
                               train_batch(rng, cfg, TRAIN_PAIRS[0], num_gt),
                               "vidvrd")

    # the launches of one bf16 step at 24 pairs, and of one under remat
    state16 = states.pop("cuda")
    del states
    band = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    tb = batch_to_device(train_batch(rng, cfg, TRAIN_PAIRS[1], num_gt), cuda)
    counts = {}
    for remat in (False, True):
        state16.model.config = dataclasses.replace(cfg16, remat=remat,
                                                   remat_policy="dots")
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        train_step(state16, tb, step_generator(0, state16.step))
        torch.cuda.synchronize()
        counts[remat] = band_counts(ba, fa)
        expect = {name: 0 for name in counts[remat]}
        expect.update(band_attention_bf16=2 * band if remat else band,
                      band_attention_dq_bf16=band,
                      band_attention_dkv_bf16=band)
        print(f"bf16 train step at {TRAIN_PAIRS[1]} pairs"
              f"{' with remat (dots)' if remat else ''}: kernel launches "
              f"{counts[remat]}, dense full-attention calls "
              f"{fa.dense_calls}")
        if counts[remat] != expect:
            raise AssertionError(f"launches {counts[remat]}, expected "
                                 f"{expect}")
    state16.model.config = cfg16

    # remat under each policy against the plain step, fp32, from copies of
    # one state, with drop path on
    remat_losses = {}
    for policy in (None, "full", "dots"):
        st = copy.deepcopy(state32)
        st.model.config = dataclasses.replace(
            cfg, remat=policy is not None, remat_policy=policy or "full")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, remat_losses[policy] = train_step(st, tb, step_generator(0, 99))
        torch.cuda.synchronize()
        print(f"fp32 train step at {TRAIN_PAIRS[1]} pairs, remat "
              f"{policy or 'off'}: {1e3 * (time.perf_counter() - t0):.2f} "
              f"ms (one step, first of its kind), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"total_loss {remat_losses[policy]['total_loss'].item():.6f}")
        del st
    for policy in ("full", "dots"):
        errs = {k: abs(remat_losses[policy][k].item() - v.item())
                / (1 + abs(v.item())) for k, v in remat_losses[None].items()}
        if max(errs.values()) > LOSS_TOL:
            raise AssertionError(f"remat {policy}: losses off by {errs}")

    # fp32 and bf16 steps at 24 and 96 pairs, in turns
    for n_pairs in TRAIN_PAIRS[1:]:
        tb = batch_to_device(train_batch(rng, cfg, n_pairs, num_gt), cuda)
        steps = {"fp32": state32, "bf16": state16}
        for st in steps.values():
            for _ in range(2):
                train_step(st, tb, step_generator(0, st.step))
        torch.cuda.synchronize()
        ms, peak = {k: [] for k in steps}, {}
        for k in ("fp32", "bf16", "bf16", "fp32"):
            st = steps[k]
            torch.cuda.reset_peak_memory_stats()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                _, losses = train_step(st, tb, step_generator(0, st.step))
            torch.cuda.synchronize()
            ms[k].append(1e3 * (time.perf_counter() - t0) / iters)
            if not all(torch.isfinite(v) for v in losses.values()):
                raise AssertionError(f"non-finite {k} losses at {n_pairs} "
                                     "pairs")
            peak[k] = torch.cuda.max_memory_allocated() / 2**30
        for k, v in ms.items():
            print(f"vidvrd train step {n_pairs} pairs T={T} {k}: "
                  f"{v[0]:.2f} / {v[1]:.2f} ms per step, "
                  f"{1e3 * n_pairs / v[0]:.1f} / {1e3 * n_pairs / v[1]:.1f} "
                  f"pairs/s, peak memory {peak[k]:.2f} GiB")
            st = steps[k]
            _, _, events = profile_device(
                lambda: train_step(st, tb, step_generator(0, st.step)), 3,
                "step")
            if k == "bf16":
                refuse_fma_band(events, f"3 bf16 train steps at {n_pairs} "
                                "pairs")
    return counts[False]


def check_train_step_relpe_bf16(cuda, ba, fa) -> dict:
    """bf16 training with ``use_rel_pe`` at VidOR local-attention width
    (``configs/vidor_local.yaml`` with ``use_rel_pe`` and ``compute_dtype:
    bfloat16``, random seeded weights): three steps at a few pairs on the
    card against the port's bf16 CPU steps (``bf16_steps_vs_cpu``), every
    ``rel_pe`` moved; the launches of one step at 48 pairs (the config's
    batch_size 3 x num_pairs 16), without and with remat: K4 bf16 once a
    stem or branch block (twice under remat), whose backward is the dense
    form once a block, K1 bf16 once a local S/O mutual layer (twice under
    remat) with K2 and K3 bf16 once, at the shape
    ``check_band_backward_bf16`` times last, no fp32 instance and no K7
    (the predictor trains through the dense form); then bf16 steps at 48
    pairs timed and profiled (no FMA band kernel on bf16 streams). Returns
    the launches of the step without remat by kernel."""
    from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
    from vrdone_tpu_torch.train.loop import (batch_to_device, step_generator,
                                             train_step)
    raw = load_yaml_config(str(ROOT / "configs" / "vidor_local.yaml"))
    cfg16 = dataclasses.replace(model_config_from_yaml(raw), use_rel_pe=True,
                                compute_dtype="bfloat16")
    tc = raw["training_config"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    rng = np.random.default_rng(15)
    state16 = bf16_steps_vs_cpu(
        cfg16, tc, cuda, train_batch(rng, cfg16, RELPE_TRAIN_PAIRS[0], num_gt),
        "vidor_local + use_rel_pe", must_move="rel_pe")["cuda"]

    n_pairs = RELPE_TRAIN_PAIRS[1]
    tb = batch_to_device(train_batch(rng, cfg16, n_pairs, num_gt), cuda)
    arch = cfg16.backbone_arch
    blocks, mutual = 2 * arch[1] + arch[2], 4 * arch[1]
    counts = {}
    for remat in (False, True):
        state16.model.config = dataclasses.replace(cfg16, remat=remat,
                                                   remat_policy="dots")
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        with dense_band_calls(ba) as dense, backward_shapes(ba) as shapes:
            train_step(state16, tb, step_generator(0, state16.step))
            torch.cuda.synchronize()
        counts[remat] = band_counts(ba, fa)
        # the K2/K3 bf16 shape this step launches is the one timed alone
        if shapes != {BWD_BF16_SHAPES[-1]}:
            raise AssertionError(f"K2/K3 bf16 launched at (B, H, d, w, T) "
                                 f"{shapes}, timed at {BWD_BF16_SHAPES[-1]}")
        times = 2 if remat else 1
        got = {**counts[remat], "dense band form": dense[0]}
        expect = {name: 0 for name in got}
        expect.update(band_attention_pe_bf16=times * blocks,
                      band_attention_bf16=times * mutual,
                      band_attention_dq_bf16=mutual,
                      band_attention_dkv_bf16=mutual,
                      **{"dense band form": blocks})
        # the predictor's dense attention: once a layer's self and cross
        # attention; the recompute under remat may stop before the last
        full = 2 * cfg16.predictor.num_layers
        print(f"vidor_local + use_rel_pe bf16 train step at {n_pairs} pairs"
              f"{' with remat (dots)' if remat else ''}: kernel launches and "
              f"dense band calls {got}, dense full-attention calls "
              f"{fa.dense_calls}")
        if got != expect or not (remat or fa.dense_calls == full):
            raise AssertionError(f"launches {got}, expected {expect}")
    state16.model.config = cfg16

    for _ in range(2):
        train_step(state16, tb, step_generator(0, state16.step))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(5):
            _, losses = train_step(state16, tb,
                                   step_generator(0, state16.step))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / 5)
    if not all(torch.isfinite(v) for v in losses.values()):
        raise AssertionError("non-finite bf16 rel-PE losses")
    print(f"vidor_local + use_rel_pe bf16 train step {n_pairs} pairs "
          f"T={cfg16.max_seq_len}: {ms[0]:.2f} / {ms[1]:.2f} ms per step, "
          f"{1e3 * n_pairs / ms[0]:.1f} / {1e3 * n_pairs / ms[1]:.1f} "
          f"pairs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _, _, events = profile_device(
        lambda: train_step(state16, tb, step_generator(0, state16.step)), 2,
        "step")
    refuse_fma_band(events, "2 bf16 rel-PE train steps")
    return counts[False]


def profile_device(fn, runs: int, unit: str) -> tuple[float, float, list]:
    """Where the time of ``fn`` goes: ``torch.profiler`` over ``runs``
    calls, device time summed over the kernels against the host clock, and
    the ten kernels with the most device time, each per call (a ``unit``).
    Returns (device busy ms, wall ms, the kernels' events), a call each."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / runs
    kernels = device_events(prof)
    busy = sum(dev_us(e) for e in kernels) / 1e3 / runs
    launches = sum(e.count for e in kernels) / runs
    print(f"  profile over {runs} {unit}(s): wall {1e3 * wall:.2f} ms a "
          f"{unit} (profiler on), device busy {busy:.2f} ms "
          f"({100 * busy / (1e3 * wall):.1f}%), {launches:.0f} kernels a "
          f"{unit}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"    {dev_us(e) / 1e3 / runs:9.3f} ms  {e.count // runs:6d}x"
              f"  {e.key[:90]}")
    return busy, 1e3 * wall, kernels


def write_cli_corpus(root: str, raw, model_over: dict | None = None) -> str:
    """A tiny synthetic VidVRD corpus (four train videos, two test videos)
    under ``root`` and the config of ``raw`` pointed at it, with
    ``model_over`` set in its model_config, batches of 2 items of 2 pairs
    and one epoch. Returns the config's path."""
    import yaml
    from tests.synth_corpus import make_vidvrd_corpus, make_vidvrd_test_corpus
    vis = raw["model_config"]["visual_dim"]
    dirs = make_vidvrd_corpus(root, n_videos=4, n_frames=40, seed=0,
                              vis_dim=vis)
    dirs.update(make_vidvrd_test_corpus(root, n_videos=2, seed=1,
                                        vis_dim=vis))
    cfg = json.loads(json.dumps(raw))
    cfg["dataset_config"].update(
        ann_dir=dirs["ann_dir"], info_dir=dirs["info_dir"],
        gt_boxfeatures_dir=dirs["gt_boxfeatures_dir"],
        test_boxfeatures_dir=dirs["test_boxfeatures_dir"],
        cache_dir=os.path.join(root, "cache"))
    cfg["model_config"].update(model_over or {})
    cfg["training_dataset_config"]["num_pairs"] = 2
    cfg["training_config"].update(batch_size=2, training_epoch=1,
                                  total_epoch=2, warmup_epochs=1,
                                  log_interval=1, eval_start_epoch=1)
    cfg["prepare_gt_config"]["gt_relations_path"] = os.path.join(
        root, "gts.json")
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path


def check_train_cli(raw, model_over: dict, flags: tuple) -> None:
    """train_torch.py for one epoch of a tiny synthetic corpus on the card,
    with ``model_over`` set in the config's model_config and ``flags``
    added: exit 0 and a checkpoint written."""
    with tempfile.TemporaryDirectory() as root:
        cfg_path = write_cli_corpus(root, raw, model_over)
        exp = os.path.join(root, "exp")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "train_torch.py"), "--data_name",
             "vidvrd", "--cfg_path", cfg_path, "--exp_dir", exp, "--device",
             "cuda", *flags], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"train_torch.py failed:\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        print(f"{' '.join(['train_torch.py', *flags])} on cuda with "
              f"{model_over}: exit 0 in {time.perf_counter() - t0:.1f} s")
        if not os.path.exists(os.path.join(exp, "model_last.ckpt")):
            raise AssertionError("train_torch.py wrote no checkpoint")


METRIC_NAMES = ("RelDet_mAP", "RelDet_AR@50", "RelDet_AR@100",
                "RelTag_AP@1", "RelTag_AP@5", "RelTag_AP@10")


def re_metric(text: str):
    for name, value in re.findall(
            rf"({'|'.join(METRIC_NAMES)}): ([0-9.eE+-]+|nan)", text):
        yield name, float(value)


# -- phase 13: data parallelism on the card -------------------------------
DP_PAIRS = 24   # configs/vidvrd.yaml's global batch: 6 items of 4 pairs
DP_RANKS = 2    # ranks sharing the one card (12 pairs a rank)
DP_STEPS = 3


def dp_setup(cfg, raw, device):
    """Phase 13a's train state and global batches, alike in every process:
    weights from seed 0 with drop-path scales near 1 (as
    ``check_train_step`` sets them, so that every branch moves the loss),
    and DP_STEPS batches of DP_PAIRS pairs from seed 13."""
    from vrdone_tpu_torch.models.layers import AffineDropPath
    from vrdone_tpu_torch.train.loop import create_train_state
    gen = torch.Generator().manual_seed(0)
    state, _ = create_train_state(cfg, raw["training_config"], 100,
                                  device=device, generator=gen)
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, AffineDropPath):
                m.scale.copy_(torch.empty_like(m.scale, device="cpu")
                              .uniform_(0.5, 1.5, generator=gen))
    state.ema_params = [p.detach().clone() for p in state.params()]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    rng = np.random.default_rng(13)
    return state, [train_batch(rng, cfg, DP_PAIRS, num_gt)
                   for _ in range(DP_STEPS)]


def dp_train_steps(state, batches, rows: slice, device, ba, fa) -> dict:
    """DP_STEPS train steps on ``rows`` of each global batch (drop path as
    configured, the draws of ``step_generator(0, step)``): the losses, each
    step's time and the launches of the last step."""
    from vrdone_tpu_torch.train.loop import (batch_to_device, step_generator,
                                             train_step)
    out = {"losses": [], "ms": []}
    with dense_band_calls(ba) as dense:
        for step, batch in enumerate(batches):
            tb = batch_to_device({k: v[rows] for k, v in batch.items()},
                                 device)
            torch.cuda.synchronize()
            zero_counts(ba, fa)
            dense[0] = 0
            t0 = time.perf_counter()
            _, losses = train_step(state, tb, step_generator(0, step))
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["launches"] = {**band_counts(ba, fa),
                               "dense band form": dense[0],
                               "dense full attention": fa.dense_calls}
            out["losses"].append({k: v.item() for k, v in losses.items()})
    return out


def dp_rank_main(out_dir: str) -> None:
    """One rank of phase 13a, started by ``check_data_parallel`` with
    torchrun's environment: a gloo group over CUDA tensors on card 0
    (NCCL refuses two ranks on one card), DP_STEPS full-width steps on
    this rank's rows; writes its losses, times, launches and parameters
    to ``out_dir/rank<r>.pt``."""
    from vrdone_tpu_torch.config import (load_yaml_config,
                                         model_config_from_yaml)
    from vrdone_tpu_torch.ops import band_attention as ba
    from vrdone_tpu_torch.ops import full_attention as fa
    from vrdone_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = mesh.init_distributed("cuda:0", backend="gloo")
    try:
        raw = load_yaml_config(str(ROOT / "configs" / "vidvrd.yaml"))
        cfg = model_config_from_yaml(raw)
        state, batches = dp_setup(cfg, raw, device)
        out = dp_train_steps(state, batches, mesh.local_batch_slice(DP_PAIRS),
                             device, ba, fa)
        out.update(rank=rank, world=world, params=[
            p.detach().cpu() for p in state.params()])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        mesh.shutdown()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_dp_train_step(cfg, raw, cuda, ba, fa) -> dict:
    """Phase 13a: DP_RANKS ranks on the one card over gloo, each
    DP_STEPS full-width steps on its rows of DP_PAIRS pairs, against one
    process's steps on the whole batches: losses within LOSS_TOL, the ranks'
    parameters equal, the largest parameter gap to one process printed, the
    launches of a rank's step (K1 with its lse, K2 and K3 once a band
    layer, as one process's step at half the batch) and both step times.
    Returns the launches of rank 0's last step."""
    with tempfile.TemporaryDirectory() as out_dir:
        env = dict(os.environ, WORLD_SIZE=str(DP_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.dp_rank_main({out_dir!r})"],
            cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_RANKS)]
        try:
            state, batches = dp_setup(cfg, raw, cuda)
            one = dp_train_steps(state, batches, slice(None), cuda, ba, fa)
            one_params = [p.detach().cpu() for p in state.params()]
            del state
        finally:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"data-parallel rank {r} failed:\n"
                                     f"{log[-3000:]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=True) for r in range(DP_RANKS)]
    for step in range(DP_STEPS):
        ref = one["losses"][step]
        errs = {k: abs(ranks[0]["losses"][step][k] - v) / (1 + abs(v))
                for k, v in ref.items()}
        worst = max(errs, key=errs.get)
        print(f"data-parallel step {step}, {DP_RANKS} ranks x "
              f"{DP_PAIRS // DP_RANKS} pairs vs one process x {DP_PAIRS}: "
              f"total_loss {ranks[0]['losses'][step]['total_loss']:.6f} vs "
              f"{ref['total_loss']:.6f}; worst loss term {worst} rel err "
              f"{errs[worst]:.3e}")
        if errs[worst] > LOSS_TOL:
            raise AssertionError(f"data-parallel step {step}: {worst} off "
                                 f"by {errs[worst]}")
    for r in range(1, DP_RANKS):
        if ranks[r]["losses"] != ranks[0]["losses"] or not all(
                torch.equal(a, b) for a, b in zip(ranks[r]["params"],
                                                  ranks[0]["params"])):
            raise AssertionError(f"rank {r}'s step differs from rank 0's")
    gap = max((a - b).abs().max().item()
              for a, b in zip(ranks[0]["params"], one_params))
    print(f"data-parallel parameters after {DP_STEPS} steps: ranks equal bit "
          f"for bit; largest gap to one process {gap:.3e}")
    ms = {"one process": one["ms"], **{f"rank {r}": ranks[r]["ms"]
                                       for r in range(DP_RANKS)}}
    print("data-parallel step times (ms, gloo on one card, TF32 off): "
          + "; ".join(f"{k} " + ", ".join(f"{t:.2f}" for t in v)
                      for k, v in ms.items()))
    blocks = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    expect = {name: 0 for name in one["launches"]}
    expect.update(band_attention=blocks, band_attention_dq=blocks,
                  band_attention_dkv=blocks,
                  **{"dense full attention": 4 * cfg.backbone_arch[1]
                     + 2 * cfg.predictor.num_layers})
    for r, got in enumerate(rank["launches"] for rank in ranks):
        print(f"data-parallel step, rank {r} at {DP_PAIRS // DP_RANKS} pairs: "
              f"kernel launches {got}")
        if got != expect:
            raise AssertionError(f"rank {r} launches {got}, expected "
                                 f"{expect}")
    return {k: v for k, v in ranks[0]["launches"].items()
            if not k.startswith("dense")}


def check_dp_cli(raw) -> None:
    """Phases 13b and 13c: train_torch.py under ``torchrun --standalone
    --nproc_per_node 1`` (NCCL, world size 1) for one epoch of a tiny
    synthetic corpus, then eval_torch.py --multihost on its checkpoint
    with two ranks sharing the card (``--device cuda:0``; the merge runs on
    the gloo group) beside one process's eval_torch.py: exit codes 0, a
    checkpoint written, the merged predictions equal one process's."""
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    with tempfile.TemporaryDirectory() as root:
        cfg_path = write_cli_corpus(root, raw)
        exp = os.path.join(root, "exp")
        common = ["--data_name", "vidvrd", "--cfg_path", cfg_path]
        ckpt = os.path.join(exp, "model_last.ckpt")

        def launch(args):
            return subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        def finish(name, proc, t0):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{name} failed:\n{out[-3000:]}\n"
                                     f"{err[-3000:]}")
            print(f"{name}: exit 0 in {time.perf_counter() - t0:.1f} s")
            return out

        t0 = time.perf_counter()
        out = finish("torchrun --nproc_per_node 1 train_torch.py (NCCL)",
                     launch([*torchrun, "--nproc_per_node", "1",
                             str(ROOT / "train_torch.py"), *common,
                             "--exp_dir", exp, "--device", "cuda",
                             "--multihost", "--n_dp", "1"]), t0)
        if "data-parallel ranks: 1" not in out or not os.path.exists(ckpt):
            raise AssertionError("train_torch.py under torchrun wrote no "
                                 "checkpoint")
        evals = {"dp": [*torchrun, "--nproc_per_node", "2",
                        str(ROOT / "eval_torch.py"), "--multihost",
                        "--device", "cuda:0"],
                 "one": [sys.executable, str(ROOT / "eval_torch.py"),
                         "--device", "cuda"]}
        t0 = time.perf_counter()
        procs = {k: launch([*v, *common, "--exp_dir",
                            os.path.join(root, f"eval_{k}"), "--ckpt_path",
                            ckpt, "--topk", "3", "--save_result"])
                 for k, v in evals.items()}
        outs = {k: finish(f"eval_torch.py ({k})", p, t0)
                for k, p in procs.items()}
        preds = {}
        for k in evals:
            with open(os.path.join(root, f"eval_{k}", "predicted_relations"
                                   "_topk3_epoch3.json")) as f:
                preds[k] = json.load(f)
        metrics = {k: dict(re_metric(v)) for k, v in outs.items()}
    if preds["dp"] != preds["one"] or metrics["dp"] != metrics["one"]:
        raise AssertionError("two ranks' merged predictions differ from one "
                             "process's")
    n = sum(len(v) for v in preds["one"].values())
    print(f"eval_torch.py --multihost, 2 ranks on one card: merged "
          f"predictions of {len(preds['one'])} videos ({n} relations) and "
          f"metrics equal one process's: {metrics['one']}")


# -- phase 17: sequence and tensor parallelism on the card -------------------
SP_PAIRS = 48   # configs/vidor_local.yaml's global batch: 3 items of 16 pairs
TP_PAIRS = 24   # configs/vidvrd.yaml's: 6 items of 4
PAR_RANKS = 2   # ranks sharing the one card: dp 1 x sp 2, then dp 1 x tp 2
PAR_STEPS = 3


def par_setup(name: str, device, pairs: int, layout=None, tp=False):
    """Phase 17's train state and global batches for ``configs/<name>``,
    alike in every process: ``dp_setup``'s weights (seed 0, drop-path
    scales near 1; the scales are never sharded) in ``layout``, this
    rank's shards of them with ``tp``, and PAR_STEPS batches of ``pairs``
    pairs from seed 17; and the config."""
    from vrdone_tpu_torch.config import (load_yaml_config,
                                         model_config_from_yaml)
    from vrdone_tpu_torch.models.layers import AffineDropPath
    from vrdone_tpu_torch.train.loop import create_train_state
    raw = load_yaml_config(str(ROOT / "configs" / name))
    cfg = model_config_from_yaml(raw)
    gen = torch.Generator().manual_seed(0)
    state, _ = create_train_state(cfg, raw["training_config"], 100,
                                  device=device, generator=gen,
                                  layout=layout, tp=tp)
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, AffineDropPath):
                m.scale.copy_(torch.empty_like(m.scale, device="cpu")
                              .uniform_(0.5, 1.5, generator=gen))
    state.ema_params = [p.detach().clone() for p in state.params()]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    rng = np.random.default_rng(17)
    return state, cfg, [train_batch(rng, cfg, pairs, num_gt)
                        for _ in range(PAR_STEPS)]


@contextlib.contextmanager
def band_lengths(ba):
    """Records the T of each K1 (with or without its lse), K2 and K3 call
    made through the band wrappers while open."""
    seen, saved = [], {}
    for name in ("band_attention_cuda", "band_attention_dq_cuda",
                 "band_attention_dkv_cuda"):
        saved[name] = fn = getattr(ba, name)

        def recorded(q, *args, _fn=fn, _name=name, **kw):
            seen.append((_name, q.shape[1], kw.get("with_lse", False)))
            return _fn(q, *args, **kw)

        setattr(ba, name, recorded)
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ba, name, fn)


def par_train_steps(state, batches, cut, device, ba, fa) -> dict:
    """PAR_STEPS train steps on ``cut(batch)`` of each global batch (drop
    path as configured, the draws of ``step_generator(0, step)``): the
    losses, each step's time, the peak memory, the launches of the last
    step with the T of each band call, and the parameter and optimizer
    bytes; and the step-0 gradients (the first moments after step 0, tp
    shards gathered whole)."""
    from vrdone_tpu_torch.train.checkpoint import state_payload
    from vrdone_tpu_torch.train.loop import (batch_to_device, step_generator,
                                             train_step)
    out = {"losses": [], "ms": []}
    torch.cuda.reset_peak_memory_stats(device)
    with dense_band_calls(ba) as dense, band_lengths(ba) as lengths:
        for step, batch in enumerate(batches):
            tb = batch_to_device(cut(batch), device)
            torch.cuda.synchronize()
            zero_counts(ba, fa)
            dense[0] = 0
            lengths.clear()
            t0 = time.perf_counter()
            _, losses = train_step(state, tb, step_generator(0, step))
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["losses"].append({k: v.item() for k, v in losses.items()})
            if step == 0:
                out["first_grads"] = state_payload(
                    state, epoch=0, batch_size=0)["opt_state"]["moments"][
                        "mu"]
        out["launches"] = {**band_counts(ba, fa), "dense band form": dense[0],
                           "dense full attention": fa.dense_calls}
        out["band_lengths"] = sorted(set(lengths))
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    out["param_mib"] = sum(p.numel() * p.element_size()
                           for p in state.params()) / 2 ** 20
    out["opt_mib"] = sum(t.numel() * t.element_size() for ts in
                         state.optimizer.moments.values()
                         for t in ts) / 2 ** 20
    # the most the steps move a leaf whose gradient is float noise (an Adam
    # update of arbitrary sign, at most lr a step) on each of two sides
    out["noise_bound"] = 2 * sum(state.optimizer.schedule(t)
                                 for t in range(len(batches)))
    return out


def par_rank_main(out_dir: str) -> None:
    """One rank of phase 17, started by ``check_sequence_tensor_parallel``
    with torchrun's environment: a gloo group over CUDA tensors on card 0
    (NCCL refuses two ranks on one card); 17a, dp 1 x sp 2 on
    ``configs/vidor_local.yaml``: PAR_STEPS steps on this rank's time
    columns of SP_PAIRS pairs; 17b, dp 1 x tp 2 on ``configs/vidvrd.yaml``
    (``tp_min_size`` at its default): PAR_STEPS steps on TP_PAIRS pairs
    with this rank's shards. Writes the losses, times, memory, launches and
    the whole (gathered) parameters to ``out_dir/rank<r>.pt``."""
    from vrdone_tpu_torch.ops import band_attention as ba
    from vrdone_tpu_torch.ops import full_attention as fa
    from vrdone_tpu_torch.parallel import mesh
    from vrdone_tpu_torch.train.checkpoint import state_payload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = mesh.init_distributed("cuda:0", backend="gloo")
    try:
        out = {"rank": rank, "world": world}
        for key, name, pairs, sizes in (("sp", "vidor_local.yaml", SP_PAIRS,
                                         (1, 1, PAR_RANKS)),
                                        ("tp", "vidvrd.yaml", TP_PAIRS,
                                         (1, PAR_RANKS, 1))):
            layout = mesh.make_layout(*sizes)
            state, _, batches = par_setup(name, device, pairs, layout,
                                          tp=key == "tp")
            res = par_train_steps(
                state, batches, lambda b: mesh.time_slice(b, layout), device,
                ba, fa)
            whole = state_payload(state, epoch=0, batch_size=0)
            res.update(params=whole["params"], tp_dims=state.tp_dims,
                       coords=(layout.dp, layout.tp, layout.sp))
            out[key] = res
            del state
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        mesh.shutdown()


def check_sequence_tensor_parallel(cuda, ba, fa) -> dict:
    """Phase 17: PAR_RANKS ranks on the one card over gloo
    (``par_rank_main``) against one process's steps on the whole batches:
    17a sp (``configs/vidor_local.yaml``, T = 512, window 9, ``use_local``,
    256 columns a rank) and 17b tp (``configs/vidvrd.yaml`` at width 512,
    the large kernels' output features split). Losses within LOSS_TOL,
    each rank's step-0 gradients (tp shards gathered) within STEP_GRAD_TOL
    of one process's (the warmup's small learning rate leaves the later
    losses and the parameters blind to a wrong gradient), the ranks'
    parameters equal bit for bit, the largest parameter gap to one process
    within the most three Adam steps move a leaf, step times, peak
    memory, the parameter and optimizer memory; under sp each rank's K1
    (with its lse), K2 and K3 once a band layer at T_local + 2w and no
    dense band form, under tp the sharded leaves and elements. Returns the
    launches of sp rank 0's last step."""
    with tempfile.TemporaryDirectory() as out_dir:
        env = dict(os.environ, WORLD_SIZE=str(PAR_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.par_rank_main({out_dir!r})"],
            cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PAR_RANKS)]
        one, cfgs = {}, {}
        try:
            for key, name, pairs in (("sp", "vidor_local.yaml", SP_PAIRS),
                                     ("tp", "vidvrd.yaml", TP_PAIRS)):
                state, cfgs[key], batches = par_setup(name, cuda, pairs)
                one[key] = par_train_steps(state, batches, lambda b: b, cuda,
                                           ba, fa)
                one[key]["params"] = {n: p.detach().cpu() for n, p in
                                      state.model.named_parameters()}
                del state
                torch.cuda.empty_cache()
        finally:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 17 rank {r} failed:\n"
                                     f"{log[-3000:]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=True) for r in range(PAR_RANKS)]
    for key, label in (("sp", f"sequence-parallel (dp 1 x sp {PAR_RANKS}, "
                        f"vidor_local.yaml, {SP_PAIRS} pairs x "
                        f"{cfgs['sp'].max_seq_len})"),
                       ("tp", f"tensor-parallel (dp 1 x tp {PAR_RANKS}, "
                        f"vidvrd.yaml, {TP_PAIRS} pairs x "
                        f"{cfgs['tp'].max_seq_len})")):
        ref, got = one[key], [rank[key] for rank in ranks]
        for step in range(PAR_STEPS):
            errs = {k: abs(got[0]["losses"][step][k] - v) / (1 + abs(v))
                    for k, v in ref["losses"][step].items()}
            worst = max(errs, key=errs.get)
            print(f"{label} step {step}: total_loss "
                  f"{got[0]['losses'][step]['total_loss']:.6f} vs one process "
                  f"{ref['losses'][step]['total_loss']:.6f}; worst loss term "
                  f"{worst} rel err {errs[worst]:.3e}")
            if errs[worst] > LOSS_TOL:
                raise AssertionError(f"{label} step {step}: {worst} off by "
                                     f"{errs[worst]}")
        for r in range(1, PAR_RANKS):
            if got[r]["losses"] != got[0]["losses"] or not all(
                    torch.equal(v, got[0]["params"][n])
                    for n, v in got[r]["params"].items()):
                raise AssertionError(f"{label}: rank {r}'s step differs from "
                                     f"rank 0's")
        for r in range(PAR_RANKS):
            check_step0_gradients(
                f"{label} rank {r}: step 0 gradients vs one process",
                list(ref["params"]), got[r]["first_grads"],
                ref["first_grads"])
        gap = max((got[0]["params"][n] - v).abs().max().item()
                  for n, v in ref["params"].items())
        bound = ref["noise_bound"]
        print(f"{label}: parameters after {PAR_STEPS} steps: ranks equal bit "
              f"for bit; largest gap to one process {gap:.3e} (bound "
              f"{bound:.3e})")
        if not gap <= bound:
            raise AssertionError(f"{label}: parameters {gap} from one "
                                 f"process's")
        print(f"{label} step times (ms, gloo on one card, TF32 off): "
              + "; ".join(f"{who} " + ", ".join(f"{t:.2f}" for t in ms)
                          for who, ms in [("one process", ref["ms"])] + [
                              (f"rank {r}", g["ms"])
                              for r, g in enumerate(got)]))
        print(f"{label} peak memory (GiB): one process "
              f"{ref['peak_gib']:.2f}; " + "; ".join(
                  f"rank {r} {g['peak_gib']:.2f}" for r, g in enumerate(got))
              + f"; parameters (MiB) {ref['param_mib']:.1f} vs rank "
              + ", ".join(f"{g['param_mib']:.1f}" for g in got)
              + f"; optimizer moments (MiB) {ref['opt_mib']:.1f} vs rank "
              + ", ".join(f"{g['opt_mib']:.1f}" for g in got))
    sp_cfg = cfgs["sp"]
    w = sp_cfg.n_mha_win_size // 2
    t_ext = sp_cfg.max_seq_len // PAR_RANKS + 2 * w
    blocks = (2 * sp_cfg.backbone_arch[1] + sp_cfg.backbone_arch[2]
              + 4 * sp_cfg.backbone_arch[1])   # stems, branches, S/O layers
    for r, g in enumerate(rank["sp"] for rank in ranks):
        launches = g["launches"]
        expect = {name: 0 for name in launches}
        expect.update(band_attention=blocks, band_attention_dq=blocks,
                      band_attention_dkv=blocks,
                      **{"dense full attention":
                         2 * sp_cfg.predictor.num_layers})
        print(f"sequence-parallel step, rank {r} at "
              f"{sp_cfg.max_seq_len // PAR_RANKS} frames: kernel launches "
              f"{launches}; band calls (wrapper, T, lse) {g['band_lengths']}")
        if launches != expect:
            raise AssertionError(f"sp rank {r} launches {launches}, expected "
                                 f"{expect}")
        top = {(n, t, lse) for n, t, lse in g["band_lengths"]
               if t == t_ext}
        if ("band_attention_cuda", t_ext, True) not in top or not {
                "band_attention_dq_cuda", "band_attention_dkv_cuda"} <= {
                n for n, _, _ in top}:
            raise AssertionError(f"sp rank {r}: no K1 with lse, K2 and K3 "
                                 f"at T_local + 2w = {t_ext}")
        print(f"sequence-parallel rank {r}: the halo rows are "
              f"{2 * w} of {t_ext} query rows at the full-resolution levels "
              f"({100 * 2 * w / t_ext:.1f}%)")
    for r, g in enumerate(rank["tp"] for rank in ranks):
        elements = sum(one["tp"]["params"][n].numel() for n in g["tp_dims"])
        print(f"tensor-parallel rank {r}: {len(g['tp_dims'])} sharded leaves "
              f"of {len(one['tp']['params'])}, {elements} of "
              f"{sum(v.numel() for v in one['tp']['params'].values())} "
              f"elements split over {PAR_RANKS}")
        if not g["tp_dims"]:
            raise AssertionError("tensor parallelism sharded no leaf")
    return {k: v for k, v in ranks[0]["sp"]["launches"].items()
            if not k.startswith("dense")}


@contextlib.contextmanager
def flash_inputs(fa, seen: dict):
    """While open, keep the inputs of the first K8 launch of each shape
    (q, k, v, key mask, lse, Dr, dO: what K7, K8 and K9 take) in ``seen``,
    keyed by (B, H, d, Tq, Tk)."""
    dq_cuda = fa.full_attention_dq_cuda

    def record(*args, n_head):
        q, k = args[:2]
        key = (q.shape[0], n_head, q.shape[2] // n_head, q.shape[1],
               k.shape[1])
        if key not in seen:
            seen[key] = tuple(a.detach().clone() for a in args)
        return dq_cuda(*args, n_head=n_head)

    fa.full_attention_dq_cuda = record
    try:
        yield seen
    finally:
        fa.full_attention_dq_cuda = dq_cuda


def check_step_inputs(fa, seen: dict, label: str) -> None:
    """K7 with its lse, K8 and K9 on the inputs a train step gave them, one
    shape at a time, against their plain versions (``hold_full_backward``;
    the lse the step saved must equal K7's again); the shapes must be
    ``FLASH_SHAPES``, at which ``check_full_backward`` times each kernel
    alone."""
    if set(seen) != set(FLASH_SHAPES):
        raise AssertionError(f"{label}: K8 launched at (B, H, d, Tq, Tk) "
                             f"{sorted(seen)}, timed at {FLASH_SHAPES}")
    for (b, h, d, tq, tk), args in sorted(seen.items()):
        hold_full_backward(fa, f"{label} step's own inputs, B*H={b}*{h} "
                           f"Tq={tq} Tk={tk} d={d}", *args, h)


def flash_against_dense(cfg, tc, cuda, tb, ba, fa, mops, label: str,
                        loss_tol: float, grad_tol: float) -> dict:
    """One step of ``cfg`` on the card's batch ``tb`` with the opt-in on
    and off, from copies of one fresh state (lr 0 at step 0, so the first
    moments are 0.1 g), the dense step replaying the flash step's max-pool
    picks: losses within ``loss_tol`` of 1 + |loss|, step-0 gradients
    within ``grad_tol`` by norm; the launches of both (flash: K7 with its
    lse once a full attention, more under remat, whose recompute runs it
    again, K8 and K9 once, no dense form; dense: no K7, K8 or K9); then
    both timed in turns (dense, flash, flash, dense) with their peak
    memory. Returns the flash step's launches; leaves FLASH_TRAIN on."""
    from vrdone_tpu_torch.train.loop import create_train_state, train_step
    from vrdone_tpu_torch.train.loop import step_generator
    base, _ = create_train_state(cfg, tc, 100, device=cuda,
                                 generator=torch.Generator().manual_seed(0))
    states = {mode: copy.deepcopy(base) for mode in ("flash", "dense")}
    del base
    full = 4 * cfg.backbone_arch[1] + 2 * cfg.predictor.num_layers
    blocks = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    bf16 = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    times = 2 if cfg.remat else 1
    max_pool1d, pool = mops.max_pool1d, PoolReplay()
    losses, grads, counts = {}, {}, {}
    for mode in ("flash", "dense"):
        mops.FLASH_TRAIN = mode == "flash"
        pool.replay = mode == "dense"
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        mops.max_pool1d = pool
        try:
            _, losses[mode] = train_step(states[mode], tb,
                                         step_generator(0, 0))
            torch.cuda.synchronize()
        finally:
            mops.max_pool1d = max_pool1d
        counts[mode] = {**band_counts(ba, fa), "K7 with lse": fa.lse_launches,
                        "dense full attention": fa.dense_calls}
        grads[mode] = [m.detach().clone()
                       for m in states[mode].optimizer.moments["mu"]]
        print(f"vidor {label} {mode} train step at {FLASH_PAIRS[1]} pairs: "
              f"kernel launches {counts[mode]}")
    mops.FLASH_TRAIN = True
    for mode, got in counts.items():
        k7, dense = got[f"masked_attention{bf16}"], got["dense full attention"]
        expect = {name: 0 for name in got}
        expect.update({f"band_attention{bf16}": times * blocks,
                       f"band_attention_dq{bf16}": blocks,
                       f"band_attention_dkv{bf16}": blocks})
        if mode == "flash":
            expect.update({f"masked_attention{bf16}": k7, "K7 with lse": k7,
                           f"masked_attention_dq{bf16}": full,
                           f"masked_attention_dkv{bf16}": full})
        else:
            expect["dense full attention"] = dense
        # the recompute under remat may stop before the last full attention
        if got != expect or not full <= (k7 if mode == "flash" else dense) \
                <= times * full:
            raise AssertionError(f"{label} {mode} launches {got}, expected "
                                 f"{expect} with {full}..{times * full} full "
                                 "attentions")
    errs = {k: abs(losses["flash"][k].item() - v.item()) / (1 + abs(v.item()))
            for k, v in losses["dense"].items()}
    worst = max(errs, key=errs.get)
    print(f"vidor {label} flash vs dense on the card at {FLASH_PAIRS[1]} "
          f"pairs: total_loss dense {losses['dense']['total_loss'].item():.6f}"
          f" flash {losses['flash']['total_loss'].item():.6f}; worst loss "
          f"term {worst} rel err {errs[worst]:.3e} (limit {loss_tol}); "
          f"max-pool picks replayed that differ {pool.flips} of "
          f"{pool.windows}")
    if errs[worst] > loss_tol:
        raise AssertionError(f"{label} flash vs dense: {worst} off by "
                             f"{errs[worst]}")
    names = [n for n, _ in states["dense"].model.named_parameters()]
    check_step0_gradients(f"vidor {label} step 0 gradients, flash vs dense "
                          "on the card", names, grads["flash"],
                          grads["dense"], grad_tol)
    del grads
    ms, peak = {"dense": [], "flash": []}, {}
    iters = 3
    for mode in ("dense", "flash", "flash", "dense"):
        mops.FLASH_TRAIN = mode == "flash"
        st = states[mode]
        if not ms[mode]:   # its first timed turn: one step to warm up
            train_step(st, tb, step_generator(0, st.step))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            _, step_losses = train_step(st, tb, step_generator(0, st.step))
        torch.cuda.synchronize()
        ms[mode].append(1e3 * (time.perf_counter() - t0) / iters)
        peak[mode] = max(peak.get(mode, 0.0),
                         torch.cuda.max_memory_allocated() / 2**30)
        if not all(torch.isfinite(v) for v in step_losses.values()):
            raise AssertionError(f"non-finite {label} {mode} losses")
    mops.FLASH_TRAIN = True
    for mode in ("dense", "flash"):
        print(f"vidor train step {FLASH_PAIRS[1]} pairs T=512 {label} "
              f"{mode}: {ms[mode][0]:.2f} / {ms[mode][1]:.2f} ms per step, "
              f"{1e3 * FLASH_PAIRS[1] / ms[mode][0]:.1f} / "
              f"{1e3 * FLASH_PAIRS[1] / ms[mode][1]:.1f} pairs/s, peak "
              f"memory {peak[mode]:.2f} GiB")
    del states
    torch.cuda.empty_cache()
    return counts["flash"]


def check_flash_train(cuda, ba, fa) -> dict:
    """Phase 18, flash training (``VRDONE_FLASH_TRAIN=1``, set here through
    ``ops.masked.FLASH_TRAIN``) at ``configs/vidor.yaml``'s full width
    (T = 512, 8 heads, ``use_local`` off: the S/O cross-attentions at d =
    64 and the predictor's at d = 32 are full attentions; random seeded
    weights): 18a three fp32 steps at 4 pairs on the card and the CPU
    (``check_train_step``: losses, step-0 gradients, drift) and the
    launches of a step at 48 pairs (K7 with its lse, K8 and K9 16 each, no
    dense form), the kernels held on that step's own inputs; 18b three bf16
    steps under remat at 4 pairs against the port's bf16 CPU steps
    (``BF16_LOSS_TOL``, step-0 gradients within ``BF16_STEP_GRAD_TOL``), the
    kernels on a 48-pair step's inputs; 18c the card's flash step against
    its dense step at 48 pairs, fp32 and bf16 under remat (losses, step-0
    gradients, launches, step times and peak memory in turns). Returns the
    flash steps' launches by path."""
    from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
    from vrdone_tpu_torch.ops import masked as mops
    from vrdone_tpu_torch.train.loop import (batch_to_device, step_generator,
                                             train_step)
    raw = load_yaml_config(str(ROOT / "configs" / "vidor.yaml"))
    cfg = model_config_from_yaml(raw)
    tc = raw["training_config"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16", remat=True,
                                remat_policy="dots")
    rng = np.random.default_rng(12)
    launches = {}
    mops.FLASH_TRAIN = True
    try:
        # 18a
        seen = {}
        with flash_inputs(fa, seen):
            state32, launches["train_step_flash"] = check_train_step(
                cfg, raw, cuda, ba, fa, pairs=FLASH_PAIRS,
                label="vidor flash ", flash=True)
        del state32
        check_step_inputs(fa, {k: v for k, v in seen.items()
                               if k[0] == FLASH_PAIRS[1]}, "vidor flash fp32")
        del seen
        # 18b
        grads = {}
        states = bf16_steps_vs_cpu(
            cfg16, tc, cuda, train_batch(rng, cfg, FLASH_PAIRS[0], num_gt),
            "vidor flash (remat)", grads=grads)
        names = [n for n, _ in states["cpu"].model.named_parameters()]
        check_step0_gradients("vidor flash bf16 (remat) step 0 gradients "
                              "CUDA vs CPU", names, grads["cuda"],
                              grads["cpu"], BF16_STEP_GRAD_TOL)
        state16 = states["cuda"]
        del states, grads
        tb = batch_to_device(train_batch(rng, cfg, FLASH_PAIRS[1], num_gt),
                             cuda)
        seen = {}
        with flash_inputs(fa, seen):
            train_step(state16, tb, step_generator(0, state16.step))
        del state16
        check_step_inputs(fa, seen, "vidor flash bf16 (remat)")
        del seen
        # 18c
        flash_against_dense(cfg, tc, cuda, tb, ba, fa, mops, "fp32",
                            LOSS_TOL, STEP_GRAD_TOL)
        launches["train_step_flash_bf16"] = flash_against_dense(
            cfg16, tc, cuda, tb, ba, fa, mops, "bf16 remat", BF16_LOSS_TOL,
            BF16_STEP_GRAD_TOL)
    finally:
        mops.FLASH_TRAIN = False
    torch.cuda.empty_cache()
    return launches


def synthetic_video(rng, lengths, feat_dim):
    n = len(lengths)
    durations, boxes = [], []
    for t in lengths:
        for _ in range(2):
            durations.append([0, int(t)])
            boxes.append(rng.uniform(0, 100, (t, 4)).astype(np.float32))
    return {
        "sids": np.arange(0, 2 * n, 2), "oids": np.arange(1, 2 * n, 2),
        "cat_ids": rng.integers(1, 36, 2 * n),
        "cat_scores": rng.uniform(0.1, 1.0, 2 * n).astype(np.float32),
        "traj_durations": np.asarray(durations),
        "bboxes_list": boxes,
        "so_features_list": [rng.standard_normal((t, feat_dim))
                             .astype(np.float32) for t in lengths],
        "so_offset": np.zeros(n, np.int64),
    }


def mega_case(rng, g, n, m, dg, dgo, p_valid, device):
    """Fused-attention operands as the detector makes them: boxes on the
    canvas, Wg as initialised (normal(0.01))."""
    def boxes(k):
        xy = rng.uniform(0, 1, (k, 2)) * (CANVAS[1], CANVAS[0])
        return np.concatenate([xy, xy + rng.uniform(8, 300, (k, 2))],
                              1).astype(np.float32)

    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((g, n, dg), (g, m, dg), (g, m, dgo))]
    arrays += [0.1 * rng.standard_normal((g, m)).astype(np.float32),
               rng.uniform(size=m) < p_valid, boxes(n), boxes(m),
               rng.normal(0, 0.01, (64, g)).astype(np.float32),
               rng.normal(0, 0.01, (g,)).astype(np.float32)]
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


# the fused set-attention's shapes in a full-width detect_video frame
DETECT_SHAPES = ("local stage 0", "local stage 1", "local stage 2",
                 "global, key rows", "global, window rows")


@contextlib.contextmanager
def cached_bias_operands(ma, extra):
    """Within it, the fused set-attention wrapper's ``bias_operands`` (the
    dozens of small torch kernels of ``pe_setup``) returns one result built
    beforehand from the rois and Wg in ``extra``, so that a call's work on
    the card is the kernel's alone."""
    real = ma.bias_operands
    if extra:
        ops = real(*extra, 64, 1000.0)
        ma.bias_operands = lambda *args: ops
    try:
        yield
    finally:
        ma.bias_operands = real


# the position bias's shapes on the fused_attention=False route: a frame's
# three local stages (the key rows over the memory and window, then over
# the window twice)
LOCAL_SHAPES = ((675, 3750), (675, 750), (300, 750))


def bias_launches(pb, ops, out, w):
    """Launches of the position-bias kernel (K6) alone and of the
    bias_factors kernel alone (from Wg ``w``, into ``ops``' factors) on the
    operands ``ops`` of ``bias_operands``, no wrapper and no count: (K6,
    factors)."""
    lib = pb._kernel()
    q, k, a, b_t, wt, b, freqs = ops
    g, n, m = out.shape

    def k6():
        lib.position_bias_forward(
            q.data_ptr(), k.data_ptr(), a.data_ptr(), b_t.data_ptr(),
            wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, g, freqs,
            torch.cuda.current_stream().cuda_stream)

    def factors():
        lib.bias_factors_forward(
            q.data_ptr(), k.data_ptr(), w.data_ptr(), w.stride(0),
            w.stride(1), a.data_ptr(), b_t.data_ptr(), wt.data_ptr(), n, m,
            g, freqs, torch.cuda.current_stream().cuda_stream)

    return k6, factors


def check_position_bias(cuda, pb) -> dict:
    """The position-bias kernel (K6) and the bias_factors kernel at each
    local stage's shape: K6 against its plain version (gate space, and log
    space above -8), bias_factors against the torch pe_setup (1e-5 of
    1 + max |A| on A, 1e-5 on Bt, wt exact); each kernel alone (queued
    behind a device sleep, on operands built once), K6's wrapper, the plain
    versions, the bounds. Returns both kernels' JSON entries (K6's first
    shape is stage 0's)."""
    rng = np.random.default_rng(7)
    g = 16
    rows, frows = [], []
    for n, m in LOCAL_SHAPES:
        *_, qr, kr, w, b = mega_case(rng, g, n, m, 1, 1, 1.0, cuda)
        got, want = pb.position_bias_cuda(qr, kr, w, b), \
            pb.position_bias_plain(qr, kr, w, b)
        gate_err = (got.exp() - want.exp()).abs()
        if not (gate_err <= BIAS_ATOL + BIAS_RTOL * want.exp()).all():
            raise AssertionError(f"position bias {n}x{m} off in gate space "
                                 f"by {gate_err.max().item()}")
        log_err = {th: (got - want)[want > th].abs().max().item()
                   for th in (-10, -8)}
        if not log_err[-8] <= 3e-2 + 1e-3 * 8:
            raise AssertionError(f"position bias {n}x{m} off in log space: "
                                 f"{log_err}")
        p1, k1, k2, p2 = (time_ms(f) for f in (
            lambda: pb.position_bias_plain(qr, kr, w, b),
            lambda: pb.position_bias_cuda(qr, kr, w, b),
            lambda: pb.position_bias_cuda(qr, kr, w, b),
            lambda: pb.position_bias_plain(qr, kr, w, b)))
        ops = pb.bias_operands(qr, kr, w, b, 64, 1000.0)
        k6, factors = bias_launches(pb, ops, got, w)
        alone = [queued_device_ms(k6) for _ in range(2)]
        # bytes: the rois, Wg and b in, the bias out; operations: the
        # 64-deep contraction as the kernel runs it, three fp16 MMAs a
        # product (hi.hi, hi.lo, lo.hi)
        bms, by = bound_ms(4 * (4 * n + 4 * m + 65 * g + g * n * m),
                           3 * 2 * 64 * g * n * m, PEAK_FP16_MMA)
        shape = f"G=16 N={n} M={m}"
        rows.append(dict(shape=shape, device_ms=sum(alone) / 2,
                         ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                         bound_ms=bms, bound_by=by,
                         max_abs_err=gate_err.max().item()))
        print(f"position_bias {shape}: gate-space max_abs_err "
              f"{gate_err.max().item():.3e}; log-space max err above -10 "
              f"{log_err[-10]:.3e}, above -8 {log_err[-8]:.3e}; the kernel "
              f"alone {alone[0]:.4f} / {alone[1]:.4f} ms, wrapper "
              f"{(k1 + k2) / 2:.4f} ms ({(k1 + k2) / sum(alone):.2f}x the "
              f"kernel alone), plain {(p1 + p2) / 2:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
        del got, want, gate_err
        ref = pb.pe_setup(qr, kr, w)
        a_err = (ops[2] - ref[1]).abs().max().item()
        bt_err = (ops[3] - ref[2]).abs().max().item()
        if not (a_err <= 1e-5 * (1 + ref[1].abs().max().item())
                and bt_err <= 1e-5 and torch.equal(ops[4], ref[3])):
            raise AssertionError(f"bias_factors {n}x{m}: A off by {a_err}, "
                                 f"Bt by {bt_err}")
        f_alone = [queued_device_ms(factors) for _ in range(2)]
        fp1, fk1, fk2, fp2 = (time_ms(f) for f in (
            lambda: pb.pe_setup(qr, kr, w),
            lambda: pb.bias_operands(qr, kr, w, b, 64, 1000.0),
            lambda: pb.bias_operands(qr, kr, w, b, 64, 1000.0),
            lambda: pb.pe_setup(qr, kr, w)))
        # bytes: the rois and Wg in, A, Bt and wt out; operations: the fold,
        # 3 a factor and group
        fbms, fby = bound_ms(4 * (4 * (n + m) + 64 * g + 32 * g * n + 32 * m
                                  + 32 * g), 3 * 32 * g * n)
        frows.append(dict(shape=shape, device_ms=sum(f_alone) / 2,
                          ms=(fk1 + fk2) / 2, plain_ms=(fp1 + fp2) / 2,
                          bound_ms=fbms,
                          bound_by=fby, max_abs_err=max(a_err, bt_err)))
        print(f"bias_factors {shape}: A max_abs_err {a_err:.3e}, Bt "
              f"{bt_err:.3e}; the kernel alone {f_alone[0]:.4f} / "
              f"{f_alone[1]:.4f} ms, wrapper (bias_operands) "
              f"{(fk1 + fk2) / 2:.4f} ms, plain (pe_setup) "
              f"{(fp1 + fp2) / 2:.4f} ms, bound {fbms:.4f} ms ({fby})")
    return {name: dict(r[0], max_abs_err=max(e["max_abs_err"] for e in r),
                       library_ms=None, by_shape=r)
            for name, r in (("position_bias", rows), ("bias_factors", frows))}


def check_mega_kernels(cuda, pb, ma) -> dict:
    """The position-bias kernels (``check_position_bias``), and the fused
    set-attention kernel (K5) at every shape of a full-width frame, bias on
    and off, at ragged shapes and with all keys invalid, against their
    plain versions. Returns the kernels' JSON entries."""
    entries = check_position_bias(cuda, pb)
    rng = np.random.default_rng(7)
    g, dg = 16, 64

    worst = 0.0
    for label, gg, n, m, dgq, dgo, p_valid, bias in (
            ("local stage 0", g, 675, 3750, dg, dg, 0.9, True),
            ("local stage 1", g, 675, 750, dg, dg, 0.9, True),
            ("local stage 2", g, 300, 750, dg, dg, 0.9, True),
            ("global, key rows", g, 300, 750, dg, dg, 0.9, False),
            ("global, window rows", g, 1875, 750, dg, dg, 0.9, False),
            ("ragged", 5, 13, 77, 30, 40, 0.5, True),
            ("small detector", 4, 10, 12, 256, 256, 0.7, True),
            ("all keys invalid", g, 33, 101, dg, dg, 0.0, True),
            ("all keys invalid", g, 33, 101, dg, dg, 0.0, False)):
        q, k, vp, ub, valid, *extra = mega_case(rng, gg, n, m, dgq, dgo,
                                                p_valid, cuda)
        extra = extra if bias else []
        out = ma.mega_attention_cuda(q, k, vp, ub, valid, *extra)
        ref = ma.mega_attention_plain(q, k, vp, ub, valid, *extra)
        err = (out - ref).abs().max().item()
        if not (torch.isfinite(out).all()
                and err <= MEGA_TOL * (1 + ref.abs().max().item())):
            raise AssertionError(f"mega attention off by {err} ({label})")
        if p_valid == 0.0 and not (out == 0).all():
            raise AssertionError("a row with no valid key is not 0")
        worst = max(worst, err)
        p1, k1, k2, p2 = (time_ms(f) for f in (
            lambda: ma.mega_attention_plain(q, k, vp, ub, valid, *extra),
            lambda: ma.mega_attention_cuda(q, k, vp, ub, valid, *extra),
            lambda: ma.mega_attention_cuda(q, k, vp, ub, valid, *extra),
            lambda: ma.mega_attention_plain(q, k, vp, ub, valid, *extra)))
        print(f"mega_attention {label} G={gg} N={n} M={m} dg={dgq} "
              f"dgo={dgo} bias={bias}: max_abs_err {err:.3e}, wrapper "
              f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms")
        if label not in DETECT_SHAPES:
            continue
        # the detector's shapes: the kernel alone (a call's split kernel
        # and merge, with the bias operands built once outside), the
        # library's one call (SDPA with g heads and the bias, u-term and
        # validity as one additive mask built outside the timing), the bound
        with cached_bias_operands(ma, extra):
            alone = [queued_device_ms(lambda: ma.mega_attention_cuda(
                q, k, vp, ub, valid, *extra)) for _ in range(2)]
        with torch.no_grad():
            lib_mask = (pb.position_bias_plain(*extra) if bias else 0.0) \
                + ub[:, None, :].expand(gg, n, m)
            lib_mask = lib_mask.masked_fill(~valid[None, None, :],
                                            float("-inf"))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], vp[None], attn_mask=lib_mask[None],
            scale=1.0 / math.sqrt(dgq)))
        pairs = n * int(valid.sum())
        bms, by = bound_ms(
            4 * (q.numel() + k.numel() + vp.numel() + ub.numel()
                 + n * gg * dgo + (4 * (n + m) + 65 * gg if bias else 0))
            + m, 2 * gg * pairs * (dgq + dgo)
            + (2 * 64 * gg * pairs if bias else 0))
        splits = ma.launch_plan(cuda.index, n, m, gg, dgq, dgo)[1]
        print(f"mega_attention {label}: the kernel alone {alone[0]:.4f} / "
              f"{alone[1]:.4f} ms, wrapper {(k1 + k2) / 2:.4f} ms "
              f"({(k1 + k2) / sum(alone):.2f}x the kernel alone), "
              f"library (SDPA, mask precomputed) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}); {splits} key "
              f"splits, scratch "
              f"{4 * splits * gg * n * (dgo + 2) / 1e6 if splits > 1 else 0:.2f}"
              f" MB")
        del lib_mask
        if label == "local stage 0":
            entries["mega_attention"] = dict(
                ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, device_ms=sum(alone) / 2,
                shape="G=16 N=675 M=3750 dg=64")
    entries["mega_attention"]["max_abs_err"] = worst
    entries["mega_attention_bf16"] = check_mega_bf16(cuda, pb, ma)
    return entries


# the fused set-attention's five shapes in a full-width detect_video frame
MEGA_DETECT_CASES = (("local stage 0", 675, 3750),
                     ("local stage 1", 675, 750),
                     ("local stage 2", 300, 750),
                     ("global, key rows", 300, 750),
                     ("global, window rows", 1875, 750))


def check_mega_bf16(cuda, pb, ma) -> dict:
    """K5's bf16 instance against its bf16 plain version at the detector's
    five shapes, each with and without the bias, within BF16_KERNEL_TOL;
    each timed alone beside the fp32 instance alone, the wrapper, the plain
    version, SDPA in bf16 (the bias, u-term and validity as one bf16
    additive mask built outside the timing) and the bound: the largest of
    the products at the dense bf16 rate, the bias's fp32 work at the fp32
    rate and the bytes (bf16 q, k, vproj and output; fp32 ub, rois and
    Wg) at the memory rate. Prints each instance: the tensor-core kernel's
    rows, groups a block, channel bucket and key splits, the fp32 FMA
    kernel's rows and splits, and nvcc's registers and spills of every
    instance. Returns the JSON entry
    ``mega_attention_bf16`` (stage 0 with the bias; all ten in
    ``by_shape``)."""
    from vrdone_tpu_torch.ops import _build
    bf = torch.bfloat16
    usage = [ln for ln in ptxas_usage(_build.BUILD_LOG.get(
        "mega_attention", (0.0, ""))[1]) if "mega_attention" in ln]
    print("mega_attention instances, nvcc (-Xptxas -v): "
          + ("; ".join(usage) or "not compiled in this process"))
    rng = np.random.default_rng(11)
    g, dg = 16, 64
    rows = []
    for label, n, m in MEGA_DETECT_CASES:
        q, k, vp, ub, valid, *extra = mega_case(rng, g, n, m, dg, dg, 0.9,
                                                cuda)
        q16, k16, vp16 = (x.to(bf) for x in (q, k, vp))
        plan16 = ma.launch_plan(cuda.index, n, m, g, dg, dg, True)
        plan32 = ma.launch_plan(cuda.index, n, m, g, dg, dg)
        bucket, groups = ma.mma_instance(g, dg, dg)
        for bias in (True, False):
            ex = extra if bias else []

            def kernel():
                return ma.mega_attention_cuda(q16, k16, vp16, ub, valid, *ex)

            def plain():
                return ma.mega_attention_plain(q16, k16, vp16, ub, valid, *ex)

            out, ref = kernel(), plain()
            if not out.dtype == ref.dtype == bf:
                raise AssertionError(f"mega_attention_bf16 {label}: "
                                     f"{out.dtype} output, plain {ref.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            limit = BF16_KERNEL_TOL * (1 + ref.float().abs().max().item())
            if not (torch.isfinite(out.float()).all() and err <= limit):
                raise AssertionError(f"mega_attention_bf16 off by {err} "
                                     f"({label}, bias={bias})")
            p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel,
                                                   plain))
            with cached_bias_operands(ma, ex):
                alone = queued_device_ms(kernel)
                alone32 = queued_device_ms(lambda: ma.mega_attention_cuda(
                    q, k, vp, ub, valid, *ex))
            with torch.no_grad():
                lib_mask = (pb.position_bias_plain(*ex) if bias else 0.0) \
                    + ub[:, None, :].expand(g, n, m)
                lib_mask = lib_mask.masked_fill(
                    ~valid[None, None, :], float("-inf")).to(bf)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q16[None], k16[None], vp16[None], attn_mask=lib_mask[None],
                scale=1.0 / math.sqrt(dg)))
            del lib_mask
            pairs = n * int(valid.sum())
            n_bytes = (2 * (q.numel() + k.numel() + vp.numel() + n * g * dg)
                       + 4 * ub.numel() + m
                       + (4 * (4 * (n + m) + 65 * g) if bias else 0))
            # the products and the bias's fp32 work run on other pipes,
            # so the least time takes the slower of the two
            t_bytes = n_bytes / PEAK_BYTES
            t_ops = max(2 * g * pairs * 2 * dg / PEAK_BF16_MMA,
                        2 * 64 * g * pairs / PEAK_FLOPS if bias else 0.0)
            bms = 1e3 * max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            shape = (f"{label} G={g} N={n} M={m} dg=dgo={dg} "
                     f"{'with' if bias else 'no'} bias")
            # each block of the tensor-core kernel copies the valid keys'
            # k and vproj rows of its groups from L2 (its splits together
            # cover all keys): the traffic it moves again and again
            kv_l2 = (-(-n // plan16[0]) * g * int(valid.sum()) * 2
                     * (dg + dg))
            print(f"mega_attention_bf16 {shape} (instance "
                  f"mega_attention_mma_kernel<{bucket}, {groups}>: "
                  f"{plan16[0]} rows a block, {groups} groups a block "
                  f"({-(-g // groups)} along grid.z), channel bucket "
                  f"{bucket}, {plan16[1]} key splits; fp32 "
                  f"{plan32[0]} rows, {plan32[1]} splits): max_abs_err "
                  f"{err:.3e} (limit "
                  f"{limit:.3e}), the kernel alone {alone:.4f} ms (fp32 "
                  f"instance alone {alone32:.4f} ms), wrapper "
                  f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms, "
                  f"library (SDPA, bf16, mask precomputed) {lib_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}); k and vproj copied from L2 "
                  f"{kv_l2 / 1e6:.1f} MB, {kv_l2 / alone / 1e9:.2f} TB/s "
                  f"over the kernel alone")
            rows.append(dict(shape=shape, max_abs_err=err, ms=(k1 + k2) / 2,
                             device_ms=alone, fp32_device_ms=alone32,
                             plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                             bound_ms=bms, bound_by=by))
    return {**rows[0], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "by_shape": rows}


def zero_mega_counts(ma, pb) -> None:
    ma.launches = ma.bf16_launches = 0
    pb.launches = pb.factor_launches = 0


def mega_counts(ma, pb) -> dict:
    """The MEGA kernels' launches since the counts were last set to 0 (the
    fp32 name counts fp32 instances only)."""
    return {"mega_attention": ma.launches - ma.bf16_launches,
            "mega_attention_bf16": ma.bf16_launches,
            "position_bias": pb.launches, "bias_factors": pb.factor_launches}


def full_width_detector(cuda):
    """MEGA's defaults (R-101-C4, 300 key / 75 reference proposals, window
    25, global 10) with random weights drawn on the CPU from a seed, on the
    card."""
    from vrdone_tpu_torch.models.detector import MegaDetector
    return MegaDetector(num_classes=31, device=torch.device("cpu"),
                        generator=torch.Generator().manual_seed(0)).to(cuda)


def check_detect_video(cuda, pb, ma, det) -> dict:
    """detect_video at full width on the card (``det``, from
    ``full_width_detector``): the launches of one video
    through each attention route and in bf16 (the fused route, K5's bf16
    instance only), phase times (fp32 and bf16 in turns), memory, the
    stream phase's kernels a frame, the busy share of a whole video, and
    the memory property. Returns the launches by route (the fp32 names
    count fp32 instances only)."""
    from vrdone_tpu_torch.models import detector
    from vrdone_tpu_torch.models.detector import detect_video
    rng = np.random.default_rng(8)
    t = DETECT_FRAMES
    images = rng.integers(0, 256, (t, *CANVAS, 3), dtype=np.uint8)
    hw = np.asarray(CANVAS, np.float32)
    routes = {"detect_video": {},
              "detect_video_pe_bias": dict(fused_attention=False),
              "detect_video_bf16": dict(compute_dtype="bfloat16")}
    launches, outs, streams = {}, {}, {}
    real_stream = detector.stream_video
    for route, kw in routes.items():
        def capture(*args, route=route, **kwargs):
            streams[route] = (args, kwargs)
            return real_stream(*args, **kwargs)

        torch.cuda.synchronize()
        zero_mega_counts(ma, pb)
        detector.stream_video = capture
        try:
            outs[route] = detect_video(det, images, hw, **kw)
        finally:
            detector.stream_video = real_stream
        torch.cuda.synchronize()
        launches[route] = mega_counts(ma, pb)
        print(f"{route}: {t} frames, kernel launches {launches[route]}")
        for key, v in outs[route].items():
            if not np.isfinite(v).all():
                raise AssertionError(f"{route}: non-finite {key}")
    # one factor launch before each biased K5 or K6 call: 3 local stages a
    # frame on either route and in either dtype
    expect = {"detect_video": {"mega_attention": 6 * t,
                               "mega_attention_bf16": 0, "position_bias": 0,
                               "bias_factors": 3 * t},
              "detect_video_pe_bias": {"mega_attention": 0,
                                       "mega_attention_bf16": 0,
                                       "position_bias": 3 * t,
                                       "bias_factors": 3 * t},
              "detect_video_bf16": {"mega_attention": 0,
                                    "mega_attention_bf16": 6 * t,
                                    "position_bias": 0,
                                    "bias_factors": 3 * t}}
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    out = outs["detect_video"]
    scale = np.abs(out["visual"]).max()
    apart = np.abs(out["visual"] - outs["detect_video_pe_bias"]["visual"])
    print(f"detect_video outputs: proposals {out['proposals'].shape}, "
          f"{int(out['valid'].sum())} valid; visual {out['visual'].shape}, "
          f"max |visual| {scale:.3e}; cls_logits {out['cls_logits'].shape}; "
          f"the two routes' visual differ by at most "
          f"{apart.max() / scale:.3e} of max |visual|, by more than 1e-3 of "
          f"it in {(apart > 1e-3 * scale).mean():.2%} of the values (random "
          f"weights saturate MEGA's softmax, so near-ties may flip between "
          f"routes; reported, not a check)")
    out16 = outs["detect_video_bf16"]
    for key in ("visual", "cls_logits"):
        if out16[key].dtype != np.float32:
            raise AssertionError(f"bf16 detect_video: {key} is "
                                 f"{out16[key].dtype}")
    same = sum(np.array_equal(out16["proposals"][f], out["proposals"][f])
               for f in range(t))
    print(f"detect_video_bf16 outputs: visual {out16['visual'].shape} fp32, "
          f"max |visual| {np.abs(out16['visual']).max():.3e}; frames whose "
          f"proposals equal fp32's: {same} of {t}; visual differs from "
          f"fp32's by at most "
          f"{np.abs(out16['visual'] - out['visual']).max() / scale:.3e} of "
          f"max |visual| (reported, not a check: bf16 moves the RPN's "
          f"near-ties and MEGA's saturated softmax)")

    # each route's phases, twice (fp32 and bf16 in turns), and its stream
    # phase alone under the profiler: kernels and device time a frame
    order = ("detect_video", "detect_video_bf16", "detect_video_bf16",
             "detect_video", "detect_video_pe_bias", "detect_video_pe_bias")
    for route in order:
        kw = routes[route]
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        detect_video(det, images, hw, timings=timings, **kw)
        wall = time.perf_counter() - t0
        print(f"{route} {t} frames {CANVAS[0]}x{CANVAS[1]} "
              f"{kw.get('compute_dtype', 'float32')}: "
              + ", ".join(f"{k} {1e3 * v / t:.2f} ms/frame"
                          for k, v in timings.items())
              + f"; {t / wall:.2f} frames/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for route in routes:
        args, kwargs = streams[route]
        with torch.no_grad():
            busy, wall, kernels = profile_device(
                lambda: real_stream(*args, **kwargs), 1,
                "video's stream phase")
        print(f"{route} stream phase: {sum(e.count for e in kernels) / t:.1f}"
              f" kernels and {busy / t:.3f} ms of device time a frame, wall "
              f"{wall / t:.2f} ms a frame (profiler on)")

    for route in ("detect_video", "detect_video_bf16"):
        _, _, kernels = profile_device(
            lambda: detect_video(det, images, hw, **routes[route]), 1,
            "video")
        k5 = [e for e in kernels if "mega_attention" in e.key]
        print(f"{route}: the fused set-attention's kernels "
              f"{sum(dev_us(e) for e in k5) / 1e3:.3f} ms of device time a "
              f"video, " + ", ".join(f"{e.count} x {e.key[:70]}" for e in k5))
        # bf16 streams take the tensor-core kernel only: the FMA kernel
        # (fp32's) in the bf16 video's profile is a fault (the profiler may
        # miss launches, so the counts above are what show the launches)
        fma = [e.key for e in k5 if "mega_attention_kernel<" in e.key]
        if route == "detect_video_bf16" and fma:
            raise AssertionError(f"bf16 detect_video ran the FMA kernel: "
                                 f"{fma}")

    # the memory property: a change to frame 0 moves frame 3's logits
    images2 = images.copy()
    images2[0] = rng.integers(0, 256, images[0].shape, dtype=np.uint8)
    moved = np.abs(detect_video(det, images2, hw)["cls_logits"][3]
                   - out["cls_logits"][3]).max()
    print(f"frame 0 changed: frame 3's logits move by {moved:.3e}")
    if not moved > 1e-6:
        raise AssertionError("later frames ignore earlier ones")
    torch.cuda.empty_cache()
    return launches


def small_detector_case(cuda):
    """The small detector (R (1, 1, 1), the full MEGA head) of phases 7 and
    12, from one seed on the CPU and copied to the card, and its 5 frames
    of 128 x 192: (knobs, CPU detector, card detector, frames, hw, key
    proposals a frame)."""
    from vrdone_tpu_torch.models.detector import MegaDetector
    kw = dict(num_classes=31, resnet_layers=(1, 1, 1), base_num=16,
              window=5, key_loc=2, global_size=3)
    cpu_det = MegaDetector(**kw, device=torch.device("cpu"),
                           generator=torch.Generator().manual_seed(1))
    gpu_det = MegaDetector(**kw, device=cuda)
    gpu_det.load_state_dict(cpu_det.state_dict())
    rng = np.random.default_rng(9)
    t, hw, nk = 5, (128, 192), 24
    images = rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8)
    return kw, cpu_det, gpu_det, images, hw, nk


def check_detect_vs_cpu(cuda) -> None:
    """A small detector (R (1, 1, 1), the full MEGA head) on the card
    against the same weights on the CPU: the RPN outputs, proposal
    selection on identical inputs, RoIAlign -> C5 -> fc0 and the MEGA
    stream on identical rois and fc0 inputs, then the whole path with its
    proposal flips counted."""
    from vrdone_tpu_torch.models import rpn as rpn_lib
    from vrdone_tpu_torch.models.detector import detect_video, precompute_chunk
    from vrdone_tpu_torch.models.mega import global_indices, stream_video
    kw, cpu_det, gpu_det, images, hw, nk = small_detector_case(cuda)
    t = len(images)

    def worst(a, b):
        a, b = a.detach().cpu(), b.detach().cpu()
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    devs = {"cpu": (torch.device("cpu"), cpu_det), "cuda": (cuda, gpu_det)}
    with torch.no_grad():
        c4 = {k: det.features(torch.from_numpy(images).to(d))
              for k, (d, det) in devs.items()}
        rpn = {k: det.rpn(c4[k]) for k, (_, det) in devs.items()}
        errs = {"c4": worst(c4["cuda"], c4["cpu"]),
                "rpn logits": worst(rpn["cuda"][0], rpn["cpu"][0]),
                "rpn deltas": worst(rpn["cuda"][1], rpn["cpu"][1])}
        # proposal selection on identical inputs: the card's RPN outputs
        hp, wp, a = rpn["cuda"][0].shape[1:]
        anchors = torch.from_numpy(rpn_lib.make_anchors(hp, wp))
        for f in range(t):
            logits = rpn["cuda"][0][f].reshape(-1).cpu()
            deltas = rpn["cuda"][1][f].reshape(-1, 4).cpu()
            sel = [rpn_lib.select_proposals(
                anchors.to(d), logits.to(d), deltas.to(d), hw,
                post_nms_top_n=nk) for d in (torch.device("cpu"), cuda)]
            if not (torch.equal(sel[0][2], sel[1][2].cpu())
                    and torch.allclose(sel[0][0], sel[1][0].cpu(),
                                       atol=1e-3, rtol=0)):
                raise AssertionError(f"select_proposals keeps differ on "
                                     f"identical inputs (frame {f})")
        # RoIAlign -> C5 -> fc0 and the stream on identical inputs: the
        # card's proposals and fc0 features
        pre = precompute_chunk(gpu_det, torch.from_numpy(images).to(cuda),
                               hw, key_post_nms=nk)
        kb, kv, _, kf, rb, rv, rf = pre
        fc0_cpu = torch.stack([cpu_det.frame_fc0(c4["cpu"][f], kb[f].cpu(),
                                                 kv[f].cpu())
                               for f in range(t)])
        errs["fc0"] = worst(kf, fc0_cpu)
        sched = dict(mem_size=kw["window"], window=kw["window"],
                     key_loc=kw["key_loc"],
                     glob_idx=global_indices(t, kw["global_size"]))
        streams = {}
        for name, (dev, det) in devs.items():
            x = [v.to(dev) for v in (kf, kb, kv, rf, rb, rv)]
            streams[name] = stream_video(
                det.mega.routed(True, True), key_feat=x[0], key_rois=x[1],
                key_valid=x[2], key_is_fc0=True, ref_feat=x[3],
                ref_rois=x[4], ref_valid=x[5], **sched)
        errs["stream (K5 vs plain)"] = worst(streams["cuda"], streams["cpu"])
    print("small detector, CUDA vs CPU on identical inputs, max |err| / "
          "max |x|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; select_proposals keeps identical")
    bad = {k: v for k, v in errs.items() if not v <= DETECT_TOL}
    if bad:
        raise AssertionError(f"small detector off: {bad}")

    hwa = np.asarray(hw, np.float32)
    out = {"cuda": detect_video(gpu_det, images, hwa, key_post_nms=nk),
           "cpu": detect_video(cpu_det, images, hwa, key_post_nms=nk)}
    flips = sum(int(not (np.array_equal(out["cuda"]["valid"][f],
                                        out["cpu"]["valid"][f])
                         and np.allclose(out["cuda"]["proposals"][f],
                                         out["cpu"]["proposals"][f],
                                         atol=1e-3, rtol=0)))
                for f in range(t))
    print(f"small detector, whole path CUDA vs CPU: frames whose proposals "
          f"differ (RPN near-ties): {flips} of {t}")
    if flips:
        print("  NOTE: a proposal flip feeds every later frame through the "
              "window and memory; the whole-path outputs are not compared")
        return
    whole = {k: worst(torch.from_numpy(out["cuda"][k]),
                      torch.from_numpy(out["cpu"][k]))
             for k in ("visual", "cls_logits", "bbox_deltas")}
    print("  whole path max |err| / max |x|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in whole.items()))
    if not all(v <= DETECT_TOL for v in whole.values()):
        raise AssertionError(f"whole detection path off: {whole}")


def check_detect_bf16_vs_cpu(cuda, pb, ma) -> None:
    """The small detector in bf16 on the card against the port's bf16 run on
    the CPU, stage by stage where no NMS decision is in the loop (as JAX's
    bf16 tests pin it): C4 and the fc0 of fixed rois, the MEGA stream on
    fixed fc0 inputs through the fused route (K5's bf16 instance; the plain
    version on the CPU) and the dense route (K6, fp32), and
    extract_video_features. Limits BF16_DETECT_MAX and BF16_DETECT_MEAN of
    max |ref|, but extract_video_features's largest gap is held to the
    larger of BF16_DETECT_MAX and twice the CPU's own bf16-to-fp32 gap
    there: the MEGA scan over these random weights turns any rounding into
    near-ties, and a card whose bf16 is as close to fp32 as the CPU's is
    lies within twice that of the CPU's bf16. Every gap is printed before
    any is held."""
    from vrdone_tpu_torch.models.detector import extract_video_features
    from vrdone_tpu_torch.models.mega import global_indices, stream_video
    from vrdone_tpu_torch.utils.precision import cast_floating
    kw, cpu32, gpu32, *_ = small_detector_case(cuda)
    devs = {"cpu": (torch.device("cpu"), cast_floating(cpu32)),
            "cuda": (cuda, cast_floating(gpu32))}
    rng = np.random.default_rng(13)
    t, hw, nb = 5, (128, 192), 16
    bf = torch.bfloat16
    images = rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8)

    def boxes(*shape):
        xy = rng.uniform(0, 1, (*shape, 2)) * (hw[1] * 0.7, hw[0] * 0.7)
        return np.concatenate([xy, xy + rng.uniform(8, 60, (*shape, 2))],
                              -1).astype(np.float32)

    rois, rvalid = boxes(t, nb), rng.uniform(size=(t, nb)) < 0.8
    gaps = {}

    def held(name, got, ref, max_tol=BF16_DETECT_MAX):
        got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
        scale = ref.abs().max().item()
        gaps[name] = ((got - ref).abs().max().item() / scale,
                      (got - ref).abs().mean().item() / scale, max_tol)

    with torch.no_grad():
        c4, fc0 = {}, {}
        for name, (dev, det) in devs.items():
            c4[name] = det.features(torch.from_numpy(images).to(dev), bf)
            fc0[name] = torch.stack([det.frame_fc0(
                c4[name][f], torch.from_numpy(rois[f]).to(dev),
                torch.from_numpy(rvalid[f]).to(dev)) for f in range(t)])
            if not c4[name].dtype == fc0[name].dtype == bf:
                raise AssertionError(f"{name}: c4 {c4[name].dtype}, fc0 "
                                     f"{fc0[name].dtype}")
        held("c4", c4["cuda"], c4["cpu"])
        held("fc0 of fixed rois", fc0["cuda"], fc0["cpu"])
        # the stream on fixed fc0 inputs: the fp32 head cast inside
        nk = 24
        feats = [rng.standard_normal(sh).astype(np.float32)
                 for sh in ((t, nk, 1024), (t, nb, 1024))]
        stream_in = feats + [boxes(t, nk), np.ones((t, nk), bool),
                             rois, rvalid]
        sched = dict(mem_size=kw["window"], window=kw["window"],
                     key_loc=kw["key_loc"],
                     glob_idx=global_indices(t, kw["global_size"]),
                     compute_dtype="bfloat16")
        for route, flags, expect in (
                ("fused", (False, True), (6 * t, 6 * t, 0)),
                ("dense with K6", (True, False), (0, 0, 3 * t))):
            got = {}
            for name, (dev, _) in devs.items():
                kf, rf, kb, kv, rb, rv = (torch.from_numpy(a).to(dev)
                                          for a in stream_in)
                det = cpu32 if name == "cpu" else gpu32
                ma.launches = ma.bf16_launches = pb.launches = 0
                got[name] = stream_video(
                    det.mega.routed(*flags), key_feat=kf, key_rois=kb,
                    key_valid=kv, key_is_fc0=True, ref_feat=rf,
                    ref_rois=rb, ref_valid=rv, **sched)
                if name == "cuda":
                    torch.cuda.synchronize()
                    seen = (ma.launches, ma.bf16_launches, pb.launches)
                    if seen != expect:
                        raise AssertionError(f"bf16 stream, {route} route: "
                                             f"launches (K5, K5 bf16, K6) "
                                             f"{seen}, expected {expect}")
            if got["cuda"].dtype != torch.float32:
                raise AssertionError(f"bf16 stream returns "
                                     f"{got['cuda'].dtype}")
            held(f"stream, {route} route", got["cuda"], got["cpu"])
    ext = {name: extract_video_features(det, images, rois, rvalid,
                                        compute_dtype="bfloat16")
           for name, det in (("cpu", cpu32), ("cuda", gpu32))}
    ext32 = extract_video_features(cpu32, images, rois, rvalid)
    scale = np.abs(ext32).max()
    own = float(np.abs(ext["cpu"] - ext32).max() / scale)
    card = float(np.abs(ext["cuda"] - ext32).max() / scale)
    held("extract_video_features", torch.from_numpy(ext["cuda"]),
         torch.from_numpy(ext["cpu"]), max(BF16_DETECT_MAX, 2 * own))
    print("small detector in bf16, card vs the port's bf16 CPU run, largest "
          "/ mean gap of max |ref| (limits): "
          + "; ".join(f"{k} {w:.3e} / {m:.3e} ({lim:.3e} / "
                      f"{BF16_DETECT_MEAN:.0e})"
                      for k, (w, m, lim) in gaps.items())
          + f"; extract_video_features's largest gap to the CPU's fp32 run: "
          f"the CPU's bf16 {own:.3e}, the card's bf16 {card:.3e}")
    bad = {k: v for k, v in gaps.items()
           if not (v[0] <= v[2] and v[1] <= BF16_DETECT_MEAN)}
    if bad:
        raise AssertionError(f"bf16 small detector off: {bad}")


# -- phase 12: detect_video_tta, and frames to triplets with the port alone --

# 8 frames, not phase 7's 16: at 16 the phase added 126 s to the script on
# an H100, over its two-minute budget
TTA_FRAMES, TTA_SCALES = 8, (0.75,)
# the frames of phase 12's corpus: 576 x 1024 fits detect_torch.py's canvas
CORPUS_FRAMES, CORPUS_HW = 40, (576, 1024)
CORPUS_DRIFT = (2, 1)       # pixels a frame the still image moves, x and y
# the corpus's entities (category, box as shares of the frame) and
# relations (subject, object, predicate, begin, end) by split
CORPUS_OBJECTS = (("dog", (0.10, 0.20, 0.35, 0.60)),
                  ("person", (0.45, 0.15, 0.60, 0.80)),
                  ("car", (0.65, 0.50, 0.95, 0.90)))
CORPUS_RELATIONS = {"train": ((0, 1, "chase", 5, 30), (1, 2, "watch", 10, 35)),
                    "test": ((0, 1, "chase", 3, 33),)}
CORPUS_VIDEOS = {"train": ("synth_0000", "synth_0001"),
                 "test": ("synthtest_0000",)}
CORPUS_TRACKLETS = 20       # detect_torch.py --max_proposal: 380 SO pairs


def tta_views(hw, scales) -> list:
    """detect_video_tta's views in its order: (scale, hflip, view hw)."""
    h, w = hw
    out = [(1.0, False, (h, w)), (1.0, True, (h, w))]
    for s in scales:
        out += [(s, flip, (int(round(h * s)), int(round(w * s))))
                for flip in (False, True)]
    return out


def check_detect_tta(cuda, pb, ma, det) -> dict:
    """detect_video_tta at full width on the card (phase 12a; ``det`` from
    ``full_width_detector``): TTA_FRAMES frames of 608x1088 with
    TTA_SCALES and flips, four views, in fp32 and bf16. Its K5 (or K5 bf16)
    and bias_factors launches must equal the sum of the four views' single
    detect_video launches, measured here, which are 6 and 3 a frame a view
    (no K6 and no other-dtype K5: no dense attention form); every merged
    box lies on the canvas; both dtypes timed in turns. Returns the
    launches by route."""
    from vrdone_tpu_torch.models.detector import (_ViewFrames, detect_video,
                                                  detect_video_tta)
    rng = np.random.default_rng(14)
    t = TTA_FRAMES
    images = rng.integers(0, 256, (t, *CANVAS, 3), dtype=np.uint8)
    hw = np.asarray(CANVAS, np.float32)
    views = tta_views(CANVAS, TTA_SCALES)
    launches = {}
    for dtype, route in (("float32", "detect_video_tta"),
                         ("bfloat16", "detect_video_tta_bf16")):
        single = []
        for s, flip, vhw in views:
            torch.cuda.synchronize()
            zero_mega_counts(ma, pb)
            detect_video(det, _ViewFrames(images, scale=s, hflip=flip),
                         np.asarray(vhw, np.float32), compute_dtype=dtype)
            torch.cuda.synchronize()
            single.append(mega_counts(ma, pb))
        want = {k: sum(c[k] for c in single) for k in single[0]}
        zero_mega_counts(ma, pb)
        res = detect_video_tta(det, images, hw, scales=TTA_SCALES,
                               hflip=True, compute_dtype=dtype)
        torch.cuda.synchronize()
        launches[route] = mega_counts(ma, pb)
        n = len(views)
        k5 = "mega_attention_bf16" if dtype == "bfloat16" else "mega_attention"
        formula = {"mega_attention": 0, "mega_attention_bf16": 0,
                   "position_bias": 0, "bias_factors": 3 * t * n, k5: 6 * t * n}
        print(f"{route}: {t} frames, {n} views "
              f"({', '.join(f'{h}x{w}' + (' flipped' if f else '') for _, f, (h, w) in views)}): "
              f"kernel launches {launches[route]}; the views' single "
              f"detect_video calls {single}")
        if not launches[route] == want == formula:
            raise AssertionError(f"{route}: launches {launches[route]}, the "
                                 f"views' sum {want}, expected {formula}")
        counts = [len(r["boxes"]) for r in res]
        for f, r in enumerate(res):
            b = r["boxes"]
            if not (np.isfinite(b).all() and np.isfinite(r["scores"]).all()
                    and (b >= 0).all() and (b[:, 0::2] <= CANVAS[1] - 1).all()
                    and (b[:, 1::2] <= CANVAS[0] - 1).all()):
                raise AssertionError(f"{route}: frame {f} has a box off the "
                                     f"canvas or a non-finite value")
        if not sum(counts):
            raise AssertionError(f"{route}: no detection in {t} frames")
        print(f"  merged detections a frame {min(counts)}-{max(counts)}, "
              f"{sum(counts)} in all, every box on the "
              f"{CANVAS[0]}x{CANVAS[1]} canvas")
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect_video_tta(det, images, hw, scales=TTA_SCALES, hflip=True,
                         compute_dtype=dtype)
        wall = time.perf_counter() - t0
        print(f"detect_video_tta {t} frames {CANVAS[0]}x{CANVAS[1]} {dtype}, "
              f"{len(views)} views: {wall:.3f} s, {t / wall:.2f} frames/s")
    return launches


def check_detect_tta_vs_cpu(cuda) -> None:
    """Phase 7's small detector (``small_detector_case``) through
    detect_video_tta on the card and on the CPU, with TTA_SCALES and flips:
    on every frame where no view's proposals flipped (RPN near-ties, counted
    and printed), labels and box counts equal, boxes and scores within
    DETECT_TOL of their largest magnitude."""
    from vrdone_tpu_torch.models import detector
    _, cpu_det, gpu_det, images, hw, nk = small_detector_case(cuda)
    t = len(images)
    real = detector.detect_video
    views, res = {}, {}
    for name, det in (("cpu", cpu_det), ("cuda", gpu_det)):
        views[name] = []

        def capture(*args, name=name, **kwargs):
            views[name].append(real(*args, **kwargs))
            return views[name][-1]

        detector.detect_video = capture
        try:
            res[name] = detector.detect_video_tta(
                det, images, np.asarray(hw, np.float32), scales=TTA_SCALES,
                hflip=True, key_post_nms=nk, score_thresh=0.02)
        finally:
            detector.detect_video = real
    flipped = [f for f in range(t)
               if not all(np.array_equal(c["valid"][f], g["valid"][f])
                          and np.allclose(c["proposals"][f],
                                          g["proposals"][f], atol=1e-3,
                                          rtol=0)
                          for c, g in zip(views["cpu"], views["cuda"]))]
    clean = [f for f in range(t) if f not in flipped]
    print(f"small detector, detect_video_tta CUDA vs CPU "
          f"({len(views['cuda'])} views): frames whose proposals differ in "
          f"some view (RPN near-ties): {len(flipped)} of {t} {flipped}")
    for f in clean:
        c, g = res["cpu"][f], res["cuda"][f]
        if not np.array_equal(c["labels"], g["labels"]):
            raise AssertionError(f"small detector TTA: frame {f} labels "
                                 f"{g['labels']} on the card, {c['labels']} "
                                 f"on the CPU")
    errs = {}
    for key in ("boxes", "scores"):
        if not clean:
            break
        ref = np.concatenate([res["cpu"][f][key] for f in clean])
        got = np.concatenate([res["cuda"][f][key] for f in clean])
        errs[key] = float(np.abs(got - ref).max()
                          / max(np.abs(ref).max(), 1e-30))
    n = sum(len(res["cpu"][f]["labels"]) for f in clean)
    print(f"  {len(clean)} frames compared, {n} detections, labels equal; "
          f"max |err| / max |x|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not n or not all(v <= DETECT_TOL for v in errs.values()):
        raise AssertionError(f"small detector TTA off: {errs}, {n} "
                             f"detections compared")


def write_frames_corpus(root: Path) -> None:
    """The VidVRD-layout corpus of raw frames for phase 12b under ``root``:
    CORPUS_VIDEOS' annotation JSONs (the format of tests/synth_corpus.py)
    under annotations/<split>/ and their frames as 000001.jpg onward under
    frames/<split>/<video>/, CORPUS_HW and CORPUS_FRAMES each. A video is
    one still image of blocky noise with CORPUS_OBJECTS painted on it,
    moving CORPUS_DRIFT pixels a frame, so that the detector's boxes link
    into tracklets; every entity is annotated on every frame."""
    from PIL import Image
    rng = np.random.default_rng(15)
    h, w = CORPUS_HW
    dx, dy = CORPUS_DRIFT
    ph, pw = h + dy * CORPUS_FRAMES, w + dx * CORPUS_FRAMES
    for split, names in CORPUS_VIDEOS.items():
        (root / "annotations" / split).mkdir(parents=True)
        for name in names:
            base = rng.integers(0, 256, (ph // 16 + 1, pw // 16 + 1, 3),
                                dtype=np.uint8)
            base = base.repeat(16, 0).repeat(16, 1)[:ph, :pw]
            boxes = []
            for _, (x0, y0, x1, y1) in CORPUS_OBJECTS:
                b = [int(x0 * w), int(y0 * h), int(x1 * w), int(y1 * h)]
                base[b[1]:b[3], b[0]:b[2]] = rng.integers(0, 256, 3)
                boxes.append(b)
            frames = root / "frames" / split / name
            frames.mkdir(parents=True)
            trajectories = []
            for f in range(CORPUS_FRAMES):
                Image.fromarray(base[dy * f:dy * f + h, dx * f:dx * f + w]
                                ).save(frames / f"{f + 1:06d}.jpg")
                trajectories.append([
                    {"tid": tid, "bbox": {"xmin": float(x0 - dx * f),
                                          "ymin": float(y0 - dy * f),
                                          "xmax": float(x1 - dx * f),
                                          "ymax": float(y1 - dy * f)}}
                    for tid, (x0, y0, x1, y1) in enumerate(boxes)])
            anno = {"video_id": name, "height": h, "width": w,
                    "frame_count": CORPUS_FRAMES,
                    "subject/objects": [{"tid": tid, "category": c}
                                        for tid, (c, _) in
                                        enumerate(CORPUS_OBJECTS)],
                    "trajectories": trajectories,
                    "relation_instances": [
                        {"subject_tid": s, "object_tid": o, "predicate": p,
                         "begin_fid": b, "end_fid": e}
                        for s, o, p, b, e in CORPUS_RELATIONS[split]]}
            with open(root / "annotations" / split / f"{name}.json",
                      "w") as fh:
                json.dump(anno, fh)


def write_corpus_checkpoint(path: Path) -> None:
    """The detector checkpoint of phase 12b, a whole detector's ``.npz`` at
    the CLIs' defaults (R-101-C4, 35 classes): random weights from a seed
    with the RPN's and the box head's regressors zeroed, so that every box
    is an anchor. Random weights saturate the features (max |visual| about
    8e7 at full width), and random regressors then move each box onto the
    frame's edge, with no area: no two boxes overlap, and the tracker links
    none."""
    from vrdone_tpu_torch.convert import params_to_jax
    from vrdone_tpu_torch.models.detector import MegaDetector
    det = MegaDetector(num_classes=35, device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in (det.rpn.bbox_pred, det.box_head.bbox_pred):
            layer.weight.zero_()
            layer.bias.zero_()
    np.savez(path, **params_to_jax(det.state_dict()))


def check_frames_to_triplets(raw, cuda, ma, pb) -> None:
    """Phase 12b, the port alone from raw frames to triplets on the card,
    each step a subprocess: extract_gt_features_torch.py over
    the train annotations (its defaults: R-101, 16 box slots, window 25,
    global 10), then train_torch.py for one epoch of configs/vidvrd.yaml on
    those features, and beside them detect_torch.py on the test frames
    (``--score_thresh 0.02``, at most CORPUS_TRACKLETS tracklets and at
    least one), then extract_proposal_features_torch.py on its proposal
    pickles; last eval_torch.py on the checkpoint (every proposal's
    features read, six finite metrics); the detector and the extractors
    read one whole
    detector's ``.npz`` (``write_corpus_checkpoint``). Then the extraction's
    frames a second at full width in fp32 and bf16 (in turns, no MEGA
    kernel launched: the dense route), and extract_gt_features_torch.py on
    the card against the CPU at a small configuration (frame ids and tids
    equal, features within DETECT_TOL of max |ref|)."""
    import pickle

    import yaml

    import extract_gt_features_torch as egt
    from vrdone_tpu_torch.data.datasets import VidVRDDataset
    device = str(cuda)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_frames_corpus(root)
        ckpt = ["--ckpt_path", str(root / "detector.npz")]
        write_corpus_checkpoint(root / "detector.npz")
        feats = root / "features"
        cfg = json.loads(json.dumps(raw))
        cfg["dataset_config"].update(
            ann_dir=str(root / "annotations"),
            info_dir=str(feats / "per_video_val"),
            gt_boxfeatures_dir=str(feats / "GT_boxfeatures_training"),
            test_boxfeatures_dir=str(feats / "Proposal_boxfeatures_test"),
            cache_dir=str(root / "cache"))
        cfg["training_dataset_config"]["num_pairs"] = 2
        cfg["training_config"].update(batch_size=2, training_epoch=1,
                                      total_epoch=2, warmup_epochs=1,
                                      log_interval=1, eval_start_epoch=1)
        cfg["prepare_gt_config"]["gt_relations_path"] = str(root / "gts.json")
        cfg_path = root / "cfg.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        exp = root / "exp"
        common = ["--data_name", "vidvrd", "--cfg_path", str(cfg_path),
                  "--exp_dir", str(exp), "--device", device]
        steps = [
            ("extract_gt_features_torch.py",
             ["--anno_dir", str(root / "annotations" / "train"),
              "--frames_dir", str(root / "frames" / "train"), "--out_dir",
              str(feats / "GT_boxfeatures_training"), *ckpt,
              "--device", device]),
            ("train_torch.py", common),
            ("detect_torch.py",
             ["--frames_dir", str(root / "frames" / "test"), "--out_dir",
              str(feats / "per_video_val"), "--score_thresh", "0.02",
              "--max_proposal", str(CORPUS_TRACKLETS), *ckpt,
              "--device", device]),
            ("extract_proposal_features_torch.py",
             ["--proposal_dir", str(feats / "per_video_val"), "--frames_dir",
              str(root / "frames" / "test"), "--out_dir",
              str(feats / "Proposal_boxfeatures_test"), *ckpt,
              "--device", device]),
            ("eval_torch.py",
             [*common, "--ckpt_path", str(exp / "model_last.ckpt"),
              "--topk", "3"])]
        def lane(part):
            """Run the steps of ``part`` one after another, to the first
            that fails: (script, completed process, seconds) each."""
            done = []
            for script, args in part:
                t0 = time.perf_counter()
                done.append((script, subprocess.run(
                    [sys.executable, str(ROOT / script), *args], cwd=ROOT,
                    capture_output=True, text=True, timeout=600),
                    time.perf_counter() - t0))
                if done[-1][1].returncode != 0:
                    break
            return done

        # the train lane (GT features, then training) and the test lane
        # (detection, then proposal features) are independent: side by side
        # on the card, then the evaluation, which reads both
        with ThreadPoolExecutor(2) as pool:
            lanes = list(pool.map(lane, (steps[:2], steps[2:4])))
        n_props = {}
        for script, r, seconds in [*lanes[0], *lanes[1],
                                   *(lane(steps[4:]) if all(
                                       r.returncode == 0 for _, r, _ in
                                       lanes[0] + lanes[1]) else [])]:
            print(f"frames to triplets: {script} on {device}: exit "
                  f"{r.returncode} in {seconds:.1f} s"
                  + (f"; {r.stdout.strip()}" if script.startswith(
                      ("extract", "detect")) else ""))
            if r.returncode != 0:
                raise AssertionError(f"{script} failed:\n{r.stdout[-3000:]}"
                                     f"\n{r.stderr[-3000:]}")
            if script == "detect_torch.py":
                for name in CORPUS_VIDEOS["test"]:
                    with open(feats / "per_video_val" / f"{name}.pkl",
                              "rb") as fh:
                        n_props[name] = pickle.load(fh)["traj_proposal"][
                            "num_proposals"]
                    if n_props[name] < 1:
                        raise AssertionError(f"detect_torch.py wrote no "
                                             f"tracklet for {name}")
        metrics = dict(re_metric(r.stdout))
        if set(metrics) != set(METRIC_NAMES) or not all(
                map(math.isfinite, metrics.values())):
            raise AssertionError(f"eval_torch.py metrics {metrics}")
        # the eval loader reads every proposal's features (it asserts each
        # trajectory's frame count)
        test_cfg = dict(cfg["dataset_config"], **cfg["test_dataset_config"],
                        cache_dir=str(root / "cache_check"))
        dataset = VidVRDDataset(test_cfg)
        for name, n in n_props.items():
            item = dataset._prepare_test(name)
            if n >= 2 and len(item["visual_features_list"]) != n:
                raise AssertionError(f"{name}: features of "
                                     f"{len(item['visual_features_list'])} "
                                     f"of {n} proposals")
        print(f"frames to triplets: proposal tracklets {n_props}, each with "
              f"its features; eval_torch.py {metrics}")

        # the extraction's rate at full width, fp32 and bf16 in turns
        name = CORPUS_VIDEOS["train"][0]
        with open(root / "annotations" / "train" / f"{name}.json") as fh:
            anno = json.load(fh)
        args = egt.parse_args(["--anno_dir", "-", "--frames_dir", "-",
                               "--out_dir", "-", "--device", str(cuda)])
        det = egt.build_extractor(args, args.box_slots,
                                  min(15, args.box_slots))
        for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
            torch.cuda.synchronize()
            zero_mega_counts(ma, pb)
            t0 = time.perf_counter()
            egt.extract_video(det, anno, str(root / "frames" / "train"), name,
                              box_slots=args.box_slots, compute_dtype=dtype)
            wall = time.perf_counter() - t0
            seen = mega_counts(ma, pb)
            print(f"extract_gt_features_torch.extract_video {CORPUS_FRAMES} "
                  f"frames {CORPUS_HW[0]}x{CORPUS_HW[1]} {dtype}: "
                  f"{CORPUS_FRAMES / wall:.2f} frames/s (JPEG reads "
                  f"included); MEGA kernel launches {seen}")
            if any(seen.values()):
                raise AssertionError("extraction left the dense route")
        del det
        torch.cuda.empty_cache()

    check_gt_extractor_vs_cpu(cuda)


def check_gt_extractor_vs_cpu(cuda) -> None:
    """extract_gt_features_torch.py (its ``main``) on the card against
    ``--device cpu`` at a small configuration (R (1, 1, 1), 4 box slots,
    window 3, global 2) over 6 frames of 64 x 96: keys, frame ids and tids
    equal, features within DETECT_TOL of max |ref|."""
    import pickle

    from PIL import Image

    import extract_gt_features_torch as egt
    rng = np.random.default_rng(16)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "anno").mkdir()
        (root / "frames" / "vid").mkdir(parents=True)
        traj = []
        for f in range(6):
            Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
                            ).save(root / "frames" / "vid" / f"{f + 1:06d}.jpg")
            traj.append([{"tid": k, "bbox": {
                "xmin": 4.0 + 2 * f + 30 * k, "ymin": 6.0,
                "xmax": 30.0 + 2 * f + 30 * k, "ymax": 50.0}}
                for k in range(f % 3 + 1)])
        (root / "anno" / "vid.json").write_text(json.dumps(
            {"video_id": "vid", "height": 64, "width": 96, "frame_count": 6,
             "trajectories": traj, "relation_instances": [],
             "subject/objects": [{"tid": k, "category": "dog"}
                                 for k in range(3)]}))
        out = {}
        for dev in (str(cuda), "cpu"):
            egt.main(["--anno_dir", str(root / "anno"), "--frames_dir",
                      str(root / "frames"), "--out_dir", str(root / dev),
                      "--resnet_layers", "1,1,1", "--box_slots", "4",
                      "--window", "3", "--global_size", "2",
                      "--device", dev])
            with open(root / dev / "vid.pkl", "rb") as fh:
                out[dev] = pickle.load(fh)
    got, ref = out[str(cuda)], out["cpu"]
    if list(got) != list(ref) or not all(
            got[f]["frame_id"] == ref[f]["frame_id"]
            and np.array_equal(got[f]["tids"], ref[f]["tids"]) for f in ref):
        raise AssertionError("extract_gt_features_torch.py: frame ids or "
                             "tids differ between the card and the CPU")
    a, b = (np.concatenate([d[f]["visual_features"] for f in d])
            for d in (got, ref))
    err = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"extract_gt_features_torch.py, small configuration, card vs CPU: "
          f"{len(ref)} frames, ids and tids equal, features max |err| / "
          f"max |x| {err:.3e}")
    if not err <= DETECT_TOL:
        raise AssertionError(f"extract_gt_features_torch.py off by {err}")


def band_pe_library_mask(mask: torch.Tensor, rel_pe: torch.Tensor,
                         window_size: int) -> torch.Tensor:
    """K4's masking and bias as one additive (B, H, T, T) mask for
    ``F.scaled_dot_product_attention``."""
    t, w = mask.shape[1], window_size // 2
    i = torch.arange(t, device=mask.device)
    idx = (i[None] - i[:, None] + w).clamp(0, window_size - 1)
    return band_library_mask(mask, w) + rel_pe[:, idx][None]


def check_band_pe(cuda, ba, mops) -> tuple[dict, dict]:
    """K4 against its plain version at the streamed chunk's band shapes
    (B=8, H=8, d=64: the stem at T=768, the branches at 384, 192, 96), at
    a T off the row tile, at w=3 and at an even window, with invalid
    keys inside and after the valid stretch; ``BandAttentionPE``'s dq, dk,
    dv and d rel_pe against plain autograd at the stem's shape. Returns
    K4's JSON entry, timed at the stem's shape with the kernel alone,
    SDPA and the bound at each stream shape in ``by_shape``, and the
    kernel alone at each stream shape, {T: ms}."""
    rng = np.random.default_rng(11)
    b, h, d = 8, 8, 64
    worst, entry, alone, rows = 0.0, None, {}, []
    for t, ws in ((768, 9), (384, 9), (192, 9), (96, 9), (757, 9), (768, 7),
                  (768, 8)):
        q, k, v, mask = attention_inputs(rng, b, t, t, h * d, cuda)
        mask[1, t // 3] = False   # an invalid key inside a valid stretch
        pe = torch.from_numpy(rng.standard_normal((h, ws))
                              .astype(np.float32)).to(cuda)
        kw = dict(n_head=h, window_size=ws)
        err, ms, plain_ms = compare(
            lambda: ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw),
            lambda: ba.band_attention_pe_plain(q, k, v, mask, pe, **kw))
        print(f"band_attention_pe B*H=8*8 d=64 window={ws} T={t}: "
              f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"K4 off by {err} at T={t} window={ws}")
        worst = max(worst, err)
        if not (ws == 9 and t % 96 == 0):
            continue
        lib_mask = band_pe_library_mask(mask, pe, ws)
        rows.append(band_row(
            ba, f"B*H=8*8 T={t} d=64 window=9",
            lambda: ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw),
            plain_ms, lambda: F.scaled_dot_product_attention(
                heads(q, h), heads(k, h), heads(v, h), attn_mask=lib_mask),
            q, mask, h, ws // 2, pe=pe))
        del lib_mask
        alone[t] = rows[-1]["device_ms"]
        if t != 768:
            continue
        entry = {**rows[-1], "ms": ms, "by_shape": rows}

        # BandAttentionPE: the K4 forward, the dense form's autograd as the
        # backward, against plain autograd on the same inputs
        dout = torch.from_numpy(rng.standard_normal(q.shape)
                                .astype(np.float32)).to(cuda)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, pe)]
        before = ba.pe_launches
        got = torch.autograd.grad(
            mops.band_attention(*leaves[:3], mask, rel_pe=leaves[3], **kw),
            leaves, dout)
        if ba.pe_launches != before + 1:
            raise AssertionError("BandAttentionPE did not launch K4")
        ref = [x.clone().requires_grad_() for x in (q, k, v, pe)]
        want = torch.autograd.grad(
            ba.band_attention_pe_plain(*ref[:3], mask, ref[3], **kw), ref,
            dout)
        errs = [(g - r).abs().max().item() / max(1.0, r.abs().max().item())
                for g, r in zip(got, want)]
        print("BandAttentionPE at B*H=8*8 T=768 d=64 window=9: dq, dk, dv, "
              "d rel_pe err / max|grad| " + ", ".join(f"{e:.3e}"
                                                      for e in errs))
        if not max(errs) <= GRAD_TOL:
            raise AssertionError(f"BandAttentionPE grads off: {errs}")
    entry["max_abs_err"] = worst
    return entry, alone


def check_band_pe_bf16(cuda, ba) -> dict:
    """K4's bf16 instance against its bf16 plain version (BF16_KERNEL_TOL),
    the table bf16 as ``cast_floating`` and the bf16 train step leave it,
    at the bf16 rel-PE paths' shapes (VidOR local width, B*H=16*8, d=64,
    window 9: the stem at T=512, the branches at 256, 128, 64) and the
    stream's (B*H=8*8, T=768, 384, 192, 96), at a T off the row tile and
    an even window, with invalid keys inside and after the valid stretch;
    with a zero table it gives K1 bf16's output bit for bit. Each path
    shape timed alone beside K4 fp32 alone on the same values, the bf16
    plain version, SDPA in bf16 with the band, key mask and bias as one
    additive mask, and the bound. Returns the JSON entry
    ``band_attention_pe_bf16`` at the stem's shape, with ``by_shape``."""
    rng = np.random.default_rng(14)
    bf, h, d = torch.bfloat16, 8, 64
    rows, worst = [], 0.0
    band_regs = instance_usage("band_attention")
    # (B, T, window, timed): the paths' shapes, then checks only
    for b, t, ws, timed in ((16, 512, 9, True), (16, 256, 9, True),
                            (16, 128, 9, True), (16, 64, 9, True),
                            (8, 768, 9, True), (8, 384, 9, True),
                            (8, 192, 9, True), (8, 96, 9, True),
                            (16, 500, 9, False), (16, 512, 8, False)):
        q, k, v, mask = attention_inputs(rng, b, t, t, h * d, cuda)
        mask[1, t // 3] = False   # an invalid key inside a valid stretch
        pe = torch.from_numpy(rng.standard_normal((h, ws))
                              .astype(np.float32)).to(cuda)
        q16, k16, v16, pe16 = (x.to(bf) for x in (q, k, v, pe))
        kw = dict(n_head=h, window_size=ws)
        kernel = lambda: ba.band_attention_pe_cuda(q16, k16, v16, mask, pe16,
                                                   **kw)
        plain = lambda: ba.band_attention_pe_plain(q16, k16, v16, mask, pe16,
                                                   **kw)
        inst = mma_band_instance(ba, band_regs, cuda, b, t, h, d, ws, True)
        label = f"B*H={b}*{h} T={t} d={d} window={ws} ({inst})"
        zero = torch.zeros_like(pe16)
        if not torch.equal(
                ba.band_attention_pe_cuda(q16, k16, v16, mask, zero, **kw),
                ba.band_attention_cuda(q16, k16, v16, mask, **kw)):
            raise AssertionError(f"K4 bf16 with a zero table is not K1 bf16 "
                                 f"at {label}")
        if not timed:
            out, ref = kernel().float(), plain().float()
            err = (out - ref).abs().max().item()
            limit = BF16_KERNEL_TOL * (1 + ref.abs().max().item())
            print(f"band_attention_pe_bf16 {label}: max_abs_err {err:.3e} "
                  f"(limit {limit:.3e}); a zero table gives K1 bf16 bit "
                  f"for bit")
            if not err <= limit:
                raise AssertionError(f"K4 bf16 off by {err} at {label}")
            worst = max(worst, err)
            continue
        lib_mask = band_pe_library_mask(mask, pe16, ws).to(bf)
        row = bf16_case(
            "band_attention_pe_bf16", label, kernel, plain,
            lambda: F.scaled_dot_product_attention(
                heads(q16, h), heads(k16, h), heads(v16, h),
                attn_mask=lib_mask),
            2 * (4 * q.numel() + pe.numel()) + mask.numel(),
            4 * d * h * band_pairs(mask, ws // 2))
        del lib_mask
        row["fp32_device_ms"] = queued_device_ms(
            lambda: ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw))
        print(f"  K4 fp32 alone on the same values {row['fp32_device_ms']:.4f}"
              f" ms; a zero table gives K1 bf16 bit for bit")
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
    return {**rows[0], "max_abs_err": worst, "by_shape": rows}


def check_stream_kernels(cuda, ba, fa, band_rows: list
                         ) -> tuple[dict, dict]:
    """K1 and K7 against their plain versions at the shapes the streamed
    chunk group gives them: K1 in the S/O mutual layers at B=8, T=768,
    H=8, d=64, window 9, with invalid keys inside and after the valid
    stretch; K7 in the predictor at B=8, H=8, d=32 with 9 queries over the
    9 queries (all valid) and over the 96 positions of the coarsest level.
    Returns the worst error of each and the kernel alone at each shape, and
    appends K1's row (beside SDPA and its bound) to ``band_rows``."""
    rng = np.random.default_rng(13)
    worst = {"band_attention": 0.0, "masked_attention": 0.0}
    alone = {}
    q, k, v, mask = attention_inputs(rng, 8, 768, 768, 8 * 64, cuda)
    mask[1, 768 // 3] = False   # an invalid key inside a valid stretch
    kw = dict(n_head=8, window_size=9)
    cases = [("band_attention", "T=768",
              lambda: ba.band_attention_cuda(q, k, v, mask, **kw),
              lambda: ba.band_attention_plain(q, k, v, mask, **kw))]
    for tk in (9, 96):
        qf, kf, vf, mf = attention_inputs(rng, 8, 9, tk, 8 * 32, cuda)
        if tk == 9:
            mf[:] = True
        cases.append(("masked_attention", f"Tq=9 Tk={tk}",
                      lambda qf=qf, kf=kf, vf=vf, mf=mf:
                      fa.full_attention_cuda(qf, kf, vf, mf, n_head=8),
                      lambda qf=qf, kf=kf, vf=vf, mf=mf:
                      fa.full_attention_plain(qf, kf, vf, mf, n_head=8)))
    lib_mask = band_library_mask(mask, 4)
    for name, label, kernel, plain in cases:
        err, ms, plain_ms = compare(kernel, plain)
        if name == "band_attention":
            band_rows.append(band_row(
                ba, "B*H=8*8 T=768 d=64 w=4", kernel, plain_ms,
                lambda: F.scaled_dot_product_attention(
                    heads(q, 8), heads(k, 8), heads(v, 8),
                    attn_mask=lib_mask), q, mask, 8, 4))
            alone[name, label] = band_rows[-1]["device_ms"]
        else:
            alone[name, label] = queued_device_ms(kernel)
        print(f"{name} stream shape B=8 H=8 {label}: max_abs_err "
              f"{err:.3e}, kernel {ms:.4f} ms (alone "
              f"{alone[name, label]:.4f} ms), plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name} off by {err} at the stream's "
                                 f"{label}")
        worst[name] = max(worst[name], err)
    return worst, alone


def check_streaming(cuda, ba, fa, pe_alone: dict, alone: dict) -> dict:
    """``StreamingRunner`` at VidOR local-attention width with
    ``use_rel_pe`` over ``STREAM_T`` positions: the launches of the whole
    run (counts set to 0 just before it), the first chunk group's first two
    chunks against the CPU, the records, the rates and a profile, with the
    hand kernels' device time from their times alone (``pe_alone`` of
    ``check_band_pe``, ``alone`` of ``check_stream_kernels``) in place of
    what the profiler saw of them. Returns the run's launches per kernel."""
    from vrdone_tpu_torch.config import (InferenceConfig, load_yaml_config,
                                         model_config_from_yaml)
    from vrdone_tpu_torch.eval.streaming import StreamingRunner
    raw = load_yaml_config(str(ROOT / "configs" / "vidor_local.yaml"))
    cfg = dataclasses.replace(model_config_from_yaml(raw), use_rel_pe=True)
    cpu_model, gpu_model = build_models(cfg, cuda)
    ic = raw["inference_config"]
    infer = InferenceConfig(
        topk=ic["topk"], feat_stride=ic["feat_stride"],
        pred_min_frames=ic["pred_min_frames"], n_max_pair=ic["n_max_pair"],
        viou_th=ic["viou_th"], max_so_pair=cfg.max_so_pair)
    feat_dim = packed_channels(cfg)
    runner = StreamingRunner(cfg, gpu_model, infer, feat_dim, chunk_batch=8,
                             device=cuda)
    rng = np.random.default_rng(12)
    so_feat = rng.standard_normal((STREAM_T, feat_dim)).astype(np.float32)
    chunks = runner.chunk_starts(STREAM_T)
    groups = list(runner.chunk_groups(so_feat))
    print(f"stream: vidor_local + use_rel_pe, T={STREAM_T}, halo "
          f"{runner.halo}, chunk {runner.chunk_len}, interior "
          f"{runner.interior}: {len(chunks)} chunks in {len(groups)} forwards "
          f"of {tuple(groups[0][1].shape)}")
    if (runner.halo, runner.chunk_len) != (192, 768):
        raise AssertionError(f"halo {runner.halo}, chunk {runner.chunk_len}")

    # the first chunk group's first two chunks against the CPU
    _, feats, mask = groups[0]
    with torch.inference_mode():
        out = gpu_model(torch.from_numpy(feats).to(cuda),
                        torch.from_numpy(mask).to(cuda))
        ref = cpu_model(torch.from_numpy(feats[:2]),
                        torch.from_numpy(mask[:2]))
    del cpu_model
    for key in ("pred_logits", "pred_masks"):
        err = (out[key][:2].cpu() - ref[key]).abs().max().item()
        print(f"stream chunk group 0, chunks 0-1, {key} "
              f"{tuple(out[key].shape)}: CUDA vs CPU max_abs_err {err:.3e} "
              f"(max |x| {ref[key].abs().max().item():.3e})")
        if not err <= MODEL_TOL:
            raise AssertionError(f"stream {key} off by {err}")

    torch.cuda.synchronize()
    ba.launches = ba.pe_launches = fa.launches = 0
    records = runner.run_pair(so_feat)
    torch.cuda.synchronize()
    launches = {"band_attention_pe": ba.pe_launches,
                "band_attention": ba.launches, "masked_attention": fa.launches}
    arch, n = cfg.backbone_arch, len(groups)
    expect = {"band_attention_pe": n * (2 * arch[1] + arch[2]),
              "band_attention": n * 4 * arch[1],
              "masked_attention": n * 2 * cfg.predictor.num_layers}
    print(f"stream run_pair: kernel launches {launches} in {n} forwards "
          f"(per forward K4 {launches['band_attention_pe'] // n}, K1 "
          f"{launches['band_attention'] // n}, K7 "
          f"{launches['masked_attention'] // n})")
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if not records or not all(
            math.isfinite(r["score"]) and 0 <= r["start"] < r["end"]
            <= STREAM_T and 1 <= r["pred_cat"] <= cfg.num_classes
            for r in records):
        raise AssertionError(f"stream records: {records[:5]}")
    print(f"stream run_pair: {len(records)} span records over "
          f"{len({r['query'] for r in records})} queries")

    feats_dev = torch.from_numpy(feats).to(cuda)
    mask_dev = torch.from_numpy(mask).to(cuda)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: gpu_model(feats_dev, mask_dev), iters=5,
                         warmup=1)
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner.run_pair(so_feat)
        seconds = time.perf_counter() - t0
        print(f"stream T={STREAM_T} fp32: {STREAM_T / seconds:.1f} "
              f"positions/s, {len(chunks) / seconds:.2f} chunks/s, "
              f"{1e3 * seconds:.1f} ms a sequence; one chunk-group forward "
              f"{fwd_ms:.2f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    busy, wall, events = profile_device(lambda: runner.run_pair(so_feat), 1,
                                        "sequence")
    # the hand kernels of a forward by shape: K4 in the stem's blocks of
    # both streams at T and once a branch level at T/2, T/4, ...; K1 at T;
    # K7 over the queries and over the coarsest level
    t = runner.chunk_len
    per_forward = {
        "band_attention_pe": 2 * arch[1] * pe_alone[t] + sum(
            pe_alone[t >> (lv + 1)] for lv in range(arch[2])),
        "band_attention": 4 * arch[1] * alone["band_attention", f"T={t}"],
        "masked_attention": cfg.predictor.num_layers * (
            alone["masked_attention", "Tq=9 Tk=9"]
            + alone["masked_attention", f"Tq=9 Tk={t >> arch[2]}"])}
    hand = {name: n * ms for name, ms in per_forward.items()}
    names = ("band_attention_pe_fwd_kernel", "band_attention_fwd_kernel",
             "masked_attention_fwd_kernel")
    seen = [e for e in events if any(s in e.key for s in names)]
    seen_ms = sum(dev_us(e) for e in seen) / 1e3
    total = busy - seen_ms + sum(hand.values())
    print(f"stream hand kernels a sequence, alone times x launches: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in hand.items())
          + f"; the profiler saw {sum(e.count for e in seen)} of "
          f"{sum(launches.values())} of their launches ({seen_ms:.3f} ms); "
          f"device busy with all of them {total:.2f} ms "
          f"({100 * total / wall:.1f}% of the profiled wall), the hand "
          f"kernels {100 * sum(hand.values()) / total:.1f}% of it")
    return launches


# -- phase 14: MEGA detector training on the card ----------------------------
DET_TRAIN_CFG = ROOT / "configs" / "detector" / "mega_vidvrd.yaml"
DET_TRAIN_STEPS = 3
# train_detector_torch.py's defaults: the canvas, key proposals, GT slots
DET_CANVAS, DET_POST_NMS, DET_MAX_GT = (608, 1088), 128, 16
# the small configuration of tests/test_torch_detector_train.py
SMALL_TRAIN_DET = dict(num_classes=35, resnet_layers=(1, 1, 1), stage=2,
                       groups=4, base_num=4, window=3, key_loc=1,
                       global_size=2)
SMALL_TRAIN_HW, SMALL_TRAIN_POST_NMS = (64, 64), 8
DET_GRAD_TOL = 1e-4   # card vs CPU gradients, times 1 + max |g| of a leaf
# a gradient leaf behind a ReLU, max-pool or warp cell that took the other
# branch in the other fp32 run (``Branches``): the largest gap allowed,
# times 1 + max |g|, and the most such leaves (phase 15b's DFF sample: 16
# ReLU sides of 6.25M flipped, 64 of 176 leaves off, the worst 2.4e-3)
FLIP_GRAD_TOL, FLIP_LEAVES = 1e-2, 100
DET_DP_PARAM_TOL = 1e-6   # two ranks' step vs one process's, parameters


def det_train_batch(rng, b: int, hw, n_ref: tuple, max_gt: int,
                    n_gt: int = 4) -> dict:
    """A detector training batch of ``b`` samples on an ``hw`` canvas: key,
    local, memory and global frames (``n_ref``) of uniform noise, ``n_gt``
    GT boxes with labels in 1..35 and the rest of ``max_gt`` slots
    padding."""
    h, w = hw
    n_l, n_m, n_g = n_ref
    frames = rng.uniform(0, 255, (b, 1 + n_l + n_m + n_g, h, w, 3)
                         ).astype(np.float32)
    xy = rng.uniform(0, 0.6, (b, n_gt, 2)) * (w, h)
    wh = rng.uniform(0.15, 0.4, (b, n_gt, 2)) * (w, h)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_boxes[:, :n_gt] = np.concatenate([xy, xy + wh], -1)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_labels[:, :n_gt] = rng.integers(1, 36, (b, n_gt))
    gt_valid = np.zeros((b, max_gt), bool)
    gt_valid[:, :n_gt] = True
    return {"key": frames[:, 0], "local": frames[:, 1:1 + n_l],
            "mem": frames[:, 1 + n_l:1 + n_l + n_m],
            "glob": frames[:, 1 + n_l + n_m:], "gt_boxes": gt_boxes,
            "gt_labels": gt_labels, "gt_valid": gt_valid}


@torch.no_grad()
def frozen_bn_from_inputs(root, run) -> None:
    """Set each frozen batch norm's statistics under ``root`` to those of
    its input while ``run()`` runs, as an ImageNet-trained backbone's
    statistics are its data's. Random He-normal convolutions through
    identity norms grow the activations block by block: at R-101's depth
    the port's own seeded weights give losses near 1e7 and a gradient of
    NaN."""
    from vrdone_tpu_torch.models.resnet import FrozenBatchNorm

    def hook(m, args):
        x = args[0].float()
        m.running_mean.copy_(x.mean((0, 2, 3)))
        m.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(hook) for m in root.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()


def calibrate_frozen_bn(det, images: torch.Tensor, rois: torch.Tensor
                        ) -> None:
    """``frozen_bn_from_inputs`` for a detector: the backbone's norms over
    ``images``, the C5 head's over ``rois`` of the first image (any
    detector of the port: C5 under ``box_head`` or alone)."""
    pool = (det.box_head.pooled_features if hasattr(det, "box_head")
            else det.pooled)
    frozen_bn_from_inputs(det, lambda: pool(det.features(images)[0], rois))


@torch.no_grad()
def damp_heads(det) -> None:
    """A tenth of the MEGA head's and the RPN's and box head's predictor
    kernels (``tests/test_torch_detector_train.py::damp``): at full scale
    MEGA's softmaxes saturate, and the small detector's gradient is float
    noise."""
    for name, p in det.named_parameters():
        if p.ndim >= 2 and (name.startswith("mega.") or name.split(".")[-2]
                            in ("cls_score", "bbox_pred", "cls_logits")):
            p.mul_(0.1)


def small_train_case(device):
    """The small detector (seed 1, its frozen norms calibrated and its
    heads damped on the CPU) on ``device``, and a batch of two samples of
    64 x 64 with one local, memory and global frame each (seed 22)."""
    from vrdone_tpu_torch.models.detector import MegaDetector
    det = MegaDetector(**SMALL_TRAIN_DET, device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(22)
    batch = det_train_batch(rng, 2, SMALL_TRAIN_HW, (1, 1, 1), 3, n_gt=2)
    calibrate_frozen_bn(det, torch.from_numpy(batch["key"]),
                        torch.from_numpy(batch["gt_boxes"][0, :2]))
    damp_heads(det)
    return det.to(device), batch


def det_step_setup(cfg_path: Path):
    """The detector config at ``cfg_path`` and a maker of its SGD (its
    multistep schedule with warmup, as train_detector_torch.py builds
    them)."""
    from vrdone_tpu_torch.detector_config import load_detector_config
    from vrdone_tpu_torch.train.optim import detector_sgd, multistep_schedule
    cfg = load_detector_config(str(cfg_path))
    schedule = multistep_schedule(
        cfg.base_lr, cfg.warmup_iters, tuple(cfg.steps), cfg.gamma,
        cfg.base_lr * cfg.warmup_factor)
    return cfg, lambda det: detector_sgd(
        schedule, det.named_parameters(), momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, bias_lr_factor=cfg.bias_lr_factor,
        weight_decay_bias=cfg.weight_decay_bias)


def check_detector_train(cuda, ba, fa, ma, pb) -> dict:
    """Phase 14a: ``configs/detector/mega_vidvrd.yaml`` at full width
    (R-101-C4, 608 x 1088, 2 local, 3 memory and 2 global frames, 75
    reference and 128 key proposals, 16 GT slots) from random seeded
    weights with calibrated frozen norms, DET_TRAIN_STEPS steps at a batch
    of 1 on the card: finite losses each step, every parameter group moved,
    the step time (steps 1 and 2), the peak memory, the busy share (a
    profiled fourth step) and the launches of one step, which must hold
    no K5, K6 or ``bias_factors`` (training takes the dense route, as JAX
    trains). Returns the launches of the last step."""
    from vrdone_tpu_torch.detector_config import mega_detector_kwargs
    from vrdone_tpu_torch.models.detector import MegaDetector
    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        detector_train_step)
    cfg, make_opt = det_step_setup(DET_TRAIN_CFG)
    det = MegaDetector(**mega_detector_kwargs(cfg),
                       device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(21)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in det_train_batch(
        rng, 1, DET_CANVAS, (cfg.ref_num_local, cfg.ref_num_mem,
                             cfg.ref_num_global), DET_MAX_GT).items()}
    calibrate_frozen_bn(det, batch["key"], batch["gt_boxes"][0, :4])
    opt = make_opt(det)
    start = {n: p.detach().clone() for n, p in det.named_parameters()}
    n_params = sum(p.numel() for p in start.values())

    def step(i):
        return detector_train_step(det, opt, batch,
                                   StepPriorities(0, i, cuda),
                                   image_hw=DET_CANVAS,
                                   post_nms_top_n=DET_POST_NMS)

    ms = []
    torch.cuda.reset_peak_memory_stats(cuda)
    for i in range(DET_TRAIN_STEPS):
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        zero_mega_counts(ma, pb)
        t0 = time.perf_counter()
        losses = step(i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches = {**band_counts(ba, fa), **mega_counts(ma, pb)}
        values = {k: v.item() for k, v in losses.items()}
        print(f"detector train step {i} (mega_vidvrd.yaml, R-101-C4, "
              f"{DET_CANVAS[0]}x{DET_CANVAS[1]}, 8 frames, TF32 off): "
              + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
        if not all(map(math.isfinite, values.values())):
            raise AssertionError(f"detector train step {i}: {values}")
    peak = torch.cuda.max_memory_allocated(cuda) / 2**30
    moved = {}
    for group, prefix in (("backbone", "backbone."), ("RPN", "rpn."),
                          ("box head", "box_head."), ("MEGA head", "mega.")):
        moved[group] = max((p.detach() - start[n]).abs().max().item()
                           for n, p in det.named_parameters()
                           if n.startswith(prefix))
    print(f"detector train: {n_params} parameters; largest move by group "
          f"after {DET_TRAIN_STEPS} steps {moved}")
    if not all(v > 0 and math.isfinite(v) for v in moved.values()):
        raise AssertionError(f"a parameter group did not move: {moved}")
    print(f"detector train step times (ms, host clock, steps 0-"
          f"{DET_TRAIN_STEPS - 1}): " + ", ".join(f"{t:.2f}" for t in ms)
          + f"; peak memory {peak:.2f} GiB")
    print(f"detector train step: kernel launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the detector train step launched "
                             f"{launches}: training takes the dense route")
    busy, wall, _ = profile_device(lambda: step(DET_TRAIN_STEPS), 1, "step")
    print(f"detector train step: busy {busy:.2f} ms of {wall:.2f} ms "
          f"({100 * busy / wall:.1f}%, profiler on)")
    del det, opt, start, batch
    torch.cuda.empty_cache()
    return launches


def det_losses_and_grads(det, batch, i: int, device) -> tuple[dict, dict]:
    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        mega_detector_losses)
    tb = {k: torch.from_numpy(v[i]).to(device) for k, v in batch.items()}
    losses = mega_detector_losses(
        det, tb["key"], tb["local"], tb["mem"], tb["glob"], SMALL_TRAIN_HW,
        tb["gt_boxes"], tb["gt_labels"], tb["gt_valid"],
        StepPriorities(0, 0, device)(i), post_nms_top_n=SMALL_TRAIN_POST_NMS)
    names = [n for n, _ in det.named_parameters()]
    params = [p for _, p in det.named_parameters()]
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    return ({k: v.item() for k, v in losses.items()},
            {n: (torch.zeros_like(p) if g is None else g).cpu()
             for n, p, g in zip(names, params, grads)})


def check_detector_train_vs_cpu(cuda) -> None:
    """Phase 14b: the small detector's losses and gradients of one sample
    on the card against the port's CPU run, from the same weights, frames
    and draws: losses within LOSS_TOL, each leaf's gradient within
    DET_GRAD_TOL x (1 + max |g|)."""
    cpu_det, batch = small_train_case(torch.device("cpu"))
    gpu_det = copy.deepcopy(cpu_det).to(cuda)
    want, want_g = det_losses_and_grads(cpu_det, batch, 0, torch.device("cpu"))
    got, got_g = det_losses_and_grads(gpu_det, batch, 0, cuda)
    loss_err = max(abs(got[k] - v) / (1 + abs(v)) for k, v in want.items())
    grad_err = {n: ((got_g[n] - g).abs().max()
                    / (1 + g.abs().max())).item() for n, g in want_g.items()}
    worst = max(grad_err, key=grad_err.get)
    print(f"small detector train sample, card vs CPU: losses {got} (CPU "
          f"{want}), worst loss rel err {loss_err:.3e}; worst gradient "
          f"{worst} {grad_err[worst]:.3e} of 1 + max |g|")
    if loss_err > LOSS_TOL or grad_err[worst] > DET_GRAD_TOL:
        raise AssertionError("the detector's training losses or gradients "
                             "on the card differ from the CPU's")


def det_dp_rank_main(out_dir: str) -> None:
    """One rank of phase 14d, started by ``check_detector_dp`` with
    torchrun's environment: a gloo group over CUDA tensors on card 0, one
    detector step of the small configuration on this rank's sample of the
    global batch; writes its losses and parameters to
    ``out_dir/rank<r>.pt``."""
    from vrdone_tpu_torch.convert import load_npz, load_params
    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        detector_train_step)
    from vrdone_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = mesh.init_distributed("cuda:0", backend="gloo")
    try:
        det, batch = small_train_case(device)
        load_params(det, load_npz(os.path.join(out_dir, "start.npz")))
        _, make_opt = det_step_setup(DET_TRAIN_CFG)
        rows = mesh.local_batch_slice(2)
        losses = detector_train_step(
            det, make_opt(det), {k: torch.from_numpy(v[rows]).to(device)
                                 for k, v in batch.items()},
            StepPriorities(0, 0, device), image_hw=SMALL_TRAIN_HW,
            post_nms_top_n=SMALL_TRAIN_POST_NMS)
        torch.save({"losses": {k: v.item() for k, v in losses.items()},
                    "params": [p.detach().cpu() for p in det.parameters()]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        mesh.shutdown()


def check_detector_dp(cuda) -> None:
    """Phase 14d: two ranks sharing the card over gloo, a sample each, one
    detector step of the small configuration against one process's step
    on both samples: losses within LOSS_TOL, parameters within
    DET_DP_PARAM_TOL, the ranks equal bit for bit."""
    from vrdone_tpu_torch.convert import params_to_jax
    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        detector_train_step)
    det, batch = small_train_case(cuda)
    with tempfile.TemporaryDirectory() as out_dir:
        # the ranks start from these weights bit for bit
        np.savez(os.path.join(out_dir, "start.npz"),
                 **params_to_jax(det.state_dict()))
        env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.det_dp_rank_main({out_dir!r})"],
            cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            _, make_opt = det_step_setup(DET_TRAIN_CFG)
            one = detector_train_step(
                det, make_opt(det), {k: torch.from_numpy(v).to(cuda)
                                     for k, v in batch.items()},
                StepPriorities(0, 0, cuda), image_hw=SMALL_TRAIN_HW,
                post_nms_top_n=SMALL_TRAIN_POST_NMS)
        finally:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"detector rank {r} failed:\n"
                                     f"{log[-3000:]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=True) for r in range(2)]
    seconds = time.perf_counter() - t0
    if ranks[0]["losses"] != ranks[1]["losses"] or not all(
            torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                              ranks[1]["params"])):
        raise AssertionError("the detector ranks' steps differ")
    one = {k: v.item() for k, v in one.items()}
    loss_err = max(abs(ranks[0]["losses"][k] - v) / (1 + abs(v))
                   for k, v in one.items())
    gap = max((a - b.cpu()).abs().max().item()
              for a, b in zip(ranks[0]["params"], det.parameters()))
    print(f"detector step, 2 ranks on one card (gloo) x 1 sample vs one "
          f"process x 2: total_loss {ranks[0]['losses']['total_loss']:.6f} "
          f"vs {one['total_loss']:.6f}, worst loss rel err {loss_err:.3e}; "
          f"ranks equal bit for bit; largest parameter gap {gap:.3e} "
          f"({seconds:.1f} s)")
    if loss_err > LOSS_TOL or gap > DET_DP_PARAM_TOL:
        raise AssertionError("two ranks' detector step differs from one "
                             "process's")


def check_detector_train_cli(cuda) -> None:
    """Phase 14c: ``train_detector_torch.py --cfg mega_vidvrd.yaml`` for 4
    iterations on phase 12's VidVRD-layout corpus (the two train videos),
    starting from calibrated random weights through ``--init_ckpt``, then
    ``detect_torch.py --ckpt_path`` on the ``.npz`` it wrote, over 8 frames
    of the test video; both subprocesses on the card, exit 0, every logged
    loss finite."""
    import shutil

    from vrdone_tpu_torch.convert import params_to_jax
    from vrdone_tpu_torch.detector_config import (load_detector_config,
                                                  mega_detector_kwargs)
    from vrdone_tpu_torch.models.detector import MegaDetector
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_frames_corpus(root)
        det = MegaDetector(**mega_detector_kwargs(load_detector_config(
            str(DET_TRAIN_CFG))), device=torch.device("cpu"),
            generator=torch.Generator().manual_seed(0)).to(cuda)
        rng = np.random.default_rng(23)
        images = torch.from_numpy(rng.uniform(0, 255, (1, *DET_CANVAS, 3))
                                  .astype(np.float32)).to(cuda)
        calibrate_frozen_bn(det, images, torch.tensor(
            [[40.0, 30.0, 400.0, 500.0], [500.0, 100.0, 900.0, 560.0]],
            device=cuda))
        np.savez(root / "init.npz", **params_to_jax(det.state_dict()))
        del det, images
        torch.cuda.empty_cache()
        test_frames = root / "test_frames" / CORPUS_VIDEOS["test"][0]
        test_frames.mkdir(parents=True)
        src = root / "frames" / "test" / CORPUS_VIDEOS["test"][0]
        for f in sorted(os.listdir(src))[:8]:
            shutil.copy(src / f, test_frames / f)
        exp = root / "exp"
        runs = [("train_detector_torch.py",
                 ["--anno_dir", str(root / "annotations" / "train"),
                  "--frames_dir", str(root / "frames" / "train"),
                  "--exp_dir", str(exp), "--dataset", "vidvrd", "--cfg",
                  str(DET_TRAIN_CFG), "--init_ckpt", str(root / "init.npz"),
                  "--iters", "4", "--log_interval", "1", "--device",
                  "cuda"]),
                ("detect_torch.py",
                 ["--frames_dir", str(root / "test_frames"), "--out_dir",
                  str(root / "det"), "--ckpt_path",
                  str(exp / "detector_4.npz"), "--score_thresh", "0.02",
                  "--max_proposal", str(CORPUS_TRACKLETS), "--device",
                  "cuda"])]
        for script, args in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, str(ROOT / script), *args],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"{script} failed:\n{r.stdout[-3000:]}"
                                     f"\n{r.stderr[-3000:]}")
            print(f"{script} on the card: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s")
            if script == "train_detector_torch.py":
                totals = [float(v) for v in re.findall(
                    r"total_loss: (\S+) ", r.stdout)]
                print(f"  total_loss by iteration (window median): "
                      f"{totals}; {r.stdout.strip().splitlines()[-1]}")
                if len(totals) != 4 or not all(map(math.isfinite, totals)):
                    raise AssertionError(f"train_detector_torch.py losses "
                                         f"{totals}")
        if not (root / "det" / f"{CORPUS_VIDEOS['test'][0]}.pkl").exists():
            raise AssertionError("detect_torch.py wrote no pickle")


def detector_train_phase(cuda, ba, fa, ma, pb) -> dict:
    """Phase 14: full width, the small detector against the CPU, two ranks
    against one process, train_detector_torch.py -> detect_torch.py.
    Returns the launches of a full-width step."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = check_detector_train(cuda, ba, fa, ma, pb)
    check_detector_train_vs_cpu(cuda)
    check_detector_dp(cuda)
    check_detector_train_cli(cuda)
    print(f"phase 14 (detector training): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 15. the other detector methods: base, RDN, FGFA, DFF
# ---------------------------------------------------------------------------

METHODS = ("base", "rdn", "fgfa", "dff")
METHOD_CFGS = {m: ROOT / "configs" / "detector" / f"{m}_vidvrd.yaml"
               for m in METHODS}
METHOD_STEPS, METHOD_FRAMES = 2, 8
# the small configurations of tests/test_torch_detector_methods.py
SMALL_METHOD_KW = {"base": {},
                   "rdn": dict(base_stage=2, advanced_stage=1, groups=4,
                               base_num=4, window=3, key_loc=1),
                   "fgfa": dict(window=3, key_loc=1), "dff": {}}
SMALL_METHOD_HW = (64, 96)
# the method's own parameters, beside backbone, RPN and C5/head
METHOD_GROUPS = {"base": ("head.",), "rdn": ("box_head.", "rdn."),
                 "fgfa": ("c5.", "head.", "fgfa."),
                 "dff": ("c5.", "head.", "dff.")}


def method_detector(cfg, generator):
    """The config's detector on the CPU (VidVRD's 35 classes), built by
    train_detector_torch.py's ``build_detector``."""
    import types

    from train_detector_torch import build_detector
    args = types.SimpleNamespace(method=cfg.method,
                                 base_num=cfg.ref_post_nms_top_n)
    return build_detector(args, cfg, 35, tuple(cfg.resnet_layers), generator)


def method_map(det, method, images, dtype, c4=None):
    """The map each method detects on, from the first two frames: C4 of
    frame 1 (base), the fc0 features of three fixed boxes on it (RDN),
    frame 1's aggregate over frames 0-1 (FGFA), frame 1 propagated from
    frame 0 (DFF); from the frames' C4 ``c4`` where given."""
    with torch.no_grad():
        if c4 is None:
            c4 = det.features(images[:2], dtype)
        if method == "fgfa":
            fe = det.fgfa.precompute_frame(c4)
            return det.fgfa.aggregate_test(images[1:2], images[:2], fe, 1)
        if method == "dff":
            return det.dff.propagate(images[1:2], images[:1], c4[:1])
        if method == "rdn":
            h, w = images.shape[1:3]
            rois = torch.tensor([[0.04, 0.05, 0.37, 0.82],
                                 [0.46, 0.16, 0.83, 0.92],
                                 [0.0, 0.0, 1.0, 1.0]],
                                device=images.device) * torch.tensor(
                [w - 1, h - 1, w - 1, h - 1], device=images.device)
            valid = torch.ones(3, dtype=torch.bool, device=images.device)
            return det.frame_fc0(c4[1], rois, valid)
        return c4[1:]


def check_method_full_width(cuda, method, ba, fa, ma, pb) -> dict:
    """Phase 15a for one method at its config's full width (R-101-C4, the
    608 x 1088 canvas of train_detector_torch.py at MIN_SIZE_TRAIN 600,
    VidVRD's 35 classes, the config's reference frames and windows), random
    seeded weights with calibrated frozen norms: METHOD_STEPS train steps of
    one sample (finite losses, every parameter group moved, the last timed,
    its launches, peak memory and busy share), then the method's
    *_detect_video over METHOD_FRAMES frames in fp32 and bf16 (finite, fp32
    outputs of the right shapes, ms a frame, launches). Before the first
    step, bf16 is held piece by piece (``bf16_piece_gaps``: the stem, each
    block of C4, the method's part after C4; each within BF16_DETECT_MAX /
    BF16_DETECT_MEAN of max |x| of its fp32 output, twice those through
    the flow warp); the whole map's bf16 gap is reported beside the gap a
    rounding-sized change of the frames (x (1 + 2^-9 noise)) makes in
    fp32: a random R-101 amplifies any rounding through its blocks.
    Returns the launches by path."""
    from train_detector_torch import DETECT_FNS, method_ref_num
    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        detector_train_step)
    cfg, make_opt = det_step_setup(METHOD_CFGS[method])
    det = method_detector(cfg, torch.Generator().manual_seed(0)).to(cuda)
    n_ref = method_ref_num(method, cfg)
    rng = np.random.default_rng(31)
    raw = det_train_batch(rng, 1, DET_CANVAS, (n_ref, 0, 0), DET_MAX_GT)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in raw.items()
             if k not in ("local", "mem", "glob")}
    batch["ref"] = torch.from_numpy(raw["local"]).to(cuda)
    calibrate_frozen_bn(det, batch["key"], batch["gt_boxes"][0, :4])
    images = np.random.default_rng(32).integers(
        0, 256, (METHOD_FRAMES, *DET_CANVAS, 3), dtype=np.uint8)
    frames = torch.from_numpy(images[:2]).to(cuda)
    pieces = bf16_piece_gaps(det, method, frames)
    limit = {n: (1, 2)[n == "after C4" and method in ("fgfa", "dff")]
             for n in pieces}
    worst = max(pieces, key=lambda n: pieces[n][0] / limit[n])
    mean = max(pieces, key=lambda n: pieces[n][1] / limit[n])
    noise = 1 + 2.0 ** -9 * torch.randn(
        frames.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    ref = method_map(det, method, frames, torch.float32)
    moved = rel_gap(method_map(det, method, frames.float() * noise,
                               torch.float32), ref)
    whole = bf16_map_gap(det, method, frames)
    print(f"{method} bf16, full width, {len(pieces)} pieces each against "
          f"fp32 on its input: largest gap {pieces[worst][0]:.3e} "
          f"({worst}), largest mean gap {pieces[mean][1]:.3e} ({mean}), "
          f"after C4 {pieces['after C4'][0]:.3e} / "
          f"{pieces['after C4'][1]:.3e} (limits {BF16_DETECT_MAX:.0e} / "
          f"{BF16_DETECT_MEAN:.0e} of max |x|, x{limit['after C4']} after "
          f"C4); the whole map: bf16 {whole[0]:.3e} / {whole[1]:.3e}, fp32 "
          f"from frames x (1 + 2^-9 noise) {moved[0]:.3e} / {moved[1]:.3e}")
    bad = {n: g for n, g in pieces.items()
           if g[0] > limit[n] * BF16_DETECT_MAX
           or g[1] > limit[n] * BF16_DETECT_MEAN}
    if bad:
        raise AssertionError(f"{method}: full-width bf16 pieces off fp32: "
                             f"{bad}")
    opt = make_opt(det)
    start = {n: p.detach().clone() for n, p in det.named_parameters()}
    label = (f"{method} ({METHOD_CFGS[method].name}, R-101-C4, "
             f"{DET_CANVAS[0]}x{DET_CANVAS[1]}, {n_ref} ref frame(s), "
             f"TF32 off)")

    def step(i):
        return detector_train_step(det, opt, batch, StepPriorities(0, i, cuda),
                                   image_hw=DET_CANVAS,
                                   post_nms_top_n=DET_POST_NMS, method=method)

    ms = []
    torch.cuda.reset_peak_memory_stats(cuda)
    for i in range(METHOD_STEPS):
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        zero_mega_counts(ma, pb)
        t0 = time.perf_counter()
        losses = step(i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        values = {k: v.item() for k, v in losses.items()}
        if not all(map(math.isfinite, values.values())):
            raise AssertionError(f"{method} train step {i}: {values}")
    train_launches = {**band_counts(ba, fa), **mega_counts(ma, pb)}
    peak = torch.cuda.max_memory_allocated(cuda) / 2**30
    moved = {}
    for group in ("backbone.", "rpn.") + METHOD_GROUPS[method]:
        moved[group[:-1]] = max((p.detach() - start[n]).abs().max().item()
                                for n, p in det.named_parameters()
                                if n.startswith(group))
    print(f"{label} train steps: losses of step {METHOD_STEPS - 1} "
          + ", ".join(f"{k} {v:.4f}" for k, v in values.items())
          + f"; step times (ms, host clock) "
          + ", ".join(f"{t:.2f}" for t in ms) + f"; peak memory {peak:.2f} "
          f"GiB; largest move by group {moved}; kernel launches "
          f"{train_launches}")
    if not all(v > 0 and math.isfinite(v) for v in moved.values()):
        raise AssertionError(f"{method}: a parameter group did not move: "
                             f"{moved}")
    if any(train_launches.values()):
        raise AssertionError(f"{method} train step launched {train_launches}"
                             ": no hand kernel is on this path")
    busy, wall, _ = profile_device(lambda: step(METHOD_STEPS), 1, "step")
    print(f"{label} train step: busy {busy:.2f} ms of {wall:.2f} ms "
          f"({100 * busy / wall:.1f}%, profiler on)")
    del opt, start, batch
    torch.cuda.empty_cache()

    hw = np.asarray(DET_CANVAS, np.float32)
    detect = DETECT_FNS[method]
    det.eval()
    outs, detect_launches = {}, {}
    for dtype in ("float32", "bfloat16", "float32", "bfloat16"):
        torch.cuda.synchronize()
        zero_counts(ba, fa)
        zero_mega_counts(ma, pb)
        t0 = time.perf_counter()
        outs[dtype] = detect(det, images, hw, compute_dtype=dtype)
        seconds = time.perf_counter() - t0
        detect_launches[dtype] = {**band_counts(ba, fa),
                                  **mega_counts(ma, pb)}
        print(f"{method}_detect_video {METHOD_FRAMES} frames {dtype}: "
              f"{1e3 * seconds / METHOD_FRAMES:.2f} ms a frame (host clock, "
              f"to numpy), kernel launches {detect_launches[dtype]}")
    for dtype, out in outs.items():
        for key, v in out.items():
            if (v.dtype != outs["float32"][key].dtype
                    or v.shape != outs["float32"][key].shape
                    or not np.isfinite(v).all()):
                raise AssertionError(f"{method}_detect_video {dtype}: {key} "
                                     f"{v.dtype} {v.shape}")
    if any(any(c.values()) for c in detect_launches.values()):
        raise AssertionError(f"{method}_detect_video launched "
                             f"{detect_launches}")
    out32, out16 = outs["float32"], outs["bfloat16"]
    same = sum(np.array_equal(out16["valid"][f], out32["valid"][f])
               and np.allclose(out16["proposals"][f], out32["proposals"][f],
                               atol=1e-3, rtol=0)
               for f in range(METHOD_FRAMES))
    print(f"{method}_detect_video: proposals {out32['proposals'].shape}, "
          f"{int(out32['valid'].sum())} valid, cls_logits "
          f"{out32['cls_logits'].shape}; frames whose bf16 proposals equal "
          f"fp32's: {same} of {METHOD_FRAMES} (reported, not a check: bf16 "
          f"moves the RPN's near-ties)")
    del det
    torch.cuda.empty_cache()
    return {f"{method}_train_step": train_launches,
            f"{method}_detect_video": detect_launches["float32"],
            f"{method}_detect_video_bf16": detect_launches["bfloat16"]}


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """The largest and the mean |got - ref| over max |ref|."""
    scale = ref.abs().max().item()
    gap = (got.float() - ref.float()).abs()
    return gap.max().item() / scale, gap.mean().item() / scale


def bf16_map_gap(det, method, frames) -> tuple[float, float]:
    """The largest and the mean gap of the method's map on a bf16 copy of
    ``det`` from its fp32 map, over max |fp32|."""
    from vrdone_tpu_torch.utils.precision import cast_floating
    ref = method_map(det, method, frames, torch.float32)
    got = method_map(cast_floating(det, torch.bfloat16), method, frames,
                     torch.bfloat16)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{method}: bf16 map is {got.dtype}")
    return rel_gap(got, ref)


def bf16_piece_gaps(det, method, frames) -> dict:
    """A bf16 copy of ``det`` against ``det`` piece by piece, each fp32
    piece fed the bf16 piece's own input: C4's stem (the input of its first
    block), each residual block of C4, and the method's part after C4 (its
    map from the bf16 copy's C4). Returns piece -> (largest, mean gap) over
    max |fp32|."""
    from vrdone_tpu_torch.models.resnet import Bottleneck
    from vrdone_tpu_torch.utils.precision import cast_floating
    c16 = cast_floating(det, torch.bfloat16)

    def run(model, dtype):
        seen = {}
        hooks = [m.register_forward_hook(
            lambda m, args, out, n=n: seen.__setitem__(n, (args[0], out)))
            for n, m in model.backbone.named_modules()
            if isinstance(m, Bottleneck)]
        try:
            with torch.no_grad():
                c4 = model.features(frames[:2], dtype)
        finally:
            for h in hooks:
                h.remove()
        return c4, seen

    c4, seen = run(c16, torch.bfloat16)
    _, seen32 = run(det, torch.float32)
    blocks = dict(det.backbone.named_modules())
    gaps = {"stem": rel_gap(seen["layer1.block0"][0],
                            seen32["layer1.block0"][0])}
    with torch.no_grad():
        for name, (x, y) in seen.items():
            gaps[name] = rel_gap(y, blocks[name](x.float()))
        gaps["after C4"] = rel_gap(
            method_map(c16, method, frames, torch.bfloat16, c4),
            method_map(det, method, frames, torch.float32, c4.float()))
    return gaps


def small_method_case(method, device):
    """The small detector of tests/test_torch_detector_methods.py (R (1, 1,
    1), 5 classes, seed 1; the RDN head's and the predictors' kernels
    damped to a tenth and RDN's Wg biases raised by 1, as there) on
    ``device``, and a sample of 64 x 96 (seed 24)."""
    from vrdone_tpu_torch.models.base_rcnn import BaseDetector
    from vrdone_tpu_torch.models.detector_train import METHOD_REF_OFFSETS
    from vrdone_tpu_torch.models.flownet import DFFDetector, FGFADetector
    from vrdone_tpu_torch.models.rdn import RDNDetector
    cls = {"base": BaseDetector, "rdn": RDNDetector, "fgfa": FGFADetector,
           "dff": DFFDetector}[method]
    det = cls(num_classes=5, resnet_layers=(1, 1, 1),
              **SMALL_METHOD_KW[method], device=torch.device("cpu"),
              generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in det.named_parameters():
            parts = name.split(".")
            if p.ndim >= 2 and (parts[0] == "rdn" or parts[-2] in (
                    "cls_score", "bbox_pred", "cls_logits")):
                p.mul_(0.1)
            if parts[0] == "rdn" and parts[-2].startswith("Wg") \
                    and parts[-1] == "bias":
                p.add_(1.0)
    rng = np.random.default_rng(24)
    raw = det_train_batch(rng, 1, SMALL_METHOD_HW,
                          (METHOD_REF_OFFSETS[method][2], 0, 0), 3, n_gt=2)
    # labels of the 5 classes on the two valid GT slots
    labels = np.where(raw["gt_valid"][0], raw["gt_labels"][0] % 5 + 1, 0)
    sample = {"key": raw["key"][0], "ref": raw["local"][0],
              "gt_boxes": raw["gt_boxes"][0],
              "gt_labels": labels.astype(np.int32),
              "gt_valid": raw["gt_valid"][0]}
    return det.to(device), sample


def method_losses_and_grads(det, method, sample, device,
                            dtype=torch.float32) -> tuple[dict, dict]:
    """One sample's losses and every parameter's gradient (on the CPU), on
    ``det`` in ``dtype`` (fp64: a float64 copy, frames in fp64)."""
    import functools

    from vrdone_tpu_torch.models.detector_train import (StepPriorities,
                                                        method_detector_losses)
    if dtype != torch.float32:
        det = copy.deepcopy(det).to(dtype)
        det.features = functools.partial(type(det).features, det,
                                         compute_dtype=dtype)
    tb = {k: torch.from_numpy(v).to(device) for k, v in sample.items()}
    losses = method_detector_losses(
        method, det, {"key": tb["key"], "ref": tb["ref"]}, SMALL_METHOD_HW,
        tb["gt_boxes"], tb["gt_labels"], tb["gt_valid"],
        StepPriorities(0, 0, device)(0), post_nms_top_n=SMALL_TRAIN_POST_NMS)
    names = [n for n, _ in det.named_parameters()]
    params = [p for _, p in det.named_parameters()]
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    return ({k: v.item() for k, v in losses.items()},
            {n: (torch.zeros_like(p) if g is None else g).double().cpu()
             for n, p, g in zip(names, params, grads)})


def leaf_errors(got_g: dict, want_g: dict) -> dict:
    """Each leaf's largest gradient gap over 1 + max |g| of ``want_g``."""
    return {n: ((got_g[n] - g).abs().max() / (1 + g.abs().max())).item()
            for n, g in want_g.items()}


def off_leaves(got_g: dict, want_g: dict) -> dict:
    return {n: e for n, e in leaf_errors(got_g, want_g).items()
            if e > DET_GRAD_TOL}


class Branches:
    """The branches a detector's forward takes where rounding can choose
    between two: each ReLU's and leaky ReLU's side (the sign of its input),
    the stem max-pool's pick in each window, and the flow warp's sample
    cells (the floor of its coordinates), in call order. With ``replay``,
    each takes the branch that run took instead."""

    KINDS = ("relu", "leaky_relu", "max_pool", "warp_floor")

    def __init__(self, replay: "Branches | None" = None):
        self.taken = {k: [] for k in self.KINDS}
        self.replay = replay

    def take(self, kind: str, choice: torch.Tensor) -> torch.Tensor:
        if self.replay is not None:
            choice = self.replay.taken[kind][len(self.taken[kind])].to(
                choice.device)
        self.taken[kind].append(choice)
        return choice

    def differing(self, other: "Branches") -> dict:
        """Per kind: the elements whose branch differs from ``other``'s,
        and the elements in all."""
        out = {}
        for kind in self.KINDS:
            a, b = self.taken[kind], other.taken[kind]
            if [x.shape for x in a] != [x.shape for x in b]:
                out[kind] = "calls differ"
                continue
            out[kind] = (sum(int((x.cpu() != y.cpu()).sum())
                             for x, y in zip(a, b)),
                         sum(x.numel() for x in a))
        return out


@contextlib.contextmanager
def taking(branches: Branches):
    """Route F.relu, F.leaky_relu, F.max_pool2d and the warp's floor
    through ``branches`` (relu(x) as x times its side, the pool as a gather
    at its picks), for a diagnostic run."""
    from vrdone_tpu_torch.ops import warp
    saved = (F.relu, F.leaky_relu, F.max_pool2d, warp.grid_sample_bilinear,
             torch.floor)
    relu, leaky, pool, sample, floor = saved

    def relu_(x, inplace=False):
        return x * branches.take("relu", x > 0)

    def leaky_(x, negative_slope=0.01, inplace=False):
        return torch.where(branches.take("leaky_relu", x > 0), x,
                           negative_slope * x)

    def pool_(x, *args, **kw):
        out, idx = pool(x, *args, return_indices=True, **kw)
        idx = branches.take("max_pool", idx)
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(out)

    def floor_(x):
        return branches.take("warp_floor", floor(x))

    def sample_(*args, **kw):
        torch.floor = floor_
        try:
            return sample(*args, **kw)
        finally:
            torch.floor = floor

    F.relu, F.leaky_relu, F.max_pool2d = relu_, leaky_, pool_
    warp.grid_sample_bilinear = sample_
    try:
        yield branches
    finally:
        (F.relu, F.leaky_relu, F.max_pool2d, warp.grid_sample_bilinear,
         torch.floor) = saved


def locate_flips(grads_on, label: str, want_g) -> dict:
    """Where the card's fp32 gradient leaves the CPU's: the branches
    (``Branches``) that differ between the two fp32 runs, then the card's
    run again with the CPU's branches replayed. ``grads_on(on_card)`` runs
    the CPU's or the card's model and returns its gradients. Returns the
    leaves off after the replay."""
    cpu = Branches()
    with taking(cpu):
        grads_on(False)
    card = Branches()
    with taking(card):
        grads_on(True)
    with taking(Branches(cpu)):
        got_g = grads_on(True)
    errs = leaf_errors(got_g, want_g)
    print(f"  {label}: branches that differ card vs CPU (differ, of): "
          f"{card.differing(cpu)}; the card with the CPU's branches: "
          f"worst gradient {max(errs.values()):.3e} "
          f"({max(errs, key=errs.get)})")
    return {n: e for n, e in errs.items() if e > DET_GRAD_TOL}


def check_methods_vs_cpu(cuda) -> None:
    """Phase 15b: each method's small detector on the card against the
    port's CPU run from the same weights, frames and draws: one sample's
    losses within LOSS_TOL and each leaf's gradient within DET_GRAD_TOL x
    (1 + max |g|); where leaves are off (at most FLIP_LEAVES, each within
    FLIP_GRAD_TOL), the branches that differ between the two fp32 runs are
    counted (``locate_flips``), the card's run with the CPU's branches
    replayed must hold every leaf, and so must both devices' fp64
    gradients (as tests/test_torch_detector_methods.py does against JAX);
    and *_detect_video over 4 frames: valid slots equal,
    and on the frames whose window's proposals agree within 1e-3 pixel,
    logits and deltas (and RDN's features) within DETECT_TOL of their
    largest magnitude; in bf16 the map the method detects on within
    BF16_DETECT_MAX / BF16_DETECT_MEAN of max |x| of the CPU's bf16 map and
    of the card's fp32 map (twice those through the flow warp, as JAX's own
    bf16 tests hold FGFA and DFF), and the bf16 detection's outputs fp32,
    finite and of the fp32 detection's shapes."""
    from train_detector_torch import DETECT_FNS
    from vrdone_tpu_torch.models.mega import window_indices
    images = np.random.default_rng(25).integers(
        0, 256, (4, *SMALL_METHOD_HW, 3), dtype=np.uint8)
    hw = np.asarray(SMALL_METHOD_HW, np.float32)
    for method in METHODS:
        cpu_det, sample = small_method_case(method, torch.device("cpu"))
        gpu_det = copy.deepcopy(cpu_det).to(cuda)
        want, want_g = method_losses_and_grads(cpu_det, method, sample,
                                               torch.device("cpu"))
        got, got_g = method_losses_and_grads(gpu_det, method, sample, cuda)
        loss_err = max(abs(got[k] - v) / (1 + abs(v)) for k, v in want.items())
        errs = leaf_errors(got_g, want_g)
        flipped = {n: e for n, e in errs.items() if e > DET_GRAD_TOL}
        worst = max(errs, key=errs.get)
        print(f"small {method} sample, card vs CPU: total_loss "
              f"{got['total_loss']:.6f} (CPU {want['total_loss']:.6f}), worst "
              f"loss rel err {loss_err:.3e}; worst gradient {worst} "
              f"{errs[worst]:.3e}; {len(flipped)} of {len(errs)} leaves off "
              f"{DET_GRAD_TOL:.0e} (limits {FLIP_GRAD_TOL:.0e}, "
              f"{FLIP_LEAVES} leaves)")
        if (loss_err > LOSS_TOL or errs[worst] > FLIP_GRAD_TOL
                or len(flipped) > FLIP_LEAVES):
            raise AssertionError(f"{method}: losses or gradients on the card "
                                 f"differ from the CPU's: {flipped}")
        if flipped:
            replayed = locate_flips(
                lambda on_card: method_losses_and_grads(
                    gpu_det if on_card else cpu_det, method, sample,
                    cuda if on_card else torch.device("cpu"))[1],
                f"small {method}", want_g)
            _, want64 = method_losses_and_grads(
                cpu_det, method, sample, torch.device("cpu"), torch.float64)
            _, got64 = method_losses_and_grads(gpu_det, method, sample, cuda,
                                               torch.float64)
            bad = off_leaves(got64, want64)
            print(f"  small {method} in fp64, card vs CPU: {len(bad)} leaves "
                  f"off")
            if bad or replayed:
                raise AssertionError(f"{method}: gradients on the card differ "
                                     f"from the CPU's with the CPU's branches "
                                     f"({replayed}) or in fp64 ({bad})")
        kw = dict(post_nms_top_n=8)
        if method == "rdn":
            kw = dict(key_post_nms=8)
        elif method == "dff":
            kw["key_interval"] = 2
        ref = DETECT_FNS[method](cpu_det, images, hw, **kw)
        out = DETECT_FNS[method](gpu_det, images, hw, **kw)
        agree = [np.array_equal(out["valid"][f], ref["valid"][f])
                 and np.allclose(out["proposals"][f], ref["proposals"][f],
                                 atol=1e-3, rtol=0) for f in range(4)]
        clean = [f for f in range(4)
                 if method != "rdn" and agree[f]
                 or method == "rdn" and all(agree[int(i)] for i in
                                            window_indices(f, 4, window=3,
                                                           key_loc=1))]
        errs = {k: max((np.abs(out[k][f] - ref[k][f]).max()
                        / np.abs(ref[k]).max() for f in clean), default=0.0)
                for k in out if k not in ("valid", "proposals",
                                          "proposal_scores")}
        print(f"small {method}_detect_video, card vs CPU: {len(clean)} of 4 "
              f"frames with agreeing proposals; worst gap of max |x| {errs}")
        if not clean or any(v > DETECT_TOL for v in errs.values()):
            raise AssertionError(f"{method}_detect_video on the card differs "
                                 f"from the CPU's")
        # bf16: the map on the card against the CPU's bf16 map and against
        # the card's fp32 map, and the bf16 detection's outputs
        frames = torch.from_numpy(images[:2])
        k = 2 if method in ("fgfa", "dff") else 1
        from vrdone_tpu_torch.utils.precision import cast_floating
        want16 = method_map(cast_floating(cpu_det, torch.bfloat16), method,
                            frames, torch.bfloat16)
        got16 = method_map(cast_floating(gpu_det, torch.bfloat16), method,
                           frames.to(cuda), torch.bfloat16)
        rel = rel_gap(got16.cpu(), want16)
        own = bf16_map_gap(gpu_det, method, frames.to(cuda))
        out16 = DETECT_FNS[method](gpu_det, images, hw,
                                   compute_dtype="bfloat16", **kw)
        print(f"small {method} bf16 map, card vs CPU: largest gap "
              f"{rel[0]:.3e}, mean {rel[1]:.3e}; against the card's fp32 "
              f"map {own[0]:.3e}, "
              f"{own[1]:.3e} (limits {k * BF16_DETECT_MAX:.0e}, "
              f"{k * BF16_DETECT_MEAN:.0e} of max |x|)")
        if not (rel[0] <= k * BF16_DETECT_MAX
                and rel[1] <= k * BF16_DETECT_MEAN
                and own[0] <= k * BF16_DETECT_MAX
                and own[1] <= k * BF16_DETECT_MEAN):
            raise AssertionError(f"{method}: the bf16 map is off")
        for key, v in out16.items():
            if (v.dtype != ref[key].dtype or v.shape != ref[key].shape
                    or not np.isfinite(v).all()):
                raise AssertionError(f"{method}_detect_video bf16: {key}")


def check_method_cli(cuda) -> None:
    """Phase 15c: ``train_detector_torch.py --cfg rdn_vidvrd.yaml`` and
    ``fgfa_vidvrd.yaml`` on phase 12's VidVRD-layout corpus from calibrated
    random weights (``--init_ckpt``): 2 iterations with a checkpoint, then
    ``--resume`` to 3; the two methods' processes side by side on the card,
    each exit 0, every logged loss finite, the resumed run starting at
    iteration 2."""
    from vrdone_tpu_torch.convert import params_to_jax
    from vrdone_tpu_torch.detector_config import load_detector_config
    methods = ("rdn", "fgfa")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_frames_corpus(root)
        for method in methods:
            det = method_detector(load_detector_config(
                str(METHOD_CFGS[method])),
                torch.Generator().manual_seed(0)).to(cuda)
            images = torch.from_numpy(np.random.default_rng(33).uniform(
                0, 255, (1, *DET_CANVAS, 3)).astype(np.float32)).to(cuda)
            calibrate_frozen_bn(det, images, torch.tensor(
                [[40.0, 30.0, 400.0, 500.0], [500.0, 100.0, 900.0, 560.0]],
                device=cuda))
            np.savez(root / f"{method}_init.npz",
                     **params_to_jax(det.state_dict()))
            del det, images
        torch.cuda.empty_cache()
        for iters, extra in (("2", []), ("3", ["--resume"])):
            t0 = time.perf_counter()
            procs = {method: subprocess.Popen(
                [sys.executable, str(ROOT / "train_detector_torch.py"),
                 "--anno_dir", str(root / "annotations" / "train"),
                 "--frames_dir", str(root / "frames" / "train"),
                 "--exp_dir", str(root / f"{method}_exp"), "--dataset",
                 "vidvrd", "--cfg", str(METHOD_CFGS[method]), "--init_ckpt",
                 str(root / f"{method}_init.npz"), "--iters", iters,
                 "--save_interval", "2", "--log_interval", "1", "--device",
                 "cuda", *extra], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for method in methods}
            logs = {m: p.communicate(timeout=600)[0]
                    for m, p in procs.items()}
            seconds = time.perf_counter() - t0
            for method, p in procs.items():
                log = logs[method]
                if p.returncode != 0:
                    raise AssertionError(f"train_detector_torch.py --method "
                                         f"{method} failed:\n{log[-4000:]}")
                totals = [float(v) for v in re.findall(r"total_loss: (\S+) ",
                                                       log)]
                print(f"train_detector_torch.py --cfg "
                      f"{METHOD_CFGS[method].name} --iters {iters} "
                      f"{' '.join(extra)} on the card: exit 0 (both methods "
                      f"side by side in {seconds:.1f} s); total_loss by "
                      f"iteration (window median) {totals}")
                if (len(totals) != (1 if extra else 2)
                        or not all(map(math.isfinite, totals))):
                    raise AssertionError(f"{method}: losses {totals}")
                if extra and "at iteration 2" not in log:
                    raise AssertionError(f"{method}: --resume did not start "
                                         f"at iteration 2")
                if not (root / f"{method}_exp" / "detector_2.npz").exists():
                    raise AssertionError(f"{method}: no checkpoint written")


def detector_methods_phase(cuda, ba, fa, ma, pb) -> dict:
    """Phase 15: the four methods at full width, the small ones against
    the CPU, train_detector_torch.py --method rdn / fgfa. Returns the
    launches by path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    for method in METHODS:
        launches.update(check_method_full_width(cuda, method, ba, fa, ma, pb))
    t1 = time.perf_counter()
    check_methods_vs_cpu(cuda)
    t2 = time.perf_counter()
    check_method_cli(cuda)
    t3 = time.perf_counter()
    print(f"phase 15 (detector methods): {t3 - t0:.1f} s (15a {t1 - t0:.1f}, "
          f"15b {t2 - t1:.1f}, 15c {t3 - t2:.1f})")
    return launches


# -- phase 16: RetinaNet and the mask / keypoint RoI heads --------------------

# the VidVRD detector's classes (vrdone_tpu/detector_config.py:25)
RETINA_CLASSES = 35
RETINA_BATCH, RETINA_FRAMES = 2, 4   # train step images; images a route
# the share of anchor-class logits above score_thresh (``prepare_retinanet``)
RETINA_PASS = 1e-2
# the RoI heads' batch an image, their input's side and width, and the RoIs
# an image's inference runs on
HEAD_ROIS, HEAD_RES, HEAD_CH, HEAD_INFER_ROIS = 512, 14, 256, 100
KEYPOINTS = 17
SMALL_RETINA = dict(num_classes=5, resnet_layers=(1, 1, 1, 1),
                    out_channels=16)
SMALL_RETINA_HW = (64, 96)
RETINA_GROUPS = ("body.stem", "body.layer1", "body.layer2", "body.layer3",
                 "body.layer4", "fpn.", "head.cls_tower", "head.bbox_tower",
                 "head.cls_logits", "head.bbox_pred")


def counted(fn, ba, fa, ma, pb):
    """``fn()`` with every kernel's launch count set to 0 just before it,
    and the launches it made."""
    zero_counts(ba, fa)
    zero_mega_counts(ma, pb)
    out = fn()
    torch.cuda.synchronize()
    return out, {**band_counts(ba, fa), **mega_counts(ma, pb)}


@torch.no_grad()
def prepare_retinanet(model, images: torch.Tensor,
                      score_thresh: float = 0.05) -> None:
    """Random seeded weights made usable: the body's frozen norms set from
    ``images`` (``frozen_bn_from_inputs``), then the class scores spread.
    Drawn N(0, 0.01) behind four N(0, 0.01) tower convolutions, every class
    logit lies within about 1e-2 of the prior bias -log 99, under
    ``score_thresh``: no candidate would reach the NMS. So the class
    logits' kernel is scaled by 100 and their bias raised until RETINA_PASS
    of the anchor-class logits of ``images[:1]`` pass."""
    frozen_bn_from_inputs(model.body, lambda: model(images))
    cls = model.head.cls_logits
    cls.weight.mul_(100.0)
    logits = torch.cat([x.flatten() for x in model(images[:1])[0]]).float()
    cut = logits.kthvalue(int((1 - RETINA_PASS) * logits.numel())).values
    cls.bias.add_(math.log(score_thresh / (1 - score_thresh)) - cut)


def retina_sample(rng, b: int, hw, max_gt: int, n_gt: int,
                  num_classes: int) -> tuple:
    """``b`` images of uniform noise with ``n_gt`` of ``max_gt`` GT slots
    valid (``det_train_batch``), labels in 1..num_classes: (images, boxes,
    labels, valid) arrays."""
    raw = det_train_batch(rng, b, hw, (0, 0, 0), max_gt, n_gt=n_gt)
    labels = np.where(raw["gt_valid"],
                      (raw["gt_labels"] - 1) % num_classes + 1, 0)
    return (raw["key"], raw["gt_boxes"], labels.astype(np.int32),
            raw["gt_valid"])


def retina_losses(model, batch) -> dict:
    from vrdone_tpu_torch.models import retinanet as rn
    images, gtb, gtl, gtv = batch
    lg, bb = model(images)
    anchors = torch.from_numpy(rn.all_anchors(images.shape[1:3])).to(
        images.device)
    return rn.retinanet_losses(
        anchors, rn.flatten_levels(lg, model.num_classes),
        rn.flatten_levels(bb, 4), gtb, gtl, gtv,
        num_classes=model.num_classes)


def loss_grads(model, loss_of) -> tuple[dict, dict]:
    """The losses ``loss_of(model)`` gives (a dict, or one tensor) and every
    parameter's gradient of their sum (on the CPU, fp64)."""
    losses = loss_of(model)
    if not isinstance(losses, dict):
        losses = {"loss": losses}
    total = sum(v for k, v in losses.items() if k != "num_pos")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        model.named_parameters()])
    return ({k: v.item() for k, v in losses.items()},
            {n: g.double().cpu() for n, g in zip(names, grads)})


def retina_bf16_pieces(model, images: torch.Tensor) -> dict:
    """A bf16 copy of ``model`` against ``model`` piece by piece, each fp32
    piece fed the bf16 piece's own input: the stem (the input of the first
    block), each residual block of the body, the FPN (from the bf16 C3-C5)
    and the head (from the bf16 P3-P7), the worst level of each. Returns
    piece -> (largest, mean gap) over max |fp32|."""
    from vrdone_tpu_torch.models.detector import _pixel_mean
    from vrdone_tpu_torch.models.resnet import Bottleneck
    from vrdone_tpu_torch.utils.precision import cast_floating
    c16 = cast_floating(model)
    x = (images.float() - _pixel_mean(images.device)).permute(
        0, 3, 1, 2).contiguous()
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in c16.body.named_modules() if isinstance(m, Bottleneck)]
    try:
        with torch.no_grad():
            cs = c16.body(x.bfloat16())
            feats = c16.fpn(*cs)
            logits, deltas = c16.head(feats)
    finally:
        for h in hooks:
            h.remove()

    def worst(pairs):
        gaps = [rel_gap(a, b) for a, b in pairs]
        return max(g[0] for g in gaps), max(g[1] for g in gaps)

    body = model.body
    blocks = dict(body.named_modules())
    with torch.no_grad():
        stem = F.max_pool2d(F.relu(body.stem_bn(body.stem(x))), 3, stride=2,
                            padding=1)
        gaps = {"stem": rel_gap(seen["layer1.block0"][0], stem)}
        for name, (xin, y) in seen.items():
            gaps[name] = rel_gap(y, blocks[name](xin.float()))
        gaps["fpn"] = worst(zip(feats, model.fpn(*(c.float() for c in cs))))
        l32, d32 = model.head([f.float() for f in feats])
        gaps["head"] = worst(zip(logits + deltas, l32 + d32))
    return gaps


def check_retinanet_full_width(cuda, ba, fa, ma, pb) -> dict:
    """Phase 16a: RetinaNet at full width (R-101, FPN at 256 channels, 4
    convs a tower, 9 anchors, VidVRD's 35 classes, 608 x 1088), random
    seeded weights made usable by ``prepare_retinanet``: bf16 held piece by
    piece (``retina_bf16_pieces``, BF16_DETECT_MAX / BF16_DETECT_MEAN of max
    |x|); forward and backward of ``retinanet_losses`` at a batch of 2 with
    16 GT slots (finite losses, a nonzero gradient in every parameter
    group, step times, peak memory, busy share, launches); then
    ``detect_image`` over RETINA_FRAMES images in fp32, in bf16 on the fp32
    parameters and on a ``cast_floating`` copy, timed in turns (ms an
    image, launches; every valid box on the canvas, fp32 outputs). Returns
    the launches by path."""
    from vrdone_tpu_torch.models import retinanet as rn
    from vrdone_tpu_torch.utils.precision import cast_floating
    model = rn.RetinaNet(RETINA_CLASSES, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    raw = retina_sample(np.random.default_rng(41), RETINA_BATCH, CANVAS,
                        DET_MAX_GT, 4, RETINA_CLASSES)
    batch = tuple(torch.from_numpy(a).to(cuda) for a in raw)
    prepare_retinanet(model, batch[0])
    frames = torch.from_numpy(np.random.default_rng(42).integers(
        0, 256, (RETINA_FRAMES, *CANVAS, 3), dtype=np.uint8)).to(cuda)
    label = (f"RetinaNet (R-101, FPN 256, {RETINA_CLASSES} classes, "
             f"{CANVAS[0]}x{CANVAS[1]}, TF32 off)")
    pieces = retina_bf16_pieces(model, frames[:1])
    worst = max(pieces, key=lambda n: pieces[n][0])
    mean = max(pieces, key=lambda n: pieces[n][1])
    print(f"{label} bf16, {len(pieces)} pieces each against fp32 on its "
          f"input: largest gap {pieces[worst][0]:.3e} ({worst}), largest "
          f"mean gap {pieces[mean][1]:.3e} ({mean}); FPN {pieces['fpn'][0]:.3e}"
          f" / {pieces['fpn'][1]:.3e}, head {pieces['head'][0]:.3e} / "
          f"{pieces['head'][1]:.3e} (limits {BF16_DETECT_MAX:.0e} / "
          f"{BF16_DETECT_MEAN:.0e} of max |x|)")
    bad = {n: g for n, g in pieces.items()
           if g[0] > BF16_DETECT_MAX or g[1] > BF16_DETECT_MEAN}
    if bad:
        raise AssertionError(f"RetinaNet: full-width bf16 pieces off fp32: "
                             f"{bad}")

    params = list(model.parameters())

    def step():
        losses = retina_losses(model, batch)
        return losses, torch.autograd.grad(
            losses["loss_retina_cls"] + losses["loss_retina_reg"], params)

    ms = []
    torch.cuda.reset_peak_memory_stats(cuda)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (losses, grads), train_launches = counted(step, ba, fa, ma, pb)
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(cuda) / 2**30
    values = {k: v.item() for k, v in losses.items()}
    names = [n for n, _ in model.named_parameters()]
    largest = {g: max((d.abs().max().item() for n, d in zip(names, grads)
                       if n.startswith(g)), default=0.0)
               for g in RETINA_GROUPS}
    print(f"{label} forward + backward at a batch of {RETINA_BATCH}: losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in values.items())
          + "; times (ms, host clock) " + ", ".join(f"{t:.2f}" for t in ms)
          + f"; peak memory {peak:.2f} GiB; largest |grad| by group "
          + ", ".join(f"{g} {v:.3e}" for g, v in largest.items())
          + f"; kernel launches {train_launches}")
    if not (all(map(math.isfinite, values.values())) and values["num_pos"]
            and all(torch.isfinite(g).all() for g in grads)
            and all(v > 0 for v in largest.values())):
        raise AssertionError(f"RetinaNet step: losses {values}, largest "
                             f"gradients {largest}")
    del grads
    busy, wall, _ = profile_device(step, 1, "step")
    print(f"{label} forward + backward: busy {busy:.2f} ms of {wall:.2f} ms "
          f"({100 * busy / wall:.1f}%, profiler on)")

    routes = {"float32": (model, "float32"),
              "bfloat16 on fp32 parameters": (model, "bfloat16"),
              "bfloat16": (cast_floating(model), "bfloat16")}
    outs, detect_launches = {}, {}
    for route in list(routes) * 2:
        m, dt = routes[route]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[route], detect_launches[route] = counted(
            lambda: [rn.detect_image(m, frames[i], CANVAS, compute_dtype=dt)
                     for i in range(RETINA_FRAMES)], ba, fa, ma, pb)
        seconds = time.perf_counter() - t0
        print(f"detect_image {route}, {RETINA_FRAMES} images: "
              f"{1e3 * seconds / RETINA_FRAMES:.2f} ms an image (host "
              f"clock), valid detections "
              f"{[int(o['valid'].sum()) for o in outs[route]]}, kernel "
              f"launches {detect_launches[route]}")
    h, w = CANVAS
    for route, frame_outs in outs.items():
        for out in frame_outs:
            boxes = out["boxes"][out["valid"]]
            if not (out["boxes"].dtype == out["scores"].dtype == torch.float32
                    and out["valid"].any()
                    and torch.isfinite(out["scores"]).all()
                    and (boxes >= 0).all() and (boxes[:, 2] <= w - 1).all()
                    and (boxes[:, 3] <= h - 1).all()):
                raise AssertionError(f"detect_image {route}: "
                                     f"{out['boxes'].dtype}, boxes {boxes}")
    return {"retinanet_train_step": train_launches,
            "retinanet_detect_image": detect_launches["float32"],
            "retinanet_detect_image_bf16_on_fp32_params":
                detect_launches["bfloat16 on fp32 parameters"],
            "retinanet_detect_image_bf16": detect_launches["bfloat16"]}


def heads_sample(rng, hw, n_rois: int, max_gt: int, n_gt: int,
                 n_kp: int, num_classes: int) -> dict:
    """One image's RoI-head sample on an ``hw`` canvas: ``n_gt`` of
    ``max_gt`` GT slots valid (``det_train_batch``'s boxes), each with the
    ellipse inscribed in its box as its mask and ``n_kp`` keypoints about
    it (some outside, visibility 0-2); ``n_rois`` proposals, the first
    half GT boxes jittered by 10% of their size, the rest anywhere, the
    last 8 padding."""
    raw = det_train_batch(rng, 1, hw, (0, 0, 0), max_gt, n_gt=n_gt)
    gtb, gtv = raw["gt_boxes"][0], raw["gt_valid"][0]
    gtl = np.where(gtv, (raw["gt_labels"][0] - 1) % num_classes + 1, 0)
    h, w = hw
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    bitmaps = np.zeros((max_gt, h, w), np.float32)
    kp = np.zeros((max_gt, n_kp, 3), np.float32)
    for g in range(n_gt):
        x1, y1, x2, y2 = gtb[g]
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (
            y2 - y1) / 2
        bitmaps[g] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
        kp[g, :, 0] = rng.uniform(x1 - 0.1 * rx, x2 + 0.1 * rx, n_kp)
        kp[g, :, 1] = rng.uniform(y1 - 0.1 * ry, y2 + 0.1 * ry, n_kp)
        kp[g, :, 2] = rng.integers(0, 3, n_kp)
    half = n_rois // 2
    src = rng.integers(0, n_gt, half)
    size = gtb[src, 2:] - gtb[src, :2]
    props = np.zeros((n_rois, 4), np.float32)
    props[:half] = gtb[src] + rng.normal(0, 0.1, (half, 4)) * np.tile(size,
                                                                      2)
    xy = rng.uniform(0, 0.8, (n_rois - half, 2)) * (w, h)
    props[half:] = np.concatenate(
        [xy, xy + rng.uniform(0.05, 0.4, (n_rois - half, 2)) * (w, h)], 1)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 1)
    props = np.clip(props, 0, [w - 1, h - 1, w - 1, h - 1]).astype(
        np.float32)
    pvalid = np.arange(n_rois) < n_rois - 8
    return {"props": props, "pvalid": pvalid, "gtb": gtb,
            "gtl": gtl.astype(np.int32), "gtv": gtv, "bitmaps": bitmaps,
            "kp": kp}


def head_losses(s: dict, res: int) -> dict:
    """name -> the loss of that head's output on ``s``'s targets (mask
    BCE on 2*res masks, keypoint cross entropy on 4*res heatmaps)."""
    from vrdone_tpu_torch.models import mask_keypoint as mk
    labels, pos, masks = mk.mask_head_targets(
        s["props"], s["pvalid"], s["gtb"], s["gtl"], s["gtv"], s["bitmaps"],
        2 * res)
    kpos, heat, kvalid = mk.keypoint_head_targets(
        s["props"], s["pvalid"], s["gtb"], s["gtv"], s["kp"], 4 * res)
    return {"mask_head": lambda out: mk.mask_loss(out, labels, pos, masks),
            "keypoint_head": lambda out: mk.keypoint_loss(
                out, heat, kvalid, roi_weight=kpos),
            "positives": (int(pos.sum()), int(kpos.sum()),
                          float(masks[pos > 0].mean()), int(kvalid.sum()))}


def check_heads_full_width(cuda, ba, fa, ma, pb) -> dict:
    """Phase 16b: ``MaskHead(num_classes=36)`` (four 3x3 convs of 256, the
    2x deconvolution, 1x1 logits) and ``KeypointHead(17)`` (eight 3x3
    convs of 512, the k4 s2 p1 deconvolution, 2x bilinear) over HEAD_ROIS
    RoIs of (14, 14, 256) N(0, 1) features, random seeded weights: each
    loss on its targets (``mask_head_targets`` from elliptical GT masks,
    ``keypoint_head_targets``), forward and backward (finite, every kernel
    moved), forward and step times, launches; then inference at
    HEAD_INFER_ROIS RoIs through ``select_mask_probs`` ->
    ``paste_masks_in_image`` and ``heatmaps_to_keypoints`` on the card's
    outputs. Returns the launches by path."""
    from vrdone_tpu_torch.models import mask_keypoint as mk
    gen = torch.Generator(cuda).manual_seed(5)
    heads = {"mask_head": mk.MaskHead(HEAD_CH, RETINA_CLASSES + 1,
                                      device=cuda, generator=gen),
             "keypoint_head": mk.KeypointHead(HEAD_CH, KEYPOINTS,
                                              device=cuda, generator=gen)}
    raw = heads_sample(np.random.default_rng(43), CANVAS, HEAD_ROIS,
                       DET_MAX_GT, 4, KEYPOINTS, RETINA_CLASSES)
    s = {k: torch.from_numpy(v).to(cuda) for k, v in raw.items()}
    feats = torch.randn(HEAD_ROIS, HEAD_RES, HEAD_RES, HEAD_CH,
                        generator=gen, device=cuda)
    losses = head_losses(s, HEAD_RES)
    print(f"RoI heads at {HEAD_ROIS} RoIs of ({HEAD_RES}, {HEAD_RES}, "
          f"{HEAD_CH}) (TF32 off): mask positives, keypoint positives, mean "
          f"mask target on positives, valid keypoints "
          f"{losses['positives']}")
    launches = {}
    for name, head in heads.items():
        params = list(head.parameters())

        def step():
            loss = losses[name](head(feats))
            return loss, torch.autograd.grad(loss, params)

        ms, fwd = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss, grads), launches[f"{name}_train_step"] = counted(
                step, ba, fa, ma, pb)
            ms.append(1e3 * (time.perf_counter() - t0))
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                head(feats)
                torch.cuda.synchronize()
                fwd.append(1e3 * (time.perf_counter() - t0))
        kernels = {n: g.abs().max().item() for (n, p), g in
                   zip(head.named_parameters(), grads) if p.ndim >= 2}
        print(f"{name} at {HEAD_ROIS} RoIs: loss {loss.item():.4f}; forward "
              + ", ".join(f"{t:.2f}" for t in fwd) + " ms, forward + "
              "backward " + ", ".join(f"{t:.2f}" for t in ms)
              + f" ms (host clock); smallest max |grad| of a kernel "
              f"{min(kernels.values()):.3e}; kernel launches "
              f"{launches[f'{name}_train_step']}")
        if not (math.isfinite(loss.item())
                and all(torch.isfinite(g).all() for g in grads)
                and min(kernels.values()) > 0):
            raise AssertionError(f"{name}: loss {loss.item()}, kernels' "
                                 f"gradients {kernels}")

    n = HEAD_INFER_ROIS
    boxes = raw["props"][:n]
    labels = torch.from_numpy(np.random.default_rng(45).integers(
        1, RETINA_CLASSES + 1, n)).to(cuda)
    with torch.no_grad():
        t0 = time.perf_counter()
        probs, launches["mask_head_inference"] = counted(
            lambda: mk.select_mask_probs(heads["mask_head"](feats[:n]),
                                         labels).cpu().numpy(),
            ba, fa, ma, pb)
        maps, launches["keypoint_head_inference"] = counted(
            lambda: heads["keypoint_head"](feats[:n]).cpu().numpy(),
            ba, fa, ma, pb)
        t1 = time.perf_counter()
    masks = mk.paste_masks_in_image(probs, boxes, CANVAS)
    t2 = time.perf_counter()
    xy, scores = mk.heatmaps_to_keypoints(maps, boxes)
    t3 = time.perf_counter()
    print(f"RoI heads inference at {n} RoIs: both heads on the card "
          f"{1e3 * (t1 - t0):.2f} ms (to numpy), paste_masks_in_image "
          f"{1e3 * (t2 - t1):.2f} ms, heatmaps_to_keypoints "
          f"{1e3 * (t3 - t2):.2f} ms (host); mask pixels a RoI "
          f"{masks.sum((1, 2)).mean():.1f}; kernel launches "
          f"{launches['mask_head_inference']}, "
          f"{launches['keypoint_head_inference']}")
    inside = ((xy[..., 0] >= boxes[:, :1]) & (xy[..., 1] >= boxes[:, 1:2])
              & (xy[..., 0] <= boxes[:, 2:3] + 1)
              & (xy[..., 1] <= boxes[:, 3:4] + 1))
    if not (masks.shape == (n, *CANVAS) and masks.dtype == bool
            and masks.any() and np.isfinite(scores).all() and inside.all()):
        raise AssertionError(f"RoI heads inference: masks {masks.shape}, "
                             f"keypoints inside their boxes {inside.mean()}")
    return launches


def check_retina_heads_vs_cpu(cuda) -> None:
    """Phase 16c: small RetinaNet (R (1, 1, 1, 1), FPN 16, 5 classes, 64 x
    96, ``prepare_retinanet`` on the CPU) and small heads (two 3x3 convs of
    16 each, 8 RoIs of (7, 7, 16)) on the card against the same weights on
    the CPU: RetinaNet's levels within DETECT_TOL of max |x|; the losses
    within LOSS_TOL, each leaf's gradient within DET_GRAD_TOL x (1 + max
    |g|), where leaves are off (at most FLIP_LEAVES, each within
    FLIP_GRAD_TOL) the CPU's branches replayed on the card and both
    devices' fp64 gradients must hold every leaf (phase 15b's rule);
    ``detect_image``'s keep, valid and labels equal, boxes and scores within
    DETECT_TOL of max |x|; the bf16 copy's levels within BF16_DETECT_MAX /
    BF16_DETECT_MEAN of max |x| of the CPU's bf16 run."""
    from vrdone_tpu_torch.models import mask_keypoint as mk
    from vrdone_tpu_torch.models import retinanet as rn
    from vrdone_tpu_torch.utils.precision import cast_floating
    cpu = torch.device("cpu")
    model = rn.RetinaNet(**SMALL_RETINA, device=cpu,
                         generator=torch.Generator().manual_seed(1))
    raw = retina_sample(np.random.default_rng(44), 2, SMALL_RETINA_HW, 3, 2,
                        SMALL_RETINA["num_classes"])
    prepare_retinanet(model, torch.from_numpy(raw[0]))
    gen = torch.Generator().manual_seed(6)
    heads = {"mask_head": mk.MaskHead(16, 6, (16, 16), device=cpu,
                                      generator=gen),
             "keypoint_head": mk.KeypointHead(16, 4, (16, 16), device=cpu,
                                              generator=gen)}
    hraw = heads_sample(np.random.default_rng(46), SMALL_RETINA_HW, 16, 3, 2,
                        4, 5)
    feats = torch.randn(16, 7, 7, 16, generator=gen)
    cases = {"RetinaNet": (model, tuple(torch.from_numpy(a) for a in raw),
                           retina_losses)}
    for name, head in heads.items():
        cases[name] = (head, (feats, {k: torch.from_numpy(v)
                                      for k, v in hraw.items()}),
                       lambda m, b, name=name: head_losses(b[1], 7)[name](
                           m(b[0])))

    def on(batch, device, dtype=torch.float32):
        """``batch`` (tensors in tuples and dicts) on ``device``, its
        floating tensors in ``dtype``."""
        if isinstance(batch, dict):
            return {k: on(v, device, dtype) for k, v in batch.items()}
        if isinstance(batch, tuple):
            return tuple(on(v, device, dtype) for v in batch)
        return batch.to(device, dtype if batch.is_floating_point()
                        else batch.dtype)

    for name, (cpu_m, cpu_b, loss_of) in cases.items():
        gpu_m = copy.deepcopy(cpu_m).to(cuda)
        gpu_b = on(cpu_b, cuda)
        if name == "RetinaNet":
            with torch.no_grad():
                want = sum(cpu_m(cpu_b[0]), [])
                got = sum(gpu_m(gpu_b[0]), [])
            fwd = max(rel_gap(g.cpu(), w)[0] for g, w in zip(got, want))
            print(f"small RetinaNet forward, card vs CPU: worst level "
                  f"{fwd:.3e} of max |x| (limit {DETECT_TOL:.0e})")
            if not fwd <= DETECT_TOL:
                raise AssertionError("small RetinaNet forward off the CPU's")
        want, want_g = loss_grads(cpu_m, lambda m: loss_of(m, cpu_b))
        got, got_g = loss_grads(gpu_m, lambda m: loss_of(m, gpu_b))
        loss_err = max(abs(got[k] - v) / (1 + abs(v))
                       for k, v in want.items())
        errs = leaf_errors(got_g, want_g)
        flipped = {n: e for n, e in errs.items() if e > DET_GRAD_TOL}
        worst = max(errs, key=errs.get)
        print(f"small {name}, card vs CPU: losses {got} (CPU {want}), worst "
              f"loss rel err {loss_err:.3e}; worst gradient {worst} "
              f"{errs[worst]:.3e}; {len(flipped)} of {len(errs)} leaves off "
              f"{DET_GRAD_TOL:.0e}")
        if (loss_err > LOSS_TOL or errs[worst] > FLIP_GRAD_TOL
                or len(flipped) > FLIP_LEAVES):
            raise AssertionError(f"{name}: losses or gradients on the card "
                                 f"differ from the CPU's: {flipped}")
        if flipped:
            replayed = locate_flips(
                lambda on_card: loss_grads(
                    gpu_m if on_card else cpu_m,
                    lambda m: loss_of(m, gpu_b if on_card else cpu_b))[1],
                f"small {name}", want_g)
            b64 = {dev: on(cpu_b, dev, torch.float64) for dev in (cpu, cuda)}
            want64 = loss_grads(copy.deepcopy(cpu_m).double(),
                                lambda m: loss_of(m, b64[cpu]))[1]
            got64 = loss_grads(copy.deepcopy(gpu_m).double(),
                               lambda m: loss_of(m, b64[cuda]))[1]
            bad = off_leaves(got64, want64)
            print(f"  small {name} in fp64, card vs CPU: {len(bad)} leaves "
                  f"off")
            if bad or replayed:
                raise AssertionError(f"{name}: gradients on the card differ "
                                     f"from the CPU's with the CPU's branches "
                                     f"({replayed}) or in fp64 ({bad})")

    gpu_m = copy.deepcopy(model).to(cuda)
    hw = SMALL_RETINA_HW
    for i, img in enumerate(raw[0]):
        want = rn.detect_image(model, torch.from_numpy(img), hw)
        got = {k: v.cpu() for k, v in rn.detect_image(
            gpu_m, torch.from_numpy(img), hw).items()}
        errs = {k: rel_gap(got[k], want[k])[0] for k in ("boxes", "scores")}
        print(f"small detect_image {i}, card vs CPU: {int(want['valid'].sum())}"
              f" valid; boxes, scores within {errs} of max |x|")
        if not (torch.equal(got["valid"], want["valid"])
                and torch.equal(got["labels"], want["labels"])
                and want["valid"].sum() > 0
                and all(e <= DETECT_TOL for e in errs.values())):
            raise AssertionError("small detect_image on the card differs "
                                 "from the CPU's")
    images = torch.from_numpy(raw[0])
    with torch.no_grad():
        want = sum(cast_floating(model)(images, torch.bfloat16), [])
        got = sum(cast_floating(gpu_m)(images.to(cuda), torch.bfloat16), [])
    gaps = {f"{kind} P{3 + i % 5}": rel_gap(g.cpu(), w) for i, (kind, g, w)
            in enumerate(zip(["logits"] * 5 + ["deltas"] * 5, got, want))}
    big = max(gaps, key=lambda n: gaps[n][0])
    mean = max(gaps, key=lambda n: gaps[n][1])
    print(f"small RetinaNet bf16 copy, card vs CPU: largest gap "
          f"{gaps[big][0]:.3e} ({big}), largest mean gap {gaps[mean][1]:.3e} "
          f"({mean}) of max |x| (limits {BF16_DETECT_MAX:.0e}, "
          f"{BF16_DETECT_MEAN:.0e}); by level {gaps}")
    big, mean = gaps[big][0], gaps[mean][1]
    if not (got[0].dtype == torch.bfloat16 and big <= BF16_DETECT_MAX
            and mean <= BF16_DETECT_MEAN):
        raise AssertionError("small RetinaNet bf16 off the CPU's")


def retinanet_heads_phase(cuda, ba, fa, ma, pb) -> dict:
    """Phase 16: RetinaNet and the mask / keypoint heads at full width, and
    small ones against the CPU. Returns the launches by path, all 0: no
    TPU kernel lies on these paths."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = check_retinanet_full_width(cuda, ba, fa, ma, pb)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches.update(check_heads_full_width(cuda, ba, fa, ma, pb))
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    check_retina_heads_vs_cpu(cuda)
    t3 = time.perf_counter()
    print(f"phase 16 (RetinaNet, mask and keypoint heads): {t3 - t0:.1f} s "
          f"(16a {t1 - t0:.1f}, 16b {t2 - t1:.1f}, 16c {t3 - t2:.1f})")
    if any(any(c.values()) for c in launches.values()):
        raise AssertionError(f"phase 16 launched {launches}: no hand kernel "
                             f"is on these paths")
    return launches


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card")
    parser.add_argument(
        "--only", choices=("kernels", "detector_train", "detector_methods",
                           "retinanet_heads", "sequence_parallel",
                           "flash_train"),
        default=None,
        help="kernels: build the kernels, hold each against its plain "
             "version at the main paths' shapes and time it (the kernel "
             "checks of phases 1, 2, 7, 8 and 18), print their JSON line and "
             "stop; detector_train: phase 14 alone; detector_methods: phase "
             "15 alone; retinanet_heads: phase 16 alone (no kernel on these "
             "three paths, none built); sequence_parallel: phase 17 alone "
             "(its kernels built); flash_train: phase 18 alone, with the "
             "kernel checks of K7 with its lse, K8 and K9")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    from vrdone_tpu_torch.config import (InferenceConfig, load_yaml_config,
                                         model_config_from_yaml)
    from vrdone_tpu_torch.data.batching import eval_bucket_lengths
    from vrdone_tpu_torch.eval.decode import InferenceRunner, decode_video
    from vrdone_tpu_torch.ops import _build
    from vrdone_tpu_torch.ops import band_attention as ba
    from vrdone_tpu_torch.ops import full_attention as fa
    from vrdone_tpu_torch.ops import masked as mops
    from vrdone_tpu_torch.ops import mega_attention as ma
    from vrdone_tpu_torch.ops import position_bias as pb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    # the card's name and power limit, on a line of their own
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    if args.only == "detector_train":
        print(json.dumps({"detector_train_step": detector_train_phase(
            cuda, ba, fa, ma, pb)}))
        return 0
    if args.only == "detector_methods":
        print(json.dumps(detector_methods_phase(cuda, ba, fa, ma, pb)))
        return 0
    if args.only == "retinanet_heads":
        print(json.dumps(retinanet_heads_phase(cuda, ba, fa, ma, pb)))
        return 0
    if args.only == "sequence_parallel":
        ba._kernel()
        print(json.dumps({"train_step_sp": check_sequence_tensor_parallel(
            cuda, ba, fa)}))
        return 0
    if args.only == "flash_train":
        with ThreadPoolExecutor() as pool:
            list(pool.map(lambda f: f(), (ba._kernel, fa._kernel,
                                          fa._bwd_kernel)))
        for line in ptxas_usage(_build.BUILD_LOG["masked_attention_bwd"][1]):
            print(f"    {line}")
        entries, _ = check_full_backward(cuda, fa, {
            "masked_attention": [], "masked_attention_bf16": []})
        print(json.dumps({"train_step_flash": check_flash_train(cuda, ba,
                                                                fa),
                          "kernels": entries}))
        return 0

    start = last = time.perf_counter()

    def lap(phases: str) -> None:
        """The seconds the phases just run took, and since the start."""
        nonlocal last
        now = time.perf_counter()
        print(f"[time] {phases}: {now - last:.1f} s (script {now - start:.1f}"
              f" s)")
        last = now

    # 1. build: one nvcc per source, all started together; the checks of
    # K7 with its lse, K8, K9, K5 and K6 (phase 2) run while
    # band_attention.cu, the longest build, still compiles
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        band_built = pool.submit(ba._kernel)
        list(pool.map(lambda f: f(), (fa._kernel, fa._bwd_kernel, ma._kernel,
                                      pb._kernel)))
        print(f"K7, K8/K9, K5 and K6 built and loaded in "
              f"{time.perf_counter() - t0:.1f} s; their checks run while "
              "band_attention.cu compiles")
        full_rows = {"masked_attention": [], "masked_attention_bf16": []}
        full_backward, worst_full = check_full_backward(cuda, fa, full_rows)
        mega = check_mega_kernels(cuda, pb, ma)
        band_built.result()
    print(f"kernels built and loaded, and those checks run, in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (seconds, log) in _build.BUILD_LOG.items():
        print(f"  {name}: nvcc {seconds:.1f} s")
        for line in ptxas_usage(log):
            print(f"    {line}")

    # 2. each kernel against its plain version at the slices' shapes: the
    # eval forward's and the train step's, the flash train step's (K7 with
    # its lse, K8, K9), the detector's (K5, K6) and the stream's (K4, and K1
    # and K7 at the stream's shapes)
    kernels = check_kernels(cuda, ba, fa)
    kernels.update(check_bf16_kernels(cuda, ba, fa))
    kernels.update(full_backward)
    for name, err in worst_full.items():
        kernels[name]["by_shape"] += full_rows[name]
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    band_rows = kernels["band_attention"]["by_shape"]
    kernels.update(check_band_backward(cuda, ba, mops, band_rows))
    band16 = kernels["band_attention_bf16"]
    kernels.update(check_band_backward_bf16(cuda, ba, band16["by_shape"]))
    band16["max_abs_err"] = max(r["max_abs_err"]
                                for r in band16["by_shape"])
    kernels.update(mega)
    kernels["band_attention_pe"], pe_alone = check_band_pe(cuda, ba, mops)
    kernels["band_attention_pe_bf16"] = check_band_pe_bf16(cuda, ba)
    stream_worst, alone = check_stream_kernels(cuda, ba, fa, band_rows)
    lap("phases 1-2 (build, kernel checks)")
    for name, err in stream_worst.items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    if args.only == "kernels":
        print(json.dumps({"kernels": [{"name": name, **e}
                                      for name, e in kernels.items()]}))
        return 0

    # 3. the full-width VidVRD forward
    raw = load_yaml_config(str(ROOT / "configs" / "vidvrd.yaml"))
    cfg = model_config_from_yaml(raw)
    cpu_model, gpu_model = build_models(cfg, cuda)
    rng = np.random.default_rng(1)
    x, mask = packed_batch(rng, cfg, B_CHECK, T)
    with torch.inference_mode():
        ref = cpu_model(x, mask)
        out = gpu_model(x.to(cuda), mask.to(cuda))
        for key in ("pred_logits", "pred_masks"):
            err = (out[key].cpu() - ref[key]).abs().max().item()
            print(f"vidvrd forward B={B_CHECK} T={T} {key} "
                  f"{tuple(out[key].shape)}: CUDA vs CPU max_abs_err "
                  f"{err:.3e}")
            if not err <= MODEL_TOL:
                raise AssertionError(f"{key} off by {err}")
        del cpu_model, ref

        x, mask = packed_batch(rng, cfg, B_RATE, T)
        x, mask = x.to(cuda), mask.to(cuda)
        ba.launches = fa.launches = 0
        out = gpu_model(x, mask)
        torch.cuda.synchronize()
        launches = {"band_attention": ba.launches,
                    "masked_attention": fa.launches}
        expect = {"band_attention": cfg.backbone_arch[1] * 2
                  + cfg.backbone_arch[2],
                  "masked_attention": cfg.backbone_arch[1] * 4
                  + cfg.predictor.num_layers * 2}
        print(f"vidvrd forward B={B_RATE} T={T}: kernel launches {launches}")
        if launches != expect:
            raise AssertionError(f"launches {launches}, expected {expect}")
        if not all(torch.isfinite(out[k]).all()
                   for k in ("pred_logits", "pred_masks")):
            raise AssertionError("non-finite outputs at B=128")
        iters = 10
        for _ in range(2):
            gpu_model(x, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            gpu_model(x, mask)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        print(f"vidvrd forward B={B_RATE} T={T}: "
              f"{1e3 * seconds / iters:.2f} ms per forward, "
              f"{B_RATE * iters / seconds:.1f} pairs/s")

    # 4. the eval runner and triplet decoding over four length buckets
    ic = raw["inference_config"]
    infer = InferenceConfig(
        topk=ic["topk"], feat_stride=ic["feat_stride"],
        pred_min_frames=ic["pred_min_frames"], n_max_pair=ic["n_max_pair"],
        viou_th=ic["viou_th"], max_so_pair=cfg.max_so_pair)
    feat_dim = packed_channels(cfg)
    runner = InferenceRunner(cfg, gpu_model, infer, feat_dim, device=cuda)
    lengths = [40, 96, 150, 300, 700, 12, 190, 383]
    buckets = sorted(set(eval_bucket_lengths(
        np.asarray(lengths), cfg.max_seq_len, cfg.max_div_factor).tolist()))
    if buckets != [96, 192, 384, 768]:
        raise AssertionError(f"buckets {buckets}")
    n_triplets = 0
    for v in range(3):
        item = synthetic_video(rng, lengths, feat_dim)
        scores, catids, masks = runner.run_pairs(item["so_features_list"])
        if not all(np.isfinite(s).all() for s in scores):
            raise AssertionError("non-finite scores")
        if [m.shape for m in masks] != [(cfg.predictor.num_queries, t)
                                        for t in lengths]:
            raise AssertionError("mask shapes")
        res = decode_video(item, scores, catids, masks, infer)
        n = 0 if res is None else len(res["triplets"])
        if res is not None and not np.isfinite(res["triple_scores"]).all():
            raise AssertionError("non-finite triplet scores")
        print(f"video {v}: {len(lengths)} pairs over buckets {buckets}, "
              f"{n} triplets decoded")
        n_triplets += n
    print(f"InferenceRunner + decode_video: {n_triplets} triplets")

    lap("phases 3-4 (VidVRD forward, eval runner)")
    # 9. bf16 serving at VidVRD's and VidOR's widths
    bf16_launches = check_bf16_serving(cuda, ba, fa)
    lap("phase 9 (bf16 serving)")

    # 5. the full-width train step: fp32, then bf16 and remat, and both
    # dtypes timed in turns
    state32, train_launches = check_train_step(cfg, raw, cuda, ba, fa)
    train16_launches = check_train_step_bf16(cfg, raw, cuda, ba, fa, state32)
    lap("phase 5 (train steps)")
    del state32
    torch.cuda.empty_cache()
    # 10. bf16 training with use_rel_pe at VidOR local-attention width
    relpe16_launches = check_train_step_relpe_bf16(cuda, ba, fa)
    lap("phase 10 (bf16 rel-PE train step)")
    torch.cuda.empty_cache()
    # 11. VrdONE-X: serving, the reference converter and a train step
    vrdone_x_launches = check_vrdone_x(cuda, ba, fa)
    lap("phase 11 (VrdONE-X)")

    # 6. a bf16 rel-PE train_torch.py (train_torch.py -> eval_torch.py on
    # the card in fp32 runs in phase 12's chain and, under torchrun, in 13)
    check_train_cli(raw, model_over={"use_rel_pe": True, "use_local": True},
                    flags=("--compute_dtype", "bfloat16"))
    lap("phase 6 (train/eval CLIs)")
    # 13. data parallelism: two ranks' steps on the card against one
    # process's, train_torch.py under torchrun (NCCL), multihost eval
    dp_launches = check_dp_train_step(cfg, raw, cuda, ba, fa)
    check_dp_cli(raw)
    lap("phase 13 (data parallelism)")
    # 17. sequence and tensor parallelism: two ranks' sp and tp steps on the
    # card against one process's
    sp_launches = check_sequence_tensor_parallel(cuda, ba, fa)
    lap("phase 17 (sequence and tensor parallelism)")
    # 18. flash training at VidOR width: K7 with its lse, K8 and K9
    flash_launches = check_flash_train(cuda, ba, fa)
    lap("phase 18 (flash training)")
    # 14. MEGA detector training
    det_train_launches = detector_train_phase(cuda, ba, fa, ma, pb)
    lap("phase 14 (MEGA detector training)")
    # 15. the other detector methods: base, RDN, FGFA, DFF
    method_launches = detector_methods_phase(cuda, ba, fa, ma, pb)
    lap("phase 15 (detector methods)")
    # 16. RetinaNet and the mask / keypoint RoI heads
    retina_launches = retinanet_heads_phase(cuda, ba, fa, ma, pb)
    lap("phase 16 (RetinaNet, mask and keypoint heads)")

    # 7. MEGA: detect_video at full width, the small detector against the
    # CPU, detect_torch.py
    det = full_width_detector(cuda)
    detect_launches = check_detect_video(cuda, pb, ma, det)
    check_detect_vs_cpu(cuda)
    check_detect_bf16_vs_cpu(cuda, pb, ma)
    lap("phase 7 (detect_video)")
    # 12. detect_video_tta at full width and against the CPU, then frames
    # to triplets with the port alone
    detect_launches.update(check_detect_tta(cuda, pb, ma, det))
    del det
    torch.cuda.empty_cache()
    check_detect_tta_vs_cpu(cuda)
    check_frames_to_triplets(raw, cuda, ma, pb)
    lap("phase 12 (TTA, frames to triplets)")

    # 8. the streaming runner at VidOR local-attention width
    stream_launches = check_streaming(cuda, ba, fa, pe_alone, alone)
    lap("phase 8 (streaming)")

    band = "vrdone_tpu_torch/csrc/band_attention.cu"
    pallas = "vrdone_tpu/ops/pallas/band_attention.py"
    masked = "vrdone_tpu_torch/csrc/masked_attention.cu"
    masked_bwd = "vrdone_tpu_torch/csrc/masked_attention_bwd.cu"
    flash = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} "
             "({}, via vrdone_tpu/ops/masked.py:203{})")
    sources = {"band_attention": (band, f"{pallas}:42"),
               "band_attention_bf16": (band, f"{pallas}:42 (bf16 operands)"),
               "band_attention_pe": (band, f"{pallas}:42 (with_pe)"),
               "band_attention_pe_bf16": (band, f"{pallas}:42 (with_pe, "
                                          "bf16 operands)"),
               "band_attention_dq": (band, f"{pallas}:112"),
               "band_attention_dkv": (band, f"{pallas}:146"),
               "band_attention_dq_bf16": (band, f"{pallas}:112 (bf16 "
                                          "operands)"),
               "band_attention_dkv_bf16": (band, f"{pallas}:146 (bf16 "
                                           "operands)"),
               "masked_attention": (masked, "vrdone_tpu/ops/masked.py:203"),
               "masked_attention_bf16": (masked, "vrdone_tpu/ops/masked.py:"
                                         "203 (bf16 operands)"),
               "masked_attention_dq": (masked_bwd, flash.format(
                   1456, "_flash_attention_bwd_dq", "")),
               "masked_attention_dkv": (masked_bwd, flash.format(
                   1121, "_flash_attention_bwd_dkv", "")),
               "masked_attention_dq_bf16": (masked_bwd, flash.format(
                   1456, "_flash_attention_bwd_dq", ", bf16 operands")),
               "masked_attention_dkv_bf16": (masked_bwd, flash.format(
                   1121, "_flash_attention_bwd_dkv", ", bf16 operands")),
               "mega_attention": ("vrdone_tpu_torch/csrc/mega_attention.cu",
                                  "vrdone_tpu/ops/pallas/mega_attention.py:56"),
               "mega_attention_bf16": (
                   "vrdone_tpu_torch/csrc/mega_attention.cu",
                   "vrdone_tpu/ops/pallas/mega_attention.py:56 (bf16 "
                   "operands)"),
               "position_bias": ("vrdone_tpu_torch/csrc/position_bias.cu",
                                 "vrdone_tpu/ops/pallas/position_bias.py:95"),
               "bias_factors": ("vrdone_tpu_torch/csrc/position_bias.cu",
                                "vrdone_tpu/ops/pallas/position_bias.py:108 "
                                "(pe_setup, XLA-side: not a TPU kernel)")}
    # launches: the eval forward's for the forward band and full-attention
    # kernels, the train step's for the backward ones (the data-parallel
    # step's, a rank's at half the batch, in launches_by_path; the bf16 train
    # step's for their bf16 instances), detect_video's for the fused
    # set-attention (the bf16 detect_video's for its bf16 instance) and,
    # with the fused attention off, for the position bias, the streaming
    # run's for the bias band kernel, the VidVRD bf16 eval step's for the
    # bf16 instances, the bf16 rel-PE eval step's at VidOR local width for
    # the bias band kernel's bf16 instance; every path, VrdONE-X's eval
    # and train steps, the MEGA detector's train step (none: it takes the
    # dense route), the other detector methods' and phase 16's RetinaNet
    # and RoI-head paths (none) among them, is in launches_by_path
    by_path = {name: {"eval_forward": launches.get(name, 0),
                      "train_step": train_launches.get(name, 0),
                      "train_step_bf16": train16_launches.get(name, 0),
                      "train_step_bf16_rel_pe": relpe16_launches.get(name, 0),
                      "train_step_dp": dp_launches.get(name, 0),
                      "train_step_sp": sp_launches.get(name, 0),
                      **{path: c.get(name, 0)
                         for path, c in flash_launches.items()},
                      "detector_train_step": det_train_launches.get(name, 0),
                      **{path: c.get(name, 0)
                         for path, c in {**method_launches,
                                         **retina_launches}.items()},
                      **{route: c.get(name, 0)
                         for route, c in detect_launches.items()},
                      "stream": stream_launches.get(name, 0),
                      **{f"serve_bf16_{width}": c.get(name, 0)
                         for width, c in bf16_launches.items()},
                      **{path: c.get(name, 0)
                         for path, c in vrdone_x_launches.items()}}
               for name in sources}
    main_path = {"mega_attention": "detect_video",
                 "mega_attention_bf16": "detect_video_bf16",
                 "position_bias": "detect_video_pe_bias",
                 "bias_factors": "detect_video",
                 "band_attention_pe": "stream",
                 "band_attention_pe_bf16": "serve_bf16_vidor_local_rel_pe",
                 "band_attention_bf16": "serve_bf16_vidvrd",
                 "band_attention_dq_bf16": "train_step_bf16",
                 "band_attention_dkv_bf16": "train_step_bf16",
                 "masked_attention_bf16": "serve_bf16_vidvrd",
                 "masked_attention_dq": "train_step_flash",
                 "masked_attention_dkv": "train_step_flash",
                 "masked_attention_dq_bf16": "train_step_flash_bf16",
                 "masked_attention_dkv_bf16": "train_step_flash_bf16"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1],
         "launches": (by_path[name][main_path[name]] if name in main_path
                      else launches[name] if name in launches
                      else train_launches[name]),
         "launches_by_path": by_path[name],
         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
         "bound_by": e["bound_by"], "library_ms": e["library_ms"],
         **({"device_ms": e["device_ms"]} if "device_ms" in e else {}),
         **({"by_shape": e["by_shape"]} if "by_shape" in e else {}),
         "shape": e["shape"]}
        for name, e in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
