"""Smoke run of the PyTorch port (``vrdone_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase below
    python3 chip_smoke.py --only kernels  # the build and the kernel checks
                                          # of 1, 2, 7 and 8 (with their
                                          # bf16 ones); no ``ok`` line

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
     spills where this run built them;
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
  6. runs ``train_torch.py`` for one epoch on a tiny synthetic corpus on
     the card, then ``eval_torch.py`` on its checkpoint, and
     ``train_torch.py --compute_dtype bfloat16`` with ``use_rel_pe`` and
     ``use_local`` on the same corpus;
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
     (``BF16_DETECT_MAX``, ``BF16_DETECT_MEAN``), and runs
     ``detect_torch.py`` on the card (bf16, its default);
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
     and one fp32 train step at the config's 20 pairs against the CPU
     (losses within ``LOSS_TOL``), its launches (K1 with lse, K2, K3 7
     each, full attention dense) and its time and profile.
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

Any failed check raises. The second-to-last line of output is a JSON object
of per-kernel results; the last is ``{"ok": true, "device": {...}}``. With
``--only kernels`` the last line is the per-kernel JSON object, without
launch counts.
Without a CUDA device it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
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
RELPE_TRAIN_PAIRS = (2, 48)  # bf16 rel-PE steps: on both devices; timed
# K2/K3 bf16 held and timed alone, (B, H, d, w, T): the bf16 train step's
# band shapes (24 pairs, T = 96, 48, 24, 12) and its 96-pair T = 96, and
# the bf16 rel-PE train step's local S/O mutual layers at VidOR local width
# (48 pairs at max_seq_len 512, 8 heads of 64, window 9)
BWD_BF16_SHAPES = tuple((TRAIN_PAIRS[1], 4, 128, 3, t) for t in (96, 48, 24,
                                                                 12)) + (
    (TRAIN_PAIRS[2], 4, 128, 3, 96), (RELPE_TRAIN_PAIRS[1], 8, 64, 4, 512))
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
    with its lse, timed alone at VidVRD's T=96, to ``band_rows``."""
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
            if headline:
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
            fa.bf16_launches = 0
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
    ``check_train_step`` at the config's 20 pairs (three steps on the card
    and the CPU: losses, step-0 gradients, parameter and EMA drift; the
    launches of a fourth), and the step timed and profiled. Returns the
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

    # three train steps at the config's pairs on both devices, checked as
    # VidVRD's are, then the card's step timed at those pairs
    n_pairs = raw["training_dataset_config"]["num_pairs"]
    num_gt = raw["training_dataset_config"]["proposal_max_preds"]
    state, train_launches = check_train_step(
        cfg, raw, cuda, ba, fa, pairs=(n_pairs, n_pairs), label="vidor_x ")
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


def check_train_step(cfg, raw, cuda, ba, fa, pairs=TRAIN_PAIRS[:2],
                     label: str = ""):
    """Three full-width fp32 train steps at ``pairs[0]`` pairs on the card
    and on the CPU from the same weights, batch and drop-path draws: losses
    within LOSS_TOL, step-0 gradients within STEP_GRAD_TOL, parameters and
    EMA within DRIFT_TOL; then the launches of one step at ``pairs[1]``
    pairs (K1, K2 and K3 fp32 once a band layer, the dense full attention,
    no K7 and no dense band form). Returns the card's train state and the
    launches of that one step per kernel."""
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

    # the step-0 gradients (its first moments, 0.1 g): over the whole model
    # by norm, and the three leaves furthest off for the record (a leaf
    # whose gradient is a sum that nearly cancels, as softmax makes of the
    # key projections', carries a larger share of rounding)
    num = sum(((a - b) ** 2).sum() for a, b in zip(first_grads["cuda"],
                                                  first_grads["cpu"]))
    den = sum((b ** 2).sum() for b in first_grads["cpu"])
    rel = (num / den).sqrt().item()
    top = max(g.abs().max().item() for g in first_grads["cpu"])
    leaves = sorted(((a - b).abs().max().item()
                     / max(b.abs().max().item(), 1e-30), n,
                     b.abs().max().item() / top)
                    for n, a, b in zip(names, first_grads["cuda"],
                                       first_grads["cpu"]))[-3:]
    print(f"{label}step 0 gradients CUDA vs CPU: |dg| / |g| over the model "
          f"{rel:.3e}; worst leaves (max err / leaf max, leaf max / model "
          f"max): " + "; ".join(f"{n} {e:.2e}, {m:.2e}"
                                for e, n, m in reversed(leaves)))
    if rel > STEP_GRAD_TOL:
        raise AssertionError(f"{label}step-0 gradients off by {rel}")
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
    got = {**launches, "dense band form": dense[0],
           "dense full attention": fa.dense_calls}
    blocks = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    expect = {name: 0 for name in got}
    expect.update(band_attention=blocks, band_attention_dq=blocks,
                  band_attention_dkv=blocks,
                  **{"dense full attention": 4 * cfg.backbone_arch[1]
                     + 2 * cfg.predictor.num_layers})
    print(f"{label}train step at {pairs[1]} pairs: kernel launches {got}")
    if got != expect:
        raise AssertionError(f"{label}train launches {got}, expected "
                             f"{expect}")
    return state, launches


def band_counts(ba, fa) -> dict:
    """The launches of the band kernels (K1, K4, K2, K3), fp32 and bf16
    instances apart, and of K7 since the counts were last set to 0."""
    return {"band_attention": ba.launches - ba.bf16_launches,
            "band_attention_bf16": ba.bf16_launches,
            "band_attention_pe": ba.pe_launches - ba.pe_bf16_launches,
            "band_attention_pe_bf16": ba.pe_bf16_launches,
            "band_attention_dq": ba.dq_launches - ba.bf16_dq_launches,
            "band_attention_dq_bf16": ba.bf16_dq_launches,
            "band_attention_dkv": ba.dkv_launches - ba.bf16_dkv_launches,
            "band_attention_dkv_bf16": ba.bf16_dkv_launches,
            "masked_attention": fa.launches}


def zero_counts(ba, fa) -> None:
    ba.launches = ba.bf16_launches = 0
    ba.pe_launches = ba.pe_bf16_launches = 0
    ba.dq_launches = ba.bf16_dq_launches = 0
    ba.dkv_launches = ba.bf16_dkv_launches = 0
    fa.launches = fa.dense_calls = 0


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
                      must_move: str | None = None) -> dict:
    """Three bf16 train steps of ``cfg16`` on ``batch`` on the card against
    the port's bf16 CPU steps from the same weights, batch and drop-path
    draws: losses within BF16_LOSS_TOL, matchings equal or near-ties
    within MATCH_TIE_TOL, step 0's CPU run replaying the card's max-pool
    picks; the masters, EMA and moments stay fp32, and on both devices
    every parameter whose name ends with ``must_move`` has moved. Returns
    the train states by device."""
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
            for _ in range(3):
                train_step(st, tb, step_generator(0, st.step))
        torch.cuda.synchronize()
        ms, peak = {k: [] for k in steps}, {}
        for k in ("fp32", "bf16", "bf16", "fp32"):
            st = steps[k]
            torch.cuda.reset_peak_memory_stats()
            iters = 10
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


def check_train_cli(raw, device: str = "cuda", model_over: dict | None = None,
                    flags: tuple = (), evaluate: bool = True) -> None:
    """train_torch.py for one epoch of a tiny synthetic corpus on the card,
    with ``model_over`` set in the config's model_config and ``flags``
    added, then (with ``evaluate``) eval_torch.py on its last
    checkpoint."""
    import yaml
    from tests.synth_corpus import make_vidvrd_corpus, make_vidvrd_test_corpus
    vis = raw["model_config"]["visual_dim"]
    with tempfile.TemporaryDirectory() as root:
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
        exp = os.path.join(root, "exp")
        common = ["--data_name", "vidvrd", "--cfg_path", cfg_path,
                  "--exp_dir", exp, "--device", device]
        ckpt = os.path.join(exp, "model_last.ckpt")
        runs = [("train_torch.py", list(flags))]
        if evaluate:
            runs.append(("eval_torch.py", ["--ckpt_path", ckpt,
                                           "--topk", "3"]))
        for script, extra in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, str(ROOT / script), *common,
                                *extra], cwd=ROOT, capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"{script} failed:\n{r.stdout[-3000:]}"
                                     f"\n{r.stderr[-3000:]}")
            over = f" with {model_over}" if model_over else ""
            print(f"{' '.join([script, *extra])} on {device}{over}: exit 0 "
                  f"in {time.perf_counter() - t0:.1f} s")
        if not os.path.exists(ckpt):
            raise AssertionError("train_torch.py wrote no checkpoint")
        if not evaluate:
            return
        metrics = dict(re_metric(r.stdout))
        if set(metrics) != set(METRIC_NAMES) or not all(
                map(math.isfinite, metrics.values())):
            raise AssertionError(f"eval_torch.py metrics {metrics}")
        print(f"train_torch.py -> eval_torch.py: {metrics}")


METRIC_NAMES = ("RelDet_mAP", "RelDet_AR@50", "RelDet_AR@100",
                "RelTag_AP@1", "RelTag_AP@5", "RelTag_AP@10")


def re_metric(text: str):
    for name, value in re.findall(
            rf"({'|'.join(METRIC_NAMES)}): ([0-9.eE+-]+|nan)", text):
        yield name, float(value)


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


def check_detect_cli(device: str = "cuda") -> None:
    """detect_torch.py over a tiny synthetic frames directory."""
    from PIL import Image
    rng = np.random.default_rng(10)
    with tempfile.TemporaryDirectory() as root:
        frames = Path(root) / "frames" / "vid0"
        frames.mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (120, 200, 3),
                                         dtype=np.uint8)).save(
                frames / f"{i:06d}.jpg")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "detect_torch.py"), "--frames_dir",
             str(Path(root) / "frames"), "--out_dir", str(Path(root) / "out"),
             "--canvas", "128", "224", "--score_thresh", "0.02",
             "--device", device],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"detect_torch.py failed:\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        if not (Path(root) / "out" / "vid0.pkl").exists():
            raise AssertionError("detect_torch.py wrote no pickle")
        print(f"detect_torch.py on {device} (R-101, 6 frames, its default "
              f"--compute_dtype bfloat16): exit 0 in "
              f"{time.perf_counter() - t0:.1f} s; {r.stdout.strip()}")


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
    global 10), train_torch.py for one epoch of configs/vidvrd.yaml on
    those features, detect_torch.py on the test frames (``--score_thresh
    0.02``, at most CORPUS_TRACKLETS tracklets and at least one),
    extract_proposal_features_torch.py on its proposal pickles, and
    eval_torch.py on the checkpoint (every proposal's features read, six
    finite metrics); the detector and the extractors read one whole
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
        n_props = {}
        for script, args in steps:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, str(ROOT / script), *args],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            print(f"frames to triplets: {script} on {device}: exit "
                  f"{r.returncode} in {time.perf_counter() - t0:.1f} s"
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card")
    parser.add_argument(
        "--only", choices=("kernels",), default=None,
        help="kernels: build the kernels, hold each against its plain "
             "version at the main paths' shapes and time it (the kernel "
             "checks of phases 1, 2, 7 and 8), print their JSON line and "
             "stop")
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

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor() as pool:
        list(pool.map(lambda f: f(), (ba._kernel, fa._kernel, ma._kernel,
                                      pb._kernel)))
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name, (seconds, log) in _build.BUILD_LOG.items():
        print(f"  {name}: nvcc {seconds:.1f} s")
        for line in ptxas_usage(log):
            print(f"    {line}")

    # 2. each kernel against its plain version at the slices' shapes: the
    # eval forward's and the train step's, the detector's (K5, K6) and the
    # stream's (K4, and K1 and K7 at the stream's shapes)
    kernels = check_kernels(cuda, ba, fa)
    kernels.update(check_bf16_kernels(cuda, ba, fa))
    band_rows = kernels["band_attention"]["by_shape"]
    kernels.update(check_band_backward(cuda, ba, mops, band_rows))
    band16 = kernels["band_attention_bf16"]
    kernels.update(check_band_backward_bf16(cuda, ba, band16["by_shape"]))
    band16["max_abs_err"] = max(r["max_abs_err"]
                                for r in band16["by_shape"])
    kernels.update(check_mega_kernels(cuda, pb, ma))
    kernels["band_attention_pe"], pe_alone = check_band_pe(cuda, ba, mops)
    kernels["band_attention_pe_bf16"] = check_band_pe_bf16(cuda, ba)
    stream_worst, alone = check_stream_kernels(cuda, ba, fa, band_rows)
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

    # 9. bf16 serving at VidVRD's and VidOR's widths
    bf16_launches = check_bf16_serving(cuda, ba, fa)

    # 5. the full-width train step: fp32, then bf16 and remat, and both
    # dtypes timed in turns
    state32, train_launches = check_train_step(cfg, raw, cuda, ba, fa)
    train16_launches = check_train_step_bf16(cfg, raw, cuda, ba, fa, state32)
    del state32
    torch.cuda.empty_cache()
    # 10. bf16 training with use_rel_pe at VidOR local-attention width
    relpe16_launches = check_train_step_relpe_bf16(cuda, ba, fa)
    torch.cuda.empty_cache()
    # 11. VrdONE-X: serving, the reference converter and a train step
    vrdone_x_launches = check_vrdone_x(cuda, ba, fa)

    # 6. train_torch.py -> eval_torch.py, and a bf16 rel-PE train_torch.py
    check_train_cli(raw)
    check_train_cli(raw, model_over={"use_rel_pe": True, "use_local": True},
                    flags=("--compute_dtype", "bfloat16"), evaluate=False)

    # 7. MEGA: detect_video at full width, the small detector against the
    # CPU, detect_torch.py
    det = full_width_detector(cuda)
    detect_launches = check_detect_video(cuda, pb, ma, det)
    check_detect_vs_cpu(cuda)
    check_detect_bf16_vs_cpu(cuda, pb, ma)
    check_detect_cli()
    # 12. detect_video_tta at full width and against the CPU, then frames
    # to triplets with the port alone
    detect_launches.update(check_detect_tta(cuda, pb, ma, det))
    del det
    torch.cuda.empty_cache()
    check_detect_tta_vs_cpu(cuda)
    check_frames_to_triplets(raw, cuda, ma, pb)

    # 8. the streaming runner at VidOR local-attention width
    stream_launches = check_streaming(cuda, ba, fa, pe_alone, alone)

    band = "vrdone_tpu_torch/csrc/band_attention.cu"
    pallas = "vrdone_tpu/ops/pallas/band_attention.py"
    masked = "vrdone_tpu_torch/csrc/masked_attention.cu"
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
    # kernels, the train step's for the backward ones (the bf16 train
    # step's for their bf16 instances), detect_video's for the fused
    # set-attention (the bf16 detect_video's for its bf16 instance) and,
    # with the fused attention off, for the position bias, the streaming
    # run's for the bias band kernel, the VidVRD bf16 eval step's for the
    # bf16 instances, the bf16 rel-PE eval step's at VidOR local width for
    # the bias band kernel's bf16 instance; every path, VrdONE-X's eval
    # and train steps among them, is in launches_by_path
    by_path = {name: {"eval_forward": launches.get(name, 0),
                      "train_step": train_launches.get(name, 0),
                      "train_step_bf16": train16_launches.get(name, 0),
                      "train_step_bf16_rel_pe": relpe16_launches.get(name, 0),
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
                 "masked_attention_bf16": "serve_bf16_vidvrd"}
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
