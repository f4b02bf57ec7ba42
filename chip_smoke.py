"""Smoke run of the PyTorch port (``vrdone_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the two hand-written CUDA attention kernels from
``vrdone_tpu_torch/csrc`` (nvcc, into ``build/vrdone_tpu_torch``), holds
each against its plain PyTorch version at the shapes of the VidVRD eval
forward and times both, runs the full-width VidVRD ``MaskVRD`` eval forward
(``configs/vidvrd.yaml``, random seeded weights) on the card against the
same weights on the CPU, counts the kernel launches of one forward at
B=128, and drives ``InferenceRunner`` + ``decode_video`` over synthetic
videos whose pairs fall into the 96, 192, 384 and 768 frame buckets. Any
failed check raises. The second-to-last line of output is a JSON object of
per-kernel results; the last is ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits with an error and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-5   # kernel vs plain, fp32, TF32 off: summation order only
MODEL_TOL = 5e-4    # CUDA vs CPU forward through some forty chained layers
B_CHECK, B_RATE, T = 8, 128, 96


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


def compare(kernel, plain) -> tuple[float, float, float]:
    """(max abs error, kernel ms, plain ms), timed plain, kernel, kernel,
    plain so that drift over the run falls on both."""
    err = (kernel() - plain()).abs().max().item()
    p1, k1, k2, p2 = (time_ms(f) for f in (plain, kernel, kernel, plain))
    return err, (k1 + k2) / 2, (p1 + p2) / 2


def attention_inputs(rng, b, tq, tk, c, device):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, c))
                                .astype(np.float32)).to(device)
               for t in (tq, tk, tk))
    lens = rng.integers(1, tk + 1, size=b)
    lens[0] = tk
    mask = torch.from_numpy(np.arange(tk)[None] < lens[:, None]).to(device)
    return q, k, v, mask


def check_kernels(cuda, ba, fa) -> dict:
    rng = np.random.default_rng(0)
    h = 4
    results = {}
    worst = {"band_attention": 0.0, "masked_attention": 0.0}
    for t in (96, 48, 24, 12, 768):
        q, k, v, mask = attention_inputs(rng, 128, t, t, h * 128, cuda)
        kw = dict(n_head=h, window_size=7)
        err, ms, plain_ms = compare(
            lambda: ba.band_attention_cuda(q, k, v, mask, **kw),
            lambda: ba.band_attention_plain(q, k, v, mask, **kw))
        print(f"band_attention B*H=128*4 d=128 w=3 T={t}: max_abs_err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"band kernel off by {err} at T={t}")
        worst["band_attention"] = max(worst["band_attention"], err)
        if t == T:
            results["band_attention"] = (ms, plain_ms)
    for d in (128, 64):
        for tq, tk in ((96, 96), (9, 9), (9, 12), (384, 384)):
            q, k, v, mask = attention_inputs(rng, 128, tq, tk, h * d, cuda)
            err, ms, plain_ms = compare(
                lambda: fa.full_attention_cuda(q, k, v, mask, n_head=h),
                lambda: fa.full_attention_plain(q, k, v, mask, n_head=h))
            print(f"masked_attention B*H=128*4 d={d} Tq={tq} Tk={tk}: "
                  f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"full kernel off by {err} at "
                                     f"d={d} Tq={tq} Tk={tk}")
            worst["masked_attention"] = max(worst["masked_attention"], err)
            if (tq, tk, d) == (T, T, 128):
                results["masked_attention"] = (ms, plain_ms)
    return {name: (worst[name], *results[name]) for name in worst}


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
    c = 2 * cfg.visual_dim + cfg.bbox_so_dim + 2 * cfg.bbox_entity_dim
    lens = rng.integers(2, t + 1, size=b)
    lens[0] = t
    mask = np.arange(t)[None] < lens[:, None]
    x = rng.standard_normal((b, t, c)).astype(np.float32) * mask[..., None]
    return torch.from_numpy(x), torch.from_numpy(mask)


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


def main() -> int:
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    # the card's name and power limit, on a line of their own
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    ba._kernel()
    fa._kernel()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name, (seconds, log) in _build.BUILD_LOG.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: nvcc {seconds:.1f} s; " + " | ".join(usage))

    # 2. each kernel against its plain version at the slice's shapes
    kernels = check_kernels(cuda, ba, fa)

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
    feat_dim = 2 * cfg.visual_dim + cfg.bbox_so_dim + 2 * cfg.bbox_entity_dim
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

    sources = {"band_attention": ("vrdone_tpu_torch/csrc/band_attention.cu",
                                  "vrdone_tpu/ops/pallas/band_attention.py:42"),
               "masked_attention": ("vrdone_tpu_torch/csrc/masked_attention.cu",
                                    "vrdone_tpu/ops/masked.py:203")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
