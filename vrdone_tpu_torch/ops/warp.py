"""Flow-field feature warping (counterpart of ``vrdone_tpu/ops/warp.py``).

The FGFA and DFF detectors warp reference-frame C4 features along an
optical-flow field: the flow (N, 2, h, w) becomes a normalised sampling
grid, sampled bilinearly with border clamping. The grid is built with the
``align_corners=True`` normalisation (grid = (flow + base) / ((size - 1) /
2) - 1) and sampled with ``align_corners=False``, a half-pixel skew that the
reference has and the JAX package keeps. Feature maps are NCHW, as
everywhere in the port's detector.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def grid_sample_bilinear(feats: Tensor, grid: Tensor,
                         align_corners: bool = False) -> Tensor:
    """``F.grid_sample(mode="bilinear", padding_mode="border")`` as four
    gathers, the JAX package's formula: feats (N, C, H, W), grid (N, Hg, Wg,
    2) normalised xy in [-1, 1]. Returns (N, C, Hg, Wg) in the features'
    dtype; the coordinates run in the grid's dtype, and the lerp weights
    are cast to the features' (bf16 features stay bf16)."""
    n, c, h, w = feats.shape
    if align_corners:
        gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
        gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    else:
        gx = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
        gy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    x0c, x1c = x0.clamp(0, w - 1).long(), (x0 + 1).clamp(0, w - 1).long()
    y0c, y1c = y0.clamp(0, h - 1).long(), (y0 + 1).clamp(0, h - 1).long()
    flat = feats.reshape(n, c, h * w)
    hg, wg = gx.shape[1:]

    def gather(yi: Tensor, xi: Tensor) -> Tensor:
        idx = (yi * w + xi).reshape(n, 1, hg * wg).expand(n, c, hg * wg)
        return flat.gather(2, idx).reshape(n, c, hg, wg)

    v00, v01 = gather(y0c, x0c), gather(y0c, x1c)
    v10, v11 = gather(y1c, x0c), gather(y1c, x1c)
    fx = fx[:, None].to(feats.dtype)
    fy = fy[:, None].to(feats.dtype)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def flow_to_grid(flow: Tensor) -> Tensor:
    """(N, 2, h, w) pixel-displacement flow -> (N, h, w, 2) normalised
    sampling grid: (flow + base_xy) / ((size - 1) / 2) - 1."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    denom = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=flow.dtype,
                         device=flow.device)
    return (flow.permute(0, 2, 3, 1) + base[None]) / denom - 1.0


def warp_features(feats: Tensor, flow: Tensor) -> Tensor:
    """Warp NCHW ``feats`` by an NCHW ``flow``. The sampling coordinates
    run in fp32 at least (a bf16 grid quantises by about 0.26 pixel at C4
    resolution; an fp64 flow keeps fp64); the gathered features keep their
    dtype."""
    coords = torch.promote_types(flow.dtype, torch.float32)
    return grid_sample_bilinear(feats, flow_to_grid(flow.to(coords)))
