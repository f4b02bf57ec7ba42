"""ResNet-C4/C5 of the detection stage, frozen batch norm (counterpart of
``vrdone_tpu/models/resnet.py``).

The modules carry the flax names (``stem``, ``layer1.block0.conv1.conv``,
``bn1.running_var``, ...), so ``convert.py`` maps the JAX parameters one to
one. Activations run NCHW here; the JAX package runs NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

# flax's truncated normal draws from N(0, 1) cut at +-2 and divides by this
# (its standard deviation) so that the kept draws have unit variance
TRUNC_STD = 0.87962566103423978


def init_truncated(w: Tensor, fan_in: int, scale: float,
                   generator: torch.Generator | None) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / fan_in) / TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics, folded to a scale and an offset
    in fp32."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.running_mean = nn.Parameter(torch.zeros(features, device=device))
        self.running_var = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: Tensor) -> Tensor:
        scale = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + 1e-5)
        offset = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class Conv(nn.Module):
    """Square conv with padding k // 2, He-normal init, under ``conv``."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, use_bias: bool = False, *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=kernel // 2, bias=use_bias,
                              device=device)
        with torch.no_grad():
            init_truncated(self.conv.weight, in_ch * kernel * kernel, 2.0,
                           generator)
            if use_bias:
                self.conv.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with frozen BN; ``stride_in_1x1`` puts the stride
    on the first 1x1 (Caffe2 lineage) instead of the 3x3."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4,
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        out_ch = planes * expansion
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv(in_ch, planes, 1, stride=s1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, stride=s3, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv(planes, out_ch, 1, **kw)
        self.bn3 = FrozenBatchNorm(out_ch, device=device)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride=stride, **kw)
            self.downsample_bn = FrozenBatchNorm(out_ch, device=device)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + identity)


class ResStage(nn.Module):
    def __init__(self, in_ch: int, planes: int, blocks: int, stride: int,
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_ch if i == 0 else planes * 4, planes,
                stride=stride if i == 0 else 1, downsample=i == 0,
                stride_in_1x1=stride_in_1x1, device=device,
                generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetC4(nn.Module):
    """Stem + C2..C4: (N, 3, H, W) -> (N, 1024, H/16, W/16).
    layers=(3, 4, 23) is ResNet-101."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23),
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(stride_in_1x1=stride_in_1x1, device=device,
                  generator=generator)
        self.stem = Conv(3, 64, 7, stride=2, device=device,
                         generator=generator)
        self.stem_bn = FrozenBatchNorm(64, device=device)
        self.layer1 = ResStage(64, 64, layers[0], stride=1, **kw)
        self.layer2 = ResStage(256, 128, layers[1], stride=2, **kw)
        self.layer3 = ResStage(512, 256, layers[2], stride=2, **kw)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.stem_bn(self.stem(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        return self.layer3(self.layer2(self.layer1(h)))


class ResNetC5Head(nn.Module):
    """C5 over RoI crops, then the spatial mean taken in fp32:
    (R, 1024, 14, 14) -> (R, 2048)."""

    def __init__(self, blocks: int = 3, stride_in_1x1: bool = False, *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layer4 = ResStage(1024, 512, blocks, stride=2,
                               stride_in_1x1=stride_in_1x1, device=device,
                               generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        h = self.layer4(x)
        return h.float().mean(dim=(2, 3)).to(h.dtype)
