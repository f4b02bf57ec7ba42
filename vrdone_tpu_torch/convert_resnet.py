"""A torchvision-format ResNet state dict as the flax trees of the
detector's ResNet-C4 backbone and C5 head (``{"c4": ..., "c5": ...}``), for
seeding detector training from published ImageNet weights
(``models/detector_train.py::graft_backbone``).

Copy of ``conv_w``, ``bn_params``, ``bottleneck_params``, ``stage_params``
and ``convert`` of ``tools/convert_torch_resnet.py``, kept so that the port
imports nothing of the JAX side; ``tests/test_torch_copies.py`` holds each
function's source to the original's. Torch layout: conv weight (C_out,
C_in, K, K); flax: (K, K, C_in, C_out).
"""

from __future__ import annotations

import numpy as np


def conv_w(w):
    return np.asarray(w).transpose(2, 3, 1, 0)


def bn_params(sd, prefix):
    return {
        "weight": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
        "running_mean": np.asarray(sd[prefix + ".running_mean"]),
        "running_var": np.asarray(sd[prefix + ".running_var"]),
    }


def bottleneck_params(sd, prefix):
    p = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = {"conv": {"kernel": conv_w(sd[f"{prefix}.conv{i}.weight"])}}
        p[f"bn{i}"] = bn_params(sd, f"{prefix}.bn{i}")
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample_conv"] = {"conv": {
            "kernel": conv_w(sd[f"{prefix}.downsample.0.weight"])}}
        p["downsample_bn"] = bn_params(sd, f"{prefix}.downsample.1")
    return p


def stage_params(sd, prefix, blocks):
    return {f"block{i}": bottleneck_params(sd, f"{prefix}.{i}")
            for i in range(blocks)}


def convert(sd, layers=(3, 4, 23, 3)):
    """torch state dict -> {"c4": ResNetC4 params, "c5": ResNetC5Head}."""
    c4 = {
        "stem": {"conv": {"kernel": conv_w(sd["conv1.weight"])}},
        "stem_bn": bn_params(sd, "bn1"),
        "layer1": stage_params(sd, "layer1", layers[0]),
        "layer2": stage_params(sd, "layer2", layers[1]),
        "layer3": stage_params(sd, "layer3", layers[2]),
    }
    c5 = {"layer4": stage_params(sd, "layer4", layers[3])}
    return {"c4": c4, "c5": c5}
