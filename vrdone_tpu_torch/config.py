"""Configuration schema (mirror of ``vrdone_tpu/config.py``).

The same frozen dataclasses and YAML layout as the JAX package, kept here so
that nothing on the GPU path imports ``vrdone_tpu`` (whose package import
pulls in PyYAML and, below it, JAX). ``yaml`` is imported only inside the
loader. ``tests/test_torch_eval.py`` pins every field, default and derived
property to the original so that the two copies cannot drift.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class PredictorConfig:
    n_input: int = 512
    n_embd: int = 256
    n_head: int = 4
    n_hidden: int = 1024
    num_queries: int = 9
    num_classes: int = 132
    attn_pdrop: float = 0.0
    proj_pdrop: float = 0.0
    path_pdrop: float = 0.1
    cls_prior_prob: float = 0.01
    n_qx_stride: int = 0
    n_kv_stride: int = 1
    num_layers: int = 4
    deep_supervision: bool = True
    enforce_input_project: bool = False


@dataclass(frozen=True)
class ModelConfig:
    visual_dim: int = 1024
    clip_dim: Optional[int] = None
    bbox_entity_dim: int = 8
    bbox_so_dim: int = 5
    embd_dim: int = 512
    num_classes: int = 132
    backbone_arch: tuple[int, int, int] = (2, 2, 3)
    scale_factor: int = 2
    fpn_start_level: int = 0
    max_seq_len: int = 96
    n_mha_win_size: int = 7
    use_abs_pe: bool = False
    use_rel_pe: bool = False
    use_local: bool = False
    max_so_pair: int = 200
    fuse_ks: int = 1
    fuse_head: int = 4
    fuse_qx_stride: int = 1
    fuse_kv_stride: int = 1
    fuse_path_drop: float = 0.1
    n_head: int = 4
    embd_kernel_size: int = 3
    embd_with_ln: bool = True
    dropattn: float = 0.0
    dropout: float = 0.0
    droppath: float = 0.1
    fpn_dim: int = 256
    fpn_with_ln: bool = True
    fpn_norm_first: bool = True
    loss_types: tuple[str, ...] = ("labels", "masks")
    with_fuzzy: bool = False
    scale_range: Optional[float] = None
    with_clip_feature: bool = False
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    # cost / loss coefficients
    cost_class: float = 1.0
    cost_mask: float = 5.0
    cost_dice: float = 5.0
    eos_coef: float = 0.1
    loss_class: float = 1.0
    loss_mask: float = 5.0
    loss_dice: float = 5.0
    # compute dtype for the network body ("float32" | "bfloat16")
    compute_dtype: str = "float32"
    # recompute the forward in the backward (train/loop.py reads both)
    remat: bool = False
    remat_policy: str = "full"
    # a JAX-side batching strategy, exact in deterministic mode: parsed so
    # that every shipped YAML loads, and not read by the port
    stem_stream_batch: bool = False

    @property
    def mha_win_size(self) -> tuple[int, ...]:
        return (self.n_mha_win_size,) * (1 + self.backbone_arch[-1])

    @property
    def fpn_strides(self) -> tuple[int, ...]:
        return tuple(self.scale_factor ** i
                     for i in range(self.fpn_start_level,
                                    self.backbone_arch[-1] + 1))

    @property
    def max_div_factor(self) -> int:
        """Largest stride the padded eval length must divide by
        (reference models/maskvrd.py:57-63)."""
        m = 1
        for s, w in zip(self.fpn_strides, self.mha_win_size):
            stride = s * (w // 2) * 2 if w > 1 else s
            if self.max_seq_len % stride:
                raise ValueError("max_seq_len must be divisible by fpn "
                                 "stride and window size")
            m = max(m, stride)
        return m

    @staticmethod
    def from_dict(d: dict) -> "ModelConfig":
        d = dict(d)
        pred = PredictorConfig(**d.pop("predictor"))
        cost = d.pop("cost_coeff_dict", {})
        loss = d.pop("loss_coeff_dict", {})
        d.pop("with_fuzzy_eval", None)
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "backbone_arch" in kwargs:
            kwargs["backbone_arch"] = tuple(kwargs["backbone_arch"])
        if "loss_types" in kwargs:
            kwargs["loss_types"] = tuple(kwargs["loss_types"])
        return ModelConfig(
            predictor=pred,
            cost_class=cost.get("cost_class", 1.0),
            cost_mask=cost.get("cost_mask", 5.0),
            cost_dice=cost.get("cost_dice", 5.0),
            eos_coef=loss.get("eos_coef", 0.1),
            loss_class=loss.get("loss_class", 1.0),
            loss_mask=loss.get("loss_mask", 5.0),
            loss_dice=loss.get("loss_dice", 5.0),
            **kwargs)


@dataclass(frozen=True)
class InferenceConfig:
    topk: int = 8
    feat_stride: int = 1
    pred_min_frames: int = 2
    n_max_pair: int = 200
    viou_th: float = 0.5
    # largest number of SO pairs packed into one forward
    max_so_pair: int = 200
    # long sequences are padded to max_seq_len * 2**k up to this many buckets
    long_buckets: int = 4


def load_yaml_config(path: str) -> dict:
    """Load a reference-format YAML config and apply the same cross-section
    fixups as the reference entry points (train.py:46-49, eval.py:49-54)."""
    import yaml
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f.read())
    with_clip = cfg.get("dataset_config", {}).get("with_clip_feature", False)
    cfg["model_config"]["with_clip_feature"] = with_clip
    if not with_clip:
        cfg["model_config"].pop("clip_dim", None)
    return cfg


def model_config_from_yaml(cfg: dict) -> ModelConfig:
    return ModelConfig.from_dict(cfg["model_config"])
