# Copy of vrdone_tpu/detector_config.py with ``import yaml`` moved into
# the loader, kept so that the port imports nothing of vrdone_tpu;
# tests/test_torch_copies.py pins it to the original.
"""Detector configuration schema (the reference's yacs VID tree).

The reference drives its detector fork through a 544-line yacs tree
(datasets/mega/mega_core/config/defaults.py) merged with per-experiment
YAML (configs/MEGA/*.yaml). This module scopes that tree to the knobs our
detector paths actually consume, as one frozen dataclass whose defaults
are the reference defaults (defaults.py:394-463 VID section, solver
:, test DETECTIONS_PER_IMG), and a loader that accepts the
reference's own nested MODEL/SOLVER/TEST YAML layout unchanged — the
reference's config files parse as-is.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DetectorConfig:
    # MODEL.VID.METHOD (defaults.py:395); MODEL.BACKBONE.CONV_BODY
    method: str = "base"              # base | mega | rdn | fgfa | dff
    resnet_layers: tuple[int, ...] = (3, 4, 23)   # R-101-C4
    num_classes: int = 35
    # MODEL.VID.ROI_BOX_HEAD.ATTENTION (:404-410)
    attention_enable: bool = False
    embed_dim: int = 64
    groups: int = 16
    stage: int = 2
    advanced_stage: int = 0
    # MODEL.VID.RPN (:413-415)
    ref_post_nms_top_n: int = 75      # base_num
    # MODEL.VID.MEGA (:429-449)
    mega_window: int = 25             # ALL_FRAME_INTERVAL
    mega_key_loc: int = 12            # KEY_FRAME_LOCATION
    memory_enable: bool = True
    memory_size: int = 25
    global_enable: bool = True
    global_size: int = 10
    global_res_stage: int = 1
    global_shuffle: bool = True
    ref_num_local: int = 2
    ref_num_mem: int = 3
    ref_num_global: int = 2
    ratio: float = 0.2                # advanced_num = base_num * RATIO
    # MODEL.VID.RDN (:418-426)
    rdn_window: int = 37
    rdn_key_loc: int = 18
    rdn_ref_num: int = 2
    rdn_ratio: float = 0.2
    # MODEL.VID.FGFA / DFF (:452-463)
    fgfa_window: int = 19
    fgfa_key_loc: int = 9
    fgfa_ref_num: int = 2
    dff_key_interval: int = 10        # DFF.MAX_OFFSET span
    # SOLVER (reference solver defaults + MEGA config overrides)
    base_lr: float = 0.001
    weight_decay: float = 1e-4
    momentum: float = 0.9
    steps: tuple[int, ...] = (100000,)
    gamma: float = 0.1
    max_iter: int = 150000
    ims_per_batch: int = 2
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3
    bias_lr_factor: float = 2.0
    weight_decay_bias: float = 0.0
    # INPUT (defaults.py:43-45; the MEGA recipes override to (600,)/1000)
    min_size_train: tuple[int, ...] = (800,)
    max_size_train: int = 1333
    # DATASETS (defaults.py DATASETS.TRAIN/TEST; names resolved by the
    # reference's paths_catalog — here kept as labels for the training
    # tools and used to infer the corpus class count)
    datasets_train: tuple[str, ...] = ()
    datasets_test: tuple[str, ...] = ()
    # TEST
    detections_per_img: int = 300

    @property
    def advanced_num(self) -> int:
        """MEGAFeatureExtractor: advanced_num = base_num * RATIO
        (roi_box_feature_extractors.py:514-515)."""
        return int(self.ref_post_nms_top_n * self.ratio)


_METHOD_OF_ARCH = {
    "GeneralizedRCNN": "base",
    "GeneralizedRCNNMEGA": "mega",
    "GeneralizedRCNNRDN": "rdn",
    "GeneralizedRCNNFGFA": "fgfa",
    "GeneralizedRCNNDFF": "dff",
}


def _get(d: dict, *path, default=None):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def load_detector_config(path: str, **overrides) -> DetectorConfig:
    """Parse a detector YAML in the reference's nested layout.

    Accepts the reference's own files (e.g. configs/MEGA/
    vidvrd_R_101_C4_MEGA_1x_2gpu_freq5.yaml) unchanged; unknown keys are
    ignored, absent keys keep the reference defaults. kwargs override
    parsed values last (the CLI hook)."""
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = DetectorConfig()
    up: dict = {}

    method = _get(raw, "MODEL", "VID", "METHOD")
    if method is None:
        arch = _get(raw, "MODEL", "META_ARCHITECTURE")
        method = _METHOD_OF_ARCH.get(arch) if arch else None
    if method is not None:
        up["method"] = method

    body = _get(raw, "MODEL", "BACKBONE", "CONV_BODY")
    if body:
        depth = body.split("-")[1]
        up["resnet_layers"] = {"50": (3, 4, 6),
                               "101": (3, 4, 23),
                               "152": (3, 8, 36)}[depth]

    field_paths = {
        "attention_enable": ("MODEL", "VID", "ROI_BOX_HEAD", "ATTENTION",
                             "ENABLE"),
        "embed_dim": ("MODEL", "VID", "ROI_BOX_HEAD", "ATTENTION",
                      "EMBED_DIM"),
        "groups": ("MODEL", "VID", "ROI_BOX_HEAD", "ATTENTION", "GROUP"),
        "stage": ("MODEL", "VID", "ROI_BOX_HEAD", "ATTENTION", "STAGE"),
        "advanced_stage": ("MODEL", "VID", "ROI_BOX_HEAD", "ATTENTION",
                           "ADVANCED_STAGE"),
        "ref_post_nms_top_n": ("MODEL", "VID", "RPN",
                               "REF_POST_NMS_TOP_N"),
        "mega_window": ("MODEL", "VID", "MEGA", "ALL_FRAME_INTERVAL"),
        "mega_key_loc": ("MODEL", "VID", "MEGA", "KEY_FRAME_LOCATION"),
        "memory_enable": ("MODEL", "VID", "MEGA", "MEMORY", "ENABLE"),
        "memory_size": ("MODEL", "VID", "MEGA", "MEMORY", "SIZE"),
        "global_enable": ("MODEL", "VID", "MEGA", "GLOBAL", "ENABLE"),
        "global_size": ("MODEL", "VID", "MEGA", "GLOBAL", "SIZE"),
        "global_res_stage": ("MODEL", "VID", "MEGA", "GLOBAL",
                             "RES_STAGE"),
        "global_shuffle": ("MODEL", "VID", "MEGA", "GLOBAL", "SHUFFLE"),
        "ref_num_local": ("MODEL", "VID", "MEGA", "REF_NUM_LOCAL"),
        "ref_num_mem": ("MODEL", "VID", "MEGA", "REF_NUM_MEM"),
        "ref_num_global": ("MODEL", "VID", "MEGA", "REF_NUM_GLOBAL"),
        "ratio": ("MODEL", "VID", "MEGA", "RATIO"),
        "rdn_window": ("MODEL", "VID", "RDN", "ALL_FRAME_INTERVAL"),
        "rdn_key_loc": ("MODEL", "VID", "RDN", "KEY_FRAME_LOCATION"),
        "rdn_ref_num": ("MODEL", "VID", "RDN", "REF_NUM"),
        "rdn_ratio": ("MODEL", "VID", "RDN", "RATIO"),
        "fgfa_window": ("MODEL", "VID", "FGFA", "ALL_FRAME_INTERVAL"),
        "fgfa_key_loc": ("MODEL", "VID", "FGFA", "KEY_FRAME_LOCATION"),
        "fgfa_ref_num": ("MODEL", "VID", "FGFA", "REF_NUM"),
        "base_lr": ("SOLVER", "BASE_LR"),
        "weight_decay": ("SOLVER", "WEIGHT_DECAY"),
        "momentum": ("SOLVER", "MOMENTUM"),
        "max_iter": ("SOLVER", "MAX_ITER"),
        "ims_per_batch": ("SOLVER", "IMS_PER_BATCH"),
        "warmup_iters": ("SOLVER", "WARMUP_ITERS"),
        "warmup_factor": ("SOLVER", "WARMUP_FACTOR"),
        "gamma": ("SOLVER", "GAMMA"),
        "bias_lr_factor": ("SOLVER", "BIAS_LR_FACTOR"),
        "weight_decay_bias": ("SOLVER", "WEIGHT_DECAY_BIAS"),
        "detections_per_img": ("TEST", "DETECTIONS_PER_IMG"),
    }
    for name, p in field_paths.items():
        v = _get(raw, *p)
        if v is not None:
            up[name] = v
    def _tuple(v):
        if isinstance(v, str):
            # yacs evals python-tuple strings like "(100000, )"; bare
            # strings (a single dataset name) pass through as-is
            s = v.strip()
            if s.startswith(("(", "[")):
                import ast
                v = ast.literal_eval(s)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,)

    steps = _get(raw, "SOLVER", "STEPS")
    if steps is not None:
        up["steps"] = _tuple(steps)
    mst = _get(raw, "INPUT", "MIN_SIZE_TRAIN")
    if mst is not None:
        up["min_size_train"] = _tuple(mst)
    mxt = _get(raw, "INPUT", "MAX_SIZE_TRAIN")
    if mxt is not None:
        up["max_size_train"] = int(mxt)

    # DATASETS.TRAIN/TEST: yacs python-tuple strings of catalog names
    # (reference paths_catalog.py). The names fix the corpus — and with
    # it the detector class count (vidor.py:20 81 entries incl. bg;
    # vidvrd.py:20 36 entries) — unless num_classes is overridden.
    for field, key in (("datasets_train", "TRAIN"),
                       ("datasets_test", "TEST")):
        v = _get(raw, "DATASETS", key)
        if v is not None:
            up[field] = tuple(str(s) for s in _tuple(v))
    names = " ".join(up.get("datasets_train", ())
                     + up.get("datasets_test", ())).lower()
    if "vidor" in names:
        up["num_classes"] = 80
    elif "vidvrd" in names:
        up["num_classes"] = 35
    elif "vid_" in names or "det_" in names:
        up["num_classes"] = 30    # ImageNet VID (defaults.py NUM_CLASSES 31)
    # explicit MODEL.ROI_BOX_HEAD.NUM_CLASSES wins (the reference counts
    # background there — BASE_RCNN_2gpu.yaml:16 "81 ... including
    # background" — while num_classes here is foreground-only)
    nc = _get(raw, "MODEL", "ROI_BOX_HEAD", "NUM_CLASSES")
    if nc is not None:
        up["num_classes"] = int(nc) - 1

    up.update({k: v for k, v in overrides.items() if v is not None})
    return replace(cfg, **up)


def mega_detector_kwargs(cfg: DetectorConfig) -> dict:
    """Constructor kwargs for models.detector.MegaDetector."""
    return dict(
        num_classes=cfg.num_classes,
        resnet_layers=tuple(cfg.resnet_layers),
        stage=cfg.stage,
        groups=cfg.groups,
        global_res_stage=cfg.global_res_stage,
        global_enable=cfg.global_enable,
        memory_enable=cfg.memory_enable,
        base_num=cfg.ref_post_nms_top_n,
        ratio=cfg.ratio,
        window=cfg.mega_window,
        key_loc=cfg.mega_key_loc,
        global_size=cfg.global_size,
    )
