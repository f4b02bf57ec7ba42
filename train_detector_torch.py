"""Train a video detector (any ``--method``: mega, base, rdn, fgfa, dff) on
annotated frames with the PyTorch port (the counterpart of
``tools/train_detector.py``, with its flags and defaults plus
``--device``, cuda by default).

``--method mega`` (the default): each sample is a key frame with its local,
memory and global reference frames through the shared backbone; the RPN
losses on the key frame, the box-head losses on the MEGA-enhanced key
proposals plus the GT boxes, the memory built without gradient. ``base``:
plain single-frame Faster R-CNN. ``rdn``: the key and ``REF_NUM`` sampled
reference frames, the box-head losses on the RDN-enhanced predictions.
``fgfa``: the RPN and the head on the flow-warped, cosine-weighted
aggregate of the reference frames' features. ``dff``: the features of one
reference frame propagated by flow and the scale map. The losses are
``vrdone_tpu_torch/models/detector_train.py``'s, the optimizer the
detector's SGD (``train/optim.py::detector_sgd``). COCO-format images
(``--coco_ann``, reference frames are copies of the key image) and video
annotations (``--anno_dir``) form one pool; batches are grouped by aspect
(one canvas orientation each), scales come from ``--min_sizes``, and the key
and reference frames flip together. Periodic validation runs the method's
own whole-video detection.

Data parallelism takes the place of JAX's dp mesh: under ``torchrun`` each
rank takes its ``batch_size / world_size`` samples of every global batch,
the step sums the ranks' gradients (one flat all-reduce, divided by the
world size), and rank 0 writes the logs and checkpoints.

Checkpoints (the one change to the JAX tool's contract, which writes orbax
directories): every ``--save_interval`` iterations and at the end, rank 0
writes ``detector_<it>.npz``, the weights under their flax keys in the
layout of ``tools/export_params_npz.py``, which ``detect_torch.py
--ckpt_path``, ``convert.load_params`` and ``--init_ckpt`` read, and beside
it ``detector_<it>.state.pt``, the momentum buffers, the iteration and the
data sampler's generator state, which ``--resume`` reads with the newest
``.npz``. An orbax checkpoint of the JAX tool crosses over as an ``.npz``
through ``tools/export_params_npz.py``, run where JAX is.

    python train_detector_torch.py --anno_dir <dir of .json> \
        --frames_dir <dir of video dirs of 000001.jpg..> --exp_dir <dir> \
        --cfg configs/detector/mega_vidvrd.yaml [--backbone_pkl r101.pkl]
    python train_detector_torch.py ... --cfg configs/detector/rdn_vidvrd.yaml
    torchrun --standalone --nproc_per_node 2 train_detector_torch.py ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vrdone_tpu_torch.data.category import get_vocab
from vrdone_tpu_torch.models.base_rcnn import BaseDetector, base_detect_video
from vrdone_tpu_torch.models.detector import MegaDetector, hflip_boxes
from vrdone_tpu_torch.models.detector_train import (
    METHOD_REF_OFFSETS, StepPriorities, detector_train_step, graft_backbone,
    latest_checkpoint, load_finetune_params, restore_detector_checkpoint,
    sample_method_refs, sample_ref_indices, save_detector_checkpoint)
from vrdone_tpu_torch.models.flownet import (DFFDetector, FGFADetector,
                                             dff_detect_video,
                                             fgfa_detect_video)
from vrdone_tpu_torch.models.rdn import RDNDetector, rdn_detect_video
from vrdone_tpu_torch.parallel import mesh
from vrdone_tpu_torch.train.optim import detector_sgd, multistep_schedule
from vrdone_tpu_torch.utils.logging import setup_logger
from vrdone_tpu_torch.utils.metric_logger import MetricLogger


def load_frame(frames_dir, video, idx):
    from PIL import Image
    path = os.path.join(frames_dir, video, f"{idx + 1:06d}.jpg")
    img = np.asarray(Image.open(path), dtype=np.float32)
    return img[..., ::-1]  # BGR


def resize_and_pad(img, boxes, min_size, canvas_hw):
    h, w = img.shape[:2]
    scale = min_size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    from PIL import Image
    im = Image.fromarray(img.astype(np.uint8)[..., ::-1])
    im = im.resize((nw, nh))
    img_r = np.asarray(im, np.float32)[..., ::-1]
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:min(nh, ch), :min(nw, cw)] = img_r[:ch, :cw]
    return canvas, boxes * scale, (min(nh, ch), min(nw, cw))


def coco_index(coco_ann: str, images_dir: str):
    """(path, boxes, category_ids, landscape) samples from a COCO-format
    JSON (e.g. the COCO-in-VidVRD subset from tools/build_coco_subset.py)
    — the reference pre-trains MEGA on COCO-21 + VidVRD jointly
    (datasets/mega/configs/MEGA/vidvrd_..._freq5.yaml)."""
    import json as _json
    from collections import defaultdict as _dd
    with open(coco_ann) as f:
        coco = _json.load(f)
    per_img = _dd(list)
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        per_img[a["image_id"]].append(([x, y, x + w, y + h],
                                       a["category_id"]))
    out = []
    for im in coco["images"]:
        anns = per_img.get(im["id"])
        if not anns:
            continue
        boxes = np.asarray([b for b, _ in anns], np.float32)
        cats = np.asarray([c for _, c in anns], np.int64)
        out.append((os.path.join(images_dir, im["file_name"]), boxes, cats,
                    im.get("width", 2) >= im.get("height", 1)))
    return out


def sample_frames(anno):
    """(frame_idx, boxes (N,4), labels (N,)) for frames with annotations."""
    out = []
    tid_to_cat = {so["tid"]: so["category"]
                  for so in anno["subject/objects"]}
    for fid, frame in enumerate(anno["trajectories"]):
        if not frame:
            continue
        boxes = np.asarray([[b["bbox"]["xmin"], b["bbox"]["ymin"],
                             b["bbox"]["xmax"], b["bbox"]["ymax"]]
                            for b in frame], np.float32)
        out.append((fid, boxes, [tid_to_cat[b["tid"]] for b in frame]))
    return out


# whole-video detection per method, for periodic validation (None: the
# default of evaluate_video_detections, MEGA's detect_video)
DETECT_FNS = {"mega": None, "base": base_detect_video,
              "rdn": rdn_detect_video, "fgfa": fgfa_detect_video,
              "dff": dff_detect_video}


def build_detector(args, cfg, num_classes: int, layers: tuple,
                   generator: torch.Generator):
    """The ``--method`` detector on the CPU, from the config as the JAX tool
    builds it."""
    kw = dict(num_classes=num_classes, resnet_layers=layers,
              device=torch.device("cpu"), generator=generator)
    if args.method == "mega":
        kw.update(base_num=args.base_num, memory_enable=args.n_mem > 0,
                  global_enable=args.n_glob > 0)
        if cfg is not None:
            kw.update(stage=cfg.stage, groups=cfg.groups,
                      global_res_stage=cfg.global_res_stage,
                      ratio=cfg.ratio, window=cfg.mega_window,
                      key_loc=cfg.mega_key_loc, global_size=cfg.global_size,
                      memory_enable=cfg.memory_enable and args.n_mem > 0,
                      global_enable=cfg.global_enable and args.n_glob > 0)
        return MegaDetector(**kw)
    if args.method == "base":
        return BaseDetector(**kw)
    if args.method == "rdn":
        return RDNDetector(
            **kw, base_num=args.base_num,
            base_stage=cfg.stage if cfg else 2,
            advanced_stage=cfg.advanced_stage if cfg else 0,
            groups=cfg.groups if cfg else 16,
            ratio=cfg.rdn_ratio if cfg else 0.2,
            window=cfg.rdn_window if cfg else 37,
            key_loc=cfg.rdn_key_loc if cfg else 18)
    if args.method == "fgfa":
        return FGFADetector(**kw, window=cfg.fgfa_window if cfg else 19,
                            key_loc=cfg.fgfa_key_loc if cfg else 9)
    return DFFDetector(**kw)


def method_ref_num(method: str, cfg) -> int | None:
    """Reference frames a sample of a non-MEGA method (None for MEGA): the
    reference defaults, or the config's RDN / FGFA REF_NUM."""
    if method == "mega":
        return None
    if cfg is not None and method in ("rdn", "fgfa"):
        return getattr(cfg, f"{method}_ref_num")
    return METHOD_REF_OFFSETS[method][2]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--anno_dir", default=None,
                   help="video annotation JSONs (VidVRD/VidOR mode)")
    p.add_argument("--frames_dir", default=None)
    p.add_argument("--coco_ann", default=None,
                   help="COCO-format instances JSON (image mode; ids must "
                        "already be dataset entity ids, see "
                        "tools/build_coco_subset.py)")
    p.add_argument("--images_dir", default=None)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--dataset", choices=["vidvrd", "vidor"],
                   default="vidvrd")
    p.add_argument("--method", default="mega",
                   choices=["mega", "base", "rdn", "fgfa", "dff"],
                   help="training scheme (reference MODEL.VID.METHOD)")
    p.add_argument("--iters", type=int, default=150000)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--min_size", type=int, default=600)
    p.add_argument("--min_sizes", type=int, nargs="+", default=None,
                   help="multi-scale training: short-side sizes sampled "
                        "per iteration (reference INPUT.MIN_SIZE_TRAIN "
                        "tuple); overrides --min_size")
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 1088))
    p.add_argument("--max_gt", type=int, default=16)
    p.add_argument("--n_local", type=int, default=2,
                   help="local ref frames (reference REF_NUM_LOCAL)")
    p.add_argument("--n_mem", type=int, default=3,
                   help="memory ref frames (reference REF_NUM_MEM)")
    p.add_argument("--n_glob", type=int, default=2,
                   help="global ref frames (reference REF_NUM_GLOBAL)")
    p.add_argument("--base_num", type=int, default=75,
                   help="ref proposals per frame (REF_POST_NMS_TOP_N)")
    p.add_argument("--post_nms_top_n", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=1,
                   help="samples per step, the global batch: under "
                        "torchrun each rank takes batch_size / world_size "
                        "of them (reference IMS_PER_BATCH over DDP ranks)")
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--save_interval", type=int, default=10000)
    p.add_argument("--eval_interval", type=int, default=0,
                   help=">0: run detector evaluation on --val_anno_dir "
                        "every N iters")
    p.add_argument("--val_anno_dir", default=None)
    p.add_argument("--val_frames_dir", default=None)
    p.add_argument("--val_videos", type=int, default=5,
                   help="videos per validation sweep")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resnet_layers", type=str, default="3,4,23",
                   help="C2,C3,C4 block counts (3,4,23 = R-101)")
    p.add_argument("--cfg", default=None,
                   help="detector YAML in the reference's nested layout "
                        "(configs/detector/*.yaml; the reference's own "
                        "configs/MEGA/*.yaml parse too). CLI flags set "
                        "to non-default values override it.")
    p.add_argument("--backbone_pkl", default=None,
                   help="converted torchvision ResNet pickle "
                        "(convert_torch_resnet_torch.py or "
                        "tools/convert_torch_resnet.py) to seed C4/C5 — "
                        "replaces catalog://ImageNetPretrained")
    p.add_argument("--init_ckpt", default=None,
                   help="detector .npz to finetune from (weights-only; "
                        "reference finetune_mega.py): a detector_<it>.npz "
                        "of this tool, or an orbax checkpoint of "
                        "tools/train_detector.py exported by "
                        "tools/export_params_npz.py")
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue from the newest detector_<it>.npz in "
                        "--exp_dir with its detector_<it>.state.pt, "
                        "restoring the momentum buffers, the iteration and "
                        "the data sampler's generator")
    p.add_argument("--lr_rate", type=float, default=1.0,
                   help="finetune lr multiplier "
                        "(reference finetune_mega.py:93-96)")
    p.add_argument("--frame_stride", type=int, default=1,
                   help="sample every Nth annotated frame (reference "
                        "VidVRDtrain_freq5 image-index lists use 5)")
    p.add_argument("--hflip_prob", type=float, default=0.5,
                   help="train-time random horizontal flip (reference "
                        "INPUT.HORIZONTAL_FLIP_PROB_TRAIN, transforms/"
                        "build.py:9,41); flips the key and all reference "
                        "frames of a sample together")
    p.add_argument("--group_aspect", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="aspect-ratio grouped batching (reference "
                        "GroupedBatchSampler / ASPECT_RATIO_GROUPING): "
                        "each batch is all-landscape or all-portrait and "
                        "uses a matching canvas orientation")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the train step, e.g. cuda or cpu "
                        "(under torchrun cuda is cuda:LOCAL_RANK)")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    cfg = None
    if args.cfg:
        from vrdone_tpu_torch.detector_config import load_detector_config
        cfg = load_detector_config(args.cfg)
        for name, v in (("method", cfg.method), ("lr", cfg.base_lr),
                        ("iters", cfg.max_iter),
                        ("base_num", cfg.ref_post_nms_top_n),
                        ("n_local", cfg.ref_num_local),
                        ("n_mem", cfg.ref_num_mem),
                        ("n_glob", cfg.ref_num_global),
                        ("batch_size", cfg.ims_per_batch),
                        ("resnet_layers",
                         ",".join(map(str, cfg.resnet_layers)))):
            if getattr(args, name) == p.get_default(name):
                setattr(args, name, v)
    rank, world, device = mesh.join_world(args.device, False)
    try:
        train(p, args, cfg, rank, world, device)
    finally:
        mesh.shutdown()


def train(p, args, cfg, rank: int, world: int, device: torch.device) -> None:
    entity_vocab, _ = get_vocab(args.dataset)
    name_to_id = {v: k for k, v in entity_vocab.items()}
    num_classes = len(entity_vocab) - 1

    os.makedirs(args.exp_dir, exist_ok=True)
    logger = setup_logger("TrainDetector",
                          os.path.join(args.exp_dir, "logfile"),
                          distributed_rank=rank)

    if args.min_sizes is None:
        if cfg is not None and args.min_size == p.get_default("min_size"):
            args.min_sizes = [int(s) for s in cfg.min_size_train]
        else:
            args.min_sizes = [args.min_size]
    args.min_size = args.min_sizes[0]

    layers = tuple(int(x) for x in args.resnet_layers.split(","))
    method = args.method
    n_refs = method_ref_num(method, cfg)

    rng = np.random.default_rng(args.seed)
    if not (args.coco_ann or args.anno_dir):
        raise SystemExit("need --coco_ann and/or --anno_dir")

    # datasets concatenate (reference DATASETS.TRAIN tuples): any mix of
    # COCO-image and video-annotation sources forms one sample pool
    coco_samples, index, annos = [], [], {}
    if args.coco_ann:
        if not args.images_dir:
            raise SystemExit("--images_dir required with --coco_ann")
        coco_samples = coco_index(args.coco_ann, args.images_dir)
        logger.info(f"COCO source: {len(coco_samples)} images")
    if args.anno_dir:
        if not args.frames_dir:
            raise SystemExit("--frames_dir required with --anno_dir")
        videos = sorted(v[:-5] for v in os.listdir(args.anno_dir)
                        if v.endswith(".json"))
        for v in videos:
            with open(os.path.join(args.anno_dir, v + ".json")) as f:
                annos[v] = json.load(f)
        index = [(v, *s) for v in videos
                 for s in sample_frames(annos[v])[::args.frame_stride]]
        logger.info(f"video source: {len(videos)} videos, {len(index)} "
                    f"frames (stride {args.frame_stride})")

    def plan_sample(i):
        """The sample's source and frames, drawing from ``rng`` as the JAX
        tool's loader does (a video sample's reference frames), without
        reading an image."""
        if i < len(coco_samples):
            path, boxes, cats_ids, _ = coco_samples[i]
            return ("coco", path, boxes, np.asarray(cats_ids, np.int32))
        v, fid, boxes, cats = index[i - len(coco_samples)]
        labels = np.asarray([name_to_id[c] for c in cats], np.int32)
        seg_len = len(annos[v]["trajectories"])
        if method != "mega":
            refs = {"local": sample_method_refs(rng, method, fid, seg_len,
                                                ref_num=n_refs),
                    "mem": [], "glob": []}
        else:
            refs = sample_ref_indices(rng, fid, seg_len,
                                      n_local=args.n_local, n_mem=args.n_mem,
                                      n_glob=args.n_glob)
        return ("video", v, fid, refs, boxes, labels)

    def load_plan(plan):
        """(key, local, mem, glob, boxes, labels), a method's reference
        frames in local: COCO image mode's reference frames are copies of
        the key frame (reference vid_mega.py:65-73, vid_rdn.py:34-35)."""
        if plan[0] == "coco":
            from PIL import Image
            _, path, boxes, cats = plan
            img = np.asarray(Image.open(path).convert("RGB"),
                             np.float32)[..., ::-1]
            if method != "mega":
                return img, [img] * n_refs, [], [], boxes, cats
            return (img, [img] * args.n_local, [img] * args.n_mem,
                    [img] * args.n_glob, boxes, cats)
        _, v, fid, refs, boxes, labels = plan
        return (load_frame(args.frames_dir, v, fid),
                *([load_frame(args.frames_dir, v, int(j)) for j in refs[k]]
                  for k in ("local", "mem", "glob")),
                boxes, labels)

    n_samples = len(coco_samples) + len(index)
    sample_landscape = [s[3] for s in coco_samples] + \
        [annos[v]["width"] >= annos[v]["height"] for v, *_ in index]

    # aspect-ratio groups (reference GroupedBatchSampler): homogeneous
    # batches, one canvas orientation per group
    lo, hi = min(args.canvas), max(args.canvas)
    canvas_of = {True: (lo, hi), False: (hi, lo)}   # landscape / portrait
    if args.group_aspect:
        groups = {g: [i for i in range(n_samples)
                      if sample_landscape[i] == g]
                  for g in (True, False)}
        groups = {g: ix for g, ix in groups.items() if ix}
    else:
        canvas_of = {True: tuple(args.canvas), False: tuple(args.canvas)}
        groups = {True: list(range(n_samples))}
    group_keys = sorted(groups)
    group_weights = np.asarray([len(groups[g]) for g in group_keys],
                               np.float64)
    group_weights /= group_weights.sum()
    logger.info("aspect groups: " + ", ".join(
        f"{'landscape' if g else 'portrait'}={len(groups[g])}"
        for g in group_keys))

    def pack(img, boxes, ref_imgs, canvas_hw, min_size):
        canvas, boxes_r, _ = resize_and_pad(img, boxes, min_size,
                                            canvas_hw)
        packed = []
        for group in ref_imgs:
            cs = [resize_and_pad(r, np.zeros((0, 4), np.float32),
                                 min_size, canvas_hw)[0]
                  for r in group]
            packed.append(np.stack(cs) if cs else
                          np.zeros((0, *canvas_hw, 3), np.float32))
        return canvas, boxes_r, packed

    # per-(aspect-group, scale) canvases: the --canvas dims are the first
    # scale's; other scales get proportional canvases rounded up to 32
    base_ms = args.min_sizes[0]

    def round32(x):
        return int(np.ceil(x / 32) * 32)

    canvas_hw_of = {
        (g, ms): tuple(round32(d * ms / base_ms) for d in canvas_of[g])
        for g in group_keys for ms in args.min_sizes}
    if len(args.min_sizes) > 1:
        logger.info(f"multi-scale training: min_sizes={args.min_sizes}, "
                    f"canvases={canvas_hw_of}")

    # the JAX tool loads its first sample to trace its init: that draw
    plan_sample(groups[group_keys[0]][0])
    t0 = time.time()
    det = build_detector(args, cfg, num_classes, layers,
                         torch.Generator().manual_seed(args.seed))
    n_params = sum(x.numel() for x in det.parameters())
    logger.info(f"detector params: {n_params} "
                f"(init {time.time() - t0:.1f}s)")
    if args.backbone_pkl:
        import pickle
        with open(args.backbone_pkl, "rb") as f:
            graft_backbone(det, pickle.load(f))
        logger.info(f"backbone seeded from {args.backbone_pkl}")
    if args.init_ckpt:
        load_finetune_params(det, args.init_ckpt)
        logger.info(f"finetuning from {args.init_ckpt}")
    det = det.to(device)

    args.lr *= args.lr_rate     # finetune rescale (finetune_mega.py:93-96)
    schedule = multistep_schedule(
        args.lr,
        warmup_steps=cfg.warmup_iters if cfg else 500,
        milestones=(tuple(cfg.steps) if cfg else
                    (int(args.iters * 2 / 3), int(args.iters * 8 / 9))),
        gamma=cfg.gamma if cfg else 0.1,
        warmup_start_lr=args.lr * (cfg.warmup_factor if cfg else 1 / 3))
    optimizer = detector_sgd(
        schedule, det.named_parameters(),
        momentum=cfg.momentum if cfg else 0.9,
        weight_decay=cfg.weight_decay if cfg else 1e-4,
        bias_lr_factor=cfg.bias_lr_factor if cfg else 2.0,
        weight_decay_bias=cfg.weight_decay_bias if cfg else 0.0)
    rows = mesh.local_batch_slice(args.batch_size)
    logger.info(f"batch {args.batch_size} over {world} rank(s) "
                f"({rows.stop - rows.start} a rank), method={method}, "
                f"device {device}")

    def make_batch(gk, ms):
        """The global batch's draws, as the JAX tool makes them; only this
        rank's rows read and pack their images."""
        bs, g = args.batch_size, args.max_gt
        members = groups[gk]
        n = rows.stop - rows.start
        batch = {"key": [], "local": [], "mem": [], "glob": [],
                 "gt_boxes": np.zeros((n, g, 4), np.float32),
                 "gt_labels": np.zeros((n, g), np.int32),
                 "gt_valid": np.zeros((n, g), bool)}
        for i in range(bs):
            plan = plan_sample(members[int(rng.integers(0, len(members)))])
            flip = rng.random() < args.hflip_prob
            if not rows.start <= i < rows.stop:
                continue
            img, loc_i, mem_i, glob_i, boxes, cats = load_plan(plan)
            if flip:
                boxes = hflip_boxes(np.asarray(boxes, np.float32),
                                    img.shape[1])
                img = img[:, ::-1]
                loc_i = [r[:, ::-1] for r in loc_i]
                mem_i = [r[:, ::-1] for r in mem_i]
                glob_i = [r[:, ::-1] for r in glob_i]
            canvas, boxes_r, (locc, memc, globc) = pack(
                img, boxes, [loc_i, mem_i, glob_i],
                canvas_hw_of[(gk, ms)], ms)
            j = i - rows.start
            batch["key"].append(canvas)
            batch["local"].append(locc)
            batch["mem"].append(memc)
            batch["glob"].append(globc)
            k = min(len(boxes_r), g)
            batch["gt_boxes"][j, :k] = boxes_r[:k]
            batch["gt_labels"][j, :k] = cats[:k]
            batch["gt_valid"][j, :k] = True
        for key in ("key", "local", "mem", "glob"):
            batch[key] = np.stack(batch[key])
        if method != "mega":
            # key/ref contract of the method step
            batch["ref"] = batch.pop("local")
            del batch["mem"], batch["glob"]
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    start_it = 0
    if args.resume:
        path = latest_checkpoint(args.exp_dir)
        if path:
            start_it = restore_detector_checkpoint(path, det, optimizer, rng)
            logger.info(f"resumed from {path} at iteration {start_it}")
        else:
            logger.info("--resume: no checkpoint found, starting fresh")

    meters = MetricLogger()
    t0 = time.time()
    t_data = time.time()
    for it in range(start_it, args.iters):
        gk = group_keys[int(rng.choice(len(group_keys), p=group_weights))]
        # per-iteration scale sampling (reference MIN_SIZE_TRAIN tuple)
        ms = int(rng.choice(args.min_sizes))
        batch = make_batch(gk, ms)
        data_time = time.time() - t_data
        losses = detector_train_step(
            det, optimizer, batch, StepPriorities(args.seed, it, device),
            image_hw=canvas_hw_of[(gk, ms)],
            post_nms_top_n=args.post_nms_top_n, method=method)
        meters.update(data_time=data_time,
                      batch_time=time.time() - t_data,
                      **{k: float(x) for k, x in losses.items()})
        t_data = time.time()
        if it % args.log_interval == 0:
            logger.info(f"[{it}/{args.iters}] {meters}"
                        f"  lr={schedule(it):.2e}"
                        f"  {time.time() - t0:.1f}s")
        if (it + 1) % args.save_interval == 0 or it + 1 == args.iters:
            path = save_detector_checkpoint(args.exp_dir, it + 1, det,
                                            optimizer, rng)
            logger.info(f"saved {path}")
        if (args.eval_interval and (it + 1) % args.eval_interval == 0
                and args.val_anno_dir):
            if rank == 0:
                from vrdone_tpu_torch.eval.detection import \
                    evaluate_video_detections
                stats = evaluate_video_detections(
                    det, args.val_anno_dir,
                    args.val_frames_dir or args.frames_dir,
                    name_to_id=name_to_id, min_size=args.min_size,
                    canvas=args.canvas, max_videos=args.val_videos,
                    detect_fn=DETECT_FNS[method])
                logger.info(f"[{it + 1}] detector eval: " + "  ".join(
                    f"{k}={v:.4f}" for k, v in stats.items()))
            mesh.barrier()


if __name__ == "__main__":
    main()
