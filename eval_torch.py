"""Evaluate a VrdONE relation detector with the PyTorch port.

The counterpart of ``eval.py`` on ``vrdone_tpu_torch``: the same flags, the
same datasets, ground truth and scoring (the port's copies in
``vrdone_tpu_torch.data.datasets`` and ``vrdone_tpu_torch.eval.{convert,
metrics}``), and the port's bucketed eval forward on ``--device``. It
imports nothing of ``vrdone_tpu``.

``--ckpt_path`` takes either a ``train_torch.py`` checkpoint (``.ckpt``;
its EMA parameters when it has them) or a flat ``.npz`` of flax parameters
written by ``tools/export_params_npz.py`` from a ``train.py`` checkpoint.
With ``--eval_exp_dir`` the sweep reads ``model_epoch_<n>_<data>.ckpt``,
or the ``.npz`` of that name where no ``.ckpt`` exists.

Under ``torchrun`` (``--multihost``, one process a card: ``--device cuda``
becomes ``cuda:LOCAL_RANK``, and ``cuda:0`` keeps every rank on card 0)
the test videos are strided over the ranks, their predictions merged
(``parallel/comm.py::accumulate_predictions``, on a gloo group), and rank
0 alone scores, writes the GT cache and ``--save_result``; the other
ranks log zeros, as ``eval.py`` does. ``--eval_dp N`` splits each
bucketed pair batch over N cards of this process, one model replica a
card (under torchrun, rank r's block of N cards from card r·N).

    python eval_torch.py --data_name vidvrd --cfg_path configs/vidvrd.yaml \
        --exp_dir exp --ckpt_path exp/model_last.ckpt --device cuda
    torchrun --standalone --nproc_per_node 8 eval_torch.py --multihost \
        --data_name vidvrd --cfg_path configs/vidvrd.yaml --exp_dir exp \
        --ckpt_path exp/model_last.ckpt --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import torch

from vrdone_tpu_torch.config import (InferenceConfig, load_yaml_config,
                                     model_config_from_yaml)
from vrdone_tpu_torch.convert import load_npz, load_params
from vrdone_tpu_torch.data.batching import packed_channels
from vrdone_tpu_torch.data.datasets import VidORDataset, VidVRDDataset
from vrdone_tpu_torch.eval.convert import build_groundtruth, to_eval_format
from vrdone_tpu_torch.eval.decode import InferenceRunner, infer_video
from vrdone_tpu_torch.eval.metrics import relation_metrics
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.parallel import mesh
from vrdone_tpu_torch.parallel.comm import accumulate_predictions
from vrdone_tpu_torch.train.checkpoint import restore_params_for_eval
from vrdone_tpu_torch.utils.logging import setup_logger

METRIC_KEYS = ["RelDet_mAP", "RelDet_AR@50", "RelDet_AR@100",
               "RelTag_AP@1", "RelTag_AP@5", "RelTag_AP@10"]


def parse_args():
    p = argparse.ArgumentParser(description="Test a Video Relation Detector")
    p.add_argument("--data_name", type=str, choices=["vidor", "vidvrd"])
    p.add_argument("--cfg_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--ckpt_path", type=str,
                   help="a train_torch.py .ckpt, or an .npz written by "
                        "tools/export_params_npz.py")
    p.add_argument("--eval_exp_dir", default=False, action="store_true")
    p.add_argument("--scale", default=None, type=int)
    p.add_argument("--eval_start_epoch", type=int, default=3)
    p.add_argument("--epochs", type=int)
    p.add_argument("--eval_file_name", type=str, default="eval")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--save_result", default=False, action="store_true")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="one process a card under torchrun: test videos "
                        "are strided over the ranks and predictions merged "
                        "before scoring on rank 0")
    p.add_argument("--eval_dp", type=int, default=1,
                   help="split each bucketed pair batch over this many "
                        "cards of this process (data-parallel eval "
                        "forward)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the forward, e.g. cuda or cpu")
    return p.parse_args()


def load_weights(model: MaskVRD, path: str) -> None:
    """A flax ``.npz`` by its suffix, else a ``train_torch.py`` checkpoint
    (EMA first)."""
    if path.endswith(".npz"):
        load_params(model, load_npz(path))
    else:
        model.load_state_dict(restore_params_for_eval(path), strict=True)


def eval_devices(device: torch.device, eval_dp: int,
                 world: int) -> list[torch.device]:
    """The devices of the eval forward: ``device`` alone, or ``eval_dp``
    cards; under torchrun rank r (on ``cuda:r``) takes cards r·eval_dp on.
    Refuses more than the host has (one CPU)."""
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if not 1 <= eval_dp <= count:
        raise SystemExit(f"--eval_dp {eval_dp}: this host has {count} "
                         f"{device.type} device(s)")
    if eval_dp == 1:
        return [device]
    first = (device.index or 0) * eval_dp if world > 1 else 0
    if first + eval_dp > count:
        raise SystemExit(f"--eval_dp {eval_dp} from card {first}: this host "
                         f"has {count} cards")
    return [torch.device(device.type, first + i) for i in range(eval_dp)]


def main():
    args = parse_args()
    rank, world, device = mesh.join_world(args.device, args.multihost)
    try:
        evaluate(args, rank, world, device)
    finally:
        mesh.shutdown()


def evaluate(args, rank: int, world: int, device: torch.device) -> None:
    devices = eval_devices(device, args.eval_dp, world)
    config = load_yaml_config(args.cfg_path)
    if args.epochs is not None:
        config["training_config"]["training_epoch"] = args.epochs
    config["training_config"]["eval_start_epoch"] = args.eval_start_epoch
    config["inference_config"]["topk"] = args.topk
    config["dataset_config"].update(config["test_dataset_config"])
    model_cfg = model_config_from_yaml(config)
    ic = config["inference_config"]
    infer_cfg = InferenceConfig(
        topk=ic["topk"], feat_stride=ic["feat_stride"],
        pred_min_frames=ic["pred_min_frames"], n_max_pair=ic["n_max_pair"],
        viou_th=ic["viou_th"], max_so_pair=model_cfg.max_so_pair)

    os.makedirs(args.exp_dir, exist_ok=True)
    logger = setup_logger("Test", os.path.join(args.exp_dir, "logfile"),
                          distributed_rank=rank,
                          filename=args.eval_file_name + "_log.json")
    logger.info(f"PyTorch {torch.__version__}, devices: {devices}, "
                f"ranks: {world}")

    # rank 0 builds the dataset's caches; the other ranks then read them
    if args.data_name == "vidor":
        dataset = mesh.rank0_first(lambda: VidORDataset(
            config["dataset_config"], args.scale))
    else:
        dataset = mesh.rank0_first(lambda: VidVRDDataset(
            config["dataset_config"]))

    gt_path = config["prepare_gt_config"]["gt_relations_path"]
    if gt_path and os.path.exists(gt_path):
        logger.info(f"Loading GT from {gt_path}")
        with open(gt_path) as f:
            gt_relations = json.load(f)
    else:
        logger.info("Building GT from annotations...")
        gt_relations = build_groundtruth(
            config["dataset_config"]["ann_dir"], dataset.split,
            args.data_name)
        # rank 0 alone writes the cache, through a temporary file and a
        # rename: ranks writing one file at once would corrupt it
        if gt_path and rank == 0:
            os.makedirs(os.path.dirname(gt_path) or ".", exist_ok=True)
            tmp_path = gt_path + f".tmp.{os.getpid()}"
            with open(tmp_path, "w") as f:
                json.dump(gt_relations, f)
            os.replace(tmp_path, gt_path)

    ckpt_paths = []
    if args.eval_exp_dir:
        tc = config["training_config"]
        for epoch in range(args.eval_start_epoch - 1, tc["training_epoch"],
                           tc.get("save_interval", 1)):
            stem = os.path.join(args.exp_dir,
                                f"model_epoch_{epoch + 1}_{args.data_name}")
            ckpt_paths.append(stem + ".ckpt" if os.path.isfile(stem + ".ckpt")
                              else stem + ".npz")
    else:
        if not args.ckpt_path:
            raise SystemExit("--ckpt_path or --eval_exp_dir is required")
        ckpt_paths.append(args.ckpt_path)

    c = packed_channels(model_cfg)

    all_results = defaultdict(list)
    for ckpt_idx, ckpt_path in enumerate(ckpt_paths):
        logger.info(f"Loading parameters from: {ckpt_path}")
        model = MaskVRD(model_cfg, device=device)
        load_weights(model, ckpt_path)
        runner = InferenceRunner(model_cfg, model, infer_cfg, c,
                                 devices=devices)

        predict_relations = {}
        for idx in range(dataset.num_test_items()):
            if idx % world != rank:
                continue
            item = dataset.get_test_item(idx)
            if item is None:
                continue
            triplets = infer_video(runner, item)
            if triplets is None:
                continue
            predict_relations.update(
                to_eval_format(args.data_name, item["video_name"], triplets))
        if world > 1:
            predict_relations = accumulate_predictions(predict_relations)

        if len(predict_relations) < 1:
            logger.info("None of valid prediction.")
            results = {k: 0.0 for k in METRIC_KEYS}
        elif rank != 0:
            # rank 0 alone scores; the others log zeros (silently)
            results = {k: 0.0 for k in METRIC_KEYS}
        else:
            results = relation_metrics(gt_relations, predict_relations,
                                       viou_threshold=infer_cfg.viou_th)
        for k, v in results.items():
            all_results[k].append(v)
            logger.info(f"{k}: {v:.6f}")

        if args.save_result and rank == 0:
            save_path = os.path.join(
                args.exp_dir,
                f"predicted_relations_topk{args.topk}_"
                f"epoch{ckpt_idx + args.eval_start_epoch}.json")
            with open(save_path, "w") as f:
                json.dump(predict_relations, f)
            logger.info(f"Predicted relations saved at {save_path}")

    if len(ckpt_paths) > 1:
        # reference protocol (reference eval.py:182-192): for each metric
        # key, the sweep epoch with that key's maximum and its full row
        logger.info("-" * 90)
        interval = config["training_config"].get("save_interval", 1)
        for key in METRIC_KEYS:
            best = all_results[key].index(max(all_results[key]))
            epoch = best * interval + args.eval_start_epoch
            logger.info(f"Best {key} result is in epoch {epoch}")
            for k, vs in all_results.items():
                logger.info(f"{k}: {vs[best]:.6f}")
        logger.info("All of the results:")
        logger.info(f"{dict(all_results)}")
    logger.info("Eval done.")


if __name__ == "__main__":
    main()
