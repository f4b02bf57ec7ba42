"""Train a VrdONE relation detector with the PyTorch port.

The counterpart of ``train.py`` on ``vrdone_tpu_torch``: the same flags
and YAML configs, plus ``--device`` (default ``cuda``). One process a
device: forward, Hungarian matching and losses, backward, clip, AdamW and
EMA per step (``vrdone_tpu_torch/train/loop.py``), with band attention on
its CUDA kernels forward and backward. ``--compute_dtype bfloat16`` runs
the forward in bf16 on a cast of the fp32 master parameters (the bf16
instances of the band kernels), ``--remat`` recomputes the forward in the
backward (``--remat_policy full`` or ``dots``). Checkpoints are
``torch.save`` files (``model_epoch_<n>_<data>.ckpt`` and
``model_last.ckpt`` in ``--exp_dir``) holding the fp32 masters, which
``eval_torch.py --ckpt_path`` reads whatever the compute dtype was.

Data parallelism takes the place of JAX's dp mesh: launched by
``torchrun``, one process a card (``--device cuda`` becomes
``cuda:LOCAL_RANK``; NCCL on cards, gloo with ``--device cpu``), each
rank packs its rows of every global batch and the train step sums the
ranks' gradients (``vrdone_tpu_torch/parallel``), so N ranks take the
step one process takes on the global batch. ``--n_sp`` shards the time
axis of each batch over n_sp ranks as JAX's "sp" mesh axis does (halo
exchanges, gathered keys, time-reduced losses summed over the ranks): the
world size must be n_dp x n_sp, ``--n_dp`` defaults to world / n_sp, and
``max_seq_len`` must divide by n_sp x scale_factor ** backbone_arch[2].
``--multihost`` is the same path on a multi-node ``torchrun``. Rank 0
writes the logs, ``config.yaml`` and checkpoints. Tensor parallelism, as
in the JAX package, has no flag: ``create_train_state(..., tp=True)``.

    python train_torch.py --data_name vidvrd --cfg_path configs/vidvrd.yaml \
        --exp_dir experiments/vidvrd_torch --device cuda \
        [--compute_dtype bfloat16] [--remat --remat_policy dots]
    torchrun --standalone --nproc_per_node 8 train_torch.py \
        --data_name vidvrd --cfg_path configs/vidvrd.yaml \
        --exp_dir experiments/vidvrd_torch --device cuda [--n_sp 2]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import yaml

from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
from vrdone_tpu_torch.data.batching import packed_channels
from vrdone_tpu_torch.data.datasets import VidORDataset, VidVRDDataset
from vrdone_tpu_torch.data.loader import TrainLoader
from vrdone_tpu_torch.parallel import mesh
from vrdone_tpu_torch.train import checkpoint as ckpt
from vrdone_tpu_torch.train.loop import (batch_to_device, create_train_state,
                                         step_generator, train_step)
from vrdone_tpu_torch.utils.logging import AverageMeter, setup_logger


def parse_args():
    p = argparse.ArgumentParser(description="Train a Video Relation Detector")
    p.add_argument("--data_name", type=str, choices=["vidor", "vidvrd"])
    p.add_argument("--cfg_path", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--from_checkpoint", action="store_true", default=False)
    p.add_argument("--ckpt_path", type=str)
    p.add_argument("--scale", default=None, type=int)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"])
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialize the forward in the backward")
    p.add_argument("--remat_policy", type=str, default=None,
                   choices=[None, "full", "dots"],
                   help="remat policy (dots = save the Dense layers' "
                        "matrix products, full = recompute everything)")
    p.add_argument("--n_dp", type=int, default=None,
                   help="data-parallel size (default: world size / n_sp; "
                        "the world is torchrun --nproc_per_node x nodes, 1 "
                        "without torchrun)")
    p.add_argument("--n_sp", type=int, default=1,
                   help="sequence-parallel size (shards the time axis of "
                        "each batch over n_sp ranks; n_dp x n_sp ranks are "
                        "used)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-20")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="data parallelism over a multi-node torchrun (the "
                        "same path as one node)")
    p.add_argument("--auto_resume", action="store_true", default=False,
                   help="resume from <exp_dir>/model_last.ckpt if present")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the train step, e.g. cuda or cpu")
    args = p.parse_args()
    if args.n_sp < 1 or (args.n_dp is not None and args.n_dp < 1):
        p.error("--n_sp and --n_dp must be at least 1")
    return args


def main():
    args = parse_args()
    rank, world, device = mesh.join_world(args.device, args.multihost)
    try:
        n_dp = world // args.n_sp if args.n_dp is None else args.n_dp
        if n_dp * args.n_sp != world:
            raise SystemExit(f"--n_dp {n_dp} x --n_sp {args.n_sp} ranks is "
                             f"not the world size {world}; launch with "
                             f"torchrun --nproc_per_node "
                             f"{max(n_dp, 1) * args.n_sp}")
        train(args, rank, device, mesh.make_layout(n_dp, 1, args.n_sp))
    finally:
        mesh.shutdown()


def train(args, rank: int, device: torch.device,
          layout: mesh.Layout) -> None:
    config = load_yaml_config(args.cfg_path)
    config["training_config"]["seed"] = args.seed
    config["dataset_config"].update(config["training_dataset_config"])
    if args.compute_dtype:
        config["model_config"]["compute_dtype"] = args.compute_dtype
    if args.remat:
        config["model_config"]["remat"] = True
    if args.remat_policy:
        config["model_config"]["remat_policy"] = args.remat_policy
    model_cfg = model_config_from_yaml(config)
    if layout.n_sp > 1:
        try:
            mesh.check_time_split(model_cfg.max_seq_len, layout.n_sp,
                                  model_cfg.scale_factor,
                                  model_cfg.backbone_arch[2])
        except ValueError as e:
            raise SystemExit(str(e)) from None

    os.makedirs(args.exp_dir, exist_ok=True)
    logger = setup_logger("Train", os.path.join(args.exp_dir, "logfile"),
                          distributed_rank=rank, filename="train_log.json")
    logger.info(f"PyTorch {torch.__version__}, device: {device}, "
                f"data-parallel ranks: {layout.n_dp}, sequence-parallel "
                f"ranks: {layout.n_sp}")
    logger.info(f"Config:\n{json.dumps(config, indent=4)}")
    if rank == 0:
        with open(os.path.join(args.exp_dir, "config.yaml"), "w") as f:
            f.write(yaml.dump(config, indent=2, allow_unicode=True))

    tc = config["training_config"]
    # rank 0 builds the dataset's caches; the other ranks then read them
    if args.data_name == "vidor":
        dataset = mesh.rank0_first(lambda: VidORDataset(
            config["dataset_config"], args.scale))
    else:
        dataset = mesh.rank0_first(lambda: VidVRDDataset(
            config["dataset_config"]))

    batch_size = tc["batch_size"]
    num_pairs = config["training_dataset_config"]["num_pairs"]
    pack_size = batch_size * num_pairs
    num_gt = config["training_dataset_config"]["proposal_max_preds"]
    loader = TrainLoader(dataset, batch_size, pack_size,
                         model_cfg.max_seq_len, num_gt,
                         packed_channels(model_cfg), seed=args.seed,
                         process_index=layout.dp, process_count=layout.n_dp)
    steps_per_epoch = loader.steps_per_epoch()
    logger.info(f"Pairs per step: {pack_size} ({pack_size // layout.n_dp} a "
                f"rank); frames a rank: {model_cfg.max_seq_len // layout.n_sp}"
                f"; steps/epoch: {steps_per_epoch}")

    state, schedule = create_train_state(
        model_cfg, tc, steps_per_epoch, device=device,
        generator=torch.Generator().manual_seed(args.seed), layout=layout)
    n_params = sum(p.numel() for p in state.params())
    logger.info(f"Number of model parameters: {n_params}")

    crt_epoch = 0
    if args.auto_resume and not args.from_checkpoint:
        last = os.path.join(args.exp_dir, "model_last.ckpt")
        if os.path.exists(last):
            args.from_checkpoint = True
            args.ckpt_path = last
    if args.from_checkpoint:
        state, crt_epoch, ckpt_bs = ckpt.restore_checkpoint(args.ckpt_path,
                                                            state)
        if ckpt_bs != batch_size:
            logger.warning(f"batch_size from checkpoint not match: "
                           f"{batch_size} != {ckpt_bs}")
        logger.info(f"Resumed from {args.ckpt_path} at epoch {crt_epoch}")

    training_epoch = tc["training_epoch"]
    log_interval = tc.get("log_interval", 20)
    save_interval = tc.get("save_interval", 1)
    eval_start_epoch = tc.get("eval_start_epoch", 3)

    profiler = None
    total_steps = crt_epoch * steps_per_epoch
    for epoch in range(crt_epoch, training_epoch):
        logger.info(f"[Train]: Epoch {epoch:d} started")
        trackers: dict[str, AverageMeter] = {}
        epoch_start = time.time()
        data_t0 = time.time()
        for step, batch in enumerate(loader.epoch(epoch)):
            data_time = time.time() - data_t0
            if args.profile_dir and total_steps == 10 and rank == 0:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])])
                profiler.start()
            state, losses = train_step(
                state, batch_to_device(mesh.time_slice(batch, layout),
                                       device),
                step_generator(args.seed, total_steps))
            if profiler is not None and total_steps == 20:
                profiler.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                path = os.path.join(args.profile_dir, "trace.json")
                profiler.export_chrome_trace(path)
                profiler = None
                logger.info(f"Profiler trace written to {path}")
            if total_steps % log_interval == 0:
                for k, v in losses.items():
                    trackers.setdefault(k, AverageMeter()).update(float(v))
                parts = [f"[Train]: [{epoch:03d}][{step:05d}/"
                         f"{steps_per_epoch - 1:05d}]",
                         f"Total loss={trackers['total_loss'].avg:.4f}"]
                parts += [f"{k}={m.avg:.4f}" for k, m in trackers.items()
                          if k != "total_loss" and "_" not in k[-2:]]
                parts.append(f"training lr={schedule(total_steps):.1e}")
                parts.append(f"data={data_time*1e3:.0f}ms")
                logger.info("  ".join(parts))
            total_steps += 1
            data_t0 = time.time()
        logger.info(f"Epoch time: {time.time() - epoch_start:.4f}s")

        if (epoch + 1) % save_interval == 0 and (epoch + 1) >= eval_start_epoch:
            path = os.path.join(
                args.exp_dir, f"model_epoch_{epoch + 1}_{args.data_name}.ckpt")
            ckpt.save_checkpoint(path, state, epoch=epoch,
                                 batch_size=batch_size)
            logger.info(f"Checkpoint is saved: {path}")

    path = os.path.join(args.exp_dir, "model_last.ckpt")
    ckpt.save_checkpoint(path, state, epoch=training_epoch - 1,
                         batch_size=batch_size)
    logger.info(f"Checkpoint is saved: {path}")
    logger.info("Training Over...")


if __name__ == "__main__":
    main()
