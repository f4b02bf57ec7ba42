#!/usr/bin/env bash
# The port's counterpart of finetune_mega_vidvrd.sh: train_detector_torch.py
# with its arguments, one process a card under torchrun (NPROC of them,
# every card of this host by default), each on its samples of every batch.
set -e
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
python -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    train_detector_torch.py \
    --cfg configs/detector/mega_vidvrd.yaml \
    --dataset vidvrd \
    --anno_dir datasets/vidvrd/annotations/train \
    --frames_dir datasets/vidvrd/frames \
    --exp_dir "${1:-experiments/detector_vidvrd_finetune_torch}" \
    --init_ckpt "${2:?usage: finetune_mega_vidvrd_torch.sh EXP_DIR INIT_CKPT}" \
    --lr_rate 1.0 \
    --iters 210000
