#!/usr/bin/env bash
# The port's counterpart of eval_vidvrd_multi.sh: the checkpoint sweep of
# eval_torch.py with its arguments, one process a card under torchrun (NPROC
# of them, every card of this host by default; --multihost merges the ranks'
# predictions).
set -e
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
python -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    eval_torch.py --multihost \
    --data_name vidvrd \
    --cfg_path configs/vidvrd.yaml \
    --exp_dir "${1:-experiments/vidvrd_torch}" \
    --eval_exp_dir --eval_start_epoch 3 --epochs 15 \
    --topk 8
