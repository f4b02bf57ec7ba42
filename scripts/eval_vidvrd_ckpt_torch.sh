#!/usr/bin/env bash
# The port's counterpart of eval_vidvrd_ckpt.sh: eval_torch.py with its
# arguments, one process a card under torchrun (NPROC of them, every card of
# this host by default; --multihost merges the ranks' predictions).
set -e
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
python -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    eval_torch.py --multihost \
    --data_name vidvrd \
    --cfg_path configs/vidvrd.yaml \
    --exp_dir "${1:-experiments/vidvrd_torch}" \
    --ckpt_path "${2:?usage: eval_vidvrd_ckpt_torch.sh EXP_DIR CKPT}" \
    --topk 8
