#!/usr/bin/env bash
# The port's counterpart of train_vidor_local.sh: train_torch.py with its
# arguments, one process a card under torchrun (NPROC of them, every card of
# this host by default), N_SP of them sharing each sequence's time axis
# (sequence parallelism; n_dp = NPROC / N_SP).
set -e
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
python -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    train_torch.py \
    --data_name vidor \
    --cfg_path configs/vidor_local.yaml \
    --exp_dir "${1:-experiments/vidor_local_torch}" \
    --n_sp "${N_SP:-1}"
