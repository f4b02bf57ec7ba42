#!/usr/bin/env bash
# The port's counterpart of extract_vidvrd_gt.sh:
# extract_gt_features_torch.py with its arguments, parts PART .. PART +
# NPROC - 1 at once, one process a card (NPROC cards, every card of this
# host by default).
set -e
PART=${1:-0}
NUM_PARTS=${2:-8}
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
pids=()
for ((i = 0; i < NPROC && PART + i < NUM_PARTS; i++)); do
    python extract_gt_features_torch.py \
        --anno_dir datasets/vidvrd/annotations/train \
        --frames_dir datasets/vidvrd/frames \
        --out_dir datasets/vidvrd/features/GT_boxfeatures_training \
        --num_classes 35 --part "$((PART + i))" --num_parts "$NUM_PARTS" \
        --device "cuda:$i" &
    pids+=($!)
done
for pid in "${pids[@]}"; do
    wait "$pid"
done
