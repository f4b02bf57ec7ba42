#!/usr/bin/env bash
# The port's counterpart of extract_vidor_gt.sh:
# extract_gt_features_torch.py with its arguments, parts PART .. PART +
# NPROC - 1 at once, one process a card (NPROC cards, every card of this
# host by default).
set -e
PART=${1:-0}
NUM_PARTS=${2:-700}
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
pids=()
for ((i = 0; i < NPROC && PART + i < NUM_PARTS; i++)); do
    python extract_gt_features_torch.py \
        --anno_dir datasets/vidor/annotations/training \
        --frames_dir datasets/vidor/frames \
        --out_dir datasets/vidor/features/GT_boxfeatures_training \
        --num_classes 80 --part "$((PART + i))" --num_parts "$NUM_PARTS" \
        --device "cuda:$i" &
    pids+=($!)
done
for pid in "${pids[@]}"; do
    wait "$pid"
done
