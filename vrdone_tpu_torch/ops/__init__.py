"""Masked sequence ops and the hand-written CUDA attention kernels."""
