"""Bucketed eval forward and triplet decoding."""
