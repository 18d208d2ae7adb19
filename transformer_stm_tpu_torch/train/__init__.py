"""Checkpoints, metrics and the inference loop of the port."""
