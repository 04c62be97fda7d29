"""Checkpoints of parameter and optimizer trees, file-compatible with the reference."""
