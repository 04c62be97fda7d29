"""Synthetic token batches."""
