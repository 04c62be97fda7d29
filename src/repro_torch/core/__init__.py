"""Collective, planning and codec layers of the PyTorch port."""
