"""The port's CUDA kernels, their plain versions and their build."""
