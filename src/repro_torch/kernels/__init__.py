"""Paged-attention kernels (CUDA), their plain versions and dispatch."""
