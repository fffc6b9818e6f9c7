"""Benchmark of the PyTorch and CUDA SLAM port on one H100 (see README.md)."""
