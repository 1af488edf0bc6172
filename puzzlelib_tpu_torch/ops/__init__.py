"""Compute functions on torch tensors; ``hopper`` holds the hand-written CUDA kernels."""
