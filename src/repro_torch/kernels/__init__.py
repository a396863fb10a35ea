"""Attention kernels: hand-written CUDA for Hopper plus plain PyTorch
versions; ``ops`` dispatches on the tensor's device."""
