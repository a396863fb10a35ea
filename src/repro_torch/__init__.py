"""PyTorch/CUDA port of the task-cascade serving system.

Same module paths as the JAX package ``repro``; the attention kernels on
the serving path are hand-written CUDA for Hopper (``kernels/csrc``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``, which selects the plain PyTorch versions of the kernels.
"""
