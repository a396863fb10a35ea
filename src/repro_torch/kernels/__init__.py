"""Hand-written CUDA kernels for Hopper (attention and relevance
scoring) plus their plain PyTorch versions; ``ops`` dispatches on the
tensor's device."""
