"""Hand-written CUDA distance kernels and their plain PyTorch versions."""
