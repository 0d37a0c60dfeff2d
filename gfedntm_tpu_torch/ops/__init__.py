"""Hand-written CUDA kernels of the port (built at first use)."""
