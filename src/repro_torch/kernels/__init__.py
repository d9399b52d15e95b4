"""Hand-written CUDA tick kernels, their wrappers and plain versions."""
