"""Hand-written CUDA kernels (`csrc/*.cu`), their wrappers and plain
PyTorch versions, the oracles, and the backend dispatch."""
