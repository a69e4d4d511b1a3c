"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions. Each wrapper launches its kernel on a CUDA tensor and uses the plain
version on a CPU tensor; see ``_route.py``."""
