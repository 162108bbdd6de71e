"""Hand-written CUDA kernels (``csrc/``) with their ctypes wrappers and
plain PyTorch versions."""
