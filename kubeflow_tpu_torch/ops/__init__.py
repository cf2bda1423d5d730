"""Hand-written CUDA kernels of the port (``csrc/``), their build
(``_build.py``) and their PyTorch wrappers, each with a plain PyTorch
version beside it."""
