"""PyTorch port of halva_tpu for NVIDIA GPUs (Hopper, sm_90a).

Same parameter tree, layouts and semantics as the JAX package beside it,
which stays the reference. Hand-written CUDA kernels live in `csrc/` and
are built on first use (`_kernels.py`); every kernel has a plain PyTorch
version that CPU tensors take.
"""

__version__ = "0.1.0"
