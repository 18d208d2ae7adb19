"""PyTorch/CUDA port of transformer_stm_tpu, for one NVIDIA H100.

The JAX package ``transformer_stm_tpu`` stays the reference; this package
imports torch, numpy and the standard library only.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.  The
kernels of the TPU package are hand-written CUDA under ``csrc/``, built with
nvcc at first use (``kernels/_build.py``).
"""
