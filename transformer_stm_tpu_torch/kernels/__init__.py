"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``attention_small`` (forward and backward), ``flash_attention``
(forward and backward), ``fused_mlp`` (inference and training) and
``fused_layer`` (the four ViT-layer inference kernels).  Importing this
package builds nothing: the library is built with nvcc at the first launch
(``_build.library``)."""
