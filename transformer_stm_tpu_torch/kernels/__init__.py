"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Importing this package builds nothing: the library is built with
nvcc at the first launch (``_build.library``)."""
