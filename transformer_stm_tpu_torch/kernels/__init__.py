"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``attention_small`` (forward and backward), ``flash_attention``
(forward and backward), ``fused_mlp`` (inference and training) and
``fused_layer`` (the four ViT-layer inference kernels).  Importing this
package builds nothing: the library is built with nvcc at the first launch
(``_build.library``)."""


def clear_weight_packs():
    """Drops every cached weight pack (``fused_mlp.packed_mlp_weights`` and
    ``fused_layer.packed_weights``): the next launch packs its weights anew.
    Call it after writing into weights in place through ``.data``, which
    neither cache can see."""
    from . import fused_layer, fused_mlp

    fused_mlp._PACKS.clear()
    fused_layer._PACKS.clear()
