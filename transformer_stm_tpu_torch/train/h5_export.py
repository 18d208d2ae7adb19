"""Export the port's weights into the reference's own Keras model
(transformer_stm_tpu/train/h5_export.py).

The reference evaluates by rebuilding ``create_cvt_model`` and calling
``model.load_weights(h5)`` by naming convention
(models/CvT_test(Par).py:510-513).  This module closes the migration loop
in the other direction: it loads the reference's models/CvT(Par).py by
path, builds its model, assigns a (params, state) pair of trees in the JAX
layout to its variables and calls ``save_weights``, which writes an ``.h5``
that the reference's unmodified evaluation scripts load:

    params, state = to_jax_params(model)
    export_cvt_reference_h5(params, state, spec, "cvt_model_weights.h5")

The weights correspond through the import's mapping
(``h5_import.map_cvt_names``) applied to {variable name: variable}: the
TensorFlow variable names carry the same layer-name and auto-name structure
as the dataset paths of ``save_weights``.  The leaves may be numpy arrays or
the port's tensors.  TensorFlow, pandas and the reference are imported only
when a model is built.  The default reference paths are relative to the
working directory, as the command line's.
"""

from __future__ import annotations

import importlib.util

import numpy as np

from ..config import CvTSpec
from .h5_import import flatten_tree, map_cvt_names

REF_CVT = "reference/models/CvT(Par).py"
REF_CVT_IMG = "reference/models/CvT(Img).py"
REF_FFN = "reference/models/FFN(OnlyPar).py"


def load_reference_module(path: str = REF_CVT):
    """Import a reference training script by path.  Its module level reads
    two xlsx files through pandas; they are read through the port's own
    xlsx reader, so that neither openpyxl nor xlrd is needed.  The reference
    is Keras-2 code: legacy Keras is set before the first TensorFlow import
    (no effect once TensorFlow is imported; the caller must then have set
    it)."""
    import os

    os.environ.setdefault("TF_USE_LEGACY_KERAS", "1")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

    import pandas as pd

    from ..data.xlsx import read_xlsx

    orig = pd.read_excel

    def fake_read_excel(p, *a, **k):
        rows = next(iter(read_xlsx(str(p)).values()))
        return pd.DataFrame(rows[1:], columns=rows[0])

    pd.read_excel = fake_read_excel
    try:
        spec = importlib.util.spec_from_file_location("ref_cvt_par", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        pd.read_excel = orig
    return mod


def configure_reference_module(mod, spec: CvTSpec) -> None:
    """Pushes the spec's variant switches and stage sizes into the
    reference module's globals (its configuration is module-level
    constants)."""
    mod.projection_method = spec.stages[0].qkv_method
    mod.cls_token_switch = any(st.with_cls_token for st in spec.stages)
    for mst, st in zip(mod.spec["stages"], spec.stages):
        mst["qkv_method"] = st.qkv_method
        mst["with_cls_token"] = st.with_cls_token
        mst["embed_dim"] = st.embed_dim
        mst["num_heads"] = st.num_heads
        mst["patch_size"] = st.patch_size
        mst["stride"] = st.stride


def _np(leaf):
    """A leaf as a float32 numpy array: tensors through the host."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.float32)


def export_cvt_reference_h5(params, state, spec: CvTSpec, path: str,
                            mod=None, ref_path: str = None):
    """Writes ``path`` (.h5, the legacy Keras-2 ``save_weights`` layout)
    holding the weights inside the reference's own model: CvT(Par).py for
    specs with process parameters, CvT(Img).py (the same layer names, a
    4-argument builder, no process branch) where ``spec.proc_dim`` is 0.

    params, state: trees in the JAX layout (``to_jax_params``,
    ``load_checkpoint``).  Returns the reference's Keras model with the
    weights assigned, for further checks against it."""
    if mod is None:
        if ref_path is None:
            ref_path = REF_CVT if spec.proc_dim > 0 else REF_CVT_IMG
        mod = load_reference_module(ref_path)
    configure_reference_module(mod, spec)
    if spec.proc_dim > 0:
        model = mod.create_cvt_model(spec.image_height, spec.image_width,
                                     spec.num_channels, spec.proc_dim,
                                     spec.num_classes)
    else:
        model = mod.create_cvt_model(spec.image_height, spec.image_width,
                                     spec.num_channels, spec.num_classes)
    # Each variable qualified by its top-level layer's name: save_weights
    # groups the datasets by model.layers entry ("stage1_transformer/
    # dense_10/kernel:0") while a variable's .name drops that prefix
    # ("dense_10/kernel:0"), and the import's patterns need the stage
    # prefix to tell the stages apart.
    tf_vars = {}
    seen = set()
    for layer in model.layers:
        for w in layer.weights:
            tf_vars[f"{layer.name}/{w.name}"] = w
            seen.add(id(w))
    for w in model.weights:
        if id(w) not in seen:
            tf_vars[w.name] = w
    if len(tf_vars) != len(model.weights):
        raise AssertionError("duplicate TF variable names: the name-based "
                             "mapping is unsafe")
    names_p, names_s = map_cvt_names(tf_vars, spec)
    for names, tree in ((names_p, params), (names_s, state)):
        leaves, targets = flatten_tree(tree), flatten_tree(names)
        if set(leaves) != set(targets):
            raise KeyError(f"leaves do not match the reference model: "
                           f"missing {sorted(set(targets) - set(leaves))}, "
                           f"unexpected {sorted(set(leaves) - set(targets))}")
        for at, name in targets.items():
            var = tf_vars[name]
            var.assign(_np(leaves[at]).reshape(var.shape))
    model.save_weights(path)
    return model


def export_ffn_reference_h5(params, path: str, mod=None,
                            ref_path: str = REF_FFN):
    """Writes ``path`` holding the FFN's weights inside the reference's own
    params-only model (models/FFN(OnlyPar).py ``create_cvt_model``: a plain
    Dense(256, relu) x 2 -> Dense(1) despite the name), which its evaluation
    script loads by naming convention (models/FFN_test(OnlyPar).py:177,
    ``Vit_model_weights_{freq}.h5``).

    params: the FFN's tree in the JAX layout (``ffn_to_jax_params``,
    ``load_checkpoint``).  Returns the reference's Keras model with the
    weights assigned."""
    if mod is None:
        mod = load_reference_module(ref_path)
    proc_dim, hidden = _np(params["fc1"]["kernel"]).shape
    num_classes = _np(params["final"]["kernel"]).shape[1]
    model = mod.create_cvt_model(proc_dim, num_classes)
    dense_layers = [layer for layer in model.layers if layer.weights]
    want = [(proc_dim, hidden), (hidden, hidden), (hidden, num_classes)]
    got = [tuple(layer.weights[0].shape) for layer in dense_layers]
    if got != want:
        raise AssertionError(f"reference FFN layout changed: {got} != "
                             f"{want}")
    for layer, key in zip(dense_layers, ("fc1", "fc2", "final")):
        layer.weights[0].assign(_np(params[key]["kernel"]))
        layer.weights[1].assign(_np(params[key]["bias"]))
    model.save_weights(path)
    return model
