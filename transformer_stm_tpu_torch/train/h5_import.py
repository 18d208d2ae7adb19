"""Import reference-trained Keras ``.h5`` weight files into the port
(transformer_stm_tpu/train/h5_import.py).

The reference saves its weights with Keras-2 ``save_weights``
(models/CvT(Par).py:489: ``cvt_model_weights_{freq}_{proj}_cls{bool}.h5``)
and its evaluation rebuilds the model and loads them by naming convention
(models/CvT_test(Par).py:513).  This module does the same for the port:
given such a file and the ``CvTSpec`` it encodes, it builds the (params,
state) trees in the JAX layout and a ``CvT`` from them:

    model = import_cvt_h5(path, spec, device="cuda")
    params, state = h5_trees(arrays, spec)   # numpy trees, JAX layout

A genuine ``save_weights`` file of the reference's models/CvT(Par).py
(tests/test_reference_parity.py) is laid out as:

  stage{i}_ConvEmbed/stage{i}_ConvEmbed/conv2d_N/{kernel,bias}:0
  stage{i}_transformer/dense_N/...                      <- MLP fc1/fc2
  stage{i}_transformer/stage{i}_transformer/conv_attention_N/
      dense_M/...            <- proj_q, proj_k, proj_v, out (creation order)
      {q,k,v}_proj/depthwise_conv2d_N/depthwise_kernel:0
      {q,k,v}_proj/batch_normalization_N/{gamma,beta,moving_*}:0
      multi_head_attention_N/{query,key,value,attention_output}/...
  stage{i}_transformer/stage{i}_transformer/layer_normalization_N/...
  stage3_transformer/cls_token:0
  layer_normalization_N/... (head), Proc_Dense_{1,2}/, Final_Dense/

Each kernel is found by (substring patterns, shape, Keras creation order,
which is the natural sort order of the auto-names) and its bias taken from
the same group: independent searches for a bias by shape can collide (the
stage-3 MLP's fc2 bias (256,) and the attention denses' (256,)).
``map_cvt_names`` takes any {name: array with ``.shape``}, h5 datasets or
TensorFlow variables; the weight export (h5_export.py) uses it too.  h5py is
imported only by ``_load_arrays``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CvTSpec


def _load_arrays(path: str) -> Dict[str, np.ndarray]:
    """{dataset path: array} of every dataset in the HDF5 file."""
    import h5py

    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _natural_key(name: str):
    """Natural sort so dense_2 < dense_10 (Keras auto-names keep creation
    order only under numeric comparison)."""
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", name)]


def _find_name(arrays, *, contains: List[str], shape: Tuple[int, ...],
               used: set, not_contains: Optional[List[str]] = None) -> str:
    """Name of the first unused dataset (natural path order = Keras
    creation order) containing every pattern (case-insensitive), none of
    ``not_contains``, with the given shape."""
    for name in sorted(arrays, key=_natural_key):
        if name in used:
            continue
        low = name.lower()
        if all(p.lower() in low for p in contains) and \
                not any(p.lower() in low for p in (not_contains or [])) and \
                tuple(arrays[name].shape) == tuple(shape):
            used.add(name)
            return name
    left = [(n, arrays[n].shape) for n in sorted(arrays) if n not in used]
    raise KeyError(f"no dataset matching {contains} shape {shape} "
                   f"(available: {left[:8]}...)")


def _sibling(arrays, kernel_name: str, leaf: str, used: set) -> str:
    """Name of the dataset ``leaf`` in the same group as kernel_name, as an
    h5 path ('group/leaf:0') or a TensorFlow variable name."""
    group = kernel_name.rsplit("/", 1)[0]
    for cand in (f"{group}/{leaf}:0", f"{group}/{leaf}"):
        if cand in arrays:
            used.add(cand)
            return cand
    raise KeyError(f"no sibling '{leaf}' next to {kernel_name}")


def _dense(arrays, *, contains, shape, used, not_contains=None):
    """{'kernel', 'bias'} names, the bias taken from the kernel's group."""
    kname = _find_name(arrays, contains=contains, shape=shape, used=used,
                       not_contains=not_contains)
    return {"kernel": kname, "bias": _sibling(arrays, kname, "bias", used)}


def _norm(arrays, *, contains, shape, used, not_contains=None):
    """{'gamma', 'beta'} names of a normalisation, the beta from gamma's
    group."""
    gname = _find_name(arrays, contains=contains + ["gamma"], shape=shape,
                       used=used, not_contains=not_contains)
    return {"gamma": gname, "beta": _sibling(arrays, gname, "beta", used)}


def map_cvt_names(arrays, spec: CvTSpec):
    """(params, state) trees of dataset NAMES in the JAX layout
    (``init_cvt``'s), for any {name: array-like with ``.shape``}: the h5
    datasets of a weight file or the TensorFlow variables of a model."""
    used: set = set()
    params = {"stages": []}
    state = {"stages": []}
    in_ch = spec.num_channels
    for i, st in enumerate(spec.stages, start=1):
        embed = {"proj": _dense(
            arrays, contains=[f"stage{i}_ConvEmbed", "kernel"],
            shape=(st.patch_size, st.patch_size, in_ch, st.embed_dim),
            used=used)}
        t = f"stage{i}_transformer"
        d = st.embed_dim

        def proj_parts(tag):
            # only dw_bn holds weights: avg pools, linear is the identity
            if st.qkv_method != "dw_bn":
                return {}, {}
            kname = _find_name(
                arrays, contains=[t, f"{tag}_proj", "kernel"],
                shape=(st.kernel_size, st.kernel_size, d, 1), used=used)
            bn = _norm(arrays, contains=[t, f"{tag}_proj"], shape=(d,),
                       used=used)
            moving = {k: _find_name(arrays, contains=[t, f"{tag}_proj", k],
                                    shape=(d,), used=used)
                      for k in ("mean", "var")}
            return {"conv": {"kernel": kname}, "bn": bn}, {"bn": moving}

        qp, qs = proj_parts("q")
        kp, ks = proj_parts("k")
        vp, vs = proj_parts("v")
        h = st.num_heads
        dh = d // h
        # the block's auto-named (d, d) denses in Keras creation order:
        # proj_q, proj_k, proj_v, then the output projection
        proj_q, proj_k, proj_v, proj_out = (
            _dense(arrays, contains=[t, "dense", "kernel"],
                   not_contains=["multi_head"], shape=(d, d), used=used)
            for _ in range(4))
        mha = {key: _dense(arrays, contains=[t, key, "kernel"],
                           not_contains=["output"], shape=(d, h, dh),
                           used=used)
               for key in ("query", "key", "value")}
        mha["out"] = _dense(arrays, contains=[t, "attention_output",
                                              "kernel"],
                            shape=(h, dh, d), used=used)
        norm1 = _norm(arrays, contains=[t, "layer_normalization"],
                      shape=(d,), used=used)
        block = {
            "norm1": norm1,
            "attn": {"q_proj": qp, "k_proj": kp, "v_proj": vp,
                     "proj_q": proj_q, "proj_k": proj_k, "proj_v": proj_v,
                     "mha": mha, "proj": proj_out},
            "mlp": {"fc1": _dense(arrays, contains=[t, "dense", "kernel"],
                                  shape=(d, d * st.mlp_ratio), used=used),
                    "fc2": _dense(arrays, contains=[t, "dense", "kernel"],
                                  shape=(d * st.mlp_ratio, d), used=used)},
        }
        if st.with_cls_token:
            # stored (1, 1, 1, d); ``h5_trees`` reshapes it to (1, 1, d)
            block["cls_token"] = _find_name(arrays, contains=[t, "cls"],
                                            shape=(1, 1, 1, d), used=used)
        params["stages"].append({"embed": embed, "blocks": [block]})
        state["stages"].append({"blocks": [{"attn": {
            "q_proj": qs, "k_proj": ks, "v_proj": vs}}]})
        in_ch = st.embed_dim

    last = spec.stages[-1].embed_dim
    params["head_norm"] = _norm(
        arrays, contains=["layer_normalization"], not_contains=["stage"],
        shape=(last,), used=used)
    feat = last
    if spec.proc_dim > 0:
        params["proc_fc1"] = _dense(
            arrays, contains=["Proc_Dense_1", "kernel"],
            shape=(spec.proc_dim, spec.proc_hidden), used=used)
        params["proc_fc2"] = _dense(
            arrays, contains=["Proc_Dense_2", "kernel"],
            shape=(spec.proc_hidden, spec.proc_hidden), used=used)
        feat += spec.proc_hidden
    params["final"] = _dense(arrays, contains=["Final_Dense", "kernel"],
                             shape=(feat, spec.num_classes), used=used)
    return params, state


def map_tree(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts and lists, the path
    '/'-joined ('stages/2/blocks/0/cls_token'); empty dicts stay."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def flatten_tree(tree, path: str = "") -> dict:
    """{path: leaf} of nested dicts and lists, in ``map_tree``'s paths."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {p: leaf for k, v in items
                for p, leaf in flatten_tree(v, f"{path}/{k}").items()}
    return {path: tree}


def h5_trees(arrays, spec: CvTSpec):
    """{name: array} in the reference's layout -> (params, state) numpy
    trees in the JAX layout, the cls token reshaped from (1, 1, 1, d) to
    (1, 1, d)."""
    names_p, names_s = map_cvt_names(arrays, spec)

    def leaf(path, name):
        a = np.asarray(arrays[name])
        return a.reshape(1, 1, -1) if "cls_token" in path else a

    return map_tree(leaf, names_p), map_tree(leaf, names_s)


def import_cvt_h5(path: str, spec: CvTSpec, device="cuda"):
    """A Keras ``.h5`` weight file of the reference -> a ``CvT`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    from .checkpoint import from_jax_params

    return from_jax_params(*h5_trees(_load_arrays(path), spec), spec,
                           device=device)
