"""Checkpoints in the JAX package's layout (transformer_stm_tpu/train/
checkpoint.py:25-54), read without jax.

A JAX checkpoint ``ckpt_{step:06d}.npz`` holds path-flattened leaves:
``p/<path>`` for parameters, ``s/<path>`` for the BatchNorm state and
``o/<path>`` for the optimizer, e.g. ``p/stages/0/blocks/0/mlp/fc1/kernel``.
The port's ``CvT`` module names its parameters and buffers by the same
paths with dots, so the mapping is a rename:

    params, state, step = load_checkpoint(path)
    model = from_jax_params(params, state, spec, device="cuda")
    params, state = to_jax_params(model)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CvTSpec
from ..models.cvt import CvT


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """{"a/0/b": leaf} -> nested dicts, with lists where every key of a
    level is an index."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_checkpoint(path: str) -> Tuple[dict, dict, Optional[int]]:
    """Reads a JAX ``ckpt_*.npz`` -> (params tree, state tree, step); the
    step comes from the ``.json`` beside it, None where there is none."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten({k[2:]: v for k, v in flat.items()
                         if k.startswith("p/")})
    state = _unflatten({k[2:]: v for k, v in flat.items()
                        if k.startswith("s/")})
    meta_path = path[:-4] + ".json"
    step = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step")
    return params, state, step


def load_into(module, np_params, np_state):
    """Copies JAX-layout numpy trees into ``module``'s parameters and
    buffers.  Every leaf must match one in name and shape, and every
    parameter and buffer must be given."""
    given = {"parameter": {k.replace("/", "."): v
                           for k, v in _flatten(np_params).items()},
             "state": {k.replace("/", "."): v
                       for k, v in _flatten(np_state).items()}}
    wanted = {"parameter": dict(module.named_parameters()),
              "state": dict(module.named_buffers())}
    for kind in ("parameter", "state"):
        g, w = set(given[kind]), set(wanted[kind])
        if g != w:
            raise KeyError(f"{kind} leaves do not match the model: missing "
                           f"{sorted(w - g)}, unexpected {sorted(g - w)}")
    with torch.no_grad():
        for kind in ("parameter", "state"):
            for name, t in wanted[kind].items():
                arr = np.array(given[kind][name], np.float32)  # a copy
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {name}: given "
                                     f"{arr.shape}, model {tuple(t.shape)}")
                t.copy_(torch.from_numpy(arr))
    return module


def from_jax_params(np_params, np_state, spec: CvTSpec,
                    device="cuda") -> CvT:
    """JAX-layout numpy trees (``init_cvt``'s params and state, or
    ``load_checkpoint``'s) -> a CvT module on ``device``."""
    return load_into(CvT(spec), np_params, np_state).to(device)


def to_jax_params(model) -> Tuple[dict, dict]:
    """The inverse of ``from_jax_params``: (params tree, state tree) of
    numpy arrays in the JAX layout."""
    def tree(named):
        return _unflatten({k.replace(".", "/"): v.detach().cpu().numpy()
                           for k, v in named})
    return tree(model.named_parameters()), tree(model.named_buffers())
