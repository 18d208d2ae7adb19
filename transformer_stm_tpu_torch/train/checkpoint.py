"""Checkpoints in the JAX package's layout (transformer_stm_tpu/train/
checkpoint.py:25-97), read and written without jax, so that either package
resumes the other's.

A checkpoint ``ckpt_{step:06d}.npz`` holds path-flattened leaves:
``p/<path>`` for parameters, ``s/<path>`` for the BatchNorm state and, when
the json beside it says ``has_opt``, ``o/step``, ``o/mu/<path>`` and
``o/nu/<path>`` for Adam, e.g. ``p/stages/0/blocks/0/mlp/fc1/kernel``.  The
port's ``CvT`` module names its parameters and buffers by the same paths
with dots, so the mapping is a rename:

    params, state, opt, step = load_checkpoint(path)
    model = from_jax_params(params, state, spec, device="cuda")
    params, state = to_jax_params(model)
    save_checkpoint(ckpt_dir, model, adam_state, step)

A ViT's parameter tree (``init_vit`` of the JAX package: ``patch_embed``,
``pos_embed``, ``cls_token``, the ``blocks`` list, ``head_norm``, ``head``;
no state) maps the same way onto the port's ``ViT``:

    model = vit_from_jax_params(params, spec, device="cuda")
    params = vit_to_jax_params(model)

``ViTTrainer`` (train/vit_train.py) saves its model and AdamW state with
``save_checkpoint`` as the JAX trainer does (vit_train.py:91-114 there):
no ``s/`` leaves, the epoch as the step, the records in the .json.

The multi-target trainer's checkpoints are stacked (train/multi.py:395-420
of the JAX package): every ``p/``, ``s/`` and ``o/`` leaf carries a leading
slot axis T and ``o/step`` is (T,), one Adam count per slot.
``save_stacked_checkpoint`` writes one from per-slot models, and
``take_slot`` cuts slot i out of ``load_checkpoint``'s trees:

    save_stacked_checkpoint(ckpt_dir, models, opts, step, metadata)
    params, state, opt, step = load_checkpoint(path)
    load_into(model_i, take_slot(params, i), take_slot(state, i))
    opt_i = adam_from_jax(take_slot(opt, i), model_i, device)
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CvTSpec, ViTSpec
from ..models.cvt import CvT
from ..models.vit import ViT
from .optimizer import AdamState


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


def _leaves(model, opt: Optional[AdamState]) -> Dict[str, np.ndarray]:
    """The checkpoint leaves of one model and its Adam state."""
    params, state = to_jax_params(model)
    flat = {"p/" + k: v for k, v in _flatten(params).items()}
    flat.update({"s/" + k: v for k, v in _flatten(state).items()})
    if opt is not None:
        flat["o/step"] = np.asarray(opt.step, np.int32)
        for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for k, t in moments.items():
                flat[f"o/{name}/" + k.replace(".", "/")] = \
                    t.detach().cpu().numpy()
    return flat


def _write(ckpt_dir: str, flat, step: int, has_opt: bool,
           metadata: Optional[Dict]) -> str:
    """ckpt_dir/ckpt_{step:06d}.npz through a temporary file and an atomic
    replace, then its .json {"step", "has_opt", **metadata}
    (checkpoint.py:62-81)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:06d}")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path + ".npz")
    meta = {"step": step, "has_opt": has_opt}
    meta.update(metadata or {})
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path + ".npz"


def save_checkpoint(ckpt_dir: str, model, opt: Optional[AdamState],
                    step: int, metadata: Optional[Dict] = None) -> str:
    """Writes ckpt_dir/ckpt_{step:06d}.npz and its .json as the JAX
    package does."""
    return _write(ckpt_dir, _leaves(model, opt), step, opt is not None,
                  metadata)


def save_stacked_checkpoint(ckpt_dir: str, models: Sequence,
                            opts: Optional[Sequence[AdamState]], step: int,
                            metadata: Optional[Dict] = None) -> str:
    """One checkpoint of T slots: each leaf of the per-slot models (and
    Adam states) stacked along a new leading axis, ``o/step`` (T,) int32."""
    flats = [_leaves(m, o) for m, o in
             zip(models, opts if opts is not None else [None] * len(models))]
    flat = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return _write(ckpt_dir, flat, step, opts is not None, metadata)


def take_slot(tree, i: int):
    """Slot i of a stacked tree (``load_checkpoint``'s params, state or
    opt of a stacked checkpoint): every leaf indexed on its leading axis."""
    if isinstance(tree, dict):
        return {k: take_slot(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [take_slot(v, i) for v in tree]
    return np.asarray(tree)[i]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ckpt_*.npz of ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def load_checkpoint(path: str):
    """Reads a ``ckpt_*.npz`` of either package -> (params tree, state
    tree, opt, step).  ``opt`` is {"step", "mu", "nu"} in the JAX layout
    when the .json beside it says ``has_opt``, else None; the step comes
    from the .json, None where there is none (a bare npz)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def part(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in flat.items() if k.startswith(prefix)}

    params, state = _unflatten(part("p/")), _unflatten(part("s/"))
    meta_path = path[:-4] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    opt = None
    if meta.get("has_opt"):
        opt = {"step": flat["o/step"], "mu": _unflatten(part("o/mu/")),
               "nu": _unflatten(part("o/nu/"))}
    return params, state, opt, meta.get("step")


def adam_from_jax(opt_tree, model, device) -> AdamState:
    """``load_checkpoint``'s opt -> an AdamState for ``model``'s
    parameters, on ``device``; every moment must match a parameter."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    moments = {}
    for name in ("mu", "nu"):
        flat = {k.replace("/", "."): v
                for k, v in _flatten(opt_tree[name]).items()}
        if set(flat) != set(shapes):
            raise KeyError(f"optimizer {name} leaves do not match the model: "
                           f"missing {sorted(set(shapes) - set(flat))}, "
                           f"unexpected {sorted(set(flat) - set(shapes))}")
        for n, v in flat.items():
            if tuple(v.shape) != shapes[n]:
                raise ValueError(f"shape mismatch for {name} {n}: given "
                                 f"{v.shape}, model {shapes[n]}")
        moments[name] = {n: torch.from_numpy(np.array(flat[n], np.float32))
                         .to(device) for n in shapes}
    return AdamState(step=int(opt_tree["step"]), mu=moments["mu"],
                     nu=moments["nu"])


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


def vit_from_jax_params(np_params, spec: ViTSpec, device="cuda") -> ViT:
    """A JAX ViT parameter tree of numpy arrays (float32 or bfloat16) -> a
    float32 ``ViT`` on ``device``; every leaf must match by name and
    shape."""
    return load_into(ViT(spec), np_params, {}).to(device)


def vit_to_jax_params(model: ViT) -> dict:
    """The inverse of ``vit_from_jax_params``: the parameter tree as float32
    numpy arrays in the JAX layout, whatever the model's type."""
    return _unflatten({k.replace(".", "/"): v.detach().float().cpu().numpy()
                       for k, v in model.named_parameters()})
