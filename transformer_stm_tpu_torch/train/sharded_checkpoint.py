"""Sharded checkpoints of a mesh's ranks, in the JAX package's layout
(transformer_stm_tpu/train/sharded_checkpoint.py), read and written without
jax, so that either package restores the other's.

Under ``ckpt_dir``::

    ckpt_000050.manifest.json   {"step", "process_count", "has_opt", ...}
    ckpt_000050.shard0.npz      "p/stages/0/.../fc1/kernel|0:64,0:128", ...
    ckpt_000050.shard1.npz      (one file for each rank)

A key is a leaf's path as ``train/checkpoint`` flattens it (``p/`` the
parameters, ``s/`` the BatchNorm state, ``o/step``, ``o/mu/``, ``o/nu/``
Adam's) and, after "|", the global slice the array holds ("a:b,c:d", or
"scalar").  A leaf is written once: by the ranks at data coordinate 0, and
for a leaf that is whole on every rank (not split over 'model',
parallel/sharding.py) by the one at model coordinate 0 too.  Restoring
reads every shard file; where the rank's slice was written as it is, it is
copied, else the whole leaf is assembled from the slices and cut: a
checkpoint restores onto any mesh layout.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .optimizer import AdamState


def _norm_index(index, shape) -> str:
    """A global slice (a tuple of slices) as "a:b,c:d", or "scalar"."""
    parts = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError("strided shards are not supported")
        parts.append(f"{start}:{stop}")
    return ",".join(parts) if parts else "scalar"


def _leaves(model, opt: Optional[AdamState]):
    """[(key, local tensor, axis split over 'model' or None)] in the JAX
    layout."""
    axes = getattr(model, "tp_axes", {})
    out = []
    for name, p in model.named_parameters():
        out.append(("p/" + name.replace(".", "/"), p, axes.get(name)))
    for name, b in model.named_buffers():
        out.append(("s/" + name.replace(".", "/"), b, None))
    if opt is not None:
        for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for name, t in moments.items():
                out.append((f"o/{kind}/" + name.replace(".", "/"), t,
                            axes.get(name)))
    return out


def _global(model, t, axis):
    """(global shape, the global index of this rank's slice)."""
    shape = list(t.shape)
    index = [slice(0, d) for d in shape]
    if axis is not None:
        n, r = shape[axis], model.tp_rank
        shape[axis] = n * model.tp_size
        index[axis] = slice(r * n, (r + 1) * n)
    return tuple(shape), tuple(index)


def _coords(mesh):
    """(data coordinate, model coordinate, global rank, world size)."""
    if mesh is None:
        return 0, 0, 0, 1
    return (mesh.get_local_rank("data"), mesh.get_local_rank("model"),
            dist.get_rank(), dist.get_world_size())


def _atomic_write(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_sharded_checkpoint(ckpt_dir: str, model, opt: Optional[AdamState],
                            step: int, metadata: Optional[Dict] = None,
                            mesh=None) -> str:
    """Every rank of ``mesh`` (None: one process, no mesh) writes its
    shard file of the leaves it owns; rank 0 writes the manifest once every
    shard is written.  Returns this rank's shard path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    data_rank, model_rank, rank, world = _coords(mesh)
    flat: Dict[str, np.ndarray] = {}
    if data_rank == 0:
        for key, t, axis in _leaves(model, opt):
            if axis is None and model_rank != 0:
                continue
            shape, index = _global(model, t, axis)
            flat[f"{key}|{_norm_index(index, shape)}"] = \
                t.detach().cpu().numpy()
        if opt is not None and model_rank == 0:
            flat["o/step|scalar"] = np.asarray(opt.step, np.int32)
    base = os.path.join(ckpt_dir, f"ckpt_{step:06d}")
    shard = f"{base}.shard{rank}.npz"
    _atomic_write(shard, lambda f: np.savez(f, **flat))
    if mesh is not None:
        dist.barrier()
    if rank == 0:
        meta = {"step": step, "process_count": world,
                "has_opt": opt is not None}
        meta.update(metadata or {})
        _atomic_write(f"{base}.manifest.json",
                      lambda f: f.write(json.dumps(meta).encode()))
    if mesh is not None:
        dist.barrier()
    return shard


def latest_sharded_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest manifest path of ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    ms = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*.manifest.json")))
    return ms[-1] if ms else None


def _load_shards(manifest_path: str):
    with open(manifest_path) as f:
        meta = json.load(f)
    base = manifest_path[: -len(".manifest.json")]
    by_key: Dict[str, Dict[str, np.ndarray]] = {}
    for path in sorted(glob.glob(base + ".shard*.npz")):
        with np.load(path) as z:
            for k in z.files:
                key, idx = k.rsplit("|", 1)
                by_key.setdefault(key, {})[idx] = z[k]
    return meta, by_key


def _assemble(shards: Dict[str, np.ndarray], shape, dtype) -> np.ndarray:
    """The whole leaf from its slices."""
    out = np.zeros(shape, dtype)
    for idx, data in shards.items():
        if idx == "scalar":
            return np.asarray(data, dtype)
        out[tuple(slice(*map(int, p.split(":")))
                  for p in idx.split(","))] = data
    return out


def _slice_of(shards, key: str, shape, index, dtype) -> np.ndarray:
    if not shards:
        raise KeyError(f"sharded checkpoint missing leaf {key}")
    want = _norm_index(index, shape)
    if want in shards:
        return np.asarray(shards[want], dtype)
    return _assemble(shards, shape, dtype)[index]


def restore_sharded_checkpoint(manifest_path: str, model,
                               opt: Optional[AdamState] = None):
    """Copies this rank's slice of every leaf into ``model``'s parameters
    and buffers and, when the checkpoint has Adam's state, into ``opt``
    (its step too), in place, whatever mesh wrote it.  Returns
    (model, opt, step)."""
    meta, by_key = _load_shards(manifest_path)
    use_opt = opt if meta.get("has_opt") else None
    with torch.no_grad():
        for key, t, axis in _leaves(model, use_opt):
            shape, index = _global(model, t, axis)
            arr = _slice_of(by_key.get(key), key, shape, index, np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{arr.shape}, model {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    if use_opt is not None:
        use_opt.step = int(_slice_of(by_key.get("o/step"), "o/step", (),
                                     (), np.int32))
    return model, opt, meta["step"]
