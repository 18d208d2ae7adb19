"""Sharding rules of the tensor-parallel layers
(transformer_stm_tpu/parallel/sharding.py:45-98).

The rules of the JAX package, applied to the JAX path of each parameter of
the port's CvT (``train/checkpoint.to_jax_params`` names them: the
parameter's name with "/" for "."):

- MHA query/key/value kernels (E, H, Dh) split the heads (axis 1) and their
  biases (H, Dh) axis 0; the out kernel (H, Dh, E) axis 0, its bias whole;
- MLP fc1's kernel (D, 4D) splits the hidden units (axis 1) and its bias
  with them; fc2's kernel (4D, D) axis 0, its bias whole;
- the ConvEmbed kernel (kh, kw, cin, cout) splits the output channels
  (axis 3), the depthwise projection kernel (kh, kw, C, 1) the channels
  (axis 2); their biases and the BatchNorms stay whole;
- an axis is split only where the model axis's size divides it and it is
  longer than 1: stage 1's single head stays whole.

Everything else is whole on every rank.  JAX leaves the rest to GSPMD; here
``shard_params`` keeps this rank's slice of each split parameter and marks
the modules that own them with the model axis's process group
(``tp_group``), which their forwards read (ops/attention.mha,
ops/blocks._mlp_sharded, ops/conv_embed.ConvEmbed,
ops/projection.Projection).  Adam's moments mirror the parameters: build
them with ``adam_init`` after ``shard_params``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import MeshConfig
from ..ops.attention import MHA
from ..ops.blocks import MLP
from ..ops.conv_embed import ConvEmbed
from ..ops.projection import Projection

# The parameter each tensor-parallel module's split is read from, by type.
_MARKERS = ((MHA, "query.kernel"), (MLP, "fc1.kernel"),
            (ConvEmbed, "proj.kernel"), (Projection, "conv.kernel"))


def replicate(mesh) -> None:
    """No dim split: every rank holds the whole tensor."""
    return None


def batch_sharding(mesh, ndim: int = 4) -> int:
    """The dim split over 'data': the leading (batch) one."""
    return 0


def data_rows(batch: int, mesh) -> slice:
    """This rank's rows of a global batch of ``batch`` rows split over the
    'data' axis (``batch_sharding``)."""
    size, rank = mesh.get_group("data").size(), mesh.get_local_rank("data")
    if batch % size:
        raise ValueError(f"batch {batch} does not split over {size} data "
                         "ranks")
    b = batch // size
    return slice(rank * b, (rank + 1) * b)


def model_size(mesh) -> int:
    """The 'model' axis's size of a DeviceMesh or a MeshConfig."""
    if isinstance(mesh, MeshConfig):
        return max(1, mesh.model)
    return mesh.get_group("model").size()


def _tp_axis(names, shape, size: int) -> Optional[int]:
    def ok(axis: int) -> bool:
        return shape[axis] % size == 0 and shape[axis] > 1

    ndim = len(shape)
    if "mha" in names:
        if names[-2] in ("query", "key", "value"):
            if ndim == 3 and ok(1):
                return 1
            if ndim == 2 and ok(0):
                return 0
            return None
        if names[-2] == "out":
            return 0 if ndim == 3 and ok(0) else None
    if "mlp" in names and names[-1] == "kernel":
        if "fc1" in names and ok(1):
            return 1
        if "fc2" in names and ok(0):
            return 0
    if "mlp" in names and names[-1] == "bias" and "fc1" in names and ok(0):
        return 0
    if names[-1] == "kernel" and ndim == 4:
        if "embed" in names and ok(3):
            return 3
        if names[-2] == "conv" and ok(2):
            return 2
    return None


def cvt_param_sharding(model: nn.Module, mesh,
                       tensor_parallel: bool = True
                       ) -> Dict[str, Optional[int]]:
    """{parameter name: the axis split over 'model', or None} for the
    whole (unsplit) ``model``; all None without tensor parallelism or at a
    model axis of 1.  ``mesh``: a DeviceMesh, or a MeshConfig."""
    size = model_size(mesh)
    tp = tensor_parallel and size > 1
    return {name: _tp_axis(name.split("."), tuple(p.shape), size)
            if tp else None for name, p in model.named_parameters()}


def shard_params(model: nn.Module, mesh, tensor_parallel: bool = True):
    """Keeps this rank's slice of every parameter split over 'model' in
    place, marks the modules that own them with the model axis's process
    group and records the split as ``model.tp_axes`` ({name: axis} of the
    split parameters) and ``model.tp_rank``/``model.tp_size``.  Returns
    ``model``."""
    axes = {n: a for n, a in cvt_param_sharding(
        model, mesh, tensor_parallel).items() if a is not None}
    rank, size = mesh.get_local_rank("model"), model_size(mesh)
    with torch.no_grad():
        for name, axis in axes.items():
            prefix, _, leaf = name.rpartition(".")
            owner = model.get_submodule(prefix)
            p = getattr(owner, leaf)
            setattr(owner, leaf, nn.Parameter(
                p.chunk(size, axis)[rank].contiguous().clone(),
                requires_grad=p.requires_grad))
    if axes:
        group = mesh.get_group("model")
        for prefix, module in model.named_modules():
            for kind, marker in _MARKERS:
                path = f"{prefix}.{marker}" if prefix else marker
                if isinstance(module, kind) and path in axes:
                    module.tp_group = group
    model.tp_axes, model.tp_rank, model.tp_size = axes, rank, size
    return model
