"""CvT model (transformer_stm_tpu/models/cvt.py:32-137), evaluation and
training.

Spec-driven pyramid: [ConvEmbed -> ConvTransformerBlock x depth] per stage,
then
- cls head:        LayerNorm(cls token)
- token-mean head: LayerNorm over tokens, mean over tokens
optionally concatenated with the Dense(256, relu) x 2 process-parameter
branch, and a final Dense(num_classes).

    model = init_cvt(spec, torch.Generator().manual_seed(0))
    out = cvt_forward(model, images, proc)        # (B, num_classes)
    out = cvt_forward(model, images, proc, train=True, generator=gen)

The module tree mirrors the JAX parameter tree: its parameters are the JAX
``params`` leaves and its buffers (the BatchNorm moving statistics) the JAX
``state`` leaves, under the same path names (train/checkpoint.py maps them).
In training the forward updates those buffers in place, where the JAX
function returns the new state.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import CvTSpec
from ..ops.blocks import ConvTransformerBlock
from ..ops.common import Dense, LayerNorm
from ..ops.conv_embed import ConvEmbed


class _Stage(nn.Module):
    def __init__(self, in_ch: int, st, embed_norm: bool, generator=None):
        super().__init__()
        self.embed = ConvEmbed(in_ch, st.embed_dim, st.patch_size, st.stride,
                               norm=embed_norm, generator=generator)
        self.blocks = nn.ModuleList(
            ConvTransformerBlock(st.embed_dim, st.num_heads, st.kernel_size,
                                 st.strides, st.qkv_method, st.mlp_ratio,
                                 st.with_cls_token, st.dropout_rate,
                                 generator)
            for _ in range(st.depth))


class CvT(nn.Module):
    def __init__(self, spec: CvTSpec, generator=None):
        super().__init__()
        self.spec = spec
        in_chs = [spec.num_channels] + [s.embed_dim for s in spec.stages]
        self.stages = nn.ModuleList(
            _Stage(in_chs[i], st, spec.embed_norm, generator)
            for i, st in enumerate(spec.stages))
        last_dim = spec.stages[-1].embed_dim
        self.head_norm = LayerNorm(last_dim)
        feat_dim = last_dim
        if spec.proc_dim > 0:
            self.proc_fc1 = Dense(spec.proc_dim, spec.proc_hidden, generator)
            self.proc_fc2 = Dense(spec.proc_hidden, spec.proc_hidden,
                                  generator)
            feat_dim += spec.proc_hidden
        self.final = Dense(feat_dim, spec.num_classes, generator)


def init_cvt(spec: CvTSpec, generator: torch.Generator,
             device="cuda") -> CvT:
    """Glorot-uniform kernels and zero biases drawn from ``generator``, a
    CPU generator, so the weights do not depend on the device they are
    moved to."""
    return CvT(spec, generator).to(device)


def cvt_forward(model: CvT, images, proc=None, *, train: bool = False,
                generator=None, impl: str = "auto", mlp_impl=None,
                return_features: bool = False, remat: bool = False,
                group=None):
    """images: (B, H, W, C) float; proc: (B, proc_dim) or None ->
    (B, num_classes).  ``train=True`` normalises the dw_bn projections with
    batch statistics (updating the moving ones) and applies each stage's
    dropout, drawn from ``generator`` on the images' device.  Each block's
    MLP runs on ``mlp_impl`` if it is given, else on ``impl``, as JAX's
    block resolves it (``ops/blocks.mlp``): in training "pallas" and
    "flash" go through the fused training kernel, in evaluation "auto",
    "pallas" and "flash" through the fused kernel.  ``return_features``
    returns (out, features) with features each stage's last block output,
    (B, h, w, C), as JAX's list of them (models/cvt.py:116, :137), which
    Grad-CAM reads (tools/grad_cam.py).  ``group``, the data axis's process
    group of a data-parallel step (parallel/trainer.py), syncs the training
    BatchNorm statistics over the whole batch (models/cvt.py:72, :106); a
    model that ``parallel.shard_params`` split runs its tensor-parallel
    layers on its own.

    ``remat`` is accepted and changes nothing.  JAX rematerialises each
    block (``jax.checkpoint``, models/cvt.py:107-108) to fit many slots'
    activations in TPU memory; ``torch.utils.checkpoint`` would re-run the
    block in the backward, updating the BatchNorm moving statistics in place
    a second time and drawing new dropout from the generator, which changes
    the numbers.  One card holds the activations of a slot-step."""
    del remat
    spec = model.spec
    x = images
    cls_tokens = None
    features = []
    for stage in model.stages:
        x = stage.embed(x)
        for block in stage.blocks:
            x, cls = block(x, impl=impl, train=train, generator=generator,
                           mlp_impl=mlp_impl, group=group)
            if cls is not None:
                cls_tokens = cls
        if return_features:
            features.append(x)
    if cls_tokens is not None:
        feat = model.head_norm(cls_tokens)[:, 0, :]
    else:
        b, h, w, c = x.shape
        feat = model.head_norm(x.reshape(b, h * w, c)).mean(dim=1)
    if spec.proc_dim > 0:
        if proc is None:
            raise ValueError("spec.proc_dim > 0 requires proc inputs")
        p = torch.relu(model.proc_fc1(proc))
        p = torch.relu(model.proc_fc2(p))
        feat = torch.cat([feat, p], dim=-1)
    out = model.final(feat)
    return (out, features) if return_features else out


def cvt_param_count(model: CvT) -> int:
    return sum(p.numel() for p in model.parameters())
