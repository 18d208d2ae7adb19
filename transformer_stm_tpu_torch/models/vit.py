"""Plain ViT classifiers (ViT-Ti/S/B /16), transformer_stm_tpu/models/vit.py.

patchify -> patch embed + cls token + learned position embeddings -> a
pre-norm encoder (x += MHA(LN1 x); x += MLP(LN2 x), eps 1e-6) -> LN head
on the cls token -> Dense.  The module tree mirrors the JAX parameter tree
(``patch_embed``, ``pos_embed``, ``cls_token``, ``blocks``, ``head_norm``,
``head``), so train/checkpoint.py carries weights across by name.

    model = init_vit(VIT_PRESETS["ViT-S/16"], torch.Generator().manual_seed(0))
    logits = vit_forward(model.to(torch.bfloat16), images_bf16)

``vit_forward``'s routes (``impl``):

- ``"auto"``: evaluation of bfloat16 on a CUDA device takes ``"fused2"``
  (override with ``TSTM_VIT_INFER=plain|small|fused|fused2``), or
  ``"small"`` where ``fused_layer_fits`` refuses the token count, as JAX
  does on the TPU (:81-105); anything else takes the composable route with
  the router's attention and the fused inference MLP;
- ``"fused"``: each layer as ``attn_layer_infer`` + ``ln_mlp_infer``;
  ``"fused2"``: each layer as one ``vit_layer_infer``; ``"fused2_int8"``:
  ``vit_layer_infer_int8`` (opt-in, about 1% drift); all three inference
  only, on tokens folded to (B * t_pad, E) once;
- the composable route: ``"plain"`` (JAX's ``"xla"``), ``"small"``,
  ``"flash"`` (or ``"pallas"``, the JAX name); ``mlp_impl`` routes its MLP
  apart (default: ``impl``).  In training an MLP routed to ``"pallas"`` or
  ``"flash"`` runs the fused training MLP (``fused_mlp_train``), as JAX's
  does (ops/blocks.py:58-66), and any other the plain MLP.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ViTSpec
from ..kernels import fused_layer
from ..ops.attention import MHA, mha
from ..ops.blocks import MLP, mlp
from ..ops.common import Dense, LayerNorm, _param, dense, dropout, layer_norm

FUSED_IMPLS = ("fused", "fused2", "fused2_int8")


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, generator=None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MHA(dim, num_heads, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, hidden, generator)


class ViT(nn.Module):
    def __init__(self, spec: ViTSpec, generator=None):
        super().__init__()
        self.spec = spec
        n_patches = (spec.image_size // spec.patch_size) ** 2
        patch_dim = spec.patch_size * spec.patch_size * spec.num_channels
        e = spec.embed_dim
        self.patch_embed = Dense(patch_dim, e, generator)
        self.pos_embed = _param(0.02 * torch.randn(
            (1, n_patches + 1, e), generator=generator))
        self.cls_token = _param(torch.zeros(1, 1, e))
        self.blocks = nn.ModuleList(
            _Block(e, spec.num_heads, e * spec.mlp_ratio, generator)
            for _ in range(spec.depth))
        self.head_norm = LayerNorm(e)
        self.head = Dense(e, spec.num_classes, generator)


def init_vit(spec: ViTSpec, generator: torch.Generator,
             device="cuda") -> ViT:
    """Glorot-uniform kernels, zero biases and N(0, 0.02) position
    embeddings drawn from ``generator``, a CPU generator, in float32; cast
    with ``.to(torch.bfloat16)`` for bfloat16 inference."""
    return ViT(spec, generator).to(device)


def patchify(images, patch_size: int):
    """(B, H, W, C) -> (B, N, P*P*C) non-overlapping patches, row-major
    over the patch grid, each patch flattened as (P, P, C)."""
    b, h, w, c = images.shape
    p = patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _embed(model: ViT, images):
    """Patch embed, cls token in front, position embeddings: (B, T, E)."""
    x = dense(patchify(images, model.spec.patch_size),
              model.patch_embed.kernel, model.patch_embed.bias)
    cls = model.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[2])
    return torch.cat([cls, x], dim=1) + model.pos_embed.to(x.dtype)


def _head(model: ViT, x_cls):
    """LN head and Dense on the cls tokens (B, E)."""
    x = layer_norm(x_cls, model.head_norm.gamma, model.head_norm.beta, 1e-6)
    return dense(x, model.head.kernel, model.head.bias)


def _route_auto(spec: ViTSpec, images) -> str:
    """``impl="auto"`` in evaluation: bfloat16 on a CUDA device takes the
    fused layers unless ``fused_layer_fits`` refuses; else "auto"."""
    if not images.is_cuda or images.dtype != torch.bfloat16:
        return "auto"
    impl = os.environ.get("TSTM_VIT_INFER", "fused2")
    if impl in ("fused", "fused2"):
        t = (images.shape[1] // spec.patch_size) * \
            (images.shape[2] // spec.patch_size) + 1
        if not fused_layer.fused_layer_fits(
                -(-t // 8) * 8, spec.embed_dim, spec.num_heads,
                spec.embed_dim // spec.num_heads,
                spec.embed_dim * spec.mlp_ratio, 2):
            impl = "small"
    return impl


def vit_forward(model: ViT, images, *, train: bool = False, generator=None,
                impl: str = "auto", mlp_impl: str = None):
    """images: (B, H, W, C) in the model's type -> logits (B, num_classes).

    ``train=True`` runs the composable route with dropout after attention
    and in the MLP, drawn from ``generator`` on the images' device; the
    fused routes are inference only and raise."""
    spec = model.spec
    if impl == "auto" and not train:
        impl = _route_auto(spec, images)
    if impl in FUSED_IMPLS:
        if train:
            raise ValueError(f"impl={impl!r} is inference-only")
        return _vit_forward_fused(model, images, merged=(impl != "fused"),
                                  int8=(impl == "fused2_int8"))
    x = _embed(model, images)
    rate = spec.dropout_rate
    m_impl = mlp_impl if mlp_impl is not None else impl
    fused_train = "pallas" if m_impl in ("pallas", "flash") else None
    for blk in model.blocks:
        y = layer_norm(x, blk.norm1.gamma, blk.norm1.beta, 1e-6)
        y = mha(blk.attn, y, y, y, impl=impl)
        x = x + dropout(y, rate, train and rate > 0.0, generator)
        y = layer_norm(x, blk.norm2.gamma, blk.norm2.beta, 1e-6)
        x = x + mlp(blk.mlp, y, dropout_rate=rate, train=train,
                    generator=generator, impl=m_impl, mlp_impl=fused_train)
    return _head(model, x[:, 0, :])


def _vit_forward_fused(model: ViT, images, merged: bool = False,
                       int8: bool = False):
    """Fold (B, T, E) -> (B * t_pad, E) once, t_pad = T rounded up to 8 with
    zero rows, run every layer through the fused kernels, unfold at the
    head."""
    x = _embed(model, images)
    b, t, e = x.shape
    t_pad = -(-t // 8) * 8
    x = F.pad(x, (0, 0, 0, t_pad - t)).reshape(b * t_pad, e)
    for blk in model.blocks:
        if merged:
            layer = (fused_layer.vit_layer_infer_int8 if int8
                     else fused_layer.vit_layer_infer)
            x = layer(x, blk.norm1, blk.attn, blk.norm2, blk.mlp,
                      t_pad=t_pad, t_real=t)
        else:
            x = fused_layer.attn_layer_infer(x, blk.norm1, blk.attn,
                                             t_pad=t_pad, t_real=t)
            x = fused_layer.ln_mlp_infer(x, blk.norm2, blk.mlp)
    return _head(model, x.reshape(b, t_pad, e)[:, 0, :])


def classify_image(model: ViT, path: str, *, impl: str = "auto"):
    """Single-image classification (BASELINE.json config 1): cv2 decode,
    resize to the spec's size (INTER_LINEAR), grey (1 channel) or RGB, /255,
    ``vit_forward`` on the model's device and type, softmax in float32.
    Returns (probs (num_classes,) numpy, top-1 index).  The JAX package
    decodes 1-channel images with its native loader where it is built; the
    port decodes with cv2, imported when it runs, until that loader is
    ported."""
    import cv2

    spec = model.spec
    size = spec.image_size
    bgr = cv2.imread(path)
    if bgr is None:
        raise FileNotFoundError(path)
    code = cv2.COLOR_BGR2GRAY if spec.num_channels == 1 else cv2.COLOR_BGR2RGB
    img = cv2.cvtColor(cv2.resize(bgr, (size, size)), code)
    img = torch.from_numpy(img).float().reshape(1, size, size,
                                                spec.num_channels) / 255.0
    p = model.head.kernel
    with torch.inference_mode():
        logits = vit_forward(model, img.to(p.device, p.dtype), impl=impl)
    probs = torch.softmax(logits[0].float(), dim=-1).cpu().numpy()
    return probs, int(probs.argmax())
