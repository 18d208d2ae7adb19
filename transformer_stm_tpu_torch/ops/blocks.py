"""GELU MLP and the CvT ConvTransformerBlock
(transformer_stm_tpu/ops/blocks.py).

The block keeps the reference's quirks (:104-145): one LayerNorm ``norm1``
serves before attention and again before the MLP; the cls token is a
zero-initialised (1, 1, D) weight tiled over the batch.  Dropout is not
applied: this slice evaluates.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_mlp import fused_mlp, fused_mlp_plain
from .attention import IMPLS, ConvAttention
from .common import Dense, LayerNorm, _param


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, generator)
        self.fc2 = Dense(hidden_dim, dim, generator)


def mlp(m: MLP, x, *, impl: str = "auto"):
    """Dense -> exact GELU -> Dense.  ``impl="auto"`` runs the fused
    kernel (on the CPU its plain version); ``impl="plain"`` the plain
    version on any device."""
    if impl not in IMPLS:
        raise ValueError(f"unknown mlp impl {impl!r}, want {IMPLS}")
    f = fused_mlp if impl == "auto" else fused_mlp_plain
    return f(x, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias)


class ConvTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int,
                 strides: int = 1, qkv_method: str = "dw_bn",
                 mlp_ratio: int = 4, with_cls_token: bool = False,
                 generator=None):
        super().__init__()
        self.norm1 = LayerNorm(dim)  # shared: attention AND mlp pre-norm
        self.attn = ConvAttention(dim, num_heads, kernel_size, strides,
                                  qkv_method, with_cls_token, generator)
        self.mlp = MLP(dim, dim * mlp_ratio, generator)
        if with_cls_token:
            self.cls_token = _param(torch.zeros(1, 1, dim))

    def forward(self, x, impl: str = "auto"):
        """x: (B, H, W, C) -> ((B, H, W, C), cls (B, 1, C) or None)."""
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        with_cls = hasattr(self, "cls_token")
        if with_cls:
            tokens = torch.cat([self.cls_token.expand(b, 1, c), tokens], 1)
        tokens = tokens + self.attn(self.norm1(tokens), h, w, impl=impl)
        tokens = tokens + mlp(self.mlp, self.norm1(tokens), impl=impl)
        if with_cls:
            return tokens[:, 1:, :].reshape(b, h, w, c), tokens[:, :1, :]
        return tokens.reshape(b, h, w, c), None
