"""Convolutional patch embedding (transformer_stm_tpu/ops/conv_embed.py:27).

The reference's LayerNorm after the embed conv is dead at runtime
(models/CvT(Par).py:209): ``norm=False``, the default, keeps that quirk;
``norm=True`` applies the LayerNorm (eps 1e-3) it intended.
"""

from __future__ import annotations

from torch import nn

from .common import Conv2d, LayerNorm


class ConvEmbed(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int, patch_size: int,
                 stride: int, norm: bool = False, generator=None):
        super().__init__()
        self.stride = stride
        self.proj = Conv2d(in_ch, embed_dim, patch_size, generator)
        if norm:
            self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        """x: (B, H, W, Cin) -> (B, ceil(H/s), ceil(W/s), D)."""
        y = self.proj(x, self.stride)
        if hasattr(self, "norm"):
            y = self.norm(y, eps=1e-3)
        return y
