"""Convolutional patch embedding (transformer_stm_tpu/ops/conv_embed.py:27).

The reference's LayerNorm after the embed conv is dead at runtime
(models/CvT(Par).py:209): ``norm=False``, the default, keeps that quirk;
``norm=True`` applies the LayerNorm (eps 1e-3) it intended.

Under tensor parallelism (parallel/sharding.py) ``tp_group`` is the model
axis's process group and the kernel holds this rank's output channels: the
rank computes them without the bias, the shards are gathered along the
channels, and the bias, which every rank holds whole, is added once to
the whole before the norm.
"""

from __future__ import annotations

from torch import nn

from .common import Conv2d, LayerNorm, conv2d


class ConvEmbed(nn.Module):
    tp_group = None  # the model axis's group when the channels are split

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int,
                 stride: int, norm: bool = False, generator=None):
        super().__init__()
        self.stride = stride
        self.proj = Conv2d(in_ch, embed_dim, patch_size, generator)
        if norm:
            self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        """x: (B, H, W, Cin) -> (B, ceil(H/s), ceil(W/s), D)."""
        if self.tp_group is None:
            y = self.proj(x, self.stride)
        else:
            from ..parallel.collectives import all_gather, replicated_input

            x = replicated_input(x, self.tp_group)
            y = all_gather(conv2d(x, self.proj.kernel, stride=self.stride),
                           -1, self.tp_group, grad="slice")
            y = y + self.proj.bias.to(y.dtype)
        if hasattr(self, "norm"):
            y = self.norm(y, eps=1e-3)
        return y
