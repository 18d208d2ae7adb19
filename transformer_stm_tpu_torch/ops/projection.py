"""Conv QKV projection (transformer_stm_tpu/ops/projection.py:34):

- ``dw_bn``:  DepthwiseConv2D(k, s, same, no bias) + BatchNormalization;
- ``avg``:    AveragePooling2D(k, s, same), padding left out of the divisor;
- ``linear``: the identity, with no parameters (a reference quirk).
"""

from __future__ import annotations

from torch import nn

from .common import BatchNorm, DepthwiseConv2d, avg_pool_same

METHODS = ("dw_bn", "avg", "linear")


class Projection(nn.Module):
    def __init__(self, dim: int, kernel_size: int, method: str,
                 generator=None):
        super().__init__()
        if method not in METHODS:
            raise ValueError(f"Unknown method: {method}")
        self.kernel_size = kernel_size
        self.method = method
        if method == "dw_bn":
            self.conv = DepthwiseConv2d(dim, kernel_size, generator)
            self.bn = BatchNorm(dim)

    def forward(self, x, stride: int, train: bool = False):
        """x: (B, H, W, C) -> (B, H', W', C); ``train`` normalises with the
        batch statistics and updates the BatchNorm's moving ones."""
        if self.method == "dw_bn":
            return self.bn(self.conv(x, stride), train=train)
        if self.method == "avg":
            return avg_pool_same(x, self.kernel_size, stride)
        return x
