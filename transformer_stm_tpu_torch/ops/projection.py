"""Conv QKV projection (transformer_stm_tpu/ops/projection.py:34):

- ``dw_bn``:  DepthwiseConv2D(k, s, same, no bias) + BatchNormalization;
- ``avg``:    AveragePooling2D(k, s, same), padding left out of the divisor;
- ``linear``: the identity, with no parameters (a reference quirk).

Under tensor parallelism (parallel/sharding.py) ``tp_group`` is the model
axis's process group and the depthwise kernel holds this rank's channels:
the rank convolves its channels of x and the shards are gathered along the
channels before the BatchNorm, which every rank then runs whole.
"""

from __future__ import annotations

from torch import nn

from .common import BatchNorm, DepthwiseConv2d, avg_pool_same

METHODS = ("dw_bn", "avg", "linear")


class Projection(nn.Module):
    tp_group = None  # the model axis's group when the channels are split

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

    def forward(self, x, stride: int, train: bool = False, group=None):
        """x: (B, H, W, C) -> (B, H', W', C); ``train`` normalises with the
        batch statistics and updates the BatchNorm's moving ones, synced
        over ``group``, the data axis's process group, when it is given."""
        if self.method == "dw_bn":
            return self.bn(self._conv(x, stride), train=train, group=group)
        if self.method == "avg":
            return avg_pool_same(x, self.kernel_size, stride)
        return x

    def _conv(self, x, stride: int):
        if self.tp_group is None:
            return self.conv(x, stride)
        import torch.distributed as dist

        from ..parallel.collectives import all_gather, replicated_input

        c = self.conv.kernel.shape[2]
        start = dist.get_rank(self.tp_group) * c
        x = replicated_input(x, self.tp_group).narrow(-1, start, c)
        return all_gather(self.conv(x, stride), -1, self.tp_group,
                          grad="slice")
