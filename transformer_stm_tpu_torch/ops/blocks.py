"""GELU MLP and the CvT ConvTransformerBlock
(transformer_stm_tpu/ops/blocks.py).

The block keeps the reference's quirks (:104-145): one LayerNorm ``norm1``
serves before attention and again before the MLP; the cls token is a
zero-initialised (1, 1, D) weight tiled over the batch.  In training the
MLP takes the route ``mlp_impl`` if it is given, else the block's
``impl``, as JAX's block resolves it (:136-139): "pallas" and "flash" train
through the fused training kernel (:58-66; the JAX names are kept, they
name the CUDA kernel here), every other route through Dense -> GELU ->
Dropout -> Dense -> Dropout in plain PyTorch (:72-76).

Under tensor parallelism (parallel/sharding.py) ``MLP.tp_group`` is the
model axis's process group and fc1 and fc2 hold this rank's hidden units
(``_mlp_sharded``); the block passes ``group``, the data axis's process
group, on to the attention's BatchNorms.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_mlp import (STREAM_OUT, dropout_mask, fused_mlp,
                                 fused_mlp_plain, fused_mlp_train)
from .attention import IMPLS, ConvAttention
from .common import Dense, LayerNorm, _param, dense, dropout, gelu


class MLP(nn.Module):
    tp_group = None  # the model axis's group when the hidden units are split

    def __init__(self, dim: int, hidden_dim: int, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, generator)
        self.fc2 = Dense(hidden_dim, dim, generator)


MLP_IMPLS = (None, "xla", "pallas", "flash")
FUSED_ROUTES = ("pallas", "flash")


def mlp(m: MLP, x, *, dropout_rate: float = 0.1, train: bool = False,
        generator=None, impl: str = "auto", mlp_impl=None):
    """Dense -> exact GELU -> Dense on the route ``mlp_impl`` if it is not
    None, else ``impl``, as JAX's block passes it to its mlp
    (ops/blocks.py:136-139).  In training "pallas" and "flash" run the
    fused training MLP with dropout after the GELU and after the second
    Dense inside the kernel, its (2,) int32 seed drawn from ``generator``
    on x's device (zeros at rate 0, as :58-66 draws it); every other route
    the plain version with dropout drawn from ``generator``.  In evaluation
    "pallas", "flash" and "auto" run the fused kernel (on the CPU its plain
    version), as JAX's mlp routes "pallas" and "flash" and, on its
    accelerator, "auto" (:51-53, :67-70); "xla", "plain" and "small" the
    plain version on any device."""
    if impl not in IMPLS:
        raise ValueError(f"unknown mlp impl {impl!r}, want {IMPLS}")
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"unknown mlp_impl {mlp_impl!r}, want {MLP_IMPLS}")
    if train and dropout_rate > 0.0 and generator is None:
        raise ValueError("mlp: train=True with dropout_rate > 0 requires a "
                         "generator")
    route = mlp_impl if mlp_impl is not None else impl
    if m.tp_group is not None:
        return _mlp_sharded(m, x, route, dropout_rate, train, generator)
    if train and route in FUSED_ROUTES:
        return fused_mlp_train(x, m.fc1.kernel, m.fc1.bias, m.fc2.kernel,
                               m.fc2.bias,
                               _kernel_seed(generator, dropout_rate, x),
                               dropout_rate)
    if not train:
        f = (fused_mlp if route in ("auto",) + FUSED_ROUTES
             else fused_mlp_plain)
        return f(x, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias)
    y = dropout(gelu(dense(x, m.fc1.kernel, m.fc1.bias)), dropout_rate,
                train, generator)
    return dropout(dense(y, m.fc2.kernel, m.fc2.bias), dropout_rate, train,
                   generator)


def _kernel_seed(generator, rate: float, x):
    """The training kernel's (2,) int32 seed, drawn from ``generator`` on
    x's device, or zeros at rate 0 (:58-66)."""
    if rate > 0.0:
        return torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                             device=x.device, dtype=torch.int32)
    return torch.zeros(2, dtype=torch.int32, device=x.device)


def _mlp_sharded(m: MLP, x, route, rate: float, train: bool, generator):
    """The MLP with its hidden units split over ``m.tp_group``: fc1
    column-parallel on this rank's units, fc2 row-parallel, the ranks'
    products summed over the group, then fc2's bias, which every rank holds
    whole, added once.  The routes are the replicated MLP's, and the fused
    kernels take the rank's shard with fc2's bias left out (zeros).  In
    training the fused kernel drops its partial product with the output
    mask m2, which every rank draws alike from the same seed, so the sum is
    dropped as a whole and the bias takes m2 after it; its hidden mask m1
    is the rank's column block of the whole mask (``fused_mlp_train``'s
    ``part``).  The plain route draws the hidden mask whole and keeps the
    rank's columns (``dropout``'s ``part``) and drops the output after the
    sum.  On either route the shards train on the replicated MLP's
    masks."""
    import torch.distributed as dist

    from ..parallel.collectives import all_reduce_sum, replicated_input

    group = m.tp_group
    w1, b1, w2, b2 = m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias
    x = replicated_input(x, group)
    zeros = torch.zeros_like(b2)
    part = (dist.get_rank(group), dist.get_world_size(group))
    if train and route in FUSED_ROUTES:
        seed = _kernel_seed(generator, rate, x)
        y = all_reduce_sum(fused_mlp_train(x, w1, b1, w2, zeros, seed, rate,
                                           part), group)
        d = y.shape[-1]
        m2 = dropout_mask(seed, y.numel() // d, d, STREAM_OUT, rate)
        return y + (b2 * m2).reshape(y.shape).to(y.dtype)
    if not train:
        f = (fused_mlp if route in ("auto",) + FUSED_ROUTES
             else fused_mlp_plain)
        y = all_reduce_sum(f(x, w1, b1, w2, zeros), group)
        return y + b2.to(y.dtype)
    h = dropout(gelu(dense(x, w1, b1)), rate, train, generator, part)
    y = all_reduce_sum(dense(h, w2), group) + b2.to(x.dtype)
    return dropout(y, rate, train, generator)


class ConvTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int,
                 strides: int = 1, qkv_method: str = "dw_bn",
                 mlp_ratio: int = 4, with_cls_token: bool = False,
                 dropout_rate: float = 0.1, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNorm(dim)  # shared: attention AND mlp pre-norm
        self.attn = ConvAttention(dim, num_heads, kernel_size, strides,
                                  qkv_method, with_cls_token, dropout_rate,
                                  generator)
        self.mlp = MLP(dim, dim * mlp_ratio, generator)
        if with_cls_token:
            self.cls_token = _param(torch.zeros(1, 1, dim))

    def forward(self, x, impl: str = "auto", train: bool = False,
                generator=None, mlp_impl=None, group=None):
        """x: (B, H, W, C) -> ((B, H, W, C), cls (B, 1, C) or None).
        ``train`` uses the batch statistics, synced over ``group`` (the data
        axis's process group) when it is given, and dropout, drawn from
        ``generator``; the MLP runs on ``mlp_impl`` if it is given, else
        on ``impl`` (``mlp``)."""
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        with_cls = hasattr(self, "cls_token")
        if with_cls:
            tokens = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, c),
                                tokens], 1)
        tokens = tokens + self.attn(self.norm1(tokens), h, w, impl=impl,
                                    train=train, generator=generator,
                                    group=group)
        tokens = tokens + mlp(self.mlp, self.norm1(tokens),
                              dropout_rate=self.dropout_rate, train=train,
                              generator=generator, impl=impl,
                              mlp_impl=mlp_impl)
        if with_cls:
            return tokens[:, 1:, :].reshape(b, h, w, c), tokens[:, :1, :]
        return tokens.reshape(b, h, w, c), None
