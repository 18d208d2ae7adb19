"""GELU MLP and the CvT ConvTransformerBlock
(transformer_stm_tpu/ops/blocks.py).

The block keeps the reference's quirks (:104-145): one LayerNorm ``norm1``
serves before attention and again before the MLP; the cls token is a
zero-initialised (1, 1, D) weight tiled over the batch.  In training the
MLP is Dense -> GELU -> Dropout -> Dense -> Dropout in plain PyTorch, as
the JAX single-target trainer runs it (:52-53, :72-76), unless the caller
asks for the fused training kernel with ``mlp_impl="pallas"``, as the JAX
multi-target trainer does (:58-66; the JAX name is kept, it names the
CUDA kernel here).
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_mlp import fused_mlp, fused_mlp_plain, fused_mlp_train
from .attention import IMPLS, ConvAttention
from .common import Dense, LayerNorm, _param, dense, dropout, gelu


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, generator)
        self.fc2 = Dense(hidden_dim, dim, generator)


MLP_IMPLS = (None, "xla", "pallas")


def mlp(m: MLP, x, *, dropout_rate: float = 0.1, train: bool = False,
        generator=None, impl: str = "auto", mlp_impl=None):
    """Dense -> exact GELU -> Dense.  In evaluation ``impl="auto"``,
    ``"pallas"`` and ``"flash"`` run the fused kernel (on the CPU its plain
    version), as JAX's mlp routes "pallas" and "flash" (ops/blocks.py:
    67-70), and ``"plain"`` or ``"small"`` the plain version on any device.
    In training, with ``mlp_impl="pallas"``, the fused training MLP with
    dropout after the GELU and after the second Dense inside the kernel,
    its (2,) int32 seed drawn from ``generator`` on x's device (zeros at
    rate 0, as ops/blocks.py:60-62 draws it); otherwise the plain version
    with dropout drawn from ``generator``.  ``mlp_impl`` is read in
    training only."""
    if impl not in IMPLS:
        raise ValueError(f"unknown mlp impl {impl!r}, want {IMPLS}")
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"unknown mlp_impl {mlp_impl!r}, want {MLP_IMPLS}")
    if train and dropout_rate > 0.0 and generator is None:
        raise ValueError("mlp: train=True with dropout_rate > 0 requires a "
                         "generator")
    if train and mlp_impl == "pallas":
        if dropout_rate > 0.0:
            seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                                 device=x.device, dtype=torch.int32)
        else:
            seed = torch.zeros(2, dtype=torch.int32, device=x.device)
        return fused_mlp_train(x, m.fc1.kernel, m.fc1.bias, m.fc2.kernel,
                               m.fc2.bias, seed, dropout_rate)
    if not train:
        f = (fused_mlp if impl in ("auto", "pallas", "flash")
             else fused_mlp_plain)
        return f(x, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias)
    y = dropout(gelu(dense(x, m.fc1.kernel, m.fc1.bias)), dropout_rate,
                train, generator)
    return dropout(dense(y, m.fc2.kernel, m.fc2.bias), dropout_rate, train,
                   generator)


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
                generator=None, mlp_impl=None):
        """x: (B, H, W, C) -> ((B, H, W, C), cls (B, 1, C) or None).
        ``train`` uses the batch statistics and dropout, drawn from
        ``generator``; ``mlp_impl`` picks the training MLP (``mlp``)."""
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        with_cls = hasattr(self, "cls_token")
        if with_cls:
            tokens = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, c),
                                tokens], 1)
        tokens = tokens + self.attn(self.norm1(tokens), h, w, impl=impl,
                                    train=train, generator=generator)
        tokens = tokens + mlp(self.mlp, self.norm1(tokens),
                              dropout_rate=self.dropout_rate, train=train,
                              generator=generator, impl=impl,
                              mlp_impl=mlp_impl)
        if with_cls:
            return tokens[:, 1:, :].reshape(b, h, w, c), tokens[:, :1, :]
        return tokens.reshape(b, h, w, c), None
