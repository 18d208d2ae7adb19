"""Multi-head attention and the CvT ConvAttention
(transformer_stm_tpu/ops/attention.py).

``mha`` keeps the numerics of keras.layers.MultiHeadAttention (:126-143).
``_attention_core`` routes softmax(q k^T / sqrt(Dh)) v as the JAX router
does on the TPU (:69-112): with ``impl="auto"`` a head whose score matrix
has more than 300,000 entries, or a batch whose f32 scores would pass
1 GiB, goes to a kernel, and the others go to plain PyTorch.  The kernel is
``flash_attention`` when there are ``FLASH_MIN_KEYS`` (16,384) keys or
more (the 512px CvT's stage 1), else ``attention_small`` (the 128px CvT's
stage 1, the 512px CvT's stages 2 and 3).  The router does not look at the
mode: each kernel has its own backward.  ``impl="small"`` and
``impl="flash"`` (or ``"pallas"``, the JAX name for flash) force a kernel;
``impl="plain"``, the JAX ``"xla"``, keeps every call in plain PyTorch.

``ConvAttention`` (:170-218) keeps the reference's quirks: the q
projection is the identity when the method is 'avg'; a second set of Dense
projections proj_q/k/v follows the conv projections; Keras MHA is called as
(query, value, key), which is standard attention on (q, k, v); attention
dropout is built but never applied; in training the output projection is
followed by dropout (:217) and the dw_bn BatchNorms use batch statistics.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.attention_small import attention_small
from ..kernels.flash_attention import flash_attention
from .common import Dense, _param, dropout, glorot_uniform
from .projection import Projection

SMALL_MIN_ENTRIES = 300_000
FLASH_MIN_KEYS = 16_384
IMPLS = ("auto", "plain", "small", "flash", "pallas")


def _attention_plain(q, k, v):
    """softmax(q k^T / sqrt(Dh)) v in PyTorch, as the JAX einsum path."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _attention_core(q, k, v, *, impl: str = "auto"):
    """q: (B, T, H, Dh); k, v: (B, S, H, Dh) -> (B, T, H, Dh)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}, want {IMPLS}")
    if impl == "auto":
        entries = q.shape[1] * k.shape[1]
        score_bytes = 4 * q.shape[0] * q.shape[2] * entries
        if entries > SMALL_MIN_ENTRIES or score_bytes > (1 << 30):
            impl = "flash" if k.shape[1] >= FLASH_MIN_KEYS else "small"
        else:
            impl = "plain"
    if impl in ("flash", "pallas"):
        return flash_attention(q, k, v)
    if impl == "small":
        return attention_small(q, k, v)
    return _attention_plain(q, k, v)


class _Affine(nn.Module):
    """A kernel and a bias of given shapes (the Keras MHA einsum dense)."""

    def __init__(self, kernel_shape, bias_shape, fan_in, fan_out,
                 generator=None):
        super().__init__()
        self.kernel = _param(glorot_uniform(kernel_shape, fan_in, fan_out,
                                            generator))
        self.bias = _param(torch.zeros(bias_shape))


class MHA(nn.Module):
    """Keras MultiHeadAttention(num_heads, key_dim=dim // num_heads):
    query/key/value kernels (E, H, Dh) + bias (H, Dh); out (H, Dh, E) +
    bias (E,)."""

    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        h, dh = num_heads, dim // num_heads
        self.query, self.key, self.value = (
            _Affine((dim, h, dh), (h, dh), dim, h * dh, generator)
            for _ in range(3))
        self.out = _Affine((h, dh, dim), (dim,), h * dh, dim, generator)


def mha(m: MHA, query, key, value, *, impl: str = "auto"):
    """(B, T, E) x (B, S, E) x (B, S, E) -> (B, T, E), Keras numerics."""
    def proj_in(p, x):
        e, h, dh = p.kernel.shape
        y = torch.matmul(x, p.kernel.reshape(e, h * dh)) + p.bias.reshape(-1)
        return y.reshape(x.shape[0], x.shape[1], h, dh)

    q = proj_in(m.query, query)
    k = proj_in(m.key, key)
    v = proj_in(m.value, value)
    o = _attention_core(q, k, v, impl=impl)
    h, dh, e = m.out.kernel.shape
    out = torch.matmul(o.reshape(o.shape[0], o.shape[1], h * dh),
                       m.out.kernel.reshape(h * dh, e))
    return out + m.out.bias


class ConvAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int,
                 strides: int = 1, qkv_method: str = "dw_bn",
                 with_cls_token: bool = False, proj_drop: float = 0.1,
                 generator=None):
        super().__init__()
        self.strides = strides
        self.proj_drop = proj_drop
        self.with_cls_token = with_cls_token
        q_method = "linear" if qkv_method == "avg" else qkv_method
        self.q_proj = Projection(dim, kernel_size, q_method, generator)
        self.k_proj = Projection(dim, kernel_size, qkv_method, generator)
        self.v_proj = Projection(dim, kernel_size, qkv_method, generator)
        self.proj_q = Dense(dim, dim, generator)
        self.proj_k = Dense(dim, dim, generator)
        self.proj_v = Dense(dim, dim, generator)
        self.mha = MHA(dim, num_heads, generator)
        self.proj = Dense(dim, dim, generator)

    def forward(self, x, height: int, width: int, impl: str = "auto",
                train: bool = False, generator=None):
        """x: (B, N, C) tokens, N = H*W [+1 cls in front] -> (B, N, C).
        ``generator`` draws the output dropout in training."""
        b, _, c = x.shape
        if self.with_cls_token:
            cls_tokens, grid = x[:, :1, :], x[:, 1:, :]
        else:
            grid = x
        grid = grid.reshape(b, height, width, c)
        q = self.q_proj(grid, self.strides, train).reshape(b, -1, c)
        k = self.k_proj(grid, self.strides, train).reshape(b, -1, c)
        v = self.v_proj(grid, self.strides, train).reshape(b, -1, c)
        if self.with_cls_token:
            q = torch.cat([cls_tokens, q], dim=1)
            k = torch.cat([cls_tokens, k], dim=1)
            v = torch.cat([cls_tokens, v], dim=1)
        q, k, v = self.proj_q(q), self.proj_k(k), self.proj_v(v)
        # The reference calls attention(q, v, k) = Keras (query, value, key),
        # that is standard attention on (q, k, v).
        out = self.proj(mha(self.mha, q, k, v, impl=impl))
        return dropout(out, self.proj_drop, train, generator)
