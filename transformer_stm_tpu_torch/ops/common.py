"""Foundational ops with the numerics of transformer_stm_tpu/ops/common.py:
TF-SAME convolutions in NHWC with HWIO kernels, dense, LayerNorm (eps
1e-6), inference BatchNorm (eps 1e-3), SAME average pooling whose divisor
leaves out the padding, and exact erf GELU.  Each parameterised op also has
a small ``nn.Module`` that holds its parameters under the JAX names, so a
checkpoint's path-keyed leaves map one to one onto ``state_dict`` names.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def use_true_f32() -> None:
    """Float32 products and convolutions in full float32 on the card.
    cuDNN convolutions default to TF32, which alone moves the CvT output by
    more than 1e-3; the JAX package evaluates in true f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: Optional[torch.Generator] = None):
    """Keras default kernel initializer."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def _param(t):
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Padding and convolutions
# ---------------------------------------------------------------------------

def same_padding(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow 'SAME' padding of one spatial dim, the extra pad after."""
    out_size = -(-in_size // stride)
    pad = max((out_size - 1) * stride + kernel - in_size, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x_nchw, kh: int, kw: int, stride: int):
    top, bottom = same_padding(x_nchw.shape[2], kh, stride)
    left, right = same_padding(x_nchw.shape[3], kw, stride)
    return F.pad(x_nchw, (left, right, top, bottom))


def conv2d(x, kernel, bias=None, stride: int = 1, padding: str = "same"):
    """NHWC conv, HWIO kernel, TF-SAME padding: (B, H, W, Cin) ->
    (B, H', W', Cout)."""
    kh, kw = kernel.shape[:2]
    xc = x.permute(0, 3, 1, 2)
    if padding == "same":
        xc = _pad_same(xc, kh, kw, stride)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    return y + bias if bias is not None else y


def depthwise_conv2d(x, kernel, bias=None, stride: int = 1,
                     padding: str = "same"):
    """Depthwise NHWC conv; kernel (kh, kw, C, 1)."""
    kh, kw, c, mult = kernel.shape
    xc = x.permute(0, 3, 1, 2)
    if padding == "same":
        xc = _pad_same(xc, kh, kw, stride)
    w = kernel.permute(2, 3, 0, 1).reshape(c * mult, 1, kh, kw)
    y = F.conv2d(xc, w, stride=stride, groups=c).permute(0, 2, 3, 1)
    return y + bias if bias is not None else y


def dense(x, kernel, bias=None):
    """y = x @ W + b on the last axis."""
    y = torch.matmul(x, kernel)
    return y + bias if bias is not None else y


# ---------------------------------------------------------------------------
# Norms, pooling, activation
# ---------------------------------------------------------------------------

def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis with the biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def batch_norm(x, gamma, beta, mean, var, eps: float = 1e-3):
    """Inference BatchNorm over the last axis from the moving statistics."""
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def avg_pool_same(x, pool_size: int, stride: int):
    """Keras AveragePooling2D(padding='same') on NHWC: padded cells are left
    out of the divisor."""
    xc = _pad_same(x.permute(0, 3, 1, 2), pool_size, pool_size, stride)
    ones = _pad_same(x.new_ones((1, 1) + tuple(x.shape[1:3])),
                     pool_size, pool_size, stride)
    summed = F.avg_pool2d(xc, pool_size, stride, divisor_override=1)
    counts = F.avg_pool2d(ones, pool_size, stride, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def gelu(x):
    """Exact (erf) GELU, the Keras default."""
    return x * 0.5 * (1.0 + torch.special.erf(x * 0.7071067811865476))


# ---------------------------------------------------------------------------
# Parameter holders
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """Keras Dense: kernel (in, out) glorot-uniform, bias zeros."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.kernel = _param(glorot_uniform((in_dim, out_dim), in_dim,
                                            out_dim, generator))
        self.bias = _param(torch.zeros(out_dim))

    def forward(self, x):
        return dense(x, self.kernel, self.bias)


class Conv2d(nn.Module):
    """Keras Conv2D: kernel (k, k, in, out), bias zeros."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 generator=None):
        super().__init__()
        rf = kernel_size * kernel_size
        self.kernel = _param(glorot_uniform(
            (kernel_size, kernel_size, in_ch, out_ch), in_ch * rf,
            out_ch * rf, generator))
        self.bias = _param(torch.zeros(out_ch))

    def forward(self, x, stride: int):
        return conv2d(x, self.kernel, self.bias, stride=stride)


class DepthwiseConv2d(nn.Module):
    """Keras DepthwiseConv2D without bias: kernel (k, k, C, 1)."""

    def __init__(self, channels: int, kernel_size: int, generator=None):
        super().__init__()
        rf = kernel_size * kernel_size
        self.kernel = _param(glorot_uniform(
            (kernel_size, kernel_size, channels, 1), rf * channels, rf,
            generator))

    def forward(self, x, stride: int):
        return depthwise_conv2d(x, self.kernel, stride=stride)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = _param(torch.ones(dim))
        self.beta = _param(torch.zeros(dim))

    def forward(self, x, eps: float = 1e-6):
        return layer_norm(x, self.gamma, self.beta, eps)


class BatchNorm(nn.Module):
    """Keras BatchNormalization in inference: parameters gamma and beta,
    moving statistics ``mean`` and ``var`` as buffers (the JAX state)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = _param(torch.ones(dim))
        self.beta = _param(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        return batch_norm(x, self.gamma, self.beta, self.mean, self.var)
