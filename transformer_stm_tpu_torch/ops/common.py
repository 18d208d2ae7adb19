"""Foundational ops with the numerics of transformer_stm_tpu/ops/common.py:
TF-SAME convolutions in NHWC with HWIO kernels, dense, LayerNorm (eps
1e-6), BatchNorm (eps 1e-3, momentum 0.99; batch statistics in training),
SAME average pooling whose divisor leaves out the padding, exact erf GELU
and inverted dropout.  In bfloat16 they keep the JAX package's rounding
points: ``dense`` and the convolutions cast their kernel and bias to x's
type, ``layer_norm`` and both BatchNorms compute in float32 and cast the
result back, and ``gelu`` evaluates the Abramowitz-Stegun rational erf in
float32 (:245-267).  Each
parameterised op also has
a small ``nn.Module`` that holds its parameters under the JAX names, so a
checkpoint's path-keyed leaves map one to one onto ``state_dict`` names.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
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
    """A parameter that records no gradient until training asks for one
    (``train/loop.py`` turns ``requires_grad`` on)."""
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
    y = F.conv2d(xc, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    return y + bias.to(y.dtype) if bias is not None else y


def depthwise_conv2d(x, kernel, bias=None, stride: int = 1,
                     padding: str = "same"):
    """Depthwise NHWC conv; kernel (kh, kw, C, 1)."""
    kh, kw, c, mult = kernel.shape
    xc = x.permute(0, 3, 1, 2)
    if padding == "same":
        xc = _pad_same(xc, kh, kw, stride)
    w = kernel.to(x.dtype).permute(2, 3, 0, 1).reshape(c * mult, 1, kh, kw)
    y = F.conv2d(xc, w, stride=stride, groups=c).permute(0, 2, 3, 1)
    return y + bias.to(y.dtype) if bias is not None else y


def dense(x, kernel, bias=None):
    """y = x @ W + b on the last axis, W and b cast to x's type (:149)."""
    y = torch.matmul(x, kernel.to(x.dtype))
    return y + bias.to(x.dtype) if bias is not None else y


# ---------------------------------------------------------------------------
# Norms, pooling, activation
# ---------------------------------------------------------------------------

def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis with the biased variance; statistics
    and affine in float32, the result in x's type (:166)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def compute_type(x):
    """The type x is computed in: float32 for bfloat16 or float32 x, float64
    for float64 x (a check then shares no rounding with float32)."""
    return torch.promote_types(x.dtype, torch.float32)


def batch_norm(x, gamma, beta, mean, var, eps: float = 1e-3):
    """Inference BatchNorm over the last axis from the moving statistics,
    in float32, the result in x's type (:192-217)."""
    xf = x.to(compute_type(x))
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def batch_norm_train(x, gamma, beta, moving_mean, moving_var,
                     momentum: float = 0.99, eps: float = 1e-3, group=None):
    """Training BatchNorm over all axes but the last (ops/common.py:186-215):
    normalises with the batch mean and the biased variance E[x^2] - mean^2,
    both taken in float32 as the normalisation is, returns x's type, and
    updates ``moving_mean`` and ``moving_var`` in place, outside autograd;
    the moving variance takes the unbiased n/(n-1) estimate, as the Keras-2
    fused BatchNorm the reference ran on does.

    With ``group`` (the data axis's process group) the statistics are the
    whole batch's: the mean over the group of the ranks' mean and mean of
    squares, differentiably, and n times the group's size in Bessel's
    factor, as JAX's pmean over ``axis_name`` (:194-206)."""
    xf = x.to(compute_type(x))
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    mean_sq = xf.square().mean(dim=axes)
    n = x.numel() // x.shape[-1]
    if group is not None:
        from ..parallel.collectives import all_reduce_sum

        world = dist.get_world_size(group)
        stats = all_reduce_sum(torch.stack([mean, mean_sq]), group,
                               grad="sum") / world
        mean, mean_sq = stats[0], stats[1]
        n *= world
    var = mean_sq - mean.square()
    bessel = n / max(n - 1, 1)
    with torch.no_grad():
        moving_mean.copy_(momentum * moving_mean + (1 - momentum) * mean)
        moving_var.copy_(momentum * moving_var
                         + (1 - momentum) * var * bessel)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


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
    """Exact (erf) GELU, the Keras default.  bfloat16 input takes the
    Abramowitz-Stegun rational erf in float32, as the JAX function does
    (:245), and is cast back."""
    if x.dtype == torch.bfloat16:
        xf = x.float()
        return (xf * 0.5 * (1.0 + erf_rational(xf * 0.7071067811865476))
                ).to(x.dtype)
    return x * 0.5 * (1.0 + torch.special.erf(x * 0.7071067811865476))


def erf_rational(x):
    """Abramowitz-Stegun 7.1.26 rational erf, |error| <= 1.5e-7 (:260)."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def dropout(x, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            part: Tuple[int, int] = (0, 1)):
    """Inverted dropout (Keras semantics, ops/common.py:270): each element
    is kept with probability 1 - rate and scaled by 1 / (1 - rate).  The
    draws come from ``generator``, which lies on x's device.  A no-op in
    evaluation or at rate 0.  ``part`` = (i, k): x is the i-th of k equal
    parts of the last axis of a wider tensor (a shard of the MLP's hidden
    units, parallel/sharding.py), whose mask is drawn whole and cut, so
    that each part keeps the mask the whole tensor would have."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout: train=True with rate > 0 requires a "
                         "generator")
    keep = 1.0 - rate
    i, k = part
    w = x.shape[-1]
    mask = torch.rand((*x.shape[:-1], w * k), generator=generator,
                      device=x.device).narrow(-1, i * w, w) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
    """Keras BatchNormalization: parameters gamma and beta, moving
    statistics ``mean`` and ``var`` as buffers (the JAX state), updated
    once per forward in training."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = _param(torch.ones(dim))
        self.beta = _param(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, train: bool = False, group=None):
        """``group``: the data axis's process group, over which training
        syncs the batch statistics (``batch_norm_train``)."""
        if train:
            return batch_norm_train(x, self.gamma, self.beta, self.mean,
                                    self.var, group=group)
        return batch_norm(x, self.gamma, self.beta, self.mean, self.var)
