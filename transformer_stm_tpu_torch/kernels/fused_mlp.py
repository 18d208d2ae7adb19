"""fused_mlp: GELU(x W1 + b1) W2 + b2 with the hidden activation on chip.

Port of the Pallas TPU kernel ``fused_mlp``
(transformer_stm_tpu/kernels/fused_mlp.py:62; body ``_mlp_kernel`` :52),
the inference MLP of every CvT block.  The CUDA kernel is
``csrc/fused_mlp.cu``.  The training kernels of that module
(``make_fused_mlp_train`` :291) are not ported yet.

``fused_mlp`` takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device, or raises.
"""

from __future__ import annotations

import torch

from ..ops.common import dense, gelu
from ._build import library

WIDTHS = (64, 128, 256)  # the CvT stage widths the kernel is built for
HIDDEN_CHUNK = 64


def fused_mlp_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in PyTorch, exact erf GELU.
    x: (..., D); w1: (D, Hd); w2: (Hd, D) -> (..., D)."""
    return dense(gelu(dense(x, w1, b1)), w2, b2)


def _check(x, w1, b1, w2, b2):
    tensors = (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))
    for name, t in tensors:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"fused_mlp: {name} must lie on the CUDA device "
                             f"of x, got {t.device} and {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous float32, "
                             f"got {t.dtype}")
    d = x.shape[-1]
    hd = w1.shape[-1] if w1.dim() == 2 else -1
    if d not in WIDTHS:
        raise ValueError(f"fused_mlp: width {d} not in {WIDTHS}")
    if w1.shape != (d, hd) or hd % HIDDEN_CHUNK or b1.shape != (hd,) or \
            w2.shape != (hd, d) or b2.shape != (d,):
        raise ValueError("fused_mlp: weight shapes do not match: x "
                         f"{tuple(x.shape)} w1 {tuple(w1.shape)} b1 "
                         f"{tuple(b1.shape)} w2 {tuple(w2.shape)} b2 "
                         f"{tuple(b2.shape)}; the hidden width must be a "
                         f"multiple of {HIDDEN_CHUNK}")


def fused_mlp(x, w1, b1, w2, b2):
    """x: (..., D) float32, D in WIDTHS; w1 (D, Hd); w2 (Hd, D)."""
    if all(t.device.type == "cpu" for t in (x, w1, b1, w2, b2)):
        return fused_mlp_plain(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    d, hd = w1.shape
    n = x.numel() // d
    y = torch.empty_like(x)
    rc = library().launch_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, d, hd, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_fused_mlp failed: CUDA error {rc}")
    fused_mlp.launches += 1
    return y


# Kernel launches so far; a caller resets it to 0 to count a run.
fused_mlp.launches = 0
