"""attention_small: exact softmax(q k^T / sqrt(Dh)) v, inference forward.

Port of the Pallas TPU kernel ``attention_small``
(transformer_stm_tpu/kernels/flash_attention.py:935; forward
``_small_fwd_impl`` :703 and ``_small_fwd_kernel`` :680).  The CUDA kernel
is ``csrc/attention_small.cu``; its header says how it streams K/V where
the TPU kernel held whole rows in VMEM.  The backward pair (:764, :791) is
not ported yet: this slice only evaluates.

``attention_small`` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises.
"""

from __future__ import annotations

import math

import torch

from ._build import library

HEAD_DIM = 64


def attention_small_plain(q, k, v):
    """The kernel's arithmetic in PyTorch: f32 scores (q . k) * scale, the
    row max subtracted before exp, the output divided by the row sum.
    q: (B, T, H, Dh); k, v: (B, S, H, Dh) -> (B, T, H, Dh)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, T, H, 1)
    return torch.einsum("bhts,bshd->bthd", p, v) / l


def _check(q, k, v):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("attention_small: q, k and v must lie on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"attention_small: {name} must be a contiguous "
                             f"4-d float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, t, h, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"attention_small: head dim must be {HEAD_DIM}, "
                         f"got {dh}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh):
        raise ValueError("attention_small: shapes do not match: "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if b * h > 65535:
        raise ValueError(f"attention_small: B*H = {b * h} exceeds 65,535")


def attention_small(q, k, v):
    """q: (B, T, H, 64); k, v: (B, S, H, 64), float32 -> (B, T, H, 64)."""
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return attention_small_plain(q, k, v)
    _check(q, k, v)
    b, t, h, dh = q.shape
    o = torch.empty_like(q)
    rc = library().launch_attention_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, t, k.shape[1], h, dh, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_attention_small failed: CUDA error {rc}")
    attention_small.launches += 1
    return o


# Kernel launches so far; a caller resets it to 0 to count a run.
attention_small.launches = 0
