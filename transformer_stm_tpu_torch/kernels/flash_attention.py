"""flash_attention: softmax(q k^T / sqrt(Dh)) v for long sequences and any
head dim, forward and backward.

Port of the Pallas TPU kernel ``flash_attention``
(transformer_stm_tpu/kernels/flash_attention.py:174-639, a
``jax.custom_vjp``): the forward ``_flash_kernel`` :48 (``_flash_fwd_impl``
:102) is ``csrc/flash_attention.cu``; both backward pairs, the
whole-side-resident ``_bwd_pallas`` :296 and the streaming
``_bwd_pallas_streaming`` :469 that ``_bwd`` :601 picks at 512px, are the
one pair of ``csrc/flash_attention_bwd.cu``.  Both run f32 products in
3xTF32 on the tensor cores (csrc/tf32x3.cuh); before them the wrapper
zero-pads the head dim to what the kernels' TMA loads and 8-deep k-steps
take (``padded_head_dim``), keeps the scale of the true head dim and
slices the outputs, and before the backward it computes delta.  The JAX
router sends keys of
16,384 and more here (the 512px CvT's stage 1); the kernels take any Dh
from 1 to 256 (the TPU kernel pads Dh to 128 lanes, so it takes any head
dim) and any lengths.

``flash_attention(q, k, v)`` is differentiable: when autograd records it
runs ``FlashAttention``, whose forward also writes the per-row lse and
saves q, k, v, o and lse for the backward kernels (``FlashAttentionBwd``);
otherwise it runs the lse-free forward (``FlashAttentionEval``) and saves
nothing.  The three come from ``attention_small.autograd_functions``, with
vmap rules, as ``AttentionSmall``'s do.
Tensors on the CPU take the plain versions below, which stream K/V in
blocks of keys as the kernels do, so that they never hold a (T, S) score
matrix (1 GiB per image and head at 512px); tensors on a CUDA device launch
the kernels, or raise.
"""

from __future__ import annotations

import math

import torch

from ._build import aligned16, library
from .attention_small import _on_cpu, apply, autograd_functions

MAX_HEAD_DIM = 256
PLAIN_BLOCK = 512  # keys per block of the plain versions


def flash_attention_plain(q, k, v, with_lse: bool = False,
                          block: int = PLAIN_BLOCK):
    """The forward kernel's arithmetic in PyTorch, ``block`` keys at a
    time: f32 scores (q . k) * scale, a running row max m and denominator
    l, the accumulator rescaled by exp(m_old - m_new) as m grows, divided
    by l at the end.  q: (B, T, H, Dh); k, v: (B, S, H, Dh) -> o
    (B, T, H, Dh), and with ``with_lse`` also lse = m + log(l), (B, H, T)."""
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    m = q.new_full((b, h, t, 1), -math.inf)
    l = q.new_zeros((b, h, t, 1))
    acc = q.new_zeros((b, h, t, dh))
    for s0 in range(0, k.shape[1], block):
        s = torch.einsum("bthd,bshd->bhts", q, k[:, s0:s0 + block]) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", p,
                                         v[:, s0:s0 + block])
        m = m_new
    o = (acc / l).permute(0, 2, 1, 3).contiguous()
    if not with_lse:
        return o
    return o, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, g, block: int = PLAIN_BLOCK,
                              scale: float | None = None):
    """The backward kernels' arithmetic in PyTorch, ``block`` keys at a
    time: p rebuilt from the saved lse, dp = dO . v, delta = rowsum(dO * o),
    dS = p (dp - delta); dq = scale sum dS k, dk = scale dS^T q,
    dv = p^T dO.  q, o, g: (B, T, H, Dh); k, v: (B, S, H, Dh); lse:
    (B, H, T); scale 1/sqrt(Dh) unless given (as for zero-padded inputs)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (g * o).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B,H,T,1)
    lse = lse.unsqueeze(-1)
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for s0 in range(0, k.shape[1], block):
        kb, vb = k[:, s0:s0 + block], v[:, s0:s0 + block]
        p = torch.exp(torch.einsum("bthd,bshd->bhts", q, kb) * scale - lse)
        ds = p * (torch.einsum("bthd,bshd->bhts", g, vb) - delta)
        dq = dq + torch.einsum("bhts,bshd->bthd", ds, kb) * scale
        dks.append(torch.einsum("bhts,bthd->bshd", ds, q) * scale)
        dvs.append(torch.einsum("bhts,bthd->bshd", p, g))
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _check(q, k, v):
    """Raises on what the kernels do not take."""
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, t, h, dh = q.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim must be 1 to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh) or \
            min(t, k.shape[1]) < 1:
        raise ValueError("flash_attention: shapes do not match: "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds 65,535")


def padded_head_dim(dh: int) -> int:
    """The head dim the kernels take: a multiple of 8 (the k-step
    of a TF32 wgmma, and TMA's 16-byte row stride) and at least 32 (one
    128-byte TMA box)."""
    return max(32, -(-dh // 8) * 8)


def pad_head_dim(t, dhp: int):
    """t (..., Dh) with zero columns up to dhp, 16-byte aligned: t itself
    when it already is, else a new tensor."""
    if t.shape[-1] == dhp:
        return aligned16(t)
    return torch.nn.functional.pad(t, (0, dhp - t.shape[-1]))


def flash_attention_fwd(q, k, v, with_lse: bool = False):
    """(o, lse or None) outside autograd: the plain version on the CPU,
    else the kernel."""
    if _on_cpu(q, k, v):
        if with_lse:
            return flash_attention_plain(q, k, v, with_lse=True)
        return flash_attention_plain(q, k, v), None
    _check(q, k, v)
    b, t, h, dh = q.shape
    dhp = padded_head_dim(dh)
    qp, kp, vp = (pad_head_dim(x, dhp) for x in (q, k, v))
    o = torch.empty_like(qp)
    lse = q.new_empty((b, h, t)) if with_lse else None
    rc = library().launch_flash_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        b, t, k.shape[1], h, dhp, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_flash_attention failed: CUDA error {rc}")
    flash_attention.launches += 1
    if dhp != dh:
        o = o[..., :dh].contiguous()
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, g):
    """(dq, dk, dv) from the forward's inputs, output and lse and the
    output's gradient g; all float32, g contiguous."""
    if _on_cpu(q, k, v, o, lse, g):
        return flash_attention_bwd_plain(q, k, v, o, lse, g)
    _check(q, k, v)
    b, t, h, dh = q.shape
    for name, x, shape in (("o", o, q.shape), ("g", g, q.shape),
                           ("lse", lse, (b, h, t))):
        if x.device != q.device or x.dtype != torch.float32 or \
                not x.is_contiguous() or tuple(x.shape) != tuple(shape):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             "contiguous float32 tensor of shape "
                             f"{tuple(shape)} on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    # delta = rowsum(dO * o), (B, H, T): one reduction before the kernels,
    # as the JAX package computes it outside its kernels (:284).
    delta = (g * o).sum(dim=-1).transpose(1, 2).contiguous()
    dhp = padded_head_dim(dh)
    qp, kp, vp, gp = (pad_head_dim(x, dhp) for x in (q, k, v, g))
    dq = torch.empty_like(qp)
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    rc = library().launch_flash_attention_bwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), gp.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, k.shape[1], h, dhp, 1.0 / math.sqrt(dh), 1,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"launch_flash_attention_bwd failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    if dhp != dh:
        dq, dk, dv = (x[..., :dh].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


FlashAttention, FlashAttentionBwd, FlashAttentionEval = autograd_functions(
    flash_attention_fwd, flash_attention_bwd, "flash_attention",
    "FlashAttention")


def flash_attention(q, k, v):
    """q: (B, T, H, Dh); k, v: (B, S, H, Dh), float32 or bfloat16 (run in
    float32, as ``attention_small`` runs it), Dh 1 to 256 -> (B, T, H, Dh)
    in their type."""
    return apply(FlashAttention, FlashAttentionEval, q, k, v)


# Kernel launches so far; a caller resets them to 0 to count a run.  The
# forward counts its launches with or without lse; the backward counts each
# call, which launches its two kernels.
flash_attention.launches = 0
flash_attention_bwd.launches = 0
