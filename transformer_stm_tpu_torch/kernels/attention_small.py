"""attention_small: exact softmax(q k^T / sqrt(Dh)) v, forward and backward.

Port of the Pallas TPU kernel ``attention_small``
(transformer_stm_tpu/kernels/flash_attention.py:935, a ``jax.custom_vjp``).
Both directions compute the same function as flash attention at Dh 64 and
run its kernels, f32 products in 3xTF32 on the tensor cores, which take any
lengths: the forward ``_small_fwd_impl`` :703 / ``_small_fwd_kernel`` :680
launches ``csrc/flash_attention.cu``, and the backward pair
``_small_bwd_dq_kernel`` :764 and ``_small_bwd_dkv_kernel`` :791
(``_small_bwd_impl`` :825) the pair of ``csrc/flash_attention_bwd.cu``.
Each source's header says how it streams K/V where the TPU kernels held
whole rows in VMEM.

``attention_small(q, k, v)`` is differentiable: when autograd records (grad
enabled and an input requires grad) it runs ``AttentionSmall``, whose
forward also writes the per-row lse and saves q, k, v, o and lse for the
backward kernels (``AttentionSmallBwd``); otherwise it runs the lse-free
forward (``AttentionSmallEval``) and saves nothing.  ``autograd_functions``
makes the three, with vmap rules that fold the mapped axis into the batch
axis, so ``torch.func.vmap`` and ``torch.func.grad`` run through the
kernels; ``flash_attention`` uses it too.
Tensors on the CPU take the plain versions below; tensors on a CUDA device
launch the kernels, or raise.
"""

from __future__ import annotations

import math
import types

import torch

from ._build import aligned16, library

HEAD_DIM = 64


def attention_small_plain(q, k, v, with_lse: bool = False):
    """The forward kernel's arithmetic in PyTorch: f32 scores (q . k) *
    scale, the row max m subtracted before exp, the output divided by the
    row sum l.  q: (B, T, H, Dh); k, v: (B, S, H, Dh) -> o (B, T, H, Dh),
    and with ``with_lse`` also lse = m + log(l), (B, H, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # (B, H, T, 1)
    o = torch.einsum("bhts,bshd->bthd", p, v) / l.permute(0, 2, 1, 3)
    if not with_lse:
        return o
    return o, (m + torch.log(l)).squeeze(-1)


def attention_small_bwd_plain(q, k, v, o, lse, g):
    """The backward kernels' arithmetic in PyTorch, step by step: p rebuilt
    from the saved lse, dp = dO . v, delta = rowsum(dO * o),
    dS = p (dp - delta); dq = scale dS k, dk = scale dS^T q, dv = p^T dO.
    q, o, g: (B, T, H, Dh); k, v: (B, S, H, Dh); lse: (B, H, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("bthd,bshd->bhts", g, v)
    delta = (g * o).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, H, T, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhts,bshd->bthd", ds, k) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, g)
    return dq, dk, dv


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


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


def attention_small_fwd(q, k, v, with_lse: bool = False):
    """(o, lse or None) outside autograd: the plain version on the CPU,
    else the kernel."""
    if _on_cpu(q, k, v):
        if with_lse:
            return attention_small_plain(q, k, v, with_lse=True)
        return attention_small_plain(q, k, v), None
    _check(q, k, v)
    b, t, h, dh = q.shape
    q, k, v = map(aligned16, (q, k, v))
    o = torch.empty_like(q)
    lse = q.new_empty((b, h, t)) if with_lse else None
    rc = library().launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        b, t, k.shape[1], h, dh, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"attention_small: launch_flash_attention failed: CUDA error "
            f"{rc}")
    attention_small.launches += 1
    return o, lse


def attention_small_bwd(q, k, v, o, lse, g):
    """(dq, dk, dv) from the forward's inputs, output and lse and the
    output's gradient g; all float32, g contiguous."""
    if _on_cpu(q, k, v, o, lse, g):
        return attention_small_bwd_plain(q, k, v, o, lse, g)
    _check(q, k, v)
    b, t, h, dh = q.shape
    for name, x, shape in (("o", o, q.shape), ("g", g, q.shape),
                           ("lse", lse, (b, h, t))):
        if x.device != q.device or x.dtype != torch.float32 or \
                not x.is_contiguous() or tuple(x.shape) != tuple(shape):
            raise ValueError(f"attention_small_bwd: {name} must be a "
                             "contiguous float32 tensor of shape "
                             f"{tuple(shape)} on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    # delta = rowsum(dO * o), (B, H, T): one reduction before the kernels,
    # as the JAX package computes it outside its kernels (:852-860).
    delta = (g * o).sum(dim=-1).transpose(1, 2).contiguous()
    q, k, v, g = map(aligned16, (q, k, v, g))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = library().launch_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, k.shape[1], h, dh, 1.0 / math.sqrt(dh), 1,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"attention_small_bwd: launch_flash_attention_bwd failed: CUDA "
            f"error {rc}")
    attention_small_bwd.launches += 1
    return dq, dk, dv


def _fold(info, in_dims, *tensors):
    """A vmap rule's inputs with the mapped axis moved to the front (an
    unmapped input is expanded) and folded into the batch axis, which every
    kernel here treats row by row, so the fold is exact."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(info.batch_size, *t.shape) if d is None else \
            t.movedim(d, 0)
        out.append(t.reshape(-1, *t.shape[2:]).contiguous())
    return out


def _unfold(n, tensors):
    return tuple(t.reshape(n, -1, *t.shape[1:]) for t in tensors)


def autograd_functions(fwd, bwd, name: str, cls_name: str):
    """The three autograd Functions around an attention kernel pair:
    ``fwd(q, k, v, with_lse) -> (o, lse or None)`` and
    ``bwd(q, k, v, o, lse, g) -> (dq, dk, dv)``.

    - ``{cls_name}``, training: the forward with lse, saving q, k, v, o and
      lse; its backward runs the second Function;
    - ``{cls_name}Bwd``, the backward, as a Function so that a vmapped
      backward reaches the kernels with plain tensors;
    - ``{cls_name}Eval``, evaluation: the lse-free forward, outside
      autograd.

    Each is in the ``setup_context`` form with a vmap rule that folds the
    mapped axis into the batch axis, so ``torch.func.vmap`` and
    ``torch.func.grad`` batch them as ``jax.vmap`` batches the JAX
    ``custom_vjp``."""

    def train_setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)
        ctx.mark_non_differentiable(output[1])

    def train_backward(ctx, g, _g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        return Bwd.apply(q, k, v, o, lse, g.contiguous())

    def train_vmap(info, in_dims, q, k, v):
        o, lse = Train.apply(*_fold(info, in_dims, q, k, v))
        return _unfold(info.batch_size, (o, lse)), (0, 0)

    def bwd_backward(ctx, *grads):
        raise NotImplementedError(f"{name} has no second derivative")

    def bwd_vmap(info, in_dims, *tensors):
        grads = Bwd.apply(*_fold(info, in_dims, *tensors))
        return _unfold(info.batch_size, grads), (0, 0, 0)

    def eval_backward(ctx, g):
        raise RuntimeError(f"{cls_name}Eval records no graph; {name} runs "
                           f"{cls_name} while autograd records")

    def eval_vmap(info, in_dims, q, k, v):
        o = Eval.apply(*_fold(info, in_dims, q, k, v))
        return _unfold(info.batch_size, (o,))[0], 0

    def function(suffix, **methods):
        body = {k: staticmethod(f) for k, f in methods.items()}
        body["setup_context"] = body.get(
            "setup_context", staticmethod(lambda ctx, inputs, output: None))
        # new_class runs autograd's metaclass, which names the grad_fn
        # class after this one ("AttentionSmallBackward")
        return types.new_class(cls_name + suffix, (torch.autograd.Function,),
                               exec_body=lambda ns: ns.update(body))

    Train = function("", forward=lambda q, k, v: fwd(q, k, v, with_lse=True),
                     setup_context=train_setup, backward=train_backward,
                     vmap=train_vmap)
    Bwd = function("Bwd", forward=bwd, backward=bwd_backward, vmap=bwd_vmap)
    Eval = function("Eval", forward=lambda q, k, v: fwd(q, k, v)[0],
                    backward=eval_backward, vmap=eval_vmap)
    return Train, Bwd, Eval


def apply(train, evaluate, q, k, v):
    """``train`` (with lse, saving for the backward) while autograd records,
    that is grad is enabled and an input requires grad; else ``evaluate``.
    bfloat16 q, k and v run the float32 kernels: they are converted to
    float32 here and the output is converted back."""
    if q.dtype == torch.bfloat16:
        if not k.dtype == v.dtype == torch.bfloat16:
            raise ValueError(f"q, k and v must share a type, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        return apply(train, evaluate, q.float(), k.float(),
                     v.float()).to(q.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return train.apply(q, k, v)[0]
    return evaluate.apply(q, k, v)


AttentionSmall, AttentionSmallBwd, AttentionSmallEval = autograd_functions(
    attention_small_fwd, attention_small_bwd, "attention_small",
    "AttentionSmall")


def attention_small(q, k, v):
    """q: (B, T, H, 64); k, v: (B, S, H, 64), float32 or bfloat16 ->
    (B, T, H, 64) in their type.

    In bfloat16 the kernel runs on the float32 values and only the output
    is rounded.  The JAX kernel rounds p to bfloat16 before p v
    (kernels/flash_attention.py:695); the port keeps p in float32, a
    difference of under one bfloat16 ulp of the output."""
    return apply(AttentionSmall, AttentionSmallEval, q, k, v)


# Kernel launches so far; a caller resets them to 0 to count a run.  The
# forward counts its launches with or without lse (the flash forward kernel,
# counted here and not in ``flash_attention.launches``); the backward counts
# each call, which launches its two kernels (the flash backward pair,
# counted here and not in ``flash_attention_bwd.launches``).
attention_small.launches = 0
attention_small_bwd.launches = 0
