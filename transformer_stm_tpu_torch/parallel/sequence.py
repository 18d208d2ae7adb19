"""Sequence parallelism for long token counts
(transformer_stm_tpu/parallel/sequence.py:31-92).

q, k and v are this rank's shards of (B, T, H, Dh) tensors split along T
over a mesh axis (``data`` by default), in rank order; the output is this
rank's shard of the attention output.  Both are differentiable.

- ``sp_attention`` gathers K and V along T over the axis (``all_gather``,
  whose backward gives each rank its slice of the summed gradient) and
  runs the rank's queries through the port's ``_attention_core`` with
  ``impl="auto"``: at 16,384 keys or more on the card that is the flash
  attention kernel forward and its backward pair.
- ``ring_attention`` keeps O(T / n) keys a rank: K and V go round the ring
  (``ppermute``, rank r to r + 1) for n steps while a running maximum and
  denominator fold each block into the output (the online softmax of
  :56-92), in float32 in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import _attention_core
from .collectives import all_gather, ppermute


def sp_attention(q, k, v, mesh, axis: str = "data"):
    """All-gather sequence parallelism: the rank's T / n queries against
    the whole of K and V."""
    group = mesh.get_group(axis)
    return _attention_core(q, all_gather(k, 1, group),
                           all_gather(v, 1, group), impl="auto")


def ring_attention(q, k, v, mesh, axis: str = "data"):
    """Ring sequence parallelism: the rank's queries against each rank's
    K/V block in turn."""
    group = mesh.get_group(axis)
    n = group.size()
    b, t, h, dh = q.shape
    qf = q.float() * (1.0 / math.sqrt(dh))
    acc = q.new_zeros((b, t, h, dh), dtype=torch.float32)
    m = q.new_full((b, h, t, 1), -1e30, dtype=torch.float32)
    denom = q.new_zeros((b, h, t, 1), dtype=torch.float32)
    kv = torch.stack([k, v])
    for i in range(n):
        s = torch.einsum("bthd,bshd->bhts", qf, kv[0].float())
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhts,bshd->bthd", p, kv[1].float())
        acc = acc * alpha.transpose(1, 2) + pv
        m = m_new
        if i + 1 < n:
            kv = ppermute(kv, 1, group)
    return (acc / denom.transpose(1, 2)).to(q.dtype)
