"""The bf16 int8 ViT layer's route to csrc/vit_layer_sm90.cu, on the CPU.

``vit_layer_infer_int8`` in bfloat16 runs in the sm90 layer design with
int8 ``wgmma``; the kernel runs only on the card (``python3 chip_smoke.py``,
phase 7).  Here:

- ``pack_weights`` for that route: the four projections as int8 W^T (out,
  in), contiguous, equal to ``quant_cols`` of the wrapper's weights, the LN
  parameters and biases in f32, and the column scales last;
- ``sm90_workspace_bytes`` in the int8 mode: counters, q|k|v and the
  attention output of every row, each block's int8 slot of max(E, HD,
  hidden) bytes a row, its f32 z slot and its f32 hidden slot;
- the kernel's scheme for the hidden, emulated: GELU in f32 by 384-column
  passes of fc1 (192 columns a warpgroup, two columns a thread), each
  row's absolute maximum gathered per thread, over each quad and across the
  warpgroups, then the row quantised with the 8-value packing of
  ``quant8``: equal to ``quant_rows`` of the whole row bit for bit, all-zero
  rows (padded tokens) included, which become zeros with a finite scale;
- ``fused_layer_fits`` and the int8 wrapper at the new t_pad limit, 576
  (the bf16 layer's), where the layer in csrc/fused_layer.cu stopped at 464.
"""

import numpy as np
import pytest
import torch

from transformer_stm_tpu_torch.kernels import fused_layer
from transformer_stm_tpu_torch.kernels.fused_layer import (
    MODE_ATTN, MODE_MLP, MODE_Q8, FusedLayerSharedMemoryError,
    fused_layer_fits, gelu_exact, pack_weights, quant_cols, quant_rows,
    vit_layer_infer_int8)
from transformer_stm_tpu_torch.ops.attention import MHA
from transformer_stm_tpu_torch.ops.blocks import MLP
from transformer_stm_tpu_torch.ops.common import LayerNorm

Q8 = MODE_ATTN | MODE_MLP | MODE_Q8
NW = 192        # columns of a warpgroup in a wide product
ROWS = 64       # rows of a tile


def layer(e=128, h=2, seed=0, dtype=torch.bfloat16):
    """(LayerNorm, MHA, LayerNorm, MLP) with random parameters from numpy."""
    rng = np.random.default_rng(seed)
    mods = (LayerNorm(e), MHA(e, h), LayerNorm(e), MLP(e, 4 * e))
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                p.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return [m.to(dtype) for m in mods]


@pytest.mark.parametrize("e,h", [(128, 2), (192, 3)])
def test_q8_pack_layout_and_scales(e, h):
    n1, attn, n2, mlp = layer(e, h)
    ops = pack_weights(Q8, torch.bfloat16, "cpu", n1, attn, n2, mlp)
    hd, hidden = h * 64, 4 * e
    wqkv, bqkv, wo, bo = fused_layer._attn_weights(attn,
                                                   attn.query.kernel.dtype)
    w1, b1, w2, b2 = fused_layer._mlp_weights(mlp, mlp.fc1.kernel.dtype)
    assert len(ops) == 16
    shapes = [(3 * hd, e), (e, hd), (hidden, e), (e, hidden)]
    for t, w, shape in zip(ops[:4], (wqkv, wo, w1, w2), shapes):
        assert t.dtype == torch.int8 and t.shape == shape
        assert t.is_contiguous() and torch.equal(t, quant_cols(w)[0].t())
    f32 = [n1.gamma.float(), n1.beta.float(), bqkv, bo, n2.gamma.float(),
           n2.beta.float(), b1, b2]
    for t, want in zip(ops[4:12], f32):
        assert t.dtype == torch.float32 and torch.equal(t, want)
    for t, w in zip(ops[12:], (wqkv, wo, w1, w2)):
        scale = quant_cols(w)[1]
        assert t.dtype == torch.float32 and torch.equal(t, scale)
        assert t.shape == (w.shape[1],)
    # q's columns carry 1/sqrt(Dh) before they are quantised
    assert torch.equal(bqkv[:hd], attn.query.bias.float().reshape(hd) / 8.0)


def test_q8_workspace_bytes():
    """ViT-S at B 192 on 132 blocks: the int8 slot holds 1,536 bytes a row
    (the hidden, the widest A operand), beside z and the f32 hidden."""
    n, e, hd, hidden, slots = 192 * 200, 384, 384, 1536, 132

    def a(b):
        return -(-b // 1024) * 1024
    tiles = n // ROWS
    want = (a(4 * (1 + tiles + 192)) + n * 3 * hd * 2 + n * hd * 2
            + slots * ROWS * hidden + slots * ROWS * e * 4
            + slots * ROWS * hidden * 4)
    got = fused_layer.sm90_workspace_bytes(Q8, n, 200, e, hd, slots, hidden)
    assert got == want
    # the bf16 layer's workspace does not change with the hidden width
    both = MODE_ATTN | MODE_MLP
    assert fused_layer.sm90_workspace_bytes(both, n, 200, e, hd, slots) == \
        fused_layer.sm90_workspace_bytes(both, n, 200, e, hd, slots, hidden)
    # ViT-Ti: the hidden (768) is the widest row; ViT-B: 3,072
    for e, hd, hidden in ((192, 192, 768), (768, 768, 3072)):
        small = fused_layer.sm90_workspace_bytes(Q8, 400, 200, e, hd, 2,
                                                 hidden)
        assert small == (a(4 * (1 + 7 + 2)) + a(400 * 3 * hd * 2)
                         + a(400 * hd * 2) + a(2 * ROWS * hidden)
                         + a(2 * ROWS * e * 4) + a(2 * ROWS * hidden * 4))


def quant8(v, inv):
    """``quant8`` of csrc/vit_layer_sm90.cu on rows of 8 f32 values: int8
    clip(rint(v * inv)), packed into two little-endian uint32 words."""
    q = torch.clamp(torch.round(v * inv), -127.0, 127.0).to(torch.int64)
    b = q & 0xFF
    shifts = 8 * torch.arange(4)
    return ((b[..., :4] << shifts).sum(-1), (b[..., 4:] << shifts).sum(-1))


def unpack8(lo, hi):
    words = torch.stack([lo, hi], dim=-1)
    b = (words[..., None] >> (8 * torch.arange(4))) & 0xFF
    return b.reshape(*lo.shape, 8).to(torch.uint8).view(torch.int8)


def hidden_scheme(pre):
    """The kernel's hidden: GELU of fc1's epilogue by 384-column passes,
    the row maxima gathered (per thread over its column pairs, per quad,
    across the warpgroups), then the row quantised 8 values at a time."""
    rows, hidden = pre.shape
    h = torch.empty_like(pre)
    part = torch.zeros(2, rows, 4)  # [warpgroup][row][lane of the quad]
    for c0 in range(0, hidden, 2 * NW):
        for w in range(2):
            for j in range(NW // 8):
                for q in range(4):
                    c = c0 + w * NW + 8 * j + 2 * q
                    if c >= hidden:
                        continue
                    h[:, c:c + 2] = gelu_exact(pre[:, c:c + 2])
                    part[w, :, q] = torch.maximum(
                        part[w, :, q], h[:, c:c + 2].abs().amax(-1))
    amax = part.amax(-1).amax(0).clamp_min(1e-6)  # quads, then warpgroups
    inv = torch.tensor(127.0, dtype=torch.float32) / amax
    lo, hi = quant8(h.reshape(rows, hidden // 8, 8), inv[:, None, None])
    return unpack8(lo, hi).reshape(rows, hidden), \
        (amax * (1.0 / 127.0))[:, None], h


@pytest.mark.parametrize("hidden", [768, 1536, 3072])
def test_hidden_scheme_equals_quant_rows(hidden):
    rng = np.random.default_rng(hidden)
    pre = torch.from_numpy(rng.standard_normal((ROWS, hidden))
                           .astype(np.float32)) * 3.0
    pre[5] *= 1e3        # a row whose maximum is far from the others
    pre[40:] = -30.0     # GELU is zero here: rows of padded tokens
    q, s, h = hidden_scheme(pre)
    want_q, want_s = quant_rows(gelu_exact(pre))
    assert torch.equal(h, gelu_exact(pre))
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert not q[40:].any() and torch.isfinite(s).all()
    assert (s[40:] == 1e-6 * (1.0 / 127.0)).all()


def test_fits_at_the_new_int8_limit():
    """The int8 layer runs in the bf16 layer's kernel: t_pad 576 fits and
    584 does not, where its own kernel stopped at 464."""
    assert fused_layer_fits(576, 384, 6, 64, 1536, 2)
    assert not fused_layer_fits(584, 384, 6, 64, 1536, 2)
    assert fused_layer.attention_smem_bytes(576) <= fused_layer.SMEM_LIMIT


@pytest.mark.parametrize("t_pad,fits", [(472, True), (576, True),
                                        (584, False)])
def test_int8_wrapper_at_the_limit(t_pad, fits):
    """Off the card the wrapper never falls back: past the limit it raises
    FusedLayerSharedMemoryError, below it (a meta tensor standing in for
    the card) ValueError for the device."""
    n1, attn, n2, mlp = layer(384, 6)
    x = torch.empty(t_pad, 384, dtype=torch.bfloat16, device="meta")
    err = ValueError if fits else FusedLayerSharedMemoryError
    with pytest.raises(err) as info:
        vit_layer_infer_int8(x, n1, attn, n2, mlp, t_pad=t_pad,
                             t_real=t_pad - 3)
    assert (info.type is ValueError) == fits
    if fits:
        assert "CUDA device" in str(info.value)
