"""The int8 ViT layer on float32 x (csrc/fused_layer.cu, mode 7) on the CPU.

The CUDA design runs only on the card, where ``python3 chip_smoke.py``
(phase 7) holds it against ``vit_layer_infer_int8_plain`` within
VIT_INT8_TOL (1e-2 of max |plain|).  Here, with inputs from numpy seeds:

- the design's data flow, emulated in torch in its own order, is within
  VIT_INT8_TOL of the plain version at ViT-Ti and ViT-S widths with t_pad
  24 and 200, in chunks of whole images (several, the last one short): LN
  as ``ln_quant`` computes it and each row quantised as ``quant_row`` does
  (amax clamped at 1e-6, a true division 127 / amax, rint, clip, scale
  amax * (1 / 127)); every product an exact integer sum converted to f32,
  then ((acc * sx) * sw) + b; the attention's two products in 3xTF32
  (tests/test_torch_f32_layer.py's helpers); o and the whole hidden row
  quantised per row; z = x + d and y = z + d;
- the hidden's row maxima, gathered tile by tile as fc1's epilogue does
  (a max per 192-column tile, combined by atomicMax), give the quantised
  hidden and its scales bit for bit as a pass over the whole row does;
- how many quantised entries differ from ``quant_rows``'s (which divides
  as reciprocal times 127), printed: at most one step each;
- an all-zero row (a padded token) quantises to zeros with a finite scale;
- ``workspace_bytes`` in mode 7 against hand counts at ViT-S and ViT-B, B
  192 and B 768: it follows the chunk, not the batch;
- ``pack_weights`` of the float32 ``MODE_Q8`` route gives int8 W^T (out,
  in), equal to ``quant_cols`` bit for bit, in the bfloat16 route's
  layout.
"""

import numpy as np
import pytest
import torch

from test_torch_f32_layer import attention, layer, ln_rows, tokens
from transformer_stm_tpu_torch.kernels import fused_layer as fl
from transformer_stm_tpu_torch.kernels.fused_layer import (
    MODE_ATTN, MODE_MLP, MODE_Q8, gelu_exact, layer_chunk_rows, pack_weights,
    quant_cols, quant_rows, vit_layer_infer_int8_plain, workspace_bytes)

Q8 = MODE_ATTN | MODE_MLP | MODE_Q8
VIT_INT8_TOL = 1e-2  # chip_smoke.py: max |err| <= tol * max |plain|
BN = 192             # columns of a chunk_gemm_s8 tile
WIDTHS = [(192, 3), (384, 6)]             # ViT-Ti, ViT-S: (E, H)
TOKENS = [(3, 197, 200), (5, 17, 24)]     # (B, t_real, t_pad)
THIRD = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quant_row(v, amax=None):
    """``quant_row`` of csrc/fused_layer.cu on each row of v: amax (the
    row's max |v| unless given) clamped at 1e-6, inv = 127 / amax (a true
    division, as ``__fdiv_rn``), q = clip(rint(v * inv), -127, 127), scale
    amax * (1 / 127) -> (int8 q, f32 (R, 1) scales)."""
    if amax is None:
        amax = v.abs().amax(dim=-1)
    amax = amax.clamp_min(1e-6)
    inv = torch.full_like(amax, 127.0) / amax
    q = torch.clamp(torch.round(v * inv[:, None]), -127.0, 127.0)
    return q.to(torch.int8), (amax * THIRD)[:, None]


def qdot(aq, sx, w_t, sw, b):
    """chunk_gemm_s8 and its epilogue: the exact integer sum of aq (R, K)
    and W^T (N, K), converted to f32, then ((acc * sx) * sw) + b."""
    acc = (aq.double() @ w_t.double().t()).float()
    return acc * sx * sw + b


def tile_maxima(h):
    """fc1's epilogue: each row's max |h| over each 192-column tile, the
    tiles' maxima combined by max (atomicMax on the bits)."""
    parts = [h[:, c:c + BN].abs().amax(dim=-1)
             for c in range(0, h.shape[1], BN)]
    return torch.stack(parts).amax(dim=0)


def emulate(x, mods, t_pad, t_real, rows, differ):
    """The launches of ``launch_fused_layer`` in mode 7, chunk by chunk in
    chunks of ``rows`` rows; ``differ`` gathers, per quantised array, how
    many entries differ from ``quant_rows`` of the same values."""
    (wqkv, wo, w1, w2, g1, be1, bqkv, bo, g2, be2, b1, b2, sqkv, so, s1,
     s2) = pack_weights(Q8, torch.float32, "cpu", *mods)
    heads = mods[1].query.bias.shape[0]

    def quant(name, v, amax=None):
        q, s = quant_row(v, amax)
        want_q, want_s = quant_rows(v)
        assert torch.equal(s, want_s), name
        step = (q.int() - want_q.int()).abs()
        assert step.max() <= 1, name
        differ[name] = differ.get(name, 0) + int((step > 0).sum())
        return q, s

    out = []
    for r0 in range(0, x.shape[0], rows):
        xc = x[r0:r0 + rows]
        aq, sa = quant("xq", ln_rows(xc, g1, be1))
        qkv = qdot(aq, sa, wqkv, sqkv, bqkv)
        o = attention(qkv, t_pad, t_real, heads)
        aq, sa = quant("oq", o)
        z = xc + qdot(aq, sa, wo, so, bo)
        aq, sa = quant("zq", ln_rows(z, g2, be2))
        hid = gelu_exact(qdot(aq, sa, w1, s1, b1))
        hq, sh = quant("hq", hid, tile_maxima(hid))
        whole_q, whole_s = quant_row(hid)
        assert torch.equal(hq, whole_q) and torch.equal(sh, whole_s)
        out.append(z + qdot(hq, sh, w2, s2, b2))
    return torch.cat(out)


@pytest.mark.parametrize("b,t_real,t_pad", TOKENS, ids=["T200", "T24"])
@pytest.mark.parametrize("e,h", WIDTHS, ids=["vit_ti", "vit_s"])
def test_the_chunked_int8_design_matches_the_plain_version(e, h, b, t_real,
                                                            t_pad):
    mods = layer(e, h, seed=e + t_pad + 2)
    x = tokens(b, t_real, t_pad, e, seed=t_pad + 2)
    want = vit_layer_infer_int8_plain(x, *mods, t_pad=t_pad, t_real=t_real)
    # several chunks, the last one short: two images a chunk
    differ = {}
    got = emulate(x, mods, t_pad, t_real, 2 * t_pad, differ)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    print(f"int8 f32 x E{e} T{t_real}/{t_pad} B{b}: max |emulated - plain| "
          f"{err:.2e} of max |plain| {scale:.2f}; quantised entries that "
          f"differ from quant_rows of the same values: {differ}")
    assert torch.isfinite(got).all()
    assert err <= VIT_INT8_TOL * scale


@pytest.mark.parametrize("width", [192, 1280, 1536, 3072])
def test_hidden_row_maxima_by_tiles_equal_a_whole_row_pass(width):
    """The hidden quantised from its tile-by-tile maxima equals a pass over
    the whole row bit for bit (the max is exact in any order), padded rows
    (GELU zero) included: 1, 8 and 16 whole 192-column tiles, and at E 320
    (hidden 1,280) a last tile of 128 columns."""
    rng = np.random.default_rng(width)
    pre = torch.from_numpy(rng.standard_normal((64, width))
                           .astype(np.float32)) * 3.0
    pre[5] *= 1e3
    pre[40:] = -30.0
    h = gelu_exact(pre)
    assert torch.equal(tile_maxima(h), h.abs().amax(dim=-1))
    q, s = quant_row(h, tile_maxima(h))
    whole_q, whole_s = quant_row(h)
    assert torch.equal(q, whole_q) and torch.equal(s, whole_s)
    assert not q[40:].any()


def test_an_all_zero_row_quantises_to_zeros_with_a_finite_scale():
    v = torch.zeros(3, 384)
    v[1] = torch.linspace(-2.0, 3.0, 384)
    q, s = quant_row(v)
    want_q, want_s = quant_rows(v)
    assert torch.equal(s, want_s)
    assert not q[0].any() and not q[2].any()
    assert torch.isfinite(s).all() and s[0].item() == pytest.approx(
        1e-6 / 127.0, rel=1e-6)
    assert (q[1].int() - want_q[1].int()).abs().max() <= 1
    assert q[1].abs().max() == 127


def test_q8_workspace_by_hand():
    """Chunks of whole images (``layer_chunk_rows``): ViT-S takes 39 images
    a chunk at B 192 and 41 at B 768, ViT-B 20 and 21.  A row holds z (4 E
    bytes), the wide region (4 max(4 HD, hidden)), the int8 row (max(E,
    HD, hidden)) and two f32 values: 9,224 bytes at ViT-S, 18,440 at
    ViT-B, whatever the batch."""
    for b, e, rows, row_bytes, total in (
            (192, 384, 7800, 4 * 384 + 4 * 1536 + 1536 + 8, 71_947_200),
            (768, 384, 8200, 4 * 384 + 4 * 1536 + 1536 + 8, 75_636_800),
            (192, 768, 4000, 4 * 768 + 4 * 3072 + 3072 + 8, 73_760_000),
            (768, 768, 4200, 4 * 768 + 4 * 3072 + 3072 + 8, 77_448_000)):
        assert layer_chunk_rows(b * 200, e, 200) == rows
        assert workspace_bytes(Q8, rows, e, e, 4 * e) == rows * row_bytes
        assert rows * row_bytes == total
    # ViT-Ti: the hidden (768) is the widest region, 4 HD = 768 too
    assert workspace_bytes(Q8, 400, 192, 192, 768) == \
        400 * (4 * 192 + 4 * 768 + 768 + 8)


def test_f32_q8_packing_is_int8_w_t_with_column_scales():
    """The bfloat16 route's layout: the four W^T int8 (out, in), the LN
    parameters and biases f32, the column scales last."""
    n1, attn, n2, mlp = layer(192, 3, seed=5)
    ops = pack_weights(Q8, torch.float32, "cpu", n1, attn, n2, mlp)
    assert len(ops) == 16
    wqkv, bqkv, wo, bo = fl._attn_weights(attn, torch.float32)
    w1, b1, w2, b2 = fl._mlp_weights(mlp, torch.float32)
    for t, sc, w in zip(ops[:4], ops[12:], (wqkv, wo, w1, w2)):
        q, s = quant_cols(w)
        assert t.dtype == torch.int8 and t.is_contiguous()
        assert t.shape == (w.shape[1], w.shape[0])
        assert torch.equal(t, q.t())
        assert sc.dtype == torch.float32 and torch.equal(sc, s)
    f32 = (n1.gamma, n1.beta, bqkv, bo, n2.gamma, n2.beta, b1, b2)
    for t, want in zip(ops[4:12], f32):
        assert t.dtype == torch.float32 and torch.equal(t, want.float())
