"""The float32 fused ViT layer (csrc/fused_layer.cu, modes 1-3) on the CPU.

The CUDA design runs only on the card, where ``python3 chip_smoke.py``
(phase 7) holds it against the plain versions within VIT_F32_TOL (1e-5 of
max |plain|).  Here, with inputs from numpy seeds:

- in float32 the merged layer's plain version equals its two halves' run
  in turn, bit for bit (z is float32 either way), at ViT-Ti and ViT-S
  widths with t_pad 24 and 200: so ``vit_layer_infer`` runs row 9's
  launches, then row 10's;
- the design's data flow, emulated in torch in its own order, is within
  VIT_F32_TOL of the plain versions: chunks of whole images
  (several, the last one short), LN as
  ``ln_rows`` computes it, every product as ``chunk_gemm`` runs it (A split
  on the fly, B the packed TF32 halves of ``pack_weights``, pairs of
  32-deep K stages into fresh accumulators), the attention's two products
  in 3xTF32 (the flash forward's own tiling is emulated in
  tests/test_torch_tf32x3_fwd.py), and the epilogues' orders of addition;
- ``layer_chunk_rows`` and ``workspace_bytes`` against hand counts at
  ViT-S and ViT-B, B 192, and at the B 768 of phase 7: the workspace
  follows the chunk, not the batch;
- ``pack_weights`` in float32 gives each W^T split into TF32 halves, and
  the cache packs each layer of a model once, and once more after a
  parameter changes.
"""

import math

import numpy as np
import pytest
import torch

from transformer_stm_tpu_torch.kernels import fused_layer as fl
from transformer_stm_tpu_torch.kernels.fused_layer import (
    MODE_ATTN, MODE_MLP, attn_layer_infer_plain, layer_chunk_rows,
    ln_mlp_infer_plain, pack_weights, packed_weights, vit_layer_infer_plain,
    workspace_bytes)
from transformer_stm_tpu_torch.kernels.fused_mlp import tf32_split
from transformer_stm_tpu_torch.ops.attention import MHA
from transformer_stm_tpu_torch.ops.blocks import MLP
from transformer_stm_tpu_torch.ops.common import LayerNorm

BOTH = MODE_ATTN | MODE_MLP
VIT_F32_TOL = 1e-5   # chip_smoke.py: max |err| <= tol * max |plain|
FOLD = 64            # a pair of 32-deep K stages into one fresh accumulator
WIDTHS = [(192, 3), (384, 6)]             # ViT-Ti, ViT-S: (E, H)
TOKENS = [(2, 197, 200), (3, 17, 24)]     # (B, t_real, t_pad)


def layer(e, h, seed):
    """(LayerNorm, MHA, LayerNorm, MLP) at width e, every parameter random
    (kernels N(0, 1/fan_in), biases, LN betas N(0, 0.01), gammas 1 +
    N(0, 0.01))."""
    rng = np.random.default_rng(seed)
    mods = (LayerNorm(e), MHA(e, h), LayerNorm(e), MLP(e, 4 * e))
    with torch.no_grad():
        for m in mods:
            for name, p in m.named_parameters():
                r = torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32))
                if name.endswith("kernel"):
                    fan = p.shape[0] * (p.shape[1] if name.startswith("out")
                                        else 1)
                    p.copy_(r / math.sqrt(fan))
                else:
                    p.copy_(0.1 * r + (1.0 if name == "gamma" else 0.0))
    return mods


def tokens(b, t_real, t_pad, e, seed):
    """Folded (B t_pad, E) rows, the padded tokens zero, as vit_forward
    pads them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t_pad, e)).astype(np.float32)
    x[:, t_real:] = 0.0
    return torch.from_numpy(x.reshape(b * t_pad, e))


@pytest.mark.parametrize("b,t_real,t_pad", TOKENS, ids=["T200", "T24"])
@pytest.mark.parametrize("e,h", WIDTHS, ids=["vit_ti", "vit_s"])
def test_the_merged_layer_is_its_two_halves_in_f32(e, h, b, t_real, t_pad):
    n1, attn, n2, mlp = layer(e, h, seed=e + t_pad)
    x = tokens(b, t_real, t_pad, e, seed=t_pad)
    dims = dict(t_pad=t_pad, t_real=t_real)
    merged = vit_layer_infer_plain(x, n1, attn, n2, mlp, **dims)
    halves = ln_mlp_infer_plain(attn_layer_infer_plain(x, n1, attn, **dims),
                                n2, mlp)
    assert torch.equal(merged, halves)


# -- the design, emulated ---------------------------------------------------

def ln_rows(x, gamma, beta, eps=1e-6):
    """``ln_rows``: the mean, the mean of the squared deviations, then
    ((x - mean) * rsqrt(var + eps)) * gamma + beta."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * (1.0 / torch.sqrt(var + eps))) * gamma + beta


def chunk_gemm(a, w_pack):
    """A W over K by pairs of 32-deep stages, each in a fresh accumulator
    added into the tile's: A split on the fly, W as packed, (2, N, K)
    TF32 halves of W^T; the small terms first."""
    big, small = w_pack
    acc = torch.zeros(a.shape[0], big.shape[0])
    for k in range(0, a.shape[1], FOLD):
        ab, as_ = tf32_split(a[:, k:k + FOLD].contiguous())
        bb, bs = big[:, k:k + FOLD].t(), small[:, k:k + FOLD].t()
        acc = acc + ((as_ @ bb + ab @ bs) + ab @ bb)
    return acc


def mm3(a, b):
    """a @ b in 3xTF32, the small terms first."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def attention(qkv, t_pad, t_real, heads):
    """Per image and head: s = q k^T (q pre-scaled), keys past t_real
    masked, p = exp(s - max), o = (p v) / sum p; both products in
    3xTF32."""
    n = qkv.shape[0]
    q, k, v = qkv.reshape(n // t_pad, t_pad, 3, heads, 64).unbind(2)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = mm3(q, k.transpose(-1, -2))
    s[..., t_real:] = -math.inf
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = mm3(p, v) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).reshape(n, heads * 64)


def emulate(mode, x, mods, t_pad, t_real, rows):
    """The launches of ``launch_fused_layer_tf32x3`` chunk by chunk, in
    chunks of ``rows`` rows."""
    n1, attn, n2, mlp = mods
    wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1, be1, g2, be2 = pack_weights(
        mode, torch.float32, "cpu", *mods)
    n = x.shape[0]
    heads = attn.query.bias.shape[0] if attn is not None else 0
    out = []
    for r0 in range(0, n, rows):
        xc = x[r0:r0 + rows]
        src = xc
        if mode & MODE_ATTN:
            qkv = chunk_gemm(ln_rows(xc, g1, be1), wqkv) + bqkv
            o = attention(qkv, t_pad, t_real, heads)
            src = (xc + bo) + chunk_gemm(o, wo)
        if mode & MODE_MLP:
            hid = fl.gelu_exact(chunk_gemm(ln_rows(src, g2, be2), w1) + b1)
            src = src + (chunk_gemm(hid, w2) + b2)
        out.append(src)
    return torch.cat(out)


@pytest.mark.parametrize("b,t_real,t_pad", TOKENS, ids=["T200", "T24"])
@pytest.mark.parametrize("e,h", WIDTHS, ids=["vit_ti", "vit_s"])
def test_the_chunked_design_matches_the_plain_versions(e, h, b, t_real,
                                                       t_pad):
    mods = layer(e, h, seed=e + t_pad + 1)
    n1, attn, n2, mlp = mods
    x = tokens(b, t_real, t_pad, e, seed=t_pad + 1)
    dims = dict(t_pad=t_pad, t_real=t_real)
    # several chunks, the last one short: two images a chunk, or a tile of
    # 128 rows in ln_mlp_infer
    cases = ((BOTH, mods, vit_layer_infer_plain(x, *mods, **dims), 2 * t_pad),
             (MODE_ATTN, (n1, attn, None, None),
              attn_layer_infer_plain(x, n1, attn, **dims), 2 * t_pad),
             (MODE_MLP, (None, None, n2, mlp), ln_mlp_infer_plain(x, n2, mlp),
              128))
    for mode, used, want, rows in cases:
        got = emulate(mode, x, used, t_pad, t_real, rows)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        print(f"mode {mode} E{e} T{t_real}/{t_pad}: max |emulated - plain| "
              f"{err:.2e} of max |plain| {scale:.2f}")
        assert err <= VIT_F32_TOL * scale, mode


def test_chunk_rows_and_workspace_by_hand():
    """About 132 x 128 x 192 / E rows a chunk, in whole images of 200 rows
    spread evenly over the chunks: ViT-S B 192 takes 5 chunks of at most
    39 images (42 fit 8,448 rows), B 768 takes 19 of at most 41; ViT-B (4,224
    rows, 21 images) at B 192 takes 10 chunks of at most 20.  ln_mlp_infer
    takes whole 128-row tiles: 300 tiles in 5 chunks of 60.  The workspace:
    xn and z (E floats a row each, z only in the merged mode) and the wider
    of q|k|v plus o (4 HD) and the hidden (4 E)."""
    s, b = (384, 1536), (768, 3072)
    assert layer_chunk_rows(192 * 200, 384, 200) == 39 * 200
    assert layer_chunk_rows(768 * 200, 384, 200) == 41 * 200
    assert layer_chunk_rows(192 * 200, 768, 200) == 20 * 200
    assert layer_chunk_rows(192 * 200, 384) == 60 * 128
    assert layer_chunk_rows(3 * 24, 384, 24) == 72
    assert layer_chunk_rows(100, 384) == 128
    for rows, (e, hidden), mode, floats in (
            (7800, s, BOTH, 7800 * (384 + 384 + 1536)),
            (7800, s, MODE_ATTN, 7800 * (384 + 4 * 384)),
            (7680, s, MODE_MLP, 7680 * (384 + 1536)),
            (4000, b, BOTH, 4000 * (768 + 768 + 3072)),
            (8200, s, BOTH, 8200 * (384 + 384 + 1536))):
        assert workspace_bytes(mode, rows, e, e, hidden) == 4 * floats
    assert workspace_bytes(BOTH, 7800, 384, 384, 1536) == 71_884_800
    assert workspace_bytes(BOTH, 8200, 384, 384, 1536) == 75_571_200
    assert workspace_bytes(BOTH, 4000, 768, 768, 3072) == 73_728_000


def test_f32_packing_splits_each_w_t_once_per_model():
    """Each W^T comes split, (2, out, in) TF32 halves that sum to it within
    2^-22 of its largest entry; a model's layers pack once each, a second
    pass packs nothing, and a parameter written in place repacks its layer
    alone, to the new values."""
    model = [layer(192, 3, seed=s) for s in range(3)]
    ops = packed_weights(BOTH, torch.float32, "cpu", *model[0])["ops"]
    wqkv, bqkv, wo, bo, w1, b1, w2, b2 = ops[:8]
    want_qkv, want_bqkv, want_wo, _ = fl._attn_weights(model[0][1],
                                                      torch.float32)
    mlp = model[0][3]
    for pack, w in ((wqkv, want_qkv), (wo, want_wo), (w1, mlp.fc1.kernel),
                    (w2, mlp.fc2.kernel)):
        assert pack.shape == (2, w.shape[1], w.shape[0])
        assert pack.is_contiguous()
        for half in pack:
            assert not (half.view(torch.int32) & 0x1FFF).any()
        err = (pack[0] + pack[1] - w.t()).abs().max()
        assert err <= 2.0 ** -22 * w.abs().max()
    assert torch.equal(bqkv, want_bqkv)
    start = pack_weights.packings
    for _ in range(2):
        entries = [packed_weights(BOTH, torch.float32, "cpu", *m)
                   for m in model]
    assert pack_weights.packings == start + 2  # layers 1 and 2; 0 was packed
    with torch.no_grad():
        model[1][3].fc2.bias.add_(1.0)
    again = [packed_weights(BOTH, torch.float32, "cpu", *m) for m in model]
    assert pack_weights.packings == start + 3
    assert again[0] is entries[0] and again[2] is entries[2]
    assert again[1] is not entries[1]
    assert torch.equal(again[1]["ops"][7], model[1][3].fc2.bias)
