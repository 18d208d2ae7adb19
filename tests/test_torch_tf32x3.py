"""The 3xTF32 numerical scheme of the port's f32 tensor-core kernels, on the
CPU.

``csrc/fused_mlp.cu`` and ``csrc/flash_attention_bwd.cu`` compute f32
products on the tensor cores as three TF32 products: each operand a is
split into big = rna_tf32(a) and small = rna_tf32(a - big), and a b is
summed as small_a big_b + big_a small_b + big_a big_b in f32.  The CUDA
kernels run only on the card (``python3 chip_smoke.py``); here the scheme
is emulated with torch on the CPU:

- ``tf32_round`` / ``tf32_split`` (the wrapper's weight packing) against
  the definition: 10 explicit mantissa bits, round to nearest with ties
  away from zero, big + small within 2^-22 of a;
- ``fused_mlp`` in emulated 3xTF32 against float64 and against the JAX
  ``fused_mlp`` under the Pallas interpreter, at D 64 and 384, within
  MLP_TOL of max |y| (chip_smoke.py's bar for the kernel);
- the flash backward in emulated 3xTF32, with the kernels' data flow (p
  from the lse, dS, products over 512-key blocks), at S 4,096 with Dh 64
  and Dh 33 zero-padded to 40, within FLASH_TOL of float64;
- the wrapper's pre-pass: ``padded_head_dim``, ``pad_head_dim`` on CPU
  tensors, and ``flash_attention_bwd_plain`` on padded inputs equal to the
  unpadded result in the true columns;
- the k-order (``kpos`` in csrc/tf32x3.cuh) that lets an accumulator feed
  a product as its register A operand;
- ``packed_mlp_weights``: layout, reuse, and repacking after an in-place
  update, bfloat16 weights included (packed once, converted inside the
  pack).
"""

import importlib
import math
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu_torch.kernels import fused_mlp as port_mlp  # noqa: E402
from transformer_stm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain, pad_head_dim,
    padded_head_dim)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    fused_mlp_plain, kpos_order, packed_mlp_weights, tf32_round, tf32_split)

jax_mlp = importlib.import_module("transformer_stm_tpu.kernels.fused_mlp")

MLP_TOL = 1e-4    # chip_smoke.py: max |kernel - ref| <= MLP_TOL * max |ref|
FLASH_TOL = 1e-5  # chip_smoke.py: max |kernel - ref| <= FLASH_TOL * max |ref|
BLOCK = 512       # keys per block of the emulated flash backward


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernel reads the flag when it runs; another test module of
    the same worker may have imported it before the variable was set."""
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)


def _bits(x):
    return x.view(torch.int32)


def mm3(a, b):
    """a @ b in emulated 3xTF32: three products of TF32 halves, in f32."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return as_ @ bb + ab @ bs + ab @ bb


def _gelu(x):
    return 0.5 * x * (1.0 + torch.special.erf(x * 0.7071067811865476))


def mlp3(x, w1, b1, w2, b2):
    """fused_mlp's arithmetic in emulated 3xTF32."""
    return mm3(_gelu(mm3(x, w1) + b1), w2) + b2


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_tf32_round_keeps_ten_mantissa_bits(scale):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32)) * scale
    big = tf32_round(x)
    assert (_bits(big) & 0x1FFF == 0).all()
    # to nearest: within half a TF32 ulp, 2^-11 of |x|
    assert ((big - x).abs() <= x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_rebuilds_within_2_22(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(8192) *
                          10.0 ** rng.uniform(-6, 6, 8192)).astype(np.float32))
    big, small = tf32_split(x)
    assert (_bits(big) & 0x1FFF == 0).all()
    assert (_bits(small) & 0x1FFF == 0).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -22).all()


def test_tf32_round_ties_away_from_zero():
    # 1 + 2^-11 is halfway between the TF32 neighbours 1 and 1 + 2^-10
    half = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                         1.0 + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tf32_round(half), want)


def _mlp_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32)]


@pytest.mark.parametrize("d", [64, 384])
def test_emulated_fused_mlp_within_tolerance(d):
    """3xTF32 keeps fused_mlp within MLP_TOL of float64 and of the JAX
    kernel; a single TF32 product would not hold the f32 bar."""
    args = _mlp_inputs(24, d, seed=d)
    got = mlp3(*map(torch.from_numpy, args))
    want64 = fused_mlp_plain(*(torch.from_numpy(a).double() for a in args))
    want_jax = np.asarray(jax_mlp.fused_mlp(*map(jnp.asarray, args)))
    scale = want64.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= MLP_TOL * scale
    assert np.abs(got.numpy() - want_jax).max() <= MLP_TOL * scale
    # the scheme's point: 3xTF32 is f32-accurate where one TF32 pass is not
    assert (got.double() - want64).abs().max().item() <= 1e-5 * scale
    x, w1, b1, w2, b2 = map(torch.from_numpy, args)
    one = tf32_round(_gelu(tf32_round(x) @ tf32_round(w1) + b1))
    one = one @ tf32_round(w2) + b2
    assert (one.double() - want64).abs().max().item() > 1e-4 * scale


def flash_bwd3(q, k, v, o, lse, g, scale):
    """The backward kernels' data flow in emulated 3xTF32: scores and dP by
    key blocks, p from the saved lse, dS = p (dP - delta), dq = scale dS k,
    dk = scale dS^T q, dv = p^T dO.  (B, T, H, Dh) layouts as the kernels."""
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    delta = (g * o).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    lse = lse.unsqueeze(-1)
    dq = torch.zeros_like(qh)
    dks, dvs = [], []
    for s0 in range(0, k.shape[1], BLOCK):
        kb, vb = kh[:, :, s0:s0 + BLOCK], vh[:, :, s0:s0 + BLOCK]
        p = torch.exp(mm3(qh, kb.transpose(-1, -2)) * scale - lse)
        ds = p * (mm3(gh, vb.transpose(-1, -2)) - delta)
        dq = dq + mm3(ds, kb) * scale
        dks.append(mm3(ds.transpose(-1, -2), qh) * scale)
        dvs.append(mm3(p.transpose(-1, -2), gh))
    back = (lambda x: x.permute(0, 2, 1, 3))
    return back(dq), back(torch.cat(dks, 2)), back(torch.cat(dvs, 2))


@pytest.mark.parametrize("dh", [64, 33], ids=["Dh64", "Dh33_padded_to_40"])
def test_emulated_flash_backward_within_tolerance(dh):
    rng = np.random.default_rng(dh)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 4096, 1, dh))
                                   .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    dhp = padded_head_dim(dh)
    assert dhp == (64 if dh == 64 else 40)
    qp, kp, vp, gp, op = (pad_head_dim(x, dhp) for x in (q, k, v, g, o))
    got = [x[..., :dh] for x in
           flash_bwd3(qp, kp, vp, op, lse, gp, 1.0 / math.sqrt(dh))]
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    o64, lse64 = flash_attention_plain(q64, k64, v64, with_lse=True)
    want = flash_attention_bwd_plain(q64, k64, v64, o64, lse64, g64)
    for x, w in zip(got, want):
        assert ((x.double() - w).abs().max() / w.abs().max()).item() <= \
            FLASH_TOL


@pytest.mark.parametrize("dh,want", [(1, 32), (16, 32), (33, 40), (64, 64),
                                     (100, 104), (256, 256)])
def test_padded_head_dim(dh, want):
    assert padded_head_dim(dh) == want


def test_pad_head_dim_on_cpu_tensors():
    x = torch.randn(2, 5, 3, 33)
    p = pad_head_dim(x, 40)
    assert p.shape == (2, 5, 3, 40) and p.is_contiguous()
    assert torch.equal(p[..., :33], x) and not p[..., 33:].any()
    y = torch.randn(2, 5, 3, 40)
    assert pad_head_dim(y, 40) is y  # already padded and aligned: no copy
    view = torch.randn(2 * 5 * 3 * 40 + 1)[1:].view(2, 5, 3, 40)
    moved = pad_head_dim(view, 40)  # 4 bytes off 16-byte alignment: a copy
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)


@pytest.mark.parametrize("dh", [33, 16])
def test_plain_backward_on_padded_inputs_equals_unpadded(dh):
    """The wrapper zero-pads q, k, v and dO and keeps the scale of the true
    head dim: the padded problem's true columns are the unpadded result,
    and its padded columns are zero."""
    rng = np.random.default_rng(dh)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, n, 2, dh))
                                   .astype(np.float64)) for n in (70, 130,
                                                                  130, 70))
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, g)
    dhp = padded_head_dim(dh)
    padded = [pad_head_dim(x, dhp) for x in (q, k, v, o)]
    got = flash_attention_bwd_plain(*padded, lse, pad_head_dim(g, dhp),
                                    scale=1.0 / math.sqrt(dh))
    for x, w in zip(got, want):
        torch.testing.assert_close(x[..., :dh], w, rtol=1e-12, atol=1e-12)
        assert not x[..., dh:].any()


def kpos(c):
    """csrc/tf32x3.cuh's kpos: the k-position of accumulator column c when
    the accumulator is fed back as the register A operand."""
    return (c & ~7) | ((c & 1) << 2) | ((c >> 1) & 3)


def test_kpos_order_moves_each_column_to_its_kpos():
    w_t = torch.arange(3 * 64, dtype=torch.float32).reshape(3, 64)
    moved = kpos_order(w_t)
    for c in range(64):
        assert torch.equal(moved[:, kpos(c)], w_t[:, c])


def test_accumulator_as_register_a_with_kpos_order():
    """Thread (warp w, lane 4 g + t) holds accumulator columns 8 j + 2 t and
    8 j + 2 t + 1 and feeds them as A's k-positions t and t + 4 of k-step j
    (csrc/tf32x3.cuh): the product is exact when B's rows take kpos order."""
    rng = np.random.default_rng(3)
    acc = rng.standard_normal((64, 64))
    b = rng.standard_normal((64, 48))
    a_eff = np.zeros_like(acc)
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j in range(8):
                for row in (16 * w + g, 16 * w + g + 8):
                    a_eff[row, 8 * j + t] = acc[row, 8 * j + 2 * t]
                    a_eff[row, 8 * j + t + 4] = acc[row, 8 * j + 2 * t + 1]
    b_eff = np.zeros_like(b)
    for c in range(64):
        b_eff[kpos(c)] = b[c]
    assert sorted(kpos(c) for c in range(64)) == list(range(64))
    np.testing.assert_allclose(a_eff @ b_eff, acc @ b, rtol=1e-12, atol=1e-12)


def test_packed_weights_layout_and_reuse():
    w1, w2 = torch.randn(64, 256), torch.randn(256, 64)
    before = packed_mlp_weights.packings
    p1, p2 = packed_mlp_weights(w1, w2)
    assert p1.shape == (2, 256, 64) and p2.shape == (2, 64, 256)
    # D 64 splits fc2's K: W2^T's hidden columns come in kpos order
    for packed, w_t in ((p1, w1.t()), (p2, kpos_order(w2.t()))):
        big, small = tf32_split(w_t.contiguous())
        assert torch.equal(packed[0], big) and torch.equal(packed[1], small)
    w3, w4 = torch.randn(256, 1024), torch.randn(1024, 256)  # D 256: as is
    assert torch.equal(packed_mlp_weights(w3, w4)[1][0],
                       tf32_round(w4.t().contiguous()))
    again = packed_mlp_weights(w1, w2)
    assert again[0] is p1 and again[1] is p2
    assert packed_mlp_weights.packings == before + 2


def test_packed_weights_follow_in_place_updates():
    w1, w2 = torch.randn(64, 128), torch.randn(128, 64)
    p1, _ = packed_mlp_weights(w1, w2)
    with torch.no_grad():
        w1.mul_(2.0)
    q1, _ = packed_mlp_weights(w1, w2)
    assert q1 is not p1 and torch.equal(q1[0], tf32_round(w1.t().contiguous()))
    key = (id(w1), id(w2))
    assert key in port_mlp._PACKS
    del w1, q1
    assert key not in port_mlp._PACKS  # dropped with the weight


def test_packed_weights_of_bf16_weights_pack_once():
    """``fused_mlp`` hands bfloat16 weights to the cache as they are, and
    the pack converts them to float32: two packs of the same weights count
    one packing, and an in-place update of them repacks."""
    rng = np.random.default_rng(11)
    w1, w2 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(torch.bfloat16) for shape in ((64, 256), (256, 64)))
    before = packed_mlp_weights.packings
    p1, p2 = packed_mlp_weights(w1, w2)
    again = packed_mlp_weights(w1, w2)
    assert again[0] is p1 and again[1] is p2
    assert packed_mlp_weights.packings == before + 1
    assert p1.dtype == torch.float32 and p2.dtype == torch.float32
    assert _is_pack_of((p1, p2), w1.float(), w2.float())
    with torch.no_grad():
        w2.mul_(2.0)
    q1, q2 = packed_mlp_weights(w1, w2)
    assert packed_mlp_weights.packings == before + 2
    assert q2 is not p2 and _is_pack_of((q1, q2), w1.float(), w2.float())


def test_packed_weights_of_inference_tensors_are_not_kept():
    with torch.inference_mode():
        w1, w2 = torch.randn(64, 128), torch.randn(128, 64)
    before = packed_mlp_weights.packings
    packed_mlp_weights(w1, w2)
    packed_mlp_weights(w1, w2)
    assert packed_mlp_weights.packings == before + 2
    assert (id(w1), id(w2)) not in port_mlp._PACKS


def _param_pair():
    rng = np.random.default_rng(7)
    return [torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))
        for shape in ((64, 256), (256, 64))]


def _is_pack_of(packed, w1, w2):
    want = port_mlp.pack_mlp_weights(w1, w2)
    return all(torch.equal(p, w) for p, w in zip(packed, want))


def test_packed_weights_follow_vector_to_parameters():
    """``vector_to_parameters`` rebinds ``.data`` and bumps no version: the
    storage in the cache's key sees it, and the next call repacks."""
    w1, w2 = _param_pair()
    packed_mlp_weights(w1, w2)
    versions = (w1._version, w2._version)
    torch.nn.utils.vector_to_parameters(
        torch.ones(w1.numel() + w2.numel()), [w1, w2])
    assert (w1._version, w2._version) == versions
    before = packed_mlp_weights.packings
    packed = packed_mlp_weights(w1, w2)
    assert packed_mlp_weights.packings == before + 1
    assert _is_pack_of(packed, w1, w2)
    assert packed[0][0].sum().item() == w1.numel()  # big halves of 1.0


def test_packed_weights_after_data_copy_need_clear_weight_packs():
    """A write through ``.data`` changes neither version nor storage; after
    ``kernels.clear_weight_packs()`` the pack follows the new weights."""
    from transformer_stm_tpu_torch.kernels import clear_weight_packs

    w1, w2 = _param_pair()
    old = packed_mlp_weights(w1, w2)
    w1.data.copy_(torch.full_like(w1, 2.0))
    assert packed_mlp_weights(w1, w2) is old  # no key can see the write
    clear_weight_packs()
    assert (id(w1), id(w2)) not in port_mlp._PACKS
    packed = packed_mlp_weights(w1, w2)
    assert packed is not old and _is_pack_of(packed, w1, w2)
