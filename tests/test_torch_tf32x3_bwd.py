"""The data flow of the two 3xTF32 backward kernels, emulated on the CPU.

The CUDA kernels run only on the card (``python3 chip_smoke.py``); here each
is emulated with torch in its own order, every f32 product as three TF32
products on split operands (``mm3``), with inputs from numpy seeds:

- attention_small's backward (``csrc/flash_attention_bwd.cu``): scores from
  the lse, then dq summed over 64-key tiles and dk, dv over 64-query tiles,
  each tile's product in a fresh accumulator folded in with f32 adds; at
  (B 2, S 1,024, H 1) and (B 1, S 1,025, H 4, a ragged last tile), within
  chip_smoke.py's ATTN_TOL of float64 and of the JAX ``attention_small``
  VJP under the Pallas interpreter;
- the training MLP's backward (``csrc/fused_mlp_train.cu``): dx by hidden
  tiles of 64 units, fresh per tile; dW1, dW2, db1, db2 by row slots (slot
  s takes row tiles s, s + slots, ...; at D 64 the slot's tiles alternate
  between two warpgroups whose sums meet at the end), fresh per row tile,
  and the slots summed in a fixed order; at D 64, 128 and 256 with a ragged
  last row tile and more row tiles than slots, within chip_smoke.py's
  MLP_TOL of float64 and of JAX ``make_fused_mlp_train(0.0)`` under the
  Pallas interpreter;
- the masks as the backward kernels draw them (m1 for a pair of
  accumulator elements, m2 for a group of four columns in place) equal
  ``dropout_mask`` bit for bit;
- the backward's scratch stays under 64 MiB from N 8,320 to 2,097,152 and
  does not grow with N.
"""

import importlib
import math
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu.kernels.fused_mlp import make_fused_mlp_train  # noqa: E402
from transformer_stm_tpu_torch.kernels import fused_mlp as port_mlp  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small_bwd_plain, attention_small_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    STREAM_HIDDEN, STREAM_OUT, TRAIN_BWD_TILE, dropout_mask,
    fused_mlp_train_bwd_plain, keep_scale, keep_threshold, philox4x32_10,
    tf32_split, train_bwd_scratch, train_bwd_slots)

jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")

ATTN_TOL = 1e-4   # chip_smoke.py: |err| <= ATTN_TOL + ATTN_TOL |ref|
MLP_TOL = 1e-4    # chip_smoke.py: max |err| <= MLP_TOL * max |ref|
TILE = 64         # rows of every tile, keys and queries of an attention tile
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernel reads the flag when it runs; another test module of
    the same worker may have imported it before the variable was set."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)


def mm3(a, b):
    """a @ b in emulated 3xTF32: the small terms, then the big product."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def _close(got, ref, tol):
    return bool(((got.double() - ref.double()).abs()
                 <= tol + tol * ref.double().abs()).all())


# ---------------------------------------------------------------------------
# attention_small backward: the flash pair at Dh 64
# ---------------------------------------------------------------------------

def attention_bwd3(q, k, v, o, lse, g):
    """The flash backward pair's data flow: (B, H, rows, 64) operands, p =
    2^(q.k scale log2 e - lse log2 e) for keys inside S, ds = p (dO.v -
    delta); dq over 64-key tiles, dk and dv over 64-query tiles, each tile
    in a fresh accumulator; dq and dk scaled at the end."""
    t, s, dh = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    delta = (g * o).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    x = mm3(qh, kh.transpose(-1, -2))
    p = torch.exp2(x * (scale * LOG2E) - (lse * LOG2E).unsqueeze(-1))
    ds = p * (mm3(gh, vh.transpose(-1, -2)) - delta)
    dq = torch.zeros_like(qh)
    for s0 in range(0, s, TILE):
        dq = dq + mm3(ds[..., s0:s0 + TILE], kh[:, :, s0:s0 + TILE])
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for t0 in range(0, t, TILE):
        rows = slice(t0, t0 + TILE)
        dv = dv + mm3(p[:, :, rows].transpose(-1, -2), gh[:, :, rows])
        dk = dk + mm3(ds[:, :, rows].transpose(-1, -2), qh[:, :, rows])
    back = (lambda y: y.permute(0, 2, 1, 3))
    return back(dq * scale), back(dk * scale), back(dv)


@pytest.mark.parametrize("shape", [(2, 1024, 1, 64), (1, 1025, 4, 64)],
                         ids=["B2_S1024_H1", "B1_S1025_H4"])
def test_emulated_attention_small_backward_within_tolerance(shape):
    rng = np.random.default_rng(shape[1])
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = attention_small_plain(tq, tk, tv, with_lse=True)
    got = attention_bwd3(tq, tk, tv, o, lse, tg)

    q64, k64, v64, g64 = (x.double() for x in (tq, tk, tv, tg))
    o64, lse64 = attention_small_plain(q64, k64, v64, with_lse=True)
    want64 = attention_small_bwd_plain(q64, k64, v64, o64, lse64, g64)
    _, vjp = jax.vjp(jax_fa.attention_small, *map(jnp.asarray, (q, k, v)))
    want_jax = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g))]
    for name, x, w64, wj in zip("qkv", got, want64, want_jax):
        assert _close(x, w64, ATTN_TOL), f"d{name} against float64"
        assert _close(x, wj, ATTN_TOL), f"d{name} against JAX"


# ---------------------------------------------------------------------------
# The training MLP's backward: dx by hidden tiles, dW by row slots
# ---------------------------------------------------------------------------

def _gelu_both(v):
    e = torch.special.erf(v * 0.7071067811865476)
    return (0.5 * v * (1.0 + e),
            0.5 * (1.0 + e) + v * torch.exp(-0.5 * v * v) * 0.3989422804014327)


def mlp_bwd3(x, w1, b1, w2, seed, rate, dy, sms):
    """The backward kernels' data flow on one row-major (N, D) problem."""
    n, d = x.shape
    hd = w1.shape[1]
    m1 = dropout_mask(seed, n, hd, STREAM_HIDDEN, rate)
    g = dy * dropout_mask(seed, n, d, STREAM_OUT, rate)
    h_act, grad = _gelu_both(mm3(x, w1) + b1)
    h, q = h_act * m1, grad * m1
    da = mm3(g, w2.t()) * q

    dx = torch.zeros_like(x)
    for c0 in range(0, hd, TILE):  # a fresh accumulator per hidden tile
        dx = dx + mm3(da[:, c0:c0 + TILE], w1[:, c0:c0 + TILE].t())

    tiles = -(-n // TILE)
    slots = train_bwd_slots(n, hd, sms)
    lanes = 2 if d == 64 else 1  # D 64: two warpgroups a slot
    parts = []
    for s in range(slots):
        acc = [[torch.zeros(d, hd), torch.zeros(hd, d), torch.zeros(hd),
                torch.zeros(d)] for _ in range(lanes)]
        for i, tile in enumerate(range(s, tiles, slots)):
            r = slice(TILE * tile, TILE * tile + TILE)
            a = acc[i % lanes]
            a[0] += mm3(x[r].t(), da[r])
            a[1] += mm3(g[r].t(), h[r]).t()
            a[2] += da[r].sum(0)
            a[3] += g[r].sum(0)
        parts.append([sum(a[j] for a in acc) for j in range(4)])
    dw1, dw2, db1, db2 = parts[0]
    for part in parts[1:]:  # the slots in a fixed order
        dw1, dw2, db1, db2 = (dw1 + part[0], dw2 + part[1], db1 + part[2],
                              db2 + part[3])
    return dx, dw1, db1, dw2, db2


def _mlp_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32)]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_emulated_mlp_backward_within_tolerance(d):
    """Rows 5 x 64 + 17: a ragged last row tile, and with 8 SMs (2 slots at
    D 64, 1 above) more row tiles than slots."""
    n = 5 * TILE + 17
    x, w1, b1, w2, b2, dy = _mlp_inputs(n, d, seed=d)
    seed = torch.tensor([1234, 5678], dtype=torch.int32)
    tx, tw1, tb1, tw2, tb2, tdy = map(torch.from_numpy, (x, w1, b1, w2, b2,
                                                         dy))
    assert -(-n // TILE) > train_bwd_slots(n, 4 * d, sms=8)
    f = make_fused_mlp_train(0.0, interpret=True)
    _, vjp = jax.vjp(lambda *a: f(*a, jnp.zeros(2, jnp.int32)),
                     *map(jnp.asarray, (x[None], w1, b1, w2, b2)))
    want_jax = vjp(jnp.asarray(dy[None]))
    for rate in (0.1, 0.0):
        got = mlp_bwd3(tx, tw1, tb1, tw2, seed, rate, tdy, sms=8)
        want64 = fused_mlp_train_bwd_plain(
            *(t.double() for t in (tx, tw1, tb1, tw2, tb2)), seed, rate,
            tdy.double())
        names = ("dx", "dW1", "db1", "dW2", "db2")
        for name, a, w in zip(names, got, want64):
            scale = w.abs().max().item()
            assert (a.double() - w).abs().max().item() <= MLP_TOL * scale, \
                f"rate {rate} {name} against float64"
        if rate == 0.0:
            for name, a, wj in zip(names, got, want_jax):
                wj = torch.from_numpy(np.array(wj)).reshape(a.shape)
                scale = wj.abs().max().item()
                assert (a - wj).abs().max().item() <= MLP_TOL * scale, \
                    f"{name} against JAX"


def _words(seed, e, stream):
    """Philox's four words for element indices e (int64 tensor)."""
    k = seed.to(torch.int64) & 0xFFFFFFFF
    grp = e >> 2
    return torch.stack(philox4x32_10(grp & 0xFFFFFFFF, stream, grp >> 32, 0,
                                     k[0], k[1]), dim=-1)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_backward_masks_equal_dropout_mask(rate):
    """m1 as the kernels draw it for accumulator elements (row, u) and
    (row, u + 1), u = 8 j + 2 t: one Philox group, words e & 3 and e & 3 +
    1; m2 as they draw it in place over a group of four columns."""
    seed = torch.tensor([987654, 321], dtype=torch.int32)
    n, d, hd = 70, 64, 256
    thr, scale = keep_threshold(rate), keep_scale(rate)
    rows = torch.arange(n).repeat_interleave(hd // 2)
    units = (2 * torch.arange(hd // 2)).repeat(n)
    e = rows * hd + units
    w = _words(seed, e, STREAM_HIDDEN)
    i = e & 3
    pair = torch.stack([w.gather(1, i[:, None])[:, 0],
                        w.gather(1, (i + 1)[:, None])[:, 0]], dim=-1)
    m1 = ((pair >= thr).to(torch.float32) * scale).reshape(n, hd)
    assert torch.equal(m1, dropout_mask(seed, n, hd, STREAM_HIDDEN, rate))
    e = torch.arange(n * d // 4) * 4  # the first column of each group
    m2 = ((_words(seed, e, STREAM_OUT) >= thr).to(torch.float32) * scale)
    assert torch.equal(m2.reshape(n, d),
                       dropout_mask(seed, n, d, STREAM_OUT, rate))


@pytest.mark.parametrize("part", [(1, 2), (3, 4)])
def test_backward_m1_takes_the_part(part):
    """``mask1`` of a tensor-parallel shard: element (row, u) at index row
    Hw + hoff + u, Hw = k Hd and hoff = i Hd, equals
    ``dropout_mask(part=(i, k))``."""
    seed = torch.tensor([987654, 321], dtype=torch.int32)
    n, hd, rate = 70, 64, 0.1
    i, k = part
    rows = torch.arange(n).repeat_interleave(hd // 2)
    units = (2 * torch.arange(hd // 2)).repeat(n)
    e = rows * (k * hd) + i * hd + units
    w = _words(seed, e, STREAM_HIDDEN)
    j = e & 3
    pair = torch.stack([w.gather(1, j[:, None])[:, 0],
                        w.gather(1, (j + 1)[:, None])[:, 0]], dim=-1)
    m1 = ((pair >= keep_threshold(rate)).to(torch.float32)
          * keep_scale(rate)).reshape(n, hd)
    assert torch.equal(m1, dropout_mask(seed, n, hd, STREAM_HIDDEN, rate,
                                        part))


@pytest.mark.parametrize("n", [8320, 32768, 131072, 2097152])
def test_scratch_stays_bounded(n):
    """Packed weights and row-slot partials: under 64 MiB at every width,
    the same at N 2,097,152 as at the CvT stages."""
    for d in (64, 128, 256):
        sizes = train_bwd_scratch(n, d, 4 * d, sms=132)
        assert 4 * sum(sizes) <= 64 * 2 ** 20
        assert sizes == train_bwd_scratch(max(n, 131072), d, 4 * d, sms=132)
        slots = train_bwd_slots(n, 4 * d, sms=132)
        assert slots * (4 * d // TRAIN_BWD_TILE) <= 132
        assert sizes == [6 * d * 4 * d, slots * (2 * d * 4 * d + 4 * d + d)]
    assert port_mlp.train_bwd_slots(100, 256, sms=132) == 2
