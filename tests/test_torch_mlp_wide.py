"""The training MLP at D 384 and 768 as products over row chunks, emulated
on the CPU.

The CUDA kernels (``csrc/fused_mlp_train.cu``, namespace chunk) run only on
the card (``python3 chip_smoke.py``); here their data flow is emulated with
torch in its own order, every f32 product as three TF32 products on split
operands (``mm3``), each pair of 32-deep K stages into a fresh accumulator
added into the tile's with f32 adds, with inputs from numpy seeds:

- the forward: per chunk of rows, h = Drop1(GELU(x W1 + b1)) into the
  chunk's hidden and y = Drop2(h W2 + b2);
- the backward: per chunk, x and g = dy m2 split; the scores a^T + b1 and
  dh^T; the combine step (h^T, da^T, da split, db1's sums over 32 rows);
  dx^T in four parts of K = Hd summed in order; dW1^T and dW2 added to
  chunk after chunk; db1 and db2 from the partial sums in order;

at D 384 and 768 with chunks of one row tile (192 rows in the backward,
128 in the forward) and N two chunks and a ragged remainder, within
chip_smoke.py's MLP_TOL of float64 and of JAX ``make_fused_mlp_train(0.0)``
under the Pallas interpreter, at rates 0.1 and 0; the masks as the kernels
read them (``mask_bits`` words, the forward epilogue's six words a row,
chunk_combine's word a row, chunk_prep's Philox groups) equal
``dropout_mask`` bit for bit; the backward's scratch stays within 64 MiB at
D 384 and 96 MiB at D 768 from N 591 to 2,097,152 and does not grow past
one chunk.
"""

import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu.kernels.fused_mlp import make_fused_mlp_train  # noqa: E402
from transformer_stm_tpu_torch.kernels import fused_mlp as pm  # noqa: E402
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    STREAM_HIDDEN, STREAM_OUT, dropout_mask, keep_scale, keep_threshold,
    philox4x32_10, tf32_split)

MLP_TOL = 1e-4    # chip_smoke.py: max |err| <= MLP_TOL * max |ref|
BK = 32           # K of a stage
FOLD = 2 * BK     # a pair of stages into one fresh accumulator
BWD_ROWS = pm.CHUNK_TILE_N   # a backward chunk of one row tile
FWD_ROWS = pm.CHUNK_TILE_M   # a forward chunk of one row tile
DX_PARTS = 4


def mm3(a, b):
    """a @ b in emulated 3xTF32: the small terms, then the big product."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def gemm(a, b_t):
    """A B^T over K (a's and b_t's last axis) by pairs of stages, each pair
    in a fresh accumulator added into the sum, as chunk_gemm's tiles run."""
    acc = torch.zeros(a.shape[0], b_t.shape[0])
    for k in range(0, a.shape[1], FOLD):
        acc = acc + mm3(a[:, k:k + FOLD], b_t[:, k:k + FOLD].t())
    return acc


def _gelu_both(v):
    e = torch.special.erf(v * 0.7071067811865476)
    return (0.5 * v * (1.0 + e),
            0.5 * (1.0 + e) + v * torch.exp(-0.5 * v * v) * 0.3989422804014327)


def _words(seed, e, stream):
    """Philox's four words for element indices e (int64 tensor)."""
    k = seed.to(torch.int64) & 0xFFFFFFFF
    grp = e >> 2
    return torch.stack(philox4x32_10(grp & 0xFFFFFFFF, stream, grp >> 32, 0,
                                     k[0], k[1]), dim=-1)


def mask_bits(seed, row0, rows, rows_all, width, stream, rate, whole=None,
              off=0):
    """The kernel's bit words: (rows_all, width / 32) int64, bit c % 32 of
    word (r, q) for element (row0 + r, off + 32 q + c % 32) of a mask
    ``whole`` wide (width unless given), zeros past rows."""
    thr = keep_threshold(rate)
    r = torch.arange(rows_all).repeat_interleave(width)
    c = torch.arange(width).repeat(rows_all)
    w = _words(seed, (row0 + r) * (whole or width) + off + c, stream)
    keep = (w.gather(1, (c & 3)[:, None])[:, 0] >= thr) & (r < rows)
    bits = (keep.to(torch.int64) << (c & 31)).reshape(rows_all, width // 32,
                                                      32)
    return bits.sum(-1)


def keep_from_bits(bits, rows, width, rate):
    """The (rows, width) multipliers the kernels take from the bits."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(width)[None, :]
    on = (bits[r, c >> 5] >> (c & 31)) & 1
    return on.to(torch.float32) * keep_scale(rate)


def epilogue_keep(bits, rows, width, rate):
    """The (rows, width) multipliers the forward epilogue takes from the
    bits: thread t of a quad holds columns col = nb + 8 j + e1 of a
    192-column tile (nb = 192 nt + 2 t, j < 24, e1 < 2) and reads them from
    word (nb >> 5) + j / 4 of its row, bit col & 31."""
    out = torch.full((rows, width), float("nan"))
    for nt in range(width // 192):
        for t in range(4):
            nb = 192 * nt + 2 * t
            for j in range(24):
                w = bits[:rows, (nb >> 5) + j // 4]
                for e1 in range(2):
                    col = nb + 8 * j + e1
                    out[:, col] = (((w >> (col & 31)) & 1).to(torch.float32)
                                   * keep_scale(rate))
    return out


def m2_prep(seed, n, d, rate):
    """m2 as chunk_prep draws it: one Philox group of four columns, word e
    for column 4 q + e."""
    if rate == 0.0:
        return torch.ones(n, d)
    e = torch.arange(n * d // 4) * 4
    w = _words(seed, e, STREAM_OUT)
    return ((w >= keep_threshold(rate)).to(torch.float32)
            * keep_scale(rate)).reshape(n, d)


def fwd_chunked(x, w1, b1, w2, b2, seed, rate, rows=FWD_ROWS):
    """The chunked forward: fc1 with GELU and m1 into the chunk's hidden,
    fc2 with b2 and m2, per chunk of `rows` rows."""
    n, d = x.shape
    hd = w1.shape[1]
    y = torch.empty(n, d)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        rc = -(-(r1 - r0) // pm.CHUNK_TILE_M) * pm.CHUNK_TILE_M
        xc = torch.zeros(rc, d)
        xc[:r1 - r0] = x[r0:r1]
        if rate:
            m1 = keep_from_bits(mask_bits(seed, r0, r1 - r0, rc, hd,
                                          STREAM_HIDDEN, rate), rc, hd, rate)
            m2 = keep_from_bits(mask_bits(seed, r0, r1 - r0, rc, d,
                                          STREAM_OUT, rate), rc, d, rate)
        else:
            m1, m2 = torch.ones(rc, hd), torch.ones(rc, d)
        h = _gelu_both(gemm(xc, w1t) + b1)[0] * m1
        y[r0:r1] = ((gemm(h, w2t) + b2) * m2)[:r1 - r0]
    return y


def bwd_chunked(x, w1, b1, w2, seed, rate, dy, rows=BWD_ROWS):
    """The chunked backward: (dx, dW1, db1, dW2, db2)."""
    n, d = x.shape
    hd = w1.shape[1]
    dx = torch.empty(n, d)
    w1t = w1.t().contiguous()
    g_all = dy * m2_prep(seed, n, d, rate)
    dw1t = dw2 = db1 = db2 = None
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        rc = -(-(r1 - r0) // pm.CHUNK_TILE_N) * pm.CHUNK_TILE_N
        xc, gc = torch.zeros(rc, d), torch.zeros(rc, d)
        xc[:r1 - r0], gc[:r1 - r0] = x[r0:r1], g_all[r0:r1]
        gpart = gc.reshape(rc // 32, 32, d).sum(1)  # chunk_prep, db2
        # the scores: a^T + b1 and dh^T, (Hd, rc)
        at = gemm(w1t, xc) + b1[:, None]
        dht = gemm(w2, gc)
        # chunk_combine
        if rate:
            bits = mask_bits(seed, r0, r1 - r0, rc, hd, STREAM_HIDDEN, rate)
            m1t = keep_from_bits(bits, rc, hd, rate).t()
        else:
            m1t = (torch.arange(rc) < r1 - r0).to(torch.float32).expand(hd,
                                                                        rc)
        h, q = _gelu_both(at)
        ht, dat = h * m1t, dht * (q * m1t)
        dapart = dat.t().reshape(rc // 32, 32, hd).sum(1)
        # the bias sums, in order
        s1, s2 = dapart[0], gpart[0]
        for k in range(1, rc // 32):
            s1, s2 = s1 + dapart[k], s2 + gpart[k]
        db1 = s1 if db1 is None else db1 + s1
        db2 = s2 if db2 is None else db2 + s2
        # dx^T in four parts of K = Hd, summed in order
        kp = hd // DX_PARTS
        parts = [gemm(w1[:, p * kp:(p + 1) * kp],
                      dat.t()[:, p * kp:(p + 1) * kp].contiguous())
                 for p in range(DX_PARTS)]
        dxt = parts[0]
        for part in parts[1:]:
            dxt = dxt + part
        dx[r0:r1] = dxt.t()[:r1 - r0]
        # the weights, added to chunk after chunk
        c1, c2 = gemm(dat, xc.t().contiguous()), gemm(ht, gc.t().contiguous())
        dw1t = c1 if dw1t is None else dw1t + c1
        dw2 = c2 if dw2 is None else dw2 + c2
    return dx, dw1t.t(), db1, dw2, db2


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32)]


@pytest.mark.parametrize("d", pm.CHUNKED_WIDTHS)
def test_emulated_chunked_mlp_within_tolerance(d):
    """N = 2 x 192 + 17: two full backward chunks and a ragged third (three
    forward chunks and a ragged fourth), at rates 0.1 and 0, against
    float64 and (rate 0) JAX under the Pallas interpreter."""
    n = 2 * BWD_ROWS + 17
    x, w1, b1, w2, b2, dy = _inputs(n, d, seed=d)
    seed = torch.tensor([4321, 8765], dtype=torch.int32)
    tx, tw1, tb1, tw2, tb2, tdy = map(torch.from_numpy, (x, w1, b1, w2, b2,
                                                         dy))
    f = make_fused_mlp_train(0.0, interpret=True)
    y, vjp = jax.vjp(lambda *a: f(*a, jnp.zeros(2, jnp.int32)),
                     *map(jnp.asarray, (x[None], w1, b1, w2, b2)))
    want_jax = (y, *vjp(jnp.asarray(dy[None])))
    names = ("y", "dx", "dW1", "db1", "dW2", "db2")
    for rate in (0.1, 0.0):
        got = (fwd_chunked(tx, tw1, tb1, tw2, tb2, seed, rate),
               *bwd_chunked(tx, tw1, tb1, tw2, seed, rate, tdy))
        a64 = [t.double() for t in (tx, tw1, tb1, tw2, tb2)]
        want64 = (pm.fused_mlp_train_plain(*a64, seed, rate),
                  *pm.fused_mlp_train_bwd_plain(*a64, seed, rate,
                                                tdy.double()))
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


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_chunked_masks_equal_dropout_mask(rate):
    """m1 and m2 as the chunked kernels read them, over two chunks at a row
    offset, equal dropout_mask bit for bit: mask_bits' words; the forward
    epilogue's reads of six words a 192-column tile row
    (``epilogue_keep``);
    chunk_combine's one word of 32 units a row; chunk_prep's Philox group
    of four columns."""
    seed = torch.tensor([2468, 1357], dtype=torch.int32)
    d, hd, rows = 384, 1536, 2 * 192
    want1 = dropout_mask(seed, 800, hd, STREAM_HIDDEN, rate)
    want2 = dropout_mask(seed, 800, d, STREAM_OUT, rate)
    for r0 in (0, rows):
        bits1 = mask_bits(seed, r0, rows, rows, hd, STREAM_HIDDEN, rate)
        bits2 = mask_bits(seed, r0, rows, rows, d, STREAM_OUT, rate)
        assert torch.equal(keep_from_bits(bits1, rows, hd, rate),
                           want1[r0:r0 + rows])
        assert torch.equal(keep_from_bits(bits2, rows, d, rate),
                           want2[r0:r0 + rows])
        assert torch.equal(epilogue_keep(bits1, rows, hd, rate),
                           want1[r0:r0 + rows])
        assert torch.equal(epilogue_keep(bits2, rows, d, rate),
                           want2[r0:r0 + rows])
        # chunk_combine: the word of units u0 .. u0 + 31 of row r
        u0 = 32 * 7
        word = bits1[:, u0 // 32]
        u = torch.arange(u0, u0 + 32)
        on = (word[:, None] >> (u & 31)[None, :]) & 1
        assert torch.equal(on.to(torch.float32) * keep_scale(rate),
                           want1[r0:r0 + rows, u0:u0 + 32])
    assert torch.equal(m2_prep(seed, 800, d, rate), want2)


@pytest.mark.parametrize("part", [(1, 2), (3, 4)])
def test_chunked_m1_bits_take_the_part(part):
    """mask_bits of a tensor-parallel shard (whole Hw = k Hd, first
    column hoff = i Hd) at a row offset equal ``dropout_mask(part=(i,
    k))``, as the kernels read them."""
    seed = torch.tensor([2468, 1357], dtype=torch.int32)
    hd, rows, rate = 384, 192, 0.1
    i, k = part
    want = dropout_mask(seed, 2 * rows, hd, STREAM_HIDDEN, rate, part)
    bits = mask_bits(seed, rows, rows, rows, hd, STREAM_HIDDEN, rate,
                     k * hd, i * hd)
    assert torch.equal(keep_from_bits(bits, rows, hd, rate), want[rows:])
    assert torch.equal(epilogue_keep(bits, rows, hd, rate), want[rows:])


def test_chunked_bits_past_the_rows_are_zero():
    """A ragged chunk's padded rows draw no kept element, so h and da are
    zero there whatever the seed."""
    seed = torch.tensor([5, 6], dtype=torch.int32)
    bits = mask_bits(seed, 192, 17, 192, 1536, STREAM_HIDDEN, 0.1)
    assert bits[17:].abs().sum().item() == 0 and bits[:17].abs().sum() > 0


@pytest.mark.parametrize("d", pm.CHUNKED_WIDTHS)
def test_chunked_scratch_is_bounded(d):
    """The backward's scratch within chip_smoke.py's limits (64 MiB at D
    384, 96 MiB at D 768) from N 591 to 2,097,152, the same for every N
    past one chunk; chunks of whole 192-row tiles."""
    hd, limit = 4 * d, (96 if d == 768 else 64) * 2 ** 20
    full = pm.train_bwd_scratch(2_097_152, d, hd)
    for n in (591, 64 * 197, 131_072, 2_097_152):
        sizes = pm.train_bwd_scratch(n, d, hd)
        assert 4 * sum(sizes) <= limit
        r = pm.train_chunk_rows(n, d)
        assert r % pm.CHUNK_TILE_N == 0
        if n >= pm.BWD_CHUNK_ROWS[d]:
            assert sizes == full
    assert pm.train_chunk_rows(100, d) == pm.CHUNK_TILE_N
    assert 4 * sum(pm.train_bwd_scratch(100, d, hd)) < 4 * sum(full)


@pytest.mark.parametrize("d", pm.CHUNKED_WIDTHS)
def test_chunked_forward_chunks_fill_the_card(d):
    """The forward's chunk, 132 x 128 x 192 / D rows: fc2's tiles at that
    chunk are 132 (one per SM), fc1's four times that; fewer rows for a
    smaller N, in whole 128-row tiles."""
    r = pm.train_fwd_chunk_rows(10 ** 6, d)
    assert r // pm.CHUNK_TILE_M * (d // pm.CHUNK_TILE_N) == 132
    assert r // pm.CHUNK_TILE_M * (4 * d // pm.CHUNK_TILE_N) == 4 * 132
    assert pm.train_fwd_chunk_rows(591, d) == 640
