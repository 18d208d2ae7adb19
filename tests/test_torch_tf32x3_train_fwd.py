"""The data flow of the training MLP's forward kernel, emulated on the CPU.

``fused_mlp_train``'s forward is ``csrc/fused_mlp.cu``'s body with its
dropout flag: y = ((GELU(x W1 + b1) m1) W2 + b2) m2 in f32 on the tensor
cores in 3xTF32.  The CUDA kernel runs only on the card (``python3
chip_smoke.py``, phase 2); here its order is emulated with torch, every f32
product as three TF32 products on split operands (``mm3``), with inputs from
numpy seeds, at N 209 (three 64-row tiles and a ragged fourth) and the
three CvT widths:

- fc1 by hidden chunks of 128 units, each 32-column slab of x into a fresh
  accumulator folded in with f32 adds; GELU, then m1, in registers;
- fc2 split K at D 64 and 128 (each warpgroup's 64 units of a chunk into
  its own partial y over all D columns, the two partials summed once at the
  end) and split columns at D 256 (the whole chunk into each warpgroup's
  half of y), each 32-unit slab fresh; then (y + b2) m2;
- within chip_smoke.py's MLP_TOL of ``fused_mlp_train_plain`` and of its
  float64 evaluation at rates 0.1 and 0, and of JAX
  ``make_fused_mlp_train(0.0)`` under the Pallas interpreter at rate 0;
- its zeros exactly where m2 is zero;
- the masks as the kernel draws them (``keep_quad``: threads t and t ^ 1
  each draw one Philox group, of rows ra and ra + 8, and trade the two
  words the other needs) equal ``dropout_mask`` bit for bit, and the
  schedule that draws a chunk's m1 groups over its fc1 stages draws each
  group once.
"""

import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu.kernels.fused_mlp import make_fused_mlp_train  # noqa: E402
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    SPLIT_K_WIDTHS, STREAM_HIDDEN, STREAM_OUT, dropout_mask,
    fused_mlp_train_plain, keep_scale, keep_threshold, philox4x32_10,
    tf32_split)

MLP_TOL = 1e-4   # chip_smoke.py: max |kernel - ref| <= MLP_TOL * max |ref|
ROWS = 64        # rows of a tile
HW = 64          # hidden units of a warpgroup in a chunk
HC = 2 * HW      # hidden chunk
KS = 32          # columns of a slab (one 128-byte row of f32)
N = 3 * ROWS + 17
SEED = (1234, 5678)


def mm3(a, b):
    """a @ b in emulated 3xTF32: the small terms, then the big product."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def _gelu(v):
    return 0.5 * v * (1.0 + torch.special.erf(v * 0.7071067811865476))


def _words(seed, e, stream):
    """Philox's four words of the groups of element indices e."""
    k = seed.to(torch.int64) & 0xFFFFFFFF
    grp = e >> 2
    return torch.stack(philox4x32_10(grp & 0xFFFFFFFF, stream, grp >> 32, 0,
                                     k[0], k[1]), dim=-1)


def kernel_keep(seed, n, width, stream, rate, whole=None, off=0):
    """The keep multipliers of a (n, width) mask as ``keep_quad`` draws
    them: thread t of each quad holds columns 8 j + 2 t, + 1 of rows ra and
    ra + 8 (ra = 16 w + g of a tile); it draws the group of row ra (even t)
    or ra + 8 (odd t) and trades words with thread t ^ 1.  With ``whole``
    and ``off`` (the launch's Hw and hoff) the columns are off .. off +
    width - 1 of a mask ``whole`` wide."""
    whole = whole or width
    thr = keep_threshold(rate)
    npad = -(-n // ROWS) * ROWS
    ra = torch.tensor([r for r in range(npad) if r % 16 < 8])
    j = torch.arange(width // 8)
    t = torch.arange(4)
    odd = (t & 1).bool()
    e_top = ra[:, None, None] * whole + off + 8 * j[None, :, None] + 2 * t
    w = _words(seed, e_top - 2 * odd.long() + odd.long() * 8 * whole, stream)
    send0 = torch.where(odd, w[..., 0], w[..., 2])
    send1 = torch.where(odd, w[..., 1], w[..., 3])
    partner = t ^ 1
    recv0, recv1 = send0[..., partner], send1[..., partner]
    words = {(0, 0): torch.where(odd, recv0, w[..., 0]),  # row ra
             (0, 1): torch.where(odd, recv1, w[..., 1]),
             (8, 0): torch.where(odd, w[..., 2], recv0),  # row ra + 8
             (8, 1): torch.where(odd, w[..., 3], recv1)}
    keep = torch.zeros(npad, width, dtype=torch.bool)
    cols = (8 * j[:, None] + 2 * t).expand(len(ra), -1, -1)
    rows = ra[:, None, None].expand_as(cols)
    for (dr, dc), word in words.items():
        keep[rows + dr, cols + dc] = word >= thr
    return keep[:n].to(torch.float32) * keep_scale(rate)


def train_fwd3(x, w1, b1, w2, b2, seed, rate):
    """The forward kernel's data flow on one row-major (N, D) problem."""
    n, d = x.shape
    hd = w1.shape[1]
    split_k = d in SPLIT_K_WIDTHS
    if rate == 0.0:
        m1, m2 = torch.ones(n, hd), torch.ones(n, d)
    else:
        m1 = kernel_keep(seed, n, hd, STREAM_HIDDEN, rate)
        # split K draws m2 a group of four columns at a time, as the mask
        m2 = (dropout_mask(seed, n, d, STREAM_OUT, rate) if split_k
              else kernel_keep(seed, n, d, STREAM_OUT, rate))
    ys = [torch.zeros(n, d), torch.zeros(n, d)] if split_k else \
        [torch.zeros(n, d)]
    for h0 in range(0, hd, HC):
        acc = torch.zeros(n, HC)
        for k0 in range(0, d, KS):  # a fresh accumulator per slab of x
            acc = acc + mm3(x[:, k0:k0 + KS], w1[k0:k0 + KS, h0:h0 + HC])
        h = _gelu(acc + b1[h0:h0 + HC]) * m1[:, h0:h0 + HC]
        for s0 in range(0, HC, KS):  # a fresh accumulator per 32-unit slab
            wg = s0 // HW if split_k else 0
            ys[wg] = ys[wg] + mm3(h[:, s0:s0 + KS], w2[h0 + s0:h0 + s0 + KS])
    y = (ys[0] + ys[1]) if split_k else ys[0]
    return (y + b2) * m2


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((N, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32)]


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_emulated_train_forward_within_tolerance(d, rate):
    args = [torch.from_numpy(a) for a in _inputs(d, seed=d)]
    seed = torch.tensor(SEED, dtype=torch.int32)
    got = train_fwd3(*args, seed, rate)
    want = fused_mlp_train_plain(*args, seed, rate)
    want64 = fused_mlp_train_plain(*(t.double() for t in args), seed, rate)
    for ref in (want, want64):
        scale = ref.abs().max().item()
        assert (got.double() - ref.double()).abs().max().item() <= \
            MLP_TOL * scale


@pytest.mark.parametrize("d", [64, 128, 256])
def test_emulated_train_forward_at_rate_0_matches_jax(d):
    arrays = _inputs(d, seed=d + 1)
    got = train_fwd3(*map(torch.from_numpy, arrays),
                     torch.tensor(SEED, dtype=torch.int32), 0.0)
    f = make_fused_mlp_train(0.0, interpret=True)
    want = np.asarray(f(jnp.asarray(arrays[0][None]),
                        *map(jnp.asarray, arrays[1:]),
                        jnp.zeros(2, jnp.int32)))[0]
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= MLP_TOL * scale


@pytest.mark.parametrize("d", [64, 128, 256])
def test_emulated_zeros_are_m2s(d):
    args = [torch.from_numpy(a) for a in _inputs(d, seed=d + 2)]
    seed = torch.tensor(SEED, dtype=torch.int32)
    got = train_fwd3(*args, seed, 0.1)
    m2 = dropout_mask(seed, N, d, STREAM_OUT, 0.1)
    assert (m2 == 0).any()
    assert torch.equal(got == 0, m2 == 0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("width", [64, 256, 512, 1024])
def test_kernel_mask_draws_equal_dropout_mask(width, rate):
    seed = torch.tensor([987654, 321], dtype=torch.int32)
    for stream in (STREAM_HIDDEN, STREAM_OUT):
        assert torch.equal(kernel_keep(seed, N, width, stream, rate),
                           dropout_mask(seed, N, width, stream, rate))


@pytest.mark.parametrize("part", [(1, 2), (3, 4), (0, 4)])
@pytest.mark.parametrize("width", [64, 128])
def test_kernel_mask_draws_take_the_part(width, part):
    """m1 of a tensor-parallel shard as ``keep_quad`` draws it at Hw = k
    width and hoff = i width equals ``dropout_mask(part=(i, k))``."""
    seed = torch.tensor([987654, 321], dtype=torch.int32)
    i, k = part
    assert torch.equal(
        kernel_keep(seed, N, width, STREAM_HIDDEN, 0.1, k * width, i * width),
        dropout_mask(seed, N, width, STREAM_HIDDEN, 0.1, part))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_m1_groups_spread_over_the_fc1_stages_once(d):
    """fc1 stage ks of a chunk draws groups j in [ks per, (ks + 1) per) of
    the HW / 8 a thread holds, per = ceil(HW / 8 / (D / 32))."""
    nslab = d // KS
    per = -(-(HW // 8) // nslab)
    drawn = [j for ks in range(nslab)
             for j in range(ks * per, min(HW // 8, (ks + 1) * per))]
    assert drawn == list(range(HW // 8))
