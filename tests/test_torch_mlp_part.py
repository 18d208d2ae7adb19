"""The training MLP's hidden mask under tensor parallelism, on the CPU.

When tensor parallelism splits the MLP's hidden units over k ranks, rank i
holds column block i of W1 and b1 and row block i of W2, and runs the fused
training MLP on its block with ``part=(i, k)``.  Its hidden mask m1 must be
block i of the mask the replicated MLP draws, not a mask of its own keyed on
the shard's local index (every rank would then drop the same pattern of its
units).  Checked here on ``fused_mlp_train_plain``, ``FusedMLPTrain`` (whose
CPU backward is ``fused_mlp_train_bwd_plain``) and ``dropout_mask``; the
CUDA kernels take the same index (csrc/philox.cuh) and ``chip_smoke.py``
holds them against these plain versions at parts (1, 2) and (3, 4).
"""

import numpy as np
import pytest
import torch

from transformer_stm_tpu_torch.kernels import fused_mlp as k

D, HD, RATE = 64, 256, 0.1


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=1.0: torch.from_numpy(
        (s * rng.standard_normal(shape)).astype(np.float32))
    return (t(3, 17, D), t(D, HD, s=D ** -0.5), t(HD, s=0.1),
            t(HD, D, s=HD ** -0.5), t(D, s=0.1), t(3, 17, D))


def _shard(w1, b1, w2, i, parts):
    cols = slice(i * HD // parts, (i + 1) * HD // parts)
    return w1[:, cols], b1[cols], w2[cols]


@pytest.mark.parametrize("parts", [2, 4])
def test_shards_sum_to_the_whole_training_mlp(parts):
    """Sum over the shards of the training MLP on each block with its part,
    fc2's bias left out, plus b2 m2, equals the whole call (1e-5); the
    gradients of that sum through the backward's plain version equal the
    whole call's gradient slices."""
    x, w1, b1, w2, b2, dy = _inputs(parts)
    seed = torch.tensor([20240, -77], dtype=torch.int32)
    n = x.numel() // D
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    whole = k.fused_mlp_train(*leaves, seed, RATE)
    want = torch.autograd.grad(whole, leaves, dy)

    xs = x.clone().requires_grad_(True)
    shards = [[t.clone().requires_grad_(True) for t in _shard(w1, b1, w2, i,
                                                              parts)]
              for i in range(parts)]
    b2s = b2.clone().requires_grad_(True)
    m2 = k.dropout_mask(seed, n, D, k.STREAM_OUT, RATE).reshape(x.shape)
    total = sum(k.fused_mlp_train(xs, *sh[:2], sh[2], torch.zeros(D), seed,
                                  RATE, part=(i, parts))
                for i, sh in enumerate(shards)) + b2s * m2
    np.testing.assert_allclose(total.detach().numpy(),
                               whole.detach().numpy(), atol=1e-5, rtol=0)
    flat = [xs, *(t for sh in shards for t in sh), b2s]
    got = torch.autograd.grad(total, flat, dy)
    dx, dw1, db1, dw2, db2 = want
    np.testing.assert_allclose(got[0].numpy(), dx.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[-1].numpy(), db2.numpy(), atol=1e-5,
                               rtol=0)
    for i in range(parts):
        for name, a, b in zip(("dW1", "db1", "dW2"), got[1 + 3 * i:4 + 3 * i],
                              _shard(dw1, db1, dw2, i, parts)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"{name} shard {i}")


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("stream", [k.STREAM_HIDDEN, k.STREAM_OUT])
def test_part_mask_is_the_whole_masks_column_block(parts, stream):
    seed = torch.tensor([3, 1 << 30], dtype=torch.int32)
    width = HD // parts
    whole = k.dropout_mask(seed, 75, HD, stream, RATE)
    for i in range(parts):
        assert torch.equal(
            k.dropout_mask(seed, 75, width, stream, RATE, part=(i, parts)),
            whole[:, i * width:(i + 1) * width])


def _mask_before_parts(seed, rows, width, stream, rate):
    """``dropout_mask`` as it was before it took a part: element e = row *
    width + col, the groups of four numbered 0 .. rows width / 4 - 1."""
    g = torch.arange(rows * width // 4, dtype=torch.int64)
    key = seed.to(torch.int64) & 0xFFFFFFFF
    words = torch.stack(k.philox4x32_10(g & 0xFFFFFFFF, stream, g >> 32, 0,
                                        key[0], key[1]), dim=-1)
    keep = words.reshape(rows, width) >= k.keep_threshold(rate)
    return keep.to(torch.float32) * k.keep_scale(rate)


@pytest.mark.parametrize("rate", [0.1, 0.6])
def test_part_0_of_1_draws_the_masks_of_old(rate):
    """At part (0, 1), the default, every mask of the training MLP is the
    one it drew before parts existed, bit for bit, and so are the plain
    forward and backward."""
    seed = torch.tensor([987654, -321], dtype=torch.int32)
    for rows, width in ((300, 64), (37, 256), (5, 1536), (129, 768)):
        for stream in (k.STREAM_HIDDEN, k.STREAM_OUT):
            old = _mask_before_parts(seed, rows, width, stream, rate)
            assert torch.equal(k.dropout_mask(seed, rows, width, stream,
                                              rate), old)
            assert torch.equal(k.dropout_mask(seed, rows, width, stream,
                                              rate, part=(0, 1)), old)
    x, w1, b1, w2, b2, dy = _inputs(9)
    args = (x, w1, b1, w2, b2, seed, rate)
    assert torch.equal(k.fused_mlp_train_plain(*args),
                       k.fused_mlp_train_plain(*args, part=(0, 1)))
    for a, b in zip(k.fused_mlp_train_bwd_plain(*args, dy),
                    k.fused_mlp_train_bwd_plain(*args, dy, part=(0, 1))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("part", [(2, 2), (-1, 2), (0, 0)])
def test_a_part_outside_its_range_raises(part):
    seed = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="part"):
        k.dropout_mask(seed, 4, 8, k.STREAM_HIDDEN, RATE, part=part)
    with pytest.raises(ValueError, match="part"):
        k.fused_mlp_train_fwd(*_inputs()[:5], seed, RATE, part)
