"""The port's fused training MLP on the CPU.

``fused_mlp_train_plain`` and its backward are held against the JAX
``make_fused_mlp_train(0.0)`` run under the Pallas interpreter, on the same
numpy inputs: values and all five gradients at atol 5e-5, the JAX test's
bound (tests/test_kernels.py:161-190).  With dropout the two packages draw
different bits (the TPU kernel used the TPU's own generator), so the port is
checked on its own terms: the mask function is Philox-4x32-10 (Random123's
known answers), keeps the right share under an unsigned compare, depends on
the global element index only, and autograd through the plain forward equals
the backward that rebuilds the masks (atol 1e-5).  The CUDA kernels run only
on the card, where ``chip_smoke.py`` holds them against these plain
versions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu.kernels.fused_mlp import make_fused_mlp_train
from transformer_stm_tpu_torch.kernels import _build
from transformer_stm_tpu_torch.kernels import fused_mlp as k
from transformer_stm_tpu_torch.ops import blocks

ATOL = 5e-5


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((2, n, d)).astype(np.float32),
            (0.1 * rng.standard_normal((d, hd))).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (0.1 * rng.standard_normal((hd, d))).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((2, n, d)).astype(np.float32)]


@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_jax_kernel_at_rate_zero(d):
    *args, g = _inputs(40, d, seed=d)
    seed = np.zeros(2, np.int32)
    f = make_fused_mlp_train(0.0, interpret=True)
    y_j, vjp = jax.vjp(lambda *a: f(*a, jnp.asarray(seed)),
                       *map(jnp.asarray, args))
    grads_j = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in args]
    y = k.fused_mlp_train_plain(*t, torch.from_numpy(seed), 0.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    grads = k.fused_mlp_train_bwd_plain(*t, torch.from_numpy(seed), 0.0,
                                        torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_function_gradients_match_jax_at_rate_zero():
    """FusedMLPTrain through torch.autograd on CPU tensors (its plain
    forward and backward) against jax.vjp of the JAX kernel."""
    *args, g = _inputs(24, 64, seed=3)
    f = make_fused_mlp_train(0.0, interpret=True)
    _, vjp = jax.vjp(lambda *a: f(*a, jnp.zeros(2, jnp.int32)),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = k.fused_mlp_train(*t, torch.zeros(2, dtype=torch.int32), 0.0)
    got = torch.autograd.grad(y, t, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32_10."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = k.philox4x32_10(t([0, 0xFFFFFFFF]), t([0, 0xFFFFFFFF]),
                          t([0, 0xFFFFFFFF]), t([0, 0xFFFFFFFF]),
                          t([0, 0xFFFFFFFF]), t([0, 0xFFFFFFFF]))
    words = [[int(w[i]) for w in got] for i in range(2)]
    assert words == [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
                     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]]


@pytest.mark.parametrize("rate", [0.1, 0.6])
def test_mask_keeps_the_right_share_unsigned(rate):
    """Rate 0.6 puts the threshold above 2^31: a signed compare would keep
    the wrong share (the bug recorded at fused_mlp.py:155-164)."""
    seed = torch.tensor([12345, -678], dtype=torch.int32)
    for stream, width in ((k.STREAM_HIDDEN, 256), (k.STREAM_OUT, 64)):
        m = k.dropout_mask(seed, 4096, width, stream, rate)
        share = (m > 0).double().mean().item()
        assert abs(share - (1 - rate)) < 3e-3
        assert set(torch.unique(m).tolist()) == {0.0, k.keep_scale(rate)}
    assert k.keep_threshold(0.5) == 2 ** 31
    assert k.keep_threshold(1.0) == 2 ** 32 - 1


def test_mask_depends_on_the_global_element_index_only():
    """A mask of fewer rows is the first rows of a larger one (the counter
    is the element index, not a per-block one); the streams and the seeds
    give different masks."""
    seed = torch.tensor([7, 9], dtype=torch.int32)
    big = k.dropout_mask(seed, 300, 64, k.STREAM_HIDDEN, 0.1)
    assert torch.equal(k.dropout_mask(seed, 37, 64, k.STREAM_HIDDEN, 0.1),
                       big[:37])
    assert not torch.equal(k.dropout_mask(seed, 300, 64, k.STREAM_OUT, 0.1),
                           big)
    other = torch.tensor([8, 9], dtype=torch.int32)
    assert not torch.equal(k.dropout_mask(other, 300, 64, k.STREAM_HIDDEN,
                                          0.1), big)
    assert torch.equal(k.dropout_mask(seed, 5, 8, 1, 0.0), torch.ones(5, 8))


def test_backward_rebuilds_the_forward_masks():
    """rate 0.3: autograd through the plain forward (its masks are
    constants) equals the plain backward, which rebuilds the masks from the
    seed."""
    *args, g = _inputs(33, 32, seed=5)
    seed = torch.tensor([2024, 11], dtype=torch.int32)
    t = [torch.from_numpy(a).double().requires_grad_(True) for a in args]
    y = k.fused_mlp_train_plain(*t, seed, 0.3)
    want = torch.autograd.grad(y, t, torch.from_numpy(g).double())
    got = k.fused_mlp_train_bwd_plain(*[a.detach() for a in t], seed, 0.3,
                                      torch.from_numpy(g).double())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    # dropout is applied: some outputs are exactly zero, the rest scaled
    assert (y == 0).any() and (y != 0).float().mean() > 0.5


def test_function_takes_a_non_contiguous_output_gradient():
    *args, _ = _inputs(8, 32, seed=6)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = k.fused_mlp_train(*t, seed, 0.2)
    g = torch.randn(32, 8, 2).permute(2, 1, 0)  # (2, 8, 32), not contiguous
    got = torch.autograd.grad(y, t, g)
    want = k.fused_mlp_train_bwd_plain(*[a.detach() for a in t], seed, 0.2,
                                       g.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_on_cpu_launch_nothing_and_off_the_cpu_raise():
    *args, g = map(torch.from_numpy, _inputs(4, 32, seed=7))
    seed = torch.zeros(2, dtype=torch.int32)
    before = (k.fused_mlp_train.launches, k.fused_mlp_train_bwd.launches)
    k.fused_mlp_train_fwd(*args, seed, 0.1)
    k.fused_mlp_train_bwd(*args, seed, 0.1, g)
    assert (k.fused_mlp_train.launches,
            k.fused_mlp_train_bwd.launches) == before
    x = torch.empty(8, 64, device="meta")
    w1, w2 = torch.empty(64, 256), torch.empty(256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        k.fused_mlp_train_fwd(x, w1, torch.empty(256), w2, torch.empty(64),
                              seed, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        k.fused_mlp_train_bwd(x, w1, torch.empty(256), w2, torch.empty(64),
                              seed, 0.1, x)
    assert _build._lib is None


def test_mlp_routes_training_to_the_kernel_only_when_asked(monkeypatch):
    """mlp(train=True) takes the fused training MLP with mlp_impl="pallas"
    or "flash" (its seed drawn from the generator, zeros at rate 0), as
    JAX's mlp does (ops/blocks.py:58-66), and the plain MLP otherwise; at
    rate 0 both agree.  An unknown mlp_impl raises."""
    gen = torch.Generator().manual_seed(0)
    m = blocks.MLP(32, 128, gen)
    x = torch.randn(2, 5, 32, generator=gen)
    seeds = []
    real = k.fused_mlp_train

    def spy(*a):
        seeds.append(a[5].clone())
        return real(*a)

    monkeypatch.setattr(blocks, "fused_mlp_train", spy)
    plain = blocks.mlp(m, x, dropout_rate=0.0, train=True)
    fused = blocks.mlp(m, x, dropout_rate=0.0, train=True, mlp_impl="pallas")
    assert len(seeds) == 1 and torch.equal(seeds[0], torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(fused, plain, atol=1e-6, rtol=0)
    blocks.mlp(m, x, dropout_rate=0.1, train=True, generator=gen,
               mlp_impl="xla")
    assert len(seeds) == 1
    blocks.mlp(m, x, dropout_rate=0.1, train=True, generator=gen,
               mlp_impl="pallas")
    assert len(seeds) == 2 and seeds[1].dtype == torch.int32
    assert (seeds[1] >= 0).all()
    blocks.mlp(m, x, dropout_rate=0.1, train=True, generator=gen,
               mlp_impl="flash")
    assert len(seeds) == 3 and seeds[2].dtype == torch.int32
    with pytest.raises(ValueError, match="mlp_impl"):
        blocks.mlp(m, x, train=True, generator=gen, mlp_impl="small")
