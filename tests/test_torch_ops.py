"""The port's ops (transformer_stm_tpu_torch/ops/common.py) against the JAX
ops on the same inputs, made with numpy from a seed.  Tolerance: atol 1e-5
(both sides compute in float32 on the CPU; only the order of sums differs).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from transformer_stm_tpu.ops import common as jc
from transformer_stm_tpu_torch.ops import common as tc

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("in_size,kernel,stride,expect", [
    (128, 7, 4, (1, 2)),   # stage-1 patch embed: TF pads (1, 2)
    (32, 3, 2, (0, 1)),    # stage-2 patch embed
    (16, 3, 2, (0, 1)),    # stage-3 patch embed
    (8, 3, 1, (1, 1)),     # conv projection
    (65, 3, 2, (1, 1)),
    (7, 3, 2, (1, 1)),
])
def test_same_padding(in_size, kernel, stride, expect):
    got = tc.same_padding(in_size, kernel, stride)
    assert got == jc.same_padding(in_size, kernel, stride) == expect


@pytest.mark.parametrize("hw,cin,cout,k,stride", [
    (128, 1, 8, 7, 4),
    (32, 8, 16, 3, 2),
    (9, 4, 4, 3, 1),
])
def test_conv2d(hw, cin, cout, k, stride):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal(cout).astype(np.float32)
    want = jc.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    got = tc.conv2d(_t(x), _t(w), _t(b), stride=stride)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("hw,stride", [(8, 1), (9, 2), (16, 2)])
def test_depthwise_conv2d(hw, stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, hw, hw, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 1)).astype(np.float32)
    want = jc.depthwise_conv2d({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                               stride=stride)
    got = tc.depthwise_conv2d(_t(x), _t(w), stride=stride)
    assert got.shape == want.shape
    _close(got, want)


def test_dense():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jc.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x))
    _close(tc.dense(_t(x), _t(w), _t(b)), want)


@pytest.mark.parametrize("eps", [1e-6, 1e-3])
def test_layer_norm(eps):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jc.layer_norm({"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                         jnp.asarray(x), eps=eps)
    _close(tc.layer_norm(_t(x), _t(g), _t(b), eps=eps), want)


def test_batch_norm_inference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    g, b, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.2, 2.0, 8).astype(np.float32)
    want, _ = jc.batch_norm({"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                            {"mean": jnp.asarray(m), "var": jnp.asarray(v)},
                            jnp.asarray(x), train=False)
    _close(tc.batch_norm(_t(x), _t(g), _t(b), _t(m), _t(v)), want)


@pytest.mark.parametrize("hw,pool,stride", [(8, 3, 1), (9, 3, 2), (16, 3, 2),
                                            (7, 2, 2)])
def test_avg_pool_same(hw, pool, stride):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    want = jc.avg_pool_same(jnp.asarray(x), pool, stride)
    got = tc.avg_pool_same(_t(x), pool, stride)
    assert got.shape == want.shape
    _close(got, want)


def test_gelu_exact():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    _close(tc.gelu(_t(x)), jc.gelu(jnp.asarray(x)))


def test_glorot_uniform_limits_and_seed():
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    a = tc.glorot_uniform((64, 256), 64, 256, g1)
    b = tc.glorot_uniform((64, 256), 64, 256, g2)
    assert torch.equal(a, b)
    assert a.abs().max() <= np.sqrt(6.0 / (64 + 256))


def test_use_true_f32_turns_tf32_off():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        tc.use_true_f32()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = before
