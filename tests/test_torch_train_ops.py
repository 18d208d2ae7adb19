"""The port's training ops against the JAX package on the CPU, on the same
numpy inputs.

- attention_small backward (plain version, and autograd through the
  wrapper's ``AttentionSmall``) against ``jax.vjp`` of the Pallas kernel in
  interpret mode: atol 1e-4, f32 on both sides, only the order of sums
  differs;
- train-mode BatchNorm output and moving statistics: atol 1e-5 (f32 means
  over at most 400 rows);
- Adam and AdamW over 5 steps: atol 1e-6 (the same f32 operations; the
  bias correction's f32 power may differ in the last bit);
- dropout: exact identity where it must be, 1/keep scaling, and a keep
  share inside 5-sigma binomial bounds;
- the repairs: ``fused_mlp`` refuses to run while autograd records, and a
  train-mode forward never reaches it.
"""

import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import importlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu.ops import blocks as jax_blocks  # noqa: E402
from transformer_stm_tpu.ops import common as jax_common  # noqa: E402
from transformer_stm_tpu.train import optimizer as jax_opt  # noqa: E402
from transformer_stm_tpu_torch.config import (  # noqa: E402
    CvTSpec, StageSpec, TrainConfig)
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    AttentionSmall, attention_small, attention_small_bwd,
    attention_small_bwd_plain, attention_small_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import fused_mlp  # noqa: E402
from transformer_stm_tpu_torch.models.cvt import (  # noqa: E402
    cvt_forward, init_cvt)
from transformer_stm_tpu_torch.ops import blocks  # noqa: E402
from transformer_stm_tpu_torch.ops.blocks import MLP, mlp  # noqa: E402
from transformer_stm_tpu_torch.ops.common import (  # noqa: E402
    BatchNorm, batch_norm_train, dropout)
from transformer_stm_tpu_torch.train.checkpoint import load_into  # noqa: E402
from transformer_stm_tpu_torch.train.optimizer import (  # noqa: E402
    adam_init, adam_update, lr_at_epoch)

jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels read the flag when they run; another test module of
    the same worker may have imported them before the variable was set."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# attention_small backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 65, 4, 64), (2, 256, 2, 64)],
                         ids=["S65_H4", "S256_H2"])
def test_attention_small_backward_matches_jax_vjp(shape):
    q, k, v, g = _arrays(shape, 4, seed=shape[1] + 1)
    o_j, vjp = jax.vjp(jax_fa.attention_small, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    _, aux = jax_fa._small_fwd_impl(*map(jnp.asarray, (q, k, v)),
                                    with_lse=True)
    b, t, h, _ = shape
    want_lse = np.asarray(aux)[:, :t, 0].reshape(b, h, t)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = attention_small_plain(tq, tk, tv, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4, rtol=0)
    plain = attention_small_bwd_plain(tq, tk, tv, o, lse, tg)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = attention_small(*leaves)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "AttentionSmallBackward"
    out.backward(tg)
    for name, w, p, a in zip("qkv", want, plain, leaves):
        np.testing.assert_allclose(p.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=f"plain d{name}")
        np.testing.assert_allclose(a.grad.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=f"autograd d{name}")


def test_attention_small_backward_plain_matches_float64_autograd():
    """The plain backward is the exact gradient: against autograd of the
    plain forward in float64, atol 1e-5 (f32 rounding only)."""
    q, k, v, g = _arrays((1, 33, 2, 64), 4, seed=3)
    leaves = [torch.from_numpy(x).double().requires_grad_(True)
              for x in (q, k, v)]
    attention_small_plain(*leaves).backward(torch.from_numpy(g).double())
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = attention_small_plain(tq, tk, tv, with_lse=True)
    for got, leaf in zip(attention_small_bwd_plain(tq, tk, tv, o, lse, tg),
                         leaves):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=1e-5,
                                   rtol=0)


def test_attention_small_records_only_when_autograd_asks():
    """No graph under no_grad or without inputs that require grad; on the
    CPU no launch is counted forward or backward."""
    q, k, v = map(torch.from_numpy, _arrays((1, 20, 1, 64), 3, seed=4))
    before = (attention_small.launches, attention_small_bwd.launches)
    assert attention_small(q, k, v).grad_fn is None
    leaf = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert attention_small(leaf, k, v).grad_fn is None
    with torch.inference_mode():
        assert attention_small(leaf, k, v).grad_fn is None
    out = attention_small(leaf, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert leaf.grad is not None and torch.count_nonzero(leaf.grad) > 0
    assert (attention_small.launches, attention_small_bwd.launches) == before
    assert issubclass(AttentionSmall, torch.autograd.Function)


def test_attention_small_backward_raises_off_the_cpu():
    """A tensor on no CUDA device is refused, not sent to the plain
    version."""
    q = torch.empty(1, 8, 1, 64, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_small_bwd(q, q, q, q, lse, q)


# ---------------------------------------------------------------------------
# The two repairs: no kernel result cut off from autograd
# ---------------------------------------------------------------------------

def test_fused_mlp_refuses_to_run_while_autograd_records():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    m = MLP(64, 256, torch.Generator().manual_seed(0))
    args = [m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias]
    m.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp(x, *args)
    with pytest.raises(RuntimeError, match="no backward"):
        mlp(m, x, impl="auto")
    with torch.no_grad():
        assert fused_mlp(x, *args).shape == x.shape
    with torch.inference_mode():
        assert mlp(m, x).shape == x.shape


SMALL = CvTSpec(stages=(
    StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1),
    StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2),
    StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
              with_cls_token=True),
), image_height=32, image_width=32)


def test_train_forward_never_reaches_the_fused_mlp(monkeypatch):
    """With the inference kernel made to raise, a train-mode forward runs
    and every MLP weight gets a gradient; an eval forward reaches it."""
    def boom(*args):
        raise AssertionError("fused_mlp reached in training")

    monkeypatch.setattr(blocks, "fused_mlp", boom)
    model = init_cvt(SMALL, torch.Generator().manual_seed(1), device="cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, (4, 32, 32, 1)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    out = cvt_forward(model, x, p, train=True, generator=gen)
    out.square().sum().backward()
    for stage in model.stages:
        for blk in stage.blocks:
            assert torch.count_nonzero(blk.mlp.fc1.kernel.grad) > 0
            assert torch.count_nonzero(blk.mlp.fc2.kernel.grad) > 0
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        cvt_forward(model, x, p)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_train_mode_is_the_plain_mlp_with_dropout(rate):
    """At rate 0 equal to JAX's train-mode MLP (atol 1e-4); at 0.1 it
    drops units, so differs from the plain MLP, and needs a generator."""
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32),
        jax_blocks.init_mlp(jax.random.PRNGKey(3), 64, 256))
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    m = load_into(MLP(64, 256), params, {})
    gen = torch.Generator().manual_seed(3)
    got = mlp(m, torch.from_numpy(x), dropout_rate=rate, train=True,
              generator=gen, impl="auto")
    if rate == 0.0:
        want = jax_blocks.mlp(params, jnp.asarray(x), dropout_rate=0.0,
                              train=True, impl="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    else:
        plain = mlp(m, torch.from_numpy(x), impl="plain")
        assert not torch.allclose(got, plain)
        with pytest.raises(ValueError, match="requires a generator"):
            mlp(m, torch.from_numpy(x), dropout_rate=rate, train=True)


# ---------------------------------------------------------------------------
# BatchNorm in training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 5, 5, 16), (2, 10, 20, 8)])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma, beta = (rng.standard_normal(c).astype(np.float32)
                   for _ in range(2))
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    want, new = jax_common.batch_norm(
        {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var},
        jnp.asarray(x), train=True)
    bn = BatchNorm(c)
    load_into(bn, {"gamma": gamma, "beta": beta}, {"mean": mean, "var": var})
    got = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new["mean"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(new["var"]),
                               atol=1e-5, rtol=0)
    # evaluation reads the moving statistics and leaves them alone
    before = bn.mean.clone(), bn.var.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.mean, before[0]) and torch.equal(bn.var, before[1])


def test_batch_norm_train_gradient_flows_through_the_batch_statistics():
    """The gradient of the normalised output with respect to x includes
    the batch mean and variance: against float64 autograd, atol 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 3, 4)).astype(np.float32)
    w = rng.standard_normal((6, 3, 4)).astype(np.float32)

    def grad(dtype):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        ones, zeros = torch.ones(4, dtype=dtype), torch.zeros(4, dtype=dtype)
        y = batch_norm_train(xt, ones, zeros, zeros.clone(), ones.clone())
        (y * torch.from_numpy(w).to(dtype)).sum().backward()
        return xt.grad

    np.testing.assert_allclose(grad(torch.float32).numpy(),
                               grad(torch.float64).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def test_dropout_identity_at_rate_zero_and_in_evaluation():
    x = torch.randn(50, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    assert dropout(x, 0.0, True, gen) is x
    assert dropout(x, 0.5, False, gen) is x
    assert dropout(x, 0.5, False) is x  # no generator needed there


def test_dropout_scales_kept_units_and_keeps_the_right_share():
    rate, n = 0.1, 200_000
    x = torch.full((n,), 2.0)
    y = dropout(x, rate, True, torch.Generator().manual_seed(4))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.9),
                               atol=0, rtol=0)
    share, sigma = kept.float().mean().item(), (rate * (1 - rate) / n) ** .5
    assert abs(share - (1 - rate)) < 5 * sigma, share
    again = dropout(x, rate, True, torch.Generator().manual_seed(4))
    assert torch.equal(y, again)  # one seed, one mask


def test_dropout_without_a_generator_raises():
    with pytest.raises(ValueError, match="requires a generator"):
        dropout(torch.ones(3), 0.1, True)


# ---------------------------------------------------------------------------
# Optimizer and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "adamw"])
def test_adam_matches_jax_over_five_steps(weight_decay):
    rng = np.random.default_rng(10)
    model = torch.nn.Module()
    model.kernel = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((6, 4)).astype(np.float32)))
    model.bias = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(4).astype(np.float32)))
    jparams = {"kernel": model.kernel.detach().numpy().copy(),
               "bias": model.bias.detach().numpy().copy()}
    jstate = jax_opt.adam_init(jparams)
    opt = adam_init(model)
    for step in range(5):
        grads = {k: (rng.standard_normal(v.shape) * 10 ** -step)
                 .astype(np.float32) for k, v in jparams.items()}
        lr = 1e-3 * (step + 1)
        jparams, jstate = jax_opt.adam_update(
            grads, jstate, jparams, jnp.float32(lr),
            weight_decay=weight_decay)
        params = list(model.parameters())
        adam_update([torch.from_numpy(grads[n]) for n, _ in
                     model.named_parameters()], opt, params, lr,
                    weight_decay=weight_decay)
    assert opt.step == int(jstate.step) == 5
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), atol=1e-6,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(opt.mu[name].numpy(),
                                   np.asarray(jstate.mu[name]), atol=1e-6)
        np.testing.assert_allclose(opt.nu[name].numpy(),
                                   np.asarray(jstate.nu[name]), atol=1e-6)


def test_lr_schedule_matches_jax():
    for epoch in range(251):
        for base, decay, every in ((1e-3, 0.8, 50), (3e-3, 0.5, 2)):
            assert lr_at_epoch(base, epoch, decay, every) == \
                jax_opt.lr_at_epoch(base, epoch, decay, every)


def test_bfloat16_compute_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TrainConfig(compute_dtype="bfloat16")
    assert TrainConfig().epochs == 1000 and TrainConfig().lr_decay == 0.8


def test_attention_small_runs_under_torch_func_vmap_and_grad():
    """torch.func.vmap over 3 slots, of the forward and of torch.func.grad
    of a scalar loss, equals a Python loop over the slots (exactly: the
    vmap rules fold the slot axis into the batch axis); an unmapped input
    is broadcast."""
    from torch.func import grad, vmap

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(3, 2, 17, 2, 64, generator=gen) for _ in range(3))
    c = torch.randn(2, 17, 2, 64, generator=gen)
    out = vmap(attention_small)(q, k, v)
    assert torch.equal(out, torch.stack([attention_small(q[i], k[i], v[i])
                                         for i in range(3)]))

    def loss(a, b, d):
        return (attention_small(a, b, d) * c).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    want = [grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
            for i in range(3)]
    for j in range(3):
        assert torch.equal(got[j], torch.stack([w[j] for w in want]))
    one = vmap(attention_small, in_dims=(0, None, None))(q, k[0], v[0])
    assert torch.equal(one[2], attention_small(q[2], k[0], v[0]))
