"""Gradients and BatchNorm state of the port's train-mode CvT against the
JAX package on the CPU: the same perturbed weights, moving statistics and
numpy batch (64x64 images, embed dims 16/32/64, dropout 0), a masked MSE
over a batch whose last row is a pad (a copy of row 0, mask 0), as the
training loop pads it.

- gradients per leaf within 1e-4 * max|g| (f32 on both sides; the order
  of sums differs).  The images are 64x64 because the JAX package's f32
  reductions on the CPU lose digits with length: at 128x128 its stage-1
  BatchNorm variance carries relative errors near 4e-5 (torch's 2e-6,
  against float64), its outputs drift 5e-5 from a float64 evaluation
  (the port's 5e-6), and one cls-token gradient 1.4e-4 * max|g| from the
  port's;
- the dead K-path leaves gated instead: below 1e-6 * max|g| in both
  packages (PARITY.md, "Dead parameters"; tests/test_multi.py:183-199);
- the new moving statistics within 1e-5; the loss within 1e-4 relative
  (the f32 batch variance E[x^2] - mean^2 of the dw_bn BatchNorms cancels
  digits, and the two packages sum in another order).

``impl="auto"``, with the router's threshold lowered to 0 as it would be
reached at 128x128, sends every stage through the ``attention_small``
autograd Function (its plain versions on the CPU); ``impl="plain"`` keeps
all of it in plain PyTorch.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.train.loop import \
    _masked_mse_mae as jax_masked_mse_mae
from transformer_stm_tpu_torch.config import CvTSpec
from transformer_stm_tpu_torch.kernels import attention_small as port_kernel
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.ops import attention as port_attention
from transformer_stm_tpu_torch.train.checkpoint import (
    _flatten, from_jax_params, to_jax_params)
from transformer_stm_tpu_torch.train.loop import _masked_mse_mae

B = 4
HW = 64


def _narrow(spec_cls, method, cls):
    base = spec_cls(image_height=HW, image_width=HW).with_projection(
        method, cls)
    return dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, embed_dim=d, num_heads=h, dropout_rate=0.0)
        for st, d, h in zip(base.stages, (16, 32, 64), (1, 2, 4))))


def _setup(method, cls, seed):
    rng = np.random.default_rng(seed)
    jspec = _narrow(JaxCvTSpec, method, cls)
    params, state = jax_init_cvt(jax.random.PRNGKey(seed), jspec)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)

    def stat(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    state = jax.tree_util.tree_map_with_path(stat, state)
    images = rng.uniform(0, 1, (B, HW, HW, 1)).astype(np.float32)
    images[-1] = images[0]  # the pad row: a copy of row 0
    proc = rng.standard_normal((B, 5)).astype(np.float32)
    proc[-1] = proc[0]
    labels = rng.standard_normal(B).astype(np.float32)
    mask = np.array([1.0] * (B - 1) + [0.0], np.float32)
    return jspec, params, state, (images, proc, labels, mask)


def _dead(path: str, spec) -> bool:
    """Additive biases on the keys shift every score of a query alike, and
    softmax ignores the shift: their true gradient is 0.  The k_proj
    BatchNorm beta is dead only in a stage without a cls token; with one,
    the cls key bypasses the projection and the shift is not uniform."""
    if path.endswith("mha/key/bias") or path.endswith("attn/proj_k/bias"):
        return True
    if path.endswith("attn/k_proj/bn/beta"):
        return not spec.stages[int(path.split("/")[1])].with_cls_token
    return False


CASES = [("dw_bn", True, "auto"), ("dw_bn", True, "plain"),
         ("avg", False, "auto")]


@pytest.mark.parametrize("method,cls,impl", CASES,
                         ids=[f"{m}_cls{c}_{i}" for m, c, i in CASES])
def test_train_gradients_and_state_match_jax(monkeypatch, method, cls, impl):
    jspec, params, state, batch = _setup(method, cls, seed=len(method))
    images, proc, labels, mask = batch

    def loss_fn(p):
        out, new_state = jax_cvt_forward(p, state, jspec, images, proc,
                                         train=True)
        return jax_masked_mse_mae(out, labels, mask)[0], new_state

    # jit compiles the dw_bn gradient in one go (eager, op by op, it takes
    # three times longer); JAX's avg pooling (reduce_window) does not
    # linearize under jit, and is quick eagerly.
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    if method == "dw_bn":
        grad_fn = jax.jit(grad_fn)
    (want_loss, want_state), want_g = grad_fn(
        jax.tree_util.tree_map(jnp.asarray, params))

    calls = []
    real = port_attention.attention_small

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(port_attention, "attention_small", spy)
    monkeypatch.setattr(port_attention, "SMALL_MIN_ENTRIES", 0)
    spec = _narrow(CvTSpec, method, cls)
    model = from_jax_params(params, jax.tree_util.tree_map(np.asarray, state),
                            spec, device="cpu")
    model.requires_grad_(True)
    bwd_before = port_kernel.attention_small_bwd.launches
    out = cvt_forward(model, *map(torch.from_numpy, (images, proc)),
                      train=True, impl=impl)
    loss = _masked_mse_mae(out, *map(torch.from_numpy, (labels, mask)))[0]
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == (3 if impl == "auto" else 0)  # every stage
    assert port_kernel.attention_small_bwd.launches == bwd_before  # CPU

    np.testing.assert_allclose(loss.item(), float(want_loss), atol=0,
                               rtol=1e-4)
    want = _flatten(jax.tree_util.tree_map(np.asarray, want_g))
    got = {n.replace(".", "/"): g.numpy() for n, g in zip(names, grads)}
    assert got.keys() == want.keys()
    gmax = max(np.abs(a).max() for a in want.values())
    n_dead = 0
    for path, w in want.items():
        if _dead(path, spec):
            n_dead += 1
            assert np.abs(w).max() < 1e-6 * gmax, path
            assert np.abs(got[path]).max() < 1e-6 * gmax, path
            continue
        np.testing.assert_allclose(got[path], w, atol=1e-4 * gmax, rtol=0,
                                   err_msg=path)
    # two key biases per stage, and the k_proj beta of dw_bn stages
    # without a cls token
    assert n_dead == 2 * 3 + sum(method == "dw_bn" and not st.with_cls_token
                                 for st in spec.stages)

    _, new_state = to_jax_params(model)
    want_s = _flatten(jax.tree_util.tree_map(np.asarray, want_state))
    got_s = _flatten(new_state)
    assert got_s.keys() == want_s.keys()
    for path, w in want_s.items():
        np.testing.assert_allclose(got_s[path], w, atol=1e-5, rtol=0,
                                   err_msg=path)
