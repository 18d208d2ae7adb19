"""The port's CvT (transformer_stm_tpu_torch) against the JAX package on
the CPU, with the same weights and inputs.

- blocks and the narrow model (embed dims 16/32/64): atol 1e-4, float32
  on both sides, only the order of sums differs;
- the reference goldens and a trained full-width final: atol 1e-3, the
  JAX package's own bar (tests/test_reference_golden.py).
"""

import dataclasses
import glob
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.models.cvt import cvt_param_count as jax_count
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.ops import attention as jax_attention
from transformer_stm_tpu.ops import blocks as jax_blocks
from transformer_stm_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from transformer_stm_tpu_torch.config import CvTSpec
from transformer_stm_tpu_torch.models.cvt import (
    cvt_forward, cvt_param_count, init_cvt)
from transformer_stm_tpu_torch.ops import attention as port_attention
from transformer_stm_tpu_torch.ops.blocks import (
    MLP, ConvTransformerBlock, mlp)
from transformer_stm_tpu_torch.train.checkpoint import (
    _flatten, _unflatten, from_jax_params, load_checkpoint, load_into,
    to_jax_params)

HERE = os.path.dirname(__file__)
GOLDENS = sorted(glob.glob(os.path.join(HERE, "goldens", "ref_parity_*.npz")))
FINAL = os.path.join(
    HERE, "..", "persist", "Weight", "Images & Parameters",
    "cvt_model_weights_200HZ_Pcv_dw_bn_clsTrue", "ckpt_001000.npz")
METHODS = [("dw_bn", True, False), ("dw_bn", False, False),
           ("avg", True, False), ("avg", False, False),
           ("linear", True, False), ("linear", False, False),
           ("dw_bn", True, True)]  # embed_norm: the norm the reference meant


def _narrow(spec_cls, method, cls, dims=(16, 32, 64), heads=(1, 2, 4),
            embed_norm=False):
    base = spec_cls(embed_norm=embed_norm).with_projection(method, cls)
    return dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, embed_dim=int(dims[i]),
                            num_heads=int(heads[i]))
        for i, st in enumerate(base.stages)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, rng, scale=0.05):
    """Nonzero biases, cls tokens and norms, so every leaf matters."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), tree)


def _random_state(state, rng):
    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, _np_tree(state))


def _inputs(rng, b, spec):
    images = rng.uniform(0, 1, (b, 128, 128, 1)).astype(np.float32)
    proc = rng.standard_normal((b, spec.proc_dim)).astype(np.float32)
    return images, proc


def _port_out(model, images, proc, impl="auto"):
    with torch.no_grad():
        out = cvt_forward(model, torch.from_numpy(images),
                          torch.from_numpy(proc), impl=impl)
    return out.numpy().ravel()


@pytest.mark.parametrize(
    "method,cls,embed_norm", METHODS,
    ids=[f"{m}_cls{c}" + ("_embed_norm" if e else "") for m, c, e in METHODS])
def test_cvt_forward_matches_jax_narrow(method, cls, embed_norm):
    rng = np.random.default_rng(10)
    jspec = _narrow(JaxCvTSpec, method, cls, embed_norm=embed_norm)
    params, state = jax_init_cvt(jax.random.PRNGKey(1), jspec)
    params = _perturbed(_np_tree(params), rng)
    state = _random_state(state, rng)
    images, proc = _inputs(rng, 2, jspec)
    want, _ = jax_cvt_forward(params, state, jspec, images, proc,
                              train=False)
    model = from_jax_params(
        params, state, _narrow(CvTSpec, method, cls, embed_norm=embed_norm),
        device="cpu")
    got = _port_out(model, images, proc)
    np.testing.assert_allclose(got, np.asarray(want).ravel(), atol=1e-4,
                               rtol=0)
    plain = _port_out(model, images, proc, impl="plain")
    np.testing.assert_allclose(plain, got, atol=1e-5, rtol=0)


def _golden_trees(npz):
    """``p['stages'][0]['embed']...`` keys -> JAX-layout numpy trees."""
    flat = {"p": {}, "s": {}}
    for key in npz.files:
        if key[:2] in ("p[", "s["):
            path = "/".join(re.findall(r"\['?([^'\]]+)'?\]", key))
            flat[key[0]][path] = npz[key]
    return _unflatten(flat["p"]), _unflatten(flat["s"])


@pytest.mark.parametrize("path", GOLDENS,
                         ids=[os.path.basename(p) for p in GOLDENS])
def test_forward_matches_reference_golden(path):
    npz = np.load(path)
    name = os.path.basename(path)          # ref_parity_{method}_cls{b}.npz
    method = name[len("ref_parity_"):name.index("_cls")]
    cls = name[name.index("_cls") + 4:-4] == "True"
    spec = _narrow(CvTSpec, method, cls, npz["dims"], npz["heads"])
    params, state = _golden_trees(npz)
    model = from_jax_params(params, state, spec, device="cpu")
    got = _port_out(model, npz["images"], npz["proc"])
    np.testing.assert_allclose(got, npz["ref_out"], atol=1e-3, rtol=0)


def test_trained_final_matches_jax_full_width():
    params, state, step = load_checkpoint(FINAL)
    assert step == 1000
    model = from_jax_params(params, state, CvTSpec(), device="cpu")
    jspec = JaxCvTSpec()
    p0, s0 = jax_init_cvt(jax.random.PRNGKey(0), jspec)
    jparams, jstate, _, _ = jax_load_checkpoint(FINAL, p0, s0)
    images, proc = _inputs(np.random.default_rng(11), 4, jspec)
    want, _ = jax_cvt_forward(jparams, jstate, jspec, images, proc,
                              train=False)
    got = _port_out(model, images, proc)
    np.testing.assert_allclose(got, np.asarray(want).ravel(), atol=1e-3,
                               rtol=0)


def test_checkpoint_round_trip_is_exact():
    params, state, _ = load_checkpoint(FINAL)
    model = from_jax_params(params, state, CvTSpec(), device="cpu")
    p2, s2 = to_jax_params(model)
    for a, b in ((params, p2), (state, s2)):
        fa, fb = _flatten(a), _flatten(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    with np.load(FINAL) as z:
        n_leaves = sum(1 for k in z.files if k[:2] in ("p/", "s/"))
    assert n_leaves == len(_flatten(params)) + len(_flatten(state))


def test_from_jax_params_rejects_missing_and_misshaped_leaves():
    params, state, _ = load_checkpoint(FINAL)
    del params["final"]["bias"]
    with pytest.raises(KeyError, match="final.bias"):
        from_jax_params(params, state, CvTSpec(), device="cpu")
    params, state, _ = load_checkpoint(FINAL)
    params["final"]["bias"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="final.bias"):
        from_jax_params(params, state, CvTSpec(), device="cpu")


def test_param_count_and_init():
    model = init_cvt(CvTSpec(), torch.Generator().manual_seed(3), "cpu")
    p0, _ = jax_init_cvt(jax.random.PRNGKey(0), JaxCvTSpec())
    assert cvt_param_count(model) == jax_count(p0)
    again = init_cvt(CvTSpec(), torch.Generator().manual_seed(3), "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    blk = model.stages[2].blocks[0]
    assert torch.count_nonzero(blk.cls_token) == 0


BLOCKS = [("dw_bn", True), ("avg", False), ("linear", True)]


@pytest.mark.parametrize("method,cls", BLOCKS,
                         ids=[f"{m}_cls{c}" for m, c in BLOCKS])
def test_conv_transformer_block_matches_jax(method, cls):
    rng = np.random.default_rng(12)
    dim, heads = 32, 2
    params, state = jax_blocks.init_conv_transformer_block(
        jax.random.PRNGKey(2), dim, heads, 3, method, 4, with_cls_token=cls)
    params = _perturbed(_np_tree(params), rng)
    state = _random_state(state, rng)
    x = rng.standard_normal((2, 6, 6, dim)).astype(np.float32)
    want_x, want_cls, _ = jax_blocks.conv_transformer_block(
        params, state, jnp.asarray(x), num_heads=heads, kernel_size=3,
        qkv_method=method, with_cls_token=cls, train=False)
    block = load_into(ConvTransformerBlock(dim, heads, 3, 1, method, 4, cls),
                      params, state)
    with torch.no_grad():
        got_x, got_cls = block(torch.from_numpy(x))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-4,
                               rtol=0)
    if cls:
        np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                                   atol=1e-4, rtol=0)
    else:
        assert got_cls is None and want_cls is None


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_mlp_matches_jax(impl):
    rng = np.random.default_rng(13)
    params = _perturbed(_np_tree(jax_blocks.init_mlp(
        jax.random.PRNGKey(3), 64, 256)), rng)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    want = jax_blocks.mlp(params, jnp.asarray(x), train=False, impl="xla")
    m = load_into(MLP(64, 256), params, {})
    with torch.no_grad():
        got = mlp(m, torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("t,s,to_kernel", [(600, 600, True),
                                           (256, 256, False),
                                           (65, 65, False)])
def test_attention_router(monkeypatch, t, s, to_kernel):
    """Above 300,000 score entries per head the router takes the
    attention_small wrapper (its plain version on the CPU); below, plain
    PyTorch.  Both agree with the JAX einsum path."""
    rng = np.random.default_rng(t)
    q = rng.standard_normal((1, t, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
            for _ in range(2))
    calls = []
    real = port_attention.attention_small

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(port_attention, "attention_small", spy)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port_attention._attention_core(tq, tk, tv)
    assert bool(calls) == to_kernel
    plain = port_attention._attention_core(tq, tk, tv, impl="plain")
    assert len(calls) == int(to_kernel)
    want = jax_attention._attention_core(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), impl="xla")
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    with pytest.raises(ValueError, match="impl"):
        port_attention._attention_core(tq, tk, tv, impl="xla")
