"""The port's ViT inference path on the CPU, against the JAX package.

- ``vit_forward`` of a ViT at ViT-S and ViT-Ti widths, depth 2, 64px (17
  tokens, padded to 24 on the fused routes), batch 3, from JAX weights
  carried across, over every route, against JAX ``impl="xla"``: float32
  within 1e-4, bfloat16 within 5e-2 (JAX's own bars,
  tests/test_fused_layer.py:26-27); ``"fused2_int8"`` within 1e-2 of the
  logit scale of JAX's ``"fused2_int8"`` and within JAX's int8 contract
  against float (3% of the scale, correlation above 0.999);
- ``train=True`` raises on the fused routes and runs dropout on the
  composable route;
- ``impl="auto"`` in bfloat16 on the card consults ``fused_layer_fits`` and
  falls back to ``"small"`` (a mirror of
  tests/test_fused_layer.py:157-180), and takes the fused layers where they
  fit;
- weights carried JAX -> port -> JAX are equal; ``patchify`` and the
  presets equal JAX's;
- the bfloat16 ops (``dense``, ``layer_norm``, ``gelu``, plain attention,
  ``mha``) against JAX's in bfloat16;
- ``preprocess_images_device`` against JAX's (345x340 -> 224 within 1e-5);
- ``classify_image`` on a 3-channel JPEG written with cv2: probabilities
  within 1e-5 of JAX's.
"""

import dataclasses
import importlib
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"  # before the kernels import

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu.config import VIT_PRESETS as JAX_PRESETS  # noqa: E402
from transformer_stm_tpu.data.images import \
    preprocess_images_device as jax_preprocess  # noqa: E402
from transformer_stm_tpu.models.vit import \
    classify_image as jax_classify  # noqa: E402
from transformer_stm_tpu.models.vit import init_vit as jax_init  # noqa: E402
from transformer_stm_tpu.models.vit import patchify as jax_patchify  # noqa: E402,E501
from transformer_stm_tpu.models.vit import \
    vit_forward as jax_forward  # noqa: E402
from transformer_stm_tpu.ops import attention as jax_attention  # noqa: E402
from transformer_stm_tpu.ops import common as jax_common  # noqa: E402
from transformer_stm_tpu_torch.config import VIT_PRESETS  # noqa: E402
from transformer_stm_tpu_torch.data.images import \
    preprocess_images_device  # noqa: E402
from transformer_stm_tpu_torch.kernels import fused_layer  # noqa: E402
from transformer_stm_tpu_torch.models import vit as vit_mod  # noqa: E402
from transformer_stm_tpu_torch.models.vit import (  # noqa: E402
    classify_image, patchify, vit_forward)
from transformer_stm_tpu_torch.ops import common  # noqa: E402
from transformer_stm_tpu_torch.ops.attention import (  # noqa: E402
    _attention_plain, mha)
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    _flatten, vit_from_jax_params, vit_to_jax_params)

jax_fl = importlib.import_module("transformer_stm_tpu.kernels.fused_layer")

F32_ATOL, BF16_ATOL = 1e-4, 5e-2
INT8_TOL = 1e-2                    # of the logit scale, vs JAX int8
INT8_REL, INT8_CORR = 0.03, 0.999  # vs float (JAX's contract)
WIDTHS = ["ViT-S/16", "ViT-Ti/16"]
IMPLS = ["auto", "plain", "small", "flash", "fused", "fused2"]
DTYPES = {"f32": (torch.float32, jnp.float32, F32_ATOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_ATOL)}
BATCH = 3

_CACHE = {}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels read the flag when they run; another test module of
    the same worker may have imported them before the variable was set."""
    monkeypatch.setattr(jax_fl, "_INTERPRET", True)


def specs(name, depth=2, image_size=64):
    return (dataclasses.replace(JAX_PRESETS[name], depth=depth,
                                image_size=image_size),
            dataclasses.replace(VIT_PRESETS[name], depth=depth,
                                image_size=image_size))


def setup(name, dtype):
    """(port model, JAX params, port spec, JAX spec, images) in ``dtype``,
    the JAX weights (seed 0) carried into the port; cached per width."""
    if name not in _CACHE:
        jspec, spec = specs(name)
        params = jax_init(jax.random.PRNGKey(0), jspec)
        np_params = jax.tree_util.tree_map(np.asarray, params)
        img = np.random.default_rng(1).uniform(
            0.0, 1.0, (BATCH, 64, 64, 3)).astype(np.float32)
        _CACHE[name] = (np_params, jspec, spec, img)
    np_params, jspec, spec, img = _CACHE[name]
    tdt, jdt, _ = DTYPES[dtype]
    model = vit_from_jax_params(np_params, spec, device="cpu").to(tdt)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt),
                                np_params)
    return model, jp, spec, jspec, img


def jax_logits(name, dtype, impl="xla"):
    key = (name, dtype, impl)
    if key not in _CACHE:
        _, jp, _, jspec, img = setup(name, dtype)
        jdt = DTYPES[dtype][1]
        out = jax_forward(jp, jspec, jnp.asarray(img).astype(jdt),
                          train=False, impl=impl, mlp_impl="xla"
                          if impl == "xla" else None)
        _CACHE[key] = np.asarray(out.astype(jnp.float32))
    return _CACHE[key]


def port_logits(name, dtype, impl):
    model, _, _, _, img = setup(name, dtype)
    with torch.inference_mode():
        out = vit_forward(model, torch.from_numpy(img).to(
            DTYPES[dtype][0]), impl=impl)
    assert out.dtype == DTYPES[dtype][0]
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", WIDTHS)
def test_vit_forward_matches_jax_xla(name, impl, dtype):
    got = port_logits(name, dtype, impl)
    want = jax_logits(name, dtype)
    print(f"{name} {impl} {dtype}: max |port - JAX| "
          f"{np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=DTYPES[dtype][2], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", WIDTHS)
def test_vit_forward_int8(name, dtype):
    got = port_logits(name, dtype, "fused2_int8")
    want = jax_logits(name, dtype, "fused2_int8")
    scale = np.abs(want).max()
    print(f"{name} int8 {dtype}: max |port - JAX int8| "
          f"{np.abs(got - want).max():.3e} of scale {scale:.3f}")
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= INT8_TOL * scale
    ref = jax_logits(name, "f32")
    assert np.abs(got - ref).max() / np.abs(ref).max() < INT8_REL
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > INT8_CORR


@pytest.mark.parametrize("impl", ["fused", "fused2", "fused2_int8"])
def test_fused_routes_reject_train(impl):
    model, _, _, _, img = setup("ViT-S/16", "f32")
    with pytest.raises(ValueError, match="inference-only"):
        vit_forward(model, torch.from_numpy(img), train=True, impl=impl,
                    generator=torch.Generator().manual_seed(0))


def test_train_runs_dropout_on_the_composable_route():
    _, spec = specs("ViT-Ti/16", depth=1)
    spec = dataclasses.replace(spec, dropout_rate=0.1)
    model = vit_mod.init_vit(spec, torch.Generator().manual_seed(0),
                             device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        vit_forward(model, x, train=True)
    a, b = (vit_forward(model, x, train=True,
                        generator=torch.Generator().manual_seed(s))
            for s in (2, 3))
    ev = vit_forward(model, x)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    assert not torch.equal(a, ev)
    assert torch.equal(ev, vit_forward(model, x, train=False))


def _auto_on_the_card(monkeypatch, fits):
    """vit_forward(impl="auto") on bf16 images that claim to lie on a CUDA
    device, with fused_layer_fits answering ``fits``; returns the fits
    calls and the routes taken (the fused forward is replaced by a
    recorder, the composable route runs on the CPU)."""
    calls, routes = [], []
    monkeypatch.setattr(fused_layer, "fused_layer_fits",
                        lambda *a, **k: (calls.append((a, k)), fits)[1])
    monkeypatch.setattr(vit_mod, "_vit_forward_fused",
                        lambda model, images, merged=False, int8=False:
                        (routes.append(("fused", merged, int8)),
                         torch.zeros(images.shape[0], 1000))[1])
    real_mha = vit_mod.mha
    monkeypatch.setattr(vit_mod, "mha", lambda *a, impl, **k:
                        (routes.append(impl), real_mha(*a, impl=impl,
                                                       **k))[1])
    model, _, _, _, img = setup("ViT-S/16", "bf16")
    x = torch.from_numpy(img).to(torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with torch.inference_mode():
        out = vit_forward(model, x)
    return out, calls, routes


def test_auto_bf16_falls_back_when_the_kernels_do_not_fit(monkeypatch):
    out, calls, routes = _auto_on_the_card(monkeypatch, fits=False)
    assert out.shape[0] == BATCH
    assert calls, "fused_layer_fits was not consulted"
    (t_pad, e, heads, dh, hidden, itemsize), kw = calls[0]
    assert (t_pad, e, heads, dh, hidden, itemsize) == (24, 384, 6, 64, 1536,
                                                       2)
    assert kw == {}
    assert routes == ["small", "small"]  # both layers, no fused forward


def test_auto_bf16_takes_fused2_where_it_fits(monkeypatch):
    _, calls, routes = _auto_on_the_card(monkeypatch, fits=True)
    assert calls and routes == [("fused", True, False)]


def test_weights_round_trip_both_ways():
    setup("ViT-S/16", "f32")
    np_params, _, spec, _ = _CACHE["ViT-S/16"]
    back = vit_to_jax_params(vit_from_jax_params(np_params, spec,
                                                 device="cpu"))
    want, got = _flatten(np_params), _flatten(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # bf16 JAX weights land as their f32 values and come back so
    jb = jax.tree_util.tree_map(lambda a: np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16)), np_params)
    back = _flatten(vit_to_jax_params(
        vit_from_jax_params(jb, spec, device="cpu").to(torch.bfloat16)))
    for k, v in _flatten(jb).items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32),
                                      err_msg=k)


def test_presets_and_patchify_match_jax():
    for name, spec in VIT_PRESETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            JAX_PRESETS[name])
    x = np.random.default_rng(2).standard_normal(
        (2, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(x), 16).numpy(),
        np.asarray(jax_patchify(jnp.asarray(x), 16)))


def test_bf16_ops_match_jax():
    """dense casts its kernel to x's type, layer_norm takes f32 statistics,
    gelu the rational erf, the plain attention f32 scores and bf16
    probabilities: each within one bf16 ulp of JAX's (compared in f32)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    be = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)

    def close(got, want):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -7 * np.abs(want).max(), rtol=0)

    close(common.dense(xb, torch.from_numpy(w), torch.from_numpy(b)),
          jax_common.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                           xj))
    close(common.layer_norm(xb, torch.from_numpy(g), torch.from_numpy(be)),
          jax_common.layer_norm({"gamma": jnp.asarray(g),
                                 "beta": jnp.asarray(be)}, xj))
    close(common.gelu(xb * 3), jax_common.gelu(xj * 3))
    q, k, v = (rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
               for _ in range(3))
    close(_attention_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v))),
          jax_attention._attention_core(*(jnp.asarray(a).astype(jnp.bfloat16)
                                          for a in (q, k, v)), impl="xla"))
    model, jp, _, _, _ = setup("ViT-Ti/16", "bf16")
    y = rng.standard_normal((2, 9, 192)).astype(np.float32)
    close(mha(model.blocks[0].attn, *[torch.from_numpy(y).to(
        torch.bfloat16)] * 3, impl="plain"),
        jax_attention.mha(jp["blocks"][0]["attn"],
                          *[jnp.asarray(y).astype(jnp.bfloat16)] * 3,
                          impl="xla"))


def test_preprocess_images_device_matches_jax():
    raw = np.random.default_rng(6).integers(0, 256, (2, 345, 340, 3),
                                            dtype=np.uint8)
    got = preprocess_images_device(torch.from_numpy(raw), 224, 224)
    want = np.asarray(jax_preprocess(jnp.asarray(raw), 224, 224))
    assert got.shape == (2, 224, 224, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    low = preprocess_images_device(torch.from_numpy(raw), 224, 224,
                                   dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16
    # the box-filtered downscale: F.interpolate's antialiased bilinear
    # against jax.image.resize(antialias=True), within 1e-5 after /255
    for size in (224, 128):
        got = preprocess_images_device(torch.from_numpy(raw), size, size,
                                       antialias=True)
        want = np.asarray(jax_preprocess(jnp.asarray(raw), size, size,
                                         antialias=True))
        assert got.shape == (2, size, size, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_classify_image_matches_jax(tmp_path):
    """A 3-channel spec, so that JAX decodes with cv2 as the port does."""
    import cv2

    jspec, spec = specs("ViT-Ti/16", depth=2, image_size=64)
    jspec = dataclasses.replace(jspec, num_classes=10)
    spec = dataclasses.replace(spec, num_classes=10)
    params = jax_init(jax.random.PRNGKey(3), jspec)
    model = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                spec, device="cpu")
    rng = np.random.default_rng(7)
    path = str(tmp_path / "layer.jpg")
    cv2.imwrite(path, rng.integers(0, 256, (90, 80, 3), dtype=np.uint8))
    probs, top1 = classify_image(model, path)
    want, want_top1 = jax_classify(params, jspec, path, impl="xla")
    assert probs.shape == (10,) and abs(float(probs.sum()) - 1.0) < 1e-5
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
    assert top1 == want_top1
    with pytest.raises(FileNotFoundError):
        classify_image(model, str(tmp_path / "missing.jpg"))
