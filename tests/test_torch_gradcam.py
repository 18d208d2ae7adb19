"""The port's Grad-CAM against the JAX package's on the CPU.

On a narrow CvT (embed dims 16/32/64, 128px; weights carried from JAX
``init_cvt``, perturbed so that every leaf matters, random BatchNorm
statistics), on the same numpy images:

- ``cvt_forward(..., return_features=True)``: each stage's block output
  against JAX's within 1e-5 (the outputs too);
- ``gradcam_heatmaps`` at stages -1, 0 and 1 against JAX's: heatmaps
  within 1e-4 on [0, 1], predictions within 1e-5;
- the committed trained full-width checkpoint
  (persist/.../cvt_model_weights_200HZ_Pcv_dw_bn_clsTrue) on 4 synthetic
  images: heatmaps and predictions within 1e-3, the golden bar (skipped
  where it is absent);
- ``overlay_heatmap`` bit-equal to JAX's; ``save_gradcam_panel`` writes
  its PNG;
- ``harness.heatmap_target`` on a synthetic JPEG fixture
  (tests/test_torch_data.py ``write_fixture``/``write_jpegs``) and a JAX
  checkpoint writes ``n_images`` panels and JAX's heatmaps (1e-4); without
  matplotlib it computes them and says that the panels were not written.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_data import write_fixture, write_jpegs
from test_torch_model import _narrow, _np_tree, _perturbed, _random_state
from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu import harness as jax_harness
from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.tools import grad_cam as jax_grad_cam
from transformer_stm_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from transformer_stm_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from transformer_stm_tpu_torch import config, harness
from transformer_stm_tpu_torch.config import CvTSpec
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.tools import grad_cam
from transformer_stm_tpu_torch.train.checkpoint import (from_jax_params,
                                                        load_checkpoint)

HERE = os.path.dirname(os.path.abspath(__file__))
FINAL = os.path.join(
    HERE, "..", "persist", "Weight", "Images & Parameters",
    "cvt_model_weights_200HZ_Pcv_dw_bn_clsTrue", "ckpt_001000.npz")
HEAT_TOL = 1e-4
PRED_TOL = 1e-5


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(20)
    jspec = _narrow(JaxCvTSpec, "dw_bn", True)
    params, state = jax_init_cvt(jax.random.PRNGKey(4), jspec)
    params = _perturbed(_np_tree(params), rng)
    state = _random_state(state, rng)
    model = from_jax_params(params, state, _narrow(CvTSpec, "dw_bn", True),
                            device="cpu")
    images = rng.uniform(0, 1, (3, 128, 128, 1)).astype(np.float32)
    proc = rng.standard_normal((3, 5)).astype(np.float32)
    return dict(jspec=jspec, params=params, state=state, model=model,
                images=images, proc=proc)


def test_return_features_match_jax(narrow):
    n = narrow
    want, _, jfeats = jax_cvt_forward(n["params"], n["state"], n["jspec"],
                                      n["images"], n["proc"],
                                      return_features=True)
    with torch.no_grad():
        out, feats = cvt_forward(n["model"], torch.from_numpy(n["images"]),
                                 torch.from_numpy(n["proc"]),
                                 return_features=True)
        plain = cvt_forward(n["model"], torch.from_numpy(n["images"]),
                            torch.from_numpy(n["proc"]))
    assert torch.equal(out, plain)
    assert [tuple(f.shape) for f in feats] == [(3, 32, 32, 16),
                                               (3, 16, 16, 32),
                                               (3, 8, 8, 64)]
    for got, ref in zip(feats, jfeats):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("stage", [-1, 0, 1])
def test_gradcam_heatmaps_match_jax(narrow, stage):
    n = narrow
    want_h, want_p = jax_grad_cam.gradcam_heatmaps(
        n["params"], n["state"], n["jspec"], n["images"], n["proc"],
        stage=stage)
    got_h, got_p = grad_cam.gradcam_heatmaps(
        n["model"], n["model"].spec, n["images"], n["proc"], stage=stage)
    assert got_h.shape == want_h.shape and got_h.dtype == np.float32
    assert got_h.min() >= 0.0 and got_h.max() <= 1.0
    np.testing.assert_allclose(got_h, want_h, atol=HEAT_TOL, rtol=0)
    np.testing.assert_allclose(got_p, want_p, atol=PRED_TOL, rtol=PRED_TOL)


def test_gradcam_plain_route_equals_auto(narrow):
    """On the CPU every kernel wrapper runs its plain version, so the two
    routes agree to rounding; the card holds the kernels to this in
    chip_smoke.py phase 9."""
    n = narrow
    auto = grad_cam.gradcam_heatmaps(n["model"], n["model"].spec,
                                     n["images"], n["proc"])
    plain = grad_cam.gradcam_heatmaps(n["model"], n["model"].spec,
                                      n["images"], n["proc"], impl="plain")
    for a, b in zip(auto, plain):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.skipif(not os.path.exists(FINAL),
                    reason="trained CvT checkpoint not in this checkout")
def test_trained_checkpoint_gradcam_matches_jax():
    params, state, _, _ = load_checkpoint(FINAL)
    model = from_jax_params(params, state, CvTSpec(), device="cpu")
    jspec = JaxCvTSpec()
    p0, s0 = jax_init_cvt(jax.random.PRNGKey(0), jspec)
    jparams, jstate, _, _ = jax_load_checkpoint(FINAL, p0, s0)
    rng = np.random.default_rng(21)
    images = rng.uniform(0, 1, (4, 128, 128, 1)).astype(np.float32)
    proc = rng.standard_normal((4, 5)).astype(np.float32)
    want_h, want_p = jax_grad_cam.gradcam_heatmaps(jparams, jstate, jspec,
                                                   images, proc)
    got_h, got_p = grad_cam.gradcam_heatmaps(model, model.spec, images, proc)
    assert got_h.shape == (4, 8, 8)
    np.testing.assert_allclose(got_h, want_h, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_p, want_p, atol=1e-3, rtol=0)


def test_overlay_is_jax_bit_for_bit_and_the_panel_is_written(tmp_path):
    rng = np.random.default_rng(22)
    image = rng.uniform(0, 1, (128, 128))
    heat = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    got = grad_cam.overlay_heatmap(image, heat)
    np.testing.assert_array_equal(got, jax_grad_cam.overlay_heatmap(image,
                                                                    heat))
    assert got.shape == (128, 128, 3)
    path = str(tmp_path / "panel.png")
    grad_cam.save_gradcam_panel(path, image, heat, 1.25, 1.5)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _spec64(mod):
    base = mod.CvTSpec(image_height=64, image_width=64)
    return dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, embed_dim=d, num_heads=h)
        for st, d, h in zip(base.stages, (16, 32, 64), (1, 2, 4))))


@pytest.fixture(scope="module")
def heat_fixture(tmp_path_factory):
    """A JPEG tree of 2 groups x 5 pieces x 3 layers at 64px and one JAX
    checkpoint at the target's weight path."""
    root = str(tmp_path_factory.mktemp("heat"))
    fields, corpus = write_fixture(root, groups=2, layers=3, hw=64)
    write_jpegs(fields, corpus)
    cfg = config.ExperimentConfig(model=_spec64(config),
                                  data=config.DataConfig(**fields),
                                  frequencies=("50HZ_Bm",),
                                  result_dir=os.path.join(root, "R"))
    jcfg = jax_config.ExperimentConfig(model=_spec64(jax_config),
                                       data=jax_config.DataConfig(**fields),
                                       frequencies=("50HZ_Bm",),
                                       result_dir=cfg.result_dir)
    params, state = jax_init_cvt(jax.random.PRNGKey(6),
                                 jax_harness._spec_for(jcfg))
    jax_save_checkpoint(jax_harness._paths(jcfg, "50HZ_Bm")["weights"],
                        params, state, None, step=1)
    return cfg, jcfg, params, state


def test_heatmap_target_writes_panels_with_jax_heatmaps(heat_fixture):
    cfg, jcfg, params, state = heat_fixture
    out = harness.heatmap_target(cfg, "50HZ_Bm", layers=3, n_images=4,
                                 verbose=False, device="cpu")
    assert len(out["panels"]) == 4
    for k, path in enumerate(out["panels"]):
        assert path == os.path.join(cfg.result_dir, "Plots",
                                    cfg.variant_dir,
                                    f"gradcam_50HZ_Bm_{k}.png")
        assert os.path.getsize(path) > 0
    # JAX's heatmaps over the same images: the first 4 held-out rows of the
    # data reloaded at 3 layers a specimen
    sub = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, image_layers=3))
    data, _, val_rows = jax_harness._load_target(sub, "50HZ_Bm", None, None)
    rows = val_rows[:4]
    want_h, want_p = jax_grad_cam.gradcam_heatmaps(
        params, state, jax_harness._spec_for(jcfg),
        data["images"][rows].astype(np.float32) / 255.0,
        data["proc_scaled"][rows])
    np.testing.assert_allclose(out["heatmaps"], want_h, atol=HEAT_TOL,
                               rtol=0)
    np.testing.assert_allclose(out["preds"], want_p, atol=PRED_TOL,
                               rtol=PRED_TOL)


def test_heatmap_target_without_matplotlib_says_so(heat_fixture,
                                                   monkeypatch, capsys):
    cfg = dataclasses.replace(heat_fixture[0], result_dir=os.path.join(
        heat_fixture[0].result_dir, "..", "R2"))
    weights = harness._paths(heat_fixture[0], "50HZ_Bm")["weights"]
    dst = harness._paths(cfg, "50HZ_Bm")["weights"]
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.symlink(weights, dst)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = harness.heatmap_target(cfg, "50HZ_Bm", layers=3, n_images=2,
                                 device="cpu")
    assert out["panels"] == [] and out["heatmaps"].shape == (2, 4, 4)
    assert "panels not written" in capsys.readouterr().out


def test_heatmap_target_refuses_the_params_only_variant(heat_fixture):
    cfg = dataclasses.replace(heat_fixture[0], inputs="par")
    with pytest.raises(ValueError, match="image branch"):
        harness.heatmap_target(cfg, "50HZ_Bm", device="cpu")
