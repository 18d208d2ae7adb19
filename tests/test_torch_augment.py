"""The port's on-device augmentation (data/augment.py) on the CPU against
the JAX package's (transformer_stm_tpu/data/augment.py:19-73).

- ``augment_with`` given the per-sample draws that JAX's ``augment_batch``
  makes from a key (replayed here from ``_augment_one``'s splits)
  reproduces its images within 1e-6, for square and non-square batches
  and with each step on alone;
- the identity config is bit-equal to the input; shape, range [0, 1] and
  per-seed determinism of ``augment_batch``;
- ``TrainLoop`` trains with ``augment=`` (the multi-target trainer's case
  is in tests/test_torch_multi.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu.data import augment as jaug
from transformer_stm_tpu_torch.config import CvTSpec, StageSpec, TrainConfig
from transformer_stm_tpu_torch.data import augment as paug
from transformer_stm_tpu_torch.train.loop import TrainLoop

AUG_TOL = 1e-6


def jax_draws(key, b, cfg, h, w):
    """The draws of ``jaug.augment_batch(key, x, cfg)`` for a batch of b
    images of h x w, replayed from ``_augment_one``'s splits, as the
    port's ``augment_with`` takes them."""
    out = {k: [] for k in ("flip_h", "flip_v", "rot", "crop_y", "crop_x",
                           "brightness", "contrast")}
    p = cfg.crop_padding
    for k in jax.random.split(key, b):
        kh, kv, kr, kc, kb, kt = jax.random.split(k, 6)
        out["flip_h"].append(bool(jax.random.bernoulli(kh)))
        out["flip_v"].append(bool(jax.random.bernoulli(kv)))
        out["rot"].append(int(jax.random.randint(kr, (), 0, 4))
                          if h == w else 0)
        out["crop_y"].append(int(jax.random.randint(kc, (), 0, 2 * p + 1)))
        out["crop_x"].append(int(jax.random.randint(
            jax.random.fold_in(kc, 1), (), 0, 2 * p + 1)))
        out["brightness"].append(float(1.0 + jax.random.uniform(
            kb, (), minval=-cfg.brightness, maxval=cfg.brightness)))
        out["contrast"].append(float(1.0 + jax.random.uniform(
            kt, (), minval=-cfg.contrast, maxval=cfg.contrast)))
    return {k: torch.tensor(v, dtype=torch.float32 if k in (
        "brightness", "contrast") else None) for k, v in out.items()}


CONFIGS = {
    "default": paug.AugmentConfig(),
    "all": paug.AugmentConfig(vertical_flip=True, crop_padding=3,
                              brightness=0.3, contrast=0.4),
    "rot90_only": paug.AugmentConfig(horizontal_flip=False, crop_padding=0,
                                     brightness=0.0, contrast=0.0),
    "crop_only": paug.AugmentConfig(horizontal_flip=False, rot90=False,
                                    crop_padding=5, brightness=0.0,
                                    contrast=0.0),
}


@pytest.mark.parametrize("shape", [(6, 16, 16, 1), (5, 12, 20, 3)],
                         ids=["square", "wide_rgb"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_augment_with_jax_draws_matches_jax(name, shape):
    cfg = CONFIGS[name]
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jaug.augment_batch(
        key, jnp.asarray(x), jaug.AugmentConfig(*cfg)))
    got = paug.augment_with(torch.from_numpy(x),
                            jax_draws(key, shape[0], cfg, *shape[1:3]), cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=AUG_TOL, rtol=0)


def test_identity_config_is_bit_equal():
    cfg = paug.AugmentConfig(horizontal_flip=False, vertical_flip=False,
                             rot90=False, crop_padding=0, brightness=0.0,
                             contrast=0.0)
    x = torch.rand(4, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    y = paug.augment_batch(x, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(x, y)


def test_shape_range_and_determinism_per_seed():
    x = torch.rand(8, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    a, b, c = (paug.augment_batch(x, paug.AugmentConfig(),
                                  torch.Generator().manual_seed(s))
               for s in (5, 5, 6))
    assert a.shape == x.shape and a.dtype == x.dtype
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        paug.augment_batch(x)


def test_train_loop_trains_with_augment():
    spec = CvTSpec(stages=(
        StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1),
        StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                  with_cls_token=True)), image_height=32, image_width=32,
        proc_dim=5, proc_hidden=8)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (12, 32, 32, 1), dtype=np.uint8)
    proc = rng.standard_normal((12, 5)).astype(np.float32)
    labels = rng.standard_normal(12).astype(np.float32)
    cfg = TrainConfig(batch_size=8, epochs=1)
    preds = []
    for augment in (paug.AugmentConfig(), None):
        loop = TrainLoop(spec, cfg, device="cpu", augment=augment)
        loop.fit(images, proc, labels, verbose=False)
        assert loop.epoch == 1
        preds.append(loop.predict(images, proc))
    assert np.isfinite(preds[0]).all()
    assert not np.array_equal(preds[0], preds[1])
