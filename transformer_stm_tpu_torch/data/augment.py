"""On-device augmentation (transformer_stm_tpu/data/augment.py:19-73):
flips, rot90, reflect-pad crop, brightness and contrast jitter, vectorised
over the batch on the images' device.

    x = augment_batch(images, AugmentConfig(), generator)   # (B, H, W, C)

``augment_batch`` draws each sample's parameters from ``generator`` (on the
images' device) and ``augment_with`` applies given draws, so that the same
draws give the same images whatever drew them: the JAX function draws from
per-sample keys (``_augment_one``), which a test can replay.  The order of
the steps is the JAX one: horizontal flip, vertical flip, rot90 (square
images only), a crop of the image padded by ``crop_padding`` with
reflection, brightness x scale, contrast (x - mean) x factor + mean with
the mean over the image of each channel, then a clip to [0, 1].
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F


class AugmentConfig(NamedTuple):
    horizontal_flip: bool = True
    vertical_flip: bool = False
    rot90: bool = True           # random 0/90/180/270 rotation
    crop_padding: int = 8        # pad-and-crop jitter, 0 = off
    brightness: float = 0.1      # multiplicative jitter amplitude, 0 = off
    contrast: float = 0.1        # contrast jitter amplitude, 0 = off


def draw(b: int, cfg: AugmentConfig, generator: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Per-sample parameters of a batch of b, each (b,) on ``device``:
    ``flip_h``/``flip_v`` (bool, probability 1/2), ``rot`` (quarter turns,
    0..3), ``crop_y``/``crop_x`` (offsets into the padded image, 0..2p),
    ``brightness`` and ``contrast`` (1 + uniform(-a, a)).  All are drawn
    whatever the config, so a run's draws do not depend on which steps are
    on."""
    def uniform(a):
        u = torch.rand(b, generator=generator, device=device)
        return 1.0 + (2.0 * u - 1.0) * a

    p = cfg.crop_padding
    return {
        "flip_h": torch.rand(b, generator=generator, device=device) < 0.5,
        "flip_v": torch.rand(b, generator=generator, device=device) < 0.5,
        "rot": torch.randint(0, 4, (b,), generator=generator, device=device),
        "crop_y": torch.randint(0, 2 * p + 1, (b,), generator=generator,
                                device=device),
        "crop_x": torch.randint(0, 2 * p + 1, (b,), generator=generator,
                                device=device),
        "brightness": uniform(cfg.brightness),
        "contrast": uniform(cfg.contrast),
    }


def augment_with(images, draws: Dict[str, torch.Tensor],
                 cfg: AugmentConfig = AugmentConfig()):
    """images (B, H, W, C) float in [0, 1] -> augmented, the same shape,
    with the per-sample parameters ``draws`` (as ``draw`` returns them; the
    entries of steps the config leaves off are not read)."""
    b, h, w, c = images.shape
    x = images

    def per_sample(v):
        return v.reshape(b, 1, 1, 1)

    if cfg.horizontal_flip:
        x = torch.where(per_sample(draws["flip_h"]), x.flip(2), x)
    if cfg.vertical_flip:
        x = torch.where(per_sample(draws["flip_v"]), x.flip(1), x)
    if cfg.rot90 and h == w:
        k = per_sample(draws["rot"])
        x = torch.where(k == 1, torch.rot90(x, 1, (1, 2)),
                        torch.where(k == 2, torch.rot90(x, 2, (1, 2)),
                                    torch.where(k == 3,
                                                torch.rot90(x, 3, (1, 2)),
                                                x)))
    if cfg.crop_padding > 0:
        p = cfg.crop_padding
        padded = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                       mode="reflect").permute(0, 2, 3, 1)
        rows = draws["crop_y"].reshape(b, 1) + torch.arange(h, device=x.device)
        cols = draws["crop_x"].reshape(b, 1) + torch.arange(w, device=x.device)
        bi = torch.arange(b, device=x.device).reshape(b, 1, 1)
        x = padded[bi, rows[:, :, None], cols[:, None, :]]
    if cfg.brightness > 0:
        x = x * per_sample(draws["brightness"]).to(x.dtype)
    if cfg.contrast > 0:
        mean = x.mean(dim=(1, 2), keepdim=True)
        x = (x - mean) * per_sample(draws["contrast"]).to(x.dtype) + mean
    return x.clamp(0.0, 1.0)


def augment_batch(images, cfg: AugmentConfig = AugmentConfig(),
                  generator: torch.Generator = None):
    """images (B, H, W, C) float in [0, 1] -> augmented, the same shape;
    each sample's parameters drawn from ``generator`` on the images'
    device."""
    if generator is None:
        raise ValueError("augment_batch requires a generator on the images' "
                         "device")
    return augment_with(images, draw(images.shape[0], cfg, generator,
                                     images.device), cfg)
