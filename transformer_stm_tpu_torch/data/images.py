"""Image helpers (transformer_stm_tpu/data/images.py); this slice needs
only the normalisation.  The corpus loader comes with the evaluation
harness."""

from __future__ import annotations

import torch


def normalize_images(x):
    """uint8 -> float32 in [0, 1] (images.py:139), on x's device; float
    input passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x
