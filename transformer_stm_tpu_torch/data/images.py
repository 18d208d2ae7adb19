"""Image corpus (transformer_stm_tpu/data/images.py).

The reference decodes, per valid specimen, 200 JPEGs with cv2.imread (BGR),
cv2.resize to (W, H) INTER_LINEAR and BGR2GRAY, and /255
(models/CvT(Par).py:411-426).  ``decode_corpus`` decodes the corpus once
into a uint8 memmap cache (specimen-major, resized and grayscaled) with a
.json of the specimens decoded so far, shared by every target; when the
cache covers the wanted specimens it decodes nothing.  The /255 runs on the
device (``normalize_images``).  ``decode_specimen`` decodes through the
native loader (``data/native.py``, libjpeg) where it builds, else through
cv2, imported when it runs, as the JAX package chooses between them.
``preprocess_images_device`` resizes, greys and normalises raw RGB on the
device.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DataConfig
from .labels import LabelTable, ProcessTable, build_target_arrays


def _specimen_dir(cfg: DataConfig, spec_idx: int) -> str:
    """Specimen row -> data folder (models/CvT(Par).py:412-416)."""
    pieces = cfg.piece_num_end - cfg.piece_num_start + 1
    group = spec_idx // pieces + 1
    piece = spec_idx % pieces + 1
    return os.path.join(cfg.data_root,
                        f"circle(340x345)/trail{group:01d}_{piece:02d}")


def decode_specimen(cfg: DataConfig, spec_idx: int,
                    use_native: Optional[bool] = None) -> np.ndarray:
    """One specimen's image_layers JPEGs -> (L, H, W) uint8 grey, the
    reference's pipeline (resize the 3-channel image first, then BGR2GRAY:
    the order matters), as images.py:39-59 decodes it: through the native
    loader unless ``use_native`` is False or it does not build here, else
    (or where a file fails, for cv2's error) through cv2."""
    folder = _specimen_dir(cfg, spec_idx)
    paths = [os.path.join(folder, f"layer_{i + 1:02d}.jpg")
             for i in range(cfg.image_layers)]
    if use_native is not False:
        from . import native

        if native.available():
            try:
                return native.decode_batch(paths, cfg.image_height,
                                           cfg.image_width)
            except IOError:
                pass

    import cv2

    out = np.empty((cfg.image_layers, cfg.image_height, cfg.image_width),
                   np.uint8)
    for i, fn in enumerate(paths):
        img = cv2.imread(fn)
        if img is None:
            raise FileNotFoundError(fn)
        img = cv2.resize(img, (cfg.image_width, cfg.image_height))
        out[i] = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return out


def _cache_paths(cfg: DataConfig) -> Tuple[str, str]:
    tag = f"{cfg.image_height}x{cfg.image_width}_L{cfg.image_layers}"
    base = os.path.join(cfg.cache_dir, f"corpus_{tag}")
    return base + ".npy", base + ".json"


def decode_corpus(cfg: DataConfig, specimen_indices=None,
                  verbose: bool = True) -> np.ndarray:
    """The corpus as a read-only memmap (n_specimens, L, H, W) uint8,
    decoding only the wanted specimens (all by default) that the cache does
    not hold yet.  The cache layout is the JAX package's, so either package
    reads the other's."""
    pieces = cfg.piece_num_end - cfg.piece_num_start + 1
    n_spec = cfg.group_end * pieces
    npy, meta = _cache_paths(cfg)
    if os.path.exists(npy) and os.path.exists(meta):
        with open(meta) as f:
            done = set(json.load(f)["decoded"])
    else:
        os.makedirs(cfg.cache_dir, exist_ok=True)
        arr = np.lib.format.open_memmap(
            npy, mode="w+", dtype=np.uint8,
            shape=(n_spec, cfg.image_layers, cfg.image_height,
                   cfg.image_width))
        del arr
        done = set()

    wanted = (list(range(n_spec)) if specimen_indices is None
              else [int(i) for i in specimen_indices])
    missing = [i for i in wanted if i not in done]
    if missing:
        arr = np.lib.format.open_memmap(npy, mode="r+")
        for n, idx in enumerate(missing):
            arr[idx] = decode_specimen(cfg, idx)
            done.add(idx)
            if verbose and (n + 1) % 20 == 0:
                print(f"decoded {n + 1}/{len(missing)} specimens")
        arr.flush()
        del arr
        with open(meta, "w") as f:
            json.dump({"decoded": sorted(done)}, f)
    return np.lib.format.open_memmap(npy, mode="r")


def load_dataset(cfg: DataConfig, freq: str,
                 labels: Optional[LabelTable] = None,
                 procs: Optional[ProcessTable] = None,
                 with_images: bool = True):
    """One target's dataset in the reference's layout: a dict with images
    (N, H, W, 1) uint8 (normalised on the device), labels (N,),
    proc_scaled (N, 5), valid_indices and count; N = V * image_layers in
    specimen order.  with_images=False skips the decode."""
    labels = labels or LabelTable.load(cfg.excel_labels)
    procs = procs or ProcessTable.load(cfg.excel_process)
    t = build_target_arrays(cfg, freq, labels, procs)
    if with_images:
        corpus = decode_corpus(cfg, t["valid_indices"])
        imgs = corpus[t["valid_indices"]]  # (V, L, H, W)
        v, l, h, w = imgs.shape
        t["images"] = np.asarray(imgs).reshape(v * l, h, w, 1)
    return t


def normalize_images(x):
    """uint8 -> float32 in [0, 1] (images.py:139), on x's device; float
    input passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x


# BT.601 weights of R, G and B, as cv2's BGR2GRAY applies them
GREY_WEIGHTS = (0.299, 0.587, 0.114)


def preprocess_images_device(rgb, out_h: int, out_w: int, dtype=None,
                             antialias: bool = False):
    """Raw RGB (B, H0, W0, 3), uint8 or float, on any device -> resized,
    BT.601-greyed, /255 (B, out_h, out_w, 1) float32 or ``dtype``, on the
    same device (images.py:146): bilinear with half-pixel centres
    (``F.interpolate(align_corners=False)``).  Without ``antialias`` it is
    the 2x2-tap resize that ``jax.image.resize(method="linear",
    antialias=False)`` and cv2's INTER_LINEAR compute; with it, the
    triangle filter widened by the scale when shrinking, as
    ``jax.image.resize(..., antialias=True)`` filters."""
    x = rgb.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=antialias)
    w = torch.tensor(GREY_WEIGHTS, device=x.device)
    grey = torch.einsum("bchw,c->bhw", x, w) / 255.0
    if dtype is not None:
        grey = grey.to(dtype)
    return grey[..., None]
