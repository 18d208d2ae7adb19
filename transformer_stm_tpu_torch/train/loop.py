"""The inference half of ``TrainLoop`` (transformer_stm_tpu/train/loop.py:
410-434).  ``fit`` comes with the training slice.

    loop = TrainLoop(spec, cfg, device="cuda")
    preds = loop.predict(images_u8, proc)          # np.float32 (N,)

Images go to the device as uint8 and are normalised there (/255).  The
last batch is padded to the batch size with copies of row 0, as the JAX
loop pads it to keep one compiled shape, and the pad rows are dropped.
On a CUDA device the loop evaluates in true f32 (``use_true_f32``), as the
JAX package's metrics exports do (``exact=True``, loop.py:166-189).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CvTSpec, TrainConfig
from ..data.images import normalize_images
from ..models.cvt import CvT, cvt_forward, init_cvt
from ..ops.common import use_true_f32


class TrainLoop:
    def __init__(self, spec: CvTSpec, cfg: TrainConfig = TrainConfig(),
                 impl: str = "auto", device="cuda",
                 model: Optional[CvT] = None):
        self.spec = spec
        self.cfg = cfg
        self.impl = impl
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_true_f32()
        if model is None:
            model = init_cvt(spec, torch.Generator().manual_seed(cfg.seed),
                             device=self.device)
        self.model = model.to(self.device)

    def predict(self, images, proc, batch_size: Optional[int] = None):
        """images: (N, H, W, C) uint8 or float; proc: (N, P) or None ->
        np.float32 (N,)."""
        bs = batch_size or self.cfg.batch_size
        n = len(images)
        outs = []
        with torch.inference_mode():
            for s in range(0, n, bs):
                idx = np.arange(s, min(s + bs, n))
                real = len(idx)
                if real < bs:  # pad to one shape, as the JAX loop does
                    idx = np.concatenate([idx, np.zeros(bs - real, np.int64)])
                x = normalize_images(
                    torch.from_numpy(np.ascontiguousarray(images[idx]))
                    .to(self.device))
                p = (torch.from_numpy(np.asarray(proc[idx], np.float32))
                     .to(self.device) if proc is not None else None)
                out = cvt_forward(self.model, x, p, impl=self.impl)
                outs.append(out.reshape(-1)[:real].float().cpu().numpy())
        return np.concatenate(outs)
