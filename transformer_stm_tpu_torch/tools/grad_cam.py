"""Grad-CAM for the CvT (transformer_stm_tpu/tools/grad_cam.py; reference
tools/grad_cam_CvT.py:422-481): which regions of a layer image drive a
prediction.

    heatmap = ReLU( sum_c  mean_hw(d pred / d fmap)_c * fmap_c ) / max

The feature maps come from ``cvt_forward(..., return_features=True)`` on
``impl`` (on the card the attention and MLP kernels), the gradient from a
second forward on the plain route that starts from the chosen stage's
feature map, through autograd, as JAX takes ``jax.grad`` of a forward on
``impl="xla"`` (:57-76).  That forward's head is the token mean, also for a
cls model (the reference's Grad-CAM rebuilds its model with a GAP head,
tools/grad_cam_CvT.py:316-350), and its outputs are the returned
predictions.  ``overlay_heatmap`` and ``save_gradcam_panel`` draw the
reference's panels with matplotlib, imported when they run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CvTSpec
from ..models.cvt import CvT, cvt_forward


def gradcam_heatmaps(model: CvT, spec: CvTSpec, images, proc=None,
                     stage: int = -1, impl: str = "auto"):
    """images (B, H, W, C) float in [0, 1], proc (B, P) or None, numpy or
    tensors -> (heatmaps (B, h, w), preds (B,)) as float32 numpy arrays.
    The heatmap has the chosen stage's grid (stage 3: 8x8 at 128px)."""
    stage = stage % len(spec.stages)
    device = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    if proc is not None:
        proc = torch.as_tensor(proc, dtype=torch.float32, device=device)
    with torch.no_grad():
        _, features = cvt_forward(model, images, proc, impl=impl,
                                  return_features=True)
    feats = features[stage].detach().requires_grad_(True)
    with torch.enable_grad():
        preds = _forward_substituting(model, spec, proc, stage, feats)[:, 0]
        grads, = torch.autograd.grad(preds.sum(), feats)
    with torch.no_grad():
        pooled = grads.mean(dim=(1, 2), keepdim=True)  # (B, 1, 1, C)
        cam = torch.relu((pooled * feats).sum(dim=-1))  # (B, h, w)
        denom = cam.amax(dim=(1, 2), keepdim=True).clamp_min(1e-10)
        return ((cam / denom).cpu().numpy(),
                preds.detach().cpu().numpy())


def _forward_substituting(model: CvT, spec: CvTSpec, proc, stage: int,
                          sub_feats):
    """The plain forward from ``sub_feats``, the output of stage ``stage``,
    to the head: the later stages, the token-mean head, the process
    branch and the final Dense.  The stages up to ``stage`` are not run:
    their output is replaced."""
    x = sub_feats
    for st in model.stages[stage + 1:]:
        x = st.embed(x)
        for block in st.blocks:
            x, _ = block(x, impl="plain")
    b, h, w, c = x.shape
    feat = model.head_norm(x.reshape(b, h * w, c)).mean(dim=1)
    if spec.proc_dim > 0 and proc is not None:
        p = torch.relu(model.proc_fc1(proc))
        p = torch.relu(model.proc_fc2(p))
        feat = torch.cat([feat, p], dim=-1)
    return model.final(feat)


def overlay_heatmap(image_gray: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.4) -> np.ndarray:
    """The JET-colormap overlay (reference tools/grad_cam_CvT.py:537-548):
    image_gray (H, W) in [0, 1], heatmap (h, w) in [0, 1] -> (H, W, 3) RGB,
    the heatmap upscaled bilinearly with its corners on the image's."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import cm

    h, w = image_gray.shape
    yi = np.linspace(0, heatmap.shape[0] - 1, h)
    xi = np.linspace(0, heatmap.shape[1] - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, heatmap.shape[0] - 1)
    x1 = np.minimum(x0 + 1, heatmap.shape[1] - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    hm = (heatmap[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
          + heatmap[np.ix_(y1, x0)] * wy * (1 - wx)
          + heatmap[np.ix_(y0, x1)] * (1 - wy) * wx
          + heatmap[np.ix_(y1, x1)] * wy * wx)
    jet = cm.jet(hm)[:, :, :3]
    base = np.stack([image_gray] * 3, axis=-1)
    return np.clip(base + alpha * jet, 0, 1)


def save_gradcam_panel(path: str, image_gray: np.ndarray,
                       heatmap: np.ndarray, pred: float,
                       actual: Optional[float] = None) -> None:
    """The four-panel PNG: input, heatmap, overlay, and the overlay titled
    with the prediction (and the label) (reference
    tools/grad_cam_CvT.py:532-598)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    axes[0].imshow(image_gray, cmap="gray")
    axes[0].set_title("input")
    axes[1].imshow(heatmap, cmap="jet")
    axes[1].set_title("Grad-CAM")
    overlay = overlay_heatmap(image_gray, heatmap)
    axes[2].imshow(overlay)
    axes[2].set_title("overlay")
    axes[3].imshow(overlay)
    title = f"pred: {pred:.2f}"
    if actual is not None:
        title += f" / actual: {actual:.2f}"
    axes[3].set_title(title)
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
