"""The evaluation harness's two plots (transformer_stm_tpu/tools/plots.py:68
and :87; reference models/CvT_test(Par).py:541-557), written headlessly as
PNGs on the host.

matplotlib is imported when a plot is drawn, not when this module is
imported: a machine without it imports the harness, and
``harness.test_target`` says there that the plots were not written.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, out_path: str) -> None:
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_r2_scatter(y_true, y_pred, r2: float, freq: str,
                    out_path: str) -> None:
    """Predicted-vs-actual scatter with the identity line."""
    plt = _pyplot()
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(y_true, y_pred, s=4, alpha=0.3)
    lo = float(min(y_true.min(), y_pred.min()))
    hi = float(max(y_true.max(), y_pred.max()))
    ax.plot([lo, hi], [lo, hi], "r--", linewidth=1)
    ax.set_xlabel("actual")
    ax.set_ylabel("predicted")
    ax.set_title(f"{freq}  R² = {r2:.4f}")
    _save(fig, plt, out_path)


def plot_actual_vs_predicted(y_true, y_pred, freq: str,
                             out_path: str) -> None:
    """Actual and predicted value lines over the evaluation set index."""
    plt = _pyplot()
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(y_true, label="actual", linewidth=0.8)
    ax.plot(y_pred, label="predicted", linewidth=0.8, alpha=0.8)
    ax.set_xlabel("test image")
    ax.set_ylabel(freq)
    ax.set_title(f"actual vs predicted — {freq}")
    ax.legend()
    _save(fig, plt, out_path)
