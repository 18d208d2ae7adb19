"""Plots (transformer_stm_tpu/tools/plots.py), written headlessly as PNGs
on the host from the port's artifacts (records sheets, Predictions_Metrics
sheets, label sheets) and the reference's classical-ML baselines:

- ``plot_records`` (:32): the training curves of a records sheet;
- the evaluation harness's two plots, ``plot_r2_scatter`` (:68) and
  ``plot_actual_vs_predicted`` (:87) (reference models/CvT_test(Par).py:
  541-557);
- ``read_glcm_baseline`` (:109), ``plot_compare_predictions`` (:130) and
  ``plot_compare_r2`` (:157): the CvT against the GLCM baselines
  (reference tools/Compare_plot.py, Compare_r.py);
- ``plot_label_distribution`` (:193), ``plot_values_vs_group_average``
  (:211) and ``plot_labels_vs_parameters`` (:251): the dataset views
  (reference tools/Plot_Original_Data.py).

matplotlib is imported when a plot is drawn, not when this module is
imported: a machine without it imports the harness, and
``harness.test_target`` says there that the plots were not written.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ..data.xlsx import read_xlsx


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, out_path: str, dpi: int = 120) -> None:
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def plot_records(records_path: str, out_path: str,
                 clip_percentile: float = 99.8) -> None:
    """loss and MAE with their validation curves against the epoch, the y
    axis clipped at the given percentile so that early spikes do not
    flatten the plot (reference tools/Plot_records.py)."""
    rows = read_xlsx(records_path)["Sheet1"]
    header, data = rows[0], rows[1:]
    col = {h: i for i, h in enumerate(header)}
    epoch = [r[col["epoch"]] for r in data]
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    for ax, keys, title in ((axes[0], ["loss", "val_loss"], "loss (MSE)"),
                            (axes[1], ["mae", "val_mae"], "MAE")):
        allvals = []
        for k in keys:
            if k in col:
                vals = [r[col[k]] for r in data]
                if any(v is not None for v in vals):
                    ax.plot(epoch, vals, label=k)
                    allvals += [v for v in vals if v is not None]
        if allvals:
            ax.set_ylim(0, float(np.percentile(allvals, clip_percentile)))
        ax.set_xlabel("epoch")
        ax.set_title(title)
        ax.legend()
    _save(fig, plt, out_path)


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


def read_glcm_baseline(glcm_dir: str, prop: str, model: str,
                       freq_sheet: str) -> Dict:
    """One classical-ML baseline sheet, {glcm_dir}/{prop}_{model}.xlsx,
    sheet ``freq_sheet`` (e.g. '50HZ_Hc') -> {"predictions", "true", "r2"}:
    the columns whose header holds "prediction" and "true", the R² from
    the first data row of the column whose header holds "r2" or "r²"."""
    sheets = read_xlsx(os.path.join(glcm_dir, f"{prop}_{model}.xlsx"))
    header, data = sheets[freq_sheet][0], sheets[freq_sheet][1:]
    col = {h: i for i, h in enumerate(header) if h}
    pred_key = next(k for k in col if "prediction" in str(k).lower())
    true_key = next(k for k in col if "true" in str(k).lower())
    r2_key = next(k for k in col if "r2" in str(k).lower()
                  or "r²" in str(k).lower())
    return {
        "predictions": np.array([r[col[pred_key]] for r in data
                                 if r[col[pred_key]] is not None]),
        "true": np.array([r[col[true_key]] for r in data
                          if r[col[true_key]] is not None]),
        "r2": data[0][col[r2_key]],
    }


_MISSING_BASELINE = (FileNotFoundError, KeyError, StopIteration)


def plot_compare_predictions(cvt_metrics_path: str, glcm_dir: str,
                             prop: str, freq: str, out_path: str,
                             models: Sequence[str] = ("lightgbm",)) -> None:
    """The CvT's predictions over the classical models' (reference
    tools/Compare_plot.py:30-82); a model without a sheet is left out."""
    from ..train.metrics import read_predictions_metrics

    cvt = read_predictions_metrics(cvt_metrics_path)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(cvt["actual"], label="actual", linewidth=0.8, color="black")
    ax.plot(cvt["predictions"], label=f"CvT (R²={cvt['r2']:.3f})",
            linewidth=0.8, alpha=0.8)
    for m in models:
        try:
            b = read_glcm_baseline(glcm_dir, prop, m, freq)
        except _MISSING_BASELINE:
            continue
        ax.plot(b["predictions"], label=f"{m} (R²={b['r2']:.3f})",
                linewidth=0.8, alpha=0.6)
    ax.set_title(f"{freq}: CvT vs classical baselines")
    ax.legend()
    _save(fig, plt, out_path)


def plot_compare_r2(metrics_by_freq: Dict[str, str], glcm_dir: str,
                    prop: str, out_path: str,
                    models: Sequence[str] = ("lightgbm", "xgboost", "svr",
                                             "logistic", "linear")) -> None:
    """R² against the frequency for the CvT and the classical models
    (reference tools/Compare_r.py:29-68).  metrics_by_freq: {'50HZ_Hc':
    path of its Predictions_Metrics sheet, ...}."""
    from ..train.metrics import read_predictions_metrics

    freqs = sorted(metrics_by_freq, key=lambda f: int(f.split("HZ")[0]))
    hz = [int(f.split("HZ")[0]) for f in freqs]
    cvt_r2 = [read_predictions_metrics(metrics_by_freq[f])["r2"]
              for f in freqs]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(hz, cvt_r2, "o-", label="CvT")
    for m in models:
        try:
            r2s = [read_glcm_baseline(glcm_dir, prop, m, f)["r2"]
                   for f in freqs]
        except _MISSING_BASELINE:
            continue
        ax.plot(hz, r2s, "s--", label=m, alpha=0.7)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("R²")
    ax.set_title(f"{prop}: R² vs frequency")
    ax.legend()
    _save(fig, plt, out_path)


def plot_label_distribution(labels_by_freq: Dict[str, np.ndarray],
                            out_path: str) -> None:
    """Each target's label values against the specimen index, two panels a
    row."""
    rows = (len(labels_by_freq) + 1) // 2
    plt = _pyplot()
    fig, axes = plt.subplots(rows, 2, figsize=(12, 3 * rows), squeeze=False)
    for ax, (freq, vals) in zip(axes.ravel(), labels_by_freq.items()):
        ax.plot(np.asarray(vals, np.float64), ".", markersize=3)
        ax.set_title(freq)
    _save(fig, plt, out_path, dpi=100)


def _per_image(values, layers_per_piece: int):
    """(the values, None as NaN; each repeated for its specimen's images,
    so that the image numbering is the corpus's)."""
    vals = np.array([np.nan if v is None else float(v) for v in values],
                    np.float64)
    return vals, np.repeat(vals, layers_per_piece)


def plot_values_vs_group_average(values, freq: str, out_path: str,
                                 pieces_per_group: int = 5,
                                 layers_per_piece: int = 200) -> None:
    """The dataset view of the reference (tools/Plot_Original_Data.py:
    176-197): the label of every image of the corpus against its group's
    mean (a group is ``pieces_per_group`` specimens), a dashed step line.
    ``values`` is one target's column (``LabelTable.target_values``)."""
    vals, per_image = _per_image(values, layers_per_piece)
    group_avg = np.empty_like(per_image)
    span = pieces_per_group * layers_per_piece
    for g in range(len(vals) // pieces_per_group):
        block = vals[g * pieces_per_group:(g + 1) * pieces_per_group]
        group_avg[g * span:(g + 1) * span] = (
            np.nanmean(block) if np.any(~np.isnan(block)) else np.nan)
    image_numbers = np.arange(1, len(per_image) + 1)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(image_numbers, per_image, label="Actual", marker="o",
            markersize=1, linewidth=0.5)
    ax.plot(image_numbers, group_avg, label="Group Average", color="red",
            linestyle="--")
    ax.set_xlabel("Image Number")
    ax.set_ylabel("Values")
    ax.set_title(f"Actual vs Group Average - {freq}")
    ax.legend()
    _save(fig, plt, out_path, dpi=100)


def plot_labels_vs_parameters(values, proc_scaled: np.ndarray, freq: str,
                              out_path: str,
                              layers_per_piece: int = 200) -> None:
    """The labels against the five standard-scaled process parameters on a
    twin axis (tools/Plot_Original_Data.py:135-170, commented out in the
    reference).  ``proc_scaled``: (n_specimens, 5)."""
    _, per_image = _per_image(values, layers_per_piece)
    proc_rep = np.repeat(np.asarray(proc_scaled, np.float64),
                         layers_per_piece, axis=0)
    image_numbers = np.arange(1, len(per_image) + 1)
    param_labels = ["Oxygen Concentration", "Laser Scanning Speed",
                    "Laser Power", "Layer Spacing", "Energy Density"]
    colors = ["red", "green", "blue", "purple", "orange"]
    plt = _pyplot()
    fig, ax1 = plt.subplots(figsize=(10, 4))
    ax1.set_xlabel("Image Number")
    ax1.set_ylabel("Labels", color="tab:blue")
    ax1.plot(image_numbers, per_image, label="Labels", marker="o",
             markersize=1, linewidth=0.5, color="tab:blue")
    ax1.tick_params(axis="y", labelcolor="tab:blue")
    ax2 = ax1.twinx()
    for i, lbl in enumerate(param_labels):
        ax2.plot(image_numbers, proc_rep[:, i], label=lbl, marker="x",
                 markersize=1, linewidth=0.5, color=colors[i])
    ax2.set_ylabel("Parameters", color="tab:red")
    ax2.tick_params(axis="y", labelcolor="tab:red")
    l1, n1 = ax1.get_legend_handles_labels()
    l2, n2 = ax2.get_legend_handles_labels()
    ax2.legend(l1 + l2, n1 + n2, loc="upper center",
               bbox_to_anchor=(0.5, -0.15), ncol=6, fontsize=6)
    ax1.set_title(f"Labels vs Parameters - {freq}")
    _save(fig, plt, out_path, dpi=100)
