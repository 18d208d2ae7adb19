"""Evaluation metrics, the training records and the predictions sheet
(transformer_stm_tpu/train/metrics.py:26-90).

The metrics match sklearn's r2_score / mean_squared_error /
mean_absolute_error; ``RecordsWriter`` writes the per-epoch records
(epoch / loss / mae / val_loss / val_mae / lr); ``write_predictions_metrics``
writes the reference's Predictions_Metrics_{freq}.xlsx schema: per-image
Predictions / Actual / Errors(%) columns and, on the first data row, Train
mounts / Test mounts / R2 Score / MSE / MAE.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..data.xlsx import read_xlsx, write_xlsx

HEADER = ["Predictions", "Actual", "Errors(%)", "Train mounts",
          "Test mounts", "R2 Score", "MSE", "MAE"]


def _f64(y):
    return np.asarray(y, np.float64).ravel()


def mse(y_true, y_pred) -> float:
    return float(np.mean((_f64(y_true) - _f64(y_pred)) ** 2))


def mae(y_true, y_pred) -> float:
    return float(np.mean(np.abs(_f64(y_true) - _f64(y_pred))))


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = _f64(y_true), _f64(y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


class RecordsWriter:
    """Per-epoch training records, written as one sheet with the header
    ``COLUMNS`` (reference: models/CvT(Par).py:492-494); epochs 1-based."""

    COLUMNS = ["epoch", "loss", "mae", "val_loss", "val_mae", "lr"]

    def __init__(self):
        self.rows: List[List] = []

    def log(self, epoch: int, loss: float, mae_v: float,
            val_loss: Optional[float], val_mae: Optional[float],
            lr: float) -> None:
        self.rows.append([epoch + 1, float(loss), float(mae_v),
                          None if val_loss is None else float(val_loss),
                          None if val_mae is None else float(val_mae),
                          float(lr)])

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_xlsx(path, {"Sheet1": [self.COLUMNS] + self.rows})


def write_predictions_metrics(path: str, freq: str, y_pred, y_true,
                              train_num: int, test_num: int) -> None:
    """Writes Predictions_Metrics_{freq}.xlsx to ``path``."""
    y_pred, y_true = _f64(y_pred), _f64(y_true)
    errors = np.abs(y_pred - y_true) / y_true * 100
    summary = [train_num, test_num, r2_score(y_true, y_pred),
               mse(y_true, y_pred), mae(y_true, y_pred)]
    rows = [HEADER]
    for i in range(len(y_pred)):
        row = [float(y_pred[i]), float(y_true[i]), float(errors[i])]
        if i == 0:
            row += summary
        rows.append(row)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_xlsx(path, {"Sheet1": rows})


def read_predictions_metrics(path: str) -> Dict:
    """Parses a Predictions_Metrics xlsx back into arrays and the summary;
    rows whose Predictions or Actual cell is empty are dropped, as the JAX
    reader drops them (train/metrics.py:100-103)."""
    sheets = read_xlsx(path)
    name = next(iter(sheets))
    header, data = sheets[name][0], sheets[name][1:]
    col = {h: i for i, h in enumerate(header) if h}
    first = data[0]
    return {
        "sheet": name, "header": header,
        "predictions": np.array([r[col["Predictions"]] for r in data
                                 if r[col["Predictions"]] is not None]),
        "actual": np.array([r[col["Actual"]] for r in data
                            if r[col["Actual"]] is not None]),
        "train_num": first[col["Train mounts"]],
        "test_num": first[col["Test mounts"]],
        "r2": first[col["R2 Score"]],
        "mse": first[col["MSE"]],
        "mae": first[col["MAE"]],
    }
