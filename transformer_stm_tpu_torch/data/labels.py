"""Label and process-parameter tables (transformer_stm_tpu/data/labels.py),
the reference's preprocess_data label logic (models/CvT(Par).py:363-407):

- 200 specimen rows = 40 groups x 5 pieces; a NaN label means the piece was
  removed as an IQR outlier by the offline label prep.
- Per target: valid indices = non-NaN rows inside the configured group
  range; labels replicated x image_layers.
- Process parameters: 5 columns per *group*, gathered per valid specimen,
  replicated x layers, then standard-scaled (fit on the replicated array,
  as sklearn's StandardScaler.fit_transform).
- ``iqr_filter``: the offline label prep's outlier rule (tools/prep.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import PROCESS_PARAMETERS, DataConfig
from .xlsx import read_table


def _is_nan(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def coerce_float(v) -> Optional[float]:
    """Cells of the raw label sheet may hold numbers as text; coerce,
    mapping non-numeric or empty cells to None."""
    if _is_nan(v):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(str(v).strip())
    except ValueError:
        return None


@dataclass
class LabelTable:
    """One row per specimen, one column per frequency target (plus leading
    index columns)."""

    columns: List[str]
    rows: List[List]

    @classmethod
    def load(cls, path: str) -> "LabelTable":
        cols, rows = read_table(path)
        return cls(cols, rows)

    def target_values(self, freq: str) -> List[Optional[float]]:
        ci = self.columns.index(freq)
        return [r[ci] if ci < len(r) and not _is_nan(r[ci]) else None
                for r in self.rows]


@dataclass
class ProcessTable:
    """One row per group, the five ``PROCESS_PARAMETERS`` columns."""

    columns: List[str]
    rows: List[List]

    @classmethod
    def load(cls, path: str) -> "ProcessTable":
        cols, rows = read_table(path)
        return cls(cols, rows)

    def group_params(self, group_index: int) -> np.ndarray:
        idx = [self.columns.index(p) for p in PROCESS_PARAMETERS]
        return np.array([self.rows[group_index][i] for i in idx], np.float64)


def standard_scale(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x - mean) / std with ddof 0; zero-variance columns pass through
    unscaled (std taken as 1)."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std_safe = np.where(std == 0.0, 1.0, std)
    return (x - mean) / std_safe, mean, std_safe


def build_target_arrays(cfg: DataConfig, freq: str, labels: LabelTable,
                        procs: ProcessTable):
    """The reference's preprocess_data without the image decode.  Returns a
    dict: valid_indices np.int64 (V,) specimen rows with a label; labels
    np.float32 (V * image_layers,); proc_scaled np.float32
    (V * image_layers, 5); count, the specimen rows scanned."""
    pieces = cfg.piece_num_end - cfg.piece_num_start + 1
    start_index = (cfg.group_start - 1) * pieces
    end_index = cfg.group_end * pieces

    values = labels.target_values(freq)
    count = cfg.group_end * pieces
    valid, label_groups = [], []
    for idx in range(count):
        v = values[idx] if idx < len(values) else None
        if v is not None and start_index <= idx < end_index:
            label_groups.extend([v] * cfg.image_layers)
            valid.append(idx)
    valid_indices = np.array(valid, np.int64)

    proc_rows = []
    for idx in valid_indices:
        proc_rows.extend([procs.group_params(int(idx) // pieces)]
                         * cfg.image_layers)
    proc_scaled, _, _ = standard_scale(np.array(proc_rows, np.float64))

    return {
        "valid_indices": valid_indices,
        "labels": np.array(label_groups, np.float32),
        "proc_scaled": proc_scaled.astype(np.float32),
        "count": count,
    }


def iqr_filter(values: Sequence) -> List[Optional[float]]:
    """The offline label prep's IQR outlier filter (labels.py:132;
    reference tools/PickUpData.py:15-25): values outside
    [Q1 - 1.5 IQR, Q3 + 1.5 IQR] become None, the quartiles by linear
    interpolation (``np.percentile``, as pandas' quantile)."""
    nums = [coerce_float(v) for v in values]
    arr = np.array([v for v in nums if v is not None], np.float64)
    if arr.size == 0:
        return [None] * len(values)
    q1, q3 = np.percentile(arr, 25), np.percentile(arr, 75)
    lo, hi = q1 - 1.5 * (q3 - q1), q3 + 1.5 * (q3 - q1)
    return [None if (v is None or v < lo or v > hi) else v for v in nums]
