"""Deterministic train/validation split (transformer_stm_tpu/data/split.py):
in each group of 5 specimen rows the first piece that survived outlier
filtering goes to validation, every other valid piece to training
(reference: models/CvT(Par).py:437-453)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def first_valid_per_group(valid_indices: Sequence[int], count: int,
                          group_size: int = 5) -> List[int]:
    valid = set(int(v) for v in valid_indices)
    firsts = []
    for d in range(0, count, group_size):
        for j in range(d, d + group_size):
            if j in valid:
                firsts.append(j)
                break
    return firsts


def train_val_split(valid_indices: np.ndarray, count: int,
                    image_layers: int, group_size: int = 5):
    """(train_rows, val_rows): flat per-image indices into the
    (V * image_layers)-long arrays of ``labels.build_target_arrays``."""
    firsts = set(first_valid_per_group(valid_indices, count, group_size))
    train_rows, val_rows = [], []
    for i, spec_idx in enumerate(valid_indices):
        rows = np.arange(i * image_layers, (i + 1) * image_layers)
        (val_rows if int(spec_idx) in firsts else train_rows).append(rows)
    cat = lambda parts: (np.concatenate(parts) if parts
                         else np.zeros((0,), np.int64))
    return cat(train_rows), cat(val_rows)
