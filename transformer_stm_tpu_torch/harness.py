"""Experiment harness helpers (transformer_stm_tpu/harness.py): the model
spec of an experiment and the reference's artifact layout.

    Result/Weight/{variant}/{weight name}/            checkpoints
    Result/Records/{variant}/{records name}.xlsx      per-epoch records
    Result/Excel/{variant}/Predictions_Metrics_{freq}.xlsx
    Result/Plots/{variant}/...

``train_target``, ``test_target`` and ``run`` come with the evaluation
harness.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .config import ExperimentConfig


def _spec_for(cfg: ExperimentConfig):
    spec = cfg.model.with_projection(cfg.projection_method, cfg.cls_token)
    if cfg.inputs == "img":
        spec = dataclasses.replace(spec, proc_dim=0)
    return spec


def _paths(cfg: ExperimentConfig, freq: str, time: Optional[int] = None):
    """Every artifact path of one target; "(many)" repeat runs carry the
    _{time} suffix on each of them."""
    v = cfg.variant_dir
    base = cfg.result_dir
    wname = cfg.weight_name(freq, time)
    suf = f"{freq}_{time}" if time is not None else freq
    return {
        "weights": os.path.join(base, "Weight", v, wname),
        "records": os.path.join(
            base, "Records", v,
            wname.replace("model_weights", "records") + ".xlsx"),
        "metrics": os.path.join(base, "Excel", v,
                                f"Predictions_Metrics_{suf}.xlsx"),
        "plot_scatter": os.path.join(base, "Plots", v,
                                     f"r2_scatter_{suf}.png"),
        "plot_lines": os.path.join(base, "Plots", v,
                                   f"actual_vs_predicted_{suf}.png"),
    }
