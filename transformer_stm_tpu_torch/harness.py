"""Experiment harness (transformer_stm_tpu/harness.py): per-target training
and evaluation.

- ``train_target`` (:76): data -> ``TrainLoop`` -> weights checkpoint and
  records sheet, resuming from the latest mid-run checkpoint;
- ``test_target`` (:231): rebuild the model, load its weights, predict the
  held-out split, write the Predictions_Metrics sheet and the two plots;
- ``run`` (:332): every configured target, times the repeats of the
  "(many)" mode, with the label and process sheets read once.

Artifact layout, the reference's:

    Result/Weight/{variant}/{weight name}/            checkpoints
    Result/Records/{variant}/{records name}.xlsx      per-epoch records
    Result/Excel/{variant}/Predictions_Metrics_{freq}.xlsx
    Result/Plots/{variant}/...

Each function runs on ``device`` (the card unless the caller asks for the
CPU).  ``inputs="par"`` (the params-only FFN, JAX ``_train_ffn`` :135) is
not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from .config import ExperimentConfig
from .data.images import load_dataset
from .data.labels import LabelTable, ProcessTable
from .data.split import train_val_split


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


def _check_inputs(cfg: ExperimentConfig):
    if cfg.inputs == "par":
        raise NotImplementedError(
            'inputs="par" (the params-only FFN) is not ported yet')


def _load_target(cfg: ExperimentConfig, freq: str, labels, procs):
    data = load_dataset(cfg.data, freq, labels, procs,
                        with_images=(cfg.inputs != "par"))
    train_rows, val_rows = train_val_split(
        data["valid_indices"], data["count"], cfg.data.image_layers)
    return data, train_rows, val_rows


def train_target(cfg: ExperimentConfig, freq: str, labels=None, procs=None,
                 time: Optional[int] = None, epochs: Optional[int] = None,
                 verbose: bool = True, device="cuda") -> Dict:
    """Trains one target end to end; writes the weights and the records.
    Resumes from the latest checkpoint under ``<weights>.ckpts`` (written
    every ``checkpoint_every`` epochs); a "(many)" repeat ``time`` trains
    from the seed ``cfg.train.seed + 1000 * time``."""
    from .train.checkpoint import latest_checkpoint, save_checkpoint
    from .train.loop import TrainLoop

    _check_inputs(cfg)
    spec = _spec_for(cfg)
    data, train_rows, val_rows = _load_target(cfg, freq, labels, procs)
    paths = _paths(cfg, freq, time)
    if isinstance(time, int):
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=cfg.train.seed + 1000 * time))

    imgs, y = data["images"], data["labels"]
    proc = data["proc_scaled"] if cfg.inputs != "img" else None
    loop = TrainLoop(spec, cfg.train, device=device)
    ckpt_dir = paths["weights"] + ".ckpts"
    ck = latest_checkpoint(ckpt_dir)
    if ck is not None:
        loop.load_checkpoint(ck)
        if verbose:
            print(f"[{freq}] resuming from {ck} at epoch {loop.epoch}")
    out = loop.fit(
        imgs[train_rows], proc[train_rows] if proc is not None else None,
        y[train_rows],
        val=(imgs[val_rows], proc[val_rows] if proc is not None else None,
             y[val_rows]),
        epochs=epochs, verbose=verbose, checkpoint_dir=ckpt_dir)
    save_checkpoint(paths["weights"], out["model"], out["opt"],
                    step=loop.epoch,
                    metadata={"freq": freq, "config": cfg.inputs})
    out["records"].write(paths["records"])
    return {"paths": paths, "records": out["records"].rows}


def test_target(cfg: ExperimentConfig, freq: str, labels=None, procs=None,
                time: Optional[int] = None, verbose: bool = True,
                device="cuda") -> Dict:
    """Evaluates one target from its saved weights; writes the
    Predictions_Metrics sheet and the two plots.  Where matplotlib is not
    installed the plots are not written, and one line says so."""
    from .tools.plots import plot_actual_vs_predicted, plot_r2_scatter
    from .train.checkpoint import latest_checkpoint, load_checkpoint, \
        load_into
    from .train.loop import TrainLoop
    from .train.metrics import mae, mse, r2_score, write_predictions_metrics

    _check_inputs(cfg)
    spec = _spec_for(cfg)
    data, train_rows, val_rows = _load_target(cfg, freq, labels, procs)
    paths = _paths(cfg, freq, time)
    y_val = np.asarray(data["labels"])[val_rows]
    ckpt = latest_checkpoint(paths["weights"])
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint for {freq} under {paths['weights']}: train "
            "first")
    loop = TrainLoop(spec, cfg.train, device=device)
    params, state, _, _ = load_checkpoint(ckpt)
    load_into(loop.model, params, state)
    proc = data["proc_scaled"] if cfg.inputs != "img" else None
    pred = loop.predict(data["images"][val_rows],
                        proc[val_rows] if proc is not None else None,
                        exact=True)

    r2, m_mse, m_mae = r2_score(y_val, pred), mse(y_val, pred), \
        mae(y_val, pred)
    write_predictions_metrics(paths["metrics"], freq, pred, y_val,
                              len(train_rows), len(val_rows))
    try:
        plot_r2_scatter(y_val, pred, r2, freq, paths["plot_scatter"])
        plot_actual_vs_predicted(y_val, pred, freq, paths["plot_lines"])
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print(f"[{freq}] plots not written ({paths['plot_scatter']}, "
              f"{paths['plot_lines']}): matplotlib is not installed")
    if verbose:
        print(f"[{freq}] R² {r2:.4f}  MSE {m_mse:.2f}  MAE {m_mae:.3f}")
    return {"r2": r2, "mse": m_mse, "mae": m_mae, "paths": paths}


def run(cfg: ExperimentConfig, mode: str = "train",
        epochs: Optional[int] = None, verbose: bool = True,
        device="cuda") -> Dict:
    """Every configured target (times the repeats in "(many)" mode)."""
    labels = LabelTable.load(cfg.data.excel_labels)
    procs = ProcessTable.load(cfg.data.excel_process)
    results = {}
    times = range(1, cfg.train.repeats + 1) if cfg.train.repeats > 1 \
        else [None]
    for freq in cfg.frequencies:
        for t in times:
            if verbose:
                tag = f" (run {t})" if t else ""
                print(f"=== {mode} {freq}{tag} ===")
            if mode == "train":
                results[(freq, t)] = train_target(
                    cfg, freq, labels, procs, time=t, epochs=epochs,
                    verbose=verbose, device=device)
            else:
                results[(freq, t)] = test_target(
                    cfg, freq, labels, procs, time=t, verbose=verbose,
                    device=device)
    return results
