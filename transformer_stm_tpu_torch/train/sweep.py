"""Hyperparameter sweep (transformer_stm_tpu/train/sweep.py:119-330), the
successor of the reference lineage's keras-tuner search
(old_codes/BayConvT(OnlyPar).py:191).

- **CvT sweeps train the points as slots.**  Every (learning_rate, seed)
  point trains as one slot of the multi-target trainer (train/multi.py),
  over one corpus on the card.  Points that differ in the dropout rate
  build different models, so the runner groups points by dropout and runs
  one trainer per group, of at most ``max_group`` slots.
- **FFN sweeps run one point after another** through the harness (the
  params-only model trains in seconds) and may also sweep the hidden
  width, a shape change that slots of one trainer cannot hold.

Selection metric: the final epoch's validation MSE (the protocol's own
val_loss); the lowest over the epochs is recorded beside it.

The free-form sweep over dotted config paths (``run_config_sweep``) writes
an xlsx leaderboard through ``data/xlsx.write_xlsx``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ExperimentConfig

__all__ = ["grid_points", "sweep_cvt", "sweep_ffn", "run_sweep",
           "write_summary", "config_grid_points", "config_random_points",
           "run_config_sweep"]


def grid_points(lrs: Sequence[float], dropouts: Sequence[float] = (None,),
                seeds: Sequence[int] = (0,),
                hiddens: Sequence[int] = (None,)) -> List[Dict]:
    """The cross product as a list of sweep points (dicts).  None entries
    mean "leave at the config's value"."""
    pts = []
    for lr, dr, seed, hid in itertools.product(lrs, dropouts, seeds,
                                               hiddens):
        p = {"lr": float(lr), "seed": int(seed)}
        if dr is not None:
            p["dropout"] = float(dr)
        if hid is not None:
            p["hidden"] = int(hid)
        pts.append(p)
    return pts


def _with_dropout(spec, rate: float):
    stages = tuple(dataclasses.replace(st, dropout_rate=rate)
                   for st in spec.stages)
    return dataclasses.replace(spec, stages=stages)


def sweep_cvt(cfg: ExperimentConfig, freq: str, points: Sequence[Dict],
              epochs: Optional[int] = None, impl: str = "auto",
              mlp_impl: str = "xla", epochs_per_call: int = 1,
              corpus=None, verbose: bool = True,
              max_group: int = 5, device="cuda") -> List[Dict]:
    """Runs ``points`` for one CvT target; returns per-point results in
    the points' order.

    Points that share a dropout rate train together as the slots of one
    trainer, with per-slot learning rates (``lr_scales``, shares of
    cfg.train.learning_rate), in chunks of at most ``max_group`` slots."""
    from .multi import MultiTargetTrainer

    epochs = epochs or cfg.train.epochs
    for p in points:
        if "hidden" in p:
            raise ValueError("hidden-width sweep is FFN-only (a shape "
                             "change cannot be a slot)")

    by_static: Dict[Optional[float], List[int]] = {}
    for i, p in enumerate(points):
        by_static.setdefault(p.get("dropout"), []).append(i)

    results: List[Optional[Dict]] = [None] * len(points)
    for dropout, idxs in by_static.items():
        g_cfg = cfg
        if dropout is not None:
            g_cfg = dataclasses.replace(
                cfg, model=_with_dropout(cfg.model, dropout))
        for chunk_start in range(0, len(idxs), max_group):
            chunk = idxs[chunk_start:chunk_start + max_group]
            # "sweep{i}" (not the bare int of a "(many)" repeat) keeps the
            # sweep's artifacts in their own _{time} namespace
            targets = [(freq, points[i]["seed"], f"sweep{i + 1}")
                       for i in chunk]
            scales = [points[i]["lr"] / g_cfg.train.learning_rate
                      for i in chunk]
            tr = MultiTargetTrainer(g_cfg, targets, impl=impl,
                                    mlp_impl=mlp_impl,
                                    epochs_per_call=epochs_per_call,
                                    corpus=corpus, lr_scales=scales,
                                    device=device)
            tr.fit(epochs, verbose=verbose)
            for slot, i in enumerate(chunk):
                rec = np.asarray(tr.records[slot], np.float64)
                val = rec[:, 3]
                results[i] = {
                    **points[i],
                    "val_mse": float(val[-1]),
                    "val_mae": float(rec[-1, 4]),
                    "best_val_mse": float(val.min()),
                    "best_epoch": int(rec[int(val.argmin()), 0]),
                    "epochs": int(epochs),
                }
            if verbose:
                got = ", ".join(
                    f"lr={points[i]['lr']:g}/s{points[i]['seed']}: "
                    f"{results[i]['val_mse']:.4f}" for i in chunk)
                print(f"[sweep {freq}] dropout={dropout}: {got}",
                      flush=True)
    return [r for r in results if r is not None]


def sweep_ffn(cfg: ExperimentConfig, freq: str, points: Sequence[Dict],
              epochs: Optional[int] = None, verbose: bool = True,
              device="cuda") -> List[Dict]:
    """The FFN's sweep, one point after another through the harness: each
    point a full train and evaluation at its (lr, seed[, hidden]), its
    artifacts under the _{time} suffix "sweep{i}"."""
    from ..data.labels import LabelTable, ProcessTable
    from ..harness import test_target, train_target

    epochs = epochs or cfg.train.epochs
    labels = LabelTable.load(cfg.data.excel_labels)
    procs = ProcessTable.load(cfg.data.excel_process)
    results = []
    for i, p in enumerate(points):
        if "dropout" in p:
            raise ValueError("the reference FFN has no dropout — sweep "
                             "lr/seed/hidden for inputs=par")
        tc = dataclasses.replace(cfg.train, epochs=epochs,
                                 learning_rate=p["lr"], seed=p["seed"])
        p_cfg = dataclasses.replace(cfg, train=tc)
        if "hidden" in p:
            p_cfg = dataclasses.replace(p_cfg, ffn_hidden=p["hidden"])
        train_target(p_cfg, freq, labels, procs, time=f"sweep{i + 1}",
                     verbose=False, device=device)
        res = test_target(p_cfg, freq, labels, procs, time=f"sweep{i + 1}",
                          verbose=False, device=device)
        results.append({**p, "val_mse": float(res["mse"]),
                        "val_mae": float(res["mae"]),
                        "r2": float(res["r2"]), "epochs": int(epochs)})
        if verbose:
            print(f"[sweep {freq}] point {i + 1}/{len(points)} {p}: "
                  f"MSE {res['mse']:.4f} R2 {res['r2']:.4f}", flush=True)
    return results


def run_sweep(cfg: ExperimentConfig, freq: str, points: Sequence[Dict],
              epochs: Optional[int] = None, verbose: bool = True,
              device="cuda", **cvt_kw) -> Dict:
    """Runs the FFN or the CvT sweep, as cfg.inputs says, and returns the
    summary: the points ranked by val_mse, the best first."""
    if cfg.inputs == "par":
        results = sweep_ffn(cfg, freq, points, epochs=epochs,
                            verbose=verbose, device=device)
    else:
        results = sweep_cvt(cfg, freq, points, epochs=epochs,
                            verbose=verbose, device=device, **cvt_kw)
    ranked = sorted(results, key=lambda r: r["val_mse"])
    return {"freq": freq, "inputs": cfg.inputs,
            "n_points": len(results), "best": ranked[0],
            "results": ranked}


def write_summary(summary: Dict, result_dir: str) -> str:
    path = os.path.join(
        result_dir,
        f"sweep_{summary['freq']}_{summary['inputs'].replace('+', '_')}"
        ".json")
    os.makedirs(result_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    return path


# -- the free-form sweep over dotted config paths ----------------------------

def _set_path(cfg, path: str, value):
    """dataclasses.replace along a dotted path, e.g. 'train.batch_size'."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    sub = getattr(cfg, parts[0])
    return dataclasses.replace(
        cfg, **{parts[0]: _set_path(sub, ".".join(parts[1:]), value)})


def config_grid_points(space: Dict[str, Sequence]) -> List[Dict]:
    """{dotted.path: candidates} -> the full cross product of assignments."""
    keys = list(space)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(space[k] for k in keys))]


def config_random_points(space: Dict[str, Sequence], n: int,
                         seed: int = 0) -> List[Dict]:
    """``n`` assignments drawn with ``random.Random(seed)``, the JAX
    package's draws."""
    import random

    rng = random.Random(seed)
    return [{k: rng.choice(list(v)) for k, v in space.items()}
            for _ in range(n)]


def run_config_sweep(base_cfg: ExperimentConfig, space: Dict[str, Sequence],
                     trial_fn, mode: str = "grid", n_random: int = 10,
                     seed: int = 0, objective: str = "val_loss",
                     minimize: bool = True,
                     out_path: Optional[str] = None) -> List[Dict]:
    """trial_fn(cfg) -> metrics dict.  Returns the trials sorted best
    first; with ``out_path`` also writes them as an xlsx leaderboard."""
    points = (config_grid_points(space) if mode == "grid"
              else config_random_points(space, n_random, seed))
    trials = []
    for i, point in enumerate(points):
        cfg = base_cfg
        for path, value in point.items():
            cfg = _set_path(cfg, path, value)
        metrics = trial_fn(cfg)
        trials.append({"trial": i, **point, **metrics})
        print(f"trial {i + 1}/{len(points)} {point} -> "
              f"{objective}={metrics.get(objective)}")
    trials.sort(key=lambda t: (t.get(objective) if minimize
                               else -t.get(objective)))
    if out_path:
        from ..data.xlsx import write_xlsx

        cols = ["trial"] + list(space) + sorted(
            k for k in trials[0] if k != "trial" and k not in space)
        rows = [cols] + [[t.get(c) for c in cols] for t in trials]
        write_xlsx(out_path, {"sweep": rows})
    return trials
