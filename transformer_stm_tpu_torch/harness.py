"""Experiment harness (transformer_stm_tpu/harness.py): per-target training
and evaluation.

- ``train_target`` (:76): data -> ``TrainLoop`` -> weights checkpoint and
  records sheet, resuming from the latest mid-run checkpoint;
- ``test_target`` (:231): rebuild the model, load its weights, predict the
  held-out split, write the Predictions_Metrics sheet and the two plots;
- ``_train_ffn`` (:135): the params-only FFN (``inputs="par"``) trained on
  the device, which ``train_target`` runs for that variant;
- ``heatmap_target`` (:289): Grad-CAM panels over a target's trained
  weights (``tools/grad_cam.py``);
- ``run`` (:332): every configured target, times the repeats of the
  "(many)" mode, with the label and process sheets read once.

Artifact layout, the reference's:

    Result/Weight/{variant}/{weight name}/            checkpoints
    Result/Records/{variant}/{records name}.xlsx      per-epoch records
    Result/Excel/{variant}/Predictions_Metrics_{freq}.xlsx
    Result/Plots/{variant}/...

Each function runs on ``device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import dataclasses
import os
from time import perf_counter
from typing import Dict, Optional

import numpy as np
import torch

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
    from the seed ``cfg.train.seed + 1000 * time``.  ``inputs="par"``
    trains the FFN (``_train_ffn``), which does not resume."""
    from .train.checkpoint import latest_checkpoint, save_checkpoint
    from .train.loop import TrainLoop

    spec = _spec_for(cfg)
    data, train_rows, val_rows = _load_target(cfg, freq, labels, procs)
    paths = _paths(cfg, freq, time)
    if isinstance(time, int):
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=cfg.train.seed + 1000 * time))
    if cfg.inputs == "par":
        return _train_ffn(cfg, freq, data["proc_scaled"], data["labels"],
                          train_rows, val_rows, paths, epochs, verbose,
                          device=device)

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


def _train_ffn(cfg: ExperimentConfig, freq: str, proc, y, train_rows,
               val_rows, paths, epochs=None, verbose: bool = True,
               device="cuda", model=None, cuda_graph: bool = True) -> Dict:
    """Trains the params-only FFN (reference models/FFN(OnlyPar).py) on
    ``device`` from ``model`` (default ``init_ffn`` from cfg.train.seed);
    writes its checkpoint and records.

    As JAX's one compiled scan over the epochs (harness.py:135-232): the
    process table and labels go to the device once; each epoch shuffles
    the training rows (a CPU generator seeded as ``TrainLoop`` seeds its
    shuffle), pads the last batch with row 0 and masks it, each step's loss
    the masked MSE over max(rows, 1), one Adam step; the epoch's loss and
    MAE are the sample-weighted sums over the rows, the validation MSE and
    MAE those of one forward over the held-out rows, lr = lr * decay ^
    floor(epoch / every) in float32.  Nothing is fetched from the device
    until the last epoch is done.

    An epoch reads its shuffle, lr and Adam bias corrections from device
    buffers that are refilled before it, so on the card the first epoch
    runs op by op and is then captured as one CUDA graph that each later
    epoch replays: one launch an epoch in place of one a kernel
    (``cuda_graph=False`` runs every epoch op by op, which chip_smoke.py
    holds the replays against).  The result's ``first_seconds`` is the
    first epoch's time, the capture included (capturing waits for the
    card)."""
    from .models.ffn import ffn_forward, init_ffn
    from .ops.common import use_true_f32
    from .train.checkpoint import save_checkpoint
    from .train.loop import _SHUFFLE, _seed
    from .train.metrics import RecordsWriter
    from .train.optimizer import adam_apply, adam_init

    tc = cfg.train
    device = torch.device(device)
    if device.type == "cuda":
        use_true_f32()
    if model is None:
        model = init_ffn(proc.shape[1], cfg.ffn_hidden,
                         cfg.model.num_classes,
                         torch.Generator().manual_seed(tc.seed),
                         device=device)
    model = model.to(device).requires_grad_(True)
    params = list(model.parameters())
    opt = adam_init(model)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    xs, ys = dev(proc[train_rows]), dev(y[train_rows])
    xv, yv = dev(proc[val_rows]), dev(y[val_rows])
    n, bs = len(train_rows), tc.batch_size
    steps = -(-n // bs)
    epochs = epochs if epochs is not None else tc.epochs
    mask = (torch.arange(steps * bs, device=device) < n).float().reshape(
        steps, bs)
    k2 = mask.sum(dim=1).clamp_min(1.0)
    lrs = [float(np.float32(tc.learning_rate) * np.power(
        np.float32(tc.lr_decay), np.float32(e // tc.lr_decay_every)))
        for e in range(epochs)]
    # the buffers an epoch reads: the shuffled rows, and each step's lr and
    # bias corrections 1 - b^t in float32 (optimizer.adam_update's)
    idx = torch.zeros(steps, bs, dtype=torch.int64, device=device)
    sched = torch.zeros(steps, 3, device=device)
    acc = torch.zeros(2, device=device)
    rec = torch.zeros(4, device=device)
    recs = torch.zeros(epochs, 4, device=device)

    def fill(epoch):
        gen = torch.Generator().manual_seed(_seed(tc.seed, _SHUFFLE, epoch))
        rows = torch.zeros(steps * bs, dtype=torch.int64)
        rows[:n] = torch.randperm(n, generator=gen)
        t = np.arange(epoch * steps + 1, (epoch + 1) * steps + 1,
                      dtype=np.float32)
        table = np.stack([np.full(steps, lrs[epoch], np.float32),
                          np.float32(1.0) - np.power(np.float32(0.9), t),
                          np.float32(1.0) - np.power(np.float32(0.999), t)],
                         axis=1)
        table = torch.from_numpy(table)
        if device.type == "cuda":
            rows, table = rows.pin_memory(), table.pin_memory()
        idx.copy_(rows.reshape(steps, bs), non_blocking=True)
        sched.copy_(table, non_blocking=True)

    def run_epoch():
        acc.zero_()
        for s in range(steps):
            with torch.enable_grad():
                err = (ffn_forward(model, xs.index_select(0, idx[s]))
                       .reshape(-1) - ys.index_select(0, idx[s]))
                se = (err.square() * mask[s]).sum()
                ae = (err.abs() * mask[s]).sum()
                grads = torch.autograd.grad(se / k2[s], params)
            adam_apply(grads, opt, params, sched[s, 0], sched[s, 1],
                       sched[s, 2])
            acc.add_(torch.stack([se.detach(), ae.detach()]))
        with torch.no_grad():
            err = ffn_forward(model, xv).reshape(-1) - yv
            rec.copy_(torch.cat([acc / n, torch.stack(
                [err.square().mean(), err.abs().mean()])]))

    graph, first_seconds = None, 0.0
    t0 = perf_counter()
    for epoch in range(epochs):
        fill(epoch)
        if graph is not None:
            graph.replay()
        elif device.type != "cuda" or not cuda_graph:
            run_epoch()
        else:
            # the first epoch on a side stream, torch.cuda.graph's warm-up
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                run_epoch()
            torch.cuda.current_stream(device).wait_stream(side)
            if epochs > 1:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):  # records; runs nothing
                    run_epoch()
        recs[epoch].copy_(rec)
        if epoch == 0:
            first_seconds = perf_counter() - t0
    opt.step = epochs * steps
    recs = recs.cpu().numpy()  # the one fetch of the run
    seconds = perf_counter() - t0
    records = RecordsWriter()
    for epoch in range(epochs):
        records.log(epoch, *recs[epoch], lrs[epoch])
    if verbose:
        later = (f", then {(seconds - first_seconds) / (epochs - 1):.3f} s "
                 "an epoch" if epochs > 1 else "")
        print(f"[{freq}] {epochs} epochs, final val_loss {recs[-1, 2]:.4f} "
              f"({seconds:.3f} s; the first epoch {first_seconds:.3f} s"
              f"{later})")
    model.requires_grad_(False)
    save_checkpoint(paths["weights"], model, opt, step=epochs,
                    metadata={"freq": freq, "config": "par"})
    records.write(paths["records"])
    return {"paths": paths, "records": records.rows, "model": model,
            "seconds": seconds, "first_seconds": first_seconds}


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

    spec = _spec_for(cfg)
    data, train_rows, val_rows = _load_target(cfg, freq, labels, procs)
    paths = _paths(cfg, freq, time)
    y_val = np.asarray(data["labels"])[val_rows]
    ckpt = latest_checkpoint(paths["weights"])
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint for {freq} under {paths['weights']}: train "
            "first")
    params, state, _, _ = load_checkpoint(ckpt)
    if cfg.inputs == "par":
        pred = _predict_ffn(params, data["proc_scaled"][val_rows],
                            device)
    else:
        loop = TrainLoop(spec, cfg.train, device=device)
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


def _predict_ffn(params, proc, device) -> np.ndarray:
    """The FFN of a checkpoint's parameters over ``proc`` -> np.float32
    (N,), in true f32 on the card (harness.py:253-262)."""
    from .models.ffn import ffn_forward
    from .ops.common import use_true_f32
    from .train.checkpoint import ffn_from_jax_params

    device = torch.device(device)
    if device.type == "cuda":
        use_true_f32()
    model = ffn_from_jax_params(params, device)
    with torch.no_grad():
        x = torch.from_numpy(np.asarray(proc, np.float32)).to(device)
        return ffn_forward(model, x).reshape(-1).cpu().numpy()


def heatmap_target(cfg: ExperimentConfig, freq: str, layers: int = 10,
                   n_images: int = 4, verbose: bool = True,
                   device="cuda") -> Dict:
    """Grad-CAM panels over a target's trained weights (reference ``make
    heatmap``, tools/grad_cam_CvT.py, at image_layers 10): the data
    reloaded at ``layers`` images a specimen, the first ``n_images``
    held-out images, one panel each at
    Result/Plots/{variant}/gradcam_{freq}_{k}.png.  Where matplotlib is not
    installed the heatmaps are computed, the panels not written, and one
    line says so.  Returns the panel paths, heatmaps and predictions."""
    from .models.cvt import CvT
    from .ops.common import use_true_f32
    from .tools.grad_cam import gradcam_heatmaps, save_gradcam_panel
    from .train.checkpoint import latest_checkpoint, load_checkpoint, \
        load_into

    if cfg.inputs == "par":
        raise ValueError("Grad-CAM needs the image branch; inputs='par' has "
                         "none")
    spec = _spec_for(cfg)
    sub_cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_layers=layers))
    data, _, val_rows = _load_target(sub_cfg, freq, None, None)
    ckpt = latest_checkpoint(_paths(cfg, freq)["weights"])
    if ckpt is None:
        raise FileNotFoundError(f"no trained weights for {freq}")
    if torch.device(device).type == "cuda":
        use_true_f32()
    params, state, _, _ = load_checkpoint(ckpt)
    model = load_into(CvT(spec), params, state).to(device)

    rows = val_rows[:n_images]
    imgs = data["images"][rows].astype(np.float32) / 255.0
    proc = data["proc_scaled"][rows] if cfg.inputs != "img" else None
    heatmaps, preds = gradcam_heatmaps(model, spec, imgs, proc)
    plots = os.path.join(cfg.result_dir, "Plots", cfg.variant_dir)
    outs = []
    try:
        for k in range(len(rows)):
            out = os.path.join(plots, f"gradcam_{freq}_{k}.png")
            os.makedirs(plots, exist_ok=True)
            save_gradcam_panel(out, imgs[k, :, :, 0], heatmaps[k],
                               float(preds[k]),
                               float(data["labels"][rows][k]))
            outs.append(out)
            if verbose:
                print(f"wrote {out}")
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print(f"[{freq}] Grad-CAM panels not written ({plots}): matplotlib "
              "is not installed")
    return {"panels": outs, "heatmaps": heatmaps, "preds": preds}


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
