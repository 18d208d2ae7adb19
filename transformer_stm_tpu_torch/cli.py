"""Command line of the port (transformer_stm_tpu/cli.py:27-316).

  python -m transformer_stm_tpu_torch.cli train  --config cfg.json [--freq ...]
  python -m transformer_stm_tpu_torch.cli test   --config cfg.json [--freq ...]
  python -m transformer_stm_tpu_torch.cli heatmap --config cfg.json --freq 50HZ_Bm
  python -m transformer_stm_tpu_torch.cli pickup --in raw.xlsx --out processed.xlsx
  python -m transformer_stm_tpu_torch.cli memory
  python -m transformer_stm_tpu_torch.cli plot-records --records PATH
  python -m transformer_stm_tpu_torch.cli model-plot
  python -m transformer_stm_tpu_torch.cli compare --metrics-dir DIR
  python -m transformer_stm_tpu_torch.cli plot-labels --config cfg.json
  python -m transformer_stm_tpu_torch.cli plot-data --config cfg.json [--params]
  python -m transformer_stm_tpu_torch.cli save-config --out cfg.json
  python -m transformer_stm_tpu_torch.cli sweep --config cfg.json --lr 1e-3,1e-4
      [--dropout 0.0,0.1] [--seeds 0,1] [--inputs par --hidden 64,256]

Every setting comes from one JSON config (``--config``, written by either
package) with command-line overrides; a 512px run is set up through the
config's ``model`` and ``data`` sizes, as in the JAX CLI; ``--inputs par``
trains and tests the params-only FFN.  ``--device`` (default ``cuda``)
picks where ``train``, ``test``, ``heatmap`` and ``sweep`` run; PyTorch
needs it, JAX does not.  ``sweep`` (train/sweep.py) trains the CvT's points
as slots of one trainer a dropout group, or the FFN's (``--inputs par``,
which may sweep ``--hidden``) one after another, and writes
``sweep_{freq}_{inputs}.json`` into the result directory.  The default
paths are relative (``reference/...``), as ``DataConfig``'s.  Where
matplotlib is not installed, a plotting subcommand says on a line that it
wrote nothing and returns 1.  Not ported yet: ``bench`` (the benchmark) and
``export-h5`` (the Keras weight export).
"""

from __future__ import annotations

import argparse
import dataclasses

from .config import (ExperimentConfig, FREQUENCIES, load_config,
                     save_config)


def _load_cfg(args) -> ExperimentConfig:
    return load_config(args.config) if args.config else ExperimentConfig()


def _build_cfg(args) -> ExperimentConfig:
    cfg = _load_cfg(args)
    if args.inputs:
        cfg = dataclasses.replace(cfg, inputs=args.inputs)
    if args.projection:
        cfg = dataclasses.replace(cfg, projection_method=args.projection)
    if args.cls_token is not None:
        cfg = dataclasses.replace(cfg, cls_token=args.cls_token)
    if args.freq:
        cfg = dataclasses.replace(cfg, frequencies=tuple(args.freq))
    tr = cfg.train
    if args.epochs:
        tr = dataclasses.replace(tr, epochs=args.epochs)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.repeats:
        tr = dataclasses.replace(tr, repeats=args.repeats)
    if args.seed is not None:
        tr = dataclasses.replace(tr, seed=args.seed)
    cfg = dataclasses.replace(cfg, train=tr)
    if args.result_dir:
        cfg = dataclasses.replace(cfg, result_dir=args.result_dir)
    return cfg


def _add_common(p):
    p.add_argument("--config", help="JSON config path")
    p.add_argument("--inputs", choices=["img", "par", "img+par"])
    p.add_argument("--projection", choices=["dw_bn", "avg", "linear"])
    p.add_argument("--cls-token", dest="cls_token", type=lambda s: s == "1",
                   help="1/0")
    p.add_argument("--freq", nargs="*", choices=list(FREQUENCIES),
                   help="subset of targets (default: all 20)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--repeats", type=int,
                   help=">1 = repeat-run '(many)' mode")
    p.add_argument("--seed", type=int)
    p.add_argument("--result-dir")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transformer-stm-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("train", "test"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--device", default="cuda",
                       help="torch device (default: cuda)")

    p = sub.add_parser("heatmap", help="Grad-CAM over trained weights")
    _add_common(p)
    p.add_argument("--layers", type=int, default=10,
                   help="images per specimen (reference uses 10)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")

    sub.add_parser("memory", help="CPU, RAM and card memory monitor (1 Hz)")

    p = sub.add_parser("pickup", help="IQR label prep (make Pick_up_datas)")
    p.add_argument("--in", dest="in_path",
                   default="reference/Excel/Circle_test.xlsx")
    p.add_argument("--out", dest="out_path",
                   default="Excel/Processed_Circle_test.xlsx")

    p = sub.add_parser("plot-records")
    p.add_argument("--records", required=True)
    p.add_argument("--out", default="records.png")

    p = sub.add_parser("model-plot", help="model structure diagram")
    _add_common(p)
    p.add_argument("--out", default="model_plot.png")

    p = sub.add_parser("save-config", help="write the config JSON")
    _add_common(p)
    p.add_argument("--out", default="config.json")

    p = sub.add_parser("sweep", help="hyperparameter sweep (the lineage's "
                       "keras-tuner search: CvT points train together as "
                       "slots of one trainer; FFN points also sweep the "
                       "hidden width)")
    _add_common(p)
    p.add_argument("--lr", default="1e-3",
                   help="comma list of learning rates")
    p.add_argument("--dropout", default=None,
                   help="comma list of dropout rates (CvT only)")
    p.add_argument("--seeds", default="0", help="comma list of init seeds")
    p.add_argument("--hidden", default=None,
                   help="comma list of FFN hidden widths (par only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")

    p = sub.add_parser("compare", help="CvT vs classical-ML baselines")
    p.add_argument("--metrics-dir", required=True,
                   help="dir of Predictions_Metrics_{freq}.xlsx")
    p.add_argument("--glcm-dir", default="reference/Result/Excel/glcm")
    p.add_argument("--prop", default="Hc",
                   choices=["Bm", "Hc", "μa", "Br", "Pcv"])
    p.add_argument("--out", default="compare_r2.png")

    p = sub.add_parser("plot-labels", help="label distribution plot")
    p.add_argument("--config", help="JSON config path")
    p.add_argument("--out", default="labels.png")

    p = sub.add_parser("plot-data", help="dataset visualizer: per-image "
                       "values vs group averages (Plot_Original_Data)")
    p.add_argument("--config", help="JSON config path")
    p.add_argument("--freq", default="50HZ_Bm")
    p.add_argument("--out", default="original_data_{freq}.png")
    p.add_argument("--params", action="store_true",
                   help="also write the labels-vs-parameters twin-axis view")

    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd in ("train", "test"):
        from .harness import run
        return run(_build_cfg(args), mode=cmd, verbose=True,
                   device=args.device)
    if cmd == "heatmap":
        from .harness import heatmap_target
        cfg = _build_cfg(args)
        return {freq: heatmap_target(cfg, freq, layers=args.layers,
                                     device=args.device)
                for freq in cfg.frequencies}
    if cmd == "memory":
        from .tools.monitor import monitor_loop
        monitor_loop()
    elif cmd == "pickup":
        from .tools.prep import pick_up_data
        n = pick_up_data(args.in_path, args.out_path)
        print(f"wrote {args.out_path} ({n} outlier cells dropped)")
    elif cmd == "plot-records":
        from .tools.plots import plot_records
        return _draw(args.out, plot_records, args.records, args.out)
    elif cmd == "model-plot":
        from .tools.model_plot import plot_model_structure
        return _draw(args.out, plot_model_structure, _build_cfg(args),
                     args.out)
    elif cmd == "save-config":
        save_config(_build_cfg(args), args.out)
        print(f"wrote {args.out}")
    elif cmd == "sweep":
        return _sweep(args)
    elif cmd == "compare":
        return _compare(args)
    elif cmd == "plot-labels":
        from .data.labels import LabelTable
        from .tools.plots import plot_label_distribution
        lt = LabelTable.load(_load_cfg(args).data.excel_labels)
        return _draw(args.out, plot_label_distribution,
                     {f: [v for v in lt.target_values(f) if v is not None]
                      for f in FREQUENCIES}, args.out)
    elif cmd == "plot-data":
        return _plot_data(args)
    return None


def _draw(out, plot, *args):
    """plot(*args), which writes ``out``, and a line that says so; where
    matplotlib is not installed, a line that says that instead, and 1."""
    try:
        plot(*args)
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print(f"not written ({out}): matplotlib is not installed")
        return 1
    print(f"wrote {out}")
    return None


def _sweep(args):
    """The ``sweep`` subcommand: the grid of ``--lr`` x ``--dropout`` x
    ``--seeds`` x ``--hidden`` for each target; returns {freq: summary}."""
    from .train.sweep import grid_points, run_sweep, write_summary

    cfg = _build_cfg(args)

    def split(s, t):
        return tuple(t(x) for x in s.split(",")) if s else (None,)

    points = grid_points(split(args.lr, float), split(args.dropout, float),
                         split(args.seeds, int) or (0,),
                         split(args.hidden, int))
    out = {}
    for freq in cfg.frequencies:
        out[freq] = run_sweep(cfg, freq, points, epochs=cfg.train.epochs,
                              device=args.device)
        path = write_summary(out[freq], cfg.result_dir)
        print(f"{freq}: best {out[freq]['best']} -> {path}")
    return out


def _compare(args):
    """The ``compare`` subcommand: R² against the frequency for one
    property's Predictions_Metrics sheets and its baselines; 1 where there
    is no sheet."""
    import os

    from .tools.plots import plot_compare_r2
    metrics_by_freq = {}
    for f in FREQUENCIES:
        path = os.path.join(args.metrics_dir,
                            f"Predictions_Metrics_{f}.xlsx")
        if f.endswith(args.prop) and os.path.exists(path):
            metrics_by_freq[f] = path
    if not metrics_by_freq:
        print(f"no Predictions_Metrics files for {args.prop} in "
              f"{args.metrics_dir}")
        return 1
    return _draw(args.out, plot_compare_r2, metrics_by_freq, args.glcm_dir,
                 args.prop, args.out)


def _plot_data(args):
    """The ``plot-data`` subcommand: one target's values against the group
    averages, and with ``--params`` against the scaled process
    parameters."""
    import numpy as np

    from .data.labels import LabelTable, ProcessTable, standard_scale
    from .tools.plots import (plot_labels_vs_parameters,
                              plot_values_vs_group_average)
    cfg = _load_cfg(args)
    values = LabelTable.load(cfg.data.excel_labels).target_values(args.freq)
    out = args.out.format(freq=args.freq)
    rc = _draw(out, plot_values_vs_group_average, values, args.freq, out)
    if args.params:
        pt = ProcessTable.load(cfg.data.excel_process)
        per_piece = np.array([pt.group_params(g) for g in range(len(pt.rows))
                              for _ in range(5)][:len(values)])
        pout = out.replace(".png", "_params.png")
        rc = _draw(pout, plot_labels_vs_parameters, values,
                   standard_scale(per_piece)[0], args.freq, pout) or rc
    return rc


if __name__ == "__main__":
    main()
