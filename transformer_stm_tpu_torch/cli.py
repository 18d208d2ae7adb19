"""Command line of the port (transformer_stm_tpu/cli.py:27-149, 171-174):
train and test every configured target, or write the config JSON.

  python -m transformer_stm_tpu_torch.cli train --config cfg.json [--freq ...]
  python -m transformer_stm_tpu_torch.cli test  --config cfg.json [--freq ...]
  python -m transformer_stm_tpu_torch.cli save-config --out cfg.json

Every setting comes from one JSON config (``--config``, written by either
package) with command-line overrides; a 512px run is set up through the
config's ``model`` and ``data`` sizes, as in the JAX CLI.  ``--device``
(default ``cuda``) picks where the model runs; PyTorch needs it, JAX does
not.  The JAX CLI's other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from .config import (ExperimentConfig, FREQUENCIES, load_config,
                     save_config)


def _build_cfg(args) -> ExperimentConfig:
    cfg = load_config(args.config) if args.config else ExperimentConfig()
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
    p = sub.add_parser("save-config", help="write the config JSON")
    _add_common(p)
    p.add_argument("--out", default="config.json")
    args = ap.parse_args(argv)

    cfg = _build_cfg(args)
    if args.cmd in ("train", "test"):
        from .harness import run
        return run(cfg, mode=args.cmd, verbose=True, device=args.device)
    save_config(cfg, args.out)
    print(f"wrote {args.out}")
    return None


if __name__ == "__main__":
    main()
