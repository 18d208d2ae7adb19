"""The "(many)" repeat-run variance study (transformer_stm_tpu/train/many.py
:26-75, scripts/train_many.py).

The reference's "(many)" trainer variants repeat every training 8 times
with fresh random init (models/CvT(Par)(many).py:499-505, artifacts
suffixed ``_{time}``).  Here the repeats train together as slots of the
multi-target trainer (train/multi.py), over one corpus on the card, with
per-slot init seeds and one protocol; then each repeat is evaluated through
the single-target harness (``harness.test_target``) and a mean/std/min/max
summary is written to ``{result_dir}/cvt_many_{freq}_summary.json``.

    python -m transformer_stm_tpu_torch.train.many [freq] [epochs] [repeats]

runs ``scripts/train_many.py``'s configuration (img+par, batch 128, bf16
compute, ``Result/``) on the card, with its environment: TSTM_WATCHDOG_S
(the hang watchdog's deadline, '0' disables), TSTM_MULTI_IMPL (attention,
default "small") and TSTM_MULTI_MLP (the training MLP, default "pallas").
It resumes from ``Result/Weight/{variant}/many_{freq}.ckpts``, so it is the
command the supervisor respawns (train/supervisor.py).
"""

from __future__ import annotations

import json
import os
import sys
import time as _time
from contextlib import nullcontext

import numpy as np


def run_many(cfg, freq: str, epochs: int, repeats: int = 8, *,
             impl: str = "small", mlp_impl: str = "pallas",
             watchdog=None, checkpoint_every: int = 50,
             verbose: bool = True, device="cuda") -> dict:
    """Trains ``repeats`` seeds of ``freq`` as the slots of one trainer
    (targets ``(freq, 1000 + t, t)``, t = 1..repeats), resuming from its
    stacked checkpoints; exports each repeat's ``_{t}`` artifacts,
    evaluates each, and writes and returns the variance summary.
    ``watchdog``: a caller's ``HangWatchdog`` (or None), whose deadlines
    also cover the trainer's set-up, the export and each evaluation."""
    from ..harness import test_target
    from .multi import MultiTargetTrainer

    targets = [(freq, 1000 + t, t) for t in range(1, repeats + 1)]
    wd_ctx = (watchdog.dispatch if watchdog is not None
              else (lambda label: nullcontext()))
    t0 = _time.time()
    with wd_ctx("trainer init / first device contact"):
        tr = MultiTargetTrainer(cfg, targets, epochs_per_call=10,
                                impl=impl, mlp_impl=mlp_impl, device=device)
    ckdir = os.path.join(cfg.result_dir, "Weight", cfg.variant_dir,
                         f"many_{freq}.ckpts")
    if tr.load(ckdir):
        if verbose:
            print(f"resumed at epoch {tr.epoch}", flush=True)
    tr.fit(epochs=epochs, checkpoint_dir=ckdir,
           checkpoint_every=checkpoint_every, verbose=verbose,
           watchdog=watchdog)
    if verbose:
        print(f"trained {repeats} repeats in "
              f"{(_time.time() - t0) / 60:.1f} min", flush=True)
    with wd_ctx("weight export"):
        tr.export(verbose=verbose)

    rows = []
    for _, seed, tsuf in targets:
        with wd_ctx(f"eval time={tsuf}"):
            res = test_target(cfg, freq, time=tsuf, verbose=verbose,
                              device=device)
        rows.append({"time": tsuf, "seed": seed, "r2": res["r2"],
                     "mse": res["mse"], "mae": res["mae"]})
    arr = {k: np.array([r[k] for r in rows]) for k in ("r2", "mse", "mae")}
    summary = {
        "freq": freq, "epochs": epochs, "repeats": repeats,
        "runs": rows,
        "stats": {k: {"mean": float(v.mean()),
                      "std": float(v.std(ddof=1)) if len(rows) > 1 else 0.0,
                      "min": float(v.min()), "max": float(v.max())}
                  for k, v in arr.items()},
    }
    out = os.path.join(cfg.result_dir, f"cvt_many_{freq}_summary.json")
    with open(out, "w") as fh:
        json.dump(summary, fh, indent=1)
    return summary


def main(argv=None) -> dict:
    """``scripts/train_many.py``'s command line: [freq] [epochs] [repeats]
    (defaults 50HZ_Bm, 1000, 8) on the card.  Prints the summary's stats
    and returns the summary."""
    from ..config import ExperimentConfig, TrainConfig
    from .watchdog import watchdog_from_env

    argv = sys.argv[1:] if argv is None else list(argv)
    freq = argv[0] if len(argv) > 0 else "50HZ_Bm"
    epochs = int(argv[1]) if len(argv) > 1 else 1000
    repeats = int(argv[2]) if len(argv) > 2 else 8
    cfg = ExperimentConfig(
        inputs="img+par",
        frequencies=(freq,),
        train=TrainConfig(epochs=epochs, batch_size=128,
                          compute_dtype="bfloat16"),
        result_dir="Result",
    )
    wd = watchdog_from_env(default_timeout=720.0)
    if wd is not None:
        wd.start()
    summary = run_many(
        cfg, freq, epochs, repeats,
        impl=os.environ.get("TSTM_MULTI_IMPL", "small"),
        mlp_impl=os.environ.get("TSTM_MULTI_MLP", "pallas"),
        watchdog=wd)
    print(json.dumps(summary["stats"], indent=1))
    return summary


if __name__ == "__main__":
    main()
