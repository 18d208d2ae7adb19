"""Multi-target trainer (transformer_stm_tpu/train/multi.py): the target
family, or the repeats of one target ("(many)" mode), trained as T slots
over one shared uint8 image corpus that lives on the device.

    tr = MultiTargetTrainer(cfg, [("50HZ_Bm", 0, None), ("50HZ_Hc", 1, None)],
                            mlp_impl="pallas", device="cuda")
    tr.fit(epochs=1000, checkpoint_dir=chunk_checkpoint_dir(cfg, freqs))
    tr.export()

The protocol is the JAX trainer's, slot by slot (:58-220):

- each step gathers the slot's batch from the corpus on the device (/255
  there); labels and process rows come through ``rows // layers``;
- every slot pads to the same ``steps_per_epoch = ceil(rows_max / B) +
  extra_steps``: positions n_train..rows_max hold copies of the slot's first
  unshuffled train row, positions past rows_max copies of its first shuffled
  row; the pad rows enter the BatchNorm batch statistics and the loss masks
  them out;
- a fully masked step is a bit-exact no-op for that slot: it is skipped,
  so parameters, BatchNorm state, Adam moments and the Adam count stay as
  they were;
- per-slot lr = lr * lr_scale[t] * 0.8^floor(epoch / 50), in float32;
- validation every epoch at ``val_batch = min(512, max(B, ceil(max n_val /
  4)))`` through the evaluation path (attention_small and the inference
  fused_mlp);
- records: one row per epoch and slot, [epoch, loss, mae, val_loss,
  val_mae, lr * scale].

Each slot's init, shuffle and dropout come from that slot's seed alone
(init from ``torch.Generator().manual_seed(seed)`` as ``TrainLoop`` does,
shuffle and dropout from ``_seed(seed, stream, ...)``), never from its
index, so two slots with the same seed train bit for bit alike.

Design: T per-slot ``CvT`` modules and ``AdamState``s; within each step
index the slots' steps run one after another through the single-target
``make_train_step``.  JAX vmaps the step over the slots (:174); batching
the slots into one launch is a speed question for a later change.  JAX's
``_mlp_train_bn_for_width`` and ``TSTM_MLP_TRAIN_BN`` existed only for
Mosaic's VMEM limit under vmap and are not carried over: the CUDA kernels'
tiles are their own constants (``kernels/fused_mlp.TRAIN_BWD_TILE``).
``remat`` is accepted and changes nothing (``models/cvt.cvt_forward``).
``augment`` (a ``data.augment.AugmentConfig``) augments each slot's batch
with that slot's own draws, from its step generator (JAX :86-94);
``cfg.train.compute_dtype="bfloat16"`` trains and validates in bfloat16
with float32 parameters and metrics (:81, :98, :115).  ``fit(watchdog=...)``
arms a ``train.watchdog.HangWatchdog`` deadline around the corpus upload,
each chunk of epochs and each checkpoint (:432-514); each of those ends in a
synchronisation with the card, so that a wedged launch trips it.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from contextlib import nullcontext
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.images import decode_corpus
from ..data.labels import LabelTable, ProcessTable, build_target_arrays
from ..data.split import train_val_split
from ..harness import _paths, _spec_for
from ..models.cvt import cvt_forward, init_cvt
from ..ops.common import use_true_f32
from .checkpoint import (adam_from_jax, latest_checkpoint, load_checkpoint,
                         load_into, save_checkpoint, save_stacked_checkpoint,
                         take_slot, to_jax_params)
from .loop import _DROPOUT, _SHUFFLE, _seed, compute_dtype, make_train_step
from .metrics import RecordsWriter
from .optimizer import adam_init, lr_at_epoch

MLP_IMPLS = ("xla", "pallas", "flash")


def _pad_rows(rows_list, width: int) -> np.ndarray:
    """(T, width) int64: each slot's rows, padded with its first row."""
    out = np.zeros((len(rows_list), width), np.int64)
    for i, r in enumerate(rows_list):
        out[i, :len(r)] = r
        if len(r) < width:
            out[i, len(r):] = r[0] if len(r) else 0
    return out


class MultiTargetTrainer:
    """targets: list of (freq, seed, time_suffix); repeated freqs with
    different seeds give the "(many)" repeat mode.  ``lr_scales``: optional
    per-slot multipliers of cfg.train.learning_rate.  ``mlp_impl`` goes to
    every block's MLP in training, as JAX's trainer passes it (:100):
    "pallas" and "flash" (the JAX names) train the MLPs through the fused
    training kernel, "xla" through the plain MLP.  ``corpus``: the decoded
    corpus (n_specimens, L, H, W) uint8, else ``decode_corpus(cfg.data)``."""

    def __init__(self, cfg: ExperimentConfig,
                 targets: Sequence[Tuple[str, int, Optional[int]]],
                 impl: str = "auto", epochs_per_call: int = 1,
                 corpus: Optional[np.ndarray] = None,
                 extra_steps: int = 0, remat: bool = True,
                 mlp_impl: str = "xla",
                 lr_scales: Optional[Sequence[float]] = None,
                 augment=None, device="cuda"):
        if mlp_impl not in MLP_IMPLS:
            raise ValueError(f"unknown mlp_impl {mlp_impl!r}, want "
                             f"{MLP_IMPLS}")
        self.cfg = cfg
        self.targets = list(targets)
        self.spec = _spec_for(cfg)
        self.impl = impl
        self.mlp_impl = mlp_impl
        self.remat = remat
        self.epochs_per_call = epochs_per_call
        tc = cfg.train
        L = cfg.data.image_layers
        labels = LabelTable.load(cfg.data.excel_labels)
        procs = ProcessTable.load(cfg.data.excel_process)
        if corpus is None:
            corpus = np.asarray(decode_corpus(cfg.data))
        n_spec = corpus.shape[0]
        self.corpus_np = corpus.reshape(n_spec * L, corpus.shape[2],
                                        corpus.shape[3], 1)

        y_spec, proc_spec, tr_rows, va_rows, n_tr, n_va = [], [], [], [], [], []
        for freq, _, _ in self.targets:
            t = build_target_arrays(cfg.data, freq, labels, procs)
            valid = np.asarray(t["valid_indices"], np.int64)
            train_r, val_r = train_val_split(valid, t["count"], L)
            # per-target replicated rows -> corpus rows
            to_corpus = lambda r: valid[r // L] * L + (r % L)
            tr_rows.append(to_corpus(np.asarray(train_r)))
            va_rows.append(to_corpus(np.asarray(val_r)))
            n_tr.append(len(train_r))
            n_va.append(len(val_r))
            ys = np.zeros((n_spec,), np.float32)
            ys[valid] = np.asarray(t["labels"], np.float32)[::L][:len(valid)]
            ps = np.zeros((n_spec, t["proc_scaled"].shape[1]), np.float32)
            ps[valid] = np.asarray(t["proc_scaled"],
                                   np.float32)[::L][:len(valid)]
            y_spec.append(ys)
            proc_spec.append(ps)

        B = tc.batch_size
        self.rows_max = max(n_tr)
        # extra_steps appends fully masked (skipped) steps to every epoch
        self.steps_per_epoch = -(-self.rows_max // B) + extra_steps
        self.val_batch = min(512, max(B, -(-max(n_va) // 4)))
        self.n_val_steps = -(-max(n_va) // self.val_batch)
        self.y_spec = np.stack(y_spec)
        self.proc_spec = (np.stack(proc_spec) if cfg.inputs != "img"
                          else None)
        self.n_train = np.asarray(n_tr, np.int64)
        self.n_val = np.asarray(n_va, np.int64)
        self.train_rows = _pad_rows(tr_rows, self.rows_max)
        self.val_rows = _pad_rows(va_rows, self.n_val_steps * self.val_batch)

        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_true_f32()
        self.models = [init_cvt(self.spec, torch.Generator().manual_seed(
            int(seed)), device=self.device) for _, seed, _ in self.targets]
        self.opts = [adam_init(m) for m in self.models]
        self.epoch = 0
        self.records = [[] for _ in self.targets]
        if lr_scales is None:
            self.lr_scales_np = np.ones(len(self.targets), np.float32)
        else:
            if len(lr_scales) != len(self.targets):
                raise ValueError(f"{len(lr_scales)} lr_scales for "
                                 f"{len(self.targets)} targets")
            self.lr_scales_np = np.asarray(lr_scales, np.float32)
        self._step = make_train_step(tc, impl=impl, mlp_impl=mlp_impl,
                                     augment=augment)
        self._dev = None

    # -- device data -------------------------------------------------------

    def _upload(self):
        if self._dev is None:
            f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                self.device)
            self._dev = {
                "corpus": torch.from_numpy(np.ascontiguousarray(
                    self.corpus_np)).to(self.device),
                "y": f32(self.y_spec),
                "proc": (f32(self.proc_spec) if self.proc_spec is not None
                         else None),
                "val_rows": torch.from_numpy(self.val_rows).to(self.device),
            }
        return self._dev

    def _batch(self, t: int, rows):
        """Slot t's batch for corpus rows (B,) on the device: (images f32
        in [0, 1], proc or None, labels)."""
        dev = self._upload()
        sidx = rows // self.cfg.data.image_layers
        return (dev["corpus"][rows].to(torch.float32) / 255.0,
                dev["proc"][t][sidx] if dev["proc"] is not None else None,
                dev["y"][t][sidx])

    def lr_per_slot(self, epoch: int) -> np.ndarray:
        """(T,) float32: lr * lr_scale * decay^floor(epoch / every)."""
        tc = self.cfg.train
        decay = np.power(np.float32(tc.lr_decay), np.float32(
            np.floor(np.float32(epoch) / np.float32(tc.lr_decay_every))))
        return np.float32(tc.learning_rate) * self.lr_scales_np * decay

    def epoch_plan(self, epoch: int):
        """(rows (T, steps, B) int64 and mask (T, steps, B) f32 on the
        device, live (T, steps) bool on the host): each slot's train rows
        shuffled from (its seed, epoch), real rows first, then the pads."""
        B, S = self.cfg.train.batch_size, self.steps_per_epoch
        T = len(self.targets)
        idx = np.empty((T, S * B), np.int64)
        for t, (_, seed, _) in enumerate(self.targets):
            n, rows = int(self.n_train[t]), self.train_rows[t]
            gen = torch.Generator().manual_seed(
                _seed(int(seed), _SHUFFLE, epoch))
            perm = torch.randperm(n, generator=gen).numpy()
            order = np.concatenate([rows[:n][perm], rows[n:]])
            idx[t, :self.rows_max] = order
            idx[t, self.rows_max:] = order[0]
        mask = (np.arange(S * B)[None, :] < self.n_train[:, None]).astype(
            np.float32).reshape(T, S, B)
        to = lambda a: torch.from_numpy(a).to(self.device)
        return to(idx.reshape(T, S, B)), to(mask), mask.sum(-1) > 0

    # -- steps -------------------------------------------------------------

    def train_step(self, epoch: int, s: int, plan, acc, lr=None):
        """Step index s of ``epoch`` for every live slot, one after another;
        adds [se, ae, n] of each slot to ``acc`` (T, 3).  A slot whose step
        holds no real row is skipped: a bit-exact no-op."""
        rows, mask, live = plan
        lr = self.lr_per_slot(epoch) if lr is None else lr
        for t, (_, seed, _) in enumerate(self.targets):
            if not live[t, s]:
                continue
            imgs, proc, yy = self._batch(t, rows[t, s])
            gen = torch.Generator(device=self.device).manual_seed(
                _seed(int(seed), _DROPOUT, epoch, s))
            m = self._step(self.models[t], self.opts[t],
                           (imgs, proc, yy, mask[t, s]), gen, float(lr[t]))
            acc[t] += torch.stack([m["se"], m["ae"], m["n"]])

    def validate(self):
        """(T, 3) [sum se, sum ae, n] over each slot's validation rows,
        through the evaluation path."""
        dev = self._upload()
        VB = self.val_batch
        pos = np.arange(self.n_val_steps * VB)
        with torch.inference_mode():
            acc = torch.zeros(len(self.targets), 3, device=self.device)
            for s in range(self.n_val_steps):
                for t, model in enumerate(self.models):
                    real = pos[s * VB:(s + 1) * VB] < self.n_val[t]
                    if not real.any():
                        continue
                    m = torch.from_numpy(real.astype(np.float32)).to(
                        self.device)
                    imgs, proc, yy = self._batch(
                        t, dev["val_rows"][t, s * VB:(s + 1) * VB])
                    dtype = compute_dtype(self.cfg.train)
                    d = cvt_forward(
                        model, imgs.to(dtype),
                        proc.to(dtype) if proc is not None else None,
                        impl=self.impl).reshape(-1).float() - yy
                    acc[t] += torch.stack([(d.square() * m).sum(),
                                           (d.abs() * m).sum(), m.sum()])
        return acc

    def run_epoch(self, epoch: int):
        """Trains and validates one epoch -> (train acc, val acc), (T, 3)
        device tensors, unfetched."""
        plan = self.epoch_plan(epoch)
        lr = self.lr_per_slot(epoch)
        acc = torch.zeros(len(self.targets), 3, device=self.device)
        for s in range(self.steps_per_epoch):
            self.train_step(epoch, s, plan, acc, lr)
        return acc, self.validate()

    # -- checkpointing (stacked, resume-safe) ------------------------------

    def save(self, path: str) -> str:
        return save_stacked_checkpoint(
            path, self.models, self.opts, step=self.epoch,
            metadata={"targets": [t[0] for t in self.targets],
                      "records": self.records})

    def load(self, path: str) -> bool:
        """Resumes from the newest stacked checkpoint under ``path``, of
        either package: each slot's parameters, BatchNorm state and Adam
        state with its own count, the epoch and the records."""
        ck = latest_checkpoint(path)
        if ck is None:
            return False
        params, state, opt, step = load_checkpoint(ck)
        n = np.asarray(params["final"]["kernel"]).shape[0]
        if n != len(self.targets):
            raise ValueError(f"{ck} holds {n} slots, the trainer "
                             f"{len(self.targets)}")
        for i, model in enumerate(self.models):
            load_into(model, take_slot(params, i), take_slot(state, i))
            if opt is not None:
                self.opts[i] = adam_from_jax(take_slot(opt, i), model,
                                             self.device)
        self.epoch = int(step)
        with open(ck[:-4] + ".json") as f:
            meta = json.load(f)
        if "records" in meta:
            self.records = meta["records"]
        return True

    def target_params(self, i: int):
        """Slot i as (params, state) numpy trees in the JAX layout and its
        AdamState."""
        params, state = to_jax_params(self.models[i])
        return params, state, self.opts[i]

    # -- main loop ---------------------------------------------------------

    def fit(self, epochs: int, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100, verbose: bool = True,
            log_every: int = 1, watchdog=None):
        """Trains from ``self.epoch`` to ``epochs``, ``epochs_per_call``
        epochs per metrics fetch; checkpoints at multiples of
        ``checkpoint_every`` and at the end.  ``log_every`` is accepted as
        in JAX, which prints once per call.

        ``watchdog``: a ``train.watchdog.HangWatchdog``, which is started
        and left running for the caller's later dispatches, or True, which
        builds one from TSTM_WATCHDOG_S and stops it at the end.  Its
        deadlines: "corpus upload / device init" (the upload, then a
        synchronise), "multi-epoch @ {epoch}" (a chunk of epochs up to the
        fetch of its metrics) and "checkpoint @ {epoch}" (the stacked save,
        whose copies to the host wait for the card)."""
        from .watchdog import HangWatchdog, watchdog_from_env

        owns_watchdog = watchdog is True
        if watchdog is True:
            watchdog = watchdog_from_env()
        if isinstance(watchdog, HangWatchdog):
            watchdog.start()
        wd_dispatch = (watchdog.dispatch if watchdog
                       else (lambda label: nullcontext()))

        # the first contact with the card: a wedge at device init shows here
        with wd_dispatch("corpus upload / device init"):
            self._upload()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        E = self.epochs_per_call
        while self.epoch < epochs:
            n_now = min(E, epochs - self.epoch)
            t0 = time.time()
            with wd_dispatch(f"multi-epoch @ {self.epoch}"):
                accs = [self.run_epoch(self.epoch + e) for e in range(n_now)]
                # the fetch waits for the card: the deadline covers the
                # chunk's kernels, not only their launches
                tr_acc = torch.stack([a for a, _ in accs]).cpu().numpy()
                va_acc = torch.stack([v for _, v in accs]).cpu().numpy()
            dt = time.time() - t0
            tc = self.cfg.train
            for e in range(n_now):
                ep = self.epoch + e
                lr = lr_at_epoch(tc.learning_rate, ep, tc.lr_decay,
                                 tc.lr_decay_every)
                for ti in range(len(self.targets)):
                    se, ae, n = tr_acc[e, ti]
                    vse, vae, vn = va_acc[e, ti]
                    self.records[ti].append(
                        [ep, float(se / n), float(ae / n), float(vse / vn),
                         float(vae / vn), lr * float(self.lr_scales_np[ti])])
            self.epoch += n_now
            if verbose:
                mean_vl = float(np.mean(va_acc[-1, :, 0] / va_acc[-1, :, 2]))
                print(f"epoch {self.epoch}/{epochs} "
                      f"({dt / n_now:.1f}s/epoch, T={len(self.targets)}) "
                      f"mean val_loss {mean_vl:.4f}", flush=True)
            if checkpoint_dir and (self.epoch % checkpoint_every == 0
                                   or self.epoch >= epochs):
                t1 = time.time()
                with wd_dispatch(f"checkpoint @ {self.epoch}"):
                    self.save(checkpoint_dir)
                if verbose:
                    print(f"  checkpoint @ {self.epoch} "
                          f"({time.time() - t1:.0f}s)", flush=True)
        # only a watchdog that fit() built is stopped: a caller's keeps
        # guarding the dispatches after training (export, evaluation)
        if owns_watchdog and isinstance(watchdog, HangWatchdog):
            watchdog.stop()
        return self

    # -- artifact export ---------------------------------------------------

    def export(self, verbose: bool = True):
        """Per-target weights and records in the reference layout
        (``harness._paths``)."""
        outs = {}
        for i, (freq, seed, tsuf) in enumerate(self.targets):
            paths = _paths(self.cfg, freq, tsuf)
            save_checkpoint(paths["weights"], self.models[i], self.opts[i],
                            step=self.epoch,
                            metadata={"freq": freq, "seed": seed,
                                      "config": self.cfg.inputs})
            rec = RecordsWriter()
            for row in self.records[i]:
                rec.log(int(row[0]), row[1], row[2], row[3], row[4], row[5])
            rec.write(paths["records"])
            outs[(freq, tsuf)] = paths
            if verbose:
                print(f"exported {freq}"
                      + (f" (run {tsuf})" if tsuf else ""), flush=True)
        return outs


def chunk_checkpoint_dir(cfg: ExperimentConfig,
                         targets: Sequence[str]) -> str:
    """Checkpoint dir of a run keyed by its exact target set, so that runs
    of different subsets never resume each other's stacks."""
    sig = hashlib.sha1("|".join(targets).encode()).hexdigest()[:10]
    return os.path.join(cfg.result_dir, "Weight", cfg.variant_dir,
                        f"multi_run_{sig}.ckpts")
