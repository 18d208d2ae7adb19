"""Training and evaluation loop (transformer_stm_tpu/train/loop.py).

The reference's model.fit harness: Adam on the MSE with MAE as a metric,
per-epoch shuffling and validation, lr x0.8 every 50 epochs, per-epoch
records, mid-run checkpoints and resume from ``loop.epoch``.

    loop = TrainLoop(spec, cfg, device="cuda")
    result = loop.fit(images_u8, proc, labels, val=(vi, vp, vl))
    preds = loop.predict(images_u8, proc)          # np.float32 (N,)

As on the JAX loop's device-data path, the uint8 images go to the device
once and each step gathers its batch there (/255 on the device); the train
metrics are summed on the device and fetched once per epoch.  Every batch
has the configured size: the last one of an epoch is padded with copies of
train row 0, which the loss and the metrics mask out.  The pad rows do enter
the BatchNorm batch statistics of that batch, the JAX loop's deliberate
deviation from Keras (loop.py:246-258), kept here.  The shuffle comes from a
CPU generator seeded from (cfg.seed, epoch) and the dropout from a device
generator seeded from (cfg.seed, step index), so a run is reproducible.  On
a CUDA device the loop computes in true f32 (``use_true_f32``).

``cfg.compute_dtype="bfloat16"`` casts the images and the process
parameters to bfloat16 after the augmentation, as the JAX step does
(loop.py:60-70); the parameters, the Adam state, the BatchNorm statistics,
the MSE and the metrics stay float32, and validation runs in bfloat16 too.
``augment`` (a ``data.augment.AugmentConfig``) augments each batch on the
device, its draws taken from the step's dropout generator before the
dropout's.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import CvTSpec, TrainConfig
from ..data.augment import augment_batch
from ..data.images import normalize_images
from ..models.cvt import CvT, cvt_forward, init_cvt
from ..ops.common import use_true_f32
from .checkpoint import (adam_from_jax, load_checkpoint, load_into,
                         save_checkpoint)
from .metrics import RecordsWriter
from .optimizer import AdamState, adam_init, adam_update, lr_at_epoch

# Stream ids that keep the seeds of the shuffle and the dropout apart.
_SHUFFLE, _DROPOUT = 0, 1


def _seed(*words: int) -> int:
    """A 63-bit seed mixed from non-negative integers."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _masked_mse_mae(pred, y, mask):
    """(mse, mae, sum of squared errors, sum of absolute errors) over the
    rows where mask is 1: the epoch metrics stay exact when the last batch
    is padded."""
    pred = pred.reshape(-1).float()
    err = pred - y.float()
    n = mask.sum().clamp_min(1.0)
    se = (err.square() * mask).sum()
    ae = (err.abs() * mask).sum()
    return se / n, ae / n, se, ae


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    """The forward's type of ``cfg.compute_dtype``."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


def make_train_step(cfg: TrainConfig, impl: str = "auto", mlp_impl=None,
                    augment=None):
    """Returns step(model, opt, batch, generator, lr) -> metrics, which
    updates the model's parameters, BatchNorm statistics and ``opt`` in
    place.  batch = (images float in [0, 1], proc or None, labels, mask);
    metrics holds device scalars loss, mae, se, ae, n.  ``generator`` draws
    the augmentation, then the dropout (it may be None when every rate is 0
    and ``augment`` is None); ``mlp_impl="pallas"`` trains the MLPs through
    the fused training kernel.  The forward runs in ``cfg.compute_dtype``."""
    dtype = compute_dtype(cfg)

    def step(model: CvT, opt: AdamState, batch, generator, lr: float):
        images, proc, labels, mask = batch
        if augment is not None:
            images = augment_batch(images, augment, generator)
        images = images.to(dtype)
        proc = proc.to(dtype) if proc is not None else None
        model.requires_grad_(True)
        params = list(model.parameters())
        with torch.enable_grad():
            out = cvt_forward(model, images, proc, train=True,
                              generator=generator, impl=impl,
                              mlp_impl=mlp_impl)
            loss, mae_v, se, ae = _masked_mse_mae(out, labels, mask)
            grads = torch.autograd.grad(loss, params)
        adam_update(grads, opt, params, lr, weight_decay=cfg.weight_decay)
        return {"loss": loss.detach(), "mae": mae_v.detach(),
                "se": se.detach(), "ae": ae.detach(), "n": mask.sum()}

    return step


def _pad(idx: np.ndarray, bs: int):
    """(idx padded with row 0 to bs, mask of the real rows)."""
    real = len(idx)
    mask = np.zeros(bs, np.float32)
    mask[:real] = 1.0
    if real < bs:
        idx = np.concatenate([idx, np.zeros(bs - real, np.int64)])
    return idx, mask


def _to_device(device, images, proc, labels=None):
    """The dataset on the device: uint8 images as they are, f32 rest."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (torch.from_numpy(np.ascontiguousarray(images)).to(device),
            f32(proc) if proc is not None else None,
            f32(labels) if labels is not None else None)


class TrainLoop:
    """Single-device training on ``device`` (the card unless the caller
    asks for the CPU).  ``model`` defaults to ``init_cvt`` from cfg.seed;
    ``callbacks`` are called as cb(loop, epoch, metrics dict) after each
    epoch."""

    def __init__(self, spec: CvTSpec, cfg: TrainConfig = TrainConfig(),
                 impl: str = "auto", device="cuda",
                 model: Optional[CvT] = None, callbacks=None, augment=None):
        self.spec = spec
        self.cfg = cfg
        self.impl = impl
        self.callbacks = callbacks or []
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_true_f32()
        if model is None:
            model = init_cvt(spec, torch.Generator().manual_seed(cfg.seed),
                             device=self.device)
        self.model = model.to(self.device)
        self.opt = adam_init(self.model)
        self.epoch = 0
        self._step = make_train_step(cfg, impl=impl, augment=augment)

    # -- data feeding ------------------------------------------------------

    def _permutation(self, n: int, epoch: int) -> np.ndarray:
        gen = torch.Generator().manual_seed(
            _seed(self.cfg.seed, _SHUFFLE, epoch))
        return torch.randperm(n, generator=gen).numpy()

    def _batches(self, n: int, epoch: int):
        """Shuffled (idx, mask) pairs of the batch size; the last batch is
        padded with row 0 and its pad rows masked."""
        bs = self.cfg.batch_size
        perm = self._permutation(n, epoch)
        for s in range(0, n, bs):
            yield _pad(perm[s:s + bs], bs)

    # -- API ---------------------------------------------------------------

    def fit(self, images, proc, labels, val=None,
            epochs: Optional[int] = None, records=None,
            verbose: bool = True, checkpoint_dir: Optional[str] = None):
        """Trains from ``self.epoch`` to ``epochs`` (default cfg.epochs).
        images: (N, H, W, C) uint8; proc: (N, P) or None; labels: (N,);
        val: (images, proc, labels) or None.  Returns {"model", "opt",
        "records"}."""
        cfg = self.cfg
        n = len(labels)
        epochs = epochs if epochs is not None else cfg.epochs
        records = records if records is not None else RecordsWriter()
        bs = cfg.batch_size
        steps_per_epoch = -(-n // bs)
        data = _to_device(self.device, images, proc, labels)
        val_dev = _to_device(self.device, *val) if val is not None else None

        for epoch in range(self.epoch, epochs):
            lr = float(np.float32(lr_at_epoch(
                cfg.learning_rate, epoch, cfg.lr_decay, cfg.lr_decay_every)))
            t0 = time.time()
            idxs, masks = zip(*self._batches(n, epoch))
            idx_d = torch.from_numpy(np.stack(idxs)).to(self.device)
            mask_d = torch.from_numpy(np.stack(masks)).to(self.device)
            acc = torch.zeros(3, device=self.device)
            for bi in range(len(idxs)):
                idx = idx_d[bi]
                batch = (normalize_images(data[0][idx]),
                         data[1][idx] if data[1] is not None else None,
                         data[2][idx], mask_d[bi])
                gen = torch.Generator(device=self.device).manual_seed(
                    _seed(cfg.seed, _DROPOUT,
                          epoch * steps_per_epoch + bi))
                m = self._step(self.model, self.opt, batch, gen, lr)
                acc += torch.stack([m["se"], m["ae"], m["n"]])
            tot_se, tot_ae, tot_n = acc.cpu().numpy()  # one fetch per epoch
            loss, mae_v = tot_se / tot_n, tot_ae / tot_n

            val_loss = val_mae = None
            if val_dev is not None:
                val_loss, val_mae = self._val_metrics(val_dev)

            records.log(epoch, loss, mae_v, val_loss, val_mae, lr)
            if verbose:
                msg = (f"epoch {epoch + 1}/{epochs} loss {loss:.4f} "
                       f"mae {mae_v:.4f}")
                if val_loss is not None:
                    msg += f" val_loss {val_loss:.4f} val_mae {val_mae:.4f}"
                print(msg + f" lr {lr:.2e} ({time.time() - t0:.1f}s)")
            for cb in self.callbacks:
                cb(self, epoch, {"loss": loss, "mae": mae_v,
                                 "val_loss": val_loss, "val_mae": val_mae})

            self.epoch = epoch + 1
            if (checkpoint_dir and cfg.checkpoint_every
                    and (epoch + 1) % cfg.checkpoint_every == 0):
                save_checkpoint(checkpoint_dir, self.model, self.opt,
                                step=self.epoch)

        return {"model": self.model, "opt": self.opt, "records": records}

    def _val_metrics(self, val_dev):
        """(mse, mae) over the validation set through the evaluation path,
        summed on the device and fetched once."""
        images, proc, labels = val_dev
        n, bs = len(labels), self.cfg.batch_size
        with torch.inference_mode():
            acc = torch.zeros(3, device=self.device)
            for s in range(0, n, bs):
                idx, mask = _pad(np.arange(s, min(s + bs, n)), bs)
                idx = torch.from_numpy(idx).to(self.device)
                mask = torch.from_numpy(mask).to(self.device)
                dtype = compute_dtype(self.cfg)
                pred = cvt_forward(
                    self.model, normalize_images(images[idx]).to(dtype),
                    proc[idx].to(dtype) if proc is not None else None,
                    impl=self.impl).reshape(-1).float()
                d = pred - labels[idx]
                acc += torch.stack([(d.square() * mask).sum(),
                                    (d.abs() * mask).sum(), mask.sum()])
            se, ae, cnt = acc.cpu().numpy()
        return float(se / cnt), float(ae / cnt)

    def load_checkpoint(self, path: str) -> None:
        """Resumes from a checkpoint of either package: parameters,
        BatchNorm state, Adam state (when saved) and ``epoch``."""
        params, state, opt, step = load_checkpoint(path)
        load_into(self.model, params, state)
        if opt is not None:
            self.opt = adam_from_jax(opt, self.model, self.device)
        self.epoch = int(step) if step is not None else self.epoch

    def predict(self, images, proc, batch_size: Optional[int] = None,
                exact: bool = False):
        """images: (N, H, W, C) uint8 or float; proc: (N, P) or None ->
        np.float32 (N,).  The last batch is padded to one shape with row 0,
        as the JAX loop pads it, and the pad rows dropped.

        The batches run in ``cfg.compute_dtype``, or in float32 with
        ``exact`` (the JAX keyword of the metrics sheet, harness.py:275;
        loop.py:175-176): on a CUDA device float32 is true f32
        (``use_true_f32``), so an exact prediction under a bfloat16 config
        equals the float32 config's."""
        dtype = torch.float32 if exact else compute_dtype(self.cfg)
        bs = batch_size or self.cfg.batch_size
        n = len(images)
        outs = []
        with torch.inference_mode():
            for s in range(0, n, bs):
                idx, _ = _pad(np.arange(s, min(s + bs, n)), bs)
                real = min(s + bs, n) - s
                x = normalize_images(
                    torch.from_numpy(np.ascontiguousarray(images[idx]))
                    .to(self.device)).to(dtype)
                p = (torch.from_numpy(np.asarray(proc[idx], np.float32))
                     .to(self.device, dtype) if proc is not None else None)
                out = cvt_forward(self.model, x, p, impl=self.impl)
                outs.append(out.reshape(-1)[:real].float().cpu().numpy())
        return np.concatenate(outs)
