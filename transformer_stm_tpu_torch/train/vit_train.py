"""ViT classification fine-tune (transformer_stm_tpu/train/vit_train.py:
25-223; BASELINE.json config 3: ViT-B/16 forward and backward, AdamW,
label smoothing).

    tr = ViTTrainer(spec, TrainConfig(compute_dtype="bfloat16",
                                      optimizer="adamw", weight_decay=0.05,
                                      label_smoothing=0.1,
                                      loss="softmax_xent"),
                    augment=AugmentConfig(), device="cuda")
    tr.fit(images_u8, labels, epochs=10, val_split=0.2,
           checkpoint_dir="ckpts")
    logits = tr.predict(images_u8)                 # np.float32 (N, classes)

As the JAX trainer: every batch has the configured size, the last one of an
epoch padded with row 0 and masked out of the loss and the accuracy; the
optional augmentation runs on the device in the step; the forward and
backward run in ``cfg.compute_dtype`` with float32 parameters, AdamW state
and loss; evaluation and ``predict`` run on float32 images, as JAX's
``_fwd`` does.  The init comes from a CPU generator seeded from cfg.seed
(``init_vit``), the shuffle of each epoch and the validation split from CPU
generators seeded from (cfg.seed, stream, epoch), the augmentation and
dropout of each step from a generator on the device seeded from (cfg.seed,
stream, epoch, step): a run is reproducible, though its draws are not the
JAX package's.  Checkpoints are in the JAX layout (params, AdamW moments,
epoch, and the records in the .json beside them), so either package
resumes the other's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig, ViTSpec
from ..data.augment import AugmentConfig, augment_batch
from ..data.images import normalize_images
from ..models.vit import ViT, init_vit, vit_forward
from ..ops.common import use_true_f32
from .checkpoint import (adam_from_jax, latest_checkpoint, load_checkpoint,
                         load_into, save_checkpoint)
from .loop import _DROPOUT, _SHUFFLE, _pad, _seed, compute_dtype
from .optimizer import AdamState, adam_init, adam_update, lr_at_epoch

_VAL_SPLIT = 2  # stream id of the validation split's permutation
RECORD_COLUMNS = ["epoch", "loss", "acc", "val_loss", "val_acc", "lr"]


def softmax_xent(logits, labels, num_classes: int,
                 label_smoothing: float = 0.0):
    """Per-sample cross-entropy in float32 with label smoothing: the target
    is 1 - s + s / C on the label and s / C elsewhere; labels int (B,)."""
    logits = logits.float()
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    onehot = F.one_hot(labels.long(), num_classes).float()
    targets = onehot * on + (1.0 - onehot) * off
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def make_vit_train_step(spec: ViTSpec, cfg: TrainConfig,
                        augment: Optional[AugmentConfig] = None,
                        impl: str = "auto"):
    """Returns step(model, opt, batch, generator, lr) -> metrics, which
    updates the model's parameters and ``opt`` (AdamW with
    ``cfg.weight_decay``) in place.  batch = (images float in [0, 1],
    labels int (B,), mask float (B,)); metrics holds device scalars loss
    and acc, means over the rows where mask is 1.  ``generator``, on the
    images' device, draws the augmentation, then the dropout (it may be
    None without either)."""
    dtype = compute_dtype(cfg)

    def step(model: ViT, opt: AdamState, batch, generator, lr: float):
        images, labels, mask = batch
        if augment is not None:
            images = augment_batch(images, augment, generator)
        model.requires_grad_(True)
        params = list(model.parameters())
        with torch.enable_grad():
            logits = vit_forward(model, images.to(dtype), train=True,
                                 generator=generator, impl=impl)
            per = softmax_xent(logits, labels, spec.num_classes,
                               cfg.label_smoothing)
            n = mask.sum().clamp_min(1.0)
            loss = (per * mask).sum() / n
            grads = torch.autograd.grad(loss, params)
        acc = ((logits.argmax(-1) == labels).float() * mask).sum() / n
        adam_update(grads, opt, params, lr, weight_decay=cfg.weight_decay)
        return {"loss": loss.detach(), "acc": acc}

    return step


class ViTTrainer:
    """The classification fine-tune on ``device`` (the card unless the
    caller asks for the CPU).  ``records`` holds one row per epoch,
    [epoch, loss, acc, val_loss or None, val_acc or None, lr]."""

    def __init__(self, spec: ViTSpec, cfg: TrainConfig,
                 augment: Optional[AugmentConfig] = None,
                 impl: str = "auto", device="cuda"):
        self.spec, self.cfg, self.impl = spec, cfg, impl
        self.device = torch.device(device)
        if self.device.type == "cuda":
            use_true_f32()
        self.model = init_vit(spec, torch.Generator().manual_seed(cfg.seed),
                              device=self.device)
        self.opt = adam_init(self.model)
        self._step = make_vit_train_step(spec, cfg, augment, impl)
        self.epoch = 0
        self.records: list = []

    # -- checkpoints -------------------------------------------------------

    def save(self, ckpt_dir: str) -> str:
        """ckpt_dir/ckpt_{epoch:06d}.npz (params and AdamW state) and its
        .json with the records, in the JAX layout."""
        return save_checkpoint(ckpt_dir, self.model, self.opt, self.epoch,
                               {"records": self.records})

    def load(self, ckpt_dir: str) -> bool:
        """Resumes from the newest checkpoint in ckpt_dir, of either
        package; False when there is none."""
        path = latest_checkpoint(ckpt_dir)
        if path is None:
            return False
        params, _, opt, step = load_checkpoint(path)
        load_into(self.model, params, {})
        self.opt = adam_from_jax(opt, self.model, self.device)
        self.epoch = int(step)
        with open(path[:-4] + ".json") as f:
            self.records = json.load(f).get("records", [])
        return True

    def write_records(self, path: str) -> None:
        """The training curve as an xlsx sheet, the JAX trainer's columns."""
        from ..data.xlsx import write_xlsx

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_xlsx(path, {"Sheet1": [RECORD_COLUMNS] + self.records})

    # -- training ----------------------------------------------------------

    def _generator(self, *words) -> torch.Generator:
        return torch.Generator().manual_seed(_seed(self.cfg.seed, *words))

    def train_epoch(self, images, labels, epoch: Optional[int] = None):
        """One epoch over images (N, H, W, C) uint8 or float in [0, 1] and
        int labels (N,), shuffled from (cfg.seed, epoch) -> {"loss", "acc",
        "lr"}; appends the epoch's record."""
        cfg = self.cfg
        epoch = self.epoch if epoch is None else epoch
        n, bs = len(labels), cfg.batch_size
        lr = float(np.float32(lr_at_epoch(cfg.learning_rate, epoch,
                                          cfg.lr_decay, cfg.lr_decay_every)))
        perm = torch.randperm(n, generator=self._generator(_SHUFFLE, epoch))
        data = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        labels_d = torch.from_numpy(np.asarray(labels, np.int64)).to(
            self.device)
        metrics = []
        for bi, s in enumerate(range(0, n, bs)):
            idx, mask = _pad(perm[s:s + bs].numpy(), bs)
            idx = torch.from_numpy(idx).to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(
                _seed(cfg.seed, _DROPOUT, epoch, bi))
            m = self._step(self.model, self.opt,
                           (normalize_images(data[idx]), labels_d[idx],
                            torch.from_numpy(mask).to(self.device)),
                           gen, lr)
            metrics.append(torch.stack([m["loss"], m["acc"]]))
        loss, acc = torch.stack(metrics).mean(0).tolist()  # one fetch
        self.epoch = epoch + 1
        self.records.append([epoch + 1, loss, acc, None, None, lr])
        return {"loss": loss, "acc": acc, "lr": lr}

    def evaluate(self, images, labels, batch_size: Optional[int] = None):
        """Held-out {"loss", "acc"} through ``predict``."""
        logits = torch.from_numpy(self.predict(images, batch_size))
        labels = torch.from_numpy(np.asarray(labels, np.int64))
        per = softmax_xent(logits, labels, self.spec.num_classes,
                           self.cfg.label_smoothing)
        acc = float((logits.argmax(-1) == labels).float().mean())
        return {"loss": float(per.mean()), "acc": acc}

    def fit(self, images, labels, epochs: int, val_images=None,
            val_labels=None, val_split: float = 0.0,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 10, verbose: bool = True):
        """Trains from ``self.epoch`` to ``epochs``: an optional held-out
        split (``val_split`` of the rows, from (cfg.seed, its own stream)),
        per-epoch training and validation records, a checkpoint every
        ``checkpoint_every`` epochs and at the end, and a resume from the
        newest checkpoint of ``checkpoint_dir``."""
        if val_images is None and val_split > 0.0:
            n = len(labels)
            n_val = max(1, int(n * val_split))
            perm = torch.randperm(n, generator=self._generator(
                _VAL_SPLIT)).numpy()
            val_idx, tr_idx = perm[:n_val], perm[n_val:]
            val_images, val_labels = images[val_idx], \
                np.asarray(labels)[val_idx]
            images, labels = images[tr_idx], np.asarray(labels)[tr_idx]
        if checkpoint_dir:
            self.load(checkpoint_dir)
        while self.epoch < epochs:
            m = self.train_epoch(images, labels)
            if val_images is not None:
                vm = self.evaluate(val_images, val_labels)
                self.records[-1][3] = vm["loss"]
                self.records[-1][4] = vm["acc"]
            if verbose:
                extra = (f" val_loss {self.records[-1][3]:.4f} "
                         f"val_acc {self.records[-1][4]:.4f}"
                         if val_images is not None else "")
                print(f"epoch {self.epoch}/{epochs} loss {m['loss']:.4f} "
                      f"acc {m['acc']:.4f}{extra}", flush=True)
            if checkpoint_dir and (self.epoch % checkpoint_every == 0
                                   or self.epoch >= epochs):
                self.save(checkpoint_dir)
        return self

    def predict(self, images, batch_size: Optional[int] = None):
        """images (N, H, W, C) uint8 or float -> np.float32 logits (N,
        classes), in float32 batches of the configured size, the last one
        padded with zero images and cut back."""
        bs = batch_size or self.cfg.batch_size
        outs = []
        with torch.inference_mode():
            for s in range(0, len(images), bs):
                x = normalize_images(torch.from_numpy(
                    np.ascontiguousarray(images[s:s + bs])).to(self.device))
                real = len(x)
                if real < bs:
                    x = torch.cat([x, x.new_zeros((bs - real,)
                                                  + tuple(x.shape[1:]))])
                logits = vit_forward(self.model, x.float(), impl=self.impl)
                outs.append(logits[:real].float().cpu().numpy())
        return np.concatenate(outs)
