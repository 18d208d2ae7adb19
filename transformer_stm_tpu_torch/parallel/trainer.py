"""Data- and tensor-parallel training (transformer_stm_tpu/parallel/
trainer.py:31-256).

Each rank is one process on one device of a ``data`` x ``model`` mesh
(parallel/mesh.py).  ``make_sharded_train_step`` splits the model over the
model axis (``shard_params``) and returns ``train/loop.make_train_step``
on the data axis's group, which keeps the GSPMD semantics of JAX's
``ShardedTrainer``: BatchNorm statistics over the global batch, the loss
over the global count of real rows, gradients summed over the data ranks.

``ShardedTrainer`` runs the epochs: each rank builds the same model from
``cfg.seed`` (``init_cvt``, as ``TrainLoop`` does) and keeps its slices,
shuffles the rows as ``TrainLoop._permutation`` does, pads the last batch
with row 0 and masks it, and trains on its data rank's rows of each
global batch of ``cfg.batch_size``.  The step's generator is seeded as
``TrainLoop``'s, so the augmentation, drawn for the global batch, is the
single-device run's.  On a 1 x 1 mesh the trainer takes ``TrainLoop.fit``'s
steps exactly, through NCCL calls that are identities.

    spawn(fn, 4, "cpu")                                 # parallel/mesh.py
    # in fn(rank, world):
    mesh = build_mesh(MeshConfig(data=2, model=2), device="cpu")
    tr = ShardedTrainer(spec, cfg, mesh)
    tr.upload(images_u8, proc, labels)
    tr.train_epoch_device(len(labels), epoch=0)   # {"loss", "mae", "lr"}
    tr.save(ckpt_dir, epoch=1)                    # sharded checkpoint
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import CvTSpec, StageSpec, TrainConfig
from ..data.images import normalize_images
from ..models.cvt import cvt_forward, init_cvt
from ..ops.common import use_true_f32
from ..train.loop import (_DROPOUT, _pad, _seed, _to_device, compute_dtype,
                          make_train_step, permutation)
from ..train.optimizer import adam_init, lr_at_epoch
from .mesh import mesh_device
from .sharding import data_rows, shard_params


def make_sharded_train_step(cfg: TrainConfig, mesh, model,
                            tensor_parallel: bool = True, impl: str = "auto",
                            augment=None, mlp_impl=None):
    """Returns (step, (model, opt)): ``model``, whole on this rank, split
    over 'model' in place (``shard_params``), a new Adam state of its
    slices, and step(model, opt, batch, generator, lr) -> metrics, the
    data-parallel step (``make_train_step`` on the 'data' group) on this
    rank's rows of the batch."""
    shard_params(model, mesh, tensor_parallel)
    opt = adam_init(model)
    step = make_train_step(cfg, impl=impl, mlp_impl=mlp_impl,
                           augment=augment, group=mesh.get_group("data"))
    return step, (model, opt)


class ShardedTrainer:
    """Multi-device DP(+TP) training of the CvT on this rank's device of
    ``mesh``.  ``augment``: a ``data.augment.AugmentConfig``; ``impl`` and
    ``mlp_impl`` route the attention and the MLPs as in ``TrainLoop``."""

    def __init__(self, spec: CvTSpec, cfg: TrainConfig, mesh,
                 tensor_parallel: bool = True, impl: str = "auto",
                 augment=None, mlp_impl=None):
        self.spec, self.cfg, self.mesh = spec, cfg, mesh
        self.impl, self.mlp_impl = impl, mlp_impl
        self.device = mesh_device(mesh)
        if self.device.type == "cuda":
            use_true_f32()
        self.rows = data_rows(cfg.batch_size, mesh)
        self.data_group = mesh.get_group("data")
        model = init_cvt(spec, torch.Generator().manual_seed(cfg.seed),
                         device=self.device)
        self._step, (self.model, self.opt) = make_sharded_train_step(
            cfg, mesh, model, tensor_parallel, impl, augment, mlp_impl)
        self._data = None

    # -- epochs --------------------------------------------------------------

    def _epoch(self, n: int, epoch: int, batch_of):
        """One epoch of n rows; batch_of(idx) -> (images float, proc or
        None, labels) of this rank's rows idx (an int64 tensor on the
        device) -> {"loss", "mae", "lr"}, the global batch's metrics."""
        cfg, dev = self.cfg, self.device
        bs = cfg.batch_size
        steps = -(-n // bs)
        lr = float(np.float32(lr_at_epoch(
            cfg.learning_rate, epoch, cfg.lr_decay, cfg.lr_decay_every)))
        perm = permutation(cfg.seed, n, epoch)
        idxs, masks = zip(*(_pad(perm[s:s + bs], bs)
                            for s in range(0, n, bs)))
        idx_d = torch.from_numpy(np.stack(idxs)[:, self.rows]).to(dev)
        mask_d = torch.from_numpy(np.stack(masks)[:, self.rows]).to(dev)
        acc = torch.zeros(3, device=dev)
        for bi in range(steps):
            batch = (*batch_of(idx_d[bi]), mask_d[bi])
            gen = torch.Generator(device=dev).manual_seed(
                _seed(cfg.seed, _DROPOUT, epoch * steps + bi))
            m = self._step(self.model, self.opt, batch, gen, lr)
            acc += torch.stack([m["se"], m["ae"], m["n"]])
        se, ae, cnt = acc.cpu().numpy()  # one fetch per epoch
        return {"loss": float(se / cnt), "mae": float(ae / cnt), "lr": lr}

    def upload(self, images, proc, labels):
        """The dataset on this rank's device, whole on every rank (uint8
        images as they are): ``train_epoch_device`` gathers each step's
        rows there."""
        self._data = _to_device(self.device, images, proc, labels)
        return self._data

    def train_epoch_device(self, n: int, epoch: int):
        """One epoch over the uploaded dataset: each rank gathers its rows
        of every batch on its device (``TrainLoop.fit``'s loop)."""
        images, proc, labels = self._data
        return self._epoch(n, epoch, lambda idx: (
            normalize_images(images[idx]),
            proc[idx] if proc is not None else None, labels[idx]))

    # JAX compiles the epoch into one lax.scan; here it is the same loop.
    train_epoch_device_scan = train_epoch_device

    def train_epoch(self, images, proc, labels, epoch: int):
        """One epoch from host arrays: each step copies this rank's rows of
        its batch to the device."""
        labels = np.asarray(labels, np.float32)

        def batch_of(idx):
            i = idx.cpu().numpy()
            x, p, y = _to_device(self.device, images[i],
                                 proc[i] if proc is not None else None,
                                 labels[i])
            return normalize_images(x), p, y

        return self._epoch(len(labels), epoch, batch_of)

    # -- evaluation and checkpoints -------------------------------------------

    def eval_step(self, images, proc):
        """images (B, H, W, C) in [0, 1] (or uint8) and proc (B, P) or None,
        the global batch on this rank's device -> its (B,) float32
        predictions on every rank: each data rank evaluates its rows in
        ``cfg.compute_dtype`` through ``impl`` and the rows are gathered
        over 'data'."""
        dtype = compute_dtype(self.cfg)
        rows = data_rows(images.shape[0], self.mesh)
        with torch.inference_mode():
            out = cvt_forward(
                self.model, normalize_images(images[rows]).to(dtype),
                proc[rows].to(dtype) if proc is not None else None,
                impl=self.impl).reshape(-1).float()
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(self.data_group))]
            dist.all_gather(parts, out, group=self.data_group)
        return torch.cat(parts)

    def save(self, ckpt_dir: str, epoch: int, metadata=None) -> str:
        """A sharded checkpoint of the model and Adam's state, each rank
        writing its shard file (train/sharded_checkpoint.py)."""
        from ..train.sharded_checkpoint import save_sharded_checkpoint

        return save_sharded_checkpoint(ckpt_dir, self.model, self.opt, epoch,
                                       metadata, mesh=self.mesh)

    def load(self, ckpt_dir: str) -> Optional[int]:
        """Resumes from the newest sharded checkpoint of ckpt_dir, written
        on any mesh layout by either package; returns its epoch, or None
        where there is none."""
        from ..train.sharded_checkpoint import (latest_sharded_checkpoint,
                                                restore_sharded_checkpoint)

        manifest = latest_sharded_checkpoint(ckpt_dir)
        if manifest is None:
            return None
        return restore_sharded_checkpoint(manifest, self.model, self.opt)[2]


# The tiny CvT of the dry run: the full topology (three stages, the cls
# token, dw_bn) at 32px (__graft_entry__.py:60-69).
DRYRUN_SPEC = CvTSpec(
    stages=(StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1),
            StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2),
            StageSpec(embed_dim=32, patch_size=3, stride=2, num_heads=4,
                      with_cls_token=True)),
    image_height=32, image_width=32)


def dryrun_rank(rank: int, world: int, device) -> None:
    """One rank of ``dryrun_multichip``: a data x model mesh (model 2 at 4
    ranks or more, if even), ``ShardedTrainer`` with on-device augmentation
    through upload, train_epoch_device_scan and train_epoch_device on an odd
    row count (a masked partial batch), finite losses."""
    from ..config import MeshConfig
    from ..data.augment import AugmentConfig
    from .mesh import build_mesh

    model_par = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = build_mesh(MeshConfig(data=world // model_par, model=model_par),
                      device=device)
    cfg = TrainConfig(batch_size=world * 2, epochs=1)
    trainer = ShardedTrainer(DRYRUN_SPEC, cfg, mesh,
                             tensor_parallel=model_par > 1,
                             augment=AugmentConfig(crop_padding=2))
    n = cfg.batch_size * 2 + 3
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (n, 32, 32, 1)).astype(np.uint8)
    proc = rng.normal(size=(n, 5)).astype(np.float32)
    labels = rng.normal(size=(n,)).astype(np.float32)
    trainer.upload(images, proc, labels)
    m_scan = trainer.train_epoch_device_scan(n, epoch=0)
    m_dev = trainer.train_epoch_device(n, epoch=1)
    if not (np.isfinite(m_scan["loss"]) and np.isfinite(m_dev["loss"])):
        raise FloatingPointError(f"dryrun losses {m_scan} {m_dev}")
    if rank == 0:
        print(f"dryrun_multichip OK on {world} ranks (mesh data="
              f"{world // model_par} x model={model_par}, {device}), "
              f"augmented epoch loss={m_scan['loss']:.4f}, "
              f"second epoch loss={m_dev['loss']:.4f}")
