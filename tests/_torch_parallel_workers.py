"""Rank workers of tests/test_torch_parallel.py: module-level functions
that ``parallel.spawn`` runs in fresh processes, so this module imports no
jax.  Each reads its inputs from ``d/inputs.npz`` (and the trees the test
wrote there) and rank 0 writes what the test compares into
``d/<name>.npz``; the test holds them against the JAX package and the
port's single-device code in its own process."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from transformer_stm_tpu_torch.config import (CvTSpec, MeshConfig,
                                              StageSpec, TrainConfig)
from transformer_stm_tpu_torch.data.augment import AugmentConfig
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.ops.attention import _attention_plain
from transformer_stm_tpu_torch.parallel import (
    ShardedTrainer, build_mesh, ring_attention, shard_params, sp_attention)
from transformer_stm_tpu_torch.train.checkpoint import (
    _unflatten, from_jax_params)

# tests/test_parallel.py:16-24
TINY = CvTSpec(
    stages=(
        StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1),
        StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2),
        StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                  with_cls_token=True),
    ),
    image_height=32, image_width=32,
)
TINY0 = dataclasses.replace(TINY, stages=tuple(
    dataclasses.replace(st, dropout_rate=0.0) for st in TINY.stages))
DP_CFG = TrainConfig(epochs=1, batch_size=32, seed=5)
CKPT_CFG = TrainConfig(epochs=2, batch_size=32, seed=3)


def toy(n=64, seed=0):
    """tests/test_parallel.py:_toy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, 32, 32, 1), dtype=np.uint8),
            rng.normal(size=(n, 5)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _inputs(d):
    with np.load(os.path.join(d, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


def _write(d, name, flat):
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, name + ".npz"), **flat)


def _gather(t, axis, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, axis)


def whole(trainer_or_model, mesh, opt=None):
    """{"p/..", "s/..", "o/mu/..", "o/nu/..", "o/step"} of the whole
    model, its split parameters (and moments) gathered over 'model'."""
    model = trainer_or_model
    if isinstance(model, ShardedTrainer):
        model, opt = model.model, model.opt
    group, axes = mesh.get_group("model"), getattr(model, "tp_axes", {})

    def full(name, t):
        a = axes.get(name)
        t = _gather(t, a, group) if a is not None else t.detach()
        return t.cpu().numpy()

    flat = {"p/" + n.replace(".", "/"): full(n, p)
            for n, p in model.named_parameters()}
    flat.update({"s/" + n.replace(".", "/"): b.cpu().numpy()
                 for n, b in model.named_buffers()})
    if opt is not None:
        for kind, moments in (("mu", opt.mu), ("nu", opt.nu)):
            flat.update({f"o/{kind}/" + n.replace(".", "/"): full(n, t)
                         for n, t in moments.items()})
        flat["o/step"] = np.asarray(opt.step, np.int32)
    return flat


def _trees(d):
    """The (params, state) trees the test wrote for the forward checks."""
    with np.load(os.path.join(d, "trees.npz")) as z:
        flat = {k: z[k] for k in z.files}
    part = lambda pre: _unflatten({k[2:]: v for k, v in flat.items()
                                   if k.startswith(pre)})
    return part("p/"), part("s/")


# The training forwards whose gradients the tensor-parallel check compares:
# (name, spec, mlp_impl).  TINY's dropout on the plain MLP and on the fused
# training MLP, whose shards draw their blocks of the replicated masks; the
# fused training MLP at dropout 0.
TRAIN_CHECKS = (("plain", TINY, None), ("fused", TINY0, "pallas"),
                ("fused_dropout", TINY, "pallas"))


def train_grads(model, x, mlp_impl, seed=2):
    """{name: gradient} of the sum of squares of a training forward of
    ``model`` on the test's inputs, dropout drawn from a CPU generator
    seeded ``seed``."""
    model.requires_grad_(True)
    out = cvt_forward(model, torch.from_numpy(x["img"]),
                      torch.from_numpy(x["proc"]), train=True,
                      generator=torch.Generator().manual_seed(seed),
                      mlp_impl=mlp_impl)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(out.square().sum(), params)))


def _tp_forward(d, mesh, name):
    """The tensor-parallel evaluation forward of the test's weights, and
    the gradients of ``TRAIN_CHECKS``' training forwards, gathered."""
    params, state = _trees(d)
    x = _inputs(d)
    model = shard_params(from_jax_params(params, state, TINY, device="cpu"),
                         mesh)
    with torch.inference_mode():
        out = cvt_forward(model, torch.from_numpy(x["img"]),
                          torch.from_numpy(x["proc"]))
    flat = {"out": out.numpy(), "sharded": np.asarray(sorted(model.tp_axes))}
    group = mesh.get_group("model")
    for check, spec, mlp_impl in TRAIN_CHECKS:
        model = shard_params(from_jax_params(params, state, spec,
                                             device="cpu"), mesh)
        for n, g in train_grads(model, x, mlp_impl).items():
            a = model.tp_axes.get(n)
            flat[f"{check}/{n}"] = (_gather(g, a, group) if a is not None
                                    else g).numpy()
    _write(d, name, flat)


def _dp_epoch(d, mesh, name):
    """One epoch of ``ShardedTrainer`` at dropout 0 from the gather path,
    and one of another trainer from host arrays."""
    images, proc, labels = toy()
    tr = ShardedTrainer(TINY0, DP_CFG, mesh)
    tr.upload(images, proc, labels)
    m = tr.train_epoch_device(len(labels), epoch=0)
    host = ShardedTrainer(TINY0, DP_CFG, mesh)
    mh = host.train_epoch(images, proc, labels, epoch=0)
    flat = whole(tr, mesh)
    flat.update({"loss": m["loss"], "mae": m["mae"],
                 "host_loss": mh["loss"]})
    flat.update({"host/" + k: v for k, v in whole(host, mesh).items()})
    _write(d, name, flat)


def worker_2x2(rank, world, d):
    """(b) the TP forward at 2 x 2; (c) a DP+TP epoch; (e) kill and
    resume, a checkpoint for JAX, and JAX's 4 x 2 checkpoint restored."""
    torch.set_num_threads(1)  # the test suite's other workers share the host
    mesh = build_mesh(MeshConfig(data=2, model=2), device="cpu")
    _tp_forward(d, mesh, "tp_2x2")
    _dp_epoch(d, mesh, "dp_2x2")

    images, proc, labels = toy()
    n = len(labels)
    ref = ShardedTrainer(TINY, CKPT_CFG, mesh)
    ref.upload(images, proc, labels)
    ref.train_epoch_device_scan(n, epoch=0)
    ref.train_epoch_device_scan(n, epoch=1)
    t1 = ShardedTrainer(TINY, CKPT_CFG, mesh)
    t1.upload(images, proc, labels)
    t1.train_epoch_device_scan(n, epoch=0)
    ck = os.path.join(d, "port_ck")
    t1.save(ck, epoch=1)
    saved = whole(t1, mesh)
    del t1  # the "kill"
    t2 = ShardedTrainer(TINY, CKPT_CFG, mesh)
    t2.upload(images, proc, labels)
    epoch = t2.load(ck)
    t2.train_epoch_device_scan(n, epoch=1)
    flat = {"ref/" + k: v for k, v in whole(ref, mesh).items()}
    flat.update({"resumed/" + k: v for k, v in whole(t2, mesh).items()})
    flat.update({"saved/" + k: v for k, v in saved.items()})
    flat["epoch"] = epoch
    t3 = ShardedTrainer(TINY, TrainConfig(batch_size=16, seed=1), mesh)
    flat["jax_epoch"] = t3.load(os.path.join(d, "jax_ck"))
    flat.update({"from_jax/" + k: v for k, v in whole(t3, mesh).items()})
    _write(d, "ckpt_2x2", flat)


def _attention_checks(d, mesh):
    """(d): both sequence-parallel attentions at world 4 and their
    gradients of the sum of squares, each rank's shard gathered."""
    x = _inputs(d)
    group = mesh.get_group("data")
    r, n = dist.get_rank(group), dist.get_world_size(group)
    flat = {}
    for fn in (sp_attention, ring_attention):
        q, k, v = (torch.from_numpy(x[name]).chunk(n, 1)[r].clone()
                   .requires_grad_(True) for name in ("q", "k", "v"))
        out = fn(q, k, v, mesh)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
        for key, t in (("out", out), *zip(("dq", "dk", "dv"), grads)):
            flat[f"{fn.__name__}/{key}"] = _gather(t, 1, group).numpy()
    _write(d, "attention", flat)


def worker_4x1(rank, world, d):
    """(c) a DP epoch at 4 x 1 and dropout on; (d) sequence parallelism;
    (b) the TP forward at 1 x 4."""
    torch.set_num_threads(1)
    mesh = build_mesh(MeshConfig(data=4, model=1), device="cpu")
    _dp_epoch(d, mesh, "dp_4x1")
    images, proc, _ = toy(n=128, seed=11)
    labels = images.astype(np.float32).mean((1, 2, 3)) / 255.0
    cfg = TrainConfig(epochs=4, batch_size=64, learning_rate=3e-3, seed=1)
    tr = ShardedTrainer(TINY, cfg, mesh,
                        augment=AugmentConfig(crop_padding=2, brightness=0.05,
                                              contrast=0.05))
    losses = [tr.train_epoch(images, proc, labels, e)["loss"]
              for e in range(4)]
    _attention_checks(d, mesh)
    _write(d, "dropout_4x1", {"losses": np.asarray(losses)})
    _tp_forward(d, build_mesh(MeshConfig(data=1, model=4), device="cpu"),
                "tp_1x4")


def plain_attention_grads(q, k, v):
    """The plain attention and its gradients of the sum of squares."""
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = _attention_plain(q, k, v)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    return [t.detach().numpy() for t in (out, *grads)]

