"""Process groups and the device mesh (transformer_stm_tpu/parallel/
mesh.py).

One process drives one rank.  ``maybe_distributed_init`` joins the process
group (NCCL on the card, gloo where the caller asks for the CPU), and
``build_mesh`` lays its ranks out as a ``DeviceMesh`` with the axes
``("data", "model")``: ``data`` ranks split the batch, ``model`` ranks the
attention heads, MLP hidden units and convolution channels
(parallel/sharding.py).  ``spawn`` starts the ranks of one host as
processes that meet on a file store, with no port to pick:

    spawn(fn, 4, "cpu", out_dir)        # fn(rank, world, out_dir) x 4
    # in fn:  mesh = build_mesh(MeshConfig(data=2, model=2), device="cpu")

NCCL takes one card a rank, so on the card the world is at most
``torch.cuda.device_count()``.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import MeshConfig

AXES = ("data", "model")


def local_device_count() -> int:
    """The cards this host shows."""
    return torch.cuda.device_count()


def backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_distributed_init(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           timeout: Optional[datetime.timedelta] = None
                           ) -> None:
    """Joins the process group of ``num_processes`` ranks as
    ``process_id`` at ``coordinator``, an init method of
    ``torch.distributed`` (``tcp://host:port`` or ``file://path``); a no-op
    when ``coordinator`` is None or a group is up.  On the card the rank
    takes card ``process_id`` mod the cards of its host and the group
    NCCL; ``device="cpu"`` takes gloo."""
    if coordinator is None or dist.is_initialized():
        return
    dev = torch.device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("maybe_distributed_init: no CUDA device for "
                               "the NCCL group")
        kwargs["device_id"] = torch.device(
            "cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(kwargs["device_id"])
    dist.init_process_group(backend(dev), init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def build_mesh(cfg: Optional[MeshConfig] = None,
               n_devices: Optional[int] = None,
               device="cuda") -> DeviceMesh:
    """A ``data`` x ``model`` mesh over the ranks of the process group;
    ``cfg.data == -1`` takes all the ranks the model axis leaves.
    ``n_devices`` defaults to the group's world size; the mesh must span
    the whole group."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: call "
                           "maybe_distributed_init (or run under spawn)")
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // model
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} must span the {world} ranks "
                         "of the process group")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_main(rank, fn, world, device, store, timeout, args):
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    maybe_distributed_init(store, world, rank, device, timeout)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


# How long a spawned rank's collective waits for the others before it fails.
SPAWN_TIMEOUT = datetime.timedelta(seconds=300)


def spawn(fn, world: int, device, *args) -> None:
    """Runs ``fn(rank, world, *args)`` in ``world`` new processes, each
    joined to one process group (``maybe_distributed_init`` on ``device``)
    through a file store in a new temporary directory.  ``fn`` must be a
    module-level function of a module that imports in a fresh interpreter;
    a collective waits at most ``SPAWN_TIMEOUT``.  CPU ranks share the
    host's cores: each takes its share of the intra-op threads.  Returns
    when every rank has ended, and raises if one failed (the others are
    then stopped)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main, args=(fn, world, str(device), store, SPAWN_TIMEOUT,
                              args),
            nprocs=world, join=True, start_method="spawn")
