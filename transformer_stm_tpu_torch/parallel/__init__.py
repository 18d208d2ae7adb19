"""The parallel layer (transformer_stm_tpu/parallel/) on
``torch.distributed``: one process a rank, NCCL on the card and gloo where
the caller asks for the CPU.

- mesh.py: the process group (``maybe_distributed_init``, ``spawn``) and
  the ``data`` x ``model`` ``DeviceMesh`` (``build_mesh``);
- collectives.py: all-reduce, all-gather and ppermute as autograd
  Functions, each with the backward its use needs;
- sharding.py: the JAX rules that split the heads, MLP hidden units and
  convolution channels over 'model' (tensor parallelism), and the batch
  over 'data';
- trainer.py: the data(+tensor)-parallel step and ``ShardedTrainer``, with
  BatchNorm synced over 'data' (ops/common.batch_norm_train);
- sequence.py: all-gather and ring sequence-parallel attention;
- train/sharded_checkpoint.py: one shard file a rank, in JAX's layout.

Pipeline and expert parallelism are out of scope, as in the JAX package.

    dryrun_multichip(4, device="cpu")   # 4 gloo ranks, a 2 x 2 mesh
"""

from .collectives import (all_gather, all_reduce_sum, ppermute,  # noqa: F401
                          replicated_input)
from .mesh import (build_mesh, local_device_count,  # noqa: F401
                   maybe_distributed_init, spawn)
from .sequence import ring_attention, sp_attention  # noqa: F401
from .sharding import (batch_sharding, cvt_param_sharding,  # noqa: F401
                       replicate, shard_params)
from .trainer import (ShardedTrainer, dryrun_rank,  # noqa: F401
                      make_sharded_train_step)


def dryrun_multichip(n: int, device="cuda") -> None:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: n ranks
    (processes) on ``device`` train the tiny CvT of ``trainer.DRYRUN_SPEC``
    data(+tensor)-parallel with augmentation for two epochs of an odd row
    count, and raise unless the losses are finite.  On the card each rank
    takes a card of its own."""
    import torch

    if torch.device(device).type == "cuda" and \
            n > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n}) needs {n} cards, have "
                         f"{torch.cuda.device_count()}: NCCL takes one "
                         "rank a card")
    spawn(dryrun_rank, n, device, device)
