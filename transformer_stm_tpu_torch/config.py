"""Model and training config: the port's own copy of the parts of
transformer_stm_tpu/config.py that the port reads (``StageSpec``,
``CvTSpec`` :36-90 and the single-target fields of ``TrainConfig``
:143-169)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class StageSpec:
    """One CvT pyramid stage (reference: models/CvT(Par).py:66-72)."""

    embed_dim: int
    patch_size: int
    stride: int
    num_heads: int
    kernel_size: int = 3
    strides: int = 1  # stride of the conv QKV projection
    qkv_method: str = "dw_bn"  # dw_bn | avg | linear
    with_cls_token: bool = False
    depth: int = 1  # blocks per stage
    mlp_ratio: int = 4
    dropout_rate: float = 0.1


@dataclass(frozen=True)
class CvTSpec:
    """Full CvT model spec: 128px input -> 32x32x64 -> 16x16x128 ->
    8x8x256 (+ cls token in stage 3)."""

    stages: Tuple[StageSpec, ...] = (
        StageSpec(embed_dim=64, patch_size=7, stride=4, num_heads=1),
        StageSpec(embed_dim=128, patch_size=3, stride=2, num_heads=2),
        StageSpec(embed_dim=256, patch_size=3, stride=2, num_heads=4,
                  with_cls_token=True),
    )
    image_height: int = 128
    image_width: int = 128
    num_channels: int = 1
    num_classes: int = 1  # regression: a single scalar
    proc_dim: int = 5  # 0 disables the process-parameter branch
    proc_hidden: int = 256
    # The reference's ConvEmbed LayerNorm is dead at runtime
    # (models/CvT(Par).py:209); True enables the norm it intended.
    embed_norm: bool = False

    def with_projection(self, method: str, cls_token: bool) -> "CvTSpec":
        """``method`` for every stage, the cls token only on the last."""
        n = len(self.stages)
        stages = tuple(
            dataclasses.replace(s, qkv_method=method,
                                with_cls_token=(cls_token and i == n - 1))
            for i, s in enumerate(self.stages))
        return dataclasses.replace(self, stages=stages)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: models/CvT(Par).py:44-50,
    464-476): Adam at 1e-3, lr x0.8 every 50 epochs, 1,000 epochs, batch
    128.  ``weight_decay`` > 0 makes the update AdamW (``optimizer`` names
    which, as in the JAX config); ``checkpoint_every`` > 0 writes a
    checkpoint every that many epochs.  Only float32 compute is ported."""

    learning_rate: float = 1e-3
    lr_decay: float = 0.8
    lr_decay_every: int = 50
    epochs: int = 1000
    batch_size: int = 128
    seed: int = 0
    optimizer: str = "adam"  # adam | adamw
    weight_decay: float = 0.0
    compute_dtype: str = "float32"
    checkpoint_every: int = 0  # epochs between mid-run checkpoints; 0 = off

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r} is not ported yet; "
                "the port computes in float32")
