"""Model, data, training and experiment config: the port's own copy of the
parts of transformer_stm_tpu/config.py that the port reads (``FREQUENCIES``
and ``PROCESS_PARAMETERS`` :18-33, ``StageSpec`` and ``CvTSpec`` :36-90,
``DataConfig`` :125-139, the single-target fields of ``TrainConfig``
:143-169 and ``ExperimentConfig`` :189-229).

``DataConfig``'s default paths are relative (``reference/...``), where the
JAX defaults are absolute; the mesh and the params-only FFN width are not
ported, nor ``save_config``/``load_config`` (they come with the CLI)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# The 20 regression targets: 5 magnetic properties x 4 excitation
# frequencies (reference: models/CvT(Par).py:22).
FREQUENCIES: Tuple[str, ...] = tuple(
    f"{hz}HZ_{prop}"
    for hz in (50, 200, 400, 800)
    for prop in ("Bm", "Hc", "μa", "Br", "Pcv")
)

# Process-parameter columns of Excel/Process_parameters.xlsx (reference:
# models/CvT(Par).py:388): oxygen concentration, laser scan speed, laser
# power, hatch spacing, energy density.
PROCESS_PARAMETERS: Tuple[str, ...] = (
    "氧濃度",
    "雷射掃描速度",
    "雷射功率",
    "線間距",
    "能量密度",
)


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


@dataclass(frozen=True)
class DataConfig:
    """Dataset ranges (reference: models/CvT(Par).py:30-42): 40 groups of
    5 pieces, 200 layer images each, decoded to 128x128 gray; paths are
    relative to the working directory."""

    data_root: str = "reference/data"
    excel_labels: str = "reference/Excel/Processed_Circle_test.xlsx"
    excel_process: str = "reference/Excel/Process_parameters.xlsx"
    group_start: int = 1
    group_end: int = 40
    piece_num_start: int = 1
    piece_num_end: int = 5
    image_layers: int = 200
    image_height: int = 128
    image_width: int = 128
    cache_dir: str = "cache"  # decoded-image cache, shared across targets


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level config of an experiment: inputs, projection, cls token,
    targets, model, data, training and the artifact root."""

    inputs: str = "img+par"  # img | par | img+par
    projection_method: str = "dw_bn"
    cls_token: bool = True
    frequencies: Tuple[str, ...] = FREQUENCIES
    model: CvTSpec = field(default_factory=CvTSpec)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    result_dir: str = "Result"

    @property
    def variant_dir(self) -> str:
        """Artifact sub-directory per input variant."""
        return {
            "img+par": "Images & Parameters",
            "img": "Images",
            "par": "Parameters",
        }[self.inputs]

    def weight_name(self, freq: str, time: Optional[int] = None) -> str:
        """Checkpoint name, the reference's convention
        cvt_model_weights_{freq}[_{time}]_{proj}_cls{bool}; "(many)"
        repeat runs put the run index right after the target."""
        suffix = f"_{time}" if time is not None else ""
        if self.inputs == "par":
            return f"Vit_model_weights_{freq}{suffix}"
        return (f"cvt_model_weights_{freq}{suffix}_{self.projection_method}"
                f"_cls{self.cls_token}")
