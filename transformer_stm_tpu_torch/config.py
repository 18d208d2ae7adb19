"""Model, data, training and experiment config: the port's own copy of the
parts of transformer_stm_tpu/config.py that the port reads (``FREQUENCIES``
and ``PROCESS_PARAMETERS`` :18-33, ``StageSpec`` and ``CvTSpec`` :36-90,
``ViTSpec`` and ``VIT_PRESETS`` :93-113, ``cvt_highres_spec`` :116,
``DataConfig`` :125-139, ``TrainConfig`` :143-169 but for ``prng_impl``,
``MeshConfig`` :181-186, ``ExperimentConfig`` :189-229 and the JSON files
of ``save_config``/``load_config`` :232-278).

``DataConfig``'s default paths are relative (``reference/...``), where the
JAX defaults are absolute.  A JSON written by either package loads in the
other.  ``mesh`` is the ``data`` x ``model`` layout of the ranks of a
process group, which ``parallel.build_mesh`` reads.  The one field of the
JAX config that the port does not have, ``train.prng_impl`` (the jax
PRNG), means nothing to PyTorch: it is read from a JAX-written file and
ignored (``JAX_ONLY``).  Any other key the port does not know raises:
nothing is dropped silently."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

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
class ViTSpec:
    """Plain ViT classifier (BASELINE.json configs 1-3): patchify, a
    pre-norm encoder of ``depth`` layers at width ``embed_dim`` with
    ``num_heads`` heads and an MLP of ``mlp_ratio`` x the width, an LN head
    on the cls token."""

    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: int = 4
    image_size: int = 224
    num_channels: int = 3
    num_classes: int = 1000
    dropout_rate: float = 0.0
    drop_path_rate: float = 0.0


VIT_PRESETS = {
    "ViT-Ti/16": ViTSpec(embed_dim=192, depth=12, num_heads=3),
    "ViT-S/16": ViTSpec(embed_dim=384, depth=12, num_heads=6),
    "ViT-B/16": ViTSpec(embed_dim=768, depth=12, num_heads=12),
}


def cvt_highres_spec(size: int = 384) -> CvTSpec:
    """The same CvT pyramid at 384 or 512px (BASELINE.json config 5): stage
    1 holds 96x96 = 9,216 or 128x128 = 16,384 tokens; at 512px the router
    sends them to the flash attention kernel."""
    return CvTSpec(image_height=size, image_width=size)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: models/CvT(Par).py:44-50,
    464-476): Adam at 1e-3, lr x0.8 every 50 epochs, 1,000 epochs, batch
    128.  ``weight_decay`` > 0 makes the update AdamW (``optimizer`` names
    which, as in the JAX config); ``checkpoint_every`` > 0 writes a
    checkpoint every that many epochs.  ``compute_dtype="bfloat16"`` runs
    the forward and backward in bfloat16 with float32 parameters, optimizer
    state, loss and metrics; ``loss`` and ``label_smoothing`` are the ViT
    classification trainer's (train/vit_train.py)."""

    learning_rate: float = 1e-3
    lr_decay: float = 0.8
    lr_decay_every: int = 50
    epochs: int = 1000
    batch_size: int = 128
    seed: int = 0
    optimizer: str = "adam"  # adam | adamw
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    loss: str = "mse"  # mse | softmax_xent
    compute_dtype: str = "float32"  # float32 | bfloat16
    checkpoint_every: int = 0  # epochs between mid-run checkpoints; 0 = off
    repeats: int = 1  # "(many)" repeat runs of every target (harness.run)

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}, want "
                             "'float32' or 'bfloat16'")
        if self.loss not in ("mse", "softmax_xent"):
            raise ValueError(f"loss={self.loss!r}, want 'mse' or "
                             "'softmax_xent'")


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
class MeshConfig:
    """The device mesh of the parallel layer: ``data`` ranks split the
    batch, ``model`` ranks the attention heads, MLP hidden units and
    convolution channels (parallel/sharding.py)."""

    data: int = -1  # -1: all the ranks the model axis leaves
    model: int = 1


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
    mesh: MeshConfig = field(default_factory=MeshConfig)
    result_dir: str = "Result"
    # hidden width of the params-only FFN (the reference's 256,
    # models/FFN(OnlyPar).py:46-47)
    ffn_hidden: int = 256

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


# Fields of the JAX config that mean nothing to the port, keyed by (owning
# class, field name): read from a JAX-written file and ignored whatever
# their value.
JAX_ONLY = {
    (TrainConfig, "prng_impl"),
}

# nested-dataclass fields, keyed by (owning class, field name)
_NESTED = {
    (CvTSpec, "stages"): ("tuple", StageSpec),
    (ExperimentConfig, "model"): ("one", CvTSpec),
    (ExperimentConfig, "data"): ("one", DataConfig),
    (ExperimentConfig, "train"): ("one", TrainConfig),
    (ExperimentConfig, "mesh"): ("one", MeshConfig),
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_dict(cls, d):
    names = {f.name for f in dataclasses.fields(cls)}
    for key in d:
        if key not in names and (cls, key) not in JAX_ONLY:
            raise ValueError(f"unknown config key {cls.__name__}.{key}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        nested = _NESTED.get((cls, f.name))
        if nested is not None:
            kind, sub = nested
            v = (tuple(_from_dict(sub, s) for s in v) if kind == "tuple"
                 else _from_dict(sub, v))
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: ExperimentConfig, path: str) -> None:
    """The config as JSON, in the JAX package's layout."""
    with open(path, "w") as f:
        json.dump(_to_jsonable(cfg), f, indent=2, ensure_ascii=False)


def load_config(path: str) -> ExperimentConfig:
    """A config JSON written by either package."""
    with open(path) as f:
        return _from_dict(ExperimentConfig, json.load(f))
