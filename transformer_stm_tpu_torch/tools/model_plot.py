"""The CvT's structure (transformer_stm_tpu/tools/model_plot.py; reference
tools/model_plot.py, keras.utils.plot_model): ``plot_model_structure``
(:48) draws one box a layer with its output shape, arrows along the data
flow, from the config's ``CvTSpec`` (matplotlib, imported when it draws);
``model_summary`` (:76) counts the parameters of each stage and of the
head of the port's own ``CvT``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch


def _spec(cfg):
    spec = cfg.model.with_projection(cfg.projection_method, cfg.cls_token)
    if cfg.inputs == "img":
        spec = dataclasses.replace(spec, proc_dim=0)
    return spec


def _stage_rows(cfg) -> List[Tuple[str, str]]:
    """(layer, output shape) from the input to the final Dense."""
    spec = cfg.model.with_projection(cfg.projection_method, cfg.cls_token)
    h, w = spec.image_height, spec.image_width
    rows = [("Image input", f"({h}, {w}, {spec.num_channels})")]
    for i, st in enumerate(spec.stages, start=1):
        h, w = -(-h // st.stride), -(-w // st.stride)
        rows.append((f"stage{i} ConvEmbed {st.patch_size}x{st.patch_size}"
                     f"/{st.stride}", f"({h}, {w}, {st.embed_dim})"))
        cls = " +cls" if st.with_cls_token else ""
        rows.append((f"stage{i} ConvTransformerBlock "
                     f"(heads={st.num_heads}, qkv={st.qkv_method}{cls})",
                     f"({h * w}{'+1' if st.with_cls_token else ''} tokens, "
                     f"{st.embed_dim})"))
    last = spec.stages[-1]
    rows.append(("LayerNorm(cls) + squeeze" if last.with_cls_token else
                 "LayerNorm + token mean", f"({last.embed_dim},)"))
    if spec.proc_dim > 0:
        rows.append((f"‖ Proc branch Dense({spec.proc_hidden})x2 ‖",
                     f"({spec.proc_hidden},) concat -> "
                     f"({last.embed_dim + spec.proc_hidden},)"))
    rows.append((f"Dense({spec.num_classes}) linear",
                 f"({spec.num_classes},)"))
    return rows


def plot_model_structure(cfg, out_path: str) -> None:
    """Writes the diagram of ``_stage_rows`` as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyBboxPatch

    rows = _stage_rows(cfg)
    n = len(rows)
    fig, ax = plt.subplots(figsize=(7, 1.2 * n))
    ax.axis("off")
    for i, (name, shape) in enumerate(rows):
        y = n - 1 - i
        ax.add_patch(FancyBboxPatch((0.05, y + 0.15), 0.9, 0.7,
                                    boxstyle="round,pad=0.02",
                                    facecolor="#dbe9f6",
                                    edgecolor="#39576e"))
        ax.text(0.5, y + 0.62, name, ha="center", va="center", fontsize=10,
                weight="bold")
        ax.text(0.5, y + 0.33, shape, ha="center", va="center", fontsize=9,
                color="#39576e")
        if i < n - 1:
            ax.annotate("", xy=(0.5, y + 0.12), xytext=(0.5, y - 0.0),
                        arrowprops=dict(arrowstyle="<-", color="#39576e"))
    ax.set_xlim(0, 1)
    ax.set_ylim(0, n)
    ax.set_title(f"CvT ({cfg.inputs}, {cfg.projection_method}, "
                 f"cls={cfg.cls_token})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)


def model_summary(cfg) -> str:
    """The parameter count of each stage, of the head and process branch,
    and the total, of the config's CvT built on the CPU."""
    from ..models.cvt import init_cvt

    model = init_cvt(_spec(cfg), torch.Generator().manual_seed(0),
                     device="cpu")
    lines, total = [], 0
    for i, stage in enumerate(model.stages, start=1):
        n = sum(p.numel() for p in stage.parameters())
        total += n
        lines.append(f"stage{i}: {n:,} params")
    head = sum(p.numel() for name, p in model.named_parameters()
               if not name.startswith("stages."))
    total += head
    lines.append(f"head/proc: {head:,} params")
    lines.append(f"total: {total:,} params")
    return "\n".join(lines)
