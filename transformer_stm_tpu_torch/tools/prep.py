"""Offline data preparation (transformer_stm_tpu/tools/prep.py), on the
host:

- ``pick_up_data`` (:24): the IQR outlier filter per group of 5 specimen
  rows, written as the processed label sheet (reference
  tools/PickUpData.py:15-66, ``make Pick_up_datas``; the ``pickup``
  subcommand);
- ``rotate_augment`` (:48): 90/180/270-degree copies of each layer image
  as layer_{n+L}/{n+2L}/{n+3L}.jpg (reference tools/Rotate.py:4-46), with
  PIL, imported when it runs;
- ``renumber_folders`` (:72): the one-shot ``item*`` ->
  ``trail{g}_{p:02d}`` renumbering of a data directory;
- ``to_ml_excel`` (:93): the processed sheet split into a test sheet (the
  first valid piece of each group) and a train sheet, the other rows'
  targets masked with 'X', for the classical-ML pipeline (reference
  tools/toMLexcel.py:15-49).
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..config import FREQUENCIES
from ..data.labels import iqr_filter
from ..data.split import first_valid_per_group
from ..data.xlsx import read_table, write_xlsx


def _target_columns(cols) -> List[int]:
    return [i for i, c in enumerate(cols) if c in FREQUENCIES]


def pick_up_data(in_path: str, out_path: str, group_size: int = 5) -> int:
    """Filters every target column group by group; an outlier becomes an
    empty cell.  Cell A1 is blanked as the reference's sheet has it.
    Returns the number of cells emptied."""
    cols, rows = read_table(in_path)
    dropped = 0
    for ci in _target_columns(cols):
        for g0 in range(0, len(rows), group_size):
            group = rows[g0:g0 + group_size]
            vals = [r[ci] if ci < len(r) else None for r in group]
            for r, old, new in zip(group, vals, iqr_filter(vals)):
                if old is not None and new is None:
                    dropped += 1
                r.extend([None] * (ci + 1 - len(r)))
                r[ci] = new
    header = [None] + list(cols[1:])
    write_xlsx(out_path, {"Sheet1": [header] + rows})
    return dropped


def rotate_augment(data_dir: str, image_layers: int = 200,
                   folders: Optional[List[str]] = None) -> int:
    """Writes the rotated copies; returns the number of images written."""
    from PIL import Image

    if folders is None:
        folders = sorted(d for d in os.listdir(data_dir)
                         if d.startswith("trail"))
    count = 0
    for folder in folders:
        fp = os.path.join(data_dir, folder)
        for i in range(1, image_layers + 1):
            src = os.path.join(fp, f"layer_{i:02d}.jpg")
            if not os.path.exists(src):
                continue
            img = Image.open(src)
            for k, angle in enumerate((90, 180, 270), start=1):
                dst = os.path.join(fp,
                                   f"layer_{i + k * image_layers:02d}.jpg")
                img.rotate(angle, expand=True).save(dst)
                count += 1
    return count


def renumber_folders(data_dir: str, dry_run: bool = True,
                     pieces: int = 5) -> List[tuple]:
    """The (src, dst) plan that renames every directory not yet named
    ``trail*``, in sorted order, to ``trail{group}_{piece:02d}``; carried
    out when ``dry_run`` is False."""
    entries = sorted(d for d in os.listdir(data_dir)
                     if os.path.isdir(os.path.join(data_dir, d))
                     and not d.startswith("trail"))
    plan = [(name, f"trail{i // pieces + 1:01d}_{i % pieces + 1:02d}")
            for i, name in enumerate(entries)]
    if not dry_run:
        for src, dst in plan:
            os.rename(os.path.join(data_dir, src),
                      os.path.join(data_dir, dst))
    return plan


def to_ml_excel(in_path: str, out_path: str, group_size: int = 5) -> None:
    """Writes the "test" and "train" sheets: a row is valid when any target
    survived; the first valid row of each group is a test row, and each
    sheet masks the other sheet's rows' targets with 'X'."""
    cols, rows = read_table(in_path)
    targets = _target_columns(cols)
    valid = [ri for ri, r in enumerate(rows)
             if any(ci < len(r) and r[ci] is not None for ci in targets)]
    firsts = set(first_valid_per_group(valid, len(rows), group_size))

    def masked(keep_test: bool):
        out = [list(cols)]
        for ri, r in enumerate(rows):
            rr = list(r)
            if (ri in firsts) != keep_test:
                for ci in targets:
                    if ci < len(rr):
                        rr[ci] = "X"
            out.append(rr)
        return out

    write_xlsx(out_path, {"test": masked(True), "train": masked(False)})
