"""The phase profiler of the bf16 fused ViT layer against the committed source
(the bf16 modes' spans and, with ``--int8``, the int8 layer's).

``transformer_stm_tpu_torch.tools.profile_fused_layer_phases`` inserts
``clock64()`` spans into a copy of ``csrc/vit_layer_sm90.cu`` at whole lines
of it.  The profile itself runs only on the card; here, on the CPU, every
anchor must still match the source, so that an edit of the kernel that moves
a line shows in the tests and not first on the card.
"""

import re
from pathlib import Path

import pytest

from transformer_stm_tpu_torch.tools import profile_fused_layer_phases as prof

SOURCE = (Path(prof.__file__).resolve().parents[1] / "csrc" /
          prof.SOURCE).read_text()


def test_every_anchor_matches_the_committed_source():
    text = prof.patch(SOURCE)
    marks = [int(k) for k in re.findall(r"PROF\((\d+)\);", text)]
    # each phase is closed by exactly one mark, and the spans start once
    assert sorted(marks) == list(range(len(prof.PHASES)))
    assert text.count(prof.INIT) == 1
    assert text.startswith(prof.PRELUDE) and text.endswith(prof.EPILOGUE)


def test_the_patch_only_adds_lines():
    added = {code for _, _, _, code in prof.ANCHORS}
    body = prof.patch(SOURCE)[len(prof.PRELUDE) + 1:-len(prof.EPILOGUE)]
    assert [line for line in body.split("\n")
            if line not in added] == SOURCE.split("\n")


@pytest.mark.parametrize("anchor", [0, len(prof.ANCHORS) - 1])
def test_a_missing_anchor_raises(anchor):
    line = prof.ANCHORS[anchor][0]
    with pytest.raises(ValueError, match="anchor not found"):
        prof.patch(SOURCE.replace(line + "\n", "\n"))


def test_every_int8_anchor_matches_the_committed_source():
    text = prof.patch(SOURCE, prof.ANCHORS_INT8)
    marks = [int(k) for k in re.findall(r"PROF\((\d+)\);", text)]
    assert sorted(marks) == list(range(len(prof.PHASES_INT8)))
    assert text.count(prof.INIT) == 1
    body = text[len(prof.PRELUDE) + 1:-len(prof.EPILOGUE)]
    added = {code for _, _, _, code in prof.ANCHORS_INT8}
    assert [line for line in body.split("\n")
            if line not in added] == SOURCE.split("\n")
    # the int8 spans sit in the int8 layer's code: q|k|v's epilogue in item
    # A, the hidden's quantisation in item C
    lines = text.split("\n")
    at = lines.index("PROF(5);")
    assert lines[at + 1].strip().startswith("dequant_acc(acc, sx, p.sqkv")
    at = lines.index("PROF(19);")
    assert lines[at + 1] == "  slot_ready();"
    assert "qs[tid]" in lines[at - 1]
