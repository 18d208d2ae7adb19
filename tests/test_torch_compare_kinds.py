"""The kind comparison of the training MLP backward against the committed source.

``transformer_stm_tpu_torch.tools.compare_mlp_bwd_kinds`` rewrites the
``dx_kind``/``dw_kind`` lines of a copy of ``csrc/fused_mlp_train.cu``.  The
timing runs only on the card; here, on the CPU, each of its builds must
patch the committed source and name kinds that the source still has.
"""

from pathlib import Path

import pytest

from transformer_stm_tpu_torch.tools import compare_mlp_bwd_kinds as kinds

SOURCE = (Path(kinds.__file__).resolve().parents[1] / "csrc" /
          kinds.SOURCE).read_text()


@pytest.mark.parametrize("name", [n for n, k in kinds.BUILDS.items() if k])
def test_each_build_changes_only_the_two_kind_lines(name):
    dx, dw = kinds.BUILDS[name]
    old, new = SOURCE.split("\n"), kinds.patch(SOURCE, (dx, dw)).split("\n")
    changed = [(a, b) for a, b in zip(old, new) if a != b]
    assert len(old) == len(new) and len(changed) <= 2
    for (fn, triple) in (("dx_kind", dx), ("dw_kind", dw)):
        line = next(b for b in new if f"constexpr int {fn}(int D)" in b)
        for d, k in zip(kinds.WIDTHS, triple):
            assert f"D == {d} ? {k} " in line


def test_an_unknown_kind_or_a_missing_line_raises():
    with pytest.raises(ValueError, match="not kinds of"):
        kinds.patch(SOURCE, (("DX", "DX", "DQ"), ("DW", "DW", "DW")))
    gone = SOURCE.replace("constexpr int dw_kind(int D)", "int dw_kind(int D)")
    with pytest.raises(ValueError, match="not found"):
        kinds.patch(gone, (("DX", "DX", "DX"), ("DW", "DW", "DW")))
