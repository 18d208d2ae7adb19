"""The comparison of ``tools/f32_layer_times.py`` on the CPU: two dumps are
the same only where every tensor is bit-equal and each side has it."""

import torch

from transformer_stm_tpu_torch.tools import f32_layer_times as tool


def test_compare_reports_each_tensor(tmp_path, capsys):
    a = {"x": torch.arange(6.0), "y": torch.ones(2, 3)}
    paths = [str(tmp_path / n) for n in ("a.pt", "b.pt", "c.pt", "d.pt")]
    torch.save(a, paths[0])
    torch.save({k: v.clone() for k, v in a.items()}, paths[1])
    torch.save({"x": a["x"], "y": a["y"] + 2 ** -20}, paths[2])
    torch.save({"x": a["x"]}, paths[3])
    assert tool.compare(paths[0], paths[1])
    assert "bit-equal  y" in capsys.readouterr().out
    assert not tool.compare(paths[0], paths[2])
    assert "DIFFERENT  y" in capsys.readouterr().out
    assert not tool.compare(paths[0], paths[3])
    assert "DIFFERENT  y" in capsys.readouterr().out
