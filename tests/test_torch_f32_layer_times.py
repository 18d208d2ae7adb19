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


def test_compare_holds_the_int8_layer_within_its_tolerance(tmp_path, capsys):
    """The int8 layer on float32 x may move with the float32 layer: within
    1e-2 of max |A| it passes, past that it differs; every other tensor is
    still held bit for bit."""
    key = "vit_layer_infer_int8 f32"
    y = torch.linspace(-4.0, 4.0, 64)
    paths = [str(tmp_path / n) for n in ("a.pt", "b.pt", "c.pt", "d.pt")]
    torch.save({key: y, "x": torch.ones(3)}, paths[0])
    torch.save({key: y + 0.03, "x": torch.ones(3)}, paths[1])
    torch.save({key: y + 0.05, "x": torch.ones(3)}, paths[2])
    torch.save({key: y, "x": torch.ones(3) + 2 ** -20}, paths[3])
    assert tool.compare(paths[0], paths[1])
    assert f"within     {key}" in capsys.readouterr().out
    assert not tool.compare(paths[0], paths[2])
    assert f"DIFFERENT  {key}" in capsys.readouterr().out
    assert not tool.compare(paths[0], paths[3])
    assert "DIFFERENT  x" in capsys.readouterr().out


def test_split_sums_launches_by_kernel_and_by_product():
    """chunk_gemm_s8's launches go to q|k|v, out, fc1, fc2 in turn, chunk
    by chunk; the kernels sum by their short names; a run that is not
    whole chunks of four gives no product split."""
    s8 = "void cgemm::chunk_gemm_s8<(anonymous namespace)::q8layer::Q8Params>"
    flash = "void (anonymous namespace)::flash_fwd_tf32x3<0>(Params)"
    launches = []
    for c in range(2):
        launches += [("ln_quant(float const*)", 0.01), (s8, 1.0 + c),
                     (flash, 0.5), (s8, 2.0 + c), (s8, 3.0 + c),
                     (s8, 4.0 + c)]
    kernels, products = tool.split(launches)
    assert products == {"qkv": 3.0, "out": 5.0, "fc1": 7.0, "fc2": 9.0}
    assert kernels["chunk_gemm_s8"] == 24.0
    assert kernels["flash_fwd_tf32x3"] == 1.0
    assert abs(kernels["ln_quant"] - 0.02) < 1e-12
    assert tool.split(launches[:3])[1] is None
    assert tool.split([(flash, 0.5)])[1] is None
