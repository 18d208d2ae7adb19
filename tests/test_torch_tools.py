"""The port's host tools against the JAX package's on the CPU, exact.

- ``iqr_filter`` and ``pick_up_data`` on a synthetic raw label sheet with
  outliers, numbers stored as text and empty cells: the same cells
  emptied, the same count, the same sheet;
- ``rotate_augment``, ``renumber_folders`` and ``to_ml_excel`` on
  temporary trees: the same files and sheets;
- every plot function writes a PNG from a fixture, pixel for pixel the
  JAX package's;
- ``read_glcm_baseline`` on a written GLCM sheet equal to JAX's;
- ``model_summary`` and the diagram's rows equal to JAX's (the parameter
  counts from the port's own modules);
- ``cpu_ram_stats`` and ``format_line`` carry JAX's keys; without CUDA
  ``cuda_memory_stats()`` is [] and the line shows no card.
"""

import os
import shutil

import numpy as np
import pytest

import matplotlib.image

from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu.data import labels as jax_labels
from transformer_stm_tpu.data.xlsx import read_xlsx as jax_read_xlsx
from transformer_stm_tpu.tools import model_plot as jax_model_plot
from transformer_stm_tpu.tools import monitor as jax_monitor
from transformer_stm_tpu.tools import plots as jax_plots
from transformer_stm_tpu.tools import prep as jax_prep
from transformer_stm_tpu_torch import config
from transformer_stm_tpu_torch.data import labels
from transformer_stm_tpu_torch.data.xlsx import read_xlsx, write_xlsx
from transformer_stm_tpu_torch.tools import model_plot, monitor, plots, prep
from transformer_stm_tpu_torch.train.metrics import (
    RecordsWriter, write_predictions_metrics)

FREQS = ("50HZ_Bm", "50HZ_Hc", "200HZ_Hc")


def write_raw_labels(path, groups=4, seed=0):
    """A raw label sheet: groups x 5 specimens, one outlier a column in
    most groups, a few numbers as text, a few empty cells."""
    rng = np.random.default_rng(seed)
    rows = [["No."] + list(FREQS)]
    for i in range(groups * 5):
        row = [i + 1]
        for t in range(len(FREQS)):
            v = float(rng.uniform(1.0, 1.2))
            if i % 5 == (t + i // 5) % 5 and i // 5 != 1:
                v *= 3.0  # an outlier of its group
            row.append(v)
        rows.append(row)
    rows[3][1] = f" {rows[3][1]!r} "  # a number stored as text
    rows[7][2] = None
    rows[12][3] = "n/a"
    write_xlsx(path, {"Sheet1": rows})
    return rows


def test_iqr_filter_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        vals = list(rng.normal(1.0, 0.1, 5))
        vals[int(rng.integers(5))] *= float(rng.choice([1.0, 4.0, -2.0]))
        vals[int(rng.integers(5))] = rng.choice([None, "x", " 1.05 ", 1.0])
        assert labels.iqr_filter(vals) == jax_labels.iqr_filter(vals)
    assert labels.iqr_filter([None, "x"]) == [None, None]
    assert labels.iqr_filter([1.0, 1.1, 1.2, 1.1, 9.0]) == \
        [1.0, 1.1, 1.2, 1.1, None]


def test_pick_up_data_matches_jax(tmp_path):
    raw = str(tmp_path / "raw.xlsx")
    write_raw_labels(raw)
    got = prep.pick_up_data(raw, str(tmp_path / "port.xlsx"))
    want = jax_prep.pick_up_data(raw, str(tmp_path / "jax.xlsx"))
    assert got == want and got >= 6
    ours = read_xlsx(str(tmp_path / "port.xlsx"))
    assert ours == jax_read_xlsx(str(tmp_path / "jax.xlsx"))
    assert ours["Sheet1"][0][0] is None  # A1 blanked, as the reference
    emptied = sum(v is None for r in ours["Sheet1"][1:] for v in r[1:])
    # the count includes the "n/a" cell; the empty cell was empty already
    assert emptied == got + 1


def _jpeg_tree(root, folders, layers):
    from PIL import Image

    rng = np.random.default_rng(2)
    for name in folders:
        os.makedirs(os.path.join(root, name))
        for i in range(1, layers + 1):
            Image.fromarray(rng.integers(0, 256, (12, 9, 3), dtype=np.uint8)
                            ).save(os.path.join(root, name,
                                                f"layer_{i:02d}.jpg"))


def test_rotate_augment_matches_jax(tmp_path):
    _jpeg_tree(str(tmp_path / "port"), ["trail1_01", "trail1_02", "x"], 2)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = prep.rotate_augment(str(tmp_path / "port"), image_layers=2)
    want = jax_prep.rotate_augment(str(tmp_path / "jax"), image_layers=2)
    assert got == want == 12
    for folder in ("trail1_01", "trail1_02", "x"):
        names = sorted(os.listdir(tmp_path / "port" / folder))
        assert names == sorted(os.listdir(tmp_path / "jax" / folder))
        for n in names:
            assert (tmp_path / "port" / folder / n).read_bytes() == \
                (tmp_path / "jax" / folder / n).read_bytes(), n
    assert len(os.listdir(tmp_path / "port" / "trail1_01")) == 8


def test_renumber_folders_matches_jax(tmp_path):
    for side in ("port", "jax"):
        for name in ["item3", "item1", "item10", "trail9_01", "b"]:
            os.makedirs(tmp_path / side / name)
        (tmp_path / side / "file.txt").write_text("x")
    plan = prep.renumber_folders(str(tmp_path / "port"), pieces=2)
    assert plan == jax_prep.renumber_folders(str(tmp_path / "jax"), pieces=2)
    assert plan[0] == ("b", "trail1_01") and plan[3] == ("item3",
                                                         "trail2_02")
    assert "item1" in os.listdir(tmp_path / "port")  # a dry run
    prep.renumber_folders(str(tmp_path / "port"), dry_run=False, pieces=2)
    jax_prep.renumber_folders(str(tmp_path / "jax"), dry_run=False, pieces=2)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_to_ml_excel_matches_jax(tmp_path):
    raw = str(tmp_path / "raw.xlsx")
    write_raw_labels(raw, groups=3)
    processed = str(tmp_path / "processed.xlsx")
    prep.pick_up_data(raw, processed)
    prep.to_ml_excel(processed, str(tmp_path / "port.xlsx"))
    jax_prep.to_ml_excel(processed, str(tmp_path / "jax.xlsx"))
    ours = read_xlsx(str(tmp_path / "port.xlsx"))
    assert ours == jax_read_xlsx(str(tmp_path / "jax.xlsx"))
    assert set(ours) == {"test", "train"}
    assert sum(r[1] != "X" for r in ours["test"][1:]) == 3


# ---------------------------------------------------------------------------
# plots


def write_glcm(glcm_dir, prop, model, freqs, seed=3):
    """A classical baseline sheet in the layout the reference's GLCM
    results use: one sheet a target, predictions, true values and R² on
    the first row."""
    rng = np.random.default_rng(seed)
    sheets = {}
    for k, f in enumerate(freqs):
        true = rng.uniform(1, 2, 6)
        rows = [[None, "Predictions", "True Values", "R2 Score"]]
        for i in range(6):
            rows.append([i, float(true[i] + 0.1 * rng.standard_normal()),
                         float(true[i]), 0.8 + 0.05 * k if i == 0 else None])
        sheets[f] = rows
    os.makedirs(glcm_dir, exist_ok=True)
    write_xlsx(os.path.join(glcm_dir, f"{prop}_{model}.xlsx"), sheets)


@pytest.fixture(scope="module")
def plot_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    rec = RecordsWriter()
    for e in range(12):
        rec.log(e, 10.0 / (e + 1), 3.0 / (e + 1),
                None if e == 3 else 12.0 / (e + 1), 4.0 / (e + 1), 1e-3)
    rec.write(str(root / "records.xlsx"))
    rng = np.random.default_rng(4)
    metrics = {}
    for f in ("50HZ_Hc", "200HZ_Hc"):
        y = rng.uniform(1, 2, 8)
        metrics[f] = str(root / f"Predictions_Metrics_{f}.xlsx")
        write_predictions_metrics(metrics[f], f, y + 0.05 *
                                  rng.standard_normal(8), y, 32, 8)
    glcm = str(root / "glcm")
    for m in ("lightgbm", "svr"):
        write_glcm(glcm, "Hc", m, ("50HZ_Hc", "200HZ_Hc"))
    values = [float(v) for v in rng.uniform(1, 2, 10)]
    values[3] = None
    return dict(records=str(root / "records.xlsx"), metrics=metrics,
                glcm=glcm, values=values,
                proc=rng.standard_normal((10, 5)),
                labels={f: rng.uniform(1, 2, 10) for f in FREQS})


PLOTS = {
    "plot_records": lambda m, a, out: m.plot_records(a["records"], out),
    "plot_r2_scatter": lambda m, a, out: m.plot_r2_scatter(
        a["labels"]["50HZ_Bm"], a["labels"]["50HZ_Hc"], 0.5, "50HZ_Bm", out),
    "plot_actual_vs_predicted": lambda m, a, out: m.plot_actual_vs_predicted(
        a["labels"]["50HZ_Bm"], a["labels"]["50HZ_Hc"], "50HZ_Bm", out),
    "plot_compare_predictions": lambda m, a, out: m.plot_compare_predictions(
        a["metrics"]["50HZ_Hc"], a["glcm"], "Hc", "50HZ_Hc", out,
        models=("lightgbm", "svr", "absent")),
    "plot_compare_r2": lambda m, a, out: m.plot_compare_r2(
        a["metrics"], a["glcm"], "Hc", out),
    "plot_label_distribution": lambda m, a, out: m.plot_label_distribution(
        a["labels"], out),
    "plot_values_vs_group_average":
        lambda m, a, out: m.plot_values_vs_group_average(
            a["values"], "50HZ_Bm", out, layers_per_piece=3),
    "plot_labels_vs_parameters":
        lambda m, a, out: m.plot_labels_vs_parameters(
            a["values"], a["proc"], "50HZ_Bm", out, layers_per_piece=3),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_writes_the_jax_png(plot_inputs, tmp_path, name):
    ours, theirs = str(tmp_path / "sub" / "port.png"), \
        str(tmp_path / "jax.png")
    PLOTS[name](plots, plot_inputs, ours)
    PLOTS[name](jax_plots, plot_inputs, theirs)
    got, want = matplotlib.image.imread(ours), matplotlib.image.imread(theirs)
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def test_read_glcm_baseline_matches_jax(plot_inputs):
    for f in ("50HZ_Hc", "200HZ_Hc"):
        got = plots.read_glcm_baseline(plot_inputs["glcm"], "Hc", "svr", f)
        want = jax_plots.read_glcm_baseline(plot_inputs["glcm"], "Hc", "svr",
                                            f)
        assert got.keys() == want.keys() and got["r2"] == want["r2"]
        for k in ("predictions", "true"):
            np.testing.assert_array_equal(got[k], want[k])
        assert len(got["true"]) == 6
    with pytest.raises(FileNotFoundError):
        plots.read_glcm_baseline(plot_inputs["glcm"], "Hc", "xgboost",
                                 "50HZ_Hc")


# ---------------------------------------------------------------------------
# model plot and monitor


@pytest.mark.parametrize("inputs,proj,cls", [
    ("img+par", "dw_bn", True), ("img", "avg", False),
    ("img+par", "linear", False)])
def test_model_summary_and_rows_match_jax(inputs, proj, cls, tmp_path):
    kw = dict(inputs=inputs, projection_method=proj, cls_token=cls)
    cfg, jcfg = config.ExperimentConfig(**kw), \
        jax_config.ExperimentConfig(**kw)
    assert model_plot.model_summary(cfg) == jax_model_plot.model_summary(jcfg)
    assert model_plot._stage_rows(cfg) == jax_model_plot._stage_rows(jcfg)
    out = str(tmp_path / "model.png")
    model_plot.plot_model_structure(cfg, out)
    jax_model_plot.plot_model_structure(jcfg, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(
        matplotlib.image.imread(out),
        matplotlib.image.imread(str(tmp_path / "jax.png")))


def test_flagship_summary_counts():
    total = model_plot.model_summary(config.ExperimentConfig()).splitlines()
    assert total[-1] == "total: 1,838,593 params"


def test_monitor_keys_match_jax(capsys):
    keys = jax_monitor.cpu_ram_stats().keys()
    assert monitor.cpu_ram_stats().keys() == keys
    assert monitor.cuda_memory_stats() == []
    line = monitor.format_line()
    assert line.startswith("CPU ") and "RAM" in line and "cuda" not in line
    stats = monitor.cpu_ram_stats()  # the second call: a busy share
    assert stats.keys() == keys
    assert 0.0 <= stats["cpu_percent"] <= 100.0
    assert 0 < stats["ram_used_gb"] < stats["ram_total_gb"]
    monitor.monitor_loop(interval=0.0, iterations=2)
    assert capsys.readouterr().out.count("CPU ") == 2
