"""The port's data layer against the JAX package's on the CPU, exact.

A synthetic fixture under ``tmp_path`` stands in for the corpus and the
label sheets: label and process xlsx files written by the port's own xlsx
writer (one label missing on a non-first piece, as the IQR filter leaves
them), and a tiny JPEG tree.  Both packages' ``read_table``,
``build_target_arrays``, ``train_val_split``, ``decode_corpus`` and
``load_dataset`` give equal results; the harness paths and spec agree.
Both packages decode on their default path, the native libjpeg loader
(each its own build of the same source), bit for bit alike; on the cv2
path (``use_native=False``) too.
"""

import dataclasses
import os

import numpy as np
import pytest

from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu import harness as jax_harness
from transformer_stm_tpu.data import images as jax_images
from transformer_stm_tpu.data import labels as jax_labels
from transformer_stm_tpu.data import split as jax_split
from transformer_stm_tpu.data.xlsx import read_table as jax_read_table
from transformer_stm_tpu.train.metrics import \
    read_predictions_metrics as jax_read_predictions_metrics
from transformer_stm_tpu_torch import config, harness
from transformer_stm_tpu_torch.data import images, labels, split
from transformer_stm_tpu_torch.data.xlsx import read_table, write_xlsx
from transformer_stm_tpu_torch.train.metrics import (
    HEADER, read_predictions_metrics)

FREQS = ("50HZ_Bm", "50HZ_Hc")


def write_fixture(root, groups=2, layers=4, hw=32, freqs=FREQS,
                  missing=((1, 2),), seed=0):
    """Label and process sheets for ``groups`` x 5 specimens and a uint8
    corpus (n_specimens, layers, hw, hw).  ``missing``: (target index,
    specimen row) pairs whose label cell is left empty.  Returns (the
    DataConfig fields, corpus)."""
    rng = np.random.default_rng(seed)
    n_spec = groups * 5
    vals = rng.uniform(1.0, 2.0, (n_spec, len(freqs)))
    rows = [["No."] + list(freqs)]
    for i in range(n_spec):
        rows.append([i + 1] + [None if (t, i) in missing else float(vals[i, t])
                               for t in range(len(freqs))])
    lab = os.path.join(root, "labels.xlsx")
    write_xlsx(lab, {"Sheet1": rows})
    proc = rng.uniform(0.5, 3.0, (groups, 5))
    prc = os.path.join(root, "process.xlsx")
    write_xlsx(prc, {"Sheet1": [list(config.PROCESS_PARAMETERS)]
                     + proc.tolist()})
    corpus = rng.integers(0, 256, (n_spec, layers, hw, hw), dtype=np.uint8)
    fields = dict(data_root=os.path.join(root, "data"), excel_labels=lab,
                  excel_process=prc, group_end=groups, image_layers=layers,
                  image_height=hw, image_width=hw,
                  cache_dir=os.path.join(root, "cache"))
    return fields, corpus


def write_jpegs(fields, corpus):
    """The corpus as a JPEG tree (3-channel, 40x40) in the reference's
    folder layout."""
    import cv2

    cfg = config.DataConfig(**fields)
    for idx in range(corpus.shape[0]):
        folder = images._specimen_dir(cfg, idx)
        os.makedirs(folder, exist_ok=True)
        for i in range(corpus.shape[1]):
            img = cv2.resize(corpus[idx, i], (40, 40))
            cv2.imwrite(os.path.join(folder, f"layer_{i + 1:02d}.jpg"),
                        np.stack([img, img // 2, 255 - img], -1))


@pytest.fixture
def fixture(tmp_path):
    return write_fixture(str(tmp_path))


def _tables(fields):
    return ((labels.LabelTable.load(fields["excel_labels"]),
             labels.ProcessTable.load(fields["excel_process"])),
            (jax_labels.LabelTable.load(fields["excel_labels"]),
             jax_labels.ProcessTable.load(fields["excel_process"])))


def test_read_table_matches_jax(fixture):
    fields, _ = fixture
    for key in ("excel_labels", "excel_process"):
        assert read_table(fields[key]) == jax_read_table(fields[key])
        assert read_table(fields[key], header=False) == \
            jax_read_table(fields[key], header=False)


@pytest.mark.parametrize("freq", FREQS)
def test_target_arrays_and_split_match_jax(fixture, freq):
    fields, _ = fixture
    (lt, pt), (jlt, jpt) = _tables(fields)
    got = labels.build_target_arrays(config.DataConfig(**fields), freq, lt, pt)
    want = jax_labels.build_target_arrays(jax_config.DataConfig(**fields),
                                          freq, jlt, jpt)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    tr, va = split.train_val_split(got["valid_indices"], got["count"], 4)
    jtr, jva = jax_split.train_val_split(want["valid_indices"],
                                         want["count"], 4)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    # one missing label on a non-first piece: one piece fewer in training
    assert len(tr) == (28 if freq == "50HZ_Hc" else 32) and len(va) == 8


def test_first_valid_per_group_matches_jax():
    valid = [1, 2, 3, 5, 9, 12, 13]
    assert split.first_valid_per_group(valid, 15) == \
        jax_split.first_valid_per_group(valid, 15) == [1, 5, 12]


def test_standard_scale_and_coerce_float_match_jax():
    x = np.random.default_rng(1).normal(size=(20, 5))
    x[:, 2] = 3.0  # zero variance passes through
    for a, b in zip(labels.standard_scale(x), jax_labels.standard_scale(x)):
        np.testing.assert_array_equal(a, b)
    for v in (None, float("nan"), 3, " 2.5 ", "x", 1.25):
        assert labels.coerce_float(v) == jax_labels.coerce_float(v)


def test_decode_corpus_matches_jax_and_reads_the_cache(tmp_path,
                                                       monkeypatch):
    fields, corpus = write_fixture(str(tmp_path), groups=1, layers=2)
    write_jpegs(fields, corpus)
    got = np.array(images.decode_corpus(config.DataConfig(**fields),
                                        verbose=False))
    jfields = dict(fields, cache_dir=str(tmp_path / "jax_cache"))
    want = np.array(jax_images.decode_corpus(
        jax_config.DataConfig(**jfields), verbose=False))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 2, 32, 32) and got.dtype == np.uint8

    def no_decode(*a, **k):
        raise AssertionError("decoded although the cache holds it")

    monkeypatch.setattr(images, "decode_specimen", no_decode)
    again = images.decode_corpus(config.DataConfig(**fields), [0, 3],
                                 verbose=False)
    np.testing.assert_array_equal(np.asarray(again), got)
    # the JAX package reads the port's cache without decoding either
    monkeypatch.setattr(jax_images, "decode_specimen", no_decode)
    np.testing.assert_array_equal(np.asarray(jax_images.decode_corpus(
        jax_config.DataConfig(**fields), verbose=False)), got)


@pytest.mark.parametrize("use_native", [None, False],
                         ids=["default", "cv2"])
def test_decode_specimen_matches_jax(tmp_path, use_native):
    fields, corpus = write_fixture(str(tmp_path), groups=1, layers=3)
    write_jpegs(fields, corpus)
    for idx in (0, 4):
        got = images.decode_specimen(config.DataConfig(**fields), idx,
                                     use_native=use_native)
        want = jax_images.decode_specimen(jax_config.DataConfig(**fields),
                                          idx, use_native=use_native)
        assert got.shape == (3, 32, 32) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_load_dataset_matches_jax(tmp_path):
    fields, corpus = write_fixture(str(tmp_path), groups=1, layers=2)
    write_jpegs(fields, corpus)
    got = images.load_dataset(config.DataConfig(**fields), "50HZ_Bm")
    want = jax_images.load_dataset(jax_config.DataConfig(**dict(
        fields, cache_dir=str(tmp_path / "jax_cache"))), "50HZ_Bm")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["images"].shape == (10, 32, 32, 1)


@pytest.mark.parametrize("inputs", ["img+par", "img", "par"])
def test_harness_paths_and_spec_match_jax(inputs):
    cfg = config.ExperimentConfig(inputs=inputs, result_dir="R")
    jcfg = jax_config.ExperimentConfig(inputs=inputs, result_dir="R")
    assert cfg.variant_dir == jcfg.variant_dir
    for freq, time in (("50HZ_Bm", None), ("800HZ_μa", 3)):
        assert harness._paths(cfg, freq, time) == \
            jax_harness._paths(jcfg, freq, time)
    spec, jspec = harness._spec_for(cfg), jax_harness._spec_for(jcfg)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)


def test_config_constants_match_jax():
    assert config.FREQUENCIES == jax_config.FREQUENCIES
    assert config.PROCESS_PARAMETERS == jax_config.PROCESS_PARAMETERS
    jd = dataclasses.asdict(jax_config.DataConfig())
    d = dataclasses.asdict(config.DataConfig())
    assert d.keys() == jd.keys()
    for k in d:
        if k not in ("data_root", "excel_labels", "excel_process"):
            assert d[k] == jd[k], k


def test_predictions_sheet_with_a_blank_row_reads_as_jax(tmp_path):
    """Rows whose Predictions or Actual cell is empty are dropped, as the
    JAX reader drops them: float64 [1., 2.] in both packages."""
    path = str(tmp_path / "Predictions_Metrics_50HZ_Bm.xlsx")
    write_xlsx(path, {"Sheet1": [HEADER, [1.0, 1.5, 50.0, 8, 2, 0.5, 0.1,
                                          0.2], [2.0, 2.5, 20.0],
                                 [None, None, None]]})
    got, want = read_predictions_metrics(path), \
        jax_read_predictions_metrics(path)
    for key in ("predictions", "actual"):
        assert got[key].dtype == want[key].dtype == np.float64
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["predictions"], [1.0, 2.0])
    for key in ("train_num", "test_num", "r2", "mse", "mae"):
        assert got[key] == want[key]
