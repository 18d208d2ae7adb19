"""The port's TensorBoard export (transformer_stm_tpu_torch/tools/tb_export.py),
which writes event files without TensorFlow, against the JAX tool's, which
writes them through ``tf.summary``.  TensorFlow reads both here: the same
tags, steps and float32 tensor values, each record's bytes equal once the
wall time is set aside, and the CRCs check (TF's reader verifies them)."""

import glob
import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from transformer_stm_tpu.tools import tb_export as jax_tb  # noqa: E402
from transformer_stm_tpu_torch.tools import tb_export  # noqa: E402
from transformer_stm_tpu_torch.train.metrics import RecordsWriter  # noqa: E402

ROWS = [[0, 0.5, 0.25, None, 0.125, 1e-3],
        [1, 0.4, 0.2, 0.3, 0.1, 1e-3],
        [2, 1e30, -3.5, 0.29, 0.0, 8e-4]]


def _events(logdir):
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1
    return files[0], [tf.compat.v1.Event.FromString(r) for r in
                      tf.compat.v1.io.tf_record_iterator(files[0])]


def _scalars(events):
    return [(e.step, v.tag, float(tf.make_ndarray(v.tensor)),
             v.metadata.plugin_data.plugin_name)
            for e in events for v in e.summary.value]


def _without_wall_time(events):
    out = []
    for e in events[1:]:
        e.wall_time = 0
        out.append(e.SerializeToString())
    return out


def test_crc32c_known_values():
    assert tb_export.crc32c(b"123456789") == 0xE3069283
    assert tb_export.crc32c(b"") == 0
    assert tb_export.crc32c(bytes(32)) == 0x8A9136AA


def test_event_file_matches_the_jax_tool(tmp_path):
    ours = tb_export.export_rows(ROWS, str(tmp_path / "port"))
    theirs = jax_tb.export_rows(ROWS, str(tmp_path / "jax"))
    path, mine = _events(ours)
    _, want = _events(theirs)
    assert os.path.basename(path).endswith(".v2")
    assert mine[0].file_version == want[0].file_version == "brain.Event:2"
    assert _scalars(mine) == _scalars(want)
    assert len(_scalars(mine)) == 14  # the None cell is skipped
    assert all(e.wall_time > 0 for e in mine)
    assert _without_wall_time(mine) == _without_wall_time(want)


def test_export_records_from_a_records_sheet(tmp_path):
    rec = RecordsWriter()
    for row in ROWS[1:]:
        rec.log(*row)
    sheet = str(tmp_path / "records.xlsx")
    rec.write(sheet)
    ours = tb_export.export_records(sheet, str(tmp_path / "port"))
    theirs = jax_tb.export_records(sheet, str(tmp_path / "jax"))
    _, mine = _events(ours)
    _, want = _events(theirs)
    assert _scalars(mine) == _scalars(want)
    assert {t for _, t, _, _ in _scalars(mine)} == {
        "loss", "mae", "val_loss", "val_mae", "lr"}
    got = {(s, t): v for s, t, v, _ in _scalars(mine)}
    assert got[(3, "mae")] == np.float32(-3.5)  # epochs 1-based


def test_two_exports_write_two_files(tmp_path):
    tb_export.export_rows(ROWS[:1], str(tmp_path))
    tb_export.export_rows(ROWS[1:], str(tmp_path))
    files = sorted(glob.glob(str(tmp_path / "events.out.tfevents.*")))
    assert len(files) == 2
    steps = sorted(e.step for f in files for r in
                   tf.compat.v1.io.tf_record_iterator(f)
                   for e in [tf.compat.v1.Event.FromString(r)]
                   if e.summary.value)
    assert steps == [0] * 4 + [1] * 5 + [2] * 5


def test_a_corrupt_record_fails_the_crc(tmp_path):
    path, _ = _events(tb_export.export_rows(ROWS, str(tmp_path)))
    data = bytearray(open(path, "rb").read())
    data[-10] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(Exception):
        list(tf.compat.v1.io.tf_record_iterator(path))
