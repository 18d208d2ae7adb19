"""The port's inference loop, metrics and sheet against the JAX package on
the CPU, and the port's import hygiene.

- ``TrainLoop.predict`` with a ragged last batch against the JAX loop's
  exact (true f32) predict on the same weights: atol 1e-4;
- metrics and the Predictions_Metrics sheet: equal to the JAX writer's;
- importing the port and chip_smoke pulls in no jax, no JAX package, no
  matplotlib, cv2, tensorflow or openpyxl; chip_smoke fails, printing no
  result, without a CUDA device and without the rest of the repository.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.config import TrainConfig as JaxTrainConfig
from transformer_stm_tpu.data.xlsx import read_xlsx as jax_read_xlsx
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.train import metrics as jax_metrics
from transformer_stm_tpu.train.loop import TrainLoop as JaxTrainLoop
from transformer_stm_tpu_torch.config import CvTSpec, TrainConfig
from transformer_stm_tpu_torch.data.xlsx import read_xlsx
from transformer_stm_tpu_torch.train import metrics
from transformer_stm_tpu_torch.train.checkpoint import from_jax_params
from transformer_stm_tpu_torch.train.loop import TrainLoop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow(spec_cls):
    base = spec_cls()
    return dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, embed_dim=d, num_heads=h)
        for st, d, h in zip(base.stages, (16, 32, 64), (1, 2, 4))))


def test_predict_ragged_batches_match_jax_loop():
    rng = np.random.default_rng(20)
    jspec = _narrow(JaxCvTSpec)
    params, state = jax_init_cvt(jax.random.PRNGKey(5), jspec)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(
            a.shape).astype(np.float32), params)
    images = rng.integers(0, 256, (5, 128, 128, 1), dtype=np.uint8)
    proc = rng.standard_normal((5, 5)).astype(np.float32)

    jloop = JaxTrainLoop(jspec, JaxTrainConfig(batch_size=2))
    jloop.params, jloop.state = params, state
    want = jloop.predict(images, proc, exact=True)

    model = from_jax_params(params, jax.tree_util.tree_map(np.asarray, state),
                            _narrow(CvTSpec), device="cpu")
    loop = TrainLoop(_narrow(CvTSpec), TrainConfig(batch_size=2),
                     device="cpu", model=model)
    got = loop.predict(images, proc)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # one batch of all five, no padding, gives the same rows
    np.testing.assert_allclose(loop.predict(images, proc, batch_size=8), got,
                               atol=1e-6, rtol=0)


def test_trainloop_builds_a_seeded_model():
    a = TrainLoop(_narrow(CvTSpec), TrainConfig(seed=4), device="cpu")
    b = TrainLoop(_narrow(CvTSpec), TrainConfig(seed=4), device="cpu")
    for (n, x), (_, y) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert x.device.type == "cpu" and x.equal(y), n


@pytest.mark.parametrize("name", ["mse", "mae", "r2_score"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(21)
    y, p = rng.uniform(1, 2, 50), rng.uniform(1, 2, 50)
    assert getattr(metrics, name)(y, p) == getattr(jax_metrics, name)(y, p)


def test_r2_of_constant_labels_is_zero():
    assert metrics.r2_score(np.ones(4), np.arange(4.0)) == 0.0


def test_predictions_sheet_matches_jax_writer(tmp_path):
    rng = np.random.default_rng(22)
    pred = rng.uniform(1, 2, 7).astype(np.float32)
    true = rng.uniform(1, 2, 7)
    ours, theirs = tmp_path / "ours.xlsx", tmp_path / "theirs.xlsx"
    metrics.write_predictions_metrics(str(ours), "50HZ_Bm", pred, true, 30, 7)
    jax_metrics.write_predictions_metrics(str(theirs), "50HZ_Bm", pred, true,
                                          30, 7)
    assert jax_read_xlsx(str(ours)) == jax_read_xlsx(str(theirs))
    assert read_xlsx(str(theirs)) == jax_read_xlsx(str(theirs))
    back = metrics.read_predictions_metrics(str(ours))
    want = jax_metrics.read_predictions_metrics(str(theirs))
    assert back["header"] == metrics.HEADER
    for key in ("train_num", "test_num", "r2", "mse", "mae"):
        assert back[key] == want[key]
    np.testing.assert_array_equal(back["predictions"], want["predictions"])
    np.testing.assert_array_equal(back["actual"], want["actual"])


FORBIDDEN = ["jax", "transformer_stm_tpu", "matplotlib", "cv2", "tensorflow",
             "openpyxl"]


# the command line and the analysis and data-prep modules behind its
# subcommands, imported by name as a user's command imports them
ENTRY_MODULES = [
    "transformer_stm_tpu_torch.cli", "transformer_stm_tpu_torch.harness",
    "transformer_stm_tpu_torch.models.ffn",
    "transformer_stm_tpu_torch.data.native",
    "transformer_stm_tpu_torch.tools.grad_cam",
    "transformer_stm_tpu_torch.tools.prep",
    "transformer_stm_tpu_torch.tools.plots",
    "transformer_stm_tpu_torch.tools.model_plot",
    "transformer_stm_tpu_torch.tools.monitor"]


def test_port_and_chip_smoke_import_no_jax_or_missing_packages():
    code = (
        "import sys, json, pkgutil, importlib\n"
        f"for m in {ENTRY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import transformer_stm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_chip_smoke(cwd):
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
