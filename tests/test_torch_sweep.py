"""The port's hyperparameter sweep (transformer_stm_tpu_torch/train/sweep.py)
and its ``sweep`` subcommand against the JAX package's (tests/test_sweep.py
needs the reference checkout's data, :18-20).

- ``sweep_cvt``: both packages' trainers are wrapped here so that each
  starts from one JAX epoch-0 stacked checkpoint (the tiny CvT of
  tests/test_torch_multi.py, dropout 0, batch = rows_max, the corpus of
  ``test_torch_data.write_fixture`` in the decode cache); two points of one
  group train 2 epochs as slots with per-slot learning rates; val_mse,
  val_mae and best_val_mse agree within 1e-4 relative, best_epoch and the
  ranking are equal;
- the grouping by dropout, the 5 + 2 chunking of 7 points, the slots'
  targets and lr shares, and the results, through one recording trainer
  given to both packages; the refusals (hidden width for the CvT, dropout
  for the FFN);
- ``grid_points``, ``config_grid_points``, ``config_random_points`` (the
  same draws) and ``_set_path`` equal to JAX's; ``run_config_sweep``'s
  xlsx leaderboard read back equal to JAX's;
- both command lines' ``sweep --inputs par --hidden 8,16``: the same JSON
  keys, points and paths.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from transformer_stm_tpu import cli as jax_cli
from transformer_stm_tpu import config as jc
from transformer_stm_tpu.config import save_config as jax_save_config
from transformer_stm_tpu.train import multi as jax_multi
from transformer_stm_tpu.train import sweep as jax_sweep
from transformer_stm_tpu_torch import cli
from transformer_stm_tpu_torch import config as pc
from transformer_stm_tpu_torch.data.xlsx import read_xlsx
from transformer_stm_tpu_torch.train import multi
from transformer_stm_tpu_torch.train import sweep

from test_torch_many import cache_fixture
from test_torch_multi import experiment

RTOL = 1e-4
FREQ = "50HZ_Bm"
POINTS = [{"lr": 3e-3, "seed": 0}, {"lr": 1e-3, "seed": 2}]


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    return cache_fixture(str(tmp_path_factory.mktemp("sweep")))


def _from_checkpoint(cls, ck):
    class Resumed(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            assert self.load(ck) and self.epoch == 0

    return Resumed


def test_sweep_cvt_matches_jax(fields, tmp_path, monkeypatch):
    jcfg = experiment(jc, fields, str(tmp_path / "jax"), 32)
    pcfg = experiment(pc, fields, str(tmp_path / "port"), 32)
    ck = str(tmp_path / "epoch0")
    targets = [(FREQ, p["seed"], f"sweep{i + 1}")
               for i, p in enumerate(POINTS)]
    jax_multi.MultiTargetTrainer(jcfg, targets).save(ck)
    monkeypatch.setattr(jax_multi, "MultiTargetTrainer", _from_checkpoint(
        jax_multi.MultiTargetTrainer, ck))
    monkeypatch.setattr(multi, "MultiTargetTrainer", _from_checkpoint(
        multi.MultiTargetTrainer, ck))
    want = jax_sweep.run_sweep(jcfg, FREQ, POINTS, epochs=2, verbose=False)
    got = sweep.run_sweep(pcfg, FREQ, POINTS, epochs=2, verbose=False,
                          device="cpu")
    assert got.keys() == want.keys() and got["n_points"] == 2
    assert [(r["lr"], r["seed"]) for r in got["results"]] == \
        [(r["lr"], r["seed"]) for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        assert g.keys() == w.keys()
        assert (g["best_epoch"], g["epochs"]) == (w["best_epoch"], 2)
        for k in ("val_mse", "val_mae", "best_val_mse"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0,
                                       err_msg=k)
    assert got["best"] == got["results"][0]
    assert got["results"][0]["val_mse"] != got["results"][1]["val_mse"]
    path = sweep.write_summary(got, pcfg.result_dir)
    assert os.path.relpath(path, pcfg.result_dir) == os.path.relpath(
        jax_sweep.write_summary(want, jcfg.result_dir), jcfg.result_dir) \
        == "sweep_50HZ_Bm_img_par.json"


class Recorder:
    """Stands in for either package's trainer: records how it was built
    and fills records where val_loss falls to its lowest at epoch 1."""

    made = []

    def __init__(self, cfg, targets, impl="auto", mlp_impl="xla",
                 epochs_per_call=1, corpus=None, lr_scales=None, **kw):
        self.cfg, self.targets, self.lr_scales = cfg, targets, lr_scales
        self.args = (impl, mlp_impl, epochs_per_call)
        Recorder.made.append(self)

    def fit(self, epochs, verbose=True):
        self.records = [
            [[e, 1.0, 1.0, (i + 1) * (2.0 + (e - 1) ** 2), 0.5 + e, 1e-3]
             for e in range(epochs)] for i, _ in enumerate(self.targets)]
        return self


def _recorded(package, mod, cfg, points, monkeypatch):
    Recorder.made = []
    monkeypatch.setattr(mod, "MultiTargetTrainer", Recorder)
    res = package.sweep_cvt(cfg, FREQ, points, epochs=3, verbose=False)
    made = [(t.targets, t.lr_scales, t.args,
             [st.dropout_rate for st in t.cfg.model.stages])
            for t in Recorder.made]
    return res, made


def test_groups_and_chunks_match_jax(fields, tmp_path, monkeypatch):
    jcfg = experiment(jc, fields, str(tmp_path), 8)
    pcfg = experiment(pc, fields, str(tmp_path), 8)
    seven = [{"lr": 1e-3 * (k + 1), "seed": k} for k in range(7)]
    mixed = [{"lr": 1e-3, "seed": 0, "dropout": 0.0},
             {"lr": 2e-3, "seed": 1, "dropout": 0.3},
             {"lr": 1e-3, "seed": 1, "dropout": 0.0}]
    for points, sizes in ((seven, [5, 2]), (mixed, [2, 1])):
        got, made = _recorded(sweep, multi, pcfg, points, monkeypatch)
        want, jmade = _recorded(jax_sweep, jax_multi, jcfg, points,
                                monkeypatch)
        assert got == want
        assert made == jmade
        assert [len(m[0]) for m in made] == sizes
    assert [m[3] for m in made] == [[0.0] * 3, [0.3] * 3]
    assert made[0][0] == [(FREQ, 0, "sweep1"), (FREQ, 1, "sweep3")]
    # shares of the config's learning rate, 3e-3
    assert made[0][1] == pytest.approx([1 / 3, 1 / 3])
    assert made[1][1] == pytest.approx([2 / 3])
    assert (got[1]["best_epoch"], got[1]["best_val_mse"], got[1]["val_mse"]) \
        == (1, 2.0, 3.0)


def test_refusals(fields, tmp_path):
    pcfg = experiment(pc, fields, str(tmp_path), 8)
    jcfg = experiment(jc, fields, str(tmp_path), 8)
    for mod, cfg in ((sweep, pcfg), (jax_sweep, jcfg)):
        with pytest.raises(ValueError, match="hidden"):
            mod.sweep_cvt(cfg, FREQ, [{"lr": 1e-3, "seed": 0, "hidden": 64}],
                          epochs=1, verbose=False)
        with pytest.raises(ValueError, match="no dropout"):
            mod.sweep_ffn(dataclasses.replace(cfg, inputs="par"), FREQ,
                          [{"lr": 1e-3, "seed": 0, "dropout": 0.1}],
                          epochs=1, verbose=False)


@pytest.mark.parametrize("args", [
    ([1e-3, 1e-4],), ([1e-3], [0.0, 0.1], [0, 1]),
    ([3e-3, 1e-3], (None,), [4], [8, 16, 32])])
def test_grid_points_match_jax(args):
    assert sweep.grid_points(*args) == jax_sweep.grid_points(*args)


SPACE = {"train.learning_rate": [1e-3, 3e-4, 1e-4],
         "train.batch_size": [32, 64], "ffn_hidden": [64, 256]}


def test_config_points_and_set_path_match_jax():
    assert sweep.config_grid_points(SPACE) == \
        jax_sweep.config_grid_points(SPACE)
    assert len(sweep.config_grid_points(SPACE)) == 12
    for seed in (0, 7):
        assert sweep.config_random_points(SPACE, 9, seed) == \
            jax_sweep.config_random_points(SPACE, 9, seed)
    for point in sweep.config_random_points(SPACE, 4, 3):
        mine, theirs = pc.ExperimentConfig(), jc.ExperimentConfig()
        for path, value in point.items():
            mine = sweep._set_path(mine, path, value)
            theirs = jax_sweep._set_path(theirs, path, value)
        for path, value in point.items():
            a, b = mine, theirs
            for part in path.split("."):
                a, b = getattr(a, part), getattr(b, part)
            assert a == b == value
    spec = sweep._set_path(pc.ExperimentConfig(), "model.proc_hidden", 64)
    assert spec.model.proc_hidden == 64


def test_config_sweep_leaderboard_matches_jax(tmp_path, capsys):
    def trial(cfg):
        return {"val_loss": cfg.train.learning_rate * cfg.train.batch_size
                + cfg.ffn_hidden * 1e-6, "hidden": cfg.ffn_hidden}

    outs = {}
    for name, mod, base in (("port", sweep, pc.ExperimentConfig()),
                            ("jax", jax_sweep, jc.ExperimentConfig())):
        out = str(tmp_path / f"{name}.xlsx")
        outs[name] = (mod.run_config_sweep(base, SPACE, trial, mode="random",
                                           n_random=5, seed=1, out_path=out),
                      read_xlsx(out))
    assert outs["port"] == outs["jax"]
    trials, sheets = outs["port"]
    assert [t["val_loss"] for t in trials] == sorted(
        t["val_loss"] for t in trials)
    assert sheets["sweep"][0][:4] == ["trial", "train.learning_rate",
                                      "train.batch_size", "ffn_hidden"]
    assert "trial 5/5" in capsys.readouterr().out


def test_cli_ffn_sweep_matches_jax(fields, tmp_path):
    """``sweep --inputs par --hidden 8,16`` through both command lines."""
    paths = {}
    for name, mod, save, m in (("port", cli, pc.save_config, pc),
                               ("jax", jax_cli, jax_save_config, jc)):
        cfg = experiment(m, fields, str(tmp_path / name), 8)
        cfg_path = str(tmp_path / f"{name}.json")
        save(dataclasses.replace(cfg, frequencies=(FREQ,)), cfg_path)
        argv = ["sweep", "--config", cfg_path, "--inputs", "par",
                "--hidden", "8,16", "--epochs", "2"]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
        res = cfg.result_dir
        with open(os.path.join(res, f"sweep_{FREQ}_par.json")) as f:
            summary = json.load(f)
        paths[name] = (summary, sorted(
            os.path.relpath(os.path.join(d, f), res)
            for d, _, fs in os.walk(res) for f in fs))
    (mine, my_files), (theirs, their_files) = paths["port"], paths["jax"]
    assert mine.keys() == theirs.keys()
    assert (mine["freq"], mine["inputs"], mine["n_points"]) == \
        (theirs["freq"], theirs["inputs"], theirs["n_points"]) == \
        (FREQ, "par", 2)
    assert sorted((r["hidden"], tuple(sorted(r))) for r in mine["results"]) \
        == sorted((r["hidden"], tuple(sorted(r)))
                  for r in theirs["results"])
    assert my_files == their_files
    assert any("sweep1" in f for f in my_files) and \
        any("sweep2" in f for f in my_files)
