"""The port's command line, harness and config files on the CPU, against the
JAX package.

A synthetic JPEG tree and xlsx pair under ``tmp_path``
(tests/test_torch_data.py ``write_fixture``, ``write_jpegs``: 2 groups x 5
pieces x 4 layers, decoded to 64x64) is decoded once through cv2 into the
shared cache, which both packages then read (the JAX native decoder
differs from cv2 by one grey level on about 0.1% of pixels).  The JAX
``harness.train_target`` and ``test_target`` and the port's
``cli.main([... "--device", "cpu"])`` train one target for one epoch from
the same weights (one epoch-0 checkpoint written into both packages'
checkpoint directories, which both harnesses resume from) on one batch
(32 training images, so the two shuffles change only the order of
summation), dropout 0, and test it.  The port's router sends stage 1
through ``FlashAttention`` (its thresholds lowered: 64x64 images give 256
tokens), stages 2 and 3 through ``attention_small``; JAX runs XLA
attention on the CPU.

- both write the same artifact paths and the same Predictions_Metrics and
  records schema; the records within 1e-4 relative (the tolerance of
  tests/test_torch_train_loop.py) up to the Adam step and the validation
  columns after it within 1e-3 (see ``test_records_match_jax``), the
  predictions within 1e-3, the
  metrics (MSE, MAE and 1 - R², which is MSE over the labels' variance)
  within 1e-3 relative;
- a config JSON written by each package loads in the other; a JAX field the
  port cannot honour raises, the JAX-only ones at their defaults load;
- a second ``train`` with more epochs resumes from the latest checkpoint;
- ``test`` without matplotlib writes the sheet and says the plots were not.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from test_torch_data import write_fixture, write_jpegs
from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu import harness as jax_harness
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from transformer_stm_tpu_torch import cli, config, harness
from transformer_stm_tpu_torch.data import images
from transformer_stm_tpu_torch.data.xlsx import read_table
from transformer_stm_tpu_torch.kernels import flash_attention as port_fa
from transformer_stm_tpu_torch.ops import attention as port_attention
from transformer_stm_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)
from transformer_stm_tpu_torch.train.metrics import (HEADER,
                                                     read_predictions_metrics)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREQ = "50HZ_Bm"
RTOL = 1e-4
VAL_RTOL = 1e-3
HW = 64


def _spec(mod):
    base = mod.CvTSpec(image_height=HW, image_width=HW)
    return dataclasses.replace(base, stages=tuple(
        dataclasses.replace(st, embed_dim=d, num_heads=h, dropout_rate=0.0)
        for st, d, h in zip(base.stages, (16, 32, 64), (1, 2, 4))))


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """The JPEG tree, sheets and the shared decode cache."""
    root = str(tmp_path_factory.mktemp("corpus"))
    fields, corpus = write_fixture(root, groups=2, layers=4, hw=HW,
                                   freqs=(FREQ, "50HZ_Hc"), missing=())
    write_jpegs(fields, corpus)
    images.decode_corpus(config.DataConfig(**fields), verbose=False)
    return fields


def _configs(fields, result_dir, epochs=1):
    """The same experiment in both packages: one target, batch 32 (the
    whole training split), one epoch, a checkpoint every epoch."""
    kw = dict(frequencies=(FREQ,), result_dir=result_dir)
    train = dict(batch_size=32, epochs=epochs, learning_rate=3e-3,
                 checkpoint_every=1)
    port = config.ExperimentConfig(
        model=_spec(config), data=config.DataConfig(**fields),
        train=config.TrainConfig(**train), **kw)
    jax_cfg = jax_config.ExperimentConfig(
        model=_spec(jax_config), data=jax_config.DataConfig(**fields),
        train=jax_config.TrainConfig(**train), **kw)
    return port, jax_cfg


def _seed_weights(jax_cfg, result_dirs):
    """One epoch-0 checkpoint of the JAX model's initial weights, written
    into both packages' checkpoint directories."""
    spec = jax_harness._spec_for(jax_cfg)
    params, state = jax_init_cvt(jax.random.PRNGKey(3), spec)
    for rd in result_dirs:
        paths = jax_harness._paths(dataclasses.replace(jax_cfg,
                                                       result_dir=rd), FREQ)
        jax_save_checkpoint(paths["weights"] + ".ckpts", params, state, None,
                            step=0)


@pytest.fixture(scope="module")
def runs(corpus_dir, tmp_path_factory):
    """Both packages train and test one target; the port through its CLI
    from a config JSON the JAX package wrote."""
    base = str(tmp_path_factory.mktemp("runs"))
    dirs = {p: os.path.join(base, p) for p in ("jax", "port")}
    port_cfg, jax_cfg = _configs(corpus_dir, dirs["jax"])
    _seed_weights(jax_cfg, dirs.values())
    jax_harness.train_target(jax_cfg, FREQ, verbose=False)
    jax_out = jax_harness.test_target(jax_cfg, FREQ, verbose=False)

    cfg_path = os.path.join(base, "jax_written.json")
    jax_config.save_config(
        dataclasses.replace(jax_cfg, result_dir=dirs["port"]), cfg_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_attention, "FLASH_MIN_KEYS", 256)
    mp.setattr(port_attention, "SMALL_MIN_ENTRIES", 0)
    calls = []
    real = port_attention.flash_attention

    def spy(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    mp.setattr(port_attention, "flash_attention", spy)
    try:
        cli.main(["train", "--config", cfg_path, "--device", "cpu"])
        port_out = cli.main(["test", "--config", cfg_path, "--device",
                             "cpu"])[(FREQ, None)]
    finally:
        mp.undo()
    return dict(dirs=dirs, jax=jax_out, port=port_out, cfg_path=cfg_path,
                flash_calls=calls, port_cfg=port_cfg)


def test_cli_runs_stage1_through_flash(runs):
    # 1 training step and 1 validation batch, then 1 test batch; 16x16
    # tokens at stage 1, none elsewhere
    assert runs["flash_calls"] == [256, 256, 256]
    assert port_fa.flash_attention.launches == 0  # CPU: the plain version


def test_artifact_paths_and_schema_match_jax(runs):
    for key in ("weights", "records", "metrics", "plot_scatter",
                "plot_lines"):
        rel = [os.path.relpath(runs[p]["paths"][key], runs["dirs"][p])
               for p in ("jax", "port")]
        assert rel[0] == rel[1], key
        if key != "weights":
            assert os.path.exists(runs["port"]["paths"][key]), key
    sheets = [read_predictions_metrics(runs[p]["paths"]["metrics"])
              for p in ("jax", "port")]
    assert sheets[0]["header"] == sheets[1]["header"] == HEADER
    for key in ("train_num", "test_num"):
        assert sheets[0][key] == sheets[1][key]
    assert len(sheets[1]["predictions"]) == sheets[1]["test_num"] == 8
    np.testing.assert_allclose(sheets[1]["predictions"],
                               sheets[0]["predictions"], atol=1e-3, rtol=0)
    # R² = 1 - MSE / var(actual), and the 8 validation labels take two
    # values, so 1 - R² is compared as the MSE is: within 1e-3 relative.
    for key, f in (("mse", float), ("mae", float), ("r2", lambda r: 1 - r)):
        np.testing.assert_allclose(f(runs["port"][key]), f(runs["jax"][key]),
                                   rtol=1e-3, atol=0, err_msg=key)
        assert sheets[1][key] == runs["port"][key]


def test_records_match_jax(runs):
    cols, rows = zip(*(read_table(runs[p]["paths"]["records"])
                       for p in ("jax", "port")))
    assert cols[0] == cols[1] == ["epoch", "loss", "mae", "val_loss",
                                  "val_mae", "lr"]
    assert [r[0] for r in rows[1]] == [1]
    got, want = (np.asarray(r, np.float64) for r in (rows[1], rows[0]))
    # epoch, loss, mae and lr come before the Adam step
    np.testing.assert_allclose(got[:, [0, 1, 2, 5]], want[:, [0, 1, 2, 5]],
                               rtol=RTOL, atol=0)
    # val_loss and val_mae come after it: its first step moves a weight by
    # about lr * sign(g) whatever |g|, so gradients at float noise land lr
    # apart in the two packages.  The records differ by 2.3e-4 relative
    # here, and by the same with the port's attention all plain.
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=VAL_RTOL,
                               atol=0)


def test_final_checkpoints_load_in_the_other_package(runs, corpus_dir):
    """The port's final weights load in the JAX test_target; both final
    checkpoints carry the resumed epoch count."""
    port_final = latest_checkpoint(runs["port"]["paths"]["weights"])
    jax_final = latest_checkpoint(runs["jax"]["paths"]["weights"])
    assert load_checkpoint(port_final)[3] == load_checkpoint(jax_final)[3] \
        == 1
    _, jax_cfg = _configs(corpus_dir, runs["dirs"]["port"])
    out = jax_harness.test_target(jax_cfg, FREQ, verbose=False)
    np.testing.assert_allclose(out["r2"], runs["port"]["r2"], atol=1e-3,
                               rtol=0)


def test_train_resumes_from_the_latest_checkpoint(runs, capsys):
    cfg_path = runs["cfg_path"]
    cli.main(["train", "--config", cfg_path, "--device", "cpu", "--epochs",
              "2"])
    out = capsys.readouterr().out
    assert "ckpt_000001.npz at epoch 1" in out
    cols, rows = read_table(runs["port"]["paths"]["records"])
    assert [r[0] for r in rows] == [2]
    assert load_checkpoint(latest_checkpoint(
        runs["port"]["paths"]["weights"]))[3] == 2


def test_config_json_round_trips_between_packages(tmp_path):
    port_cfg = config.ExperimentConfig(
        model=config.cvt_highres_spec(512),
        train=config.TrainConfig(repeats=3, checkpoint_every=5))
    config.save_config(port_cfg, str(tmp_path / "port.json"))
    theirs = jax_config.load_config(str(tmp_path / "port.json"))
    assert theirs.model == jax_config.cvt_highres_spec(512)
    assert (theirs.train.repeats, theirs.train.checkpoint_every) == (3, 5)
    assert jax_config._to_jsonable(theirs)["data"] == \
        config._to_jsonable(port_cfg)["data"]

    jax_cfg = jax_config.ExperimentConfig(
        model=jax_config.cvt_highres_spec(384),
        train=jax_config.TrainConfig(seed=4, prng_impl="threefry2x32"))
    jax_config.save_config(jax_cfg, str(tmp_path / "jax.json"))
    ours = config.load_config(str(tmp_path / "jax.json"))
    assert ours.model == config.cvt_highres_spec(384)
    assert ours.train.seed == 4
    assert ours.data.data_root == jax_cfg.data.data_root
    config.save_config(ours, str(tmp_path / "again.json"))
    again = jax_config.load_config(str(tmp_path / "again.json"))
    assert dataclasses.replace(again, train=dataclasses.replace(
        again.train, prng_impl="threefry2x32")) == jax_cfg


@pytest.mark.parametrize("change,error", [
    (dict(ffn_hidden=128), NotImplementedError),
    (dict(train=dict(loss="softmax_xent")), None),
    (dict(train=dict(label_smoothing=0.1)), None),
    (dict(train=dict(compute_dtype="bfloat16")), None),
    (dict(mesh=dict(data=8, model=1)), ValueError),
    (dict(extra_key=1), ValueError),
], ids=["ffn_hidden", "loss", "label_smoothing", "compute_dtype", "mesh",
        "unknown"])
def test_unported_jax_fields_raise(tmp_path, change, error):
    """A JAX-written config with a field the port lacks raises; the fields
    ported since (``error`` None: the ViT trainer's loss and label
    smoothing, bfloat16 compute) load with the JAX value and round-trip to
    JAX."""
    d = jax_config._to_jsonable(jax_config.ExperimentConfig())
    for key, value in change.items():
        if isinstance(value, dict):
            d[key].update(value)
        else:
            d[key] = value
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    if error is not None:
        with pytest.raises(error):
            config.load_config(str(path))
        return
    ours = config.load_config(str(path))
    for key, value in change["train"].items():
        assert getattr(ours.train, key) == value
    config.save_config(ours, str(tmp_path / "again.json"))
    again = jax_config.load_config(str(tmp_path / "again.json"))
    jax_cfg = jax_config.load_config(str(path))
    assert dataclasses.replace(again, train=dataclasses.replace(
        again.train, prng_impl=jax_cfg.train.prng_impl)) == jax_cfg


def test_save_config_subcommand_writes_what_jax_reads(tmp_path, capsys):
    out = str(tmp_path / "c.json")
    cli.main(["save-config", "--out", out, "--epochs", "7", "--freq",
              "200HZ_Pcv", "--result-dir", "R"])
    assert "wrote" in capsys.readouterr().out
    cfg = jax_config.load_config(out)
    assert (cfg.train.epochs, cfg.frequencies, cfg.result_dir) == \
        (7, ("200HZ_Pcv",), "R")


def test_params_only_inputs_are_not_ported(runs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["train", "--config", runs["cfg_path"], "--inputs", "par",
                  "--device", "cpu"])


def test_test_without_matplotlib_writes_the_sheet(runs, monkeypatch, capsys,
                                                  tmp_path):
    """The card's machine has no matplotlib: the sheet is written, the plots
    are not, and one line says so."""
    cfg = dataclasses.replace(runs["port_cfg"],
                              result_dir=runs["dirs"]["port"])
    paths = harness._paths(cfg, FREQ)
    for key in ("metrics", "plot_scatter", "plot_lines"):
        os.remove(paths[key])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    harness.test_target(cfg, FREQ, device="cpu")
    assert "plots not written" in capsys.readouterr().out
    assert os.path.exists(paths["metrics"])
    assert not os.path.exists(paths["plot_scatter"])
    assert not os.path.exists(paths["plot_lines"])


def test_new_modules_import_without_jax_or_matplotlib():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import transformer_stm_tpu_torch.cli, "
            "transformer_stm_tpu_torch.harness, "
            "transformer_stm_tpu_torch.tools.plots, "
            "transformer_stm_tpu_torch.kernels.flash_attention, "
            "transformer_stm_tpu_torch.kernels.fused_layer, "
            "transformer_stm_tpu_torch.models.vit\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('transformer_stm_tpu', 'matplotlib')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
