"""The port's params-only FFN against the JAX package's on the CPU.

- ``ffn_forward`` from weights carried over from JAX ``init_ffn`` (hidden
  256 and 64): atol 1e-5;
- the committed trained JAX FFN checkpoint
  (persist/Weight/Parameters/Vit_model_weights_200HZ_Bm_1) loaded by the
  port predicts JAX's values within 1e-5 (skipped where it is absent);
- ``harness._train_ffn`` against JAX's from the same initial weights (JAX's
  ``init_ffn(PRNGKey(seed))``, passed to the port as ``model=``), 4 epochs
  with the lr decayed every 2, one batch an epoch (30 rows padded to 32 and
  masked), so that the two packages' shuffles only reorder a sum: records
  and predictions within 1e-4 relative;
- FFN checkpoints round-trip both ways (parameters and Adam state
  bit-equal), and JAX's ``export-h5`` lookup finds the port's ``fc1`` and
  ``final`` kernels by name;
- ``harness.run(mode="train")`` then ``"test"`` with ``inputs="par"`` on a
  synthetic sheet fixture (tests/test_torch_data.py ``write_fixture``)
  writes the same artifacts as JAX's: records within 1e-4 relative,
  predictions within 1e-4, the metrics (MSE, MAE, 1 - R²) within 1e-3
  relative; a "(many)" repeat run draws its FFN from seed + 1000 * time;
- ``adam_apply`` with its lr and bias corrections as 0-dim tensors (what
  ``_train_ffn`` reads from device buffers, so that a CUDA graph can
  replay its epochs) updates bit for bit as ``adam_update``, over 5 steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_data import write_fixture
from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu import harness as jax_harness
from transformer_stm_tpu.models.ffn import ffn_forward as jax_ffn_forward
from transformer_stm_tpu.models.ffn import init_ffn as jax_init_ffn
from transformer_stm_tpu.train import checkpoint as jax_ckpt
from transformer_stm_tpu.train.optimizer import adam_init as jax_adam_init
from transformer_stm_tpu_torch import config, harness
from transformer_stm_tpu_torch.models import ffn as port_ffn
from transformer_stm_tpu_torch.models.ffn import ffn_forward, init_ffn
from transformer_stm_tpu_torch.data.xlsx import read_table
from transformer_stm_tpu_torch.train.checkpoint import (
    adam_from_jax, ffn_from_jax_params, ffn_to_jax_params, latest_checkpoint,
    load_checkpoint, save_checkpoint)
from transformer_stm_tpu_torch.train.metrics import read_predictions_metrics
from transformer_stm_tpu_torch.train.optimizer import (adam_apply,
                                                       adam_init,
                                                       adam_update)

HERE = os.path.dirname(os.path.abspath(__file__))
TRAINED = os.path.join(HERE, "..", "persist", "Weight", "Parameters",
                       "Vit_model_weights_200HZ_Bm_1", "ckpt_001000.npz")
FREQ = "50HZ_Bm"
RTOL = 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_predict(model, x):
    with torch.no_grad():
        return ffn_forward(model, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("hidden", [256, 64])
def test_ffn_forward_matches_jax(hidden):
    params = jax_init_ffn(jax.random.PRNGKey(3), proc_dim=5, hidden=hidden)
    model = ffn_from_jax_params(np_tree(params), device="cpu")
    x = np.random.default_rng(0).standard_normal((37, 5)).astype(np.float32)
    want = np.asarray(jax_ffn_forward(params, jnp.asarray(x)))
    np.testing.assert_allclose(port_predict(model, x), want, atol=1e-5,
                               rtol=0)
    assert [n for n, _ in model.named_parameters()] == [
        "fc1.kernel", "fc1.bias", "fc2.kernel", "fc2.bias", "final.kernel",
        "final.bias"]


def test_init_ffn_is_seeded_and_glorot():
    a = init_ffn(5, 256, 1, torch.Generator().manual_seed(0), device="cpu")
    b = init_ffn(5, 256, 1, torch.Generator().manual_seed(0), device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    limit = np.sqrt(6.0 / (256 + 256))
    assert a.fc2.kernel.abs().max() <= limit and not a.fc2.bias.any()


@pytest.mark.skipif(not os.path.exists(TRAINED),
                    reason="trained FFN checkpoint not in this checkout")
def test_trained_jax_checkpoint_predicts_as_jax():
    template = jax_init_ffn(jax.random.PRNGKey(0))
    params, _, _, step = jax_ckpt.load_checkpoint(TRAINED, template, {})
    np_params, state, opt, port_step = load_checkpoint(TRAINED)
    assert state == {} and port_step == step == 1000
    model = ffn_from_jax_params(np_params, device="cpu")
    adam = adam_from_jax(opt, model, "cpu")
    assert adam.step == int(np.asarray(opt["step"])) > 0
    x = np.random.default_rng(1).standard_normal((64, 5)).astype(np.float32)
    want = np.asarray(jax_ffn_forward(params, jnp.asarray(x)))
    np.testing.assert_allclose(port_predict(model, x), want, atol=1e-5,
                               rtol=1e-5)


def _cfgs(**train):
    kw = dict(inputs="par", frequencies=(FREQ,))
    return (config.ExperimentConfig(train=config.TrainConfig(**train), **kw),
            jax_config.ExperimentConfig(train=jax_config.TrainConfig(**train),
                                        **kw))


def _toy(n_train, n_val, seed=0):
    rng = np.random.default_rng(seed)
    proc = rng.standard_normal((n_train + n_val, 5)).astype(np.float32)
    y = (proc @ np.arange(1, 6) / 5 + 1.5).astype(np.float32)
    return proc, y, np.arange(n_train), np.arange(n_train, n_train + n_val)


@pytest.fixture(scope="module")
def ffn_runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ffn"))
    port_cfg, jax_cfg = _cfgs(batch_size=32, epochs=4, learning_rate=3e-3,
                              lr_decay_every=2, seed=5)
    proc, y, tr, va = _toy(30, 9)
    paths = {p: {"weights": os.path.join(base, p, "w"),
                 "records": os.path.join(base, p, "records.xlsx")}
             for p in ("jax", "port")}
    jax_out = jax_harness._train_ffn(jax_cfg, FREQ, proc, y, tr, va,
                                     paths["jax"], None, False)
    init = jax_init_ffn(jax.random.PRNGKey(5), proc_dim=5,
                        hidden=jax_cfg.ffn_hidden)
    port_out = harness._train_ffn(
        port_cfg, FREQ, proc, y, tr, va, paths["port"], verbose=False,
        device="cpu", model=ffn_from_jax_params(np_tree(init), device="cpu"))
    return dict(paths=paths, jax=jax_out, port=port_out, data=(proc, y, va))


def test_train_ffn_records_match_jax(ffn_runs):
    got = np.asarray(ffn_runs["port"]["records"], np.float64)
    want = np.asarray(ffn_runs["jax"]["records"], np.float64)
    assert got.shape == want.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    cols = [read_table(ffn_runs["paths"][p]["records"]) for p in
            ("jax", "port")]
    assert cols[0][0] == cols[1][0]
    np.testing.assert_allclose(np.asarray(cols[1][1], np.float64),
                               np.asarray(cols[0][1], np.float64),
                               rtol=RTOL, atol=0)


def test_train_ffn_checkpoint_predicts_as_jax(ffn_runs):
    proc, _, va = ffn_runs["data"]
    paths = ffn_runs["paths"]
    port_ck = latest_checkpoint(paths["port"]["weights"])
    jax_ck = latest_checkpoint(paths["jax"]["weights"])
    params, _, opt, step = load_checkpoint(port_ck)
    assert step == 4 and int(opt["step"]) == 4
    with open(port_ck[:-4] + ".json") as f:
        assert '"config": "par"' in f.read()
    template = jax_init_ffn(jax.random.PRNGKey(0))
    jparams, _, _, _ = jax_ckpt.load_checkpoint(jax_ck, template, {})
    got = port_predict(ffn_from_jax_params(params, device="cpu"), proc[va])
    want = np.asarray(jax_ffn_forward(jparams, jnp.asarray(proc[va])))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_ffn_checkpoints_round_trip_both_ways(tmp_path):
    model = init_ffn(5, 64, 1, torch.Generator().manual_seed(2),
                     device="cpu")
    opt = adam_init(model)
    opt.step = 7
    for m in list(opt.mu.values()) + list(opt.nu.values()):
        m.uniform_(0.0, 1.0)
    path = save_checkpoint(str(tmp_path / "port"), model, opt, step=3,
                           metadata={"config": "par"})
    template = jax_init_ffn(jax.random.PRNGKey(0), hidden=64)
    params, state, jopt, step = jax_ckpt.load_checkpoint(
        path, template, {}, jax_adam_init(template))
    assert step == 3 and int(jopt.step) == 7 and state == {}
    want = ffn_to_jax_params(model)
    for k in ("fc1", "fc2", "final"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(params[k][leaf]),
                                          want[k][leaf])
            np.testing.assert_array_equal(
                np.asarray(jopt.mu[k][leaf]),
                opt.mu[f"{k}.{leaf}"].numpy())
    # JAX's export-h5 par branch reads the widths from these two kernels
    with np.load(path) as z:
        fc1 = next(z[k] for k in z.files if "fc1" in k and "kernel" in k)
        final = next(z[k] for k in z.files if "final" in k and "kernel" in k)
    assert fc1.shape == (5, 64) and final.shape == (64, 1)

    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), params, {},
                                     jopt, step=3)
    p2, s2, o2, step2 = load_checkpoint(jpath)
    back = ffn_from_jax_params(p2, device="cpu")
    adam = adam_from_jax(o2, back, "cpu")
    assert step2 == 3 and adam.step == 7 and s2 == {}
    for (n, p), (_, q) in zip(back.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(p, q), n
    for n in opt.nu:
        assert torch.equal(adam.nu[n], opt.nu[n]), n


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """Both harnesses train and test the FFN of one target from the same
    initial weights: the port's ``init_ffn`` is patched to carry JAX's."""
    root = str(tmp_path_factory.mktemp("par"))
    fields, _ = write_fixture(root, groups=2, layers=4)
    train = dict(batch_size=32, epochs=3, learning_rate=3e-3,
                 lr_decay_every=2, seed=1)
    dirs = {p: os.path.join(root, p) for p in ("jax", "port")}
    port_cfg = config.ExperimentConfig(
        inputs="par", frequencies=(FREQ,), result_dir=dirs["port"],
        data=config.DataConfig(**fields), train=config.TrainConfig(**train))
    jax_cfg = jax_config.ExperimentConfig(
        inputs="par", frequencies=(FREQ,), result_dir=dirs["jax"],
        data=jax_config.DataConfig(**fields),
        train=jax_config.TrainConfig(**train))
    jax_harness.run(jax_cfg, mode="train", verbose=False)
    jax_res = jax_harness.run(jax_cfg, mode="test", verbose=False)

    def carried(proc_dim, hidden, num_classes, generator, device="cuda"):
        params = jax_init_ffn(jax.random.PRNGKey(generator.initial_seed()),
                              proc_dim, hidden, num_classes)
        return ffn_from_jax_params(np_tree(params), device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_ffn, "init_ffn", carried)
    try:
        harness.run(port_cfg, mode="train", verbose=False, device="cpu")
    finally:
        mp.undo()
    port_res = harness.run(port_cfg, mode="test", verbose=False,
                           device="cpu")
    return dict(dirs=dirs, jax=jax_res[(FREQ, None)],
                port=port_res[(FREQ, None)], cfgs=(port_cfg, jax_cfg))


def test_run_par_writes_jax_artifacts(harness_runs):
    r = harness_runs
    for key in ("weights", "records", "metrics", "plot_scatter",
                "plot_lines"):
        rel = [os.path.relpath(r[p]["paths"][key], r["dirs"][p])
               for p in ("jax", "port")]
        assert rel[0] == rel[1], key
        assert os.path.exists(r["port"]["paths"][key]), key
    assert "Parameters" in r["port"]["paths"]["metrics"]
    cols, rows = zip(*(read_table(r[p]["paths"]["records"])
                       for p in ("jax", "port")))
    assert cols[0] == cols[1]
    np.testing.assert_allclose(np.asarray(rows[1], np.float64),
                               np.asarray(rows[0], np.float64), rtol=RTOL,
                               atol=0)
    sheets = [read_predictions_metrics(r[p]["paths"]["metrics"])
              for p in ("jax", "port")]
    assert sheets[0]["header"] == sheets[1]["header"]
    for key in ("train_num", "test_num"):
        assert sheets[0][key] == sheets[1][key]
    np.testing.assert_allclose(sheets[1]["predictions"],
                               sheets[0]["predictions"], atol=1e-4, rtol=0)
    for key, f in (("mse", float), ("mae", float), ("r2", lambda v: 1 - v)):
        np.testing.assert_allclose(f(r["port"][key]), f(r["jax"][key]),
                                   rtol=1e-3, atol=0, err_msg=key)


def test_jax_test_target_reads_the_port_ffn(harness_runs):
    port_cfg, jax_cfg = harness_runs["cfgs"]
    out = jax_harness.test_target(
        dataclasses.replace(jax_cfg, result_dir=harness_runs["dirs"]["port"]),
        FREQ, verbose=False)
    np.testing.assert_allclose(out["mse"], harness_runs["port"]["mse"],
                               rtol=1e-5, atol=0)


def test_repeat_runs_seed_the_ffn_as_jax(harness_runs, monkeypatch):
    port_cfg, _ = harness_runs["cfgs"]
    seeds = []
    real = port_ffn.init_ffn

    def spy(proc_dim, hidden, num_classes, generator, device="cuda"):
        seeds.append(generator.initial_seed())
        return real(proc_dim, hidden, num_classes, generator, device)

    monkeypatch.setattr(port_ffn, "init_ffn", spy)
    harness.train_target(port_cfg, FREQ, time=2, epochs=1, verbose=False,
                         device="cpu")
    assert seeds == [port_cfg.train.seed + 2000]


def test_adam_apply_tensor_scalars_match_adam_update():
    models = [init_ffn(5, 16, 1, torch.Generator().manual_seed(3),
                       device="cpu") for _ in range(2)]
    opts = [adam_init(m) for m in models]
    rng = np.random.default_rng(0)
    for step in range(1, 6):
        grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                  .astype(np.float32))
                 for p in models[0].parameters()]
        lr = float(np.float32(1e-3) * np.float32(0.8) ** (step // 2))
        adam_update(grads, opts[0], list(models[0].parameters()), lr)
        t = np.float32(step)
        scalars = [torch.tensor(np.float32(v)) for v in (
            lr, np.float32(1.0) - np.power(np.float32(0.9), t),
            np.float32(1.0) - np.power(np.float32(0.999), t))]
        adam_apply(grads, opts[1], list(models[1].parameters()), *scalars)
    assert opts[0].step == 5 and opts[1].step == 0
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    for key in opts[0].mu:
        assert torch.equal(opts[0].mu[key], opts[1].mu[key])
        assert torch.equal(opts[0].nu[key], opts[1].nu[key])
