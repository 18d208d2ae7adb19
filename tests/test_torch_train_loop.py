"""The port's ``TrainLoop.fit`` against the JAX package's on the CPU, from
the same weights, on the same numpy data (TINY: 32x32 images, embed dims
8/16/16, dropout 0).

Each epoch is one batch (n = batch size), so the two loops' shuffles, which
come from different generators, change only the order of summation.  The
JAX loop trains 4 epochs with validation, lr x0.8 every 2 epochs and a
checkpoint after each epoch:

- the port's records and final predictions: within 1e-4 relative (f32 on
  both sides, four Adam steps);
- the port resumes the JAX checkpoint of epoch 2 for one epoch and lands on
  the JAX loop's epoch 3 (records row and predictions), within 1e-4;
- the records sheet reads back equal to the JAX writer's.
"""

import numpy as np
import pytest

import jax

from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.config import StageSpec as JaxStageSpec
from transformer_stm_tpu.config import TrainConfig as JaxTrainConfig
from transformer_stm_tpu.data.xlsx import read_xlsx as jax_read_xlsx
from transformer_stm_tpu.train.loop import TrainLoop as JaxTrainLoop
from transformer_stm_tpu.train.metrics import \
    RecordsWriter as JaxRecordsWriter
from transformer_stm_tpu_torch.config import CvTSpec, StageSpec, TrainConfig
from transformer_stm_tpu_torch.data.xlsx import read_xlsx
from transformer_stm_tpu_torch.train.checkpoint import from_jax_params
from transformer_stm_tpu_torch.train.loop import TrainLoop
from transformer_stm_tpu_torch.train.metrics import RecordsWriter

BS = 8
RTOL = 1e-4


def tiny(spec_cls, stage_cls, rate=0.0):
    return spec_cls(stages=(
        stage_cls(embed_dim=8, patch_size=7, stride=4, num_heads=1,
                  dropout_rate=rate),
        stage_cls(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                  dropout_rate=rate),
        stage_cls(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                  with_cls_token=True, dropout_rate=rate),
    ), image_height=32, image_width=32)


def toy_data(n, seed):
    """uint8 images and a learnable label: mean pixel plus a linear term
    in proc (tests/test_train.py's toy data)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, 32, 32, 1), dtype=np.uint8)
    proc = rng.normal(size=(n, 5)).astype(np.float32)
    labels = (images.astype(np.float32).mean((1, 2, 3)) / 255.0
              + proc @ np.arange(1, 6).astype(np.float32))
    return images, proc, labels


CFG = dict(epochs=4, batch_size=BS, learning_rate=3e-3, lr_decay_every=2,
           checkpoint_every=1)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    images, proc, labels = toy_data(BS, seed=1)
    val = toy_data(5, seed=2)
    loop = JaxTrainLoop(tiny(JaxCvTSpec, JaxStageSpec), JaxTrainConfig(**CFG))
    params0 = jax.tree_util.tree_map(np.array, loop.params)
    state0 = jax.tree_util.tree_map(np.array, loop.state)
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpts"))
    out = loop.fit(images, proc, labels, val=val, verbose=False,
                   checkpoint_dir=ckpt_dir)
    return dict(data=(images, proc, labels), val=val, params0=params0,
                state0=state0, rows=out["records"].rows,
                preds=loop.predict(*val[:2]), ckpt_dir=ckpt_dir)


def port_loop(params, state, **cfg):
    model = from_jax_params(params, state, tiny(CvTSpec, StageSpec),
                            device="cpu")
    return TrainLoop(tiny(CvTSpec, StageSpec), TrainConfig(**cfg),
                     device="cpu", model=model)


@pytest.fixture(scope="module")
def port_run(jax_run):
    loop = port_loop(jax_run["params0"], jax_run["state0"], **CFG)
    out = loop.fit(*jax_run["data"], val=jax_run["val"], verbose=False)
    return dict(rows=out["records"].rows, preds=loop.predict(
        *jax_run["val"][:2]), epoch=loop.epoch)


def assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[5] == pytest.approx(w[5], rel=1e-7)
        np.testing.assert_allclose(g[1:5], w[1:5], rtol=RTOL, atol=0)


def test_fit_records_match_jax(jax_run, port_run):
    assert port_run["epoch"] == 4
    assert_rows_close(port_run["rows"], jax_run["rows"])
    assert [r[5] for r in port_run["rows"]] == pytest.approx(
        [3e-3, 3e-3, 2.4e-3, 2.4e-3])
    # the model learned something in four steps
    assert port_run["rows"][-1][1] < port_run["rows"][0][1]


def test_fit_predictions_match_jax(jax_run, port_run):
    np.testing.assert_allclose(port_run["preds"], jax_run["preds"],
                               rtol=RTOL, atol=0)


def test_port_resumes_a_jax_checkpoint(jax_run):
    """JAX trains 2 epochs and saves; the port resumes (parameters,
    BatchNorm state, Adam moments and step, epoch) for one epoch and equals
    JAX's third straight epoch."""
    loop = port_loop(jax_run["params0"], jax_run["state0"], **CFG)
    loop.load_checkpoint(f"{jax_run['ckpt_dir']}/ckpt_000002.npz")
    assert loop.epoch == 2 and loop.opt.step == 2
    out = loop.fit(*jax_run["data"], val=jax_run["val"], epochs=3,
                   verbose=False)
    assert_rows_close(out["records"].rows, jax_run["rows"][2:3])
    jax_epoch3 = port_loop(jax_run["params0"], jax_run["state0"], **CFG)
    jax_epoch3.load_checkpoint(f"{jax_run['ckpt_dir']}/ckpt_000003.npz")
    np.testing.assert_allclose(loop.predict(*jax_run["val"][:2]),
                               jax_epoch3.predict(*jax_run["val"][:2]),
                               rtol=RTOL, atol=0)


def test_records_sheet_matches_jax_writer(tmp_path, jax_run):
    rows = jax_run["rows"]
    ours, theirs = RecordsWriter(), JaxRecordsWriter()
    for w in (ours, theirs):
        for r in rows:
            w.log(r[0] - 1, *r[1:])
        w.log(len(rows), 1.5, 0.5, None, None, 1e-3)  # no validation
    ours.write(str(tmp_path / "port" / "records.xlsx"))
    theirs.write(str(tmp_path / "jax" / "records.xlsx"))
    got = read_xlsx(str(tmp_path / "port" / "records.xlsx"))
    want = jax_read_xlsx(str(tmp_path / "jax" / "records.xlsx"))
    assert got == want
    assert got["Sheet1"][0] == RecordsWriter.COLUMNS
    assert got["Sheet1"][-1][3:5] == [None, None]
