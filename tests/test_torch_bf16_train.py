"""bfloat16 training of the CvT in the port, on the CPU, against the JAX
package's bfloat16 compute (``TrainConfig(compute_dtype="bfloat16")``:
images and process parameters cast after augmentation, float32 parameters,
optimizer state, BatchNorm statistics, loss and metrics).

TINY CvT (32x32, embed dims 8/16/16, cls token, dropout 0) from carried
JAX weights, the same numpy batch on both sides:

- the evaluation forward within 5e-2 x max(1, max |y|) of JAX's bfloat16
  ``cvt_forward``;
- one ``make_train_step`` step: the loss within 1e-2 relative of JAX's,
  each BatchNorm's moving statistics within 1e-3 relative to that
  BatchNorm's scale, the largest of its JAX moving mean and variance (one
  step from a zero mean leaves the mean at 1% of a bfloat16 batch mean, so
  the mean alone carries bfloat16's relative noise, 4e-3); the same for the multi-target trainer's step (the fused
  training MLP, ``mlp_impl="pallas"``) against JAX's ``cvt_forward`` with
  ``mlp_impl="pallas"`` under the Pallas interpreter; ``TrainLoop`` and
  ``MultiTargetTrainer`` train a bfloat16 epoch;
- ``predict(exact=True)`` under the bfloat16 config equals the float32
  config's prediction bit for bit.
"""

import dataclasses
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu import config as jc  # noqa: E402
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward  # noqa: E402
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt  # noqa: E402
from transformer_stm_tpu.train import loop as jloop  # noqa: E402
from transformer_stm_tpu.train.optimizer import adam_init as jax_adam_init  # noqa: E402
from transformer_stm_tpu_torch import config as pc  # noqa: E402
from transformer_stm_tpu_torch.models.cvt import cvt_forward  # noqa: E402
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    _flatten, from_jax_params, to_jax_params)
from transformer_stm_tpu_torch.train.loop import (  # noqa: E402
    TrainLoop, make_train_step)
from transformer_stm_tpu_torch.train.multi import MultiTargetTrainer  # noqa: E402
from transformer_stm_tpu_torch.train.optimizer import adam_init  # noqa: E402

from test_torch_data import write_fixture  # noqa: E402

FWD_TOL = 5e-2
LOSS_REL = 1e-2
STATE_TOL = 1e-3
BS = 8


def tiny(m):
    return m.CvTSpec(stages=(
        m.StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1,
                    dropout_rate=0.0),
        m.StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                    dropout_rate=0.0),
        m.StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                    with_cls_token=True, dropout_rate=0.0),
    ), image_height=32, image_width=32)


def carried(seed=0):
    params, state = jax_init_cvt(jax.random.PRNGKey(seed), tiny(jc))
    np_p = jax.tree_util.tree_map(np.array, params)
    np_s = jax.tree_util.tree_map(np.array, state)
    return params, state, np_p, np_s


def data(n=BS, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, 32, 32, 1)).astype(np.float32)
    proc = rng.standard_normal((n, 5)).astype(np.float32)
    labels = (images.mean((1, 2, 3)) + proc @ np.arange(1, 6)
              ).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return images, proc, labels, mask


def test_bfloat16_forward_matches_jax():
    params, state, np_p, np_s = carried()
    model = from_jax_params(np_p, np_s, tiny(pc), device="cpu")
    images, proc, _, _ = data()
    want, _ = jax.jit(lambda p, s, x, q: jax_cvt_forward(
        p, s, tiny(jc), x, q, impl="xla"))(
            params, state, jnp.asarray(images).astype(jnp.bfloat16),
            jnp.asarray(proc).astype(jnp.bfloat16))
    with torch.inference_mode():
        got = cvt_forward(model, torch.from_numpy(images).bfloat16(),
                          torch.from_numpy(proc).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want).astype(np.float32)
    assert np.abs(got.float().numpy() - want).max() <= FWD_TOL * max(
        1.0, np.abs(want).max())


def _compare_step(jax_loss, jax_state, port_loss, model):
    assert abs(port_loss - jax_loss) <= LOSS_REL * abs(jax_loss)
    _, port_state = to_jax_params(model)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jax_state))
    got = _flatten(port_state)
    assert set(got) == set(want) and want
    for k in want:
        bn = k.rsplit("/", 1)[0]
        scale = max(np.abs(want[bn + "/mean"]).max(),
                    np.abs(want[bn + "/var"]).max())
        assert np.abs(got[k] - want[k]).max() <= STATE_TOL * scale, k


def test_one_train_loop_step_in_bfloat16_matches_jax():
    params, state, np_p, np_s = carried()
    jcfg = jc.TrainConfig(batch_size=BS, compute_dtype="bfloat16")
    pcfg = pc.TrainConfig(batch_size=BS, compute_dtype="bfloat16")
    images, proc, labels, mask = data()
    step = jax.jit(jloop.make_train_step(tiny(jc), jcfg, impl="xla"))
    _, jstate, _, jm = step(params, state, jax_adam_init(params),
                            tuple(jnp.asarray(a) for a in
                                  (images, proc, labels, mask)),
                            jax.random.PRNGKey(0), jnp.float32(1e-3))
    model = from_jax_params(np_p, np_s, tiny(pc), device="cpu")
    m = make_train_step(pcfg)(model, adam_init(model), tuple(
        torch.from_numpy(a) for a in (images, proc, labels, mask)), None,
        1e-3)
    assert m["loss"].dtype == torch.float32
    _compare_step(float(jm["loss"]), jstate, float(m["loss"]), model)


def test_one_multi_target_step_in_bfloat16_matches_jax():
    """The multi-target trainer's slot step (train/multi.py's one_step in
    JAX: cvt_forward with the fused training MLP and the masked MSE; the
    Adam update after it is the one compared above), one slot, in
    bfloat16."""
    params, state, np_p, np_s = carried(seed=4)
    images, proc, labels, mask = data(seed=3)
    spec = tiny(jc)

    def loss_fn(p, st):
        out, new_state = jax_cvt_forward(
            p, st, spec, jnp.asarray(images).astype(jnp.bfloat16),
            jnp.asarray(proc).astype(jnp.bfloat16), train=True,
            rng=jax.random.PRNGKey(0), impl="xla", mlp_impl="pallas")
        pred = out.reshape(-1).astype(jnp.float32)
        se = jnp.sum(jnp.square(pred - labels) * mask)
        return se / jnp.sum(mask), new_state

    (jloss, jstate), _ = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, state)
    model = from_jax_params(np_p, np_s, tiny(pc), device="cpu")
    step = make_train_step(pc.TrainConfig(compute_dtype="bfloat16"),
                           mlp_impl="pallas")
    m = step(model, adam_init(model), tuple(
        torch.from_numpy(a) for a in (images, proc, labels, mask)), None,
        1e-3)
    _compare_step(float(jloss), jstate, float(m["loss"]), model)


def test_predict_exact_under_bfloat16_equals_float32():
    _, _, np_p, np_s = carried()
    images = (data()[0] * 255).astype(np.uint8)
    proc = data()[1]
    preds = []
    for dtype, exact in (("float32", False), ("bfloat16", True),
                         ("bfloat16", False)):
        model = from_jax_params(np_p, np_s, tiny(pc), device="cpu")
        loop = TrainLoop(tiny(pc), pc.TrainConfig(batch_size=4,
                                                  compute_dtype=dtype),
                         device="cpu", model=model)
        preds.append(loop.predict(images, proc, exact=exact))
    assert np.array_equal(preds[0], preds[1])
    assert not np.array_equal(preds[0], preds[2])
    assert np.abs(preds[2] - preds[0]).max() <= FWD_TOL * max(
        1.0, np.abs(preds[0]).max())


def test_train_loop_and_multi_trainer_train_in_bfloat16(tmp_path):
    images, proc, labels, _ = data(n=12)
    loop = TrainLoop(tiny(pc), pc.TrainConfig(batch_size=BS,
                                              compute_dtype="bfloat16"),
                     device="cpu")
    out = loop.fit((images * 255).astype(np.uint8), proc, labels,
                   val=((images[:4] * 255).astype(np.uint8), proc[:4],
                        labels[:4]), epochs=2, verbose=False)
    assert loop.epoch == 2 and np.isfinite(out["records"].rows).all()
    fields, corpus = write_fixture(str(tmp_path))
    records = []
    for dtype in ("bfloat16", "float32"):
        cfg = pc.ExperimentConfig(
            model=tiny(pc), data=pc.DataConfig(**fields),
            train=pc.TrainConfig(batch_size=BS, learning_rate=3e-3,
                                 compute_dtype=dtype),
            result_dir=str(tmp_path / "Result"))
        tr = MultiTargetTrainer(cfg, [("50HZ_Bm", 0, None)], corpus=corpus,
                                mlp_impl="pallas", device="cpu")
        tr.fit(1, verbose=False)
        records.append(tr.records[0][0])
    assert np.isfinite(records[0][1:]).all()
    assert records[0][1] != records[1][1]
    assert abs(records[0][1] - records[1][1]) <= 0.1 * records[1][1]
