"""The port's ``MultiTargetTrainer`` on the CPU, against the JAX package's
and on its own (the JAX multi tests skip here, tests/test_multi.py:15-17).

Fixture: ``test_torch_data.write_fixture`` under a temporary directory, 2
groups x 5 pieces x 4 layers of 32x32 uint8 images passed as ``corpus=``,
and label/process sheets where one target misses a label on a non-first
piece, so its slot trains on 28 rows and pads 4 (the other trains on 32).
TINY model (embed 8/16/16, cls token), dropout 0 for the comparisons with
JAX.

Against JAX (batch = rows_max, one step per epoch, so the two shuffles
change only the order of summation; the port's slots train through the
fused training MLP's plain version, JAX's through its XLA MLP):

- both start from JAX's epoch-0 stacked checkpoint and train 2 epochs; the
  records and the BatchNorm state (``s/`` leaves) agree within 1e-4
  relative, the trained slots' outputs within 1e-4 relative.  Parameters
  are compared through those outputs and through the gradients: Adam's
  first steps move every weight by about lr * sign(g), so a weight whose
  gradient is at float-noise level (|g| ~ 1e-6 max|g|, which the JAX
  trainer's own vmapped step and a direct ``jax.grad`` already disagree on)
  lands lr away in one package or the other; JAX's own
  ``test_multi_impl_small_matches_xla`` compares gradients for this reason.
  With slot seeds (0, 1) one such weight flips in the padded slot; the
  seeds here are (0, 2);
- the first step's loss and gradients of each slot, the padded one
  included, match ``jax.grad`` of the JAX model on the same batch within
  1e-4 * max|g| (the dead key-path biases gated as in
  tests/test_torch_train_grads.py);
- a stacked checkpoint the port writes resumes in JAX's trainer.

On its own, mirroring tests/test_multi.py: same-seed slots stay bit-equal
(dropout 0.1, through the fused training MLP); appended fully masked steps
are bit-exact no-ops; ``epochs_per_call`` changes nothing; save/load
resumes; ``export`` writes the reference layout.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu import config as jc
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.train.multi import \
    MultiTargetTrainer as JaxMultiTargetTrainer
from transformer_stm_tpu_torch import config as pc
from transformer_stm_tpu_torch.data.augment import AugmentConfig
from transformer_stm_tpu_torch.data.xlsx import read_xlsx
from transformer_stm_tpu_torch.kernels import fused_mlp as port_mlp
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.ops import blocks
from transformer_stm_tpu_torch.train.checkpoint import (_flatten,
                                                        load_checkpoint)
from transformer_stm_tpu_torch.train.loop import _masked_mse_mae
from transformer_stm_tpu_torch.train.metrics import RecordsWriter
from transformer_stm_tpu_torch.train.multi import (MultiTargetTrainer,
                                                   chunk_checkpoint_dir)

from test_torch_data import write_fixture
from test_torch_train_grads import _dead

RTOL = 1e-4
TARGETS = [("50HZ_Bm", 0, None), ("50HZ_Hc", 2, None)]


def tiny(m, rate=0.0):
    return m.CvTSpec(stages=(
        m.StageSpec(embed_dim=8, patch_size=7, stride=4, num_heads=1,
                    dropout_rate=rate),
        m.StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                    dropout_rate=rate),
        m.StageSpec(embed_dim=16, patch_size=3, stride=2, num_heads=2,
                    with_cls_token=True, dropout_rate=rate),
    ), image_height=32, image_width=32)


def experiment(m, fields, root, batch, rate=0.0):
    return m.ExperimentConfig(
        model=tiny(m, rate), data=m.DataConfig(**fields),
        train=m.TrainConfig(batch_size=batch, learning_rate=3e-3),
        result_dir=os.path.join(root, "Result"))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multi"))
    fields, corpus = write_fixture(root)
    jax_tr = JaxMultiTargetTrainer(experiment(jc, fields, root, 32), TARGETS,
                                   corpus=corpus)
    ck0 = os.path.join(root, "epoch0")
    jax_tr.save(ck0)
    jax_p0 = jax.tree_util.tree_map(np.array, jax_tr.params)
    jax_s0 = jax.tree_util.tree_map(np.array, jax_tr.state)
    jax_tr.fit(2, verbose=False)
    port = MultiTargetTrainer(experiment(pc, fields, root, 32), TARGETS,
                              corpus=corpus, mlp_impl="pallas", device="cpu")
    assert port.load(ck0) and port.epoch == 0
    port.fit(2, verbose=False)
    return dict(root=root, fields=fields, corpus=corpus, jax=jax_tr,
                port=port, p0=jax_p0, s0=jax_s0, ck0=ck0)


def _slot(tree, i):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[i], tree)


def test_trainer_records_match_jax(parity):
    jax_tr, port = parity["jax"], parity["port"]
    assert port.steps_per_epoch == jax_tr.steps_per_epoch == 1
    assert port.val_batch == jax_tr.val_batch
    assert list(port.n_train) == list(jax_tr.n_train) == [32, 28]
    np.testing.assert_array_equal(port.train_rows, jax_tr.train_rows)
    np.testing.assert_array_equal(port.val_rows, jax_tr.val_rows)
    for got, want in zip(port.records, jax_tr.records):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=RTOL, atol=0)
    assert [o.step for o in port.opts] == \
        np.asarray(jax_tr.opt.step).tolist() == [2, 2]


def test_trainer_state_and_outputs_match_jax(parity):
    jax_tr, port = parity["jax"], parity["port"]
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (6, 32, 32, 1)).astype(np.float32) / 255
    proc = rng.standard_normal((6, 5)).astype(np.float32)
    for i, model in enumerate(port.models):
        _, state, _ = port.target_params(i)
        got, want = _flatten(state), _flatten(_slot(jax_tr.state, i))
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=RTOL * np.abs(w).max(),
                                       err_msg=k)
        out_j, _ = jax_cvt_forward(
            jax.tree_util.tree_map(jnp.asarray, _slot(jax_tr.params, i)),
            _slot(jax_tr.state, i), jax_tr.spec, images, proc)
        with torch.no_grad():
            out = cvt_forward(model, torch.from_numpy(images),
                              torch.from_numpy(proc))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("slot", [0, 1])
def test_first_step_gradients_match_jax(parity, slot):
    """The slot's first batch (pads included, masked in the loss, in the
    BatchNorm statistics) from the epoch-0 weights."""
    port = MultiTargetTrainer(
        experiment(pc, parity["fields"], parity["root"], 32), TARGETS,
        corpus=parity["corpus"], mlp_impl="pallas", device="cpu")
    port.load(parity["ck0"])
    rows, mask, _ = port.epoch_plan(0)
    images, proc, labels = port._batch(slot, rows[slot, 0])
    model = port.models[slot].requires_grad_(True)
    out = cvt_forward(model, images, proc, train=True, mlp_impl="pallas")
    loss = _masked_mse_mae(out, labels, mask[slot, 0])[0]
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))

    jspec = parity["jax"].spec
    args = [jnp.asarray(t.numpy()) for t in (images, proc, labels,
                                             mask[slot, 0])]

    def loss_fn(p):
        o, _ = jax_cvt_forward(p, _slot(parity["s0"], slot), jspec, args[0],
                               args[1], train=True)
        return jnp.sum(jnp.square(o.reshape(-1) - args[2]) * args[3]) / \
            jnp.maximum(jnp.sum(args[3]), 1.0)

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, _slot(parity["p0"], slot)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want = _flatten(jax.tree_util.tree_map(np.asarray, want_g))
    gmax = max(np.abs(w).max() for w in want.values())
    spec = tiny(pc)
    for name, g in zip(names, grads):
        if not _dead(name, spec):
            np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                       atol=RTOL * gmax, err_msg=name)


def test_port_stacked_checkpoint_resumes_in_jax(parity, tmp_path):
    port = parity["port"]
    port.save(str(tmp_path))
    jax_tr = JaxMultiTargetTrainer(
        experiment(jc, parity["fields"], parity["root"], 32), TARGETS,
        corpus=parity["corpus"])
    assert jax_tr.load(str(tmp_path))
    assert jax_tr.epoch == 2 and jax_tr.records == port.records
    assert np.asarray(jax_tr.opt.step).tolist() == [2, 2]
    for i in range(2):
        params, state, opt = port.target_params(i)
        for mine, theirs in ((params, jax_tr.params), (state, jax_tr.state),
                             (opt.mu, jax_tr.opt.mu)):
            if isinstance(next(iter(mine.values())), torch.Tensor):
                mine = {k.replace(".", "/"): v.numpy()
                        for k, v in mine.items()}
            else:
                mine = _flatten(mine)
            theirs = _flatten(_slot(theirs, i))
            assert mine.keys() == theirs.keys()
            for k in mine:
                np.testing.assert_array_equal(mine[k], theirs[k])


# -- the port on its own ----------------------------------------------------

@pytest.fixture
def small(tmp_path):
    fields, corpus = write_fixture(str(tmp_path))

    def make(targets, rate=0.0, **kw):
        cfg = experiment(pc, fields, str(tmp_path), 8, rate)
        return MultiTargetTrainer(cfg, targets, corpus=corpus, device="cpu",
                                  **kw)

    return make


def _same(a, b):
    for m1, m2 in zip(a.models, b.models):
        for (n, x), (_, y) in zip(list(m1.named_parameters())
                                  + list(m1.named_buffers()),
                                  list(m2.named_parameters())
                                  + list(m2.named_buffers())):
            if not torch.equal(x, y):
                return False
    for o1, o2 in zip(a.opts, b.opts):
        if o1.step != o2.step or not all(
                torch.equal(o1.mu[k], o2.mu[k]) and
                torch.equal(o1.nu[k], o2.nu[k]) for k in o1.mu):
            return False
    return a.records == b.records


def test_same_seed_slots_are_bit_identical(small):
    """Dropout 0.1 through the fused training MLP: the masks come from the
    slot's seed, not its index."""
    tr = small([("50HZ_Bm", 0, None), ("50HZ_Bm", 0, 2),
                ("50HZ_Bm", 1, 3)], rate=0.1, mlp_impl="pallas")
    tr.fit(2, verbose=False)
    a, b, c = tr.models
    pa, pb, pc_ = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not all(torch.equal(pa[k], pc_[k]) for k in pa)
    assert tr.records[0] == tr.records[1] != tr.records[2]
    assert tr.opts[0].step == tr.opts[1].step == 8


def test_fully_masked_steps_are_bit_exact_no_ops(small):
    targets = [("50HZ_Bm", 0, None), ("50HZ_Hc", 1, None)]
    a = small(targets, rate=0.1, mlp_impl="pallas")
    b = small(targets, rate=0.1, mlp_impl="pallas", extra_steps=3)
    assert b.steps_per_epoch == a.steps_per_epoch + 3 == 7
    a.fit(2, verbose=False)
    b.fit(2, verbose=False)
    assert _same(a, b)
    assert [o.step for o in b.opts] == [8, 8]  # 4 live steps per epoch


def test_epochs_per_call_changes_nothing(small):
    targets = [("50HZ_Hc", 3, None)]
    a = small(targets, rate=0.1, epochs_per_call=1)
    b = small(targets, rate=0.1, epochs_per_call=2)
    a.fit(3, verbose=False)
    b.fit(3, verbose=False)
    assert _same(a, b)


def test_resume_round_trip(small, tmp_path):
    targets = [("50HZ_Bm", 0, None), ("50HZ_Hc", 1, None)]
    ck = str(tmp_path / "ck")
    a = small(targets, mlp_impl="pallas")
    a.fit(1, checkpoint_dir=ck, checkpoint_every=1, verbose=False)
    b = small(targets, mlp_impl="pallas")
    assert b.load(ck) and b.epoch == 1
    assert _same(a, b)
    a.fit(2, verbose=False)
    b.fit(2, verbose=False)
    assert _same(a, b)
    assert not small(targets).load(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="slots"):
        small(targets[:1]).load(ck)


def test_export_writes_the_reference_layout(small, tmp_path):
    tr = small([("50HZ_Bm", 0, None), ("50HZ_Bm", 4, 2)], lr_scales=[1, .5])
    tr.fit(2, verbose=False)
    outs = tr.export(verbose=False)
    assert list(outs) == [("50HZ_Bm", None), ("50HZ_Bm", 2)]
    for i, ((freq, tsuf), paths) in enumerate(outs.items()):
        base = os.path.join(str(tmp_path), "Result")
        suffix = f"_{tsuf}" if tsuf else ""
        assert paths["weights"] == os.path.join(
            base, "Weight", "Images & Parameters",
            f"cvt_model_weights_{freq}{suffix}_dw_bn_clsTrue")
        params, state, opt, step = load_checkpoint(
            os.path.join(paths["weights"], "ckpt_000002.npz"))
        assert step == 2 and int(opt["step"]) == 8
        rows = read_xlsx(paths["records"])["Sheet1"]
        assert rows[0] == RecordsWriter.COLUMNS
        assert [r[0] for r in rows[1:]] == [1.0, 2.0]
        assert rows[1][5] == pytest.approx(3e-3 * [1, .5][i])
    assert chunk_checkpoint_dir(tr.cfg, ["50HZ_Bm"]).startswith(
        os.path.join(str(tmp_path), "Result", "Weight"))


def test_unported_options_raise(small, monkeypatch):
    """``augment`` is ported: a slot trains with it (its records differ from
    an unaugmented slot's); ``mlp_impl="flash"`` trains the MLPs through the
    fused training MLP, as JAX's trainer passes it on (train/multi.py:100),
    and at rate 0 equals ``"pallas"`` bit for bit; an unknown ``mlp_impl``
    still raises; ``watchdog=True`` is ported (train/watchdog.py): fit
    builds one from TSTM_WATCHDOG_S and trains under it."""
    aug = small([("50HZ_Bm", 0, None)], augment=AugmentConfig())
    aug.fit(1, verbose=False)
    plain = small([("50HZ_Bm", 0, None)])
    plain.fit(1, verbose=False)
    assert np.isfinite(aug.records[0][0][1:]).all()
    assert aug.records[0][0][1] != plain.records[0][0][1]
    calls = []
    real = blocks.fused_mlp_train
    monkeypatch.setattr(blocks, "fused_mlp_train",
                        lambda *a: calls.append(1) or real(*a))
    routes = {}
    for mlp_impl in ("flash", "pallas", "xla"):
        del calls[:]
        routes[mlp_impl] = small([("50HZ_Bm", 0, None)], mlp_impl=mlp_impl)
        routes[mlp_impl].fit(1, verbose=False)
        assert bool(calls) == (mlp_impl != "xla"), mlp_impl
    assert _same(routes["flash"], routes["pallas"])
    with pytest.raises(ValueError, match="mlp_impl"):
        small([("50HZ_Bm", 0, None)], mlp_impl="small")
    tr = small([("50HZ_Bm", 0, None)])
    monkeypatch.setenv("TSTM_WATCHDOG_S", "300")
    tr.fit(1, verbose=False, watchdog=True)
    assert tr.epoch == 1
    launches = port_mlp.fused_mlp_train.launches
    tr.fit(2, verbose=False)
    assert port_mlp.fused_mlp_train.launches == launches  # CPU: plain
