"""The port's training loop on the CPU: the ragged last batch against the
JAX loop, seeded determinism, checkpoints both ways between the packages,
and import hygiene of a training run.

- ragged epochs (n = batch size + 3), with the port fed the JAX loop's
  permutation: the row-0 pads are masked in the loss and the metrics and
  enter the BatchNorm batch statistics exactly as the JAX loop's do, so
  records and predictions agree within 1e-4 relative (f32, two epochs);
- two fits with one seed are bit-identical, with dropout on; another
  seed differs;
- a checkpoint the port writes is read back by the JAX package exactly,
  and by a fresh port loop to bit-identical predictions.
"""

import json
import os
import subprocess
import sys

import numpy as np

import jax
import torch

from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.config import StageSpec as JaxStageSpec
from transformer_stm_tpu.config import TrainConfig as JaxTrainConfig
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from transformer_stm_tpu.train.loop import TrainLoop as JaxTrainLoop
from transformer_stm_tpu.train.optimizer import adam_init as jax_adam_init
from transformer_stm_tpu_torch.config import CvTSpec, StageSpec, TrainConfig
from transformer_stm_tpu_torch.train.checkpoint import (
    _flatten, latest_checkpoint, save_checkpoint, to_jax_params)
from transformer_stm_tpu_torch.train.loop import TrainLoop

from test_torch_train_loop import port_loop, tiny, toy_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 8


def test_ragged_epochs_match_jax():
    n = BS + 3
    images, proc, labels = toy_data(n, seed=3)
    val = toy_data(4, seed=4)
    cfg = dict(epochs=2, batch_size=BS, learning_rate=3e-3)
    jloop = JaxTrainLoop(tiny(JaxCvTSpec, JaxStageSpec), JaxTrainConfig(**cfg))
    params0 = jax.tree_util.tree_map(np.array, jloop.params)
    state0 = jax.tree_util.tree_map(np.array, jloop.state)
    want = jloop.fit(images, proc, labels, val=val, verbose=False)
    loop = port_loop(params0, state0, **cfg)
    loop._permutation = lambda n, epoch: np.asarray(jax.random.permutation(
        jax.random.fold_in(jloop.shuffle_key, epoch), n))
    batches = list(loop._batches(n, 0))
    assert [m.sum() for _, m in batches] == [BS, 3]
    assert (batches[1][0][3:] == 0).all()  # pads are copies of row 0
    got = loop.fit(images, proc, labels, val=val, verbose=False)
    for g, w in zip(got["records"].rows, want["records"].rows):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1:5], w[1:5], rtol=1e-4, atol=0)
    np.testing.assert_allclose(loop.predict(*val[:2]),
                               jloop.predict(*val[:2]), rtol=1e-4, atol=0)


def _fit(seed, ckpt_dir=None, epochs=2, **cfg):
    """A port fit with dropout 0.1 on 20 rows (a ragged last batch)."""
    images, proc, labels = toy_data(20, seed=5)
    loop = TrainLoop(tiny(CvTSpec, StageSpec, rate=0.1),
                     TrainConfig(batch_size=BS, seed=seed, **cfg),
                     device="cpu")
    out = loop.fit(images, proc, labels, epochs=epochs, verbose=False,
                   checkpoint_dir=ckpt_dir)
    return loop, out


def test_fits_with_one_seed_are_bit_identical():
    (a, ra), (b, rb), (c, rc) = _fit(0), _fit(0), _fit(1)
    assert ra["records"].rows == rb["records"].rows
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n
    for (n, sa), sb in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(sa, sb), n
    assert ra["records"].rows != rc["records"].rows


def test_dropout_is_applied_in_training():
    """The same fit with dropout 0 gives other losses."""
    _, with_drop = _fit(0)
    images, proc, labels = toy_data(20, seed=5)
    loop = TrainLoop(tiny(CvTSpec, StageSpec), TrainConfig(batch_size=BS),
                     device="cpu")
    no_drop = loop.fit(images, proc, labels, epochs=2, verbose=False)
    assert with_drop["records"].rows != no_drop["records"].rows


def test_port_checkpoint_reads_back_in_jax(tmp_path):
    loop, _ = _fit(0, epochs=1)
    path = save_checkpoint(str(tmp_path), loop.model, loop.opt, step=1,
                           metadata={"note": "port"})
    assert os.path.basename(path) == "ckpt_000001.npz"
    with open(str(tmp_path / "ckpt_000001.json")) as f:
        assert json.load(f) == {"step": 1, "has_opt": True, "note": "port"}
    p0, s0 = jax_init_cvt(jax.random.PRNGKey(0),
                          tiny(JaxCvTSpec, JaxStageSpec, rate=0.1))
    params, state, opt, step = jax_load_checkpoint(path, p0, s0,
                                                   jax_adam_init(p0))
    assert step == 1 and int(opt.step) == loop.opt.step == 3  # 20 rows
    want_p, want_s = to_jax_params(loop.model)
    for got, want in ((params, want_p), (state, want_s)):
        got, want = _flatten(jax.tree_util.tree_map(np.asarray, got)), \
            _flatten(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
        got = _flatten(jax.tree_util.tree_map(np.asarray, moments))
        want = {k.replace(".", "/"): v.numpy()
                for k, v in getattr(loop.opt, name).items()}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_resume_gives_identical_predictions(tmp_path):
    loop, _ = _fit(0, ckpt_dir=str(tmp_path), epochs=2, checkpoint_every=1)
    fresh = TrainLoop(tiny(CvTSpec, StageSpec, rate=0.1),
                      TrainConfig(batch_size=BS, seed=7), device="cpu")
    fresh.load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert fresh.epoch == 2 and fresh.opt.step == loop.opt.step
    images, proc, _ = toy_data(6, seed=6)
    np.testing.assert_array_equal(fresh.predict(images, proc),
                                  loop.predict(images, proc))
    for k, v in loop.opt.nu.items():
        assert torch.equal(fresh.opt.nu[k], v), k


def test_checkpoint_every_and_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    loop, _ = _fit(0, ckpt_dir=str(tmp_path), epochs=5, checkpoint_every=2)
    names = sorted(os.listdir(str(tmp_path)))
    assert names == ["ckpt_000002.json", "ckpt_000002.npz",
                     "ckpt_000004.json", "ckpt_000004.npz"]
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_000004.npz")
    # resume goes on from the checkpoint's epoch, not from 0
    fresh = TrainLoop(tiny(CvTSpec, StageSpec, rate=0.1),
                      TrainConfig(batch_size=BS), device="cpu")
    fresh.load_checkpoint(latest_checkpoint(str(tmp_path)))
    images, proc, labels = toy_data(20, seed=5)
    out = fresh.fit(images, proc, labels, epochs=5, verbose=False)
    assert [r[0] for r in out["records"].rows] == [5]


def test_a_training_run_imports_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        "import numpy as np\n"
        "from transformer_stm_tpu_torch.config import "
        "CvTSpec, StageSpec, TrainConfig\n"
        "from transformer_stm_tpu_torch.train.loop import TrainLoop\n"
        "spec = CvTSpec(stages=(StageSpec(8, 7, 4, 1), StageSpec(16, 3, 2, 2),"
        " StageSpec(16, 3, 2, 2, with_cls_token=True)), image_height=32,"
        " image_width=32)\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.integers(0, 255, (10, 32, 32, 1), dtype=np.uint8)\n"
        "p = rng.normal(size=(10, 5)).astype(np.float32)\n"
        "y = rng.normal(size=10).astype(np.float32)\n"
        "loop = TrainLoop(spec, TrainConfig(batch_size=4, epochs=1,"
        " checkpoint_every=1), device='cpu')\n"
        f"loop.fit(x, p, y, val=(x, p, y), verbose=False,"
        f" checkpoint_dir={str(tmp_path)!r})\n"
        "print(json.dumps([m for m in ('jax', 'transformer_stm_tpu')"
        " if m in sys.modules]))\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_000001.npz")
