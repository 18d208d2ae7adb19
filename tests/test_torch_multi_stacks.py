"""The committed multi-target artifacts in the port, on the CPU, and the
port's import guard.

- Both stacked checkpoints under persist/ load into a full-width
  ``MultiTargetTrainer`` with their epoch, records and per-slot Adam counts
  (T=6: 221,000 to 236,000; T=8 at epoch 420: 91,560 to 99,120), and the
  T=8 stack resumes for one more epoch with each slot counting on from its
  own step.
- Slots 0-5 of the T=6 stack equal the six committed finals
  cvt_model_weights_*_dw_bn_clsTrue/ckpt_001000.npz bit for bit (``p/``
  and ``s/``), and each final's port ``cvt_forward`` lies within 1e-3 of
  the JAX ``cvt_forward`` on 4 seeded images (the goldens' bound).
- With ``jax`` blocked, every module of the port imports and no module of
  the JAX package gets loaded.
"""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import transformer_stm_tpu_torch
from transformer_stm_tpu.config import CvTSpec as JaxCvTSpec
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu_torch import config as pc
from transformer_stm_tpu_torch.config import CvTSpec
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.train.checkpoint import (
    _flatten, from_jax_params, load_checkpoint, take_slot)
from transformer_stm_tpu_torch.train.multi import MultiTargetTrainer

from test_torch_data import write_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "persist", "Weight", "Images & Parameters")
STACKS = {6: ("multi_run_8f6e1614cf.ckpts", 1000,
              [221000, 236000, 232000, 227000, 229000, 225000]),
          8: ("multi_run_40672f07ef.ckpts", 420,
              [96600, 96180, 95340, 91560, 92820, 95340, 99120, 95340])}


def _stack_targets(n):
    with open(os.path.join(WEIGHTS, STACKS[n][0],
                           f"ckpt_{STACKS[n][1]:06d}.json")) as f:
        return json.load(f)["targets"]


def _trainer(tmp_path, targets):
    """A full-width flagship trainer over a tiny synthetic corpus whose
    label sheet has the stack's target columns (1 group, 1 layer)."""
    fields, corpus = write_fixture(str(tmp_path), groups=1, layers=1, hw=128,
                                   freqs=tuple(targets), missing=())
    cfg = pc.ExperimentConfig(data=pc.DataConfig(**fields),
                              train=pc.TrainConfig(batch_size=4),
                              result_dir=str(tmp_path / "Result"))
    return MultiTargetTrainer(cfg, [(f, i, None) for i, f in
                                    enumerate(targets)], corpus=corpus,
                              device="cpu")


@pytest.mark.parametrize("n", [6, 8])
def test_committed_stack_loads_with_per_slot_adam_counts(tmp_path, n):
    name, epoch, steps = STACKS[n]
    targets = _stack_targets(n)
    tr = _trainer(tmp_path, targets)
    assert tr.load(os.path.join(WEIGHTS, name))
    assert tr.epoch == epoch
    assert [o.step for o in tr.opts] == steps
    assert [len(r) for r in tr.records] == [epoch] * n
    assert all(r[-1][0] == epoch - 1 for r in tr.records)
    params, state, _, _ = load_checkpoint(os.path.join(
        WEIGHTS, name, f"ckpt_{epoch:06d}.npz"))
    got = dict(tr.models[n - 1].named_parameters())
    for k, v in _flatten(take_slot(params, n - 1)).items():
        assert torch.equal(got[k.replace("/", ".")], torch.from_numpy(v))
    if n == 8:  # resume one epoch: each slot counts on from its own step
        tr.fit(epoch + 1, verbose=False)
        assert [o.step for o in tr.opts] == [s + 1 for s in steps]
        assert all(len(r) == epoch + 1 and r[-1][0] == epoch
                   and np.isfinite(r[-1][1:]).all() for r in tr.records)


def _final(freq):
    return os.path.join(WEIGHTS, f"cvt_model_weights_{freq}_dw_bn_clsTrue",
                        "ckpt_001000.npz")


def test_t6_stack_slots_are_the_six_finals():
    name, epoch, _ = STACKS[6]
    params, state, _, _ = load_checkpoint(os.path.join(
        WEIGHTS, name, f"ckpt_{epoch:06d}.npz"))
    for i, freq in enumerate(_stack_targets(6)):
        fp, fs, _, step = load_checkpoint(_final(freq))
        assert step == 1000
        for mine, theirs in ((take_slot(params, i), fp),
                             (take_slot(state, i), fs)):
            a, b = _flatten(mine), _flatten(theirs)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_six_finals_match_jax_forward():
    jspec = JaxCvTSpec()
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (4, 128, 128, 1)).astype(np.float32) / 255
    proc = rng.standard_normal((4, jspec.proc_dim)).astype(np.float32)
    fwd = jax.jit(lambda p, s: jax_cvt_forward(p, s, jspec, images, proc)[0])
    for freq in _stack_targets(6):
        params, state, _, _ = load_checkpoint(_final(freq))
        want = fwd(jax.tree_util.tree_map(jnp.asarray, params),
                   jax.tree_util.tree_map(jnp.asarray, state))
        model = from_jax_params(params, state, CvTSpec(), device="cpu")
        with torch.no_grad():
            got = cvt_forward(model, torch.from_numpy(images),
                              torch.from_numpy(proc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=0, err_msg=freq)


def test_port_imports_without_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(
        transformer_stm_tpu_torch.__path__, "transformer_stm_tpu_torch.")]
    assert {"transformer_stm_tpu_torch.train.multi",
            "transformer_stm_tpu_torch.data.labels",
            "transformer_stm_tpu_torch.data.split",
            "transformer_stm_tpu_torch.harness"} <= set(names)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'transformer_stm_tpu'\n"
            "       or m.startswith('transformer_stm_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
