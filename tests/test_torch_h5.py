"""The port's weight migration (transformer_stm_tpu_torch/train/h5_import.py,
keras_compat.py) against the JAX package's, on the CPU.

At the small spec of tests/test_h5_import.py, for dw_bn with the cls token,
avg without it and the img-only spec (proc_dim 0):

- (a) on a file written from the Keras twin's weights in the legacy
  Keras-2 layout (``_write_legacy_h5``), the port's ``h5_trees`` equals
  JAX's ``import_cvt_h5`` leaf for leaf, bit for bit, and the port's twin
  trees equal JAX's; the port's ``cvt_forward`` of ``import_cvt_h5(...,
  device="cpu")`` is within 1e-5 of JAX's ``cvt_forward(impl="xla")`` and
  within atol 2e-4 (max under 1e-3) of the twin, as in
  tests/test_model_parity.py;
- (b) the same equality with JAX's import on the genuine reference layout
  (h5_import.py's docstring): the MLP's denses at
  ``stage{i}_transformer/dense_N``, the attention's under
  ``stage{i}_transformer/stage{i}_transformer/conv_attention_N/``;
- (c) ``chip_smoke.legacy_layout`` gives the paths and arrays of
  ``_write_legacy_h5``'s file;
- (d) importing the migration modules and the command line pulls in
  neither tensorflow nor h5py (a fresh interpreter).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
tf = pytest.importorskip("tensorflow")

from test_h5_import import SPEC as JAX_SPEC  # noqa: E402
from test_h5_import import _write_legacy_h5  # noqa: E402
from transformer_stm_tpu.models import \
    cvt_forward as jax_cvt_forward  # noqa: E402
from transformer_stm_tpu.train import keras_compat as jax_keras  # noqa: E402
from transformer_stm_tpu.train.h5_import import \
    import_cvt_h5 as jax_import  # noqa: E402
from transformer_stm_tpu_torch.config import CvTSpec, StageSpec  # noqa: E402
from transformer_stm_tpu_torch.models.cvt import cvt_forward  # noqa: E402
from transformer_stm_tpu_torch.train import keras_compat  # noqa: E402
from transformer_stm_tpu_torch.train.h5_import import (  # noqa: E402
    _load_arrays, flatten_tree, h5_trees, import_cvt_h5, map_cvt_names)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC = CvTSpec(**{**{k: v for k, v in dataclasses.asdict(JAX_SPEC).items()
                     if k != "stages"},
                  "stages": tuple(StageSpec(**dataclasses.asdict(st))
                                  for st in JAX_SPEC.stages)})
VARIANTS = {
    "dw_bn_cls": (SPEC.with_projection("dw_bn", True),
                  JAX_SPEC.with_projection("dw_bn", True)),
    "avg_nocls": (SPEC.with_projection("avg", False),
                  JAX_SPEC.with_projection("avg", False)),
    "img_only": (dataclasses.replace(SPEC, proc_dim=0),
                 dataclasses.replace(JAX_SPEC, proc_dim=0)),
}


def _inputs(spec, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    proc = (rng.normal(size=(2, spec.proc_dim)).astype(np.float32)
            if spec.proc_dim else None)
    return imgs, proc


def _assert_same_leaves(got, want, what):
    """Two (params, state) pairs: the same leaf paths, every leaf equal bit
    for bit in shape, dtype and value."""
    for kind, g, w in zip(("params", "state"), got, want):
        g = {k: np.asarray(v) for k, v in flatten_tree(g).items()}
        w = {k: np.asarray(v) for k, v in flatten_tree(w).items()}
        assert set(g) == set(w), (what, kind, sorted(set(g) ^ set(w)))
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, \
                (what, kind, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{kind} {k}")


@pytest.fixture(scope="module", params=list(VARIANTS))
def twin_file(request, tmp_path_factory):
    """(variant, port spec, JAX spec, twin, its trees, legacy .h5 path)."""
    spec, jspec = VARIANTS[request.param]
    twin = keras_compat.build_twin(spec, batch=2, seed=3)
    trees = keras_compat.twin_to_pytree(twin)
    path = str(tmp_path_factory.mktemp("h5") /
               f"cvt_model_weights_50HZ_Bm_{request.param}.h5")
    _write_legacy_h5(path, *trees, jspec)
    return request.param, spec, jspec, twin, trees, path


def test_import_equals_jax_leaf_for_leaf(twin_file):
    what, spec, jspec, twin, trees, path = twin_file
    want = jax_import(path, jspec)
    got = h5_trees(_load_arrays(path), spec)
    _assert_same_leaves(got, want, what)
    # the port's twin extraction is JAX's, as numpy
    _assert_same_leaves(trees, jax_keras.twin_to_pytree(twin), what)
    _assert_same_leaves(got, trees, what)


def test_imported_forward_matches_jax_and_the_twin(twin_file):
    what, spec, jspec, twin, _, path = twin_file
    imgs, proc = _inputs(spec, 1)
    model = import_cvt_h5(path, spec, device="cpu")
    with torch.no_grad():
        got = cvt_forward(model, torch.from_numpy(imgs),
                          None if proc is None else torch.from_numpy(proc))
    got = got.numpy()
    params, state = jax_import(path, jspec)
    want, _ = jax_cvt_forward(params, state, jspec, imgs, proc, train=False,
                              impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0,
                               err_msg=what)
    ref = np.asarray(twin(imgs, proc, training=False))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0, err_msg=what)
    assert np.max(np.abs(got - ref)) < 1e-3


def _write_genuine_h5(path, params, state, spec):
    """The trees in the layout of a genuine save_weights file of the
    reference's models/CvT(Par).py: each top-level layer's group holds its
    weights under their variable names, the block's own sublayers under a
    second stage{i}_transformer level; Keras counters run over the stages."""
    count = {}

    def auto(name):
        n = count.get(name, 0)
        count[name] = n + 1
        return name if n == 0 else f"{name}_{n}"

    def put(f, group, leaves):
        for name, a in leaves.items():
            f[f"{group}/{name}:0"] = np.asarray(a)

    with h5py.File(path, "w") as f:
        for i, (stage, sstate, st) in enumerate(
                zip(params["stages"], state["stages"], spec.stages), start=1):
            e = f"stage{i}_ConvEmbed"
            put(f, f"{e}/{e}/{auto('conv2d')}", stage["embed"]["proj"])
            t = f"stage{i}_transformer"
            blk, bst = stage["blocks"][0], sstate["blocks"][0]
            inner = f"{t}/{t}"
            att = f"{inner}/{auto('conv_attention')}"
            put(f, f"{inner}/{auto('layer_normalization')}", blk["norm1"])
            for tag in ("q", "k", "v"):
                proj = blk["attn"][f"{tag}_proj"]
                if not proj:
                    continue
                put(f, f"{att}/{tag}_proj/{auto('depthwise_conv2d')}",
                    {"depthwise_kernel": proj["conv"]["kernel"]})
                moving = bst["attn"][f"{tag}_proj"]["bn"]
                put(f, f"{att}/{tag}_proj/{auto('batch_normalization')}",
                    {**proj["bn"], "moving_mean": moving["mean"],
                     "moving_variance": moving["var"]})
            for key in ("proj_q", "proj_k", "proj_v", "proj"):
                put(f, f"{att}/{auto('dense')}", blk["attn"][key])
            mha = f"{att}/{auto('multi_head_attention')}"
            for key in ("query", "key", "value"):
                put(f, f"{mha}/{key}", blk["attn"]["mha"][key])
            put(f, f"{mha}/attention_output", blk["attn"]["mha"]["out"])
            for key in ("fc1", "fc2"):
                put(f, f"{t}/{auto('dense')}", blk["mlp"][key])
            if "cls_token" in blk:
                put(f, t, {"cls_token": np.asarray(
                    blk["cls_token"]).reshape(1, 1, 1, -1)})
        n = auto("layer_normalization")
        put(f, f"{n}/{n}", params["head_norm"])
        for name, key in (("Proc_Dense_1", "proc_fc1"),
                          ("Proc_Dense_2", "proc_fc2"),
                          ("Final_Dense", "final")):
            if key in params:
                put(f, f"{name}/{name}", params[key])


@pytest.mark.parametrize("variant", ["dw_bn_cls", "avg_nocls"])
def test_import_of_the_genuine_layout_equals_jax(variant, tmp_path):
    spec, jspec = VARIANTS[variant]
    trees = keras_compat.twin_to_pytree(
        keras_compat.build_twin(spec, batch=1, seed=5))
    path = str(tmp_path / "genuine.h5")
    _write_genuine_h5(path, *trees, spec)
    arrays = _load_arrays(path)
    assert any("/conv_attention" in k and "/dense" in k for k in arrays)
    got = h5_trees(arrays, spec)
    _assert_same_leaves(got, jax_import(path, jspec), variant)
    _assert_same_leaves(got, trees, variant)


def test_chip_smoke_legacy_layout_is_the_test_files(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    spec, jspec = VARIANTS["dw_bn_cls"]
    trees = keras_compat.twin_to_pytree(
        keras_compat.build_twin(spec, batch=1, seed=7))
    path = str(tmp_path / "legacy.h5")
    _write_legacy_h5(path, *trees, jspec)
    want = _load_arrays(path)
    got = chip_smoke.legacy_layout(*trees, spec)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    # each name of the map is used once, and every dataset
    names = [n for tree in map_cvt_names(got, spec)
             for n in flatten_tree(tree).values()]
    assert sorted(names) == sorted(got)


def test_migration_modules_import_neither_tensorflow_nor_h5py():
    code = ("import sys\n"
            "import transformer_stm_tpu_torch.train.h5_import\n"
            "import transformer_stm_tpu_torch.train.keras_compat\n"
            "import transformer_stm_tpu_torch.train.h5_export\n"
            "import transformer_stm_tpu_torch.cli\n"
            "bad = [m for m in ('tensorflow', 'h5py', 'jax', 'keras')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
