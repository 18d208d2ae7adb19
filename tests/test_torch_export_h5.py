"""The port's weight export (transformer_stm_tpu_torch/train/h5_export.py)
and its command line's ``export-h5`` against the JAX package's, on the CPU,
without TensorFlow and without the reference's code.

A stand-in reference module provides ``spec = {"stages": [{}, {}, {}]}``
and a ``create_cvt_model`` (the CvT builder of models/CvT(Par).py and
CvT(Img).py, or the FFN's of models/FFN(OnlyPar).py) whose model's
``.layers`` carry the reference's layer names and TensorFlow variable names
(the genuine layout of h5_import.py's docstring) and whose ``save_weights``
writes them with h5py.  Both packages export into it:

- ``export_cvt_reference_h5`` (img+par dw_bn with the cls token, avg
  without, img-only) and ``export_ffn_reference_h5`` write the same
  datasets, bit for bit, and the port's file imports into a model whose
  forward is the source model's, bit for bit;
- ``export-h5`` of either command line, on the same checkpoints written by
  the port, writes the same files and prints the same lines: one target
  with the default path and one without a checkpoint; ``--out`` with two
  targets; ``--inputs par`` on an FFN checkpoint and on a CvT one.  Both
  skip the CvT checkpoint under ``--inputs par``, the JAX CLI after a
  ``KeyError``, which this test names.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from transformer_stm_tpu import cli as jax_cli  # noqa: E402
from transformer_stm_tpu.train import h5_export as jax_export  # noqa: E402
from transformer_stm_tpu_torch import cli  # noqa: E402
from transformer_stm_tpu_torch.config import (  # noqa: E402
    CvTSpec, ExperimentConfig, StageSpec)
from transformer_stm_tpu_torch.harness import _paths  # noqa: E402
from transformer_stm_tpu_torch.models.cvt import (  # noqa: E402
    cvt_forward, init_cvt)
from transformer_stm_tpu_torch.models.ffn import init_ffn  # noqa: E402
from transformer_stm_tpu_torch.train import h5_export  # noqa: E402
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    _flatten, _unflatten, save_checkpoint, to_jax_params)
from transformer_stm_tpu_torch.train.h5_import import (  # noqa: E402
    _load_arrays, import_cvt_h5)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = CvTSpec(
    stages=(StageSpec(embed_dim=16, patch_size=7, stride=4, num_heads=1),
            StageSpec(embed_dim=24, patch_size=3, stride=2, num_heads=2),
            StageSpec(embed_dim=32, patch_size=3, stride=2, num_heads=4,
                      with_cls_token=True)),
    image_height=64, image_width=64)
VARIANTS = {"dw_bn_cls": SMALL.with_projection("dw_bn", True),
            "avg_nocls": SMALL.with_projection("avg", False),
            "img_only": dataclasses.replace(SMALL, proc_dim=0)}


class _Weight:
    def __init__(self, name, shape):
        self.name, self.shape = name, tuple(shape)
        self.value = np.zeros(self.shape, np.float32)

    def assign(self, a):
        a = np.asarray(a)
        assert a.dtype == np.float32 and a.shape == self.shape, self.name
        self.value = a.copy()


class _Model:
    def __init__(self, layers):
        self.layers = layers

    @property
    def weights(self):
        return [w for layer in self.layers for w in layer.weights]

    def save_weights(self, path):
        with h5py.File(path, "w") as f:
            for layer in self.layers:
                for w in layer.weights:
                    f[f"{layer.name}/{w.name}"] = w.value


def _layer(name, weights):
    return types.SimpleNamespace(name=name, weights=weights)


def _cvt_builder(mod):
    """create_cvt_model(h, w, c[, proc_dim], num_classes): the reference's
    layers and variable names for the stage sizes in ``mod.spec``."""
    def create_cvt_model(h, w, c, *rest):
        proc_dim, num_classes = rest if len(rest) == 2 else (0, rest[0])
        count = {}

        def auto(name):
            n = count.get(name, 0)
            count[name] = n + 1
            return name if n == 0 else f"{name}_{n}"

        def weights(scope, **shapes):
            return [_Weight(f"{scope}/{k}:0", s) for k, s in shapes.items()]

        layers, in_ch = [_layer("input_1", [])], c
        for i, st in enumerate(mod.spec["stages"], start=1):
            d, k, hd = st["embed_dim"], st["patch_size"], 4 * st["embed_dim"]
            e = f"stage{i}_ConvEmbed"
            layers.append(_layer(e, weights(
                f"{e}/{auto('conv2d')}", kernel=(k, k, in_ch, d),
                bias=(d,))))
            t = f"stage{i}_transformer"
            att = f"{t}/{auto('conv_attention')}"
            ws = weights(f"{t}/{auto('layer_normalization')}", gamma=(d,),
                         beta=(d,))
            if st["qkv_method"] == "dw_bn":
                for tag in ("q", "k", "v"):
                    ws += weights(f"{att}/{tag}_proj/"
                                  f"{auto('depthwise_conv2d')}",
                                  depthwise_kernel=(3, 3, d, 1))
                    ws += weights(f"{att}/{tag}_proj/"
                                  f"{auto('batch_normalization')}",
                                  gamma=(d,), beta=(d,), moving_mean=(d,),
                                  moving_variance=(d,))
            for _ in range(4):
                ws += weights(f"{att}/{auto('dense')}", kernel=(d, d),
                              bias=(d,))
            h, dh = st["num_heads"], d // st["num_heads"]
            mha = f"{att}/{auto('multi_head_attention')}"
            for key in ("query", "key", "value"):
                ws += weights(f"{mha}/{key}", kernel=(d, h, dh),
                              bias=(h, dh))
            ws += weights(f"{mha}/attention_output", kernel=(h, dh, d),
                          bias=(d,))
            ws += weights(auto("dense"), kernel=(d, hd), bias=(hd,))
            ws += weights(auto("dense"), kernel=(hd, d), bias=(d,))
            if st["with_cls_token"]:
                ws.append(_Weight(f"{t}/cls_token:0", (1, 1, 1, d)))
            layers.append(_layer(t, ws))
            in_ch = d
        n = auto("layer_normalization")
        layers.append(_layer(n, weights(n, gamma=(in_ch,), beta=(in_ch,))))
        feat = in_ch
        if proc_dim:
            layers.append(_layer("Proc_Dense_1", weights(
                "Proc_Dense_1", kernel=(proc_dim, 256), bias=(256,))))
            layers.append(_layer("Proc_Dense_2", weights(
                "Proc_Dense_2", kernel=(256, 256), bias=(256,))))
            feat += 256
        layers.append(_layer("Final_Dense", weights(
            "Final_Dense", kernel=(feat, num_classes), bias=(num_classes,))))
        return _Model(layers)
    return create_cvt_model


def _ffn_model(proc_dim, num_classes):
    """models/FFN(OnlyPar).py's builder: an input layer, Dense(256, relu) x
    2 and Dense(num_classes)."""
    layers = [_layer("input_1", [])]
    for name, shape in (("dense", (proc_dim, 256)), ("dense_1", (256, 256)),
                        ("dense_2", (256, num_classes))):
        layers.append(_layer(name, [_Weight(f"{name}/kernel:0", shape),
                                    _Weight(f"{name}/bias:0", shape[1:])]))
    return _Model(layers)


def stand_in(ffn=False):
    mod = types.SimpleNamespace(spec={"stages": [{}, {}, {}]})
    mod.create_cvt_model = _ffn_model if ffn else _cvt_builder(mod)
    return mod


def _jax_spec(spec):
    from transformer_stm_tpu import config as jc
    return jc.CvTSpec(
        stages=tuple(jc.StageSpec(**dataclasses.asdict(st))
                     for st in spec.stages),
        **{k: v for k, v in dataclasses.asdict(spec).items()
           if k != "stages"})


def _jax_trees(params, state, spec):
    """The port's trees in JAX's exact layout (empty dicts where a
    projection holds no weights), as the JAX CLI loads a checkpoint."""
    import jax

    from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
    from transformer_stm_tpu.train.checkpoint import _unflatten_into

    flat = {f"{k}/{p}": v for k, tree in (("p", params), ("s", state))
            for p, v in _flatten(tree).items()}
    tp, ts = jax.eval_shape(lambda: jax_init_cvt(jax.random.PRNGKey(0),
                                                 _jax_spec(spec)))
    return _unflatten_into(tp, flat, "p"), _unflatten_into(ts, flat, "s")


def _seeded_cvt(spec, seed):
    """A CvT on the CPU with every leaf distinct (BatchNorm statistics off
    their initial values)."""
    model = init_cvt(spec, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            t.add_(0.05 * torch.randn(t.shape, generator=gen).abs())
    return model


def _same_files(a, b):
    got, want = _load_arrays(a), _load_arrays(b)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cvt_export_equals_jax_and_reimports_bit_for_bit(variant, tmp_path):
    spec = VARIANTS[variant]
    model = _seeded_cvt(spec, 4)
    params, state = to_jax_params(model)
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    h5_export.export_cvt_reference_h5(params, state, spec, mine,
                                      mod=stand_in())
    jax_export.export_cvt_reference_h5(*_jax_trees(params, state, spec),
                                       _jax_spec(spec), theirs,
                                       mod=stand_in())
    _same_files(mine, theirs)
    # the leaves may be the port's tensors
    tensors = _unflatten({k.replace(".", "/"): t
                          for k, t in model.named_parameters()})
    h5_export.export_cvt_reference_h5(tensors, state, spec,
                                      str(tmp_path / "t.h5"),
                                      mod=stand_in())
    _same_files(str(tmp_path / "t.h5"), mine)

    imported = import_cvt_h5(mine, spec, device="cpu")
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.uniform(0, 1, (3, 64, 64, 1))
                            .astype(np.float32))
    proc = (torch.from_numpy(rng.normal(size=(3, spec.proc_dim))
                             .astype(np.float32)) if spec.proc_dim else None)
    with torch.no_grad():
        assert torch.equal(cvt_forward(imported, imgs, proc),
                           cvt_forward(model, imgs, proc))


def test_ffn_export_equals_jax(tmp_path):
    model = init_ffn(5, 256, 1, torch.Generator().manual_seed(6),
                     device="cpu")
    params, _ = to_jax_params(model)
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    h5_export.export_ffn_reference_h5(params, mine, mod=stand_in(ffn=True))
    jax_export.export_ffn_reference_h5(params, theirs,
                                       mod=stand_in(ffn=True))
    _same_files(mine, theirs)
    with pytest.raises(AssertionError, match="layout"):
        h5_export.export_ffn_reference_h5(
            to_jax_params(init_ffn(5, 64, 1, torch.Generator(),
                                   device="cpu"))[0],
            str(tmp_path / "x.h5"), mod=stand_in(ffn=True))


A, B = "50HZ_Bm", "50HZ_Hc"


def _run(main, module, monkeypatch, capsys, argv, root):
    """(stdout lines, {written file: datasets}, the exception raised) of one
    command line's ``export-h5``, its files then removed."""
    monkeypatch.setattr(module, "load_reference_module",
                        lambda path=None: stand_in(ffn=path is not None
                                                   and "FFN" in path))
    before = {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs}
    capsys.readouterr()
    try:
        main(["export-h5", "--result-dir", root, *argv])
        err = None
    except KeyError as e:
        err = e
    lines = capsys.readouterr().out.splitlines()
    written = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            if p not in before:
                written[os.path.relpath(p, root)] = _load_arrays(p)
                os.remove(p)
    return lines, written, err


@pytest.mark.parametrize("case", ["default_path", "out_two_targets", "par"])
def test_export_h5_command_line_matches_jax(case, tmp_path, monkeypatch,
                                            capsys):
    root = str(tmp_path / "result")
    cfg = ExperimentConfig(result_dir=root)
    par = dataclasses.replace(cfg, inputs="par")
    cvt = _seeded_cvt(CvTSpec(), 1)
    argv = {"default_path": ["--freq", A, B],
            "out_two_targets": ["--freq", A, B, "--out",
                                os.path.join(root, "w.h5")],
            "par": ["--inputs", "par", "--freq", A, B]}[case]
    if case == "par":
        save_checkpoint(_paths(par, A)["weights"],
                        init_ffn(5, 256, 1, torch.Generator().manual_seed(2),
                                 device="cpu"), None, 7)
        save_checkpoint(_paths(par, B)["weights"], cvt, None, 3)
    else:
        save_checkpoint(_paths(cfg, A)["weights"], cvt, None, 5)
        if case == "out_two_targets":
            save_checkpoint(_paths(cfg, B)["weights"],
                            _seeded_cvt(CvTSpec(), 8), None, 2)
    mine = _run(cli.main, h5_export, monkeypatch, capsys, argv, root)
    theirs = _run(jax_cli.main, jax_export, monkeypatch, capsys, argv, root)
    assert mine[0][0] == theirs[0][0]
    assert sorted(mine[1]) == sorted(theirs[1])
    for name, arrays in theirs[1].items():
        assert sorted(mine[1][name]) == sorted(arrays)
        for k, a in arrays.items():
            np.testing.assert_array_equal(mine[1][name][k], a,
                                          err_msg=f"{name} {k}")
    if case == "default_path":
        assert mine[0] == theirs[0] and mine[2] is theirs[2] is None
        assert mine[0][1] == f"{B}: no checkpoint under " \
            f"{_paths(cfg, B)['weights']}"
        assert list(mine[1]) == [os.path.relpath(
            _paths(cfg, A)["weights"] + ".h5", root)]
    elif case == "out_two_targets":
        assert mine[0] == theirs[0] and mine[2] is theirs[2] is None
        assert sorted(mine[1]) == [f"w_{A}.h5", f"w_{B}.h5"]
    else:
        # the CvT checkpoint: the port says it skips it; the JAX CLI takes
        # the CvT's mlp/fc1 kernel for the FFN's and raises on p/fc1/kernel
        assert mine[2] is None and mine[0][1].startswith(f"{B}: ") and \
            mine[0][1].endswith("is not an FFN checkpoint (no fc1/final "
                                "kernels); skipping")
        assert isinstance(theirs[2], KeyError) and len(theirs[0]) == 1
        assert list(mine[1]) == [os.path.relpath(
            _paths(par, A)["weights"] + ".h5", root)]


REF_CVT = os.path.join(ROOT, h5_export.REF_CVT)


@pytest.mark.skipif(not os.path.exists(REF_CVT),
                    reason="the reference's models/CvT(Par).py is not there")
def test_export_roundtrip_into_reference_model(tmp_path):
    """tests/test_reference_parity.py's round trip on the port: the port's
    weights exported into the reference's own model, whose predictions
    match ``cvt_forward`` within 1e-3, and the file re-imports bit for
    bit."""
    pytest.importorskip("tensorflow")
    spec = CvTSpec().with_projection("dw_bn", True)
    model = _seeded_cvt(spec, 3)
    path = str(tmp_path / "cvt_model_weights_50HZ_Bm_dw_bn_clsTrue.h5")
    ref = h5_export.export_cvt_reference_h5(
        *to_jax_params(model), spec, path,
        mod=h5_export.load_reference_module(REF_CVT))
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (8, 128, 128, 1)).astype(np.float32)
    proc = rng.standard_normal((8, 5)).astype(np.float32)
    with torch.no_grad():
        ours = cvt_forward(model, torch.from_numpy(imgs),
                           torch.from_numpy(proc)).numpy().ravel()
    want = np.asarray(ref([imgs, proc], training=False)).ravel()
    assert np.max(np.abs(ours - want)) < 1e-3
    again = import_cvt_h5(path, spec, device="cpu")
    for (n, a), (_, b) in zip(
            [*model.named_parameters(), *model.named_buffers()],
            [*again.named_parameters(), *again.named_buffers()]):
        assert torch.equal(a, b), n
