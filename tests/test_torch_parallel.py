"""The port's parallel layer (transformer_stm_tpu_torch/parallel,
train/sharded_checkpoint.py) against the JAX package's and against the
port's single-device code, on the CPU.

The ranks are gloo processes started by ``parallel.spawn``; their code is
in tests/_torch_parallel_workers.py, which imports no jax, and rank 0
writes what they computed into .npz files.  JAX runs here, on the 8
virtual devices of tests/conftest.py.  Two spawns of 4 ranks (a 2 x 2
mesh; a 4 x 1 and a 1 x 4 one) run every multi-rank check but the dry run:

- (a) the sharding axis of every parameter equals JAX's PartitionSpec at
  model 2, on the narrow spec of tests/test_parallel.py and at full width;
- (b) the tensor-parallel forward equals the port's replicated forward
  (atol 1e-5) and JAX ``cvt_forward`` (1e-4, tests/test_torch_model.py's
  bar), and its training gradients the replicated model's, dropout 0.1 on
  the plain and on the fused training MLP included;
- (c) one data-parallel epoch at dropout 0 equals the port's
  ``TrainLoop``: loss rel 1e-3, parameters and BatchNorm statistics atol
  2e-3, JAX's own bars (tests/test_parallel.py:60-64); with dropout and
  augmentation the loss is finite and falls;
- (d) ``sp_attention`` and ``ring_attention`` at world 4 equal plain
  attention and JAX's functions (atol 2e-5, rtol 1e-5), their gradients
  the plain ones (atol 1e-4);
- (e) kill and resume at 2 x 2 is bitwise; JAX's 4 x 2 checkpoint
  restores onto the port's 2 x 2 mesh, and the port's onto JAX's 4 x 2 and
  8 x 1 meshes, leaves exactly equal;
- (f) ``dryrun_multichip(4, device="cpu")``.
"""

import ast
import dataclasses
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_parallel_workers as W
from transformer_stm_tpu import config as jax_config
from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.models.cvt import init_cvt as jax_init_cvt
from transformer_stm_tpu.parallel import ShardedTrainer as JaxTrainer
from transformer_stm_tpu.parallel import build_mesh as jax_build_mesh
from transformer_stm_tpu.parallel import \
    cvt_param_sharding as jax_param_sharding
from transformer_stm_tpu.parallel.sequence import \
    ring_attention as jax_ring_attention
from transformer_stm_tpu.parallel.sequence import \
    sp_attention as jax_sp_attention
from transformer_stm_tpu.train.checkpoint import _path_str
from transformer_stm_tpu_torch.config import CvTSpec, MeshConfig
from transformer_stm_tpu_torch.models.cvt import cvt_forward, init_cvt
from transformer_stm_tpu_torch.parallel import (
    cvt_param_sharding, dryrun_multichip, spawn)
from transformer_stm_tpu_torch.train.checkpoint import (
    _flatten, _unflatten, from_jax_params, to_jax_params)
from transformer_stm_tpu_torch.train.loop import TrainLoop

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 (virtual) devices")


def _jax_spec(spec):
    """The JAX CvTSpec of a port one."""
    return jax_config.CvTSpec(
        stages=tuple(jax_config.StageSpec(**dataclasses.asdict(st))
                     for st in spec.stages),
        **{k: v for k, v in dataclasses.asdict(spec).items()
           if k != "stages"})


def _jax_flat(tree, prefix):
    """{"<prefix>/a/0/b": leaf} of a JAX pytree, as its checkpoints key
    them."""
    return {prefix + "".join(_path_str(p) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainer_flat(tr):
    flat = _jax_flat(tr.params, "p")
    flat.update(_jax_flat(tr.state, "s"))
    flat.update(_jax_flat({"step": tr.opt.step, "mu": tr.opt.mu,
                           "nu": tr.opt.nu}, "o"))
    return flat


def _load(d, name):
    with np.load(os.path.join(d, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def _perturbed_trees(rng):
    """TINY's weights from seed 0 with nonzero biases, cls tokens and
    norms and random BatchNorm statistics, so that every leaf counts."""
    params, state = to_jax_params(init_cvt(
        W.TINY, torch.Generator().manual_seed(0), device="cpu"))
    flat = {"p/" + k: (v + 0.05 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in _flatten(params).items()}
    for k, v in _flatten(state).items():
        flat["s/" + k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                          else 0.1 * rng.standard_normal(v.shape)
                          ).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's 4 x 2 checkpoint, and both spawns' outputs."""
    d = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(1)
    np.savez(os.path.join(d, "trees.npz"), **_perturbed_trees(rng))
    qkv = {name: rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
           for name in ("q", "k", "v")}
    np.savez(os.path.join(d, "inputs.npz"),
             img=rng.uniform(0, 1, (8, 32, 32, 1)).astype(np.float32),
             proc=rng.normal(size=(8, 5)).astype(np.float32), **qkv)
    jax_tr = JaxTrainer(_jax_spec(W.TINY),
                        jax_config.TrainConfig(batch_size=16, seed=1),
                        jax_build_mesh(jax_config.MeshConfig(data=4,
                                                             model=2)),
                        impl="xla")
    jax_tr.save(os.path.join(d, "jax_ck"), epoch=3)
    spawn(W.worker_2x2, 4, "cpu", d)
    spawn(W.worker_4x1, 4, "cpu", d)
    return {"dir": d, "jax_ck": _jax_trainer_flat(jax_tr)}


# ---------------------------------------------------------------------------
# (a) sharding rules


@needs_8
@pytest.mark.parametrize("spec", [W.TINY, CvTSpec()], ids=["tiny", "full"])
def test_sharding_axes_equal_jax(spec):
    """Every parameter's split axis at model 2 is the one JAX's
    PartitionSpec puts 'model' on."""
    params, _ = jax.eval_shape(lambda: jax_init_cvt(jax.random.PRNGKey(0),
                                                    _jax_spec(spec)))
    specs = jax_param_sharding(
        params, jax_build_mesh(jax_config.MeshConfig(data=4, model=2)))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name = "".join(_path_str(p) for p in path)[1:].replace("/", ".")
        want[name] = (list(s.spec).index("model") if "model" in s.spec
                      else None)
    model = init_cvt(spec, torch.Generator().manual_seed(0), device="cpu")
    got = cvt_param_sharding(model, MeshConfig(data=2, model=2))
    assert got == want
    assert any(a is not None for a in got.values())
    assert got["stages.0.blocks.0.attn.mha.query.kernel"] is None  # 1 head
    assert set(cvt_param_sharding(model, MeshConfig(model=1)).values()) \
        == {None}


# ---------------------------------------------------------------------------
# (b) the tensor-parallel forward


@pytest.fixture(scope="module")
def forwards(runs):
    """The port's replicated forward and JAX's of the test's weights."""
    flat = _load(runs["dir"], "trees")
    params = _unflatten(_part(flat, "p/"))
    state = _unflatten(_part(flat, "s/"))
    x = _load(runs["dir"], "inputs")
    with torch.inference_mode():
        replicated = cvt_forward(
            from_jax_params(params, state, W.TINY, device="cpu"),
            torch.from_numpy(x["img"]), torch.from_numpy(x["proc"])).numpy()
    want, _ = jax.jit(lambda p, s, i, q: jax_cvt_forward(
        p, s, _jax_spec(W.TINY), i, q, train=False, impl="xla"))(
            params, state, x["img"], x["proc"])
    grads = {}
    for check, spec, mlp_impl in W.TRAIN_CHECKS:
        model = from_jax_params(params, state, spec, device="cpu")
        grads.update({f"{check}/{n}": g.numpy() for n, g in
                      W.train_grads(model, x, mlp_impl).items()})
    return replicated, np.asarray(want), grads


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_tp_forward_matches_replicated_and_jax(runs, forwards, layout):
    """Evaluation: the output equals the replicated model's and JAX's."""
    got = _load(runs["dir"], f"tp_{layout}")
    replicated, want, grads = forwards
    # heads, hidden units and channels were split at every stage the
    # model axis divides
    sharded = set(got["sharded"].tolist())
    assert "stages.1.blocks.0.mlp.fc1.kernel" in sharded
    assert "stages.0.embed.proj.kernel" in sharded
    assert ("stages.1.blocks.0.attn.mha.query.kernel" in sharded) == \
        (layout == "2x2")
    np.testing.assert_allclose(got["out"], replicated, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["out"], want, atol=1e-4, rtol=0)
    # training: the gradients of every parameter, whole, equal the
    # replicated model's (dropout drawn alike on the plain MLP and, each
    # shard its block of the hidden mask, on the fused training MLP; fc2's
    # bias added once)
    assert set(grads) <= set(got)
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, atol=1e-5,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# (c) data parallelism


@pytest.fixture(scope="module")
def train_loop_epoch():
    images, proc, labels = W.toy()
    loop = TrainLoop(W.TINY0, W.DP_CFG, device="cpu")
    rec = loop.fit(images, proc, labels, epochs=1, verbose=False)
    params, state = to_jax_params(loop.model)
    flat = {"p/" + k: v for k, v in _flatten(params).items()}
    flat.update({"s/" + k: v for k, v in _flatten(state).items()})
    return rec["records"].rows[0][1], flat


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_dp_epoch_matches_train_loop(runs, train_loop_epoch, layout):
    """One epoch data(+tensor)-parallel equals one epoch of TrainLoop with
    the same seeds, from the device-resident and from host arrays, the
    synced BatchNorm moving statistics included."""
    loss, want = train_loop_epoch
    got = _load(runs["dir"], f"dp_{layout}")
    assert np.isfinite(got["loss"])
    for prefix in ("", "host/"):
        key = "host_loss" if prefix else "loss"
        assert float(got[key]) == pytest.approx(loss, rel=1e-3)
        for k, v in want.items():
            np.testing.assert_allclose(got[prefix + k], v, atol=2e-3,
                                       rtol=0, err_msg=k)
    assert any(k.startswith("s/") for k in want)


def test_dp_with_dropout_and_augmentation_trains(runs):
    """Dropout 0.1 and augmentation at 4 x 1: finite, falling losses
    (tests/test_parallel.py:test_sharded_training_with_augmentation)."""
    losses = _load(runs["dir"], "dropout_4x1")["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# (d) sequence parallelism


@needs_8
@pytest.mark.parametrize("name", ["sp_attention", "ring_attention"])
def test_sequence_parallel_matches_plain_and_jax(runs, name):
    x = _load(runs["dir"], "inputs")
    got = _load(runs["dir"], "attention")
    out, dq, dk, dv = W.plain_attention_grads(x["q"], x["k"], x["v"])
    jax_fn = {"sp_attention": jax_sp_attention,
              "ring_attention": jax_ring_attention}[name]
    mesh = jax_build_mesh(jax_config.MeshConfig(data=4, model=1))
    want = jax.jit(lambda q, k, v: jax_fn(q, k, v, mesh))(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    np.testing.assert_allclose(got[f"{name}/out"], out, atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[f"{name}/out"], np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    for key, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[f"{name}/{key}"], ref, atol=1e-4,
                                   rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# (e) sharded checkpoints


def _equal(a, b, keys=None):
    keys = sorted(b) if keys is None else keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _part(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def test_kill_and_resume_is_bitwise(runs):
    """Two epochs straight == one epoch, a checkpoint, a new trainer
    restored from it and one more epoch, bit for bit
    (tests/test_sharded_checkpoint.py:50-78)."""
    got = _load(runs["dir"], "ckpt_2x2")
    assert int(got["epoch"]) == 1
    ref, resumed = _part(got, "ref/"), _part(got, "resumed/")
    assert set(ref) == set(resumed) and any(k.startswith("o/mu/")
                                            for k in ref)
    _equal(resumed, ref)
    files = sorted(os.listdir(os.path.join(runs["dir"], "port_ck")))
    assert files == ["ckpt_000001.manifest.json"] + [
        f"ckpt_000001.shard{r}.npz" for r in range(4)]


def test_jax_checkpoint_restores_onto_port_mesh(runs):
    """JAX's checkpoint of a 4 x 2 mesh onto the port's 2 x 2 mesh: every
    leaf equal."""
    got = _load(runs["dir"], "ckpt_2x2")
    assert int(got["jax_epoch"]) == 3
    from_jax, want = _part(got, "from_jax/"), runs["jax_ck"]
    assert set(from_jax) == set(want)
    _equal(from_jax, want)


@needs_8
@pytest.mark.parametrize("data,model", [(4, 2), (8, 1)],
                         ids=["4x2", "8x1"])
def test_port_checkpoint_restores_onto_jax_mesh(runs, data, model):
    got = _part(_load(runs["dir"], "ckpt_2x2"), "saved/")
    tr = JaxTrainer(_jax_spec(W.TINY), jax_config.TrainConfig(seed=7),
                    jax_build_mesh(jax_config.MeshConfig(data=data,
                                                         model=model)),
                    tensor_parallel=model > 1, impl="xla")
    assert tr.load(os.path.join(runs["dir"], "port_ck")) == 1
    flat = _jax_trainer_flat(tr)
    assert set(flat) == set(got)
    _equal(flat, got)
    shards = [re.sub(r"\|.*", "", k) for k in np.load(os.path.join(
        runs["dir"], "port_ck", "ckpt_000001.shard1.npz")).files]
    # model rank 1 of data rank 0 wrote only the split leaves' halves
    assert shards and all("mlp/fc" in k or "/mha/" in k or "embed" in k
                          or "conv" in k for k in shards)


# ---------------------------------------------------------------------------
# the kernels' stream


def _is_current_stream(node):
    """``torch.cuda.current_stream(...).cuda_stream``."""
    return (isinstance(node, ast.Attribute) and node.attr == "cuda_stream"
            and isinstance(node.value, ast.Call)
            and ast.unparse(node.value.func) == "torch.cuda.current_stream")


def test_kernel_wrappers_launch_on_the_current_stream():
    """Every kernel launch of the port's wrappers passes the current
    stream's handle as its last argument, itself or through a name bound to
    it in the same function, so that NCCL's stream-ordered collectives wait
    for the kernels' results; no wrapper makes a stream of its own."""
    root = os.path.join(os.path.dirname(__file__), "..",
                        "transformer_stm_tpu_torch", "kernels")
    launches = 0
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, name)).read())
        assert "torch.cuda.Stream" not in ast.unparse(tree), name
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            bound = {t.id for a in ast.walk(fn) if isinstance(a, ast.Assign)
                     and _is_current_stream(a.value)
                     for t in a.targets if isinstance(t, ast.Name)}
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and isinstance(
                        call.func, ast.Attribute) and \
                        call.func.attr.startswith("launch_"):
                    last = call.args[-1]
                    assert _is_current_stream(last) or (
                        isinstance(last, ast.Name) and last.id in bound), \
                        f"{name}:{call.lineno} {call.func.attr}"
                    launches += 1
    assert launches >= 12


# ---------------------------------------------------------------------------
# (f) the dry run


def test_dryrun_multichip_on_cpu(capfd):
    dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK on 4 ranks (mesh data=2 x model=2" in \
        capfd.readouterr().out
