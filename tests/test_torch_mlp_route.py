"""The CvT block's MLP route, port against JAX.

JAX's ``conv_transformer_block`` hands its mlp the route ``mlp_impl if
mlp_impl is not None else impl`` (transformer_stm_tpu/ops/blocks.py:
136-139), in training and in evaluation; ``mlp`` then trains through
``make_fused_mlp_train`` on "pallas" and "flash" (:58-66) and evaluates
through ``fused_mlp`` on them (:67-70).  Spies count the port's
``fused_mlp_train`` and ``fused_mlp`` calls and JAX's ``make_fused_mlp_train``
and ``fused_mlp`` calls for one small block over every ``impl`` x
``mlp_impl`` pair JAX takes, training and evaluating; the counts must
agree.  The port's ``"plain"`` is JAX's ``"xla"``.  In evaluation JAX's
``"auto"`` takes the kernel on its accelerator and XLA on the CPU
(:51-53), where the port's ``"auto"`` takes the kernel (on the CPU its
plain version); so JAX's block runs here with its backend reported as the
TPU.  Last, a train-mode narrow CvT at dropout 0 with ``impl="pallas"``
launches the training MLP once per block in both packages and agrees with
JAX within 1e-3 (the bar of tests/test_reference_golden.py:73); JAX's
kernels run under the Pallas interpreter.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from transformer_stm_tpu.models.cvt import cvt_forward as jax_cvt_forward
from transformer_stm_tpu.ops import blocks as jax_blocks
from transformer_stm_tpu_torch.config import CvTSpec
from transformer_stm_tpu_torch.models.cvt import cvt_forward
from transformer_stm_tpu_torch.ops import blocks
from transformer_stm_tpu_torch.train.checkpoint import from_jax_params

from test_torch_train_grads import _narrow, _setup

jax_fa = importlib.import_module(
    "transformer_stm_tpu.kernels.flash_attention")
jax_mlp = importlib.import_module("transformer_stm_tpu.kernels.fused_mlp")

IMPLS = [("auto", "auto"), ("plain", "xla"), ("pallas", "pallas"),
         ("flash", "flash")]  # (port, JAX)
MLP_IMPLS = [None, "xla", "pallas", "flash"]
DIM, HEADS, GRID, BATCH = 16, 2, 4, 2


class _ReportsTPU:
    """The ``jax`` module as JAX's blocks see it, with the TPU as backend."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def spies(monkeypatch):
    """Counts of each package's MLP kernel calls; JAX's kernels run under
    the Pallas interpreter."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)
    counts = dict.fromkeys(("port_train", "port_eval", "jax_train",
                            "jax_eval"), 0)

    def spy(module, name, key):
        real = getattr(module, name)

        def f(*a, **kw):
            counts[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, f)

    spy(blocks, "fused_mlp_train", "port_train")
    spy(blocks, "fused_mlp", "port_eval")
    spy(jax_mlp, "make_fused_mlp_train", "jax_train")
    spy(jax_mlp, "fused_mlp", "jax_eval")
    return counts


@pytest.mark.parametrize("mlp_impl", MLP_IMPLS, ids=str)
@pytest.mark.parametrize("impl,jax_impl", IMPLS, ids=[p for p, _ in IMPLS])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_block_mlp_route_matches_jax(spies, monkeypatch, impl, jax_impl,
                                     mlp_impl, train):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, GRID, GRID, DIM)).astype(np.float32)
    params, state = jax_blocks.init_conv_transformer_block(
        jax.random.PRNGKey(0), DIM, HEADS, 3, with_cls_token=True)
    monkeypatch.setattr(jax_blocks, "jax", _ReportsTPU())
    y_jax, cls_jax, _ = jax_blocks.conv_transformer_block(
        params, state, jnp.asarray(x), num_heads=HEADS, kernel_size=3,
        with_cls_token=True, dropout_rate=0.0, train=train, impl=jax_impl,
        mlp_impl=mlp_impl)

    block = blocks.ConvTransformerBlock(
        DIM, HEADS, 3, with_cls_token=True, dropout_rate=0.0,
        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, cls = block(torch.from_numpy(x), impl=impl, train=train,
                       mlp_impl=mlp_impl)
    assert y.shape == y_jax.shape and cls.shape == cls_jax.shape
    assert torch.isfinite(y).all()
    port = (spies["port_train"], spies["port_eval"])
    want = (spies["jax_train"], spies["jax_eval"])
    assert port == want, (f"port (train, eval) MLP kernel calls {port}, "
                          f"JAX {want}")
    route = mlp_impl if mlp_impl is not None else jax_impl
    fused = route in ("pallas", "flash") or (route == "auto" and not train)
    assert sum(port) == int(fused)


def test_cvt_training_on_pallas_takes_the_fused_mlp_as_jax_does(spies):
    """Every block of a train-mode narrow CvT at dropout 0 runs the fused
    training MLP once with ``impl="pallas"`` in both packages; the outputs
    agree within 1e-3."""
    jspec, params, state, batch = _setup("dw_bn", True, seed=3)
    images, proc, _, _ = batch
    want, _ = jax_cvt_forward(jax.tree_util.tree_map(jnp.asarray, params),
                              state, jspec, images, proc, train=True,
                              impl="pallas")
    spec = _narrow(CvTSpec, "dw_bn", True)
    model = from_jax_params(params, jax.tree_util.tree_map(np.asarray, state),
                            spec, device="cpu")
    with torch.no_grad():
        got = cvt_forward(model, *map(torch.from_numpy, (images, proc)),
                          train=True, impl="pallas")
    blocks_n = sum(st.depth for st in spec.stages)
    assert spies["port_train"] == spies["jax_train"] == blocks_n
    assert spies["port_eval"] == spies["jax_eval"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
