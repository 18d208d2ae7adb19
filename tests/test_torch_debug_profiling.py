"""The port's debug mode (transformer_stm_tpu_torch/debug.py) and profiling
tools (tools/profiling.py) on the CPU, beside tests/test_debug_profiling.py.

- ``check_finite`` and ``guard`` raise where the JAX functions raise, on
  the same trees, naming the same key path;
- ``debug_mode`` traps a forward NaN and a backward NaN at the operation
  that makes it and names it, restores anomaly detection and the dispatch
  mode stack, leaves a clean forward and backward of a tiny CvT (every
  kernel wrapper's plain version, the training MLP included) bit-equal, and
  traps a NaN planted in one weight at the convolution that reads it;
  ``check_kernel`` names the kernel under it and does nothing outside it;
  it refuses to run inside a CUDA graph capture;
- ``trace`` writes a Chrome trace holding the annotated region;
  ``StepTimer`` keeps JAX's summary keys.
"""

import copy
import glob
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transformer_stm_tpu import debug as jax_debug
from transformer_stm_tpu.tools.profiling import StepTimer as JaxStepTimer
from transformer_stm_tpu_torch import debug
from transformer_stm_tpu_torch.debug import (check_finite, check_kernel,
                                             debug_mode, guard)
from transformer_stm_tpu_torch.models.cvt import cvt_forward, init_cvt
from transformer_stm_tpu_torch.tools.profiling import (StepTimer, annotate,
                                                       device_memory_summary,
                                                       trace)
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from test_torch_multi import tiny

import transformer_stm_tpu_torch.config as pc


def test_check_finite_names_the_path_as_jax_does():
    good = {"a": np.ones(3), "b": {"c": np.zeros(2)}}
    check_finite({"a": torch.ones(3), "b": {"c": torch.zeros(2)}})
    check_finite(good)
    bad = {"a": {"bad": np.asarray([1.0, np.nan])}, "b": [np.ones(1)]}
    msgs = []
    for fn, tree in ((check_finite, bad),
                     (check_finite, {"a": {"bad": torch.tensor(
                         [1.0, float("inf")])}, "b": [torch.ones(1)]}),
                     (jax_debug.check_finite,
                      {"a": {"bad": jnp.asarray([1.0, np.nan])},
                       "b": [jnp.ones(1)]})):
        with pytest.raises(FloatingPointError) as e:
            fn(tree, "params")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2] == \
        "non-finite values in params at ['a']['bad']"
    check_finite({"i": np.array([1, 2])})  # integer leaves are skipped


def test_check_finite_reads_a_module_state_dict():
    model = init_cvt(tiny(pc), torch.Generator().manual_seed(0), "cpu")
    check_finite(model, "model")
    with torch.no_grad():
        model.stages[1].blocks[0].mlp.fc1.bias[2] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"\['stages.1.blocks.0.mlp.fc1.bias'\]"):
        check_finite(model, "model")


@pytest.mark.parametrize("shape", ["dict", "tuple"])
def test_guard_raises_on_nan_loss(shape):
    def step(loss):
        m = {"loss": torch.tensor(loss), "mae": torch.tensor(1.0)}
        return m if shape == "dict" else (None, m)

    with pytest.raises(FloatingPointError, match="loss"):
        guard(step)(float("nan"))
    out = guard(step)(0.5)
    m = out if shape == "dict" else out[-1]
    assert float(m["loss"]) == 0.5
    with pytest.raises(FloatingPointError, match="loss"):
        jax_debug.guard(lambda: (None, {"loss": jnp.asarray(np.nan)}))()


def test_debug_mode_traps_a_forward_nan_and_restores():
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    x = torch.tensor([1.0, 2.0])
    with debug_mode() as dbg:
        assert torch.is_anomaly_enabled()
        y = x * 2
        with pytest.raises(FloatingPointError,
                           match=r"NaN in the output of aten\.div\.Tensor"):
            (x - 1) / (x - 1)
        with pytest.raises(FloatingPointError, match=r"Inf .*aten\.log"):
            torch.log(x - 1)
        torch.empty(1000)           # uninitialised memory is not checked
    assert dbg.ops >= 4 and torch.equal(y, x * 2)
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    assert not _get_current_dispatch_mode_stack()
    assert torch.isinf(torch.log(x - 1)).any()  # no trap outside
    with debug_mode(nans=True, infs=False):
        torch.log(x - 1)
        with pytest.raises(FloatingPointError):
            torch.log(x - 3)


def test_debug_mode_traps_a_backward_nan():
    """The norm of zeros: a finite forward, a 0/0 in its backward."""
    z = torch.zeros(3, requires_grad=True)
    with debug_mode():
        n = torch.linalg.vector_norm(z)
        assert float(n.detach()) == 0.0
        with pytest.warns(UserWarning, match="LinalgVectorNormBackward0"):
            with pytest.raises(FloatingPointError, match=r"NaN .*aten\."):
                n.backward()


def test_check_kernel_names_the_kernel():
    nan = torch.tensor([0.0, float("nan")])
    check_kernel("fused_mlp_train", nan)           # outside: nothing
    with debug_mode() as dbg:
        check_kernel("fused_mlp", torch.ones(2), None)
        with pytest.raises(FloatingPointError,
                           match="NaN in the output of the "
                                 "attention_small_bwd kernel"):
            check_kernel("attention_small_bwd", torch.ones(2), nan)
    assert dbg.kernels == 2


def test_debug_mode_refuses_a_graph_capture(monkeypatch):
    monkeypatch.setattr(debug, "_capturing", lambda: True)
    with debug_mode():
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            torch.ones(2) * 2


def _fwd_bwd(model, x, proc):
    model.requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    out = cvt_forward(model, x, proc, train=True, generator=gen,
                      impl="small", mlp_impl="pallas")
    grads = torch.autograd.grad(out.square().mean(),
                                list(model.parameters()))
    return [out.detach(), *grads]


def test_debug_mode_leaves_a_clean_step_bit_equal_and_traps_a_weight():
    model = init_cvt(tiny(pc, rate=0.1), torch.Generator().manual_seed(0),
                     "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((4, 32, 32, 1), np.float32))
    proc = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    clean = _fwd_bwd(copy.deepcopy(model), x, proc)
    with debug_mode() as dbg:
        checked = _fwd_bwd(copy.deepcopy(model), x, proc)
    assert dbg.ops > 500
    assert all(map(torch.equal, clean, checked))
    bad = copy.deepcopy(model)
    with torch.no_grad():
        bad.stages[0].embed.proj.kernel.view(-1)[5] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"NaN in the output of aten\.convolution"):
        with debug_mode():
            _fwd_bwd(bad, x, proc)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("tiny step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "tiny step" in names and "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_summary_keys_match_jax():
    import time

    ours, theirs = StepTimer(warmup=1), JaxStepTimer(warmup=1)
    for t in (ours, theirs):
        for _ in range(4):
            with t:
                time.sleep(0.01)
    s, j = ours.summary(items_per_step=100), theirs.summary(100)
    assert s.keys() == j.keys()
    assert s["steps"] == 3
    assert 0.005 < s["mean_s"] < 0.2
    assert s["items_per_sec"] > 0


def test_device_memory_summary_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_summary() == "no device memory stats available"
