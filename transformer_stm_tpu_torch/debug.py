"""Debug and numerical-safety mode (transformer_stm_tpu/debug.py:22-60).

- ``debug_mode()``: traps the first operation that produces a NaN or an
  Inf, as ``jax_debug_nans``/``jax_debug_infs`` do.  In the forward a
  ``TorchDispatchMode`` checks the floating outputs of every aten operation
  and raises ``FloatingPointError`` naming it; the backward runs under
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)`` as well.  The
  CUDA kernels launch through ctypes (``kernels/_build.py``), where the
  dispatcher cannot see them, so under ``debug_mode`` each kernel wrapper
  checks its own outputs (``check_kernel``) and names the kernel.
- ``check_finite(tree, name)``: raises if a leaf of a nested dict, list,
  tuple or ``state_dict`` holds a NaN or Inf, naming its key path.
- ``guard(step_fn)``: wraps a step function and raises on a non-finite
  loss, with the step's metrics.

Each check reads its result on the host, which waits for the card: that
cannot happen while a CUDA graph is being captured, so ``debug_mode``
raises there (``harness._train_ffn(cuda_graph=False)`` runs its epochs
without a graph).  Outside a capture the checks change no result: every
operation runs as it would without them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


class _FiniteCheck(TorchDispatchMode):
    """Checks every aten operation's floating outputs; the factories of
    uninitialised memory (``empty``) and views, which compute nothing, are
    let through.  ``ops`` and ``kernels`` count the checked calls."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs
        self.ops = self.kernels = 0

    def check(self, what: str, outputs) -> None:
        for t in tree_leaves(outputs):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point() \
                    or t.layout != torch.strided or t.is_meta or \
                    t.numel() == 0:
                continue
            if _capturing():
                raise RuntimeError(
                    f"debug_mode: {what} runs inside a CUDA graph capture, "
                    "where its outputs cannot be checked on the host; run "
                    "it without the graph (harness._train_ffn: "
                    "cuda_graph=False)")
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {what}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {what}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not func.is_view and not name.startswith(("empty", "new_empty")):
            self.ops += 1
            self.check(f"aten.{func.__name__}", out)
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Within the block, the first operation or kernel whose output holds a
    NaN (``nans``) or an Inf (``infs``) raises ``FloatingPointError`` naming
    it.  Anomaly detection is on for the backward; both are restored on
    exit.  The block gets the check, whose ``ops`` and ``kernels`` count the
    operations and kernel launches it checked."""
    anomaly = (torch.is_anomaly_enabled(),
               torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(nans or infs, check_nan=nans)
    try:
        with _FiniteCheck(nans, infs) as mode:
            yield mode
    finally:
        torch.autograd.set_detect_anomaly(*anomaly)


def check_kernel(name: str, *outputs) -> None:
    """A kernel wrapper's check of its outputs under ``debug_mode``: raises
    ``FloatingPointError`` naming the kernel; does nothing outside it."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _FiniteCheck):
            mode.kernels += 1
            with _disable_current_modes():  # the check's own ops go unseen
                mode.check(f"the {name} kernel", outputs)


def _leaves_with_path(tree, path=""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Host-side: raises ``FloatingPointError`` if a floating leaf of
    ``tree`` (nested dicts, lists and tuples of tensors or arrays, or a
    module, whose ``state_dict`` is checked) holds a NaN or Inf, naming the
    leaf's key path."""
    import numpy as np

    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name} at {path}")


def _scalar(v) -> float:
    return v.item() if isinstance(v, torch.Tensor) else float(v)


def guard(step_fn: Callable, loss_key: str = "loss") -> Callable:
    """Wraps step(...) -> metrics, or -> (..., metrics) as in JAX: raises
    ``FloatingPointError`` with the step's metrics on a non-finite
    loss."""
    import math

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        metrics = out if isinstance(out, dict) else out[-1]
        loss = _scalar(metrics[loss_key])
        if not math.isfinite(loss):
            raise FloatingPointError(
                f"non-finite {loss_key}={loss}; metrics="
                f"{ {k: _scalar(v) for k, v in metrics.items()} }")
        return out

    return wrapped
