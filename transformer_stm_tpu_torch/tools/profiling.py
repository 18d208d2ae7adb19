"""Tracing and profiling (transformer_stm_tpu/tools/profiling.py:84-138).

- ``trace(log_dir)``: ``torch.profiler`` over the host's and the card's
  activity for everything inside the block; on exit it writes a
  Chrome/Perfetto trace, ``{host}_{pid}.{ns}.pt.trace.json``, into
  ``log_dir`` (open it in Perfetto, chrome://tracing or TensorBoard's
  PyTorch profiler plugin).  The block gets the profiler, whose
  ``events()`` and ``key_averages()`` stay readable after it.
- ``annotate(name)``: a named region inside a traced step
  (``torch.profiler.record_function``).
- ``StepTimer``: wall-clock times per step, synchronised with the card, so
  that a time is the card's work and not its launch; a summary with warm-up
  steps skipped.
- ``device_memory_summary``: one line of each card's memory
  (``tools/monitor.cuda_memory_stats``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Captures a trace of the block: ``with trace('profile'): step()``.
    The card's activity is recorded where CUDA is available."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()  # writes the trace


def annotate(name: str):
    """Named region inside a traced step."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per-step stats with device sync on read: each step's time
    ends after a ``torch.cuda.synchronize()`` where CUDA is initialised."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self, items_per_step: Optional[int] = None) -> Dict:
        import numpy as np

        ts = np.array(self.times[self.warmup:] or self.times)
        out = {
            "steps": len(ts),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p95_s": float(np.percentile(ts, 95)),
        }
        if items_per_step:
            out["items_per_sec"] = items_per_step / out["mean_s"]
        return out


def device_memory_summary() -> str:
    """One line of each card's memory (``tools/monitor.py`` has the live
    loop)."""
    from .monitor import cuda_memory_stats

    stats = cuda_memory_stats()
    if not stats:
        return "no device memory stats available"
    return "; ".join(
        f"{d['device']}: {d['bytes_in_use_gb']:.2f}/{d['bytes_limit_gb']:.2f}"
        f" GB (peak {d['peak_bytes_gb']:.2f})" for d in stats)
