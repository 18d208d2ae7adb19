"""Resource monitor (transformer_stm_tpu/tools/monitor.py; reference
tools/memory.py:6-70, ``make memory``): the host's CPU and RAM and each
card's memory, one line a second.

    python -m transformer_stm_tpu_torch.cli memory

``cuda_memory_stats`` takes the place of the JAX package's TPU HBM stats:
each card's memory in use and its size (``torch.cuda.mem_get_info``) and
this process's allocations (``torch.cuda.memory_stats``); without CUDA it
returns [].  The host's numbers come from /proc (Linux): the busy share of
all cores since the previous call, and MemTotal less MemAvailable.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

_last_cpu_times: Optional[List[int]] = None


def _proc_cpu_percent() -> float:
    """The busy share of all cores since the previous call (0.0 at the
    first), from /proc/stat."""
    global _last_cpu_times
    with open("/proc/stat") as f:
        times = [int(v) for v in f.readline().split()[1:]]
    last, _last_cpu_times = _last_cpu_times, times
    if last is None:
        return 0.0
    d = [a - b for a, b in zip(times, last)]
    total = sum(d)
    idle = d[3] + (d[4] if len(d) > 4 else 0)  # idle + iowait
    return 100.0 * (total - idle) / total if total > 0 else 0.0


def cpu_ram_stats() -> Dict:
    """{"cpu_percent", "ram_used_gb", "ram_total_gb"} of the host."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            mem[key] = int(value.split()[0]) * 1024
    return {"cpu_percent": _proc_cpu_percent(),
            "ram_used_gb": (mem["MemTotal"] - mem["MemAvailable"]) / 2**30,
            "ram_total_gb": mem["MemTotal"] / 2**30}


def cuda_memory_stats() -> List[Dict]:
    """One dict a card, in GiB: the JAX package's keys (``device``, and
    this process's ``bytes_in_use_gb`` and ``peak_bytes_gb`` with the
    card's size as ``bytes_limit_gb``) and the memory in use on the card by
    every process (``used_gb``); [] without CUDA.  It reads and changes
    nothing else."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "used_gb": (total - free) / 2**30,
            "bytes_limit_gb": total / 2**30,
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current",
                                         0) / 2**30,
            "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 2**30,
        })
    return out


def format_line() -> str:
    s = cpu_ram_stats()
    line = (f"CPU {s['cpu_percent']:5.1f}%  RAM "
            f"{s['ram_used_gb']:6.2f}/{s['ram_total_gb']:.1f} GB")
    for d in cuda_memory_stats():
        line += (f"  | {d['device']}: memory {d['used_gb']:.2f}"
                 f"/{d['bytes_limit_gb']:.2f} GB (this process "
                 f"{d['bytes_in_use_gb']:.2f}, peak "
                 f"{d['peak_bytes_gb']:.2f})")
    return line


def monitor_loop(interval: float = 1.0, iterations: Optional[int] = None):
    """Prints ``format_line()`` every ``interval`` seconds, ``iterations``
    times or until Ctrl-C."""
    n = 0
    try:
        while iterations is None or n < iterations:
            print(format_line(), flush=True)
            time.sleep(interval)
            n += 1
    except KeyboardInterrupt:
        pass
