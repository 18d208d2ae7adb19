"""Builds ``csrc/*.cu`` with nvcc into one shared library, loaded with ctypes.

The sources hold plain CUDA C++ with ``extern "C"`` launchers and include no
PyTorch header, so each one compiles in seconds.  Every source is compiled
by its own ``nvcc -c`` process, all started together, and the objects are
linked into ``_build/libtstm_torch_kernels.so`` for ``sm_90a`` (Hopper).
A sha256 of the sources, the headers beside them (``*.cuh``) and the flags
is kept in a ``.stamp`` file beside the library (as
``transformer_stm_tpu/data/native.py`` does for the C++ preprocessor): the library is rebuilt only when the digest differs.

Nothing is built when this module is imported; ``library()`` builds at first
use, so that the CPU tests can import every kernel module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libtstm_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 300
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # q, k, v, o, lse (or null), B, T, S, H, Dh, scale, stream
    "launch_attention_small": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
    # q, k, v, dO, lse, delta, dq, dk, dv, B, T, S, H, Dh, scale, stream
    "launch_attention_small_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # q, k, v, o, lse (or null), B, T, S, H, Dh, scale, vec, stream
    "launch_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _P],
    # q, k, v, dO, lse, delta, dq, dk, dv, B, T, S, H, Dh, scale, vec, stream
    "launch_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, ctypes.c_float, _I,
                                   _P],
    # x, w1, b1, w2, b2, y, N, D, Hd, Dout, stream
    "launch_fused_mlp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w1, b1, w2, b2, seed, y, N, D, Hd, Dout, keep threshold, keep
    # scale, stream
    "launch_fused_mlp_train_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, ctypes.c_uint32, ctypes.c_float, _P],
    # x, dy, w1, b1, w2, seed, dx, dw1p, db1p, dw2p, db2p, N, D, Hd, Dout,
    # rows per block, keep threshold, keep scale, stream
    "launch_fused_mlp_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, ctypes.c_uint32,
                                   ctypes.c_float, _P],
}

_lib = None
# What the last build in this process printed (ptxas register and shared
# memory counts) and how long it took; None when the library was up to date.
build_log = ""
build_seconds = None


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def headers():
    return sorted(SRC_DIR.glob("*.cuh"))


def _digest(srcs) -> str:
    """sha256 of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in [*srcs, *headers()]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    path = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {CUDA_NVCC}: the CUDA kernels "
            "build only where the CUDA toolkit is installed")
    return path


def commands(nvcc: str, srcs, out_dir: Path):
    """(one compile command per source, the link command)."""
    objs = [out_dir / (src.stem + ".o") for src in srcs]
    compiles = [[nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(srcs, objs)]
    link = [nvcc, *ARCH, "-shared", "-o", str(out_dir / LIB_NAME),
            *map(str, objs)]
    return compiles, link


def _run_all(cmds):
    """Runs the commands in parallel; returns their combined stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        deadline = time.monotonic() + NVCC_TIMEOUT_S
        log = []
        for cmd, proc in zip(cmds, procs):
            left = max(deadline - time.monotonic(), 1.0)
            try:
                out, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: "
                                   f"{' '.join(cmd)}") from None
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}{err}")
            log.append(out + err)
        return "".join(log)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> Path:
    """Builds the library unless the stamp says it is up to date."""
    global build_log, build_seconds
    srcs = sources()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".stamp")
    digest = _digest(srcs)
    if lib_path.exists() and stamp.exists() and \
            stamp.read_text().strip() == digest:
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles, link = commands(nvcc, srcs, Path(tmp))
        log = _run_all(compiles)
        log += _run_all([link])
        os.replace(Path(tmp) / LIB_NAME, lib_path)
    stamp.write_text(digest)
    build_log = log
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
