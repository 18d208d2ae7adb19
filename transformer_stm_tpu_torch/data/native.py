"""ctypes bindings of the native host image loader
(transformer_stm_tpu/data/native.py): the port's own copy of its C++
source, ``native/preprocess.cpp`` (threaded libjpeg decode, then OpenCV's
fixed-point bilinear resize and BT.601 grey, bit-identical to the cv2
pipeline whenever libjpeg decodes the same pixels as cv2's decoder).

The library is built with g++ at first use into the package's ``_build/``
(ignored by git) and rebuilt when the source's sha256 differs from the
one recorded beside it:

    from transformer_stm_tpu_torch.data import native
    grey = native.decode_batch(paths, 128, 128)   # (N, 128, 128) uint8

It needs g++ and libjpeg's header and library; ``available()`` says whether
they are there.  ``python -m transformer_stm_tpu_torch.data.native
[--force]`` builds it and prints the library's path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "preprocess.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libtstm_torch_preprocess.so")

_lib: Optional[ctypes.CDLL] = None


def _src_hash() -> str:
    with open(SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build(force: bool = False) -> str:
    """Compiles the library unless ``LIB`` was built from this source
    (``LIB.stamp`` holds the source's sha256); returns its path.  The
    library and its stamp are written to temporary names and renamed, so
    that processes building at once each see a whole library."""
    h = _src_hash()
    stamp = LIB + ".stamp"
    if not force and os.path.exists(LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == h:
                return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", SRC, "-o", tmp, "-ljpeg",
                        "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".stamp")
    with os.fdopen(fd, "w") as f:
        f.write(h)
    os.replace(tmp, stamp)
    return LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tstm_resize_gray.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         u8p, ctypes.c_int, ctypes.c_int]
        lib.tstm_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.c_int]
        lib.tstm_decode_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def resize_gray(bgr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (out_h, out_w) uint8 grey, bit-exact with
    cv2.resize(INTER_LINEAR) then cv2.cvtColor(BGR2GRAY)."""
    lib = _load()
    bgr = np.ascontiguousarray(bgr, np.uint8)
    out = np.empty((out_h, out_w), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tstm_resize_gray(bgr.ctypes.data_as(u8p), bgr.shape[0], bgr.shape[1],
                         out.ctypes.data_as(u8p), out_h, out_w)
    return out


def decode_batch(paths: Sequence[str], out_h: int, out_w: int,
                 threads: int = 0) -> np.ndarray:
    """Decodes, resizes and greys a batch of JPEGs on ``threads`` native
    threads (0: the library's choice) -> (N, out_h, out_w) uint8.  Raises
    IOError when any file fails."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, out_h, out_w), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ok = lib.tstm_decode_batch(
        arr, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    if ok != n:
        raise IOError(f"native decode: {n - ok}/{n} files failed")
    return out


if __name__ == "__main__":
    import sys

    print(build(force="--force" in sys.argv))
