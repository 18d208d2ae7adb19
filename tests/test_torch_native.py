"""The port's native image loader (``data/native.py`` over its own copy of
``native/preprocess.cpp``) against the JAX package's on the CPU, exact.

- ``decode_batch`` bit-equal to JAX's native one on cv2-written JPEGs of
  several sizes, to several output sizes;
- ``resize_gray`` bit-equal to JAX's, and within JAX's own bound of cv2's
  resize then BGR2GRAY (tests/test_native.py: at most 1 grey level, on
  under 2% of the pixels; cv2's vectorised paths round some sizes
  differently);
- a missing file raises;
- the library builds into the port's ``_build/`` (never into
  ``transformer_stm_tpu/native/``) from the port's source, whose code is
  the JAX package's, and is rebuilt only when the source's sha256
  changes.

Skipped where g++ or libjpeg's header is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from transformer_stm_tpu.data import native as jax_native
from transformer_stm_tpu_torch.data import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeglib_header() -> bool:
    if shutil.which("g++") is None:
        return False
    out = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                         input="#include <jpeglib.h>\n", capture_output=True,
                         text=True)
    return out.returncode == 0


pytestmark = pytest.mark.skipif(not _jpeglib_header(),
                                reason="needs g++ and libjpeg's header")

# (source height, width) -> (output height, width)
SIZES = [((40, 40), (32, 32)), ((345, 340), (128, 128)),
         ((345, 340), (224, 200)), ((17, 23), (64, 48))]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    out = {}
    for (h, w), _ in SIZES:
        paths = []
        for i in range(3):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img[: h // 2] //= 3  # some structure besides the noise
            p = str(root / f"img_{h}x{w}_{i}.jpg")
            cv2.imwrite(p, img)
            paths.append(p)
        out[(h, w)] = paths
    return out


@pytest.mark.parametrize("src,dst", SIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in SIZES])
def test_decode_batch_bit_equal_to_jax(jpegs, src, dst):
    paths = jpegs[src]
    got = native.decode_batch(paths, *dst)
    want = jax_native.decode_batch(paths, *dst)
    assert got.shape == (3,) + dst and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    one = native.decode_batch(paths, *dst, threads=1)
    np.testing.assert_array_equal(one, got)


@pytest.mark.parametrize("src,dst", SIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in SIZES])
def test_resize_gray_bit_equal_to_jax_and_near_cv2(src, dst):
    import cv2

    bgr = np.random.default_rng(1).integers(0, 256, src + (3,),
                                            dtype=np.uint8)
    got = native.resize_gray(bgr, *dst)
    np.testing.assert_array_equal(got, jax_native.resize_gray(bgr, *dst))
    want = cv2.cvtColor(cv2.resize(bgr, (dst[1], dst[0])),
                        cv2.COLOR_BGR2GRAY)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_missing_file_raises(jpegs, tmp_path):
    paths = jpegs[(40, 40)][:1] + [str(tmp_path / "absent.jpg")]
    with pytest.raises(IOError, match="1/2 files failed"):
        native.decode_batch(paths, 32, 32)


def test_builds_into_the_port_from_its_own_source(monkeypatch):
    assert os.path.dirname(native.LIB) == os.path.join(
        ROOT, "transformer_stm_tpu_torch", "_build")
    assert native.SRC == os.path.join(ROOT, "transformer_stm_tpu_torch",
                                      "native", "preprocess.cpp")
    jax_dir = os.path.join(ROOT, "transformer_stm_tpu", "native")
    assert os.path.commonpath([native.LIB, jax_dir]) != jax_dir

    def code(path):  # the lines that are not comments
        with open(path) as f:
            return [ln for ln in f if not ln.lstrip().startswith("//")]

    assert code(native.SRC) == code(os.path.join(jax_dir, "preprocess.cpp"))
    assert native.available()
    with open(native.LIB + ".stamp") as f:
        assert f.read() == native._src_hash()

    calls = []
    real = subprocess.run

    def spy(cmd, *a, **k):
        calls.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", spy)
    assert native.build() == native.LIB and calls == []  # up to date
    native.build(force=True)
    (cmd,) = calls
    assert cmd[0] == "g++" and native.SRC in cmd and "-ljpeg" in cmd
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == os.path.dirname(native.LIB)
    assert os.path.exists(native.LIB) and not os.path.exists(out)
