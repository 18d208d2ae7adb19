"""The port's kernel modules on the CPU.

Each kernel's plain PyTorch version is held against the JAX kernel run
under the Pallas interpreter, on the same numpy inputs, at atol 1e-4.  The
CUDA kernels themselves run only on the card (``python3 chip_smoke.py``
compares them there with these plain versions); here the tests check that
the wrappers take the plain version only for CPU tensors, launch nothing
and build nothing, and that the build uses nvcc for sm_90a on sources that
include no PyTorch header.
"""

import importlib
import os
import subprocess
import sys

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu_torch.kernels import _build  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small, attention_small_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_plain)

# the JAX kernels package re-exports functions under the module names
jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")
jax_mlp = importlib.import_module("transformer_stm_tpu.kernels.fused_mlp")

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels read the flag when they run; another test module of
    the same worker may have imported them before the variable was set."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 65, 4, 64), (2, 256, 2, 64)],
                         ids=["S65_H4", "S256_H2"])
def test_attention_small_plain_matches_pallas(shape):
    q, k, v = _qkv(shape, seed=shape[1])
    want = np.asarray(jax_fa.attention_small(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_small_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _mlp_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    hd = 4 * d
    return [rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32)]


@pytest.mark.parametrize("d", [64, 256])
def test_fused_mlp_plain_matches_pallas(d):
    args = _mlp_inputs(40, d, seed=d)
    want = np.asarray(jax_mlp.fused_mlp(*map(jnp.asarray, args)))
    got = fused_mlp_plain(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_attention_wrapper_on_cpu_is_plain_and_launches_nothing():
    q, k, v = map(torch.from_numpy, _qkv((2, 33, 2, 16), seed=7))
    before = attention_small.launches
    assert torch.equal(attention_small(q, k, v),
                       attention_small_plain(q, k, v))
    assert attention_small.launches == before


def test_mlp_wrapper_on_cpu_is_plain_and_launches_nothing():
    args = list(map(torch.from_numpy, _mlp_inputs(9, 32, seed=8)))
    before = fused_mlp.launches
    x = args[0].reshape(3, 3, 32)
    assert torch.equal(fused_mlp(x, *args[1:]), fused_mlp_plain(x, *args[1:]))
    assert fused_mlp.launches == before


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never takes the plain version: one
    that is on no CUDA device either is refused before any build."""
    q = torch.empty(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_small(q, q, q)
    x = torch.empty(8, 64, device="meta")
    w1, w2 = torch.empty(64, 256), torch.empty(256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(x, w1, torch.empty(256), w2, torch.empty(64))
    assert _build._lib is None


def test_importing_kernels_needs_no_nvcc_and_no_gpu():
    code = ("import transformer_stm_tpu_torch.kernels.attention_small, "
            "transformer_stm_tpu_torch.kernels.fused_mlp\n"
            "from transformer_stm_tpu_torch.kernels import _build\n"
            "assert _build._lib is None\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_VISIBLE_DEVICES="", PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_are_plain_cuda():
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["flash_attention.cu",
                                      "flash_attention_bwd.cu",
                                      "fused_layer.cu", "fused_mlp.cu",
                                      "fused_mlp_train.cu",
                                      "vit_layer_sm90.cu"]
    for src in srcs:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text
        assert 'extern "C" int launch_' in text
        assert "cudaGetLastError()" in text


def test_build_commands_compile_each_source_for_sm90a(tmp_path):
    compiles, link = _build.commands("nvcc", _build.sources(), tmp_path)
    assert len(compiles) == 6
    for cmd in compiles + [link]:
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for cmd, src in zip(compiles, _build.sources()):
        assert "-c" in cmd and str(src) in cmd and "-fPIC" in cmd
    assert "-shared" in link
    assert link[link.index("-o") + 1] == str(tmp_path / _build.LIB_NAME)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_digest_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("int x;")
    d1 = _build._digest([a])
    a.write_text("int y;")
    assert _build._digest([a]) != d1


def test_ctypes_signatures_pass_pointers_as_void_p():
    import ctypes
    # the bf16 layer's host helpers take no stream: the weight maps'
    # buffer and four weights; three out-pointers of the kernel's info
    helpers = {"vit_layer_sm90_weight_maps": 5, "vit_layer_sm90_info": 3,
               "fused_mlp_info": 3, "fused_mlp_train_fwd_info": 3,
               "flash_attention_fwd_info": 3,
               "flash_attention_bwd_info": 3,
               "fused_mlp_train_bwd_info": 3,
               "fused_mlp_train_chunked_info": 3,
               "fused_layer_tf32x3_info": 4, "fused_layer_q8_info": 4}
    for name, n_ptr in helpers.items():
        argtypes = _build.SIGNATURES[name]
        assert argtypes.count(ctypes.c_void_p) == n_ptr
        assert ctypes.c_int in argtypes
    for name, argtypes in _build.SIGNATURES.items():
        if name in helpers:
            continue
        assert argtypes[-1] is ctypes.c_void_p  # the stream
        n_ptr = {"launch_flash_attention": 5,
                 "launch_flash_attention_bwd": 9,
                 "launch_fused_mlp": 6,
                 "launch_fused_mlp_train_fwd": 8,
                 "launch_fused_mlp_train_bwd": 10,
                 "launch_fused_mlp_train_fwd_chunked": 8,
                 "launch_fused_mlp_train_bwd_chunked": 9,
                 "launch_fused_layer": 19,
                 "launch_fused_layer_tf32x3": 15,
                 "launch_vit_layer_sm90": 16}[name]
        assert argtypes.count(ctypes.c_void_p) == n_ptr + 1
        if name == "launch_fused_layer":
            # mode, then x, y and the workspace; its bytes and the chunk
            # rows; then the 16 weight, scale and bias pointers; the rows,
            # t_pad, t_real, E, H, hidden, eps
            assert argtypes[1:4] == [ctypes.c_void_p] * 3
            assert argtypes[4:6] == [ctypes.c_longlong, ctypes.c_int]
            assert argtypes[6:22] == [ctypes.c_void_p] * 16
            assert argtypes[22:29] == [ctypes.c_longlong, *[ctypes.c_int] * 5,
                                       ctypes.c_float]
        elif name == "launch_fused_layer_tf32x3":
            # mode, then x, y and the workspace; its floats and the chunk
            # rows; then the 12 weight, bias and LN pointers
            assert argtypes[1:4] == [ctypes.c_void_p] * 3
            assert argtypes[6:18] == [ctypes.c_void_p] * 12
        elif name == "launch_vit_layer_sm90":
            # mode, then x, y and the workspace; its bytes and the slots;
            # the maps, the 8 LN and bias pointers and the 4 int8 scales
            assert argtypes[1:4] == [ctypes.c_void_p] * 3
            assert argtypes[6:19] == [ctypes.c_void_p] * 13
        else:
            assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
