"""The port's fused ViT-layer kernels on the CPU, against the JAX package.

Each kernel's plain version (what the wrapper runs on CPU tensors) is held
against the JAX Pallas kernel under the interpreter, on the same numpy
weights and folded token rows:

- ``vit_layer_infer``, ``attn_layer_infer`` and ``ln_mlp_infer`` in float32
  within 1e-4 (the JAX package's own bar, tests/test_fused_layer.py:26-27)
  and in bfloat16, compared in float32, within 5e-2 (the measured error is
  printed);
- ``vit_layer_infer_int8`` within 1e-2 of the output scale against JAX's
  int8 kernel, and within JAX's int8 contract (3% of the scale, correlation
  above 0.999, tests/test_fused_layer.py:66-81) against JAX's float layer;
- at ViT-S width (E 384, H 6) with 197 tokens padded to 200, at ViT-Ti
  width (E 192, H 3), and at B 3 with 17 tokens padded to 24;
- ``quant_rows``, ``quant_cols`` and ``gelu_exact`` against the JAX
  helpers; ``attention_small`` in bfloat16 against the JAX kernel;
- ``fused_layer_fits`` and ``FusedLayerSharedMemoryError`` at the limits
  the CUDA design states (the bf16 layer's, which the bf16 int8 layer
  shares, the int8 layer's on f32 x, and none for the f32 layer), and the
  wrappers raising, never falling back, for tensors that are not on the
  CPU, and while autograd records.

The CUDA kernels run only on the card, where ``python3 chip_smoke.py``
(phase 7) holds them against these plain versions.
"""

import importlib
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"  # before the kernels import

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu_torch.kernels import fused_layer  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import \
    attention_small  # noqa: E402
from transformer_stm_tpu_torch.kernels.fused_layer import (  # noqa: E402
    FusedLayerSharedMemoryError, attn_layer_infer, fused_layer_fits,
    gelu_exact, ln_mlp_infer, quant_cols, quant_rows, vit_layer_infer,
    vit_layer_infer_int8)
from transformer_stm_tpu_torch.ops.attention import MHA  # noqa: E402
from transformer_stm_tpu_torch.ops.blocks import MLP  # noqa: E402
from transformer_stm_tpu_torch.ops.common import LayerNorm  # noqa: E402

jax_fl = importlib.import_module("transformer_stm_tpu.kernels.fused_layer")
jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")
jax_mlp = importlib.import_module("transformer_stm_tpu.kernels.fused_mlp")

F32_ATOL, BF16_ATOL = 1e-4, 5e-2
INT8_TOL = 1e-2                       # of the output scale, vs JAX int8
INT8_REL, INT8_CORR = 0.03, 0.999     # vs float (JAX's contract)
# (E, H, B, t_real, t_pad)
SHAPES = [(384, 6, 2, 197, 200), (192, 3, 2, 197, 200), (384, 6, 3, 17, 24)]
IDS = ["vit_s", "vit_ti", "vit_s_B3_T17"]
DTYPES = [(torch.float32, jnp.float32, F32_ATOL),
          (torch.bfloat16, jnp.bfloat16, BF16_ATOL)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels read the flag when they run; another test module of
    the same worker may have imported them before the variable was set."""
    monkeypatch.setattr(jax_fl, "_INTERPRET", True)
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)
    monkeypatch.setattr(jax_mlp, "_INTERPRET", True)


def layer_params(e, h, seed):
    """One ViT layer's JAX parameter dicts, numpy float32, every parameter
    random (LN affine and biases too)."""
    rng = np.random.default_rng(seed)
    hidden, dh = 4 * e, e // h

    def f(*shape, scale=1.0, base=0.0):
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    def ln():
        return {"gamma": f(e, scale=0.1, base=1.0), "beta": f(e, scale=0.1)}

    def proj(shape, bias, fan):
        return {"kernel": f(*shape, scale=fan ** -0.5),
                "bias": f(*bias, scale=0.1)}

    return {
        "norm1": ln(), "norm2": ln(),
        "attn": {k: proj((e, h, dh), (h, dh), e)
                 for k in ("query", "key", "value")}
        | {"out": proj((h, dh, e), (e,), h * dh)},
        "mlp": {"fc1": proj((e, hidden), (hidden,), e),
                "fc2": proj((hidden, e), (e,), hidden)},
    }


def port_modules(p, dtype):
    """(LayerNorm, MHA, LayerNorm, MLP) holding ``layer_params``' values."""
    e, h, _ = p["attn"]["query"]["kernel"].shape
    mods = {"norm1": LayerNorm(e), "attn": MHA(e, h), "norm2": LayerNorm(e),
            "mlp": MLP(e, p["mlp"]["fc1"]["kernel"].shape[1])}
    with torch.no_grad():
        for key, m in mods.items():
            for name, t in m.named_parameters():
                leaf = p[key]
                for part in name.split("."):
                    leaf = leaf[part]
                t.copy_(torch.from_numpy(leaf))
    return [mods[k].to(dtype) for k in ("norm1", "attn", "norm2", "mlp")]


def folded_rows(e, b, t, tp, seed):
    """(B * t_pad, E) float32 tokens, the padded rows zero."""
    x = np.random.default_rng(seed).standard_normal((b, tp, e))
    x[:, t:] = 0.0
    return x.reshape(b * tp, e).astype(np.float32)


def run_both(kernel, shape, tdt, jdt, seed=0):
    """(port output, JAX output), both as float32 numpy."""
    e, h, b, t, tp = shape
    p = layer_params(e, h, seed)
    x = folded_rows(e, b, t, tp, seed + 1)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), p)
    n1, attn, n2, mlp = port_modules(p, tdt)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    layer = dict(t_pad=tp, t_real=t)
    if kernel == "vit_layer_infer":
        got = vit_layer_infer(xt, n1, attn, n2, mlp, **layer)
        want = jax_fl.vit_layer_infer(xj, jp["norm1"], jp["attn"],
                                      jp["norm2"], jp["mlp"], **layer)
    elif kernel == "attn_layer_infer":
        got = attn_layer_infer(xt, n1, attn, **layer)
        want = jax_fl.attn_layer_infer(xj, jp["norm1"], jp["attn"], **layer)
    elif kernel == "ln_mlp_infer":
        got = ln_mlp_infer(xt, n2, mlp)
        want = jax_fl.ln_mlp_infer(xj, jp["norm2"], jp["mlp"])
    else:
        got = vit_layer_infer_int8(xt, n1, attn, n2, mlp, **layer)
        want = jax_fl.vit_layer_infer_int8(xj, jp["norm1"], jp["attn"],
                                           jp["norm2"], jp["mlp"], **layer)
    assert got.dtype == tdt and got.shape == xt.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("kernel", ["vit_layer_infer", "attn_layer_infer",
                                    "ln_mlp_infer"])
def test_plain_matches_pallas(kernel, shape, dtype):
    tdt, jdt, atol = dtype
    got, want = run_both(kernel, shape, tdt, jdt)
    err = np.abs(got - want).max()
    print(f"{kernel} {shape} {tdt}: max |port - JAX| {err:.3e} "
          f"(max |y| {np.abs(want).max():.2f})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_int8_plain_matches_pallas_and_float(shape, dtype):
    """Against JAX's int8 kernel within 1e-2 of the scale (a row's
    quantisation step can flip where the f32 sums round differently), and
    against JAX's float layer within the int8 contract."""
    tdt, jdt, _ = dtype
    got, want = run_both("vit_layer_infer_int8", shape, tdt, jdt)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"int8 {shape} {tdt}: max |port - JAX| {err:.3e} of scale "
          f"{scale:.2f}")
    assert np.isfinite(got).all()
    assert err <= INT8_TOL * scale
    _, ref = run_both("vit_layer_infer", shape, tdt, jdt)
    assert np.abs(got - ref).max() / np.abs(ref).max() < INT8_REL
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > INT8_CORR


def test_quantisation_and_gelu_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column keeps a finite scale
    x = rng.standard_normal((24, 64)).astype(np.float32) * 3.0
    x[5] = 0.0     # as the folded layout's padded rows are
    for port, jax_fn, a in ((quant_cols, jax_fl._quant_cols, w),
                            (quant_rows, jax_fl._quant_rows, x)):
        q, s = port(torch.from_numpy(a))
        jq, js = jax_fn(jnp.asarray(a))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().reshape(np.shape(js)),
                                      np.asarray(js))
    v = np.linspace(-6.0, 6.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(gelu_exact(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_mlp._gelu_exact(v)), atol=1e-6,
                               rtol=0)


def test_attention_small_takes_bf16():
    """bf16 q, k, v run the f32 kernel and come back in bf16; the JAX kernel
    rounds p to bf16 before p v, the port does not: within 1e-2 of the
    output scale (about one bf16 ulp), compared in f32."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 197, 6, 64)).astype(np.float32)
               for _ in range(3))
    got = attention_small(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v)))
    want = jax_fa.attention_small(*(jnp.asarray(a).astype(jnp.bfloat16)
                                    for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    print(f"attention_small bf16: max |port - JAX| {err:.3e}")
    assert err <= 1e-2 * np.abs(want).max()


def test_fits_at_the_cuda_limits():
    """In f32 (itemsize 4) the attention is the flash forward
    (csrc/flash_attention.cu), whose 198,656 bytes do not depend on t_pad:
    every t_pad fits, for the int8 layer on f32 x too (csrc/fused_layer.cu,
    mode 7, whose attention is that forward; it stopped at 344 while it
    held K and V of a head in one block).  The bf16 layer
    (csrc/vit_layer_sm90.cu), which also runs the bf16 int8 layer, holds Q,
    K and V of a head in 64-row tiles beside its product ring: 576 fits and
    584 does not (the int8 layer's limit was 464 while it ran in
    csrc/fused_layer.cu).  Dh must be 64 and the widths multiples of 64."""
    limit = fused_layer.SMEM_LIMIT
    for t_pad in (24, 200, 344, 352, 1032, 4096):
        assert fused_layer.attention_smem_bytes(t_pad, 4) == 198_656
    for t_pad in (344, 352, 1032):
        assert fused_layer_fits(t_pad, 384, 6, 64, 1536, 4, int8=True)
    assert fused_layer.attention_smem_bytes(576, 2) <= limit
    assert fused_layer.attention_smem_bytes(584, 2) > limit
    assert fused_layer_fits(576, 384, 6, 64, 1536, 2, int8=True)
    assert not fused_layer_fits(584, 384, 6, 64, 1536, 2, int8=True)
    assert fused_layer_fits(200, 384, 6, 64, 1536, 2)
    assert fused_layer_fits(200, 768, 12, 64, 3072, 4)
    assert fused_layer_fits(344, 192, 3, 64, 768, 4)
    assert fused_layer_fits(344, 192, 3, 64, 768, 4, int8=True)
    assert fused_layer_fits(352, 384, 6, 64, 1536, 4)
    assert fused_layer_fits(1032, 384, 6, 64, 1536, 4)
    assert fused_layer_fits(464, 384, 6, 64, 1536, 2)
    assert fused_layer_fits(472, 384, 6, 64, 1536, 2)
    assert fused_layer_fits(576, 384, 6, 64, 1536, 2)
    assert fused_layer_fits(24, 384, 6, 64, 1536, 2)
    assert fused_layer_fits(352, 384, 6, 64, 1536, 4, int8=True)
    assert not fused_layer_fits(200, 384, 12, 32, 1536, 4)
    assert not fused_layer_fits(197, 384, 6, 64, 1536, 4)
    assert not fused_layer_fits(584, 384, 6, 64, 1536, 2)
    assert not fused_layer_fits(1032, 384, 6, 64, 1536, 2)
    assert not fused_layer_fits(200, 384, 12, 32, 1536, 2)
    assert not fused_layer_fits(200, 400, 6, 64, 1600, 2)
    assert not fused_layer_fits(197, 384, 6, 64, 1536, 2)


def _meta_layer(e=384, h=6):
    p = layer_params(e, h, 0)
    return port_modules(p, torch.bfloat16)


def test_refusal_error_and_no_fallback_off_the_cpu():
    """Tensors that do not lie on the CPU never take the plain version: past
    the shared-memory limit the wrapper raises FusedLayerSharedMemoryError,
    and where the shapes fit, a tensor that is not on a CUDA device raises
    ValueError (a meta tensor stands in for the card here).  The f32 layer
    and the int8 layer on f32 x fit at any t_pad (their attention is the
    flash forward)."""
    n1, attn, n2, mlp = _meta_layer()
    # past the bf16 kernel's limit, 584 (the int8 layer too)
    for t_pad, dtype, int8 in ((584, torch.bfloat16, False),
                               (584, torch.bfloat16, True)):
        big = torch.empty(t_pad, 384, dtype=dtype, device="meta")
        if int8:
            with pytest.raises(FusedLayerSharedMemoryError):
                vit_layer_infer_int8(big, n1, attn, n2, mlp, t_pad=t_pad,
                                     t_real=t_pad - 2)
            continue
        with pytest.raises(FusedLayerSharedMemoryError):
            vit_layer_infer(big, n1, attn, n2, mlp, t_pad=t_pad,
                            t_real=t_pad - 2)
        with pytest.raises(FusedLayerSharedMemoryError):
            attn_layer_infer(big, n1, attn, t_pad=t_pad, t_real=t_pad - 2)
    # f32 at t_pad 352 and 1032, the int8 layer too: refused only for lying
    # off the card
    f32 = [m.float() for m in (n1, attn, n2, mlp)]
    for t_pad in (352, 1032):
        big = torch.empty(t_pad, 384, device="meta")
        for call in (lambda: vit_layer_infer(big, *f32, t_pad=t_pad,
                                             t_real=t_pad - 2),
                     lambda: vit_layer_infer_int8(big, *f32, t_pad=t_pad,
                                                  t_real=t_pad - 2),
                     lambda: attn_layer_infer(big, *f32[:2], t_pad=t_pad,
                                              t_real=t_pad - 2)):
            with pytest.raises(ValueError, match="CUDA device"):
                call()
    ok = torch.empty(400, 384, dtype=torch.bfloat16, device="meta")
    for call in (lambda: vit_layer_infer(ok, n1, attn, n2, mlp, t_pad=200,
                                         t_real=197),
                 lambda: vit_layer_infer_int8(ok, n1, attn, n2, mlp,
                                              t_pad=200, t_real=197),
                 lambda: attn_layer_infer(ok, n1, attn, t_pad=200,
                                          t_real=197),
                 lambda: ln_mlp_infer(ok, n2, mlp)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match="whole images"):
        vit_layer_infer(ok, n1, attn, n2, mlp, t_pad=24, t_real=17)
    # t_pad 472 and 576 fit the bf16 layer, the int8 layer too: refused
    # only for lying off the card
    for t_pad in (472, 576):
        fits = torch.empty(t_pad, 384, dtype=torch.bfloat16, device="meta")
        for layer in (vit_layer_infer, vit_layer_infer_int8):
            with pytest.raises(ValueError, match="CUDA device"):
                layer(fits, n1, attn, n2, mlp, t_pad=t_pad,
                      t_real=t_pad - 2)


def test_wrappers_raise_while_autograd_records():
    n1, attn, n2, mlp = [m.float() for m in _meta_layer()]
    x = torch.zeros(200, 384, requires_grad=True)
    for call in (lambda: vit_layer_infer(x, n1, attn, n2, mlp, t_pad=200,
                                         t_real=197),
                 lambda: attn_layer_infer(x, n1, attn, t_pad=200, t_real=197),
                 lambda: ln_mlp_infer(x, n2, mlp)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    with torch.no_grad():
        assert ln_mlp_infer(x, n2, mlp).shape == x.shape
