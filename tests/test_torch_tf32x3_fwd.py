"""The data flow of the 3xTF32 attention forward kernel, emulated on the CPU.

``csrc/flash_attention.cu`` runs both attention forwards of the port,
``flash_attention`` and ``attention_small``.  The CUDA kernel runs only on
the card (``python3 chip_smoke.py``); here ``attention_fwd3`` emulates it
with torch in its own order, every f32 product as three TF32 products on
split operands (``mm3``), with inputs from numpy seeds: 64-key tiles (the
last one zero-filled and masked), s = q k^T, the online softmax in exp2
form with the running max in units of scale log2 e, p v in a fresh
accumulator folded into o with alpha, o / l and lse = m ln 2 + log l at the
end.  It is held, for o and lse, against float64 and against the JAX
forwards under the Pallas interpreter:

- S 4,096 at Dh 64, and at Dh 33 zero-padded to 40 with the scale of the
  true head dim (the wrapper's padding), within chip_smoke.py's FLASH_TOL of
  max |ref| (JAX ``flash_attention``'s forward);
- the 512px stage-3 shape at B 1 (T = S = 1,025, H 4: a ragged last tile),
  within ATTN_TOL elementwise (JAX ``attention_small``'s forward).

``flash_attention_plain`` on zero-padded inputs with the true scale equals
the unpadded result in the true columns.
"""

import importlib
import math
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small_plain)
from transformer_stm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, pad_head_dim, padded_head_dim)
from transformer_stm_tpu_torch.kernels.fused_mlp import tf32_split  # noqa: E402

jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")

ATTN_TOL = 1e-4   # chip_smoke.py: |err| <= ATTN_TOL + ATTN_TOL |ref|
FLASH_TOL = 1e-5  # chip_smoke.py: max |err| <= FLASH_TOL * max |ref|
TILE = 64         # keys of a tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernel reads the flag when it runs; another test module of
    the same worker may have imported it before the variable was set."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)


def mm3(a, b):
    """a @ b in emulated 3xTF32: the small terms, then the big product."""
    ab, as_ = tf32_split(a.contiguous())
    bb, bs = tf32_split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def attention_fwd3(q, k, v, scale=None):
    """The forward kernel's data flow on (B, T, H, Dh) q and (B, S, H, Dh)
    k, v -> o (B, T, H, Dh), lse (B, H, T)."""
    t, s, dh = q.shape[1], k.shape[1], q.shape[-1]
    sl = (1.0 / math.sqrt(dh) if scale is None else scale) * LOG2E
    pad = -s % TILE  # the last tile's keys past S: zero-filled, masked
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    kh, vh = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (kh, vh))
    b, h = qh.shape[:2]
    m = qh.new_full((b, h, t, 1), -math.inf)
    l = qh.new_zeros((b, h, t, 1))
    o = qh.new_zeros((b, h, t, dh))
    for s0 in range(0, s, TILE):
        x = mm3(qh, kh[:, :, s0:s0 + TILE].transpose(-1, -2)) * sl
        x[..., max(0, s - s0):] = -math.inf
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm3(p, vh[:, :, s0:s0 + TILE])  # a fresh product
        m = m_new
    lse = (m * LN2 + torch.log(l)).squeeze(-1)
    return (o / l).permute(0, 2, 1, 3), lse


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max() /
            ref.double().abs().max()).item()


def _close(got, ref, tol):
    return bool(((got.double() - ref.double()).abs()
                 <= tol + tol * ref.double().abs()).all())


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dh", [64, 33], ids=["Dh64", "Dh33_padded_to_40"])
def test_emulated_flash_forward_within_tolerance(dh):
    q, k, v = _inputs((1, 4096, 1, dh), seed=dh)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    dhp = padded_head_dim(dh)
    assert dhp == (64 if dh == 64 else 40)
    o, lse = attention_fwd3(*(pad_head_dim(x, dhp) for x in (tq, tk, tv)),
                            scale=1.0 / math.sqrt(dh))
    assert not o[..., dh:].any()
    o = o[..., :dh]
    o64, lse64 = flash_attention_plain(tq.double(), tk.double(), tv.double(),
                                       with_lse=True)
    o_jax, lse_jax = (torch.from_numpy(np.array(x)) for x in
                      jax_fa._flash_fwd_impl(*map(jnp.asarray, (q, k, v)),
                                             with_lse=True))
    for name, x, w64, wj in (("o", o, o64, o_jax), ("lse", lse, lse64,
                                                    lse_jax)):
        assert _rel(x, w64) <= FLASH_TOL, f"{name} against float64"
        assert _rel(x, wj) <= FLASH_TOL, f"{name} against JAX"


def test_emulated_attention_small_forward_ragged_tile_within_tolerance():
    """The 512px stage 3 at B 1: 1,025 keys, a last tile of one key."""
    shape = (1, 1025, 4, 64)
    q, k, v = _inputs(shape, seed=1025)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = attention_fwd3(tq, tk, tv)
    o64, lse64 = attention_small_plain(tq.double(), tk.double(), tv.double(),
                                       with_lse=True)
    o_jax, aux = jax_fa._small_fwd_impl(*map(jnp.asarray, (q, k, v)),
                                        with_lse=True)
    o_jax = torch.from_numpy(np.array(o_jax))
    # aux (B H, t_pad, 8): the lse in lane 0
    lse_jax = torch.from_numpy(np.array(aux))[:, :shape[1], 0].reshape(
        shape[0], shape[2], shape[1])
    for name, x, w64, wj in (("o", o, o64, o_jax), ("lse", lse, lse64,
                                                    lse_jax)):
        assert _close(x, w64, ATTN_TOL), f"{name} against float64"
        assert _close(x, wj, ATTN_TOL), f"{name} against JAX"


@pytest.mark.parametrize("dh", [33, 16])
def test_plain_forward_on_padded_inputs_equals_unpadded(dh):
    """The wrapper zero-pads q, k and v and keeps the scale of the true
    head dim: the padded problem's true columns are the unpadded result,
    its padded columns are zero, and the lse is the same."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 2, dh))
                                .astype(np.float64)) for n in (70, 130, 130))
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    dhp = padded_head_dim(dh)
    # plain scales by 1/sqrt(dhp): q carries sqrt(dhp / dh) to make it
    # 1/sqrt(dh), the scale the wrapper passes the kernel
    got, got_lse = flash_attention_plain(
        pad_head_dim(q * math.sqrt(dhp / dh), dhp), pad_head_dim(k, dhp),
        pad_head_dim(v, dhp), with_lse=True)
    torch.testing.assert_close(got[..., :dh], o, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_lse, lse, rtol=1e-12, atol=1e-12)
    assert not got[..., dh:].any()
