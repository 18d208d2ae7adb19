"""The port's flash attention and the 512px CvT on the CPU, against the JAX
package.

- ``flash_attention_plain`` (the forward kernel's arithmetic, keys in
  blocks) against the JAX ``flash_attention`` under the Pallas interpreter,
  output and lse, at odd (T, S, Dh), atol 1e-4;
- the ``FlashAttention`` autograd backward (its plain version on CPU
  tensors) against ``jax.vjp`` with ``TSTM_FLASH_BWD`` set to ``pallas``
  (the whole-side-resident pair) and to ``stream`` (the streaming pair that
  512px runs), atol 1e-4 of the largest gradient;
- ``torch.func.vmap`` and ``grad`` through ``FlashAttention`` equal to a
  loop, exactly;
- the router: flash at 16,384 keys, attention_small at 4,096, plain at 512;
- one 512px ``cvt_forward`` at batch 1 within 1e-3 of JAX (its XLA
  attention on the CPU holds the 1 GiB of stage-1 scores);
- gradients of a 64x64 ``cvt_forward`` with ``impl="flash"`` at every
  stage against JAX with ``impl="pallas"`` (interpret mode), the dead
  K-path bias leaves gated as in tests/test_torch_train_grads.py.

The CUDA kernels run only on the card, where ``python3 chip_smoke.py``
holds them against these plain versions.
"""

import importlib
import os

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from test_torch_train_grads import _dead, _narrow, _setup  # noqa: E402
from transformer_stm_tpu.config import \
    cvt_highres_spec as jax_highres  # noqa: E402
from transformer_stm_tpu.models.cvt import \
    cvt_forward as jax_cvt_forward  # noqa: E402
from transformer_stm_tpu.models.cvt import \
    init_cvt as jax_init_cvt  # noqa: E402
from transformer_stm_tpu.train.loop import \
    _masked_mse_mae as jax_masked_mse_mae  # noqa: E402
from transformer_stm_tpu_torch.config import (CvTSpec,  # noqa: E402
                                              cvt_highres_spec)
from transformer_stm_tpu_torch.kernels import _build  # noqa: E402
from transformer_stm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_plain)
from transformer_stm_tpu_torch.models.cvt import cvt_forward  # noqa: E402
from transformer_stm_tpu_torch.ops import attention as port_attention  # noqa: E402,E501
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    _flatten, from_jax_params)
from transformer_stm_tpu_torch.train.loop import _masked_mse_mae  # noqa: E402

jax_fa = importlib.import_module("transformer_stm_tpu.kernels.flash_attention")

ATOL = 1e-4
SHAPES = [(1, 70, 130, 2, 33), (2, 100, 257, 1, 16), (1, 40, 600, 2, 64)]
IDS = ["T70_S130_Dh33", "T100_S257_Dh16", "T40_S600_Dh64"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The JAX kernels read the flag when they run; another test module of
    the same worker may have imported them before the variable was set."""
    monkeypatch.setattr(jax_fa, "_INTERPRET", True)


def _inputs(shape, seed):
    b, t, s, h, dh = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, dh)).astype(np.float32)
            for n in (t, s, s, t)]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_plain_matches_pallas(shape):
    """Output and lse; S 600 spans two of the plain version's key blocks
    and two of the Pallas kernel's."""
    q, k, v, _ = _inputs(shape, seed=shape[2])
    want_o, want_lse = jax_fa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), with_lse=True)
    got_o, got_lse = flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), with_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        flash_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["pallas", "stream"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=IDS[:2])
def test_flash_backward_matches_jax_vjp(monkeypatch, mode, shape):
    """The JAX backward reads TSTM_FLASH_BWD when it runs: ``pallas`` is
    the resident pair (PERF.md row 7), ``stream`` the streaming pair that
    the 512px config takes (row 8)."""
    monkeypatch.setenv("TSTM_FLASH_BWD", mode)
    q, k, v, g = _inputs(shape, seed=7)
    _, vjp = jax.vjp(jax_fa.flash_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(flash_attention(*leaves), leaves,
                              torch.from_numpy(g))
    assert flash_attention_bwd.launches == before  # CPU: the plain version
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w,
                                   atol=ATOL * np.abs(w).max(), rtol=0,
                                   err_msg=f"d{name}")


def test_flash_backward_plain_equals_autograd_of_the_forward():
    """The plain backward from the plain forward's lse equals autograd
    through the plain forward, in float64, to rounding."""
    q, k, v, g = (torch.from_numpy(x).double()
                  for x in _inputs(SHAPES[2], seed=3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, block=128),
                               leaves, g)
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    got = flash_attention_bwd_plain(q, k, v, o, lse, g, block=256)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-12, rtol=1e-10)


def test_flash_attention_runs_under_torch_func_vmap_and_grad():
    """vmap over 3 slots, of the forward and of grad of a scalar loss,
    equals a loop over the slots exactly (the vmap rules fold the slot axis
    into the batch axis); an unmapped input is broadcast."""
    from torch.func import grad, vmap

    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(3, 2, 19, 2, 24, generator=gen) for _ in range(3))
    c = torch.randn(2, 19, 2, 24, generator=gen)
    out = vmap(flash_attention)(q, k, v)
    assert torch.equal(out, torch.stack([flash_attention(q[i], k[i], v[i])
                                         for i in range(3)]))

    def loss(a, b, d):
        return (flash_attention(a, b, d) * c).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    want = [grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
            for i in range(3)]
    for j in range(3):
        assert torch.equal(got[j], torch.stack([w[j] for w in want]))
    one = vmap(flash_attention, in_dims=(0, None, None))(q, k[0], v[0])
    assert torch.equal(one[2], flash_attention(q[2], k[0], v[0]))


def test_flash_records_no_graph_outside_autograd():
    q = torch.randn(1, 9, 1, 8, requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None
    o, lse = FlashAttention.apply(q, q, q)
    assert o.grad_fn is not None and not lse.requires_grad


def test_flash_wrappers_on_cpu_are_plain_and_raise_elsewhere():
    q, k, v, g = map(torch.from_numpy, _inputs(SHAPES[0], seed=1))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k,
                                                                       v))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    m = torch.empty(1, 8, 1, 300, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(m, m, m)
    assert _build._lib is None


def test_router_picks_flash_small_and_plain(monkeypatch):
    """As the JAX router on the TPU (tests/test_highres.py::
    test_attention_auto_gate): keys of 16,384 and more go to flash, other
    score matrices above 300,000 entries to attention_small, short ones to
    plain PyTorch; ``impl`` forces a path."""
    calls = []

    def fake(name):
        def f(q, k, v):
            calls.append(name)
            return torch.zeros_like(q)
        return f

    for name, attr in (("flash", "flash_attention"),
                       ("small", "attention_small"),
                       ("plain", "_attention_plain")):
        monkeypatch.setattr(port_attention, attr, fake(name))

    def route(t, s, **kw):
        calls.clear()
        q, kv = torch.empty(1, t, 1, 8), torch.empty(1, s, 1, 8)
        port_attention._attention_core(q, kv, kv, **kw)
        return calls[0]

    assert route(16384, 16384) == "flash"   # 512px stage 1
    assert route(4096, 4096) == "small"     # 512px stage 2
    assert route(1025, 1025) == "small"     # 512px stage 3
    assert route(512, 512) == "plain"       # 262k entries
    assert route(1024, 1024) == "small"     # 128px stage 1
    assert route(16, 16384) == "plain"      # few entries, short of 1 GiB
    for impl, want in (("flash", "flash"), ("pallas", "flash"),
                       ("small", "small"), ("plain", "plain")):
        assert route(16384, 16384, impl=impl) == want
    monkeypatch.setattr(port_attention, "FLASH_MIN_KEYS", 4096)
    assert route(4096, 4096) == "flash"
    with pytest.raises(ValueError, match="unknown attention impl"):
        route(8, 8, impl="xla")


def test_cvt_forward_512px_matches_jax():
    """The default CvT at 512x512, batch 1: stage 1 (16,384 tokens) goes
    through flash_attention's plain version and stages 2 and 3 through
    attention_small's, against the JAX model, whose CPU router runs XLA
    attention (the 1 GiB stage-1 score matrix).  atol 1e-3, the JAX
    package's bar against the Keras goldens."""
    spec = cvt_highres_spec(512)
    params, state = jax_init_cvt(jax.random.PRNGKey(1), jax_highres(512))
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 1, (1, 512, 512, 1)).astype(np.float32)
    proc = rng.standard_normal((1, 5)).astype(np.float32)
    want = np.asarray(jax_cvt_forward(params, state, jax_highres(512),
                                      images, proc)[0])
    np_params, np_state = (jax.tree_util.tree_map(np.asarray, t)
                           for t in (params, state))
    model = from_jax_params(np_params, np_state, spec, device="cpu")
    before = flash_attention.launches
    with torch.inference_mode():
        got = cvt_forward(model, *map(torch.from_numpy, (images, proc)))
    assert flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_cvt_gradients_through_flash_match_jax_pallas():
    """A train-mode 64x64 CvT (dw_bn, cls) with ``impl="flash"`` at every
    stage against JAX with ``impl="pallas"``, which runs its flash kernels
    under the interpreter: gradients within 1e-4 of the largest, the dead
    K-path leaves below 1e-6 of it in both, loss within 1e-4 relative."""
    jspec, params, state, batch = _setup("dw_bn", True, seed=9)
    images, proc, labels, mask = batch

    def loss_fn(p):
        out, _ = jax_cvt_forward(p, state, jspec, images, proc, train=True,
                                 impl="pallas")
        return jax_masked_mse_mae(out, labels, mask)[0]

    want_loss, want_g = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params))

    spec = _narrow(CvTSpec, "dw_bn", True)
    model = from_jax_params(params, jax.tree_util.tree_map(np.asarray, state),
                            spec, device="cpu")
    model.requires_grad_(True)
    out = cvt_forward(model, *map(torch.from_numpy, (images, proc)),
                      train=True, impl="flash")
    loss = _masked_mse_mae(out, *map(torch.from_numpy, (labels, mask)))[0]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=0,
                               rtol=1e-4)
    want = _flatten(jax.tree_util.tree_map(np.asarray, want_g))
    got = {n.replace(".", "/"): g.numpy()
           for (n, _), g in zip(model.named_parameters(), grads)}
    assert got.keys() == want.keys()
    gmax = max(np.abs(a).max() for a in want.values())
    n_dead = 0
    for path, w in want.items():
        if _dead(path, spec):
            n_dead += 1
            assert np.abs(w).max() < 1e-6 * gmax, path
            assert np.abs(got[path]).max() < 1e-6 * gmax, path
            continue
        np.testing.assert_allclose(got[path], w, atol=1e-4 * gmax, rtol=0,
                                   err_msg=path)
    assert n_dead == 2 * 3 + 2  # key biases; k_proj betas without cls
