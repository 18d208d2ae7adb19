"""The port's ViT classification fine-tune (train/vit_train.py) on the CPU
against the JAX package's, and the training MLP at the ViT widths.

- ``softmax_xent`` within 1e-6 of JAX's, with and without label smoothing;
- one AdamW step of a tiny ViT (image 32, patch 8, depth 2, E 64, 2 heads,
  dropout 0) from carried JAX weights on a batch with a masked row: in
  float32 the loss and every updated parameter within 1e-5 of JAX's
  ``make_vit_train_step``; in bfloat16 the logits within 5e-2 x max(1,
  |logits|) and the loss within 1e-2 relative; ``impl="pallas"`` (the
  flash and fused training MLP plain versions here) within 1e-5 of
  ``"auto"``;
- ``ViTTrainer.fit`` as JAX's tests/test_vit.py:118-145 (validation
  records, checkpoint, resume), and a trainer checkpoint that resumes
  across packages both ways; the toy quadrant task learns to accuracy
  above 0.9;
- ``fused_mlp_train_plain`` and its backward at D 192, 384 and 768 against
  JAX ``make_fused_mlp_train(0.0, interpret=True)`` and its vjp within 1e-5
  of the largest entry, bfloat16 x giving the JAX dtypes, the keep share
  at rate 0.1; the CUDA sources' widened training widths and backward
  instantiations.
"""

import dataclasses
import os
import re
from pathlib import Path

os.environ["TSTM_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from transformer_stm_tpu import config as jc  # noqa: E402
from transformer_stm_tpu.kernels.fused_mlp import make_fused_mlp_train  # noqa: E402
from transformer_stm_tpu.models.vit import init_vit as jax_init_vit  # noqa: E402
from transformer_stm_tpu.models.vit import vit_forward as jax_vit_forward  # noqa: E402
from transformer_stm_tpu.train import vit_train as jvt  # noqa: E402
from transformer_stm_tpu.train.optimizer import adam_init as jax_adam_init  # noqa: E402
from transformer_stm_tpu_torch import config as pc  # noqa: E402
from transformer_stm_tpu_torch.kernels import fused_mlp as pm  # noqa: E402
from transformer_stm_tpu_torch.models.vit import vit_forward  # noqa: E402
from transformer_stm_tpu_torch.train import vit_train as pvt  # noqa: E402
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    _flatten, vit_from_jax_params, vit_to_jax_params)
from transformer_stm_tpu_torch.train.optimizer import adam_init  # noqa: E402

CSRC = Path(pm.__file__).resolve().parents[1] / "csrc"
STEP_TOL = 1e-5
BF16_LOGIT_TOL = 5e-2
BF16_LOSS_REL = 1e-2
MLP_TOL = 1e-5


def specs(**kw):
    fields = dict(image_size=32, patch_size=8, depth=2, embed_dim=64,
                  num_heads=2, num_channels=1, num_classes=4,
                  dropout_rate=0.0)
    fields.update(kw)
    return jc.ViTSpec(**fields), pc.ViTSpec(**fields)


def cfgs(**kw):
    fields = dict(batch_size=6, learning_rate=1e-4, optimizer="adamw",
                  weight_decay=0.05, label_smoothing=0.1,
                  loss="softmax_xent")
    fields.update(kw)
    return jc.TrainConfig(**fields), pc.TrainConfig(**fields)


def batch(n=6, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, 32, 32, 1)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int64)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return images, labels, mask


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_xent_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((16, 5))).astype(np.float32)
    labels = rng.integers(0, 5, 16)
    want = np.asarray(jvt.softmax_xent(jnp.asarray(logits),
                                       jnp.asarray(labels), 5, smoothing))
    got = pvt.softmax_xent(torch.from_numpy(logits),
                           torch.from_numpy(labels), 5, smoothing).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _carried():
    """(JAX specs, the tiny ViT's JAX params, a port model from them)."""
    jspec, pspec = specs()
    params = jax_init_vit(jax.random.PRNGKey(3), jspec)
    model = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                pspec, device="cpu")
    return jspec, pspec, params, model


def _port_step(dtype, impl="auto"):
    """(port model after one step from the carried weights, its loss, its
    AdamState)."""
    _, pspec, _, model = _carried()
    images, labels, mask = batch()
    opt = adam_init(model)
    m = pvt.make_vit_train_step(pspec, cfgs(compute_dtype=dtype)[1],
                                impl=impl)(
        model, opt, (torch.from_numpy(images), torch.from_numpy(labels),
                     torch.from_numpy(mask)), None, 1e-4)
    return model, float(m["loss"]), opt


def _one_step(dtype):
    """(JAX params after one step, JAX loss, port model after it, port
    loss, port AdamState) from the same carried weights and batch."""
    jspec, _, params, _ = _carried()
    images, labels, mask = batch()
    jstep = jvt.make_vit_train_step(jspec, cfgs(compute_dtype=dtype)[0],
                                    impl="xla")
    jparams, _, jm = jstep(params, jax_adam_init(params),
                           (jnp.asarray(images), jnp.asarray(labels),
                            jnp.asarray(mask)), jax.random.PRNGKey(0),
                           jnp.float32(1e-4))
    return (jparams, float(jm["loss"]), *_port_step(dtype))


def test_one_step_float32_matches_jax():
    """The key projection's bias has a gradient of exactly 0 (the softmax
    does not see a constant added to a query's scores), so float noise
    alone drives its first AdamW step, in either package: it is held to
    moving less than half of lr (5e-5) from where both started instead."""
    jparams, jloss, model, loss, opt = _one_step("float32")
    assert abs(loss - jloss) <= STEP_TOL * max(1.0, abs(jloss))
    want = _flatten(jax.tree_util.tree_map(np.asarray, jparams))
    got = _flatten(vit_to_jax_params(model))
    start = _flatten(jax.tree_util.tree_map(
        np.asarray, jax_init_vit(jax.random.PRNGKey(3), specs()[0])))
    assert set(got) == set(want) and opt.step == 1
    dead = [k for k in want if k.endswith("attn/key/bias")]
    assert len(dead) == 2
    for k in dead:
        for side in (got, want):
            assert np.abs(side.pop(k) - start[k]).max() < 5e-5
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    print(f"one float32 step: loss {loss:.6f} vs {jloss:.6f}, max |param "
          f"diff| {worst:.2e}")
    assert worst <= STEP_TOL


def test_one_step_bfloat16_matches_jax():
    jspec, _, params, model = _carried()
    images, _, _ = batch()
    want = np.asarray(jax_vit_forward(
        params, jspec, jnp.asarray(images).astype(jnp.bfloat16), train=True,
        rng=jax.random.PRNGKey(0), impl="xla")).astype(np.float32)
    got = vit_forward(model, torch.from_numpy(images).bfloat16(),
                      train=True).float().detach().numpy()
    assert np.abs(got - want).max() <= BF16_LOGIT_TOL * max(
        1.0, np.abs(want).max())
    _, jloss, _, loss, _ = _one_step("bfloat16")
    print(f"one bfloat16 step: loss {loss:.5f} vs JAX {jloss:.5f}")
    assert abs(loss - jloss) <= BF16_LOSS_REL * abs(jloss)


def test_pallas_route_matches_auto_on_the_cpu():
    auto, auto_loss, _ = _port_step("float32", impl="auto")
    pallas, pallas_loss, _ = _port_step("float32", impl="pallas")
    assert abs(auto_loss - pallas_loss) <= STEP_TOL
    a, b = _flatten(vit_to_jax_params(auto)), _flatten(
        vit_to_jax_params(pallas))
    live = [k for k in a if not k.endswith("attn/key/bias")]  # as above
    assert max(np.abs(a[k] - b[k]).max() for k in live) <= STEP_TOL


@pytest.mark.parametrize("impl, fused", [
    ("auto", True), ("pallas", True), ("flash", True), ("plain", False),
    ("small", False)])
def test_evaluation_mlp_routes_as_jax(impl, fused, monkeypatch):
    """In evaluation the MLP of "auto", "pallas" and "flash" goes through
    fused_mlp (the kernel's wrapper; its plain version on the CPU), as
    JAX's mlp routes "pallas" and "flash" (ops/blocks.py:67-70), a layer
    each; "plain" and "small" take the plain MLP.  The logits agree with
    "plain" within 1e-5."""
    from transformer_stm_tpu_torch.ops import blocks

    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return pm.fused_mlp(*args)

    monkeypatch.setattr(blocks, "fused_mlp", counted)
    _, pspec, _, model = _carried()
    x = torch.from_numpy(batch()[0])
    with torch.no_grad():
        got = vit_forward(model, x, impl=impl)
        assert len(calls) == (pspec.depth if fused else 0)
        want = vit_forward(model, x, impl="plain")
    assert (got - want).abs().max() <= 1e-5


def test_vit_fit_orchestration(tmp_path):
    """As tests/test_vit.py:118-145: held-out split, per-epoch validation
    records, checkpoint and resume; the records sheet."""
    spec = pc.ViTSpec(image_size=32, patch_size=8, depth=1, embed_dim=16,
                      num_heads=2, num_classes=3)
    cfg = pc.TrainConfig(batch_size=8, seed=0)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (40, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    ckdir = str(tmp_path / "ck")
    t1 = pvt.ViTTrainer(spec, cfg, device="cpu")
    t1.fit(images, labels, epochs=2, val_split=0.25, checkpoint_dir=ckdir,
           checkpoint_every=1, verbose=False)
    assert t1.epoch == 2 and len(os.listdir(ckdir)) == 4
    assert all(r[3] is not None and r[4] is not None for r in t1.records)
    t2 = pvt.ViTTrainer(spec, cfg, device="cpu")
    t2.fit(images, labels, epochs=3, val_split=0.25, checkpoint_dir=ckdir,
           verbose=False)
    assert t2.epoch == 3 and len(t2.records) == 3
    assert t2.records[:2] == t1.records
    t1.write_records(str(tmp_path / "rec.xlsx"))
    from transformer_stm_tpu_torch.data.xlsx import read_xlsx
    rows = read_xlsx(str(tmp_path / "rec.xlsx"))["Sheet1"]
    assert rows[0] == pvt.RECORD_COLUMNS and len(rows) == 3


def _tiny_data():
    rng = np.random.default_rng(2)
    return (rng.uniform(0, 1, (20, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 4, 20))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jspec, pspec = specs(depth=1, embed_dim=32)
    jcfg, pcfg = cfgs(batch_size=8)
    images, labels = _tiny_data()
    jt = jvt.ViTTrainer(jspec, jcfg, impl="xla")
    jt.fit(images, labels, epochs=1, checkpoint_dir=str(tmp_path),
           verbose=False)
    pt = pvt.ViTTrainer(pspec, pcfg, device="cpu")
    assert pt.load(str(tmp_path))
    assert pt.epoch == 1 and pt.opt.step == 3 and pt.records == jt.records
    np.testing.assert_allclose(pt.predict(images), jt.predict(images),
                               atol=1e-4, rtol=0)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jt.opt.mu))
    for k, v in want.items():
        np.testing.assert_array_equal(pt.opt.mu[k.replace("/", ".")].numpy(),
                                      v)
    pt.fit(images, labels, epochs=2, checkpoint_dir=str(tmp_path),
           verbose=False)
    assert pt.epoch == 2 and len(pt.records) == 2


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jspec, pspec = specs(depth=1, embed_dim=32)
    jcfg, pcfg = cfgs(batch_size=8)
    images, labels = _tiny_data()
    pt = pvt.ViTTrainer(pspec, pcfg, device="cpu")
    pt.fit(images, labels, epochs=1, val_split=0.2,
           checkpoint_dir=str(tmp_path), verbose=False)
    jt = jvt.ViTTrainer(jspec, jcfg, impl="xla")
    assert jt.load(str(tmp_path))
    assert jt.epoch == 1 and int(jt.opt.step) == pt.opt.step
    assert jt.records == pt.records
    np.testing.assert_allclose(jt.predict(images), pt.predict(images),
                               atol=1e-4, rtol=0)
    jt.train_epoch(images, labels)
    assert jt.epoch == 2


def test_toy_quadrant_task_learns():
    """tests/test_vit.py:55-66: four classes by the bright quadrant."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 96)
    images = rng.uniform(0, 0.2, (96, 32, 32, 1)).astype(np.float32)
    for i, c in enumerate(labels):
        y0, x0 = (c // 2) * 16, (c % 2) * 16
        images[i, y0:y0 + 16, x0:x0 + 16, 0] += 0.7
    spec = pc.ViTSpec(patch_size=8, embed_dim=32, depth=2, num_heads=2,
                      image_size=32, num_channels=1, num_classes=4,
                      dropout_rate=0.1)
    cfg = pc.TrainConfig(epochs=35, batch_size=32, learning_rate=3e-3,
                         optimizer="adamw", weight_decay=1e-4,
                         label_smoothing=0.1, loss="softmax_xent", seed=0)
    tr = pvt.ViTTrainer(spec, cfg, device="cpu")
    accs = [tr.train_epoch(images, labels)["acc"] for _ in range(35)]
    assert accs[-1] > 0.9, accs
    assert (tr.predict(images[:40]).argmax(-1) == labels[:40]).mean() > 0.9


# ---------------------------------------------------------------------------
# The training MLP at the ViT widths
# ---------------------------------------------------------------------------

def _mlp_inputs(d, n=37, seed=0):
    rng = np.random.default_rng(seed + d)
    hd = 4 * d
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((d, hd)) / d ** 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(hd)).astype(np.float32),
            (rng.standard_normal((hd, d)) / hd ** 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("d", pm.VIT_WIDTHS)
def test_train_mlp_plain_matches_jax_at_vit_widths(d):
    x, w1, b1, w2, b2, dy = _mlp_inputs(d)
    seed = np.zeros(2, np.int32)
    f = make_fused_mlp_train(0.0, interpret=True)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)] + \
        [jnp.asarray(seed)]
    y, vjp = jax.vjp(lambda *a: f(*a, jargs[-1]), *jargs[:5])
    want = (y, *vjp(jnp.asarray(dy)))
    targs = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)] + \
        [torch.from_numpy(seed)]
    got = (pm.fused_mlp_train_plain(*targs, 0.0),
           *pm.fused_mlp_train_bwd_plain(*targs, 0.0, torch.from_numpy(dy)))
    for name, g, w in zip(("y", "dx", "dW1", "db1", "dW2", "db2"), got,
                          want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= MLP_TOL * np.abs(w).max(), \
            name


@pytest.mark.parametrize("d", pm.VIT_WIDTHS)
def test_train_mlp_bfloat16_dtypes_and_keep_share(d):
    """bfloat16 x: y and dx in bfloat16, the weight and bias gradients in
    float32, as JAX's custom_vjp returns them; the autograd Function on
    the CPU agrees; m1 keeps 0.9 of the units at rate 0.1."""
    x, w1, b1, w2, b2, dy = (torch.from_numpy(a) for a in _mlp_inputs(d))
    seed = torch.tensor([11, 12], dtype=torch.int32)
    f = make_fused_mlp_train(0.0, interpret=True)
    jx = jnp.asarray(x.numpy()).astype(jnp.bfloat16)
    y, vjp = jax.vjp(lambda a, *w: f(a, *w, jnp.zeros(2, jnp.int32)), jx,
                     *(jnp.asarray(t.numpy()) for t in (w1, b1, w2, b2)))
    jdtypes = [str(t.dtype) for t in (y, *vjp(y))]
    xb = x.bfloat16().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    out = pm.fused_mlp_train(xb, *leaves, seed, 0.1)
    out.backward(dy.bfloat16())
    dtypes = [str(t.dtype).replace("torch.", "")
              for t in (out, xb.grad, *(t.grad for t in leaves))]
    assert dtypes == jdtypes == ["bfloat16", "bfloat16"] + ["float32"] * 4
    want = pm.fused_mlp_train_plain(x, w1, b1, w2, b2, seed, 0.1)
    assert (out.float() - want).abs().max() <= 2e-2 * want.abs().max()
    share = (pm.dropout_mask(seed, 512, 4 * d, pm.STREAM_HIDDEN, 0.1) > 0
             ).double().mean().item()
    assert abs(share - 0.9) < 0.01


def test_cuda_sources_build_the_training_mlp_at_the_vit_widths():
    fwd = (CSRC / "fused_mlp.cu").read_text()
    widths = re.search(r"bool width_ok\(int D\) \{\s*return ([^;]*);", fwd)
    assert widths and all(f"D == {d}" in widths[1]
                          for d in pm.WIDTHS + pm.VIT_WIDTHS)
    assert re.search(r"case 768|default: return \(const void\*\)"
                     r"fused_mlp_tf32x3<192, false, DROP>", fwd)
    bwd = (CSRC / "fused_mlp_train.cu").read_text()
    for d in pm.WIDTHS + pm.VIT_WIDTHS:
        assert f"case {d}: return kernel_of_d<{d}>(kind);" in bwd or \
            f"default: return kernel_of_d<{d}>(kind);" in bwd
        assert f"bwd::launch_bwd<{d}>(P, x, dy, pack, stream)" in bwd
    assert "dx_kind(int D) { return D >= 384 ? DXW" in bwd
    assert "dw_kind(int D) { return D >= 384 ? DWW" in bwd


@pytest.mark.parametrize("d", pm.VIT_WIDTHS)
def test_train_mlp_backward_scratch_at_vit_widths(d):
    """The backward's scratch at a ViT model's B 64 (N 12,608): under 64
    MiB at D 192 and 384; at D 768 the design's own count, (6 + 2 slots) D
    Hd + slots (Hd + D) floats with 2 row slots (96 weight blocks for 132
    SMs), 94.4 MB, under chip_smoke.py's 96 MiB."""
    n, hd = 64 * 197, 4 * d
    sizes = pm.train_bwd_scratch(n, d, hd, sms=132)
    slots = pm.train_bwd_slots(n, hd, sms=132)
    assert sizes == [6 * d * hd, slots * (2 * d * hd + hd + d)]
    if d < 768:
        assert 4 * sum(sizes) <= 64 * 2 ** 20
    else:
        assert slots == 2 and slots * hd // pm.TRAIN_BWD_TILE == 96
        assert 4 * sum(sizes) == 94_402_560 <= 96 * 2 ** 20
