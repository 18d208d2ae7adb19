"""Drives the PyTorch/CUDA port on one NVIDIA H100 and checks it.

    python3 chip_smoke.py

Phases, each printed as it finishes:

0. watchdog and environment: true f32 on the card, versions, the card's
   name and power limit;
1. build: the CUDA kernels of ``transformer_stm_tpu_torch/csrc`` with nvcc;
2. kernels: each kernel against its plain PyTorch version at the CvT stage
   shapes (in float32, and in float64 as a check that shares no rounding),
   with its time, the plain version's time and one PyTorch call's time as
   a yardstick (CUDA events, median of 10 runs after a warm-up): the
   attention_small forward with and without lse, its backward
   (attention_small_bwd, against the plain backward and f64 autograd; SDPA's
   backward as the yardstick) and fused_mlp;
3. evaluation path: the full-width dw_bn/cls CvT (random weights from a
   seed, round-tripped through the JAX checkpoint layout) evaluates 512
   synthetic 128x128 images with process parameters through
   ``TrainLoop.predict`` in 4 batches of 128; the kernels' launch counts,
   agreement with the explicit plain path, and the metrics sheet written
   and read back are checked;
4. training path: ``TrainLoop.fit`` trains the same full-width CvT (dropout
   0.1) for 2 epochs of 512 synthetic images with a learnable label and
   validates on 128: 8 steps, with exact launch counts; 3 steps of
   ``make_train_step`` on one batch with dropout 0 through the kernels and
   through plain PyTorch agree; a checkpoint saved and loaded into a fresh
   loop predicts bit for bit the same; ms per step on both paths.

Any failure raises and the exit code is non-zero.  The line before the last
is a JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Nothing is read from or written to the
repository except the kernels' build directory.
"""

import sys

sys.dont_write_bytecode = True  # write nothing into the checkout

import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from transformer_stm_tpu_torch.config import CvTSpec, TrainConfig  # noqa: E402
from transformer_stm_tpu_torch.kernels import _build  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small, attention_small_bwd, attention_small_bwd_plain,
    attention_small_fwd, attention_small_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_plain)
from transformer_stm_tpu_torch.models.cvt import (  # noqa: E402
    cvt_forward, cvt_param_count, init_cvt)
from transformer_stm_tpu_torch.ops.common import use_true_f32  # noqa: E402
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    from_jax_params, save_checkpoint, to_jax_params)
from transformer_stm_tpu_torch.train.loop import (  # noqa: E402
    TrainLoop, make_train_step)
from transformer_stm_tpu_torch.train.optimizer import adam_init  # noqa: E402
from transformer_stm_tpu_torch.train.metrics import (  # noqa: E402
    HEADER, mae, mse, r2_score, read_predictions_metrics,
    write_predictions_metrics)

SEED = 0
BATCH = 128
N_IMAGES = 512
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# (stage, B, T = S, H) with Dh 64, and (stage, N rows, D) with Hd = 4D: the
# shapes one batch of 128 gives the kernels on the main path.
ATTN_SHAPES = [("stage1", BATCH, 1024, 1), ("stage2", BATCH, 256, 2),
               ("stage3", BATCH, 65, 4)]
MLP_SHAPES = [("stage1", BATCH * 1024, 64), ("stage2", BATCH * 256, 128),
              ("stage3", BATCH * 65, 256)]
ATTN_TOL = 1e-4   # atol and rtol, elementwise (forward, lse, backward)
MLP_TOL = 1e-4    # max |kernel - plain| <= MLP_TOL * max |plain|
PATH_TOL = 1e-3   # |kernel path - plain path| <= PATH_TOL * max(1, |plain|);
                  # per-step training losses within PATH_TOL relative
TRAIN_STEPS = 3   # steps of the kernel path against the plain path
EPOCHS = 2        # of N_IMAGES training images in batches of BATCH


def say(msg):
    print(msg, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median device time of fn() in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(what, got, ref, tol=ATTN_TOL):
    """Raises unless got is finite and |got - ref| <= tol + tol |ref|."""
    excess = (got - ref).abs() - tol - tol * ref.abs()
    if not torch.isfinite(got).all() or excess.max().item() > 0:
        raise AssertionError(
            f"{what}: max |err| {(got - ref).abs().max().item():.3e} "
            f"({ref.dtype}) over atol/rtol {tol}")


def device_ms(fn, calls=3):
    """(ms of device activity per call of fn, summed by torch.profiler over
    its CUDA events; the five largest as (name, ms per call)).  The total is
    None when the profiler records no device activity."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in dev) / 1e3 / calls
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return total or None, [(e.key[:48], e.self_device_time_total / 1e3 /
                            calls) for e in top]


def bound(flops, nbytes):
    """Least time on the card in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


KERNELS = (attention_small, attention_small_bwd, fused_mlp)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def read_launches():
    return {k.__name__: k.launches for k in KERNELS}


def phase_env():
    faulthandler.dump_traceback_later(600, exit=True)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    use_true_f32()
    say(f"[0] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    return card


def kernel_name(mangled):
    """The last name of a mangled nested name, with its integer template
    argument: '_ZN<n>_GLOBAL__N_<...><n>bwd_dqEPKf...' -> 'bwd_dq',
    '..13fused_mlp_fwdILi256EEEv..' -> 'fused_mlp_fwd<256>'."""
    name, i = mangled, 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[i:])):
        n = int(m.group())
        name = mangled[i + m.end():i + m.end() + n]
        i += m.end() + n
    t = re.match(r"ILi(\d+)E", mangled[i:])
    return f"{name}<{t.group(1)}>" if t else name


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    name = spill = "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            say(f"[1] ptxas {name}: {line.split(':', 1)[-1].strip()}; "
                f"{spill}")
    say(f"[1] kernels built with nvcc in {dt:.1f} s "
        f"(nvcc {_build.build_seconds} s)")


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = []

    rows, worst = [], 0.0
    brows, bworst = [], 0.0
    for stage, b, s, h in ATTN_SHAPES:
        q, k, v, g = (torch.randn(b, s, h, 64, device=dev, generator=gen)
                      for _ in range(4))
        got = attention_small(q, k, v)
        got_l, lse = attention_small_fwd(q, k, v, with_lse=True)
        want, want_lse = attention_small_plain(q, k, v, with_lse=True)
        # and in float64, a yardstick that shares no rounding with either
        want64 = attention_small_plain(q.double(), k.double(), v.double())
        torch.cuda.synchronize()
        for what, x, ref in (("o", got, want), ("o", got, want64),
                             ("o with lse", got_l, want),
                             ("lse", lse, want_lse)):
            check_close(f"attention_small {stage} {what}", x, ref)
        err = (got - want).abs().max().item()
        err64 = (got - want64).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        del want64
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms_inf = time_ms(lambda: attention_small(q, k, v))
        ms = time_ms(lambda: attention_small_fwd(q, k, v, with_lse=True))
        plain = time_ms(lambda: attention_small_plain(q, k, v,
                                                      with_lse=True))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        b_ms, b_by = bound(4.0 * b * h * s * s * 64,
                           4.0 * (4 * b * s * h * 64 + b * h * s))
        rows.append(dict(stage=stage, shape=[b, s, h, 64], ms=ms,
                         ms_inference=ms_inf, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=max(err, err_lse),
                         max_abs_err_f64=err64))
        worst = max(worst, err, err_lse)
        say(f"[2] attention_small {stage} B{b} S{s} H{h}: max|err| "
            f"{err:.2e} (vs f64 {err64:.2e}; lse {err_lse:.2e})  kernel "
            f"{ms_inf:.3f} ms, with lse {ms:.3f} ms  plain {plain:.3f} ms"
            f"  sdpa {lib:.3f} ms  bound {b_ms:.3f} ms ({b_by})")

        # The backward, fed the kernel's own o and lse; no atomics, so two
        # calls agree bit for bit.
        dgot = attention_small_bwd(q, k, v, got_l, lse, g)
        if not all(map(torch.equal, dgot,
                       attention_small_bwd(q, k, v, got_l, lse, g))):
            raise AssertionError(f"attention_small_bwd {stage}: two calls "
                                 "on the same inputs differ")
        dwant = attention_small_bwd_plain(q, k, v, got_l, lse, g)
        leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
        d64 = torch.autograd.grad(attention_small_plain(*leaves), leaves,
                                  g.double())
        torch.cuda.synchronize()
        errs, errs64 = [], []
        for name, x, ref, ref64 in zip(("dq", "dk", "dv"), dgot, dwant, d64):
            check_close(f"attention_small_bwd {stage} {name}", x, ref)
            check_close(f"attention_small_bwd {stage} {name} (f64)", x,
                        ref64)
            errs.append((x - ref).abs().max().item())
            errs64.append((x - ref64).abs().max().item())
        del leaves, d64, dwant
        ms = time_ms(lambda: attention_small_bwd(q, k, v, got_l, lse, g))
        plain = time_ms(lambda: attention_small_bwd_plain(q, k, v, got_l,
                                                          lse, g))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                  retain_graph=True))
        del out
        b_ms, b_by = bound(10.0 * b * h * s * s * 64,
                           4.0 * (8 * b * s * h * 64 + b * h * s))
        brows.append(dict(stage=stage, shape=[b, s, h, 64], ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=max(errs),
                          max_abs_err_f64=max(errs64)))
        bworst = max(bworst, max(errs))
        say(f"[2] attention_small_bwd {stage} B{b} S{s} H{h} (two calls "
            "bit-equal): max|err| "
            f"dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (vs f64 "
            f"{errs64[0]:.2e}/{errs64[1]:.2e}/{errs64[2]:.2e})  kernel "
            f"{ms:.3f} ms  plain {plain:.3f} ms  sdpa bwd {lib:.3f} ms  "
            f"bound {b_ms:.3f} ms ({b_by})")
    # On the main paths only stage 1 reaches the kernels (T*S > 300,000);
    # training runs the forward with lse.
    for name, source, replaces, rs, w in (
            ("attention_small", "attention_small.cu", 680, rows, worst),
            ("attention_small_bwd", "attention_small_bwd.cu", 764, brows,
             bworst)):
        s1 = rs[0]
        results.append(dict(
            name=name, route="cuda",
            source=f"transformer_stm_tpu_torch/csrc/{source}",
            replaces=f"transformer_stm_tpu/kernels/flash_attention.py:"
                     f"{replaces}",
            max_abs_err=w, ms=s1["ms"], plain_ms=s1["plain_ms"],
            bound_ms=s1["bound_ms"], bound_by=s1["bound_by"],
            library_ms=s1["library_ms"], shapes=rs))
    results[-1]["also_replaces"] = \
        "transformer_stm_tpu/kernels/flash_attention.py:791"

    rows, worst = [], 0.0
    for stage, n, d in MLP_SHAPES:
        hd = 4 * d
        x = torch.randn(n, d, device=dev, generator=gen)
        w1 = torch.randn(d, hd, device=dev, generator=gen) / d ** 0.5
        b1 = 0.1 * torch.randn(hd, device=dev, generator=gen)
        w2 = torch.randn(hd, d, device=dev, generator=gen) / hd ** 0.5
        b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
        got = fused_mlp(x, w1, b1, w2, b2)
        want = fused_mlp_plain(x, w1, b1, w2, b2)
        want64 = fused_mlp_plain(*(t.double() for t in (x, w1, b1, w2, b2)))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err64 = (got - want64).abs().max().item()
        scale = want.abs().max().item()
        if not torch.isfinite(got).all() or max(err, err64) > MLP_TOL * scale:
            raise AssertionError(f"fused_mlp {stage}: max |err| {err:.3e}, "
                                 f"vs f64 {err64:.3e}, over {MLP_TOL} x "
                                 f"max|y| {scale:.3e}")
        ms = time_ms(lambda: fused_mlp(x, w1, b1, w2, b2))
        plain = time_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2))
        lib = time_ms(lambda: torch.addmm(
            b2, F.gelu(torch.addmm(b1, x, w1)), w2))
        b_ms, b_by = bound(4.0 * n * d * hd,
                           4.0 * (2 * n * d + 2 * d * hd + hd + d))
        rows.append(dict(stage=stage, shape=[n, d, hd], ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err,
                         max_abs_err_f64=err64))
        worst = max(worst, err)
        say(f"[2] fused_mlp {stage} N{n} D{d} Hd{hd}: max|err| {err:.2e} "
            f"(vs f64 {err64:.2e}; max|y| {scale:.2f})  kernel {ms:.3f} ms"
            f"  plain {plain:.3f} ms  addmm+gelu+addmm {lib:.3f} ms  bound "
            f"{b_ms:.3f} ms ({b_by})")
    # On the main path every stage reaches the kernel: per batch, the sum.
    results.append(dict(
        name="fused_mlp", route="cuda",
        source="transformer_stm_tpu_torch/csrc/fused_mlp.cu",
        replaces="transformer_stm_tpu/kernels/fused_mlp.py:52",
        max_abs_err=worst,
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows), bound_by="operations",
        library_ms=sum(r["library_ms"] for r in rows), shapes=rows))
    return results


def phase_main_path():
    spec = CvTSpec()  # flagship: dw_bn projections, cls token in stage 3
    model = init_cvt(spec, generator=torch.Generator().manual_seed(SEED),
                     device="cuda")
    params, state = to_jax_params(model)
    model = from_jax_params(params, state, spec, device="cuda")
    say(f"[3] CvT dw_bn/cls, {cvt_param_count(model)} parameters, "
        "weights round-tripped through the JAX layout")

    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_IMAGES, 128, 128, 1), dtype=np.uint8)
    proc = rng.standard_normal((N_IMAGES, spec.proc_dim)).astype(np.float32)
    labels = rng.uniform(1.0, 2.0, N_IMAGES)
    cfg = TrainConfig(batch_size=BATCH, seed=SEED)
    loop = TrainLoop(spec, cfg, device="cuda", model=model)
    loop.predict(images[:BATCH], proc[:BATCH])  # warm-up, not counted

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = loop.predict(images, proc)
    dt = time.perf_counter() - t0
    launches = read_launches()
    n_batches = N_IMAGES // BATCH
    say(f"[3] launches over {n_batches} batches: {launches}")
    want = {"attention_small": n_batches, "attention_small_bwd": 0,
            "fused_mlp": 3 * n_batches}
    if launches != want:
        raise AssertionError(f"evaluation path launches {launches}, want "
                             f"{want}")
    if preds.shape != (N_IMAGES,) or not np.isfinite(preds).all():
        raise AssertionError(f"predictions: shape {preds.shape}, finite "
                             f"{np.isfinite(preds).all()}")

    plain = TrainLoop(spec, cfg, impl="plain", device="cuda",
                      model=model).predict(images, proc)
    if read_launches() != launches:
        raise AssertionError("the plain path launched a kernel")
    diff = np.abs(preds - plain)
    limit = PATH_TOL * np.maximum(1.0, np.abs(plain))
    if (diff > limit).any():
        raise AssertionError(f"kernel path vs plain path: max |diff| "
                             f"{diff.max():.3e}")
    say(f"[3] kernel path vs plain path: max |diff| {diff.max():.3e} "
        f"(limit {PATH_TOL} x max(1, |y|)); |y| up to "
        f"{np.abs(plain).max():.3f}")

    r2, m_se, m_ae = (r2_score(labels, preds), mse(labels, preds),
                      mae(labels, preds))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Predictions_Metrics_200HZ_Pcv.xlsx")
        write_predictions_metrics(path, "200HZ_Pcv", preds, labels,
                                  train_num=0, test_num=N_IMAGES)
        sheet = read_predictions_metrics(path)
    if sheet["header"] != HEADER or \
            not np.array_equal(sheet["predictions"],
                               preds.astype(np.float64)) or \
            (sheet["r2"], sheet["mse"], sheet["mae"]) != (r2, m_se, m_ae):
        raise AssertionError("the metrics sheet did not read back as written")
    say(f"[3] metrics vs synthetic labels: r2 {r2:.4f} mse {m_se:.4f} "
        f"mae {m_ae:.4f}; Predictions_Metrics sheet read back")
    say(f"[3] predict: {N_IMAGES / dt:.1f} images/s, "
        f"{1e3 * dt / n_batches:.2f} ms per batch of {BATCH} "
        "(host clock, copies to and from the card included)")
    return launches


def synthetic(rng, n, spec):
    """uint8 images and a learnable label: the mean pixel plus a linear
    term in the process parameters."""
    images = rng.integers(0, 256, (n, 128, 128, 1), dtype=np.uint8)
    proc = rng.standard_normal((n, spec.proc_dim)).astype(np.float32)
    labels = (images.mean(axis=(1, 2, 3)) / 255.0
              + proc @ np.arange(1, spec.proc_dim + 1)).astype(np.float32)
    return images, proc, labels


def phase_training(kernels):
    spec = CvTSpec()  # flagship, dropout 0.1 in every stage
    rng = np.random.default_rng(SEED + 1)
    train = synthetic(rng, N_IMAGES, spec)
    val = synthetic(rng, BATCH, spec)
    cfg = TrainConfig(batch_size=BATCH, seed=SEED, epochs=EPOCHS)
    loop = TrainLoop(spec, cfg, device="cuda")

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = loop.fit(*train, val=val, verbose=False)["records"].rows
    dt = time.perf_counter() - t0
    launches = read_launches()
    steps = EPOCHS * N_IMAGES // BATCH
    say(f"[4] fit: {EPOCHS} epochs, {steps} steps of {BATCH} in {dt:.2f} s "
        f"(host clock, validation included); launches {launches}")
    for r in rows:
        say(f"[4] epoch {r[0]}: loss {r[1]:.4f} mae {r[2]:.4f} val_loss "
            f"{r[3]:.4f} val_mae {r[4]:.4f} lr {r[5]:.2e}")
    want = {"attention_small": steps + EPOCHS, "attention_small_bwd": steps,
            "fused_mlp": 3 * EPOCHS}
    if launches != want:
        raise AssertionError(f"training path launches {launches}, want "
                             f"{want}")
    if len(rows) != EPOCHS or not np.isfinite(
            np.asarray([r[1:] for r in rows], np.float64)).all():
        raise AssertionError(f"records not finite: {rows}")

    # The kernel path against the plain path: one batch, dropout 0.
    spec0 = dataclasses.replace(spec, stages=tuple(
        dataclasses.replace(st, dropout_rate=0.0) for st in spec.stages))
    params, state = to_jax_params(init_cvt(
        spec0, torch.Generator().manual_seed(SEED), device="cuda"))
    dev = torch.device("cuda")
    batch = (torch.from_numpy(train[0][:BATCH]).to(dev).float() / 255.0,
             torch.from_numpy(train[1][:BATCH]).to(dev),
             torch.from_numpy(train[2][:BATCH]).to(dev),
             torch.ones(BATCH, device=dev))
    vx = torch.from_numpy(val[0]).to(dev).float() / 255.0
    vp = torch.from_numpy(val[1]).to(dev)
    losses, outs = {}, {}
    for impl in ("auto", "plain"):
        before = read_launches()
        model = from_jax_params(params, state, spec0, device="cuda")
        opt = adam_init(model)
        step = make_train_step(cfg, impl=impl)
        losses[impl] = [step(model, opt, batch, None, cfg.learning_rate)
                        ["loss"].item() for _ in range(TRAIN_STEPS)]
        with torch.inference_mode():
            outs[impl] = cvt_forward(model, vx, vp, impl="plain").reshape(
                -1).cpu().numpy()
        if impl == "plain" and read_launches() != before:
            raise AssertionError("the plain training path launched a kernel")
    la, lp = np.asarray(losses["auto"]), np.asarray(losses["plain"])
    if (np.abs(la - lp) > PATH_TOL * np.abs(lp)).any():
        raise AssertionError(f"training losses, kernel path {la} vs plain "
                             f"path {lp}")
    diff = np.abs(outs["auto"] - outs["plain"])
    if (diff > PATH_TOL * np.maximum(1.0, np.abs(outs["plain"]))).any():
        raise AssertionError(f"trained models' outputs: max |diff| "
                             f"{diff.max():.3e}")
    say(f"[4] {TRAIN_STEPS} steps, kernel path vs plain path: losses "
        f"{la.tolist()} vs {lp.tolist()}, max rel diff "
        f"{(np.abs(la - lp) / np.abs(lp)).max():.2e}; trained outputs max "
        f"|diff| {diff.max():.3e} (|y| up to "
        f"{np.abs(outs['plain']).max():.3f})")

    # ms per training step (CUDA events), dropout 0.1 as configured, and
    # the device's busy time in a step (torch.profiler).
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms = {}
    for impl in ("auto", "plain"):
        step = make_train_step(cfg, impl=impl)

        def one_step():
            step(loop.model, loop.opt, batch, gen, cfg.learning_rate)

        step_ms[impl] = time_ms(one_step, reps=5, warmup=2)
        busy, top = device_ms(one_step)
        if busy is None:
            say(f"[4] {impl} path: device time not measured (the profiler "
                "recorded no device activity)")
            continue
        say(f"[4] {impl} path: device busy {busy:.2f} ms of a "
            f"{step_ms[impl]:.2f} ms step ({100 * busy / step_ms[impl]:.1f}%"
            "; profiler, 3 steps); largest: " + ", ".join(
                f"{name} {ms:.3f}" for name, ms in top))
    by_name = {k["name"]: k for k in kernels}
    attn_ms = by_name["attention_small"]["ms"] + \
        by_name["attention_small_bwd"]["ms"]
    say(f"[4] train step, batch {BATCH}: kernel path {step_ms['auto']:.2f} "
        f"ms ({1e3 * BATCH / step_ms['auto']:.1f} images/s), plain path "
        f"{step_ms['plain']:.2f} ms ({1e3 * BATCH / step_ms['plain']:.1f} "
        f"images/s); attention_small forward with lse + backward at stage 1 "
        f"{attn_ms:.3f} ms = {100 * attn_ms / step_ms['auto']:.1f}% of the "
        "kernel path's step")

    # A checkpoint loaded into a fresh loop predicts bit for bit the same.
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, loop.model, loop.opt, step=loop.epoch)
        fresh = TrainLoop(spec, TrainConfig(batch_size=BATCH, seed=SEED + 1),
                          device="cuda")
        fresh.load_checkpoint(path)
    a, b = loop.predict(*val[:2]), fresh.predict(*val[:2])
    if fresh.epoch != loop.epoch or fresh.opt.step != loop.opt.step or \
            not np.array_equal(a, b):
        raise AssertionError(f"checkpoint round trip: epoch {fresh.epoch} "
                             f"step {fresh.opt.step}, max |diff| "
                             f"{np.abs(a - b).max():.3e}")
    say(f"[4] checkpoint saved and loaded into a fresh loop: epoch "
        f"{fresh.epoch}, Adam step {fresh.opt.step}, predictions equal")
    return launches


def main():
    phase_env()
    phase_build()
    kernels = phase_kernels()
    eval_launches = phase_main_path()
    train_launches = phase_training(kernels)
    for k in kernels:
        k["launches"] = train_launches[k["name"]]
        k["launches_evaluation"] = eval_launches[k["name"]]
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
