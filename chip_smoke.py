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
   backward as the yardstick), fused_mlp, and the training MLP
   fused_mlp_train forward and backward at rates 0.1 and 0 (against
   fused_mlp_train_plain, which draws the same masks; the keep share of
   both masks; two backward calls bit-equal; addmm+gelu+dropout+addmm+
   dropout and its autograd backward as the yardstick); and attention_small
   under torch.func.vmap and grad over 2 slots, bit-equal to a loop;
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
   loop predicts bit for bit the same; ms per step on both paths;
5. multi-target path: ``MultiTargetTrainer`` trains the full-width CvT
   (dropout 0.1, mlp_impl="pallas") as 2 slots of two targets over a
   synthetic corpus of 2 groups x 5 pieces x 64 layers (label and process
   sheets written with the port's xlsx writer; one target misses a label,
   so the slots train on 512 and 448 rows), 5 steps per epoch of which one
   is gated, 2 epochs with validation, with exact launch counts; the gated
   step leaves every slot bit for bit as it was; ms per slot-step and the
   device's busy share; a stacked checkpoint round trip predicts the same;
   3 steps at dropout 0 through the kernels and through plain PyTorch agree.

Any failure raises and the exit code is non-zero.  The line before the last
is a JSON object with each kernel's numbers (``launches`` from phase 5,
``launches_by_path`` from phases 3, 4 and 5); the last line is
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

from transformer_stm_tpu_torch.config import (  # noqa: E402
    PROCESS_PARAMETERS, CvTSpec, DataConfig, ExperimentConfig, TrainConfig)
from transformer_stm_tpu_torch.data.xlsx import write_xlsx  # noqa: E402
from transformer_stm_tpu_torch.kernels import _build  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small, attention_small_bwd, attention_small_bwd_plain,
    attention_small_fwd, attention_small_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    STREAM_HIDDEN, STREAM_OUT, TRAIN_BWD_ROWS, dropout_mask, fused_mlp,
    fused_mlp_plain, fused_mlp_train, fused_mlp_train_bwd,
    fused_mlp_train_bwd_plain, fused_mlp_train_fwd, fused_mlp_train_plain)
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
from transformer_stm_tpu_torch.train.multi import (  # noqa: E402
    MultiTargetTrainer)

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
DROPOUT = 0.1     # the flagship's rate
EPOCHS = 2        # of N_IMAGES training images in batches of BATCH
MULTI_TARGETS = ("50HZ_Bm", "50HZ_Hc")  # phase 5's slots
MULTI_GROUPS, MULTI_LAYERS, MULTI_EPOCHS = 2, 64, 2
MULTI_LOSS_TOL = 1e-4  # per-step losses, kernel path vs plain path


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


KERNELS = (attention_small, attention_small_bwd, fused_mlp, fused_mlp_train,
           fused_mlp_train_bwd)


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
    results += phase_mlp_train(dev, gen)
    phase_vmap(dev, gen)
    return results


def mlp_train_library(x, w1, b1, w2, b2, rate):
    """One PyTorch graph of the same function: addmm, gelu, dropout, addmm,
    dropout (its own masks)."""
    h = F.dropout(F.gelu(torch.addmm(b1, x, w1)), rate, training=True)
    return F.dropout(torch.addmm(b2, h, w2), rate, training=True)


def phase_mlp_train(dev, gen):
    """fused_mlp_train forward and backward at the three stage shapes, at
    rate 0.1 and 0, against fused_mlp_train_plain (the same masks) and its
    float64 evaluation; the keep share of both masks at stage 1; two
    backward calls bit-equal; times at rate 0.1."""
    frows, brows, worst = [], [], {"fwd": 0.0, "bwd": 0.0}
    names = ("y", "dx", "dW1", "db1", "dW2", "db2")
    for stage, n, d in MLP_SHAPES:
        hd = 4 * d
        x = torch.randn(n, d, device=dev, generator=gen)
        w1 = torch.randn(d, hd, device=dev, generator=gen) / d ** 0.5
        b1 = 0.1 * torch.randn(hd, device=dev, generator=gen)
        w2 = torch.randn(hd, d, device=dev, generator=gen) / hd ** 0.5
        b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
        dy = torch.randn(n, d, device=dev, generator=gen)
        seed = torch.randint(0, 2 ** 31 - 1, (2,), device=dev, generator=gen,
                             dtype=torch.int32)
        args = (x, w1, b1, w2, b2, seed)
        errs = {}
        for rate in (DROPOUT, 0.0):
            got = (fused_mlp_train_fwd(*args, rate),
                   *fused_mlp_train_bwd(*args, rate, dy))
            again = fused_mlp_train_bwd(*args, rate, dy)
            if not all(map(torch.equal, got[1:], again)):
                raise AssertionError(f"fused_mlp_train_bwd {stage}: two "
                                     "calls on the same inputs differ")
            want = (fused_mlp_train_plain(*args, rate),
                    *fused_mlp_train_bwd_plain(*args, rate, dy))
            a64 = [t.double() for t in args[:5]] + [seed]
            want64 = (fused_mlp_train_plain(*a64, rate),
                      *fused_mlp_train_bwd_plain(*a64, rate, dy.double()))
            torch.cuda.synchronize()
            for name, g, w, w64 in zip(names, got, want, want64):
                scale = w.abs().max().item()
                e, e64 = ((g - w).abs().max().item(),
                          (g.double() - w64).abs().max().item())
                if not torch.isfinite(g).all() or max(e, e64) > \
                        MLP_TOL * scale:
                    raise AssertionError(
                        f"fused_mlp_train {stage} rate {rate} {name}: max "
                        f"|err| {e:.3e}, vs f64 {e64:.3e}, over {MLP_TOL} x "
                        f"max {scale:.3e}")
                errs[(rate, name)] = (e / scale, e64 / scale, e)
            del got, again, want, want64, a64
        if stage == "stage1":
            shares = [(dropout_mask(seed, n, w, s, DROPOUT) > 0).double()
                      .mean().item() for s, w in ((STREAM_HIDDEN, hd),
                                                  (STREAM_OUT, d))]
            if any(abs(sh - (1 - DROPOUT)) > 1e-3 for sh in shares):
                raise AssertionError(f"keep shares {shares}, want "
                                     f"{1 - DROPOUT} +- 1e-3")
            say(f"[2] fused_mlp_train {stage} keep share m1 {shares[0]:.5f} "
                f"m2 {shares[1]:.5f} at rate {DROPOUT}")
        rel = max(v[0] for v in errs.values())
        rel64 = max(v[1] for v in errs.values())

        ms = time_ms(lambda: fused_mlp_train_fwd(*args, DROPOUT))
        plain = time_ms(lambda: fused_mlp_train_plain(*args, DROPOUT))
        lib = time_ms(lambda: mlp_train_library(x, w1, b1, w2, b2, DROPOUT))
        b_ms, b_by = bound(4.0 * n * d * hd,
                           4.0 * (2 * n * d + 2 * d * hd + hd + d) + 8)
        frows.append(dict(stage=stage, shape=[n, d, hd], ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, max_rel_err=rel,
                          max_rel_err_f64=rel64))
        bms = time_ms(lambda: fused_mlp_train_bwd(*args, DROPOUT, dy))
        bplain = time_ms(lambda: fused_mlp_train_bwd_plain(*args, DROPOUT,
                                                           dy))
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2,
                                                            b2)]
        out = mlp_train_library(*leaves, DROPOUT)
        blib = time_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                                   retain_graph=True))
        del out, leaves
        bb_ms, bb_by = bound(10.0 * n * d * hd,
                             4.0 * (3 * n * d + 2 * (2 * d * hd + hd + d))
                             + 8)
        nb = -(-n // TRAIN_BWD_ROWS[d])
        part_ms = 2e3 * 4.0 * nb * (2 * d * hd + hd + d) / PEAK_BYTES
        brows.append(dict(stage=stage, shape=[n, d, hd], ms=bms,
                          plain_ms=bplain, library_ms=blib, bound_ms=bb_ms,
                          bound_by=bb_by, partials_ms_at_peak=part_ms,
                          blocks=nb, max_rel_err=rel, max_rel_err_f64=rel64))
        worst["fwd"] = max(worst["fwd"], *(errs[(r, "y")][2]
                                           for r in (DROPOUT, 0.0)))
        worst["bwd"] = max(worst["bwd"], *(v[2] for k, v in errs.items()
                                           if k[1] != "y"))
        say(f"[2] fused_mlp_train {stage} N{n} D{d} Hd{hd} (rates {DROPOUT} "
            f"and 0; two backward calls bit-equal): max |err| / max |ref| "
            f"{rel:.2e} (vs f64 {rel64:.2e})  forward kernel {ms:.3f} ms  "
            f"plain {plain:.3f} ms  addmm+gelu+dropout+addmm+dropout "
            f"{lib:.3f} ms  bound {b_ms:.3f} ms ({b_by});  backward kernel "
            f"{bms:.3f} ms (partials {nb} blocks, {part_ms:.3f} ms of bytes "
            f"at peak)  plain {bplain:.3f} ms  autograd of that graph "
            f"{blib:.3f} ms  bound {bb_ms:.3f} ms ({bb_by})")
        del x, w1, b1, w2, b2, dy, args
    out = []
    for name, rows, line, key in (
            ("fused_mlp_train", frows, 170, "fwd"),
            ("fused_mlp_train_bwd", brows, 189, "bwd")):
        # per slot-step every stage reaches the kernel once: the sums
        out.append(dict(
            name=name, route="cuda",
            source="transformer_stm_tpu_torch/csrc/fused_mlp_train.cu",
            replaces=f"transformer_stm_tpu/kernels/fused_mlp.py:{line}",
            max_abs_err=worst[key],
            max_rel_err=max(r["max_rel_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations",
            library_ms=sum(r["library_ms"] for r in rows), shapes=rows))
    return out


def phase_vmap(dev, gen):
    """AttentionSmall under torch.func: vmap over 2 slots of the forward
    and of grad of a scalar loss equals a loop over the slots, bit for bit,
    at stage-1 shapes."""
    from torch.func import grad, vmap

    _, b, s, h = ATTN_SHAPES[0]
    q, k, v = (torch.randn(2, b, s, h, 64, device=dev, generator=gen)
               for _ in range(3))
    c = torch.randn(b, s, h, 64, device=dev, generator=gen)
    o = vmap(attention_small)(q, k, v)
    if not torch.equal(o, torch.stack([attention_small(q[i], k[i], v[i])
                                       for i in range(2)])):
        raise AssertionError("vmap of attention_small differs from a loop")

    def loss(a, b_, c_):
        return (attention_small(a, b_, c_) * c).sum()

    gv = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    gl = [grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i]) for i in range(2)]
    if not all(torch.equal(gv[j], torch.stack([g[j] for g in gl]))
               for j in range(3)):
        raise AssertionError("vmap(grad) of attention_small differs from a "
                             "loop")
    say(f"[2] attention_small under torch.func: vmap over 2 slots of the "
        f"forward and of grad, B{b} S{s} H{h}: bit-equal to a loop")


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
            "fused_mlp": 3 * n_batches, "fused_mlp_train": 0,
            "fused_mlp_train_bwd": 0}
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
            "fused_mlp": 3 * EPOCHS, "fused_mlp_train": 0,
            "fused_mlp_train_bwd": 0}
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


def multi_fixture(root):
    """2 groups x 5 pieces x 64 layers of 128x128 uint8 images, and label
    and process sheets written with the port's xlsx writer; the second
    target misses a label on a non-first piece (row 2), so its slot trains
    on 448 rows and the first on 512."""
    rng = np.random.default_rng(SEED + 2)
    n_spec = MULTI_GROUPS * 5
    corpus = rng.integers(0, 256, (n_spec, MULTI_LAYERS, 128, 128),
                          dtype=np.uint8)
    # a learnable label: the specimen's mean pixel plus a group term
    base = corpus.mean(axis=(1, 2, 3)) / 255.0
    rows = [["No."] + list(MULTI_TARGETS)]
    for i in range(n_spec):
        rows.append([i + 1, float(base[i] + i // 5),
                     None if i == 2 else float(2 * base[i] + i // 5)])
    labels = os.path.join(root, "labels.xlsx")
    write_xlsx(labels, {"Sheet1": rows})
    process = os.path.join(root, "process.xlsx")
    write_xlsx(process, {"Sheet1": [list(PROCESS_PARAMETERS)] +
                         rng.uniform(0.5, 3.0, (MULTI_GROUPS, 5)).tolist()})
    data = DataConfig(data_root=os.path.join(root, "data"),
                      excel_labels=labels, excel_process=process,
                      group_end=MULTI_GROUPS, image_layers=MULTI_LAYERS,
                      cache_dir=os.path.join(root, "cache"))
    return data, corpus


def multi_trainer(data, corpus, root, spec=CvTSpec(), seeds=(0, 1),
                  **kw):
    cfg = ExperimentConfig(model=spec, data=data,
                           train=TrainConfig(batch_size=BATCH, seed=SEED),
                           result_dir=os.path.join(root, "Result"))
    targets = [(f, s, None) for f, s in zip(MULTI_TARGETS, seeds)]
    return MultiTargetTrainer(cfg, targets, corpus=corpus, extra_steps=1,
                              device="cuda", **kw)


def slot_outputs(tr, images, proc):
    with torch.inference_mode():
        return [cvt_forward(m, images, proc, impl="plain").reshape(-1)
                .cpu().numpy() for m in tr.models]


def phase_multi(kernels):
    """The multi-target trainer at full width through the kernels: 2 slots,
    2 epochs with validation, one gated step per epoch."""
    root = tempfile.mkdtemp()
    data, corpus = multi_fixture(root)
    tr = multi_trainer(data, corpus, root, mlp_impl="pallas")
    steps, live_steps = tr.steps_per_epoch, -(-tr.n_train // BATCH)
    say(f"[5] MultiTargetTrainer, flagship CvT at full width, dropout "
        f"{DROPOUT}, batch {BATCH}, mlp_impl='pallas': slots "
        f"{[t[0] for t in tr.targets]} with n_train {tr.n_train.tolist()} "
        f"and n_val {tr.n_val.tolist()}, {steps} steps per epoch "
        f"(live {live_steps.tolist()}), validation batch {tr.val_batch}")
    if tr.n_train.tolist() != [512, 448] or steps != 5:
        raise AssertionError("unexpected fixture sizes")

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(MULTI_EPOCHS, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    slot_steps = MULTI_EPOCHS * int(live_steps.sum())
    val_batches = MULTI_EPOCHS * len(tr.targets) * tr.n_val_steps
    say(f"[5] fit: {MULTI_EPOCHS} epochs, {slot_steps} slot-steps in "
        f"{dt:.2f} s = {1e3 * dt / MULTI_EPOCHS:.1f} ms per epoch (host "
        f"clock, validation included); launches {launches}")
    for t, recs in enumerate(tr.records):
        for r in recs:
            say(f"[5] slot {t} epoch {r[0]}: loss {r[1]:.4f} mae {r[2]:.4f} "
                f"val_loss {r[3]:.4f} val_mae {r[4]:.4f} lr {r[5]:.2e}")
    want = {"attention_small": slot_steps + val_batches,
            "attention_small_bwd": slot_steps, "fused_mlp": 3 * val_batches,
            "fused_mlp_train": 3 * slot_steps,
            "fused_mlp_train_bwd": 3 * slot_steps}
    if launches != want:
        raise AssertionError(f"multi-target launches {launches}, want {want}")
    if [o.step for o in tr.opts] != [MULTI_EPOCHS * int(n)
                                     for n in live_steps] or \
            not np.isfinite(np.asarray(tr.records, np.float64)).all():
        raise AssertionError(f"Adam counts {[o.step for o in tr.opts]}, "
                             f"records {tr.records}")

    # The gated step (the last of each epoch) leaves every slot as it was.
    plan = tr.epoch_plan(tr.epoch)
    if plan[2][:, -1].any() or not plan[2][:, :-1].all():
        raise AssertionError(f"live steps {plan[2]}")
    before = [([p.clone() for p in m.parameters()],
               [b.clone() for b in m.buffers()], o.step)
              for m, o in zip(tr.models, tr.opts)]
    acc = torch.zeros(len(tr.targets), 3, device="cuda")
    reset_launches()
    tr.train_step(tr.epoch, steps - 1, plan, acc)
    for (ps, bs, st), m, o in zip(before, tr.models, tr.opts):
        if o.step != st or not all(map(torch.equal, ps, m.parameters())) \
                or not all(map(torch.equal, bs, m.buffers())) or \
                any(read_launches().values()) or acc.abs().sum().item():
            raise AssertionError("the gated step changed a slot")
    say("[5] gated step: parameters, BatchNorm state and Adam counts "
        f"unchanged bit for bit (Adam counts {[o.step for o in tr.opts]})")

    # ms per slot-step (CUDA events) and the device's busy share.
    acc = torch.zeros(len(tr.targets), 3, device="cuda")

    def one_step():
        tr.train_step(tr.epoch, 0, plan, acc)

    step_ms = time_ms(one_step, reps=5, warmup=2) / len(tr.targets)
    busy, top = device_ms(one_step)
    busy_txt = "device time not measured (the profiler recorded none)"
    if busy is not None:
        busy /= len(tr.targets)
        busy_txt = (f"device busy {busy:.2f} ms ({100 * busy / step_ms:.1f}%"
                    "; profiler, 3 steps); largest per slot-step: "
                    + ", ".join(f"{n} {ms / len(tr.targets):.3f}"
                                for n, ms in top))
    by_name = {k["name"]: k for k in kernels}
    mlp_ms = by_name["fused_mlp_train"]["ms"] + \
        by_name["fused_mlp_train_bwd"]["ms"]
    say(f"[5] slot-step, batch {BATCH}: {step_ms:.2f} ms "
        f"({1e3 * BATCH / step_ms:.1f} images/s per slot); {busy_txt}; "
        f"fused_mlp_train forward + backward at the three stages "
        f"{mlp_ms:.3f} ms = {100 * mlp_ms / step_ms:.1f}% of the slot-step")

    # A stacked checkpoint loaded into a fresh trainer predicts the same.
    rng = np.random.default_rng(SEED + 3)
    vx = torch.from_numpy(rng.integers(0, 256, (BATCH, 128, 128, 1))
                          .astype(np.float32) / 255).to("cuda")
    vp = torch.from_numpy(rng.standard_normal((BATCH, 5))
                          .astype(np.float32)).to("cuda")
    ck = os.path.join(root, "ckpts")
    tr.save(ck)
    fresh = multi_trainer(data, corpus, root, seeds=(7, 8),
                          mlp_impl="pallas")
    if not fresh.load(ck) or fresh.epoch != tr.epoch or \
            [o.step for o in fresh.opts] != [o.step for o in tr.opts] or \
            not all(map(np.array_equal, slot_outputs(tr, vx, vp),
                        slot_outputs(fresh, vx, vp))):
        raise AssertionError("stacked checkpoint round trip changed the "
                             "slots")
    say(f"[5] stacked checkpoint saved and loaded into a fresh trainer: "
        f"epoch {fresh.epoch}, Adam counts {[o.step for o in fresh.opts]}, "
        "predictions equal")
    del fresh

    # The kernel path against the plain path: 3 steps at dropout 0.
    spec0 = dataclasses.replace(CvTSpec(), stages=tuple(
        dataclasses.replace(st, dropout_rate=0.0) for st in CvTSpec().stages))
    losses, outs = {}, {}
    for path, kw in (("kernel", dict(mlp_impl="pallas")),
                     ("plain", dict(impl="plain", mlp_impl="xla"))):
        t = multi_trainer(data, corpus, root, spec=spec0, **kw)
        p0 = t.epoch_plan(0)
        before = read_launches()
        losses[path] = []
        for s_ in range(TRAIN_STEPS):
            acc = torch.zeros(len(t.targets), 3, device="cuda")
            t.train_step(0, s_, p0, acc)
            losses[path].append((acc[:, 0] / acc[:, 2]).tolist())
        outs[path] = np.stack(slot_outputs(t, vx, vp))
        if path == "plain" and read_launches() != before:
            raise AssertionError("the plain multi-target path launched a "
                                 "kernel")
        del t
    la, lp = np.asarray(losses["kernel"]), np.asarray(losses["plain"])
    rel = np.abs(la - lp) / np.abs(lp)
    diff = np.abs(outs["kernel"] - outs["plain"])
    if (rel > MULTI_LOSS_TOL).any() or \
            (diff > PATH_TOL * np.maximum(1.0, np.abs(outs["plain"]))).any():
        raise AssertionError(f"multi-target kernel path vs plain path: "
                             f"losses {la.tolist()} vs {lp.tolist()}, "
                             f"outputs max |diff| {diff.max():.3e}")
    say(f"[5] {TRAIN_STEPS} steps at dropout 0, kernel path vs plain path: "
        f"losses per step and slot {la.tolist()} vs {lp.tolist()}, max rel "
        f"diff {rel.max():.2e} (limit {MULTI_LOSS_TOL}); trained outputs max "
        f"|diff| {diff.max():.3e} (limit {PATH_TOL} x max(1, |y|))")
    return launches


def main():
    phase_env()
    phase_build()
    kernels = phase_kernels()
    by_path = {"evaluation": phase_main_path(),
               "single_target_training": phase_training(kernels),
               "multi_target_training": phase_multi(kernels)}
    for k in kernels:
        k["launches"] = by_path["multi_target_training"][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
