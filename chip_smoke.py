"""Drives the PyTorch/CUDA port on one NVIDIA H100 and checks it.

    python3 chip_smoke.py

Phases, each printed as it finishes:

0. watchdog and environment: true f32 on the card, versions, the card's
   name and power limit;
1. build: the CUDA kernels of ``transformer_stm_tpu_torch/csrc`` with nvcc,
   each kernel's registers and spills, any ptxas C75xx note (wgmma
   serialised), and the registers, shared memory and blocks an SM of the
   3xTF32 kernels (``fused_mlp`` at every width, its dropout form that is
   the training MLP's forward at the CvT widths D 64, 128 and 256 and the
   ViT widths 192, 384 and 768, the attention forward of flash_attention
   and attention_small at Dh <= 64 and above, both flash backward kernels,
   the training MLP's dx and weight-partial kernels at D 64, 128, 192 and
   256, and the chunked products' GEMM kernel, chunk_gemm of
   csrc/chunk_gemm.cuh, with the training MLP's epilogue, which runs both
   directions at D 384 and 768, and with the f32 ViT layer's, which runs
   rows 9-11 in f32; its int8 sibling chunk_gemm_s8 with the int8 layer's
   epilogue, row 12 on f32 x) and of the bf16 int8 ViT layer's kernel
   (csrc/vit_layer_sm90.cu, mode 7);
2. kernels: each kernel against its plain PyTorch version at the CvT stage
   shapes (in float32, and in float64 as a check that shares no rounding),
   with its time, the plain version's time and one PyTorch call's time as
   a yardstick (CUDA events, median of 10 runs after a warm-up), beside its
   bound in f32 FMA (``bound_ms``) and on the tensor cores in 3xTF32
   (``bound_tc_ms``: 3 x flops at 495 TFLOP/s, or the bytes at 3.35 TB/s
   where longer), and for fused_mlp the one-off packing of its weights
   (``pack_ms``): the
   attention_small forward with and without lse, its backward
   (attention_small_bwd, against the plain backward and f64 autograd;
   SDPA's backward as the yardstick), fused_mlp, and the training MLP fused_mlp_train forward and
   backward at rates 0.1 and 0 (against fused_mlp_train_plain, which draws
   the same masks; the keep share of both masks; the forward's zeros
   exactly m2's at stage 1; two backward calls
   bit-equal; the backward's scratch bytes, measured by the caching
   allocator, at most 64 MiB; addmm+gelu+dropout+addmm+
   dropout and its autograd backward as the yardstick; the forward's time
   summed over the stages, its weights split at every call included), and
   one training-
   MLP backward at the 512px stage 1 (N 2,097,152, D 64) against plain with
   its measured scratch bytes and time; the training MLP forward and
   backward at the ViT widths D 192, 384 and 768, each at its model's B 64
   of the fine-tune (N 12,608), with the same checks (the masks included),
   bfloat16 x (y and dx in bf16 within 1e-2 of max |plain|, the weight
   gradients f32 within MLP_TOL) and its time beside plain, the library
   graph and the bounds; the scratch at most 64 MiB there too but at D 768
   (at most 96 MiB); at D 384 and 768, where both directions run as
   products over row chunks (csrc/fused_mlp_train.cu, namespace chunk),
   also the forward of csrc/fused_mlp.cu's fused body timed beside the
   chunked one, each kernel's device time in a forward and a backward call
   (torch.profiler), and a ragged N (591) at rates 0.1 and 0 within
   MLP_TOL of plain and float64, two backward calls bit-equal and the
   scratch within its limit; attention_small
   under torch.func.vmap and grad over 2 slots, bit-equal to a loop;
   flash_attention forward (with and without lse) and backward at T 300,
   S 257 for Dh 16, 33, 64, 128 and 256 and at the 512px stage-1 shape
   (B 8, S 16,384, H 1, Dh 64; float64 on 2 images), within 1e-5 of the
   largest entry of the plain version and of float64, two backward calls
   bit-equal, and timed at the main path's B 128 beside its plain version
   and SDPA (memory-efficient backend) and its backward; attention_small at
   the 512px stages 2 and 3 (S 4,096 H 2; S 1,025 H 4) the same way, timed
   at B 8 beside plain and SDPA and at B 128 beside SDPA;
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
   through plain PyTorch agree, in f32 and in bf16 compute (losses within
   2e-2 relative); a checkpoint saved and loaded into a fresh loop predicts
   bit for bit the same, and ``predict(exact=True)`` under the bf16 config
   bit for bit as the f32 config's; ms per step on both paths;
5. multi-target path: ``MultiTargetTrainer`` trains the full-width CvT
   (dropout 0.1, mlp_impl="pallas") as 2 slots of two targets over a
   synthetic corpus of 2 groups x 5 pieces x 64 layers (label and process
   sheets written with the port's xlsx writer; one target misses a label,
   so the slots train on 512 and 448 rows), 5 steps per epoch of which one
   is gated, 2 epochs with validation, with exact launch counts, and one
   epoch with ``AugmentConfig()`` with the same counts; the gated
   step leaves every slot bit for bit as it was; ms per slot-step and the
   device's busy share, and the ops that launch its torch reduce_kernel
   (torch.profiler's op-to-kernel links); a stacked checkpoint round trip
   predicts the same;
   3 steps at dropout 0 through the kernels and through plain PyTorch agree;
6. the command line at 512px: a synthetic corpus of 2 groups x 5 pieces x
   32 layers of 512x512 images written into the decode cache, label and
   process sheets, and a config JSON with ``cvt_highres_spec(512)``, batch
   128, 2 epochs and a checkpoint every epoch; ``cli.main(["train", ...])``
   and ``cli.main(["test", ...])`` with exact launch counts, the records and
   metrics sheets read back, and a second ``train --epochs 3`` that resumes
   from the epoch-2 checkpoint; ms per training step and per evaluation
   batch of 128 at 512px with the device's busy share, its largest device
   kernels and each attention kernel launch in order (torch.profiler), and
   peak memory; the kernel path against the plain path on 4 images
   (outputs, and losses over 2 training steps at dropout 0);
7. ViT-S/16 inference at 224px (``VIT_PRESETS["ViT-S/16"]``, 197 tokens
   folded into t_pad 200): the four fused-layer kernels
   (``vit_layer_infer``, ``attn_layer_infer``, ``ln_mlp_infer``,
   ``vit_layer_infer_int8``) against their plain versions at ViT-S (B 8),
   ViT-Ti and ViT-B widths (B 2) and at B 3 with 17 tokens padded to 24, in
   f32 (within 1e-5 of the largest entry) and bf16 (within two bf16 ulps of
   it; int8 within 1e-2 of it), rows 9-12 in f32 at E 320 (partial
   192-column tiles) and at ViT-S 512px (t_pad 1032), fused_mlp at D
   192/384/768 and
   attention_small on bf16; the bf16 layer's kernel (csrc/vit_layer_sm90.cu,
   the int8 layer's too) with its registers, shared memory and blocks an SM
   in each mode; each timed at
   ViT-S, B 192, bf16 (back-to-back calls, and one call alone), beside its
   plain version, the packing of its weights (once per model),
   nn.TransformerEncoderLayer (the yardstick of the whole layer) and its
   bound; rows 9-12 on f32 x (products over chunks of whole images in
   csrc/fused_layer.cu: rows 9-11 3xTF32, row 12 int8 on s8 wgmma) alone
   and back to back beside their plain versions and their f32 bounds (f32
   FMA, and the tensor cores), the whole f32 layer beside
   nn.TransformerEncoderLayer in f32, rows 11 and 12 split by kernel;
   then the whole forward with weights from seed 0
   in bf16: the routes ``impl="auto"`` (fused2), ``"fused"`` and
   ``"fused2_int8"`` at B 192, in f32 ``"auto"`` (fused_mlp), ``"fused"``,
   ``"fused2"`` and ``"fused2_int8"`` at B 64 and the
   on-device preprocessing front end (raw uint8 345x340x3 ->
   ``preprocess_images_device`` -> 1-channel ViT-S) with exact launch
   counts; a second forward of each bf16 route packs no weights, and after
   an in-place update of one weight the next forward repacks once and
   follows it; the kernel routes against ``"plain"`` at B 8 (bf16 within 5e-2
   of max(1, |logits|); int8 against f32 within 3% of the logit scale and
   correlation above 0.999, both on bf16 and on f32 images; the other f32
   routes at B 64 within 1e-3), images/s
   (CUDA events, median of 5) and peak memory of each route at B 192, 384
   and 768, of the f32 routes and f32 ``"plain"`` at B 64, and the
   device's busy share in a B 192 auto forward;
8. the ViT-B/16 fine-tune (BASELINE.json config 3, as
   scripts/bench_vit_finetune.py:34-38 sets it: one channel, 4 classes,
   batch 64, bf16, AdamW with weight decay 0.05, label smoothing 0.1) on
   320 synthetic 224x224 quadrant-class images: ``ViTTrainer.fit`` through
   the kernels (``impl="pallas"``) for 2 epochs with ``val_split=0.2`` and
   ``AugmentConfig()``, with exact launch counts (a layer's flash forward,
   flash backward pair and training MLP forward and backward a step, the
   MLP at D 768, and a flash forward and fused_mlp a layer for each
   evaluation batch); a loaded checkpoint predicts bit for bit the same and a
   second trainer resumes to epoch 3; 3 steps on one batch without
   augmentation through ``"auto"`` (plain PyTorch at 197 tokens, no
   launch) and ``"pallas"``, in f32 (losses within 1e-4 relative) and bf16
   (2e-2, first logits within 5e-2 x max(1, |logits|)); ms per bf16 step,
   images/s, peak memory and busy share of both routes;
9. the analysis and data-prep surface: Grad-CAM through
   ``cli.main(["heatmap", ...])`` on the flagship CvT (random weights from
   seed 0 saved at the target's weight path, a synthetic 128px corpus of
   10 layers a specimen written into the decode cache) with exact launch
   counts (one feature forward: attention_small once, fused_mlp 3 times),
   its heatmaps against the plain route; ``gradcam_heatmaps`` at B 128 and
   at 512px (``cvt_highres_spec(512)``, B 8: flash_attention once,
   attention_small twice, fused_mlp 3 times) through the kernels and the
   plain route, heatmaps within 1e-4 and predictions within 1e-5 of max
   |y|, ms a call and of its feature forward, the device's busy share of a
   call; the params-only FFN through ``train``/``test --inputs par`` on 40
   groups x 5 pieces x 200 rows (4 epochs of 249 steps, the first op by
   op and captured as a CUDA graph, the rest replays), no launch, its
   sheets read back, its checkpoint predicting on the card within 1e-5 of
   the CPU, seconds of the first epoch and of each later one; its graph
   replays against the same 3 epochs op by op on the card with the lr
   decayed every epoch (records within 1e-6), and the device kernels and
   busy time of an epoch each way (torch.profiler);
   ``preprocess_images_device(antialias=True)`` on the card against the
   CPU; ``pickup`` (planted outliers emptied), ``plot-records``,
   ``plot-labels``, ``plot-data --params``, ``model-plot`` and ``compare``
   (PNGs written, or a line saying matplotlib is not installed); the
   monitor's line with the card's memory; the native host loader built
   where g++ and libjpeg's header are there;
10. the multi-target family's run tooling at the flagship's full width
   (CvTSpec(), img+par, 128px, dropout 0.1, batch 128) on phase 5's corpus
   written into the decode cache, under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (ops
   without a deterministic implementation are named): (a) ``run_many``,
   3 repeats x 20 epochs with a stacked checkpoint every 10, under a
   caller's ``HangWatchdog``, with exact launch counts (under
   ``impl="small"`` every stage's attention runs on attention_small), the
   summary read back, ms per slot-step and seconds per repeat's
   evaluation; (b) ``supervise`` running a child script (written into the
   temporary directory; its patch of ``MultiTargetTrainer.run_epoch``
   lives there only) whose first attempt wedges the "multi-epoch @ 10"
   dispatch until the watchdog force-exits it with 75; the supervisor
   logs the stall and respawns it, the second attempt resumes from the
   epoch-10 stack, and its summary, records and final stacked weights
   equal (a)'s bit for bit; (c) ``cli.main(["sweep", ...])`` over 2 dropout
   groups of 2 slots with exact launch counts, the JSON read back, its
   scale-1 seed-0 point of the 0.1 group bit-equal to a one-slot trainer,
   and ``sweep --inputs par --hidden 8,16`` with no launch; (d)
   ``debug_mode`` around a forward and backward at B 32 through the
   kernels, bit-equal to the same calls outside it, a NaN planted in the
   embedding convolution's weight and one in stage 1's fc1 named at
   ``aten.convolution`` and at the ``fused_mlp_train`` kernel, ``trace()``
   around two slot-steps holding the attention and training-MLP kernels
   by name, ``StepTimer``'s summary; the phase's seconds.

Any failure raises and the exit code is non-zero.  The line before the last
is a JSON object with each kernel's numbers (``launches`` from phase 6, or
phase 5 for the training MLP, which the multi-target trainer runs at the
CvT widths, or phase 7 for the fused-layer kernels; ``launches_by_path``
from phases 3 to 10: ``vit_finetune``, where rows 4-5 run at D 768, then
phase 9's ``heatmap`` (the CLI's), ``heatmap_512px`` and ``ffn``, and phase
10's ``many`` and ``sweep``; rows 4-5
carry their ViT-width rows as ``vit_shapes`` and, as ``vit_source``, the
source of their chunked products at D 384 and 768;
rows 9-12 their f32 numbers as ``f32_*``, ``f32_launches`` the launches of
phase 7's f32 routes), phase 8's step times, phase 9's numbers
(``analysis``) and phase 10's (``family``); the last line is
``{"ok": true, "device": {...}}``.  Nothing is read from or written to the
repository except the build directory (the kernels', and the native
loader's in phase 9); phases 6, 9 and 10 work in temporary directories.
"""

import sys

sys.dont_write_bytecode = True  # write nothing into the checkout

import faulthandler  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

# cuBLAS reads its workspace setting once; phase 10 runs under
# torch.use_deterministic_algorithms, which wants one of the fixed ones
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import contextlib  # noqa: E402
import copy  # noqa: E402
import glob  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from transformer_stm_tpu_torch import cli, harness  # noqa: E402
from transformer_stm_tpu_torch.config import (  # noqa: E402
    PROCESS_PARAMETERS, CvTSpec, DataConfig, ExperimentConfig, TrainConfig,
    cvt_highres_spec, save_config)
from transformer_stm_tpu_torch.data.images import _cache_paths  # noqa: E402
from transformer_stm_tpu_torch.data.xlsx import write_xlsx  # noqa: E402
from transformer_stm_tpu_torch.kernels import _build  # noqa: E402
from transformer_stm_tpu_torch.kernels.attention_small import (  # noqa: E402
    attention_small, attention_small_bwd, attention_small_bwd_plain,
    attention_small_fwd, attention_small_plain)
from transformer_stm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_plain)
from transformer_stm_tpu_torch.kernels.fused_layer import (  # noqa: E402
    MODE_ATTN, MODE_MLP, MODE_Q8, attention_smem_bytes, attn_layer_infer,
    attn_layer_infer_plain, ln_mlp_infer, ln_mlp_infer_plain, pack_weights,
    vit_layer_infer, vit_layer_infer_int8, vit_layer_infer_int8_plain,
    vit_layer_infer_plain)
from transformer_stm_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    CHUNKED_WIDTHS, STREAM_HIDDEN, STREAM_OUT, dropout_mask, fused_mlp,
    fused_mlp_plain, fused_mlp_train, fused_mlp_train_bwd,
    fused_mlp_train_bwd_plain, fused_mlp_train_fwd, fused_mlp_train_plain,
    pack_mlp_weights, train_bwd_scratch, train_bwd_slots, train_chunk_rows,
    VIT_WIDTHS, WIDTHS)
from transformer_stm_tpu_torch.models.cvt import (  # noqa: E402
    cvt_forward, cvt_param_count, init_cvt)
from transformer_stm_tpu_torch.models.vit import (  # noqa: E402
    init_vit, vit_forward)
from transformer_stm_tpu_torch.config import VIT_PRESETS  # noqa: E402
from transformer_stm_tpu_torch.data.images import (  # noqa: E402
    preprocess_images_device)
from transformer_stm_tpu_torch.ops.attention import MHA  # noqa: E402
from transformer_stm_tpu_torch.ops.blocks import MLP  # noqa: E402
from transformer_stm_tpu_torch.ops.common import LayerNorm  # noqa: E402
from transformer_stm_tpu_torch.ops.common import use_true_f32  # noqa: E402
from transformer_stm_tpu_torch.train.checkpoint import (  # noqa: E402
    from_jax_params, latest_checkpoint, load_checkpoint, save_checkpoint,
    to_jax_params, vit_from_jax_params)
from transformer_stm_tpu_torch.train.loop import (  # noqa: E402
    TrainLoop, make_train_step)
from transformer_stm_tpu_torch.train.optimizer import adam_init  # noqa: E402
from transformer_stm_tpu_torch.train.metrics import (  # noqa: E402
    HEADER, mae, mse, r2_score, read_predictions_metrics,
    write_predictions_metrics)
from transformer_stm_tpu_torch.train.multi import (  # noqa: E402
    MultiTargetTrainer)
from transformer_stm_tpu_torch.data.augment import AugmentConfig  # noqa: E402
from transformer_stm_tpu_torch.train.vit_train import (  # noqa: E402
    ViTTrainer, make_vit_train_step)

SEED = 0
BATCH = 128
N_IMAGES = 512
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12
# (stage, B, T = S, H) with Dh 64, and (stage, N rows, D) with Hd = 4D: the
# shapes one batch of 128 gives the kernels on the main path.
ATTN_SHAPES = [("stage1", BATCH, 1024, 1), ("stage2", BATCH, 256, 2),
               ("stage3", BATCH, 65, 4)]
MLP_SHAPES = [("stage1", BATCH * 1024, 64), ("stage2", BATCH * 256, 128),
              ("stage3", BATCH * 65, 256)]
# The training MLP at the ViT widths, each at its model's B 64 of the
# fine-tune (BASELINE config 3): N = 64 x 197 rows
VIT_MLP_SHAPES = [("ViT-Ti", 192), ("ViT-S", 384), ("ViT-B", 768)]
VIT_MLP_ROWS = 64 * 197
BF16_MLP_TOL = 1e-2  # bf16 y and dx against plain's: max |err| / max |ref|
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
BF16_LOSS_TOL = 2e-2   # bf16 training losses, kernel route vs plain route
BF16_OUT_TOL = 5e-2    # bf16 outputs: max |diff| <= tol x max(1, |ref|)
# The 512px CvT (cvt_highres_spec(512)): stage 1 (B, S = T, H) goes to
# flash_attention, stages 2 and 3 to attention_small; Dh 64 everywhere.
FLASH_SHAPE = (BATCH, 16384, 1)
SMALL_512_SHAPES = [("stage2", BATCH, 4096, 2), ("stage3", BATCH, 1025, 4)]
CHECK_BATCH = 8       # kernel against plain at the 512px shapes
CHECK_BATCH_F64 = 2   # and against float64
ODD_SHAPE = (2, 300, 257, 2)  # B, T, S, H: ragged tiles on both sides
ODD_DH = (16, 33, 64, 128, 256)
FLASH_TOL = 1e-5  # max |kernel - ref| <= FLASH_TOL * max |ref|
CLI_TARGET = "50HZ_Bm"
CLI_GROUPS, CLI_LAYERS = 2, 32  # 256 train and 64 validation images
CLI_EPOCHS = 2
PATH_IMAGES = 4   # kernel path against plain path at 512px


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


SCRATCH_LIMIT = 64 << 20  # the training MLP backward's scratch, bytes
# and at D 768, where the backward keeps W1^T and two chunks' arrays
# (kernels/fused_mlp.py, train_bwd_scratch: 66.4 MB at ViT-B)
VIT_SCRATCH_LIMIT = 96 << 20


def scratch_bytes(fn):
    """The device memory that one call of fn() holds at its peak beyond
    what it returns, measured by the caching allocator: the peak allocation
    during the call, less what was allocated before it, less the storages
    of the tensors it returns."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kept = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in out}
    return peak - before - sum(kept.values())


def time_ms_batched(fn, calls=10, reps=5, warmup=2):
    """Device time of fn() in ms from back-to-back calls: CUDA events around
    `calls` calls, divided by calls, median of `reps`.  The host's work for
    a call (the wrapper's checks, allocation, the launch) overlaps the
    previous call's kernel, as in a forward; time_ms times one call alone,
    host work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_call_ms(fn, calls=10, reps=5, warmup=2):
    """Host time in ms that fn() takes to return (for a kernel wrapper: its
    checks, allocations and the launch, which does not wait for the
    kernel), perf_counter around `calls` calls, median of `reps`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - start) / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def check_close(what, got, ref, tol=ATTN_TOL):
    """Raises unless got is finite and |got - ref| <= tol + tol |ref|."""
    excess = (got - ref).abs() - tol - tol * ref.abs()
    if not torch.isfinite(got).all() or excess.max().item() > 0:
        raise AssertionError(
            f"{what}: max |err| {(got - ref).abs().max().item():.3e} "
            f"({ref.dtype}) over atol/rtol {tol}")


def device_events(prof):
    """torch.profiler's device events, by start."""
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def busy_ms(events):
    """ms of device activity: the union of the events' intervals, so that
    kernels overlapping on two streams count once."""
    busy, reach = 0.0, float("-inf")
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e3


def device_ms(fn, calls=3, launches=()):
    """(ms of device activity per call of fn: the union of torch.profiler's
    CUDA events' intervals, so that kernels overlapping on two streams count
    once; the five largest by summed time as (name, ms per call)).  The
    total is None when the profiler records no device activity.  With
    `launches`, a tuple of name patterns, a third item maps each pattern to
    the device ms of each launch of the kernels whose names hold it, in
    launch order within a call, the mean over the calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    top = [(e.key[:48], e.self_device_time_total / 1e3 / calls) for e in top]
    events = device_events(prof)
    total = busy_ms(events) / calls
    if not launches:
        return total or None, top
    each = {}
    for pattern in launches:
        ms = [e.time_range.elapsed_us() / 1e3 for e in events
              if pattern in e.name]
        n = len(ms) // calls  # every call launches the same kernels
        each[pattern] = [sum(ms[i::n]) / calls for i in range(n)]
    return total or None, top, each


def kernel_sources(fn, pattern, calls=3, top=5):
    """Which ops launch the kernels whose names hold `pattern`: (the op and
    its callers up to the first ``aten::`` op that has an input shape, those
    shapes, device ms per call of fn), the `top` largest, from
    torch.profiler's links between launches and kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = {}
    for ev in prof.events():
        ks = [k for k in getattr(ev, "kernels", []) if pattern in k.name]
        if not ks:
            continue
        chain, shapes, op = [], "", ev
        while op is not None and len(chain) < 5:
            if op.name.startswith("aten::") or not chain:
                chain.append(op.name)
            if not shapes and op.name.startswith("aten::") and op.input_shapes:
                shapes = str([sh for sh in op.input_shapes if sh])[:60]
            op = op.cpu_parent
        key = (" <- ".join(chain), shapes)
        found[key] = found.get(key, 0.0) + sum(k.duration for k in ks) / 1e3
    return sorted(((k, ms / calls) for k, ms in found.items()),
                  key=lambda kv: -kv[1])[:top]


def bound(flops, nbytes):
    """Least time on the card in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_tc(flops, nbytes):
    """Least time in ms of the same f32 work on the tensor cores: f32-
    accurate products as three TF32 products (3xTF32, csrc/tf32x3.cuh),
    3 x flops at 495 TFLOP/s, or the bytes at 3.35 TB/s where longer."""
    return 1e3 * max(3.0 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)


KERNELS = (attention_small, attention_small_bwd, fused_mlp, fused_mlp_train,
           fused_mlp_train_bwd, flash_attention, flash_attention_bwd,
           attn_layer_infer, ln_mlp_infer, vit_layer_infer,
           vit_layer_infer_int8)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def read_launches():
    return {k.__name__: k.launches for k in KERNELS}


def zero_launches():
    return {k.__name__: 0 for k in KERNELS}


def phase_env():
    faulthandler.dump_traceback_later(1100, exit=True)
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


def _last_name(mangled, i):
    """(the last name of the length-prefixed names from i, the index past
    them)."""
    name = None
    while (m := re.match(r"\d+", mangled[i:])):
        n = int(m.group())
        name = mangled[i + m.end():i + m.end() + n]
        i += m.end() + n
    return name, i


def kernel_name(mangled):
    """The last name of a mangled nested name, with its integer template
    arguments or the last name of its class argument:
    '_ZN<n>_GLOBAL__N_<...><n>bwd_dqEPKf...' -> 'bwd_dq',
    '..16fused_mlp_tf32x3ILi64ELb1EEEv..' -> 'fused_mlp_tf32x3<64,1>',
    '_ZN5cgemm10chunk_gemmIN12_GLOBAL__N_18f32layer11LayerParamsEEEvT_' ->
    'chunk_gemm<LayerParams>'."""
    name, i = _last_name(mangled, 3 if mangled.startswith("_ZN") else 2)
    name = name or mangled
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if t:
        return f"{name}<{','.join(re.findall(r'L[ib](-?\d+)E', t.group(1)))}>"
    if mangled.startswith("IN", i):
        arg, _ = _last_name(mangled, i + 2)
        return f"{name}<{arg}>" if arg else name
    return name


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    name = spill = "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif re.search(r"\(C75\d\d\)", line):
            m = re.search(r"(\(C75\d\d\)[^']*)'([^']+)'", line)
            say(f"[1] ptxas note {m.group(1).strip() if m else line.strip()}"
                f" {kernel_name(m.group(2)) if m else ''}")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            say(f"[1] ptxas {name}: {line.split(':', 1)[-1].strip()}; "
                f"{spill}")
    say(f"[1] kernels built with nvcc in {dt:.1f} s "
        f"(nvcc {_build.build_seconds} s)")
    # the 3xTF32 kernels (csrc/tf32x3.cuh): registers a thread, dynamic
    # shared memory and blocks an SM, from the runtime (spills: above)
    lib = _build.library()
    for name, fn, args in (
            *((f"fused_mlp_tf32x3 D{d}", lib.fused_mlp_info, (d,))
              for d in WIDTHS + VIT_WIDTHS),
            *((f"fused_mlp_tf32x3 with dropout D{d} (fused_mlp_train "
               "forward)", lib.fused_mlp_train_fwd_info, (d,))
              for d in WIDTHS + VIT_WIDTHS if d not in CHUNKED_WIDTHS),
            ("flash_fwd_tf32x3 Dh <= 64 (flash_attention, attention_small)",
             lib.flash_attention_fwd_info, (0,)),
            ("flash_fwd_tf32x3 Dh > 64 (flash_attention)",
             lib.flash_attention_fwd_info, (1,)),
            ("flash_bwd_tf32x3 dk/dv (flash_attention_bwd, "
             "attention_small_bwd)", lib.flash_attention_bwd_info, (0,)),
            ("flash_bwd_tf32x3 dq", lib.flash_attention_bwd_info, (1,)),
            *((f"mlp_bwd_tf32x3 {what} D{d} (fused_mlp_train_bwd)",
               lib.fused_mlp_train_bwd_info, (kind, d))
              for kind, what in ((0, "dx"), (1, "weight partials"))
              for d in WIDTHS + VIT_WIDTHS if d not in CHUNKED_WIDTHS),
            ("chunk_gemm<Params> (fused_mlp_train forward and backward at D "
             f"{' and '.join(map(str, CHUNKED_WIDTHS))})",
             lib.fused_mlp_train_chunked_info, (CHUNKED_WIDTHS[-1],)),
            ("vit_layer_sm90<7> at t_pad 200 (vit_layer_infer_int8, bf16)",
             lib.vit_layer_sm90_info,
             (MODE_ATTN | MODE_MLP | MODE_Q8, 200))):
        regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = fn(*args, ctypes.byref(regs), ctypes.byref(smem),
                ctypes.byref(blocks))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError(f"{name}: info error {rc}, {blocks.value} "
                               "blocks an SM")
        say(f"[1] {name}: {regs.value} registers, {smem.value} bytes of "
            f"shared memory, {blocks.value} block(s) an SM")
    # the f32 ViT layer's products (rows 9-11 in f32), with their local
    # memory a thread, where spills land
    regs, local, smem, blocks = (ctypes.c_int() for _ in range(4))
    rc = lib.fused_layer_tf32x3_info(
        MODE_ATTN | MODE_MLP, *map(ctypes.byref, (regs, local, smem, blocks)))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"fused_layer_tf32x3_info: error {rc}, "
                           f"{blocks.value} blocks an SM")
    say(f"[1] chunk_gemm<LayerParams> (attn_layer_infer, ln_mlp_infer and "
        f"vit_layer_infer in f32): {regs.value} registers, {local.value} "
        f"bytes of local memory a thread (stack and spills), {smem.value} "
        f"bytes of shared memory, {blocks.value} block(s) an SM")
    # the int8 layer's products on f32 x (row 12 in f32): the s8 instance
    rc = lib.fused_layer_q8_info(
        MODE_ATTN | MODE_MLP | MODE_Q8,
        *map(ctypes.byref, (regs, local, smem, blocks)))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"fused_layer_q8_info: error {rc}, "
                           f"{blocks.value} blocks an SM")
    say(f"[1] chunk_gemm_s8<Q8Params> (vit_layer_infer_int8 on f32 x): "
        f"{regs.value} registers, {local.value} bytes of local memory a "
        f"thread (stack and spills), {smem.value} bytes of shared memory, "
        f"{blocks.value} block(s) an SM")


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
        want64, want64_lse = attention_small_plain(
            q.double(), k.double(), v.double(), with_lse=True)
        torch.cuda.synchronize()
        for what, x, ref in (("o", got, want), ("o", got, want64),
                             ("o with lse", got_l, want),
                             ("o with lse", got_l, want64),
                             ("lse", lse, want_lse), ("lse", lse, want64_lse)):
            check_close(f"attention_small {stage} {what}", x, ref)
        err = (got - want).abs().max().item()
        err64 = (got - want64).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        del want64, want64_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms_inf = time_ms(lambda: attention_small(q, k, v))
        ms = time_ms(lambda: attention_small_fwd(q, k, v, with_lse=True))
        plain = time_ms(lambda: attention_small_plain(q, k, v,
                                                      with_lse=True))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        work = (4.0 * b * h * s * s * 64, 4.0 * (4 * b * s * h * 64 + b * h * s))
        b_ms, b_by = bound(*work)
        rows.append(dict(stage=stage, shape=[b, s, h, 64], ms=ms,
                         ms_inference=ms_inf, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         bound_tc_ms=bound_tc(*work),
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
        work = (10.0 * b * h * s * s * 64, 4.0 * (8 * b * s * h * 64 + b * h * s))
        b_ms, b_by = bound(*work)
        brows.append(dict(stage=stage, shape=[b, s, h, 64], ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by, bound_tc_ms=bound_tc(*work),
                          max_abs_err=max(errs),
                          max_abs_err_f64=max(errs64)))
        bworst = max(bworst, max(errs))
        say(f"[2] attention_small_bwd {stage} B{b} S{s} H{h} (two calls "
            "bit-equal): max|err| "
            f"dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (vs f64 "
            f"{errs64[0]:.2e}/{errs64[1]:.2e}/{errs64[2]:.2e})  kernel "
            f"{ms:.3f} ms  plain "
            f"{plain:.3f} ms  sdpa bwd {lib:.3f} ms  bound {b_ms:.3f} ms "
            f"({b_by}), on the tensor cores {brows[-1]['bound_tc_ms']:.3f} ms")
    # On the main paths only stage 1 reaches the kernels (T*S > 300,000);
    # training runs the forward with lse.
    for name, source, replaces, rs, w in (
            ("attention_small", "flash_attention.cu", 680, rows, worst),
            ("attention_small_bwd", "flash_attention_bwd.cu", 764, brows,
             bworst)):
        s1 = rs[0]
        results.append(dict(
            name=name, route="cuda",
            source=f"transformer_stm_tpu_torch/csrc/{source}",
            replaces=f"transformer_stm_tpu/kernels/flash_attention.py:"
                     f"{replaces}",
            max_abs_err=w, ms=s1["ms"], plain_ms=s1["plain_ms"],
            bound_ms=s1["bound_ms"], bound_by=s1["bound_by"],
            bound_tc_ms=s1["bound_tc_ms"],
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
        pack = time_ms(lambda: pack_mlp_weights(w1, w2))
        plain = time_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2))
        lib = time_ms(lambda: torch.addmm(
            b2, F.gelu(torch.addmm(b1, x, w1)), w2))
        work = (4.0 * n * d * hd, 4.0 * (2 * n * d + 2 * d * hd + hd + d))
        b_ms, b_by = bound(*work)
        rows.append(dict(stage=stage, shape=[n, d, hd], ms=ms,
                         pack_ms=pack, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_tc_ms=bound_tc(*work), max_abs_err=err,
                         max_abs_err_f64=err64))
        worst = max(worst, err)
        say(f"[2] fused_mlp {stage} N{n} D{d} Hd{hd}: max|err| {err:.2e} "
            f"(vs f64 {err64:.2e}; max|y| {scale:.2f})  kernel {ms:.3f} ms"
            f" (packing the weights, once per model, {pack:.3f} ms)  plain "
            f"{plain:.3f} ms  addmm+gelu+addmm {lib:.3f} ms  bound "
            f"{b_ms:.3f} ms ({b_by}), on the tensor cores "
            f"{rows[-1]['bound_tc_ms']:.3f} ms")
    # On the main path every stage reaches the kernel: per batch, the sum.
    results.append(dict(
        name="fused_mlp", route="cuda",
        source="transformer_stm_tpu_torch/csrc/fused_mlp.cu",
        replaces="transformer_stm_tpu/kernels/fused_mlp.py:52",
        max_abs_err=worst,
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows), bound_by="operations",
        bound_tc_ms=sum(r["bound_tc_ms"] for r in rows),
        pack_ms=sum(r["pack_ms"] for r in rows),
        library_ms=sum(r["library_ms"] for r in rows), shapes=rows))
    results += phase_mlp_train(dev, gen)
    phase_vmap(dev, gen)
    results += phase_flash(dev, gen)
    phase_small_512(dev, gen, results)
    return results


def mlp_train_library(x, w1, b1, w2, b2, rate):
    """One PyTorch graph of the same function: addmm, gelu, dropout, addmm,
    dropout (its own masks)."""
    h = F.dropout(F.gelu(torch.addmm(b1, x, w1)), rate, training=True)
    return F.dropout(torch.addmm(b2, h, w2), rate, training=True)


def mlp_train_shape(dev, gen, stage, n, d, masks=False, bf16=False,
                    limit=SCRATCH_LIMIT):
    """fused_mlp_train forward and backward at N rows and width D (Hd 4D),
    at rate 0.1 and 0, against fused_mlp_train_plain (the same masks) and
    its float64 evaluation; two backward calls bit-equal; with ``masks`` the
    forward's zeros exactly m2's and the keep share of both masks; with
    ``bf16`` bfloat16 x (y and dx in bfloat16, the weight gradients in
    float32); times at rate 0.1 beside the library graph and the bounds,
    and the backward's scratch, at most ``limit`` bytes.  Returns (forward
    row, backward row, worst forward |err|, worst backward |err|)."""
    names = ("y", "dx", "dW1", "db1", "dW2", "db2")
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
    if masks:
        # the kernel's zeros are exactly m2's
        y = fused_mlp_train_fwd(*args, DROPOUT)
        m2 = dropout_mask(seed, n, d, STREAM_OUT, DROPOUT)
        if not torch.equal(y == 0, m2 == 0):
            off = int(((y == 0) != (m2 == 0)).sum())
            raise AssertionError(
                f"fused_mlp_train {stage}: {off} outputs are zero where "
                "m2 is not, or not where it is")
        say(f"[2] fused_mlp_train {stage} rate {DROPOUT}: the forward's "
            f"zeros are m2's ({int((m2 == 0).sum())} of {m2.numel()})")
        del y, m2
        shares = [(dropout_mask(seed, n, w, s, DROPOUT) > 0).double()
                  .mean().item() for s, w in ((STREAM_HIDDEN, hd),
                                              (STREAM_OUT, d))]
        if any(abs(sh - (1 - DROPOUT)) > 1e-3 for sh in shares):
            raise AssertionError(f"keep shares {shares}, want "
                                 f"{1 - DROPOUT} +- 1e-3")
        say(f"[2] fused_mlp_train {stage} keep share m1 {shares[0]:.5f} "
            f"m2 {shares[1]:.5f} at rate {DROPOUT}")
    if bf16:
        # bf16 x runs the f32 kernels on its values: y and dx rounded to
        # bf16, the weight gradients f32 from the same inputs as plain's
        xb, dyb = x.bfloat16(), dy.bfloat16()
        got = (fused_mlp_train_fwd(xb, *args[1:], DROPOUT),
               *fused_mlp_train_bwd(xb, *args[1:], DROPOUT, dyb))
        want = (fused_mlp_train_plain(xb, *args[1:], DROPOUT),
                *fused_mlp_train_bwd_plain(xb, *args[1:], DROPOUT, dyb))
        dtypes = [str(t.dtype)[6:] for t in got]
        if dtypes != ["bfloat16"] * 2 + ["float32"] * 4:
            raise AssertionError(f"fused_mlp_train {stage} bf16 x: dtypes "
                                 f"{dtypes}")
        for i, (name, g, w) in enumerate(zip(names, got, want)):
            tol = BF16_MLP_TOL if i < 2 else MLP_TOL
            scale = w.float().abs().max().item()
            e = (g.float() - w.float()).abs().max().item()
            if e > tol * scale:
                raise AssertionError(f"fused_mlp_train {stage} bf16 x "
                                     f"{name}: max |err| {e:.3e} over {tol}"
                                     f" x max {scale:.3e}")
        say(f"[2] fused_mlp_train {stage} bf16 x: y and dx in bf16 within "
            f"{BF16_MLP_TOL} x max of plain, weight gradients f32 within "
            f"{MLP_TOL} x max")
        del got, want, xb, dyb
    rel = max(v[0] for v in errs.values())
    rel64 = max(v[1] for v in errs.values())

    ms = time_ms(lambda: fused_mlp_train_fwd(*args, DROPOUT))
    plain = time_ms(lambda: fused_mlp_train_plain(*args, DROPOUT))
    lib = time_ms(lambda: mlp_train_library(x, w1, b1, w2, b2, DROPOUT))
    work = (4.0 * n * d * hd, 4.0 * (2 * n * d + 2 * d * hd + hd + d) + 8)
    b_ms, b_by = bound(*work)
    frow = dict(stage=stage, shape=[n, d, hd], ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                bound_tc_ms=bound_tc(*work), max_rel_err=rel,
                max_rel_err_f64=rel64)
    bms = time_ms(lambda: fused_mlp_train_bwd(*args, DROPOUT, dy))
    bplain = time_ms(lambda: fused_mlp_train_bwd_plain(*args, DROPOUT, dy))
    leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    out = mlp_train_library(*leaves, DROPOUT)
    blib = time_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                               retain_graph=True))
    del out, leaves
    bwork = (10.0 * n * d * hd,
             4.0 * (3 * n * d + 2 * (2 * d * hd + hd + d)) + 8)
    bb_ms, bb_by = bound(*bwork)
    scratch, predicted, slots = mlp_bwd_scratch(
        stage, lambda: fused_mlp_train_bwd(*args, DROPOUT, dy), n, d, hd,
        limit)
    brow = dict(stage=stage, shape=[n, d, hd], ms=bms, plain_ms=bplain,
                library_ms=blib, bound_ms=bb_ms, bound_by=bb_by,
                bound_tc_ms=bound_tc(*bwork), scratch_bytes=scratch,
                scratch_predicted_bytes=predicted, scratch_limit=limit,
                max_rel_err=rel, max_rel_err_f64=rel64)
    if d in CHUNKED_WIDTHS:
        brow["chunk_rows"] = train_chunk_rows(n, d)
        plan = (f"W1^T and two chunks' arrays, chunks of "
                f"{brow['chunk_rows']} rows")
    else:
        brow.update(slots=slots, weight_blocks=slots * hd // 64)
        plan = (f"packed weights and {slots} row slots of partials, "
                f"{brow['weight_blocks']} weight blocks")
    say(f"[2] fused_mlp_train {stage} N{n} D{d} Hd{hd} (rates {DROPOUT} "
        f"and 0; two backward calls bit-equal): max |err| / max |ref| "
        f"{rel:.2e} (vs f64 {rel64:.2e})  forward kernel {ms:.3f} ms  "
        f"plain {plain:.3f} ms  addmm+gelu+dropout+addmm+dropout "
        f"{lib:.3f} ms  bound {b_ms:.3f} ms ({b_by}), on the tensor cores "
        f"{frow['bound_tc_ms']:.3f} ms;  backward kernel "
        f"{bms:.3f} ms (scratch {scratch} bytes measured, {predicted} "
        f"predicted, limit {limit}: {plan})  "
        f"plain {bplain:.3f} ms  "
        f"autograd of that graph {blib:.3f} ms  bound {bb_ms:.3f} ms "
        f"({bb_by}), on the tensor cores {brow['bound_tc_ms']:.3f} ms")
    if d in CHUNKED_WIDTHS:
        # each kernel's device time in a forward and a backward call
        frow["kernels_ms"] = kernel_split(
            lambda: fused_mlp_train_fwd(*args, DROPOUT), call_ms=ms)
        brow["kernels_ms"] = kernel_split(
            lambda: fused_mlp_train_bwd(*args, DROPOUT, dy), call_ms=bms)
        for what, row in (("forward", frow), ("backward", brow)):
            say(f"[2] fused_mlp_train {stage} {what}, device ms per call by "
                f"kernel (profiler, 3 calls): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in row["kernels_ms"].items()))
    worst_f = max(errs[(r, "y")][2] for r in (DROPOUT, 0.0))
    worst_b = max(v[2] for k, v in errs.items() if k[1] != "y")
    return frow, brow, worst_f, worst_b


def kernel_split(fn, calls=3, call_ms=None):
    """{kernel name: device ms per call of fn}, summed by torch.profiler
    over `calls` calls after one more.  The profiler has been seen to keep
    only some calls' events: with `call_ms`, fn's time on CUDA events, a
    session whose kernels add up to less than half of it is taken again,
    up to three sessions."""
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].split("::")[-1]
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / calls)
        if call_ms is None or sum(out.values()) >= call_ms / 2:
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


RAGGED_ROWS = 3 * 197  # a ragged N: two chunks and a part at D 768


def mlp_train_ragged(dev, gen, d):
    """The training MLP at a ragged N (RAGGED_ROWS) and width D: forward and
    backward at rates 0.1 and 0 within MLP_TOL of plain and of float64, two
    backward calls bit-equal, the backward's scratch within its limit.
    Returns the worst relative error and the scratch bytes."""
    n, hd = RAGGED_ROWS, 4 * d
    x = torch.randn(n, d, device=dev, generator=gen)
    w1 = torch.randn(d, hd, device=dev, generator=gen) / d ** 0.5
    b1 = 0.1 * torch.randn(hd, device=dev, generator=gen)
    w2 = torch.randn(hd, d, device=dev, generator=gen) / hd ** 0.5
    b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
    dy = torch.randn(n, d, device=dev, generator=gen)
    seed = torch.randint(0, 2 ** 31 - 1, (2,), device=dev, generator=gen,
                         dtype=torch.int32)
    args = (x, w1, b1, w2, b2, seed)
    worst = 0.0
    for rate in (DROPOUT, 0.0):
        got = (fused_mlp_train_fwd(*args, rate),
               *fused_mlp_train_bwd(*args, rate, dy))
        if not all(map(torch.equal, got[1:],
                       fused_mlp_train_bwd(*args, rate, dy))):
            raise AssertionError(f"fused_mlp_train_bwd N{n} D{d}: two calls "
                                 "on the same inputs differ")
        want = (fused_mlp_train_plain(*args, rate),
                *fused_mlp_train_bwd_plain(*args, rate, dy))
        a64 = [t.double() for t in args[:5]] + [seed]
        want64 = (fused_mlp_train_plain(*a64, rate),
                  *fused_mlp_train_bwd_plain(*a64, rate, dy.double()))
        for name, g, w, w64 in zip(("y", "dx", "dW1", "db1", "dW2", "db2"),
                                   got, want, want64):
            scale = w.abs().max().item()
            e = max((g - w).abs().max().item(),
                    (g.double() - w64).abs().max().item())
            if not torch.isfinite(g).all() or e > MLP_TOL * scale:
                raise AssertionError(f"fused_mlp_train N{n} D{d} rate {rate} "
                                     f"{name}: max |err| {e:.3e} over "
                                     f"{MLP_TOL} x max {scale:.3e}")
            worst = max(worst, e / scale)
    limit = VIT_SCRATCH_LIMIT if d == 768 else SCRATCH_LIMIT
    scratch, _, _ = mlp_bwd_scratch(
        f"N{n}", lambda: fused_mlp_train_bwd(*args, DROPOUT, dy), n, d, hd,
        limit)
    say(f"[2] fused_mlp_train ragged N{n} D{d} (chunks of "
        f"{train_chunk_rows(n, d)} rows; rates {DROPOUT} and 0, two backward "
        f"calls bit-equal): max |err| / max |ref| {worst:.2e} against plain "
        f"and f64; scratch {scratch} bytes (limit {limit})")
    return dict(shape=[n, d, hd], max_rel_err=worst, scratch_bytes=scratch)


def phase_mlp_train(dev, gen):
    """fused_mlp_train forward and backward at the three stage shapes
    (``mlp_train_shape``; stage 1 also checks the masks), one backward at
    the 512px stage 1, and the ViT widths D 192, 384 and 768 at their
    models' B 64 (N 12,608), masks and bf16 x included."""
    frows, brows, worst = [], [], {"fwd": 0.0, "bwd": 0.0}
    for stage, n, d in MLP_SHAPES:
        frow, brow, wf, wb = mlp_train_shape(dev, gen, stage, n, d,
                                             masks=stage == "stage1")
        frows.append(frow)
        brows.append(brow)
        worst["fwd"] = max(worst["fwd"], wf)
        worst["bwd"] = max(worst["bwd"], wb)
    big = mlp_train_bwd_512px(dev, gen)
    vrows = {"fwd": [], "bwd": []}
    for model, d in VIT_MLP_SHAPES:
        frow, brow, _, _ = mlp_train_shape(
            dev, gen, model, VIT_MLP_ROWS, d, masks=True, bf16=True,
            limit=SCRATCH_LIMIT if d < 768 else VIT_SCRATCH_LIMIT)
        if d in CHUNKED_WIDTHS:
            brow["ragged"] = mlp_train_ragged(dev, gen, d)
        vrows["fwd"].append(frow)
        vrows["bwd"].append(brow)
    out = []
    fsum = {k: sum(r[k] for r in frows)
            for k in ("ms", "plain_ms", "library_ms", "bound_tc_ms")}
    say(f"[2] fused_mlp_train forward summed over the three stages at rate "
        f"{DROPOUT} (the weights split at every call included): kernel "
        f"{fsum['ms']:.3f} ms (the f32-FMA design it replaces: 1.219 / "
        f"1.250 ms in PERF.md's table)  plain {fsum['plain_ms']:.3f} ms  "
        f"addmm+gelu+dropout+addmm+dropout {fsum['library_ms']:.3f} ms  "
        f"bound on the tensor cores {fsum['bound_tc_ms']:.3f} ms")
    for name, rows, line, key, source in (
            ("fused_mlp_train", frows, 170, "fwd", "fused_mlp.cu"),
            ("fused_mlp_train_bwd", brows, 189, "bwd",
             "fused_mlp_train.cu")):
        # the CvT widths' kernels (source) and, at D 384 and 768, the
        # chunked products (vit_source)
        # per slot-step every stage reaches the kernel once: the sums
        out.append(dict(
            name=name, route="cuda",
            source=f"transformer_stm_tpu_torch/csrc/{source}",
            replaces=f"transformer_stm_tpu/kernels/fused_mlp.py:{line}",
            max_abs_err=worst[key],
            max_rel_err=max(r["max_rel_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="operations",
            bound_tc_ms=sum(r["bound_tc_ms"] for r in rows),
            library_ms=sum(r["library_ms"] for r in rows), shapes=rows,
            vit_shapes=vrows[key],
            vit_source=("transformer_stm_tpu_torch/csrc/fused_mlp_train.cu + "
                        "csrc/chunk_gemm.cuh")))
    out[-1]["at_512px_stage1"] = big
    return out


def mlp_bwd_scratch(what, call, n, d, hd, limit=SCRATCH_LIMIT):
    """(measured scratch bytes of one training-MLP backward, the bytes
    that train_bwd_scratch predicts, its row slots); raises when the
    measured scratch passes ``limit``."""
    scratch = scratch_bytes(call)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    predicted = 4 * sum(train_bwd_scratch(n, d, hd, sms))
    if scratch > limit:
        raise AssertionError(f"fused_mlp_train_bwd {what} N{n} D{d}: scratch "
                             f"{scratch} bytes over {limit}")
    return scratch, predicted, train_bwd_slots(n, hd, sms)


def mlp_train_bwd_512px(dev, gen):
    """One training-MLP backward at the 512px CvT's stage 1 (N 2,097,152 =
    128 images x 16,384 tokens, D 64) against its plain version at rate
    0.1: the scratch that the partials need stays bounded there."""
    n, d = BATCH * FLASH_SHAPE[1], 64
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
    got = fused_mlp_train_bwd(*args, DROPOUT, dy)
    want = fused_mlp_train_bwd_plain(*args, DROPOUT, dy)
    torch.cuda.synchronize()
    rel = 0.0
    for name, g, w in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        scale = w.abs().max().item()
        e = (g - w).abs().max().item()
        if not torch.isfinite(g).all() or e > MLP_TOL * scale:
            raise AssertionError(f"fused_mlp_train_bwd N{n} D{d} {name}: max "
                                 f"|err| {e:.3e} over {MLP_TOL} x max "
                                 f"{scale:.3e}")
        rel = max(rel, e / scale)
    del got, want
    ms = time_ms(lambda: fused_mlp_train_bwd(*args, DROPOUT, dy), reps=5)
    scratch, predicted, slots = mlp_bwd_scratch(
        "512px stage1", lambda: fused_mlp_train_bwd(*args, DROPOUT, dy), n, d,
        hd)
    say(f"[2] fused_mlp_train_bwd at the 512px stage 1, N{n} D{d} Hd{hd}, rate "
        f"{DROPOUT}: max |err| / max |ref| {rel:.2e} against plain  kernel "
        f"{ms:.3f} ms  scratch {scratch} bytes measured, {predicted} "
        f"predicted ({slots} row slots)")
    return dict(shape=[n, d, hd], ms=ms, scratch_bytes=scratch,
                scratch_predicted_bytes=predicted, slots=slots,
                max_rel_err=rel)


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


def rel_err(got, ref):
    """max |got - ref| over max |ref|, in float64."""
    return ((got.double() - ref.double()).abs().max() /
            ref.double().abs().max()).item()


def check_rel(what, got, ref, tol=FLASH_TOL):
    e = rel_err(got, ref)
    if not torch.isfinite(got).all() or e > tol:
        raise AssertionError(f"{what}: max |err| / max |ref| {e:.3e} over "
                             f"{tol}")
    return e


def check_chunks(what, got, plain, inputs):
    """Holds kernel outputs at the main path's batch against the plain
    version on the same inputs, CHECK_BATCH images at a time so that the
    plain version's (T, S) scores fit.  got: (name, output, index of the
    plain output it equals); plain(*inputs) returns a tuple.  Each chunk is
    held by check_rel to its own max |ref|, no weaker a bar than the whole
    batch's.  Returns the worst max |err| / max |ref|."""
    worst, b = 0.0, inputs[0].shape[0]
    for i in range(0, b, CHECK_BATCH):
        sl = slice(i, min(i + CHECK_BATCH, b))
        ref = plain(*(x[sl] for x in inputs))
        worst = max(worst, *(check_rel(
            f"{what} {name} (images {sl.start}-{sl.stop - 1})", x[sl],
            ref[j]) for name, x, j in got))
        del ref
    return worst


def sdpa(q, k, v):
    """One PyTorch call of the same function: scaled_dot_product_attention
    on its memory-efficient backend, the one that takes f32 at these
    lengths (it fails here rather than fall back to a backend that would
    hold the (T, S) scores)."""
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def attn_inputs(gen, b, t, s, h, dh, dev="cuda"):
    return [torch.randn(b, n, h, dh, device=dev, generator=gen)
            for n in (t, s, s, t)]


def flash_checks(what, q, k, v, g, f64_batch):
    """flash_attention forward with and without lse and backward against
    the plain versions in f32 and, on the first f64_batch images, in
    float64; two backward calls bit-equal.  Returns (forward error, backward
    error) relative to the largest entry, the worst of f32 and f64."""
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    o_inf, none = flash_attention_fwd(q, k, v)
    d = flash_attention_bwd(q, k, v, o, lse, g)
    if none is not None or not all(
            map(torch.equal, d, flash_attention_bwd(q, k, v, o, lse, g))):
        raise AssertionError(f"flash_attention_bwd {what}: two calls on the "
                             "same inputs differ")
    po, plse = flash_attention_plain(q, k, v, with_lse=True)
    pd = flash_attention_bwd_plain(q, k, v, o, lse, g)
    efwd = max(check_rel(f"flash_attention {what} o", o, po),
               check_rel(f"flash_attention {what} o without lse", o_inf, po),
               check_rel(f"flash_attention {what} lse", lse, plse))
    ebwd = max(check_rel(f"flash_attention_bwd {what} {n}", x, y)
               for n, x, y in zip(("dq", "dk", "dv"), d, pd))
    del po, plse, pd
    n = f64_batch
    q64, k64, v64, g64 = (x[:n].double() for x in (q, k, v, g))
    po, plse = flash_attention_plain(q64, k64, v64, with_lse=True)
    pd = flash_attention_bwd_plain(q64, k64, v64, po, plse, g64)
    efwd = max(efwd, check_rel(f"flash_attention {what} o (f64)", o[:n], po),
               check_rel(f"flash_attention {what} o without lse (f64)",
                         o_inf[:n], po),
               check_rel(f"flash_attention {what} lse (f64)", lse[:n], plse))
    ebwd = max(ebwd, *(check_rel(f"flash_attention_bwd {what} {nm} (f64)",
                                 x[:n], y)
                       for nm, x, y in zip(("dq", "dk", "dv"), d, pd)))
    return efwd, ebwd


def attn_work(b, t, s, h, dh):
    """(forward, backward) work as (flops, bytes): 4 and 10 units of
    B*H*T*S*Dh flops; q, k, v, o (and lse) read or written once forward,
    q, k, v, o, dO, lse read and dq, dk, dv written backward."""
    return ((4.0 * b * h * t * s * dh,
             4.0 * (2 * b * t * h * dh + 2 * b * s * h * dh + b * h * t)),
            (10.0 * b * h * t * s * dh,
             4.0 * (6 * b * t * h * dh + 3 * b * s * h * dh + b * h * t)))


def attn_bounds(b, t, s, h, dh):
    """(forward, backward) least times in f32 FMA, each (ms, bound by)."""
    return tuple(bound(*w) for w in attn_work(b, t, s, h, dh))


def attn_bounds_tc(b, t, s, h, dh):
    """(forward, backward) least times on the tensor cores in 3xTF32."""
    return tuple(bound_tc(*w) for w in attn_work(b, t, s, h, dh))


def lib_bwd(q, k, v, g):
    """A closure that times SDPA's backward on a graph built once."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = sdpa(*leaves)
    gt = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True)


def phase_flash(dev, gen):
    """flash_attention at odd shapes for every chunk count of Dh, at the
    512px stage-1 shape against plain (batch CHECK_BATCH, float64 on
    CHECK_BATCH_F64 images), and at the main path's batch against plain
    (CHECK_BATCH images at a time), timed there beside its plain version and
    SDPA on the same inputs."""
    worst_f = worst_b = 0.0
    for dh in ODD_DH:
        b, t, s, h = ODD_SHAPE
        ef, eb = flash_checks(f"B{b} T{t} S{s} H{h} Dh{dh}",
                              *attn_inputs(gen, b, t, s, h, dh), f64_batch=b)
        worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
        say(f"[2] flash_attention B{b} T{t} S{s} H{h} Dh{dh}: forward (with "
            f"and without lse) max|err|/max|ref| {ef:.2e}, backward {eb:.2e} "
            "(f32 and f64; two backward calls bit-equal)")
    _, s, h = FLASH_SHAPE
    ef, eb = flash_checks(f"B{CHECK_BATCH} S{s} H{h} Dh64",
                          *attn_inputs(gen, CHECK_BATCH, s, s, h, 64),
                          f64_batch=CHECK_BATCH_F64)
    worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
    say(f"[2] flash_attention B{CHECK_BATCH} S{s} H{h} Dh64: forward max|err|"
        f"/max|ref| {ef:.2e}, backward {eb:.2e} (f32; f64 on "
        f"{CHECK_BATCH_F64} images)")

    b = FLASH_SHAPE[0]
    q, k, v, g = attn_inputs(gen, b, s, s, h, 64)
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    o_inf = flash_attention(q, k, v)
    d = flash_attention_bwd(q, k, v, o, lse, g)
    what = f"flash_attention B{b} S{s} H{h} Dh64"
    ef = check_chunks(what, [("o", o, 0), ("o without lse", o_inf, 0),
                             ("lse", lse, 1)],
                      lambda *x: flash_attention_plain(*x, with_lse=True),
                      (q, k, v))
    eb = check_chunks(f"{what} backward", list(zip(("dq", "dk", "dv"), d,
                                                   range(3))),
                      flash_attention_bwd_plain, (q, k, v, o, lse, g))
    worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
    del o_inf, d
    say(f"[2] {what} (the main path's shape): forward (with and without "
        f"lse) max|err|/max|ref| {ef:.2e}, backward {eb:.2e} (f32, "
        f"{CHECK_BATCH} images a check)")
    ms_inf = time_ms(lambda: flash_attention(q, k, v))
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, with_lse=True))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, with_lse=True),
                    reps=3, warmup=1)
    lib = time_ms(lambda: sdpa(q, k, v))
    bms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, g))
    bplain = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, g),
                     reps=3, warmup=1)
    blib = time_ms(lib_bwd(q, k, v, g))
    (f_ms, f_by), (b_ms, b_by) = attn_bounds(b, s, s, h, 64)
    f_tc, b_tc = attn_bounds_tc(b, s, s, h, 64)
    say(f"[2] flash_attention B{b} S{s} H{h} Dh64 (the main path's shape): "
        f"forward {ms_inf:.2f} ms, with lse {ms:.2f} ms  plain {plain:.2f} "
        f"ms  sdpa {lib:.2f} ms  bound {f_ms:.2f} ms ({f_by}), on the "
        f"tensor cores {f_tc:.2f} ms;  backward {bms:.2f} ms  plain "
        f"{bplain:.2f} ms  sdpa backward {blib:.2f} ms  bound {b_ms:.2f} ms "
        f"({b_by}), on the tensor cores {b_tc:.2f} ms")
    del q, k, v, g, o, lse
    shape = [b, s, s, h, 64]
    common = dict(route="cuda",
                  replaces="transformer_stm_tpu/kernels/flash_attention.py:48",
                  source="transformer_stm_tpu_torch/csrc/flash_attention.cu")
    return [
        dict(name="flash_attention", **common, max_abs_err=worst_f,
             err_is="max |err| / max |ref|, f32 and f64", ms=ms,
             ms_inference=ms_inf, plain_ms=plain, library_ms=lib,
             bound_ms=f_ms, bound_by=f_by, bound_tc_ms=f_tc, shape=shape),
        dict(name="flash_attention_bwd", route="cuda",
             source="transformer_stm_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="transformer_stm_tpu/kernels/flash_attention.py:185",
             also_replaces=[f"transformer_stm_tpu/kernels/flash_attention.py:"
                            f"{n}" for n in (221, 388, 429)],
             max_abs_err=worst_b,
             err_is="max |err| / max |ref|, f32 and f64", ms=bms,
             plain_ms=bplain, library_ms=blib, bound_ms=b_ms, bound_by=b_by,
             bound_tc_ms=b_tc, shape=shape)]


def phase_small_512(dev, gen, results):
    """attention_small forward (with and without lse) and backward at the
    512px stages 2 and 3, against plain at CHECK_BATCH images (float64 on
    CHECK_BATCH_F64), the kernel, plain and SDPA timed there, and at the
    main path's batch against plain (CHECK_BATCH images at a time), the
    kernel and SDPA timed there.  The rows join the kernels' ``shapes``."""
    by_name = {r["name"]: r for r in results}
    for stage, b, s, h in SMALL_512_SHAPES:
        q, k, v, g = attn_inputs(gen, CHECK_BATCH, s, s, h, 64)
        o, lse = attention_small_fwd(q, k, v, with_lse=True)
        o_inf = attention_small(q, k, v)
        d = attention_small_bwd(q, k, v, o, lse, g)
        if not all(map(torch.equal, d,
                       attention_small_bwd(q, k, v, o, lse, g))):
            raise AssertionError(f"attention_small_bwd 512px {stage}: two "
                                 "calls on the same inputs differ")
        po, plse = attention_small_plain(q, k, v, with_lse=True)
        pd = attention_small_bwd_plain(q, k, v, o, lse, g)
        n = CHECK_BATCH_F64
        q64, k64, v64, g64 = (x[:n].double() for x in (q, k, v, g))
        po64, plse64 = attention_small_plain(q64, k64, v64, with_lse=True)
        pd64 = attention_small_bwd_plain(q64, k64, v64, po64, plse64, g64)
        what = f"attention_small 512px {stage} B{CHECK_BATCH} S{s} H{h}"
        ef = max(check_rel(f"{what} o", o, po),
                 check_rel(f"{what} o without lse", o_inf, po),
                 check_rel(f"{what} lse", lse, plse),
                 check_rel(f"{what} o (f64)", o[:n], po64),
                 check_rel(f"{what} o without lse (f64)", o_inf[:n], po64),
                 check_rel(f"{what} lse (f64)", lse[:n], plse64))
        eb = max(*(check_rel(f"{what} backward {nm}", x, y)
                   for nm, x, y in zip("qkv", d, pd)),
                 *(check_rel(f"{what} backward {nm} (f64)", x[:n], y)
                   for nm, x, y in zip("qkv", d, pd64)))
        del po, plse, pd, po64, plse64, pd64, q64, k64, v64, g64
        rows = {}
        for tag, bb in (("check", CHECK_BATCH), ("main", b)):
            if bb != CHECK_BATCH:
                q, k, v, g = attn_inputs(gen, bb, s, s, h, 64)
                o, lse = attention_small_fwd(q, k, v, with_lse=True)
                o_inf = attention_small(q, k, v)
                d = attention_small_bwd(q, k, v, o, lse, g)
                ef = max(ef, check_chunks(
                    f"attention_small 512px {stage} B{bb} S{s} H{h}",
                    [("o", o, 0), ("o without lse", o_inf, 0),
                     ("lse", lse, 1)],
                    lambda *x: attention_small_plain(*x, with_lse=True),
                    (q, k, v)))
                eb = max(eb, check_chunks(
                    f"attention_small_bwd 512px {stage} B{bb} S{s} H{h}",
                    list(zip(("dq", "dk", "dv"), d, range(3))),
                    attention_small_bwd_plain, (q, k, v, o, lse, g)))
                del o_inf, d
            (f_ms, f_by), (b_ms, b_by) = attn_bounds(bb, s, s, h, 64)
            f_tc, b_tc = attn_bounds_tc(bb, s, s, h, 64)
            r = dict(ms=time_ms(lambda: attention_small_fwd(
                         q, k, v, with_lse=True)),
                     ms_inference=time_ms(lambda: attention_small(q, k, v)),
                     library_ms=time_ms(lambda: sdpa(q, k, v)),
                     bound_ms=f_ms, bound_by=f_by, bound_tc_ms=f_tc,
                     bwd_ms=time_ms(lambda: attention_small_bwd(
                         q, k, v, o, lse, g)),
                     bwd_library_ms=time_ms(lib_bwd(q, k, v, g)),
                     bwd_bound_ms=b_ms, bwd_bound_by=b_by,
                     bwd_bound_tc_ms=b_tc)
            if tag == "check":  # the plain versions hold (T, S) scores
                r["plain_ms"] = time_ms(lambda: attention_small_plain(
                    q, k, v, with_lse=True))
                r["bwd_plain_ms"] = time_ms(lambda: attention_small_bwd_plain(
                    q, k, v, o, lse, g))
            rows[bb] = r
        del q, k, v, g, o, lse
        for name, key, err in (("attention_small", "", ef),
                               ("attention_small_bwd", "bwd_", eb)):
            for bb, r in rows.items():
                row = dict(stage=f"512px {stage}", shape=[bb, s, h, 64],
                           ms=r[key + "ms"],
                           plain_ms=r.get(key + "plain_ms"),
                           library_ms=r[key + "library_ms"],
                           bound_ms=r[key + "bound_ms"],
                           bound_by=r[key + "bound_by"],
                           bound_tc_ms=r[key + "bound_tc_ms"],
                           max_rel_err=err)
                if not key:
                    row["ms_inference"] = r["ms_inference"]
                by_name[name]["shapes"].append(row)
        c, m = rows[CHECK_BATCH], rows[b]
        say(f"[2] attention_small 512px {stage} S{s} H{h}: forward max|err|/"
            f"max|ref| {ef:.2e}, backward {eb:.2e} (B{CHECK_BATCH} f32, "
            f"B{CHECK_BATCH_F64} f64, B{b} f32 {CHECK_BATCH} images a check; "
            f"two backward calls bit-equal); "
            f"B{CHECK_BATCH}: forward {c['ms_inference']:.3f} ms, with lse "
            f"{c['ms']:.3f}  plain {c['plain_ms']:.3f}  sdpa "
            f"{c['library_ms']:.3f}  bound {c['bound_ms']:.3f}; backward "
            f"{c['bwd_ms']:.3f}  plain {c['bwd_plain_ms']:.3f}  sdpa "
            f"{c['bwd_library_ms']:.3f}  bound {c['bwd_bound_ms']:.3f}; "
            f"B{b}: forward {m['ms_inference']:.2f} ms, with lse "
            f"{m['ms']:.2f}  sdpa {m['library_ms']:.2f}  bound "
            f"{m['bound_ms']:.2f}; backward {m['bwd_ms']:.2f}  sdpa "
            f"{m['bwd_library_ms']:.2f}  bound {m['bwd_bound_ms']:.2f}, on "
            f"the tensor cores {m['bwd_bound_tc_ms']:.2f}")


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
    want = {**zero_launches(), "attention_small": n_batches, "attention_small_bwd": 0,
            "fused_mlp": 3 * n_batches, "fused_mlp_train": 0,
            "fused_mlp_train_bwd": 0, "flash_attention": 0,
            "flash_attention_bwd": 0}
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
    want = {**zero_launches(), "attention_small": steps + EPOCHS, "attention_small_bwd": steps,
            "fused_mlp": 3 * EPOCHS, "fused_mlp_train": 0,
            "fused_mlp_train_bwd": 0, "flash_attention": 0,
            "flash_attention_bwd": 0}
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

    # The same in bf16 compute: the images and process parameters cast to
    # bf16, the parameters, Adam state and loss f32.
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    losses16 = {}
    for impl in ("auto", "plain"):
        before = read_launches()
        model = from_jax_params(params, state, spec0, device="cuda")
        opt = adam_init(model)
        step = make_train_step(cfg16, impl=impl)
        losses16[impl] = [step(model, opt, batch, None, cfg.learning_rate)
                          ["loss"].item() for _ in range(TRAIN_STEPS)]
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = {**zero_launches(), **({"attention_small": TRAIN_STEPS,
                                       "attention_small_bwd": TRAIN_STEPS}
                                      if impl == "auto" else {})}
        if got != want:
            raise AssertionError(f"bf16 {impl} training launches {got}, "
                                 f"want {want}")
    la, lp = np.asarray(losses16["auto"]), np.asarray(losses16["plain"])
    if not np.isfinite(la).all() or \
            (np.abs(la - lp) > BF16_LOSS_TOL * np.abs(lp)).any():
        raise AssertionError(f"bf16 training losses, kernel path {la} vs "
                             f"plain path {lp}")
    say(f"[4] {TRAIN_STEPS} steps in bf16 at dropout 0, kernel path vs "
        f"plain path: losses {la.tolist()} vs {lp.tolist()}, max rel diff "
        f"{(np.abs(la - lp) / np.abs(lp)).max():.2e} (limit "
        f"{BF16_LOSS_TOL}); f32 losses {losses['plain']}")

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

    # predict(exact=True) under a bf16 config runs f32: bit for bit the f32
    # config's prediction; without exact it runs bf16.
    loop16 = TrainLoop(spec, cfg16, device="cuda", model=loop.model)
    e16, p16 = loop16.predict(*val[:2], exact=True), loop16.predict(*val[:2])
    if not np.array_equal(e16, a) or not np.isfinite(p16).all() or \
            np.abs(p16 - a).max() > BF16_OUT_TOL * max(1.0, np.abs(a).max()):
        raise AssertionError(f"bf16 predict: exact max |diff| "
                             f"{np.abs(e16 - a).max():.3e}, bf16 "
                             f"{np.abs(p16 - a).max():.3e}")
    say(f"[4] predict under the bf16 config: exact=True equals the f32 "
        f"config's bit for bit; bf16 max |diff| {np.abs(p16 - a).max():.3e} "
        f"(|y| up to {np.abs(a).max():.3f})")
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
    want = {**zero_launches(), "attention_small": slot_steps + val_batches,
            "attention_small_bwd": slot_steps, "fused_mlp": 3 * val_batches,
            "fused_mlp_train": 3 * slot_steps,
            "fused_mlp_train_bwd": 3 * slot_steps, "flash_attention": 0,
            "flash_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"multi-target launches {launches}, want {want}")
    if [o.step for o in tr.opts] != [MULTI_EPOCHS * int(n)
                                     for n in live_steps] or \
            not np.isfinite(np.asarray(tr.records, np.float64)).all():
        raise AssertionError(f"Adam counts {[o.step for o in tr.opts]}, "
                             f"records {tr.records}")

    # One epoch with on-device augmentation (AugmentConfig()): the same
    # launches per slot-step and validation batch.
    aug = multi_trainer(data, corpus, root, mlp_impl="pallas",
                        augment=AugmentConfig())
    reset_launches()
    aug.fit(1, verbose=False)
    got = read_launches()
    want1 = {**zero_launches(), **{k: v // MULTI_EPOCHS
                                   for k, v in want.items()}}
    if got != want1 or not np.isfinite(np.asarray(aug.records,
                                                  np.float64)).all():
        raise AssertionError(f"augmented epoch: launches {got}, want "
                             f"{want1}; records {aug.records}")
    say(f"[5] one epoch with AugmentConfig(): launches {got}; slot losses "
        f"{[r[-1][1] for r in aug.records]} (unaugmented epoch 1: "
        f"{[r[0][1] for r in tr.records]})")
    del aug

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
    # the largest kernel of a slot-step is a torch reduction: what runs it
    srcs = kernel_sources(one_step, "reduce_kernel")
    say("[5] reduce_kernel per slot-step, by the op that launches it: " +
        "; ".join(f"{chain} {shapes} {ms / len(tr.targets):.3f} ms"
                  for (chain, shapes), ms in srcs))
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


def cli_fixture(root):
    """CLI_GROUPS x 5 pieces x CLI_LAYERS synthetic 512x512 images, written
    straight into the decode cache in the shared layout (so that no JPEG
    decoder, cv2, is needed), with label and process sheets written by the
    port's xlsx writer.  The first piece of each group validates, so
    4 * CLI_GROUPS * CLI_LAYERS images train."""
    rng = np.random.default_rng(SEED + 4)
    n_spec = CLI_GROUPS * 5
    data = DataConfig(data_root=os.path.join(root, "data"),
                      excel_labels=os.path.join(root, "labels.xlsx"),
                      excel_process=os.path.join(root, "process.xlsx"),
                      group_end=CLI_GROUPS, image_layers=CLI_LAYERS,
                      image_height=512, image_width=512,
                      cache_dir=os.path.join(root, "cache"))
    os.makedirs(data.cache_dir)
    npy, meta = _cache_paths(data)
    corpus = np.lib.format.open_memmap(
        npy, mode="w+", dtype=np.uint8, shape=(n_spec, CLI_LAYERS, 512, 512))
    corpus[:] = rng.integers(0, 256, corpus.shape, dtype=np.uint8)
    base = corpus.mean(axis=(1, 2, 3)) / 255.0  # a learnable label
    corpus.flush()
    del corpus
    with open(meta, "w") as f:
        json.dump({"decoded": list(range(n_spec))}, f)
    write_xlsx(data.excel_labels, {"Sheet1": [["No.", CLI_TARGET]] + [
        [i + 1, float(1.0 + base[i] + i // 5)] for i in range(n_spec)]})
    write_xlsx(data.excel_process, {"Sheet1": [list(PROCESS_PARAMETERS)] +
                                    rng.uniform(0.5, 3.0, (CLI_GROUPS, 5))
                                    .tolist()})
    return data


def cli_launches(argv):
    """cli.main(argv) with every count set to 0 just before it; the counts
    just after, and the seconds it took (host clock)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    return read_launches(), time.perf_counter() - t0


def phase_cli():
    """The 512px CvT trained and tested through the command line, as a user
    runs it, with exact launch counts and a resume; then its step and
    evaluation times and memory, and the kernel path against the plain
    path at 512px."""
    from transformer_stm_tpu_torch.data.xlsx import read_table
    from transformer_stm_tpu_torch.harness import _paths

    root = tempfile.mkdtemp()
    data = cli_fixture(root)
    spec = cvt_highres_spec(512)
    cfg = ExperimentConfig(
        frequencies=(CLI_TARGET,), model=spec, data=data,
        train=TrainConfig(batch_size=BATCH, epochs=CLI_EPOCHS, seed=SEED,
                          checkpoint_every=1),
        result_dir=os.path.join(root, "Result"))
    cfg_path = os.path.join(root, "config_512.json")
    save_config(cfg, cfg_path)
    n_train, n_val = 4 * CLI_GROUPS * CLI_LAYERS, CLI_GROUPS * CLI_LAYERS
    steps, val_batches = -(-n_train // BATCH), -(-n_val // BATCH)
    say(f"[6] CLI, CvT at 512px, dropout {DROPOUT}, batch {BATCH}: "
        f"{n_train} train and {n_val} validation images, {steps} steps per "
        "epoch")

    torch.cuda.reset_peak_memory_stats()
    train, dt = cli_launches(["train", "--config", cfg_path])
    test, dt_test = cli_launches(["test", "--config", cfg_path])
    peak_cli = torch.cuda.max_memory_allocated()
    n_steps = CLI_EPOCHS * steps
    evals = CLI_EPOCHS * val_batches
    want_train = {**zero_launches(), "attention_small": 2 * (n_steps + evals),
                  "attention_small_bwd": 2 * n_steps,
                  "fused_mlp": 3 * evals, "fused_mlp_train": 0,
                  "fused_mlp_train_bwd": 0,
                  "flash_attention": n_steps + evals,
                  "flash_attention_bwd": n_steps}
    want_test = {**zero_launches(), "attention_small": 2 * val_batches, "attention_small_bwd": 0,
                 "fused_mlp": 3 * val_batches, "fused_mlp_train": 0,
                 "fused_mlp_train_bwd": 0, "flash_attention": val_batches,
                 "flash_attention_bwd": 0}
    say(f"[6] train: {CLI_EPOCHS} epochs in {dt:.2f} s, launches {train}; "
        f"test in {dt_test:.2f} s, launches {test} (host clock; peak device "
        f"memory {peak_cli / 2**30:.2f} GiB)")
    if train != want_train or test != want_test:
        raise AssertionError(f"CLI launches: train {train}, want "
                             f"{want_train}; test {test}, want {want_test}")
    paths = _paths(cfg, CLI_TARGET)
    _, records = read_table(paths["records"])
    sheet = read_predictions_metrics(paths["metrics"])
    if [r[0] for r in records] != list(range(1, CLI_EPOCHS + 1)) or \
            not np.isfinite(np.asarray([r[1:] for r in records],
                                       np.float64)).all():
        raise AssertionError(f"records sheet: {records}")
    if sheet["header"] != HEADER or len(sheet["predictions"]) != n_val or \
            not np.isfinite(sheet["predictions"]).all() or \
            not np.isfinite(sheet["r2"]):
        raise AssertionError(f"metrics sheet: {len(sheet['predictions'])} "
                             f"rows, r2 {sheet['r2']}")
    say(f"[6] records {records}; metrics sheet: {n_val} rows, R2 "
        f"{sheet['r2']:.4f} MSE {sheet['mse']:.4f} MAE {sheet['mae']:.4f}")

    # A second train with --epochs 3 resumes from the epoch-2 checkpoint.
    ckpts = paths["weights"] + ".ckpts"
    resumed, _ = cli_launches(["train", "--config", cfg_path, "--epochs",
                               str(CLI_EPOCHS + 1)])
    _, records = read_table(paths["records"])
    final = latest_checkpoint(paths["weights"])
    if [r[0] for r in records] != [CLI_EPOCHS + 1] or \
            load_checkpoint(final)[3] != CLI_EPOCHS + 1 or \
            resumed["flash_attention_bwd"] != steps or \
            not latest_checkpoint(ckpts).endswith(
                f"ckpt_{CLI_EPOCHS + 1:06d}.npz"):
        raise AssertionError(f"resume: records {records}, final {final}, "
                             f"launches {resumed}")
    say(f"[6] train --epochs {CLI_EPOCHS + 1} resumed from the epoch-"
        f"{CLI_EPOCHS} checkpoint: one epoch, records {records}, final "
        f"checkpoint {os.path.basename(final)}")

    # ms per training step and per evaluation batch at 512px, peak memory.
    dev = torch.device("cuda")
    corpus = np.load(_cache_paths(data)[0], mmap_mode="r")
    x = torch.from_numpy(np.array(
        corpus[:BATCH // CLI_LAYERS].reshape(BATCH, 512, 512, 1))).to(dev)
    x = x.float() / 255.0
    rng = np.random.default_rng(SEED + 5)
    p = torch.from_numpy(rng.standard_normal((BATCH, 5))
                         .astype(np.float32)).to(dev)
    batch = (x, p, x.mean(dim=(1, 2, 3)), torch.ones(BATCH, device=dev))
    loop = TrainLoop(spec, cfg.train, device="cuda")
    step = make_train_step(cfg.train)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def one_step():
        step(loop.model, loop.opt, batch, gen, cfg.train.learning_rate)

    def one_eval():
        with torch.inference_mode():
            cvt_forward(loop.model, x, p)

    out = {}
    for name, fn in (("train step", one_step), ("evaluation", one_eval)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fn, reps=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        # flash_attention (stage 1) and attention_small (stages 2, 3) run
        # one forward kernel, and both backwards one pair
        busy, top, each = device_ms(fn, calls=2,
                                    launches=("flash_fwd", "flash_bwd"))
        out[name] = (ms, busy, peak)
        busy_txt = ("device time not measured (the profiler recorded none)"
                    if busy is None else
                    f"device busy {busy:.1f} ms ({100 * busy / ms:.1f}%; "
                    "profiler, 2 calls); largest: " + ", ".join(
                        f"{n} {t:.2f}" for n, t in top))
        say(f"[6] 512px {name}, batch {BATCH}: {ms:.1f} ms "
            f"({1e3 * BATCH / ms:.1f} images/s; CUDA events, median of 5); "
            f"peak device memory {peak / 2**30:.2f} GiB; {busy_txt}")
        for what, pattern in (("forward", "flash_fwd"),
                              ("backward", "flash_bwd")):
            if each[pattern]:
                t = each[pattern]
                say(f"[6] 512px {name}: attention {what} kernel launches in "
                    f"order, device ms (profiler, mean of 2 calls): " +
                    ", ".join(f"{x:.2f}" for x in t) +
                    f"; {sum(t):.1f} ms = {100 * sum(t) / ms:.1f}% of the "
                    f"{name}")
    del loop, batch

    # The kernel path against the plain path on PATH_IMAGES images: the
    # evaluation outputs, and 2 training steps at dropout 0.
    spec0 = dataclasses.replace(spec, stages=tuple(
        dataclasses.replace(st, dropout_rate=0.0) for st in spec.stages))
    params, state = to_jax_params(init_cvt(
        spec0, torch.Generator().manual_seed(SEED), device="cuda"))
    xs, ps = x[:PATH_IMAGES].contiguous(), p[:PATH_IMAGES].contiguous()
    small = (xs, ps, xs.mean(dim=(1, 2, 3)) + ps[:, 0],
             torch.ones(PATH_IMAGES, device=dev))
    evals, losses = {}, {}
    for impl in ("auto", "plain"):
        before = read_launches()
        model = from_jax_params(params, state, spec0, device="cuda")
        with torch.inference_mode():
            evals[impl] = cvt_forward(model, xs, ps, impl=impl).reshape(
                -1).cpu().numpy()
        opt = adam_init(model)
        step = make_train_step(cfg.train, impl=impl)
        losses[impl] = np.asarray([
            step(model, opt, small, None, cfg.train.learning_rate)["loss"]
            .item() for _ in range(2)])
        after = read_launches()
        if impl == "plain" and after != before:
            raise AssertionError("the plain 512px path launched a kernel")
        if impl == "auto" and (after["flash_attention"] - before[
                "flash_attention"] != 3 or after["flash_attention_bwd"] -
                before["flash_attention_bwd"] != 2):
            raise AssertionError("the 512px kernel path missed flash")
        del model, opt
        torch.cuda.empty_cache()
    diff = np.abs(evals["auto"] - evals["plain"])
    rel = np.abs(losses["auto"] - losses["plain"]) / np.abs(losses["plain"])
    if (diff > PATH_TOL * np.maximum(1.0, np.abs(evals["plain"]))).any() or \
            (rel > PATH_TOL).any():
        raise AssertionError(f"512px kernel path vs plain path: outputs max "
                             f"|diff| {diff.max():.3e}, losses "
                             f"{losses['auto']} vs {losses['plain']}")
    say(f"[6] 512px kernel path vs plain path on {PATH_IMAGES} images: "
        f"outputs max |diff| {diff.max():.3e} (|y| up to "
        f"{np.abs(evals['plain']).max():.3f}); 2 training steps at dropout 0, "
        f"losses {losses['auto'].tolist()} vs {losses['plain'].tolist()}, "
        f"max rel diff {rel.max():.2e} (limit {PATH_TOL})")
    total = {k: train[k] + test[k] for k in train}
    return total, out


# Phase 7, ViT-S/16 at 224px (VIT_PRESETS["ViT-S/16"]: E 384, depth 12, H 6,
# Dh 64, hidden 1536; 197 tokens folded into t_pad 200), weights from SEED.
VIT_SPEC = "ViT-S/16"
VIT_BATCHES = (192, 384, 768)  # whole-forward images/s in bf16
VIT_TIME_B = 192               # per-kernel timings and the main path
VIT_CHECK_B = 8                # kernel routes against the plain route
VIT_F32_B = 64                 # the f32 auto route against f32 plain
# (name, E, H, B, t_real, t_pad) of the kernel checks; the main path's
# batches make a block walk several images (or 128-row segments) through
# one workspace slot, where B 8 gives each its own
VIT_LAYER_SHAPES = [("ViT-S", 384, 6, VIT_CHECK_B, 197, 200),
                    ("ViT-Ti", 192, 3, 2, 197, 200),
                    ("ViT-B", 768, 12, 2, 197, 200),
                    ("ViT-S 64px", 384, 6, 3, 17, 24),
                    ("ViT-S", 384, 6, VIT_TIME_B, 197, 200),
                    ("ViT-S", 384, 6, max(VIT_BATCHES), 197, 200)]
# f32 widths that are not whole 192-column tiles of csrc/chunk_gemm.cuh (E
# 320: the out projection's, fc1's and fc2's last tiles hold 128 columns)
VIT_F32_EDGE_SHAPES = [("ViT E320", 320, 5, 2, 197, 200)]
# f32 x at a t_pad past 344, where the int8 layer's one-block-an-image
# design stopped: ViT-S/16 at 512px (1,025 tokens)
VIT_F32_LONG_SHAPES = [("ViT-S 512px", 384, 6, 2, 1025, 1032)]
VIT_F32_TOL = 1e-5    # f32 kernel vs plain: max |err| <= tol * max |plain|
VIT_BF16_ULPS = 2     # bf16: max |err| <= 2 bf16 ulps of max |plain|
VIT_INT8_TOL = 1e-2   # int8 kernel vs its plain version: tol * max |plain|
# bf16 kernel routes vs the bf16 plain route, logits: tol * max(1, |plain|)
# (the bar of tests/test_fused_layer.py:26-27); int8 against float: max
# |err| under 3% of the logit scale, correlation above 0.999 (:66-81)
VIT_ROUTE_TOL = 5e-2
VIT_INT8_REL, VIT_INT8_CORR = 0.03, 0.999
# NVIDIA H100 SXM data sheet, dense tensor-core rates
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
VIT_KERNELS = ("attn_layer_infer", "ln_mlp_infer", "vit_layer_infer",
               "vit_layer_infer_int8")


def bf16_ulp(x):
    """One bfloat16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def vit_layer(e, h, seed, dtype, dev="cuda"):
    """(LayerNorm, MHA, LayerNorm, MLP) of one ViT layer at width e, every
    parameter random from ``seed`` (kernels N(0, 1/fan_in), biases and LN
    betas N(0, 0.01), gammas 1 + N(0, 0.01)), on ``dev`` in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    mods = (LayerNorm(e), MHA(e, h), LayerNorm(e), MLP(e, 4 * e))
    with torch.no_grad():
        for m in mods:
            for name, p in m.named_parameters():
                r = torch.randn(p.shape, generator=g)
                if name.endswith("kernel"):
                    fan = p.shape[0] * (p.shape[1] if name.startswith("out")
                                        else 1)
                    p.copy_(r / math.sqrt(fan))
                else:
                    p.copy_(0.1 * r + (1.0 if name == "gamma" else 0.0))
    return [m.to(dev, dtype) for m in mods]


def layer_bounds(n, e, hd, hidden, t_pad, itemsize):
    """(flops of rows 9, 10, 11, int8 ops of row 12's projections, bytes of
    x in, y out and the weights) of one layer on n folded rows."""
    proj = 2.0 * n * e * 4 * hd
    core = 4.0 * n * t_pad * hd
    mlp = 4.0 * n * e * hidden
    weights = (4 * e * hd + 2 * e * hidden) * itemsize
    return proj + core, mlp, proj + core + mlp, proj + mlp, \
        2.0 * n * e * itemsize + weights


def library_layer(mods, dtype):
    """nn.TransformerEncoderLayer with the same weights: the yardstick of
    vit_layer_infer (never called by the port)."""
    n1, attn, n2, mlp = mods
    e, h, dh = attn.query.kernel.shape
    lib = torch.nn.TransformerEncoderLayer(
        e, h, 4 * e, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=True)
    with torch.no_grad():
        sa = lib.self_attn
        sa.in_proj_weight.copy_(torch.cat(
            [getattr(attn, k).kernel.reshape(e, h * dh).T
             for k in ("query", "key", "value")]))
        sa.in_proj_bias.copy_(torch.cat(
            [getattr(attn, k).bias.reshape(-1)
             for k in ("query", "key", "value")]))
        sa.out_proj.weight.copy_(attn.out.kernel.reshape(h * dh, e).T)
        sa.out_proj.bias.copy_(attn.out.bias)
        lib.linear1.weight.copy_(mlp.fc1.kernel.T)
        lib.linear1.bias.copy_(mlp.fc1.bias)
        lib.linear2.weight.copy_(mlp.fc2.kernel.T)
        lib.linear2.bias.copy_(mlp.fc2.bias)
        for ln, ours in ((lib.norm1, n1), (lib.norm2, n2)):
            ln.weight.copy_(ours.gamma)
            ln.bias.copy_(ours.beta)
    return lib.to("cuda", dtype).eval()


def vit_kernel_checks():
    """Rows 9-12 and fused_mlp at the ViT widths against their plain
    versions on the same inputs; returns the largest error of each, as
    {name: (max |err|, max |err| / max |plain|)} over the cases."""
    worst = dict.fromkeys(VIT_KERNELS + ("fused_mlp",), (0.0, 0.0))

    def note(name, err, scale):
        worst[name] = (max(worst[name][0], err),
                       max(worst[name][1], err / scale))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for name, e, h, b, t, tp in VIT_LAYER_SHAPES:
        x32 = torch.randn(b, tp, e, device="cuda", generator=gen)
        x32[:, t:] = 0.0
        x32 = x32.reshape(b * tp, e)
        for dt in (torch.float32, torch.bfloat16):
            n1, attn, n2, mlp = vit_layer(e, h, SEED, dt)
            x = x32.to(dt)
            layer = dict(t_pad=tp, t_real=t)
            cases = (
                ("vit_layer_infer", lambda: vit_layer_infer(
                    x, n1, attn, n2, mlp, **layer), lambda:
                    vit_layer_infer_plain(x, n1, attn, n2, mlp, **layer)),
                ("attn_layer_infer", lambda: attn_layer_infer(
                    x, n1, attn, **layer), lambda: attn_layer_infer_plain(
                    x, n1, attn, **layer)),
                ("ln_mlp_infer", lambda: ln_mlp_infer(x, n2, mlp),
                 lambda: ln_mlp_infer_plain(x, n2, mlp)),
                ("vit_layer_infer_int8", lambda: vit_layer_infer_int8(
                    x, n1, attn, n2, mlp, **layer), lambda:
                    vit_layer_infer_int8_plain(x, n1, attn, n2, mlp,
                                               **layer)))
            errs = []
            for kname, kernel, plain in cases:
                with torch.inference_mode():
                    got, want = kernel().float(), plain().float()
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                if kname == "vit_layer_infer_int8":
                    tol = VIT_INT8_TOL * scale
                elif dt == torch.float32:
                    tol = VIT_F32_TOL * scale
                else:
                    tol = VIT_BF16_ULPS * bf16_ulp(scale)
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(
                        f"{kname} {name} B{b} T{t}/{tp} {dt}: max |err| "
                        f"{err:.3e} over {tol:.3e} (max |y| {scale:.3f})")
                note(kname, err, scale)
                errs.append(f"{kname} {err:.2e}")
            say(f"[7] {name} E{e} H{h} B{b} T{t}/{tp} {str(dt)[6:]}: max "
                f"|kernel - plain| {'; '.join(errs)} (max |y| about "
                f"{scale:.2f})")
        with torch.inference_mode():
            n1, attn, n2, mlp = vit_layer(e, h, SEED, torch.float32)
            w = (mlp.fc1.kernel, mlp.fc1.bias, mlp.fc2.kernel, mlp.fc2.bias)
            got, want = fused_mlp(x32, *w), fused_mlp_plain(x32, *w)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err > VIT_F32_TOL * scale:
            raise AssertionError(f"fused_mlp {name} D{e}: max |err| "
                                 f"{err:.3e} over {VIT_F32_TOL} x {scale:.3f}")
        note("fused_mlp", err, scale)
        say(f"[7] fused_mlp {name} N{b * tp} D{e} Hd{4 * e} f32: max |err| "
            f"{err:.2e} (max |y| {scale:.2f})")

    for name, e, h, b, t, tp in VIT_F32_EDGE_SHAPES + VIT_F32_LONG_SHAPES:
        x = torch.randn(b, tp, e, device="cuda", generator=gen)
        x[:, t:] = 0.0
        x = x.reshape(b * tp, e)
        n1, attn, n2, mlp = vit_layer(e, h, SEED, torch.float32)
        layer = dict(t_pad=tp, t_real=t)
        errs = []
        for kname, kernel, plain in (
                ("vit_layer_infer",
                 lambda: vit_layer_infer(x, n1, attn, n2, mlp, **layer),
                 lambda: vit_layer_infer_plain(x, n1, attn, n2, mlp,
                                               **layer)),
                ("attn_layer_infer",
                 lambda: attn_layer_infer(x, n1, attn, **layer),
                 lambda: attn_layer_infer_plain(x, n1, attn, **layer)),
                ("ln_mlp_infer", lambda: ln_mlp_infer(x, n2, mlp),
                 lambda: ln_mlp_infer_plain(x, n2, mlp)),
                ("vit_layer_infer_int8",
                 lambda: vit_layer_infer_int8(x, n1, attn, n2, mlp, **layer),
                 lambda: vit_layer_infer_int8_plain(x, n1, attn, n2, mlp,
                                                    **layer))):
            with torch.inference_mode():
                got, want = kernel(), plain()
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            tol = (VIT_INT8_TOL if kname == "vit_layer_infer_int8"
                   else VIT_F32_TOL)
            if not torch.isfinite(got).all() or err > tol * scale:
                raise AssertionError(f"{kname} {name} B{b} T{t}/{tp} f32: "
                                     f"max |err| {err:.3e} over {tol}"
                                     f" x {scale:.3f}")
            note(kname, err, scale)
            errs.append(f"{kname} {err:.2e}")
        what = ("partial 192-column tiles" if tp <= 576 else
                "a t_pad past the earlier int8 design's 344")
        say(f"[7] {name} H{h} hidden {4 * e} B{b} T{t}/{tp} float32 "
            f"({what}): max |kernel - plain| "
            f"{'; '.join(errs)} (max |y| about {scale:.2f})")

    # attention_small takes bf16 q, k, v (run in f32, the output rounded)
    q, k, v = (torch.randn(VIT_CHECK_B, 197, 6, 64, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    with torch.inference_mode():
        o = attention_small(q, k, v)
        want = attention_small_plain(q.float(), k.float(), v.float()).to(
            torch.bfloat16).float()
    scale = want.abs().max().item()
    err = (o.float() - want).abs().max().item()
    if o.dtype != torch.bfloat16 or err > VIT_BF16_ULPS * bf16_ulp(scale):
        raise AssertionError(f"attention_small bf16: max |err| {err:.3e}")
    say(f"[7] attention_small bf16 B{VIT_CHECK_B} T197 H6: max |err| "
        f"{err:.2e} (max |o| {scale:.2f}, limit {VIT_BF16_ULPS} ulps)")
    return worst


def vit_kernel_times(worst, card):
    """Each kernel at the main path's shape (ViT-S, B 192, bf16; fused_mlp
    in f32, the f32 auto route's type), beside its plain version, one
    PyTorch call where there is one, and its bound."""
    e, h, hidden, t, tp = 384, 6, 1536, 197, 200
    b = VIT_TIME_B
    n = b * tp
    bt = torch.bfloat16
    mods = vit_layer(e, h, SEED, bt)
    n1, attn, n2, mlp = mods
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.randn(b, tp, e, device="cuda", generator=gen)
    x[:, t:] = 0.0
    x = x.reshape(n, e).to(bt)
    layer = dict(t_pad=tp, t_real=t)
    f_attn, f_mlp, f_layer, ops_int8, nbytes = layer_bounds(n, e, e, hidden,
                                                            tp, 2)
    f_core = 4.0 * n * tp * e
    lib = library_layer(mods, bt)
    xl = x.reshape(b, tp, e)[:, :t].contiguous()
    rows = []
    both = MODE_ATTN | MODE_MLP
    # the bf16 layer's kernel (csrc/vit_layer_sm90.cu) as built: registers a
    # thread, dynamic shared memory, blocks an SM, for each mode at t_pad
    for mode, what in ((both, "vit_layer_infer"),
                       (MODE_ATTN, "attn_layer_infer"),
                       (MODE_MLP, "ln_mlp_infer"),
                       (both | MODE_Q8, "vit_layer_infer_int8")):
        regs, smem, blocks = (ctypes.c_int() for _ in range(3))
        rc = _build.library().vit_layer_sm90_info(
            mode, tp, ctypes.byref(regs), ctypes.byref(smem),
            ctypes.byref(blocks))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError(f"vit_layer_sm90_info({mode}): error {rc}, "
                               f"{blocks.value} blocks an SM")
        if mode & MODE_ATTN and smem.value != attention_smem_bytes(tp):
            raise AssertionError(f"shared memory {smem.value} bytes, "
                                 f"fused_layer.py states "
                                 f"{attention_smem_bytes(tp)}")
        say(f"[7] {what} bf16 kernel (csrc/vit_layer_sm90.cu): "
            f"{regs.value} registers a thread at launch (the consumer "
            f"warpgroups take {240 if mode == MODE_MLP else 232} by "
            f"setmaxnreg), {smem.value} bytes of "
            f"shared memory, {blocks.value} block(s) an SM, 384 threads")
    for name, kernel, plain, flops, lib_fn, line, (mode, *mods_of) in (
            ("attn_layer_infer",
             lambda: attn_layer_infer(x, n1, attn, **layer),
             lambda: attn_layer_infer_plain(x, n1, attn, **layer),
             f_attn / PEAK_BF16_FLOPS, None, 62,
             (MODE_ATTN, n1, attn, None, None)),
            ("ln_mlp_infer", lambda: ln_mlp_infer(x, n2, mlp),
             lambda: ln_mlp_infer_plain(x, n2, mlp),
             f_mlp / PEAK_BF16_FLOPS, None, 590,
             (MODE_MLP, None, None, n2, mlp)),
            ("vit_layer_infer",
             lambda: vit_layer_infer(x, n1, attn, n2, mlp, **layer),
             lambda: vit_layer_infer_plain(x, n1, attn, n2, mlp, **layer),
             f_layer / PEAK_BF16_FLOPS, lambda: lib(xl), 279,
             (both, *mods)),
            ("vit_layer_infer_int8",
             lambda: vit_layer_infer_int8(x, n1, attn, n2, mlp, **layer),
             lambda: vit_layer_infer_int8_plain(x, n1, attn, n2, mlp,
                                                **layer),
             ops_int8 / PEAK_INT8_OPS + f_core / PEAK_BF16_FLOPS, None,
             440, (both | MODE_Q8, *mods))):
        with torch.inference_mode():
            # one call alone, the wrapper's host work included (the time
            # the table of kernels keeps); back to back, that work hides
            # behind the previous call's kernel, as in a forward
            ms = time_ms(kernel)
            batched_ms = time_ms_batched(kernel)
            host_ms = host_call_ms(kernel)
            # packing (and for int8 quantising) the weights: a one-off cost,
            # the first launch's, since the cache keeps them per model
            pack_ms = time_ms(lambda: pack_weights(mode, bt, x.device,
                                                   *mods_of))
            plain_ms = time_ms(plain)
            lib_ms = time_ms(lib_fn) if lib_fn is not None else None
            lib_batched_ms = (time_ms_batched(lib_fn) if lib_fn is not None
                              else None)
        t_ops, t_bytes = 1e3 * flops, 1e3 * nbytes / PEAK_BYTES
        b_ms = max(t_ops, t_bytes)
        rows.append(dict(
            name=name, route="cuda",
            source="transformer_stm_tpu_torch/csrc/vit_layer_sm90.cu",
            replaces=f"transformer_stm_tpu/kernels/fused_layer.py:{line}",
            max_abs_err=worst[name][0], max_rel_err=worst[name][1], ms=ms,
            batched_ms=batched_ms, host_ms=host_ms, pack_ms=pack_ms,
            plain_ms=plain_ms, bound_ms=b_ms,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=lib_ms, library_batched_ms=lib_batched_ms,
            shape=dict(batch=b, rows=n, t_real=t, t_pad=tp, width=e, heads=h,
                       hidden=hidden, dtype="bfloat16")))
        lib_txt = (f"  TransformerEncoderLayer {lib_ms:.3f} ms a call, "
                   f"{lib_batched_ms:.3f} back to back"
                   if lib_ms is not None else "  no single PyTorch call")
        say(f"[7] {name} ViT-S B{b} bf16: kernel {ms:.3f} ms a call alone, "
            f"{batched_ms:.3f} ms back to back (the wrapper returns after "
            f"{host_ms:.3f} ms on the host; packing its weights, once per "
            f"model, {pack_ms:.3f} ms)  plain {plain_ms:.3f} ms{lib_txt}  "
            f"bound {b_ms:.3f} ms ({rows[-1]['bound_by']}; {card})")
    # rows 9-12 on f32 x (rows 9-11: csrc/fused_layer.cu's 3xTF32 products
    # over row chunks; row 12: its int8 kernel) beside their f32 bounds
    # (f32 FMA; 3xTF32 on the tensor cores) and their plain versions, one
    # call alone and back to back, and the whole layer beside
    # nn.TransformerEncoderLayer in f32 (TF32 off: use_true_f32), one call
    # alone, as the bf16 library time is taken
    m32 = vit_layer(e, h, SEED, torch.float32)
    n1f, attnf, n2f, mlpf = m32
    x32 = x.float()
    lib32 = library_layer(m32, torch.float32)
    xl32 = xl.float()
    xio = 2.0 * n * e * 4  # x in, y out, f32
    f32_rows = (
        (0, lambda: attn_layer_infer(x32, n1f, attnf, **layer),
         lambda: attn_layer_infer_plain(x32, n1f, attnf, **layer),
         f_attn, xio + 4 * e * e * 4),
        (1, lambda: ln_mlp_infer(x32, n2f, mlpf),
         lambda: ln_mlp_infer_plain(x32, n2f, mlpf),
         f_mlp, xio + 2 * e * hidden * 4),
        (2, lambda: vit_layer_infer(x32, *m32, **layer),
         lambda: vit_layer_infer_plain(x32, *m32, **layer),
         f_layer, xio + (4 * e * e + 2 * e * hidden) * 4),
        (3, lambda: vit_layer_infer_int8(x32, *m32, **layer),
         lambda: vit_layer_infer_int8_plain(x32, *m32, **layer),
         None, xio + (4 * e * e + 2 * e * hidden)))
    with torch.inference_mode():
        for i, kernel, plain, flops, nb in f32_rows:
            ms32 = time_ms(kernel)
            batched32 = time_ms_batched(kernel)
            plain32 = time_ms(plain)
            if flops is None:
                # int8 projections on the tensor cores, the attention's f32
                # products on the FMA pipe; or on the tensor cores as
                # 3xTF32, as the flash forward runs them
                t_ops = ops_int8 / PEAK_INT8_OPS + f_core / PEAK_F32_FLOPS
                b32 = 1e3 * max(t_ops, nb / PEAK_BYTES)
                by32 = "operations" if t_ops >= nb / PEAK_BYTES else "bytes"
                tc32 = 1e3 * max(ops_int8 / PEAK_INT8_OPS
                                 + 3.0 * f_core / PEAK_TF32_FLOPS,
                                 nb / PEAK_BYTES)
                bound_txt = (f"bound {b32:.3f} ms ({by32}; int8 "
                             f"projections, FMA attention), {tc32:.3f} ms "
                             "on the tensor cores (int8 projections, 3xTF32 "
                             "attention)")
            else:
                b32, by32 = bound(flops, nb)
                tc32 = bound_tc(flops, nb)
                bound_txt = (f"bound {b32:.3f} ms ({by32}; f32 FMA), "
                             f"{tc32:.3f} ms on the tensor cores (3xTF32)")
            lib32_ms = time_ms(lambda: lib32(xl32)) if i == 2 else None
            # where the whole layer's device time goes, kernel by kernel
            split = (kernel_split(kernel, call_ms=ms32) if i >= 2 else None)
            rows[i].update(f32_ms=ms32, f32_batched_ms=batched32,
                           f32_plain_ms=plain32, f32_bound_ms=b32,
                           f32_bound_by=by32, f32_bound_tc_ms=tc32,
                           f32_library_ms=lib32_ms, f32_kernels_ms=split,
                           f32_source=("transformer_stm_tpu_torch/csrc/"
                                       "fused_layer.cu + csrc/chunk_gemm.cuh"
                                       + (" (chunk_gemm_s8)" if flops is None
                                          else " (chunk_gemm)")
                                       + " + csrc/flash_attention.cu"))
            lib_txt = (f"  TransformerEncoderLayer f32 {lib32_ms:.3f} ms a "
                       "call" if lib32_ms is not None else "")
            if split is not None:
                lib_txt += "; device ms a call: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in split.items())
            say(f"[7] {rows[i]['name']} ViT-S B{b} f32: kernel {ms32:.3f} ms "
                f"a call alone, {batched32:.3f} ms back to back  plain "
                f"{plain32:.3f} ms{lib_txt}  {bound_txt} ({card})")
    del m32, x32, lib32, xl32

    # the library layer computes the same function: a loose check that the
    # weights were carried over (bf16 rounds at other places there)
    with torch.inference_mode():
        ours = vit_layer_infer_plain(x, n1, attn, n2, mlp, **layer).float()
        theirs = lib(xl).float()
    ours = ours.reshape(b, tp, e)[:, :t]
    err = (ours - theirs).abs().max().item() / ours.abs().max().item()
    if err > VIT_ROUTE_TOL:
        raise AssertionError(f"TransformerEncoderLayer differs from the "
                             f"plain layer by {err:.3e} of the scale")
    say(f"[7] TransformerEncoderLayer vs vit_layer_infer_plain: max |diff| "
        f"{err:.2e} of the largest entry (bf16)")

    n1, attn, n2, mlp = vit_layer(e, h, SEED, torch.float32)
    xf = x.float().reshape(b, tp, e)[:, :t].reshape(b * t, e)
    w = (mlp.fc1.kernel, mlp.fc1.bias, mlp.fc2.kernel, mlp.fc2.bias)
    with torch.inference_mode():
        ms = time_ms(lambda: fused_mlp(xf, *w))
        pack_ms = time_ms(lambda: pack_mlp_weights(w[0], w[2]))
        plain_ms = time_ms(lambda: fused_mlp_plain(xf, *w))
        lib_ms = time_ms(lambda: torch.addmm(
            w[3], F.gelu(torch.addmm(w[1], xf, w[0])), w[2]))
    nf = b * t
    work = (4.0 * nf * e * hidden,
            4.0 * (2 * nf * e + 2 * e * hidden + hidden + e))
    b_ms, b_by = bound(*work)
    tc_ms = bound_tc(*work)
    say(f"[7] fused_mlp ViT-S N{nf} D{e} Hd{hidden} f32: kernel {ms:.3f} ms "
        f"(packing the weights, once per model, {pack_ms:.3f} ms)  plain "
        f"{plain_ms:.3f} ms  addmm+gelu+addmm {lib_ms:.3f} ms  bound "
        f"{b_ms:.3f} ms ({b_by}), on the tensor cores {tc_ms:.3f} ms")
    vit_mlp = dict(stage="vit_s_d384", shape=[nf, e, hidden], ms=ms,
                   pack_ms=pack_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, bound_tc_ms=tc_ms,
                   max_abs_err=worst["fused_mlp"][0],
                   max_rel_err=worst["fused_mlp"][1])
    return rows, vit_mlp


def check_packing_once(model, few, many):
    """The weights are packed once per model: a second forward through
    fused2, fused and fused2_int8 packs nothing; after an in-place update of
    one weight the next forward repacks that layer and follows the new
    weights (against "plain" with the same update)."""
    with torch.inference_mode():
        pack_weights.packings = 0
        for impl in ("auto", "fused", "fused2_int8"):
            vit_forward(model, many, impl=impl)
        torch.cuda.synchronize()
    if pack_weights.packings != 0:
        raise AssertionError(f"a second ViT forward packed weights "
                             f"{pack_weights.packings} times")
    say("[7] second ViT-S forward through auto (fused2), fused and "
        "fused2_int8: 0 packings")
    bias = model.blocks[0].mlp.fc2.bias
    with torch.inference_mode():
        old = vit_forward(model, few).float()
    with torch.no_grad():
        bias.add_(1.0)
    with torch.inference_mode():
        pack_weights.packings = 0
        new = vit_forward(model, few).float()
        packed = pack_weights.packings
        plain = vit_forward(model, few, impl="plain").float()
    with torch.no_grad():
        bias.sub_(1.0)
    lim = VIT_ROUTE_TOL * max(1.0, plain.abs().max().item())
    diff = (new - plain).abs().max().item()
    stale = (old - plain).abs().max().item()
    if packed != 1 or diff > lim or stale <= diff:
        raise AssertionError(
            f"after an in-place update: {packed} packings (want 1), max "
            f"|new - plain| {diff:.3e} (limit {lim:.3e}), the stale output "
            f"{stale:.3e} from plain")
    say(f"[7] after an in-place update of block 0's fc2 bias: {packed} "
        f"packing, max |auto - plain| {diff:.3e} (limit {lim:.3e}; the "
        f"output before the update lies {stale:.3e} from it)")


def phase_vit(kernels, card):
    """ViT-S/16 inference at 224px: the kernels against their plain
    versions and timed, then the whole forward through vit_forward's routes
    with exact launch counts, agreement with the plain route, images/s and
    peak memory, and the on-device preprocessing front end."""
    worst = vit_kernel_checks()
    rows, vit_mlp = vit_kernel_times(worst, card)
    for k in kernels:
        if k["name"] == "fused_mlp":
            k["vit_shapes"] = [vit_mlp]

    spec = VIT_PRESETS[VIT_SPEC]
    model32 = init_vit(spec, torch.Generator().manual_seed(SEED),
                       device="cuda")
    model = init_vit(spec, torch.Generator().manual_seed(SEED),
                     device="cuda").to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    imgs32 = torch.rand(max(VIT_BATCHES), spec.image_size, spec.image_size,
                        spec.num_channels, device="cuda", generator=gen)
    imgs = imgs32.to(torch.bfloat16)
    spec1 = dataclasses.replace(spec, num_channels=1)
    model1 = init_vit(spec1, torch.Generator().manual_seed(SEED),
                      device="cuda").to(torch.bfloat16)
    raw = torch.randint(0, 256, (VIT_TIME_B, 345, 340, 3), device="cuda",
                        dtype=torch.uint8, generator=gen)

    def front_end():
        x = preprocess_images_device(raw, spec.image_size, spec.image_size,
                                     dtype=torch.bfloat16)
        return vit_forward(model1, x)

    # The main path, counted: every route once at its batch.
    b = VIT_TIME_B
    d = spec.depth
    routes = (
        ("auto bf16", lambda: vit_forward(model, imgs[:b]),
         {"vit_layer_infer": d}),
        ("fused", lambda: vit_forward(model, imgs[:b], impl="fused"),
         {"attn_layer_infer": d, "ln_mlp_infer": d}),
        ("fused2_int8", lambda: vit_forward(model, imgs[:b],
                                            impl="fused2_int8"),
         {"vit_layer_infer_int8": d}),
        ("auto f32", lambda: vit_forward(model32, imgs32[:VIT_F32_B]),
         {"fused_mlp": d}),
        ("fused f32", lambda: vit_forward(model32, imgs32[:VIT_F32_B],
                                          impl="fused"),
         {"attn_layer_infer": d, "ln_mlp_infer": d}),
        ("fused2 f32", lambda: vit_forward(model32, imgs32[:VIT_F32_B],
                                           impl="fused2"),
         {"vit_layer_infer": d}),
        ("fused2_int8 f32", lambda: vit_forward(
            model32, imgs32[:VIT_F32_B], impl="fused2_int8"),
         {"vit_layer_infer_int8": d}),
        ("preprocess + auto bf16", front_end, {"vit_layer_infer": d}))
    f32_routes = ("auto f32", "fused f32", "fused2 f32", "fused2_int8 f32")
    outs, route_launches = {}, {}
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        for name, fn, want in routes:
            before = read_launches()
            outs[name] = fn()
            torch.cuda.synchronize()
            got = {k: n - before[k] for k, n in read_launches().items()
                   if n != before[k]}
            route_launches[name] = got
            if got != want:
                raise AssertionError(f"ViT route {name}: launches {got}, "
                                     f"want {want}")
            y = outs[name]
            if y.shape[1] != spec.num_classes or \
                    not torch.isfinite(y.float()).all():
                raise AssertionError(f"ViT route {name}: {tuple(y.shape)}, "
                                     "finite "
                                     f"{torch.isfinite(y.float()).all()}")
    launches = read_launches()
    say(f"[7] ViT-S/16 main path (auto bf16, fused and fused2_int8 at B{b}, "
        f"auto, fused, fused2 and fused2_int8 in f32 at B{VIT_F32_B}, "
        f"preprocessing + auto at B{b}): launches {launches}")
    check_packing_once(model, imgs[:VIT_CHECK_B], imgs[:b])

    # Agreement with the plain route.
    c = VIT_CHECK_B
    with torch.inference_mode():
        plain = vit_forward(model, imgs[:c], impl="plain").float()
        plain32 = vit_forward(model32, imgs32[:c], impl="plain")
        lim = VIT_ROUTE_TOL * max(1.0, plain.abs().max().item())
        for impl in ("auto", "fused"):
            diff = (vit_forward(model, imgs[:c], impl=impl).float()
                    - plain).abs().max().item()
            if diff > lim:
                raise AssertionError(f"ViT-S {impl} vs plain (bf16, B{c}): "
                                     f"max |diff| {diff:.3e} over {lim:.3e}")
            say(f"[7] ViT-S {impl} vs plain, bf16, B{c}: max |diff| "
                f"{diff:.3e} (limit {lim:.3e}; |logits| up to "
                f"{plain.abs().max().item():.3f})")
        q8 = vit_forward(model, imgs[:c], impl="fused2_int8").float()
        rel = ((q8 - plain32).abs().max() / plain32.abs().max()).item()
        corr = np.corrcoef(q8.cpu().numpy().ravel(),
                           plain32.cpu().numpy().ravel())[0, 1]
        if rel >= VIT_INT8_REL or corr <= VIT_INT8_CORR:
            raise AssertionError(f"ViT-S fused2_int8 vs f32 plain: "
                                 f"{rel:.3e} of the scale, corr {corr:.6f}")
        say(f"[7] ViT-S fused2_int8 (bf16) vs f32 plain, B{c}: max |diff| "
            f"{rel:.3e} of the logit scale (limit {VIT_INT8_REL}), "
            f"correlation {corr:.6f} (limit {VIT_INT8_CORR})")
        ref32 = vit_forward(model32, imgs32[:VIT_F32_B], impl="plain")
        q8 = outs["fused2_int8 f32"]
        rel = ((q8 - ref32).abs().max() / ref32.abs().max()).item()
        corr = np.corrcoef(q8.cpu().numpy().ravel(),
                           ref32.cpu().numpy().ravel())[0, 1]
        if rel >= VIT_INT8_REL or corr <= VIT_INT8_CORR:
            raise AssertionError(f"ViT-S fused2_int8 f32 vs f32 plain: "
                                 f"{rel:.3e} of the scale, corr {corr:.6f}")
        say(f"[7] ViT-S fused2_int8 f32 (vit_layer_infer_int8 on f32 x) vs "
            f"f32 plain, B{VIT_F32_B}: max |diff| {rel:.3e} of the logit "
            f"scale (limit {VIT_INT8_REL}), correlation {corr:.6f} (limit "
            f"{VIT_INT8_CORR})")
        lim32 = PATH_TOL * ref32.abs().clamp_min(1.0)
        for name, via in zip(f32_routes, ("fused_mlp", "attn_layer_infer + "
                                          "ln_mlp_infer", "vit_layer_infer")):
            diff = (outs[name] - ref32).abs()
            if (diff > lim32).any():
                raise AssertionError(f"ViT-S {name} vs plain: max |diff| "
                                     f"{diff.max().item():.3e}")
            say(f"[7] ViT-S {name} ({via}) vs f32 plain, B{VIT_F32_B}: max "
                f"|diff| {diff.max().item():.3e} (limit {PATH_TOL} x "
                "max(1, |y|); |logits| up to "
                f"{ref32.abs().max().item():.3f})")

    # images/s and peak memory of each route at each batch
    thru = {}
    with torch.inference_mode():
        for bb in VIT_BATCHES:
            x = imgs[:bb]
            for impl in ("auto", "fused", "fused2_int8", "plain"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = time_ms(lambda: vit_forward(model, x, impl=impl),
                             reps=5, warmup=1)
                peak = torch.cuda.max_memory_allocated()
                thru[(bb, impl)] = (ms, 1e3 * bb / ms, peak)
                say(f"[7] ViT-S/16 224px bf16 B{bb} {impl}: {ms:.2f} ms, "
                    f"{1e3 * bb / ms:.1f} images/s (CUDA events, median of "
                    f"5), peak {peak / 2**30:.2f} GiB; {card}")
        # the f32 routes at their batch (TF32 off), one forward each
        for name in f32_routes + ("plain f32",):
            impl = name.split()[0]
            ms = time_ms(lambda: vit_forward(model32, imgs32[:VIT_F32_B],
                                             impl=impl), reps=5, warmup=1)
            thru[(VIT_F32_B, name)] = (ms, 1e3 * VIT_F32_B / ms, None)
            say(f"[7] ViT-S/16 224px f32 B{VIT_F32_B} {impl}: {ms:.2f} ms, "
                f"{1e3 * VIT_F32_B / ms:.1f} images/s (CUDA events, median "
                f"of 5); {card}")
        # where a B 192 forward's device time goes (torch.profiler)
        busy, top = device_ms(lambda: vit_forward(model, imgs[:b]), calls=2)
        ms_fwd = thru[(b, "auto")][0]
        say(f"[7] ViT-S/16 auto B{b}: " + (
            "device time not measured (the profiler recorded none)"
            if busy is None else
            f"device busy {busy:.2f} ms of a {ms_fwd:.2f} ms forward "
            f"({100 * busy / ms_fwd:.1f}%; profiler, 2 calls); largest: "
            + ", ".join(f"{n} {t:.2f}" for n, t in top)))
        ms_pre = time_ms(lambda: preprocess_images_device(
            raw, spec.image_size, spec.image_size, dtype=torch.bfloat16),
            reps=5, warmup=1)
        ms_all = time_ms(front_end, reps=5, warmup=1)
    say(f"[7] raw uint8 B{b} 345x340x3 -> preprocess_images_device -> "
        f"1-channel ViT-S/16 auto bf16: {ms_all:.2f} ms, "
        f"{1e3 * b / ms_all:.1f} images/s (preprocessing alone "
        f"{ms_pre:.3f} ms); {card}")
    for r in rows:
        r["vit_images_per_s"] = {f"B{bb} {impl}": round(v[1], 1)
                                 for (bb, impl), v in thru.items()}
        r["f32_launches"] = sum(route_launches[name].get(r["name"], 0)
                                for name in f32_routes)
    return launches, rows


# Phase 8, the ViT-B/16 fine-tune (BASELINE.json config 3) as
# scripts/bench_vit_finetune.py:34-38 configures it: ViT-B/16 at 224px, one
# channel, 4 classes, batch 64, bf16 compute, AdamW (weight decay 0.05),
# label smoothing 0.1, softmax cross-entropy; weights from SEED.
FT_IMAGES = 320       # synthetic 224x224x1 images, four quadrant classes
FT_VAL_SPLIT = 0.2    # 64 held out: 256 train images, 4 steps an epoch
FT_EPOCHS = 2         # then a second trainer resumes to epoch 3
FT_LOSS_TOL = 1e-4    # f32 losses, pallas route vs auto route (relative)


def finetune_setup():
    spec = dataclasses.replace(VIT_PRESETS["ViT-B/16"], num_channels=1,
                               num_classes=4)
    cfg = TrainConfig(batch_size=64, seed=SEED, compute_dtype="bfloat16",
                      optimizer="adamw", weight_decay=0.05,
                      label_smoothing=0.1, loss="softmax_xent")
    # tests/test_vit.py:44-52 at 224px: a dim background, the class's
    # quadrant bright
    rng = np.random.default_rng(SEED + 9)
    labels = rng.integers(0, 4, FT_IMAGES)
    images = rng.uniform(0, 0.2, (FT_IMAGES, 224, 224, 1))
    for i, c in enumerate(labels):
        y0, x0 = (c // 2) * 112, (c % 2) * 112
        images[i, y0:y0 + 112, x0:x0 + 112, 0] += 0.7
    return spec, cfg, (images * 255).round().astype(np.uint8), labels


def vit_step_launches(impl, depth):
    """The launches of one fine-tune step on each route: none at 197 tokens
    on "auto" (plain PyTorch, as JAX's router keeps it), one flash forward,
    one flash backward pair and one fused training MLP forward and backward
    a layer on "pallas"."""
    want = zero_launches()
    if impl == "pallas":
        want.update(flash_attention=depth, flash_attention_bwd=depth,
                    fused_mlp_train=depth, fused_mlp_train_bwd=depth)
    return want


def phase_finetune(card):
    """ViTTrainer.fit at full ViT-B width through the kernels, resume, the
    routes against each other, step times."""
    spec, cfg, images, labels = finetune_setup()
    dev = torch.device("cuda")
    n_train = FT_IMAGES - int(FT_IMAGES * FT_VAL_SPLIT)
    steps = FT_EPOCHS * -(-n_train // cfg.batch_size)
    evals = FT_EPOCHS * -(-(FT_IMAGES - n_train) // cfg.batch_size)
    say(f"[8] ViT-B/16 fine-tune: E {spec.embed_dim}, depth {spec.depth}, "
        f"{spec.num_heads} heads, {spec.num_channels} channel, "
        f"{spec.num_classes} classes, batch {cfg.batch_size}, "
        f"{cfg.compute_dtype}, AdamW wd {cfg.weight_decay}, label smoothing "
        f"{cfg.label_smoothing}; {FT_IMAGES} synthetic quadrant images, "
        f"val_split {FT_VAL_SPLIT}, AugmentConfig()")
    with tempfile.TemporaryDirectory() as ck:
        tr = ViTTrainer(spec, cfg, augment=AugmentConfig(), impl="pallas",
                        device="cuda")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit(images, labels, epochs=FT_EPOCHS, val_split=FT_VAL_SPLIT,
               checkpoint_dir=ck, checkpoint_every=1, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        # the steps' launches, and a flash forward and a fused_mlp a layer
        # for each evaluation batch (f32 predict on the "pallas" route, as
        # JAX routes its evaluation MLP to the fused kernel)
        want = {k: v * steps for k, v in
                vit_step_launches("pallas", spec.depth).items()}
        want["flash_attention"] += spec.depth * evals
        want["fused_mlp"] += spec.depth * evals
        say(f"[8] fit: {FT_EPOCHS} epochs, {steps} steps of "
            f"{cfg.batch_size} and {evals} evaluation batches in {dt:.2f} s "
            f"(host clock); launches {launches}")
        if launches != want:
            raise AssertionError(f"fine-tune launches {launches}, want "
                                 f"{want}")
        for r in tr.records:
            say(f"[8] epoch {r[0]}: loss {r[1]:.4f} acc {r[2]:.4f} "
                f"val_loss {r[3]:.4f} val_acc {r[4]:.4f} lr {r[5]:.2e}")
        if tr.epoch != FT_EPOCHS or not np.isfinite(
                np.asarray(tr.records, np.float64)).all():
            raise AssertionError(f"fine-tune records {tr.records}")

        # a loaded checkpoint predicts bit for bit as the trainer saved it;
        # a second trainer resumes from it to the next epoch
        few = images[:cfg.batch_size]
        saved = tr.predict(few)
        fresh = ViTTrainer(spec, cfg, augment=AugmentConfig(),
                           impl="pallas", device="cuda")
        if not fresh.load(ck) or fresh.epoch != FT_EPOCHS or \
                fresh.opt.step != tr.opt.step or \
                not np.array_equal(fresh.predict(few), saved):
            raise AssertionError("fine-tune checkpoint round trip changed "
                                 "the model")
        fresh.fit(images, labels, epochs=FT_EPOCHS + 1,
                  val_split=FT_VAL_SPLIT, checkpoint_dir=ck, verbose=False)
        if fresh.epoch != FT_EPOCHS + 1 or len(fresh.records) != \
                FT_EPOCHS + 1 or fresh.records[:FT_EPOCHS] != tr.records:
            raise AssertionError(f"resume: epoch {fresh.epoch}, records "
                                 f"{fresh.records}")
        say(f"[8] checkpoint loaded into a fresh trainer predicts bit for "
            f"bit the same (Adam step {fresh.opt.step - steps // FT_EPOCHS}"
            f" before the resume); resumed to epoch {fresh.epoch}: "
            f"{fresh.records[-1]}")
        del tr, fresh

    # The routes against each other: 3 steps on one batch, dropout 0 (the
    # preset's), no augmentation, from the same weights; per-step launches
    x = torch.from_numpy(images[:cfg.batch_size]).to(dev).float() / 255.0
    y = torch.from_numpy(labels[:cfg.batch_size]).to(dev)
    mask = torch.ones(cfg.batch_size, device=dev)
    start = to_jax_params(init_vit(spec, torch.Generator().manual_seed(SEED),
                                   device="cuda"))[0]
    found = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        for impl in ("auto", "pallas"):
            model = vit_from_jax_params(start, spec, device="cuda")
            opt = adam_init(model)
            with torch.no_grad():
                logits = vit_forward(model, x.to(torch.float32 if dtype ==
                                                  "float32" else
                                                  torch.bfloat16),
                                     train=True, impl=impl).float()
            step = make_vit_train_step(spec, c, impl=impl)
            losses = []
            for _ in range(TRAIN_STEPS):
                reset_launches()
                losses.append(step(model, opt, (x, y, mask), None,
                                   cfg.learning_rate)["loss"].item())
                if read_launches() != vit_step_launches(impl, spec.depth):
                    raise AssertionError(f"{dtype} {impl} step launches "
                                         f"{read_launches()}")
            found[(dtype, impl)] = (np.asarray(losses), logits)
            del model, opt
    for dtype, tol in (("float32", FT_LOSS_TOL), ("bfloat16", BF16_LOSS_TOL)):
        (la, ga), (lp, gp) = found[(dtype, "auto")], found[(dtype, "pallas")]
        rel = np.abs(lp - la) / np.abs(la)
        gdiff = (gp - ga).abs().max().item()
        gscale = max(1.0, ga.abs().max().item())
        if not np.isfinite(lp).all() or (rel > tol).any() or (
                dtype == "bfloat16" and gdiff > BF16_OUT_TOL * gscale):
            raise AssertionError(f"{dtype} routes: losses {lp} vs {la}, "
                                 f"logits max |diff| {gdiff:.3e}")
        say(f"[8] {dtype}, {TRAIN_STEPS} steps, pallas route vs auto: "
            f"losses {lp.tolist()} vs {la.tolist()}, max rel diff "
            f"{rel.max():.2e} (limit {tol}); first logits max |diff| "
            f"{gdiff:.3e} (|logits| up to {gscale:.3f})")

    # ms per step (CUDA events, median of 5 after a warm-up of 2), images/s,
    # peak memory and the device's busy share, in the config's bf16
    out = {}
    for impl in ("auto", "pallas"):
        model = init_vit(spec, torch.Generator().manual_seed(SEED),
                         device="cuda")
        opt = adam_init(model)
        step = make_vit_train_step(spec, cfg, augment=AugmentConfig(),
                                   impl=impl)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def one_step():
            step(model, opt, (x, y, mask), gen, cfg.learning_rate)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(one_step, reps=5, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        busy, top = device_ms(one_step)
        busy_txt = ("device time not measured (the profiler recorded none)"
                    if busy is None else
                    f"device busy {busy:.1f} ms ({100 * busy / ms:.1f}%; "
                    "union of the kernels' intervals, profiler, 3 steps); "
                    "largest: " + ", ".join(
                        f"{n} {t:.2f}" for n, t in top))
        out[impl] = dict(ms=ms, images_per_s=1e3 * cfg.batch_size / ms,
                         peak_bytes=peak, busy_ms=busy)
        say(f"[8] {impl} route, bf16 step of {cfg.batch_size}: {ms:.2f} ms, "
            f"{out[impl]['images_per_s']:.1f} images/s, peak "
            f"{peak / 2 ** 30:.2f} GiB; {busy_txt} ({card})")
        del model, opt
    return launches, out

# Phase 9, the analysis and data-prep surface.  The Grad-CAM corpus: the
# reference's `make heatmap` reads 10 layers a specimen; the label and
# process sheets hold the reference corpus's 40 groups x 5 pieces (all 20
# targets), which the params-only FFN trains on at its real size, 200
# layers a specimen (32,000 training rows, 250 steps an epoch of 128).
HEAT_TARGET = "50HZ_Bm"
HEAT_GROUPS, HEAT_LAYERS = 2, 10
HEAT_512_BATCH = 8
HEAT_TOL = 1e-4       # Grad-CAM heatmaps on [0, 1], kernels vs plain: max |diff|
HEAT_PRED_TOL = 1e-5  # its predictions: max |diff| <= tol x max |plain|
FFN_GROUPS, FFN_LAYERS, FFN_EPOCHS = 40, 200, 4
FFN_TOL = 1e-5        # the card's FFN checkpoint on the card vs on the CPU:
                      # max |diff| <= tol x max(1, |y|)
FFN_GRAPH_TOL = 1e-6  # FFN_CHECK_EPOCHS epochs' records on the card, graph
FFN_CHECK_EPOCHS = 3  # replays vs op by op: |diff| <= tol x |op by op|
PREP_TOL = 1e-5       # preprocess_images_device(antialias=True), card vs CPU


def analysis_fixture(root):
    """Label and process sheets of FFN_GROUPS x 5 specimens (all 20
    targets, the label a function of the group's process parameters; one
    label missing) and a 128px corpus of the first HEAT_GROUPS groups,
    HEAT_LAYERS layers a specimen, written straight into the decode cache.
    Returns the DataConfigs of the Grad-CAM and the FFN runs."""
    from transformer_stm_tpu_torch.config import FREQUENCIES

    rng = np.random.default_rng(SEED + 10)
    proc = rng.uniform(0.5, 3.0, (FFN_GROUPS, 5))
    n_spec = FFN_GROUPS * 5
    rows = [["No."] + list(FREQUENCIES)]
    for i in range(n_spec):
        base = 1.0 + 0.2 * proc[i // 5].sum()
        rows.append([i + 1] + [float(base * (1 + 0.1 * t) +
                                     0.01 * rng.standard_normal())
                               for t in range(len(FREQUENCIES))])
    rows[3][1] = None  # as the IQR filter leaves a piece
    heat = DataConfig(data_root=os.path.join(root, "data"),
                      excel_labels=os.path.join(root, "labels.xlsx"),
                      excel_process=os.path.join(root, "process.xlsx"),
                      group_end=HEAT_GROUPS, image_layers=HEAT_LAYERS,
                      cache_dir=os.path.join(root, "cache"))
    write_xlsx(heat.excel_labels, {"Sheet1": rows})
    write_xlsx(heat.excel_process, {"Sheet1": [list(PROCESS_PARAMETERS)] +
                                    proc.tolist()})
    os.makedirs(heat.cache_dir)
    npy, meta = _cache_paths(heat)
    corpus = np.lib.format.open_memmap(
        npy, mode="w+", dtype=np.uint8,
        shape=(HEAT_GROUPS * 5, HEAT_LAYERS, 128, 128))
    corpus[:] = rng.integers(0, 256, corpus.shape, dtype=np.uint8)
    corpus.flush()
    del corpus
    with open(meta, "w") as f:
        json.dump({"decoded": list(range(HEAT_GROUPS * 5))}, f)
    ffn = dataclasses.replace(heat, group_end=FFN_GROUPS,
                              image_layers=FFN_LAYERS)
    return heat, ffn


def gradcam_check(what, model, spec, images, proc, want, card, reps):
    """gradcam_heatmaps through the kernels (impl "auto") and the plain
    route, each with every count set to 0 just before it: exact launch
    counts, heatmaps and predictions within their bars; ms per call and of
    the feature forward (CUDA events)."""
    from transformer_stm_tpu_torch.tools.grad_cam import gradcam_heatmaps

    out, launches = {}, {}
    for impl in ("auto", "plain"):
        reset_launches()
        out[impl] = gradcam_heatmaps(model, spec, images, proc, impl=impl)
        torch.cuda.synchronize()
        launches[impl] = read_launches()
    if launches["auto"] != want or launches["plain"] != zero_launches():
        raise AssertionError(f"{what} Grad-CAM launches {launches}, want "
                             f"{want} through the kernels, none plain")
    (h, p), (hp, pp) = out["auto"], out["plain"]
    b = images.shape[0]
    if h.shape[0] != b or p.shape != (b,) or not np.isfinite(h).all() or \
            not np.isfinite(p).all() or h.min() < 0 or h.max() > 1:
        raise AssertionError(f"{what} heatmaps {h.shape} in [{h.min()}, "
                             f"{h.max()}], preds {p.shape}")
    dh, dp = np.abs(h - hp).max(), np.abs(p - pp).max()
    if dh > HEAT_TOL or dp > HEAT_PRED_TOL * np.abs(pp).max():
        raise AssertionError(f"{what} Grad-CAM kernels vs plain: heatmaps "
                             f"max |diff| {dh:.3e}, preds {dp:.3e}")

    def features(impl="auto"):
        with torch.no_grad():
            cvt_forward(model, images, proc, impl=impl, return_features=True)

    times = {"ms": time_ms(lambda: gradcam_heatmaps(model, spec, images,
                                                    proc), reps=reps,
                           warmup=1),
             "plain_ms": time_ms(lambda: gradcam_heatmaps(
                 model, spec, images, proc, impl="plain"), reps=reps,
                 warmup=1),
             "features_ms": time_ms(features, reps=reps, warmup=1),
             "features_plain_ms": time_ms(lambda: features("plain"),
                                          reps=reps, warmup=1)}
    for impl in ("auto", "plain"):
        busy = device_ms(lambda: gradcam_heatmaps(model, spec, images, proc,
                                                  impl=impl))[0]
        key = "busy_ms" if impl == "auto" else "plain_busy_ms"
        times[key] = busy
    share = {k: (f"{100 * times[k + 'busy_ms'] / times[k + 'ms']:.0f}%"
                 if times[k + "busy_ms"] else "not measured")
             for k in ("", "plain_")}
    say(f"[9] {what} Grad-CAM, batch {b}: launches {launches['auto']} "
        f"(plain route none); kernels vs plain: heatmaps max |diff| "
        f"{dh:.3e} (limit {HEAT_TOL}), preds {dp:.3e} (|y| up to "
        f"{np.abs(pp).max():.3f}, limit {HEAT_PRED_TOL} x max |y|); "
        f"{times['ms']:.2f} ms a call ({times['features_ms']:.2f} of it the "
        f"feature forward); plain route {times['plain_ms']:.2f} "
        f"({times['features_plain_ms']:.2f}) (CUDA events, median of "
        f"{reps}, one call at a time, host work included); the device busy "
        f"{share['']} of a call's time, plain route {share['plain_']} "
        f"(torch.profiler, 3 calls; {card})")
    return launches["auto"], dict(times, batch=b, heat_max_diff=float(dh),
                                  pred_max_diff=float(dp))


def native_check():
    """The native host loader builds where g++ and libjpeg's header are
    there (the card needs neither): a constant image keeps its grey."""
    from transformer_stm_tpu_torch.data import native

    has_header = False
    if shutil.which("g++") is not None:
        has_header = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
            capture_output=True, text=True, timeout=60).returncode == 0
    if not has_header:
        say("[9] native loader: g++ or jpeglib.h missing on this machine, "
            "not built (the host decoder is cv2's there)")
        return
    native.build()
    bgr = np.full((345, 340, 3), 77, np.uint8)
    grey = native.resize_gray(bgr, 128, 128)
    if grey.shape != (128, 128) or (grey != 77).any():
        raise AssertionError("native resize_gray of a constant image")
    say(f"[9] native loader built ({native.LIB}); resize_gray checked")


def ffn_train_check(cfg, data, train_rows, val_rows, root, card):
    """The FFN's training on the card with its later epochs CUDA-graph
    replays against the same run op by op (``cuda_graph=False``):
    FFN_CHECK_EPOCHS epochs with the lr decayed every epoch, so each replay
    reads a new lr, new bias corrections and a new shuffle; the same
    kernels in the same order, so the records agree within FFN_GRAPH_TOL.
    Both under torch.profiler: the device kernels a step and the device's
    busy time of an epoch, op by op and replayed."""
    from transformer_stm_tpu_torch.harness import _train_ffn

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_decay_every=1))
    runs = {}
    for graph in (True, False):
        paths = {"weights": os.path.join(root, f"ffn_graph{graph}"),
                 "records": os.path.join(root, f"ffn_graph{graph}.xlsx")}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = _train_ffn(cfg, HEAT_TARGET, data["proc_scaled"],
                             data["labels"], train_rows, val_rows, paths,
                             epochs=FFN_CHECK_EPOCHS, verbose=False,
                             device="cuda", cuda_graph=graph)
            torch.cuda.synchronize()
        events = device_events(prof)
        runs[graph] = (np.asarray([r[1:5] for r in out["records"]]),
                       sum(not e.name.startswith(("Memcpy", "Memset"))
                           for e in events), busy_ms(events), out)
    rel = np.abs(runs[True][0] - runs[False][0]) / np.abs(runs[False][0])
    if runs[True][0].shape != (FFN_CHECK_EPOCHS, 4) or \
            not rel.max() <= FFN_GRAPH_TOL:
        raise AssertionError(f"FFN training, graph replays vs op by op: "
                             f"records {runs[True][0]} vs {runs[False][0]}")
    e, steps = FFN_CHECK_EPOCHS, -(-len(train_rows) // cfg.train.batch_size)
    op_kernels, op_busy = runs[False][1] / e, runs[False][2] / e
    op_wall = 1e3 * runs[False][3]["seconds"] / e
    replay_kernels = (runs[True][1] - op_kernels) / (e - 1)
    replay_busy = (runs[True][2] - op_busy) / (e - 1)
    replay_wall = 1e3 * (runs[True][3]["seconds"] -
                         runs[True][3]["first_seconds"]) / (e - 1)
    say(f"[9] FFN training, CUDA-graph replays vs op by op on the card, {e} "
        f"epochs, lr decayed every epoch: records max rel diff "
        f"{rel.max():.3e} (limit {FFN_GRAPH_TOL}); torch.profiler: op by op "
        f"{op_kernels:.0f} device kernels an epoch ({op_kernels / steps:.1f} "
        f"a step, its validation included), device busy {op_busy:.1f} ms of "
        f"{op_wall:.1f} ms (host clock, under the profiler); replayed "
        f"{replay_kernels:.0f} kernels an epoch, device busy "
        f"{replay_busy:.1f} ms of {replay_wall:.1f} ms ({card})")
    return {"graph_vs_op_by_op_max_rel_diff": float(rel.max()),
            "kernels_per_step": op_kernels / steps,
            "op_by_op_busy_ms": op_busy, "op_by_op_wall_ms": op_wall,
            "replay_kernels_per_epoch": replay_kernels,
            "replay_busy_ms": replay_busy, "replay_wall_ms": replay_wall}


def phase_analysis(card):
    """Grad-CAM through the CLI and at B 128 and at 512px against the plain
    route, the params-only FFN through the CLI, the antialiased
    preprocessing, the data-prep and plotting subcommands, the monitor."""
    import importlib.util

    from transformer_stm_tpu_torch.data.xlsx import read_table
    from transformer_stm_tpu_torch.harness import (_load_target, _paths,
                                                   _predict_ffn)
    from transformer_stm_tpu_torch.tools.grad_cam import gradcam_heatmaps
    from transformer_stm_tpu_torch.tools.monitor import format_line

    root = tempfile.mkdtemp()
    heat_data, ffn_data = analysis_fixture(root)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    result = {"matplotlib": have_mpl}
    by_path = {}

    # Grad-CAM through the command line, random weights from SEED saved at
    # the target's weight path.
    spec = CvTSpec()
    cfg = ExperimentConfig(frequencies=(HEAT_TARGET,), data=heat_data,
                           train=TrainConfig(batch_size=BATCH, seed=SEED),
                           result_dir=os.path.join(root, "Result"))
    cfg_path = os.path.join(root, "heatmap.json")
    save_config(cfg, cfg_path)
    model = init_cvt(spec, torch.Generator().manual_seed(SEED),
                     device="cuda")
    save_checkpoint(_paths(cfg, HEAT_TARGET)["weights"], model, None, step=0)
    launches, dt = cli_launches(["heatmap", "--config", cfg_path, "--layers",
                                 str(HEAT_LAYERS)])
    want = {**zero_launches(), "attention_small": 1, "fused_mlp": 3}
    if launches != want:
        raise AssertionError(f"heatmap CLI launches {launches}, want {want}")
    by_path["heatmap"] = launches
    panels = [os.path.join(cfg.result_dir, "Plots", cfg.variant_dir,
                           f"gradcam_{HEAT_TARGET}_{k}.png") for k in range(4)]
    written = [os.path.exists(p) for p in panels]
    if written != [have_mpl] * 4:
        raise AssertionError(f"heatmap panels written {written}, matplotlib "
                             f"{have_mpl}")
    # its heatmaps against the plain route on the same 4 held-out images
    data, _, val_rows = _load_target(cfg, HEAT_TARGET, None, None)
    rows = val_rows[:4]
    imgs = torch.from_numpy(data["images"][rows].astype(np.float32) /
                            255.0).cuda()
    proc = torch.from_numpy(data["proc_scaled"][rows]).cuda()
    plain_h, plain_p = gradcam_heatmaps(model, spec, imgs, proc,
                                        impl="plain")
    res = cli.main(["heatmap", "--config", cfg_path, "--layers",
                    str(HEAT_LAYERS)])[HEAT_TARGET]
    dh = np.abs(res["heatmaps"] - plain_h).max()
    dp = np.abs(res["preds"] - plain_p).max()
    if res["heatmaps"].shape != (4, 8, 8) or dh > HEAT_TOL or \
            dp > HEAT_PRED_TOL * np.abs(plain_p).max():
        raise AssertionError(f"heatmap CLI vs plain: {res['heatmaps'].shape}"
                             f", max |diff| {dh:.3e}, preds {dp:.3e}")
    say(f"[9] cli heatmap --layers {HEAT_LAYERS}, CvT dw_bn/cls at 128px: "
        f"{dt:.2f} s (host clock), launches {launches}; 4 heatmaps 8x8 vs "
        f"the plain route max |diff| {dh:.3e}, preds {dp:.3e}; panels "
        + ("written" if have_mpl else "not written (no matplotlib)"))

    # gradcam_heatmaps at B 128 and at 512px (B 8), kernels vs plain
    rng = np.random.default_rng(SEED + 11)
    imgs = torch.from_numpy(rng.integers(0, 256, (BATCH, 128, 128, 1))
                            .astype(np.float32) / 255.0).cuda()
    proc = torch.from_numpy(rng.standard_normal((BATCH, 5))
                            .astype(np.float32)).cuda()
    _, result["gradcam_128px"] = gradcam_check(
        "128px", model, spec, imgs, proc, want, card, reps=5)
    del model, imgs, proc
    spec512 = cvt_highres_spec(512)
    model = init_cvt(spec512, torch.Generator().manual_seed(SEED),
                     device="cuda")
    imgs = torch.from_numpy(rng.integers(0, 256, (HEAT_512_BATCH, 512, 512,
                                                  1)).astype(np.float32) /
                            255.0).cuda()
    proc = torch.from_numpy(rng.standard_normal((HEAT_512_BATCH, 5))
                            .astype(np.float32)).cuda()
    want512 = {**zero_launches(), "attention_small": 2, "fused_mlp": 3,
               "flash_attention": 1}
    by_path["heatmap_512px"], result["gradcam_512px"] = gradcam_check(
        "512px", model, spec512, imgs, proc, want512, card, reps=3)
    del model, imgs, proc
    torch.cuda.empty_cache()

    # the params-only FFN through the command line, at the corpus's size
    ffn_cfg = ExperimentConfig(
        inputs="par", frequencies=(HEAT_TARGET,), data=ffn_data,
        train=TrainConfig(batch_size=BATCH, seed=SEED, epochs=FFN_EPOCHS),
        result_dir=os.path.join(root, "Result"))
    ffn_path = os.path.join(root, "ffn.json")
    save_config(ffn_cfg, ffn_path)
    reset_launches()
    trained = cli.main(["train", "--config", ffn_path])[(HEAT_TARGET, None)]
    tested = cli.main(["test", "--config", ffn_path])[(HEAT_TARGET, None)]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != zero_launches():
        raise AssertionError(f"the FFN launched a kernel: {launches}")
    by_path["ffn"] = launches
    paths = _paths(ffn_cfg, HEAT_TARGET)
    _, records = read_table(paths["records"])
    sheet = read_predictions_metrics(paths["metrics"])
    data, train_rows, val_rows = _load_target(ffn_cfg, HEAT_TARGET, None,
                                              None)
    if [r[0] for r in records] != list(range(1, FFN_EPOCHS + 1)) or \
            not np.isfinite(np.asarray([r[1:] for r in records],
                                       np.float64)).all() or \
            len(sheet["predictions"]) != len(val_rows) or \
            sheet["train_num"] != len(train_rows):
        raise AssertionError(f"FFN records {records}, metrics sheet "
                             f"{len(sheet['predictions'])} rows")
    params = load_checkpoint(latest_checkpoint(paths["weights"]))[0]
    x = data["proc_scaled"][val_rows]
    on_card = _predict_ffn(params, x, "cuda")
    on_cpu = _predict_ffn(params, x, "cpu")
    diff = np.abs(on_card - on_cpu)
    if (diff > FFN_TOL * np.maximum(1.0, np.abs(on_cpu))).any() or \
            np.abs(sheet["predictions"] - on_card).max() > \
            FFN_TOL * max(1.0, np.abs(on_card).max()):
        raise AssertionError(f"FFN card vs CPU: max |diff| {diff.max():.3e}")
    steps = -(-len(train_rows) // BATCH)
    later = (trained["seconds"] - trained["first_seconds"]) / (FFN_EPOCHS - 1)
    say(f"[9] cli train/test --inputs par: {len(train_rows)} train rows, "
        f"{steps} steps an epoch of {BATCH}, {FFN_EPOCHS} epochs: the first "
        f"{trained['first_seconds']:.3f} s (op by op, then its capture as a "
        f"CUDA graph), each later one {later:.4f} s ({1e3 * later / steps:.4f}"
        f" ms a step; host clock, the epoch with its validation; {card}); "
        f"launches none; records "
        f"{[[round(v, 5) for v in r[1:]] for r in records]}; R2 "
        f"{tested['r2']:.4f}; its checkpoint on the card vs the CPU: max "
        f"|diff| {diff.max():.3e} (limit {FFN_TOL} x max(1, |y|))")
    result["ffn"] = dict(ffn_train_check(ffn_cfg, data, train_rows, val_rows,
                                         root, card),
                         first_epoch_seconds=trained["first_seconds"],
                         seconds_per_epoch=later, steps_per_epoch=steps,
                         train_rows=len(train_rows), r2=tested["r2"])

    # the antialiased preprocessing, on the card against the CPU
    raw = torch.from_numpy(rng.integers(0, 256, (8, 345, 340, 3),
                                        dtype=np.uint8))
    on_card = preprocess_images_device(raw.cuda(), 224, 224, antialias=True)
    on_cpu = preprocess_images_device(raw, 224, 224, antialias=True)
    diff = (on_card.cpu() - on_cpu).abs().max().item()
    if on_card.shape != (8, 224, 224, 1) or diff > PREP_TOL:
        raise AssertionError(f"antialiased preprocessing card vs CPU: "
                             f"{tuple(on_card.shape)}, {diff:.3e}")
    raw_d = raw.cuda()
    ms = time_ms(lambda: preprocess_images_device(raw_d, 224, 224,
                                                  antialias=True))
    say(f"[9] preprocess_images_device(antialias=True), 8 x 345x340x3 -> "
        f"224: card vs CPU max |diff| {diff:.3e} (limit {PREP_TOL}); "
        f"{ms:.3f} ms (CUDA events; {card})")

    # label prep and the plotting subcommands on the fixture's sheets
    header, lab_rows = read_table(heat_data.excel_labels)
    planted = []
    for t in range(1, len(header)):
        r = 5 * (t % FFN_GROUPS) + t % 5  # one outlier a column
        lab_rows[r][t] = lab_rows[r][t] * 5.0
        planted.append((r, t))
    raw_path = os.path.join(root, "raw_labels.xlsx")
    write_xlsx(raw_path, {"Sheet1": [header] + lab_rows})
    out_path = os.path.join(root, "processed.xlsx")
    cli.main(["pickup", "--in", raw_path, "--out", out_path])
    _, picked = read_table(out_path)
    if any(picked[r][t] is not None for r, t in planted):
        raise AssertionError("pickup kept a planted outlier")
    glcm = os.path.join(root, "glcm")
    os.makedirs(glcm)
    write_xlsx(os.path.join(glcm, "Bm_lightgbm.xlsx"), {HEAT_TARGET: [
        [None, "Predictions", "True Values", "R2 Score"],
        [0, 1.1, 1.0, 0.9], [1, 1.9, 2.0, None]]})
    plots = {
        "plot-records": ["--records", paths["records"]],
        "plot-labels": ["--config", cfg_path],
        "plot-data": ["--config", cfg_path, "--params"],
        "model-plot": ["--config", cfg_path],
        "compare": ["--metrics-dir", os.path.dirname(paths["metrics"]),
                    "--glcm-dir", glcm, "--prop", "Bm"]}
    for cmd, argv in plots.items():
        out = os.path.join(root, f"{cmd}.png")
        rc = cli.main([cmd] + argv + ["--out", out])
        if (rc is None) != have_mpl or os.path.exists(out) != have_mpl:
            raise AssertionError(f"{cmd}: rc {rc}, wrote {os.path.exists(out)}"
                                 f", matplotlib {have_mpl}")
    say(f"[9] pickup emptied the {len(planted)} planted outliers; "
        f"{', '.join(plots)} " + ("wrote their PNGs" if have_mpl else
                                  "said that matplotlib is not installed"))

    line = format_line()
    if f"cuda:0 {torch.cuda.get_device_name(0)}" not in line:
        raise AssertionError(f"monitor line without the card: {line}")
    say(f"[9] monitor: {line}")
    native_check()
    shutil.rmtree(root)
    return by_path, result



# -- phase 10: the multi-target family's run tooling --------------------------

FAMILY_TARGET = "50HZ_Bm"  # phase 5's first target: 512 train, 128 val rows
FAMILY_REPEATS, FAMILY_EPOCHS, FAMILY_CKPT_EVERY = 3, 20, 10
FAMILY_STALL_EPOCH = 10    # the child's first attempt wedges this chunk
SWEEP_EPOCHS = 2
DEBUG_BATCH = 32
# The supervised child: run_many with (a)'s arguments under a short deadline;
# its first attempt wedges the dispatch of epoch FAMILY_STALL_EPOCH's chunk.
FAMILY_CHILD = """\
import os, sys, time
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
sys.dont_write_bytecode = True
repo, cfg_path, marker, deadline = sys.argv[1:5]
sys.path.insert(0, repo)
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
from transformer_stm_tpu_torch.config import load_config
from transformer_stm_tpu_torch.train.many import run_many
from transformer_stm_tpu_torch.train.multi import MultiTargetTrainer
from transformer_stm_tpu_torch.train.watchdog import HangWatchdog

if not os.path.exists(marker):
    open(marker, "w").close()
    run_epoch = MultiTargetTrainer.run_epoch

    def wedged(self, epoch):
        if epoch == {stall}:
            print("child: epoch {stall} wedged", flush=True)
            time.sleep(3600)
        return run_epoch(self, epoch)

    MultiTargetTrainer.run_epoch = wedged
wd = HangWatchdog(timeout_s=float(deadline), first_timeout_s=600.0,
                  poll_s=0.5).start()
run_many(load_config(cfg_path), "{target}", {epochs}, {repeats},
         impl="small", mlp_impl="pallas", watchdog=wd,
         checkpoint_every={every}, verbose=True)
wd.stop()
"""


def family_fixture(root):
    """Phase 5's corpus (2 groups x 5 pieces x 64 layers of 128x128) and
    sheets, the corpus written into the decode cache, where run_many's
    trainer and test_target read it."""
    data, corpus = multi_fixture(root)
    os.makedirs(data.cache_dir)
    npy, meta = _cache_paths(data)
    np.save(npy, corpus)
    with open(meta, "w") as f:
        json.dump({"decoded": list(range(corpus.shape[0]))}, f)
    return data


def family_cfg(data, root, name, epochs):
    """The flagship (CvTSpec(), img+par, 128px, dropout 0.1) at batch 128
    on FAMILY_TARGET, its artifacts under root/name."""
    return ExperimentConfig(
        model=CvTSpec(), data=data, frequencies=(FAMILY_TARGET,),
        train=TrainConfig(batch_size=BATCH, seed=SEED, epochs=epochs),
        result_dir=os.path.join(root, name))


@contextlib.contextmanager
def timed_calls(owner, name, log):
    """owner.name wrapped for the block: each call appends (its first
    argument, its host seconds between two synchronisations) to log."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((args[0], time.perf_counter() - t0))
        return out

    setattr(owner, name, wrapper)
    try:
        yield log
    finally:
        setattr(owner, name, real)


def nondeterministic_ops(caught):
    """The ops that warned they have no deterministic implementation."""
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def family_launches(trainers, epochs, eval_batches=0):
    """Exact launch counts of fit(epochs) for each trainer and of
    eval_batches evaluation batches (``TrainLoop.predict``, impl "auto": 1
    attention_small and 3 fused_mlp a batch); with the slot-steps and
    validation batches.  A slot-step launches attention_small forward and
    backward once under impl "auto" (stage 1) and 3 times under "small"
    (every stage), and the training MLP 3 times each way with mlp_impl
    "pallas"; a validation batch 1 attention_small and 3 fused_mlp under
    "auto", 3 attention_small and no MLP kernel under "small" (its MLP
    runs plain, as JAX's evaluation MLP does)."""
    want = {**zero_launches(), "attention_small": eval_batches,
            "fused_mlp": 3 * eval_batches}
    steps = val = 0
    for t in trainers:
        s_ = epochs * int((-(-t.n_train // BATCH)).sum())
        v_ = epochs * len(t.targets) * t.n_val_steps
        attn = 3 if t.impl == "small" else 1
        mlp = 3 if t.mlp_impl in ("pallas", "flash") else 0
        want["attention_small"] += attn * (s_ + v_)
        want["attention_small_bwd"] += attn * s_
        want["fused_mlp"] += 0 if t.impl == "small" else 3 * v_
        want["fused_mlp_train"] += mlp * s_
        want["fused_mlp_train_bwd"] += mlp * s_
        steps, val = steps + s_, val + v_
    return want, steps, val


def stacked_final(result_dir):
    """(records, arrays) of the newest stacked checkpoint of the repeat
    study under result_dir."""
    ck = latest_checkpoint(os.path.join(
        result_dir, "Weight", "Images & Parameters",
        f"many_{FAMILY_TARGET}.ckpts"))
    with open(ck[:-4] + ".json") as f:
        records = json.load(f)["records"]
    with np.load(ck) as z:
        return records, {k: z[k] for k in z.files}


def family_many(data, root):
    """(a) run_many: 3 repeats x 20 epochs under a caller's watchdog, with
    exact launch counts, the summary read back."""
    from transformer_stm_tpu_torch.train.many import run_many
    from transformer_stm_tpu_torch.train.watchdog import HangWatchdog

    cfg = family_cfg(data, root, "Result_a", FAMILY_EPOCHS)
    wd = HangWatchdog(timeout_s=600.0, poll_s=1.0,
                      log=lambda msg: say(f"[10] {msg}")).start()
    fits, evals = [], []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            timed_calls(MultiTargetTrainer, "fit", fits), \
            timed_calls(harness, "test_target", evals):
        warnings.simplefilter("always")
        summary = run_many(cfg, FAMILY_TARGET, FAMILY_EPOCHS, FAMILY_REPEATS,
                           impl="small", mlp_impl="pallas", watchdog=wd,
                           checkpoint_every=FAMILY_CKPT_EVERY, verbose=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    wd.stop()
    (tr, fit_s), = fits
    n_val = int(tr.n_val[0])
    eval_batches = FAMILY_REPEATS * -(-n_val // BATCH)
    want, steps, val = family_launches([tr], FAMILY_EPOCHS, eval_batches)
    say(f"[10] (a) run_many: {FAMILY_REPEATS} repeats of {FAMILY_TARGET} "
        f"(n_train {tr.n_train.tolist()}, n_val {tr.n_val.tolist()}), "
        f"{FAMILY_EPOCHS} epochs in chunks of {tr.epochs_per_call}, a "
        f"stacked checkpoint every {FAMILY_CKPT_EVERY}: {steps} slot-steps, "
        f"{val} validation batches, {eval_batches} evaluation batches; "
        f"launches {launches}")
    if launches != want:
        raise AssertionError(f"run_many launches {launches}, want {want}")
    with open(os.path.join(cfg.result_dir,
                           f"cvt_many_{FAMILY_TARGET}_summary.json")) as f:
        back = json.load(f)
    runs = back["runs"]
    if back != json.loads(json.dumps(summary)) or \
            [r["time"] for r in runs] != list(range(1, FAMILY_REPEATS + 1)) \
            or [r["seed"] for r in runs] != [1000 + t for t in range(
                1, FAMILY_REPEATS + 1)] or not all(
                np.isfinite([r[k] for k in ("r2", "mse", "mae")]).all()
                for r in runs):
        raise AssertionError(f"run_many summary {back}")
    for k in ("r2", "mse", "mae"):
        v = np.array([r[k] for r in runs])
        st = back["stats"][k]
        if not np.allclose([st["mean"], st["std"], st["min"], st["max"]],
                           [v.mean(), v.std(ddof=1), v.min(), v.max()],
                           rtol=1e-12, atol=0):
            raise AssertionError(f"run_many stats {k}: {st} from {v}")
    records, _ = stacked_final(cfg.result_dir)
    if [len(r) for r in records] != [FAMILY_EPOCHS] * FAMILY_REPEATS or \
            [o.step for o in tr.opts] != \
            (FAMILY_EPOCHS * -(-tr.n_train // BATCH)).tolist():
        raise AssertionError("run_many records or Adam counts")
    step_ms = 1e3 * fit_s / steps
    eval_s = [s_ for _, s_ in evals]
    nondet = nondeterministic_ops(caught)
    say(f"[10] (a) summary read back: r2 {[r['r2'] for r in runs]}, stats "
        f"{back['stats']}; fit {fit_s:.2f} s = {step_ms:.2f} ms per "
        f"slot-step (host clock, validation and checkpoints included); "
        f"evaluation {[round(x, 3) for x in eval_s]} s per repeat; run_many "
        f"{total:.2f} s; ops without a deterministic implementation: "
        f"{nondet or 'none'}")
    return launches, {"seconds": total, "fit_seconds": fit_s,
                      "slot_steps": steps, "ms_per_slot_step": step_ms,
                      "eval_seconds": eval_s, "stats": back["stats"],
                      "nondeterministic_ops": nondet}, cfg


def family_resume(data, root, a_cfg, a):
    """(b) The supervisor respawns a child that the watchdog force-exits
    inside its epoch-10 chunk; the second attempt resumes from the epoch-10
    stack and finishes equal to (a) bit for bit."""
    from transformer_stm_tpu_torch.train.supervisor import (COMPLETION_MARKER,
                                                            supervise)

    cfg = family_cfg(data, root, "Result_b", FAMILY_EPOCHS)
    cfg_path = os.path.join(root, "many_b.json")
    save_config(cfg, cfg_path)
    child = os.path.join(root, "child.py")
    with open(child, "w") as f:
        f.write(FAMILY_CHILD.format(
            stall=FAMILY_STALL_EPOCH, target=FAMILY_TARGET,
            epochs=FAMILY_EPOCHS, repeats=FAMILY_REPEATS,
            every=FAMILY_CKPT_EVERY))
    log = os.path.join(root, "supervisor.log")
    # twice a chunk of (a) (fit_seconds covers two), which leaves room for
    # a fresh process's first chunk
    deadline = max(20.0, a["fit_seconds"])
    t0 = time.perf_counter()
    rc = supervise([sys.executable, child,
                    os.path.dirname(os.path.abspath(__file__)), cfg_path,
                    os.path.join(root, "child.attempted"), str(deadline)],
                   max_attempts=3, retry_delay_s=1, log_path=log,
                   env={"PYTHONDONTWRITEBYTECODE": "1"})
    dt = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    marks = [ln for ln in text.splitlines()
             if ln.startswith(("===", "[watchdog]", "child:", "resumed"))]
    say(f"[10] (b) supervisor rc {rc} in {dt:.1f} s, deadline "
        f"{deadline:.1f} s; log: " + " | ".join(marks))
    stall = (f"'multi-epoch @ {FAMILY_STALL_EPOCH}' exceeded its deadline")
    if rc != 0 or text.count("=== supervisor attempt") != 2 or \
            "=== supervisor: watchdog stall; retry in 1s ===" not in text \
            or stall not in text or COMPLETION_MARKER not in text or \
            f"resumed at epoch {FAMILY_STALL_EPOCH}" not in text:
        raise AssertionError("supervised run: " + text[-4000:])
    with open(os.path.join(cfg.result_dir,
                           f"cvt_many_{FAMILY_TARGET}_summary.json")) as f:
        sb = json.load(f)
    with open(os.path.join(a_cfg.result_dir,
                           f"cvt_many_{FAMILY_TARGET}_summary.json")) as f:
        sa = json.load(f)
    rec_a, arr_a = stacked_final(a_cfg.result_dir)
    rec_b, arr_b = stacked_final(cfg.result_dir)
    same_w = arr_a.keys() == arr_b.keys() and all(
        np.array_equal(arr_a[k], arr_b[k]) for k in arr_a)
    ra, rb = np.asarray(rec_a, np.float64), np.asarray(rec_b, np.float64)
    rel = float((np.abs(ra - rb) / np.maximum(np.abs(ra), 1e-30)).max())
    bitwise = sa == sb and rec_a == rec_b and same_w
    say(f"[10] (b) resumed run against (a): summary equal {sa == sb}, "
        f"records equal {rec_a == rec_b}, final stacked weights equal "
        f"{same_w}; records max rel diff {rel:.3e}")
    if not bitwise:
        ops = a["nondeterministic_ops"]
        if not ops or rel > MULTI_LOSS_TOL:
            raise AssertionError(
                f"the resumed run differs from the uninterrupted one (max "
                f"rel diff {rel:.3e}; ops without a deterministic "
                f"implementation: {ops or 'none'})")
        say(f"[10] (b) within MULTI_LOSS_TOL {MULTI_LOSS_TOL} relative: "
            f"{ops} have no deterministic implementation")
    return {"seconds": dt, "deadline_s": deadline, "bit_equal": bitwise,
            "records_max_rel_diff": rel}


def family_sweep(data, root):
    """(c) The sweep through the command line: 2 dropout groups of 2 slots,
    exact launch counts, the JSON read back, its scale-1 seed-0 point equal
    to a one-slot trainer; the FFN's sweep with no launch."""
    cfg = family_cfg(data, root, "Result_c", SWEEP_EPOCHS)
    cfg_path = os.path.join(root, "sweep.json")
    save_config(cfg, cfg_path)
    fits = []
    with timed_calls(MultiTargetTrainer, "fit", fits):
        launches, secs = cli_launches(
            ["sweep", "--config", cfg_path, "--lr", "1e-3,1e-4",
             "--dropout", "0.0,0.1", "--seeds", "0"])
    trainers = [t for t, _ in fits]
    want, steps, val = family_launches(trainers, SWEEP_EPOCHS)
    say(f"[10] (c) cli sweep --lr 1e-3,1e-4 --dropout 0.0,0.1 --seeds 0: "
        f"{len(trainers)} trainers of {[len(t.targets) for t in trainers]} "
        f"slots (dropout {[t.spec.stages[0].dropout_rate for t in trainers]}"
        f"), {steps} slot-steps and {val} validation batches in "
        f"{secs:.2f} s; launches {launches}")
    if launches != want or [len(t.targets) for t in trainers] != [2, 2]:
        raise AssertionError(f"sweep launches {launches}, want {want}")
    with open(os.path.join(cfg.result_dir,
                           f"sweep_{FAMILY_TARGET}_img_par.json")) as f:
        summary = json.load(f)
    mses = [r["val_mse"] for r in summary["results"]]
    if summary["n_points"] != 4 or mses != sorted(mses) or \
            summary["best"] != summary["results"][0] or \
            not np.isfinite(mses).all():
        raise AssertionError(f"sweep summary {summary}")
    # the point at scale 1 and seed 0 of the 0.1 group: slot 0 of the
    # second trainer, against a one-slot trainer of that target and seed
    tr = trainers[1]
    if tr.targets[0] != (FAMILY_TARGET, 0, "sweep2") or \
            tr.lr_scales_np[0] != 1.0 or tr.spec.stages[0].dropout_rate != 0.1:
        raise AssertionError(f"sweep group {tr.targets} {tr.lr_scales_np}")
    one = MultiTargetTrainer(tr.cfg, [(FAMILY_TARGET, 0, "sweep2")],
                             device="cuda")
    one.fit(SWEEP_EPOCHS, verbose=False)
    point = next(r for r in summary["results"] if r.get("dropout") == 0.1
                 and r["lr"] == 1e-3 and r["seed"] == 0)
    if one.records[0] != tr.records[0] or \
            point["val_mse"] != one.records[0][-1][3]:
        raise AssertionError(f"sweep slot {tr.records[0]} vs one-slot "
                             f"trainer {one.records[0]}")
    say(f"[10] (c) best {summary['best']}; the scale-1 seed-0 point of the "
        f"0.1 group equals a one-slot trainer bit for bit (records "
        f"{one.records[0]})")
    par, par_s = cli_launches(["sweep", "--config", cfg_path, "--inputs",
                               "par", "--hidden", "8,16"])
    with open(os.path.join(cfg.result_dir,
                           f"sweep_{FAMILY_TARGET}_par.json")) as f:
        ffn = json.load(f)
    if any(par.values()) or ffn["n_points"] != 2 or \
            sorted(r["hidden"] for r in ffn["results"]) != [8, 16] or \
            not np.isfinite([r["val_mse"] for r in ffn["results"]]).all():
        raise AssertionError(f"FFN sweep: launches {par}, summary {ffn}")
    say(f"[10] (c) cli sweep --inputs par --hidden 8,16: no launch, "
        f"{par_s:.2f} s, best {ffn['best']}")
    return launches, {"seconds": secs, "best": summary["best"],
                      "ffn_seconds": par_s}


def family_debug(data, root):
    """(d) debug_mode on a full-width forward and backward through the
    kernels, bit-equal to the same calls outside it; two planted NaNs
    trapped and named; trace() around two slot-steps; StepTimer."""
    from transformer_stm_tpu_torch.debug import debug_mode
    from transformer_stm_tpu_torch.tools.profiling import (
        StepTimer, annotate, device_memory_summary, trace)

    model = init_cvt(CvTSpec(), torch.Generator().manual_seed(SEED),
                     device="cuda")
    rng = np.random.default_rng(SEED + 10)
    x = torch.from_numpy(rng.integers(0, 256, (DEBUG_BATCH, 128, 128, 1))
                         .astype(np.float32) / 255).to("cuda")
    proc = torch.from_numpy(rng.standard_normal((DEBUG_BATCH, 5))
                            .astype(np.float32)).to("cuda")

    def fwd_bwd(m):
        m.requires_grad_(True)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        out = cvt_forward(m, x, proc, train=True, generator=gen,
                          impl="small", mlp_impl="pallas")
        grads = torch.autograd.grad(out.square().mean(),
                                    list(m.parameters()))
        return [out.detach(), *grads]

    clean = fwd_bwd(copy.deepcopy(model))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with debug_mode() as dbg:
        checked = fwd_bwd(copy.deepcopy(model))
    torch.cuda.synchronize()
    debug_s = time.perf_counter() - t0
    launches = read_launches()
    want = {**zero_launches(), "attention_small": 3,
            "attention_small_bwd": 3, "fused_mlp_train": 3,
            "fused_mlp_train_bwd": 3}  # impl "small": every stage
    if launches != want or not all(map(torch.equal, clean, checked)):
        raise AssertionError(f"debug_mode: launches {launches}, outputs and "
                             "gradients equal: "
                             f"{[torch.equal(a, b) for a, b in zip(clean, checked)]}")
    say(f"[10] (d) debug_mode, full-width forward and backward at B "
        f"{DEBUG_BATCH}: output and {len(clean) - 1} gradients bit-equal to "
        f"the same calls outside it; {dbg.ops} aten ops and {dbg.kernels} "
        f"kernel launches checked in {debug_s:.2f} s; launches {launches}")
    trapped = {}
    for name, expect in (("stages.0.embed.proj.kernel", "aten.convolution"),
                         ("stages.0.blocks.0.mlp.fc1.kernel",
                          "the fused_mlp_train kernel")):
        bad = copy.deepcopy(model)
        with torch.no_grad():
            dict(bad.named_parameters())[name].view(-1)[0] = float("nan")
        try:
            with debug_mode():
                fwd_bwd(bad)
        except FloatingPointError as e:
            trapped[name] = str(e)
        if expect not in trapped.get(name, ""):
            raise AssertionError(f"NaN in {name}: {trapped.get(name)!r}, "
                                 f"want {expect}")
        say(f"[10] (d) NaN planted in {name}: {trapped[name]}")

    tr = MultiTargetTrainer(family_cfg(data, root, "Result_d", 1),
                            [(FAMILY_TARGET, 0, None),
                             (FAMILY_TARGET, 1, None)],
                            mlp_impl="pallas", device="cuda")
    plan = tr.epoch_plan(0)
    acc = torch.zeros(len(tr.targets), 3, device="cuda")
    tr.train_step(0, 0, plan, acc)  # warm
    trace_dir = os.path.join(root, "trace")
    with trace(trace_dir):
        with annotate("two slot-steps"):
            tr.train_step(0, 1, plan, acc)
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {pat: sum(pat in k for k in kernels) for pat in (
        "flash_fwd_tf32x3", "flash_bwd_tf32x3", "fused_mlp_tf32x3",
        "mlp_bwd_tf32x3")}
    if len(files) != 1 or not all(found.values()) or \
            "two slot-steps" not in {e["name"] for e in events}:
        raise AssertionError(f"trace {files}: kernels {found}")
    say(f"[10] (d) trace() around two slot-steps: {len(events)} events, "
        f"{len(kernels)} kernel names, the attention and training-MLP "
        f"kernels among them ({found}); the annotation recorded")
    timer = StepTimer(warmup=1)
    for s_ in range(6):
        with timer:
            tr.train_step(0, s_ % 4, plan, acc)
    st = timer.summary(items_per_step=len(tr.targets) * BATCH)
    say(f"[10] (d) StepTimer over 2-slot steps: {st}; "
        f"{device_memory_summary()}")
    return {"debug_seconds": debug_s, "ops_checked": dbg.ops,
            "kernels_checked": dbg.kernels, "trapped": trapped,
            "step_timer": st}


def phase_family(card):
    """The multi-target family's run tooling at the flagship's full width:
    (a) the repeat study, (b) its resume after a watchdog force-exit under
    the supervisor, (c) the sweep through the command line, (d) debug_mode,
    trace() and StepTimer; all under deterministic algorithms."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the child of (b) shares the card
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    root = tempfile.mkdtemp()
    try:
        data = family_fixture(root)
        many, a, a_cfg = family_many(data, root)
        a["resume"] = family_resume(data, root, a_cfg, a)
        sweep, c = family_sweep(data, root)
        d = family_debug(data, root)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
        shutil.rmtree(root)
    dt = time.perf_counter() - t0
    say(f"[10] the multi-target family in {dt:.1f} s ({card})")
    return {"many": many, "sweep": sweep}, {
        "seconds": dt, "many": a, "sweep": c, "debug": d}


def main():
    card = phase_env()
    phase_build()
    kernels = phase_kernels()
    by_path = {"evaluation": phase_main_path(),
               "single_target_training": phase_training(kernels),
               "multi_target_training": phase_multi(kernels)}
    by_path["cli_512px"], _ = phase_cli()
    by_path["vit_inference"], vit_kernels = phase_vit(kernels, card)
    by_path["vit_finetune"], finetune = phase_finetune(card)
    analysis_paths, analysis = phase_analysis(card)
    by_path.update(analysis_paths)
    family_paths, family = phase_family(card)
    by_path.update(family_paths)
    kernels += vit_kernels
    for k in kernels:
        # the launches of the path each kernel belongs to: the ViT path for
        # the fused-layer kernels, the multi-target trainer for the training
        # MLP, the 512px CLI run for the rest
        main_path = ("vit_inference" if k["name"] in VIT_KERNELS else
                     "multi_target_training" if k["name"].startswith(
                         "fused_mlp_train") else "cli_512px")
        k["launches"] = by_path[main_path][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
    faulthandler.cancel_dump_traceback_later()
    say(card)
    say(json.dumps({"kernels": kernels, "vit_finetune_steps": finetune,
                    "analysis": analysis, "family": family}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
