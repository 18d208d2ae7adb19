"""Where the bf16 fused ViT layer spends its time, phase by phase, on the card.

    python3 -m transformer_stm_tpu_torch.tools.profile_fused_layer_phases \
        [--batch B] [--int8]

Builds a copy of ``csrc/vit_layer_sm90.cu`` with `clock64()` spans inserted
at fixed lines (the committed source stays as it is), loads it in place of
the kernel library, and runs ``vit_layer_infer`` (with ``--int8``
``vit_layer_infer_int8``, the kernel's mode 7, spans ``ANCHORS_INT8``) at
ViT-S/16 widths (E 384, H 6, hidden 1536, 197 tokens padded to 200) in
bfloat16 at batch B (192).
Thread 0 of each block (a consumer) adds the cycles since its previous mark
to the phase that the mark closes.  The table gives each phase's share of
the summed cycles and that share of the uninstrumented kernel's time (CUDA
events around 10 back-to-back calls, median of 5).  The spans anchor on
whole lines of the source (``ANCHORS``); a line that is missing raises, and
tests/test_torch_profile_phases.py checks them against the source on the
CPU.
"""

import argparse
import ctypes
import math
import statistics
import subprocess
import tempfile
from pathlib import Path

PRELUDE = r"""
__device__ unsigned long long prof_cycles[32];
__device__ unsigned long long prof_marks[32];
__device__ long long prof_last_at[4096];  // per block: the last mark
#define prof_last prof_last_at[blockIdx.x]
#define PROF(k)                                                          \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long prof_now = clock64();                              \
      atomicAdd(&prof_cycles[k],                                         \
                (unsigned long long)(prof_now - prof_last));              \
      atomicAdd(&prof_marks[k], 1ull);                                   \
      prof_last = prof_now;                                              \
    }                                                                    \
  } while (0)
"""

EPILOGUE = r"""
extern "C" int prof_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, prof_cycles, sizeof(prof_cycles));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 32, prof_marks, sizeof(prof_marks));
  return (int)e;
}
extern "C" int prof_reset() {
  unsigned long long zero[32] = {0};
  cudaError_t e = cudaMemcpyToSymbol(prof_cycles, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(prof_marks, zero, sizeof(zero));
  return (int)e;
}
"""

INIT = "if (threadIdx.x == 0) prof_last = clock64();"

# (line anchor, its occurrence (0 the first), "before" or "after", code):
# a mark PROF(k) closes phase k.
SOURCE = "vit_layer_sm90.cu"
ANCHORS = [
    ("  Ring ring{0, 0, 0, 0};", 0, "after", INIT),
    ("    if (threadIdx.x == 0) sm.item[it & 1] = atomicAdd(p.flags, 1);", 0,
     "before", "PROF(0);"),
    ("    bar_sync(0, THREADS);  // the block has finished the previous item",
     1, "after", "PROF(1);"),
    ("    ln_x(p.g1, p.be1);", 0, "after", "PROF(2);"),
    ("    atomicAdd(&p.flags[1 + idx], 1);", 0, "after", "PROF(3);"),
    ("      ring.attn_phase ^= 1;", 0, "after", "PROF(4);"),
    ("        atomicAdd(&p.flags[1 + p.tiles + idx / p.H], 1);", 0, "after",
     "PROF(5);"),
    ("      mma_loop(acc, HD / KT, sm.full, sm.empty, stage, phase, "
     "stage_a, stage_b);", 0, "before",
     "if (c0 == 0) { mbar_wait(&sm.full[stage], phase); PROF(13); }"),
    ("    // LN2 into the slot (above, from the registers, where E <= 2 NW)", 0,
     "before", "PROF(6);"),
    # the bf16 merged mode's: after the int8 layer's item A and C and the
    # bf16 item A's
    ("    bar_sync(BAR_ALL, THREADS);", 3, "after", "PROF(7);"),
    ("      for (int st = 0; st < nst1; ++st) issue_fc1(hacc);", 0, "after",
     "PROF(8);"),
    ("        drain();  // this chunk's fc1 and the previous chunk's fc2 are done",
     0, "after", "PROF(10);"),
    ("        gelu(hacc, hc);", 0, "after", "PROF(12);"),
    ("        bar_sync(BAR_CONSUMERS, CONSUMERS);  // both have read the "
     "previous chunk", 0, "after", "PROF(11);"),
    ("        fence_proxy_shared();", 0, "before", "PROF(14);"),
    ("        bar_sync(BAR_CONSUMERS, CONSUMERS);  // the chunk is in hbuf", 0,
     "after", "PROF(9);"),
    ("      fence_acc(yacc);", 0, "after", "PROF(17);"),
    ("      mma_loop(acc, HD / KT, sm.full, sm.empty, stage, phase, "
     "stage_a, stage_b);", 0, "after", "PROF(15);"),
    ("      mma_loop(acc, E / KT, sm.full, sm.empty, stage, phase, stage_a, "
     "stage_b);", 0, "after", "PROF(16);"),
]
# the phase each PROF(k) closes, by k
PHASES = ["C: y epilogue (end of the previous item)", "wait for the block",
    "A: LN1", "A: q|k|v epilogue", "B: wait for q|k|v (deps + TMA)",
    "B: attention", "C: z, LN2 from registers", "C: LN2 (from the slot)",
    "C: the first chunk's fc1", "C: h fence + barrier",
    "C: fc2 with the next chunk's fc1 (to the drain)",
    "C: wait for the other warpgroup", "C: GELU",
    "C: wait for the heads (deps + TMA of o)", "C: h into shared memory",
    "C: out projection products", "A: q|k|v products",
    "C: the last chunk's fc2 (to the drain)"]

# the int8 layer's spans (mode 7): its items A and C and the attention
ANCHORS_INT8 = [
    ("  Ring ring{0, 0, 0, 0};", 0, "after", INIT),
    ("    if (threadIdx.x == 0) sm.item[it & 1] = atomicAdd(p.flags, 1);", 0,
     "before", "PROF(0);"),
    ("    bar_sync(0, THREADS);  // the block has finished the previous item",
     1, "after", "PROF(1);"),
    ("      ring.x_phase ^= 1;", 1, "after", "PROF(2);"),
    ("        p.slot_w, qs);", 0, "after", "PROF(3);"),
    ("    bar_sync(BAR_ALL, THREADS);", 0, "after", "PROF(4);"),
    ("      dequant_acc(acc, sx, p.sqkv, p.bqkv, cw, N3);", 0, "before",
     "PROF(5);"),
    ("    atomicAdd(&p.flags[1 + idx], 1);", 0, "after", "PROF(6);"),
    ("      ring.attn_phase ^= 1;", 0, "after", "PROF(7);"),
    ("        atomicAdd(&p.flags[1 + p.tiles + idx / p.H], 1);", 0, "after",
     "PROF(8);"),
    ("    ring.x_phase ^= 1;", 0, "after", "PROF(9);"),
    ("      slot, p.slot_w, qs);", 0, "after", "PROF(10);"),
    ("  slot_ready();", 0, "after", "PROF(11);"),
    ("    mma_loop(acc, cdiv(HD, KQ), sm.full, sm.empty, stage, phase, "
     "stage_a, stage_b);", 0, "after", "PROF(12);"),
    ("  bar_sync(BAR_CONSUMERS, CONSUMERS);  // z is in its slot", 0, "after",
     "PROF(13);"),
    ("      p.eps, slot, p.slot_w, qs);", 0, "after", "PROF(14);"),
    ("  slot_ready();", 1, "after", "PROF(15);"),
    ("    mma_loop(acc, cdiv(E, KQ), sm.full, sm.empty, stage, phase, "
     "stage_a, stage_b);", 0, "after", "PROF(16);"),
    ("  // the rows' maxima meet: over each quad, then across the warpgroups",
     0, "before", "PROF(17);"),
    ("  bar_sync(BAR_CONSUMERS, CONSUMERS);  // the maxima, and the hidden, "
     "are in place", 0, "after", "PROF(18);"),
    ("  slot_ready();", 2, "before", "PROF(19);"),
    ("  slot_ready();", 2, "after", "PROF(20);"),
    ("    mma_loop(acc, cdiv(HID, KQ), sm.full, sm.empty, stage, phase, "
     "stage_a, stage_b);", 0, "after", "PROF(21);"),
    ("  ring.stage = stage, ring.phase = phase;", 1, "before", "PROF(22);"),
]
PHASES_INT8 = [
    "end of the previous item (C: fc2's last epilogue)", "wait for the block",
    "A: wait for the x tile (TMA)", "A: LN1 and its quantisation",
    "A: barrier", "A: q|k|v products (and the previous pass's epilogue)",
    "A: q|k|v epilogue (the last pass)", "B: wait for q|k|v (deps + TMA)",
    "B: attention", "C: wait for the heads (deps + TMA of o)",
    "C: o quantised", "C: barrier (oq in the slot)", "C: out projection products",
    "C: z epilogue", "C: LN2 and its quantisation", "C: barrier (zq)",
    "C: fc1 products (and the previous pass's GELU, hidden slot)",
    "C: fc1 epilogue, the last pass (GELU, hidden slot)", "C: row maxima meet",
    "C: hidden quantised", "C: barrier (hq)",
    "C: fc2 products (and the previous pass's epilogue)",
    "C: fc2 epilogue, the last pass"]


def patch(text, anchors=ANCHORS):
    """text with the spans' prelude, each anchor's code before or after
    its line and the counters' readers at the end."""
    lines = text.split("\n")
    out = [PRELUDE]
    edits = {}
    for anchor, nth, where, code in anchors:
        hits = [i for i, line in enumerate(lines) if line == anchor]
        if len(hits) <= nth:
            raise ValueError(f"anchor not found: {anchor!r} #{nth}")
        edits.setdefault(hits[nth], []).append((where, code))
    for i, line in enumerate(lines):
        for where, code in edits.get(i, []):
            if where == "before":
                out.append(code)
        out.append(line)
        for where, code in edits.get(i, []):
            if where == "after":
                out.append(code)
    return "\n".join(out) + EPILOGUE


def time_ms(fn, calls=10, reps=5, warmup=2):
    """Device time of fn() in ms: CUDA events around `calls` back-to-back
    calls, divided by calls, median of `reps` (chip_smoke's
    time_ms_batched)."""
    import torch
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--int8", action="store_true",
                    help="profile vit_layer_infer_int8 (mode 7)")
    args = ap.parse_args()
    anchors, phases = ((ANCHORS_INT8, PHASES_INT8) if args.int8
                       else (ANCHORS, PHASES))
    import torch

    from transformer_stm_tpu_torch.kernels import _build, fused_layer
    from transformer_stm_tpu_torch.ops.attention import MHA
    from transformer_stm_tpu_torch.ops.blocks import MLP
    from transformer_stm_tpu_torch.ops.common import LayerNorm

    src_dir = Path(__file__).resolve().parents[1] / "csrc"
    text = patch((src_dir / SOURCE).read_text(), anchors)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    e, h, t, tp, b = 384, 6, 197, 200, args.batch
    # chip_smoke.vit_layer's weights: kernels N(0, 1/fan_in), the rest
    # N(0, 0.01) about 0 (biases, betas) or 1 (gammas)
    g = torch.Generator().manual_seed(0)
    mods = (LayerNorm(e), MHA(e, h), LayerNorm(e), MLP(e, 4 * e))
    with torch.no_grad():
        for m in mods:
            for name, prm in m.named_parameters():
                r = torch.randn(prm.shape, generator=g)
                if name.endswith("kernel"):
                    fan = prm.shape[0] * (prm.shape[1] if name.startswith(
                        "out") else 1)
                    prm.copy_(r / math.sqrt(fan))
                else:
                    prm.copy_(0.1 * r + (1.0 if name == "gamma" else 0.0))
    mods = [m.to("cuda", torch.bfloat16) for m in mods]
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(b, tp, e, device="cuda", generator=gen)
    x[:, t:] = 0.0
    x = x.reshape(b * tp, e).to(torch.bfloat16)

    layer = (fused_layer.vit_layer_infer_int8 if args.int8
             else fused_layer.vit_layer_infer)

    def run():
        return layer(x, *mods, t_pad=tp, t_real=t)

    with torch.inference_mode():
        plain_ms = time_ms(run)  # the committed kernel
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / SOURCE
            src.write_text(text)
            for hdr in src_dir.glob("*.cuh"):
                (Path(tmp) / hdr.name).write_bytes(hdr.read_bytes())
            lib_path = Path(tmp) / "libprof.so"
            subprocess.run([_build.find_nvcc(), *_build.ARCH, *_build.FLAGS,
                            "-shared", "-o", str(lib_path), str(src)],
                           check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(lib_path))
        for sym, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, sym):
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        fused_layer.library = lambda: lib
        prof_ms = time_ms(run)
        lib.prof_reset()
        reps = 5
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if lib.prof_read(buf) != 0:
        raise RuntimeError("prof_read failed")
    cycles = [buf[i] / reps for i in range(len(phases))]
    total = sum(cycles)
    print(f"{SOURCE}{' mode 7 (int8)' if args.int8 else ''} at ViT-S, B {b}, "
          f"bf16 ({b * tp} folded rows); {card}")
    print(f"kernel {plain_ms:.3f} ms uninstrumented, {prof_ms:.3f} ms with "
          "the spans (CUDA events, 10 calls back to back, median of 5)")
    print(f"{'phase':60s} {'share':>7s} {'ms':>8s} {'marks':>8s}")
    for i, name in enumerate(phases):
        share = cycles[i] / total if total else math.nan
        print(f"{name:60s} {100 * share:6.1f}% {share * plain_ms:8.3f} "
              f"{buf[32 + i] // reps:8d}")


if __name__ == "__main__":
    main()
