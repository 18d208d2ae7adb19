"""The training MLP backward's kernel kinds, timed against each other on the card.

    python3 -m transformer_stm_tpu_torch.tools.compare_mlp_bwd_kinds \
        [--rounds R] [--out FILE]

``csrc/fused_mlp_train.cu`` picks, for each width D, a dx kernel
(``dx_kind``) and a weight-partial kernel (``dw_kind``) among the kinds of
its ``enum``.  This tool builds copies of that source with the two
functions' choices at the CvT widths replaced (``BUILDS``: a kind for D 64,
128 and 256 each; the ViT widths keep the committed choice, and the
committed source stays as it is), all ``nvcc`` processes started together,
loads each in place of the kernel library, and runs ``fused_mlp_train_bwd``
at the CvT stage shapes of one batch of 128 (chip_smoke's ``MLP_SHAPES``)
at rate 0.1 on the same inputs.  Each build's result must lie within
MLP_TOL (1e-4 of the largest entry) of the plain version.  Per build and
shape it reports the call's time (CUDA events, one call alone, median of
10) and each of its kernels' device time (torch.profiler, mean over 10
calls).  The rounds walk the builds in a rotated order R times (3), so the
spread between rounds stands beside the differences between kinds.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

SOURCE = "fused_mlp_train.cu"
WIDTHS = (64, 128, 256)
SHAPES = [(128 * 1024, 64), (128 * 256, 128), (128 * 65, 256)]  # (N, D)
RATE = 0.1
MLP_TOL = 1e-4
# name: (dx kind at D 64, 128, 256), (weight kind at D 64, 128, 256); None
# keeps the committed choice
BUILDS = {
    "committed": None,
    "general": (("DX", "DX", "DX"), ("DW", "DW", "DW")),
    "dws": (("DX1", "DX1", "DX"), ("DWS", "DWS", "DW")),
}
_KIND_LINE = re.compile(
    r"^__host__ __device__ constexpr int (dx_kind|dw_kind)\(int D\) \{ "
    r"return .*; \}$", re.M)


def patch(text, kinds):
    """text with dx_kind and dw_kind returning the given kinds at the CvT
    widths, each a (D 64, D 128, D 256) triple of the enum's names, and
    their committed choice at any other width."""
    enum = re.search(r"enum \{([^}]*)\};", text)
    names = {n.split("=")[0].strip() for n in enum.group(1).split(",")} \
        if enum else set()
    lines = _KIND_LINE.findall(text)
    if sorted(lines) != ["dw_kind", "dx_kind"]:
        raise ValueError("dx_kind/dw_kind lines not found in " + SOURCE)
    for name, triple in zip(("dx_kind", "dw_kind"), kinds):
        if len(triple) != len(WIDTHS) or not set(triple) <= names:
            raise ValueError(f"{name}: {triple} not kinds of {sorted(names)}")
        body = " : ".join(f"D == {d} ? {k}" for d, k in zip(WIDTHS, triple))
        text = re.sub(
            rf"^(__host__ __device__ constexpr int {name}\(int D\) \{{ "
            r"return )(.*)(; \}$)",
            lambda m: f"{m[1]}{body} : ({m[2]}){m[3]}", text, count=1,
            flags=re.M)
    return text


def build_all(src_dir, tmp, builds):
    """{name: ctypes library} for each build, compiled in parallel."""
    from transformer_stm_tpu_torch.kernels import _build

    for hdr in src_dir.glob("*.cuh"):
        (tmp / hdr.name).write_bytes(hdr.read_bytes())
    text = (src_dir / SOURCE).read_text()
    procs = {}
    for name, kinds in builds.items():
        src = tmp / f"{name}_{SOURCE}"
        src.write_text(text if kinds is None else patch(text, kinds))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.ARCH, *_build.FLAGS, "-shared",
             "-o", str(tmp / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for build {name}:\n{out}")
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        sym = "launch_fused_mlp_train_bwd"
        getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
        getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transformer_stm_tpu_torch.kernels import fused_mlp

    src_dir = Path(__file__).resolve().parents[1] / "csrc"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(src_dir, Path(tmp), BUILDS)

    def time_ms(fn, reps=10):
        fn(), fn()
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

    def kernel_ms(fn, calls=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / 1e3 / calls
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    gen = torch.Generator(device="cuda").manual_seed(11)
    results = []
    try:
        for n, d in SHAPES:
            hd = 4 * d
            x, dy = (torch.randn(n, d, device="cuda", generator=gen)
                     for _ in range(2))
            w1 = torch.randn(d, hd, device="cuda", generator=gen) / d ** 0.5
            w2 = torch.randn(hd, d, device="cuda", generator=gen) / hd ** 0.5
            b1 = 0.1 * torch.randn(hd, device="cuda", generator=gen)
            b2 = 0.1 * torch.randn(d, device="cuda", generator=gen)
            seed = torch.tensor([5, 7], device="cuda", dtype=torch.int32)
            call_args = (x, w1, b1, w2, b2, seed, RATE, dy)
            want = fused_mlp.fused_mlp_train_bwd_plain(*call_args)
            rows = {name: dict(build=name, shape=[n, d, hd], ms=[],
                               kernels={}) for name in libs}
            names = list(libs)
            for r in range(args.rounds):
                for name in names[r % len(names):] + names[:r % len(names)]:
                    fused_mlp.library = lambda lib=libs[name]: lib

                    def run():
                        return fused_mlp.fused_mlp_train_bwd(*call_args)
                    if r == 0:
                        for what, g, w in zip(("dx", "dW1", "db1", "dW2",
                                               "db2"), run(), want):
                            e = (g - w).abs().max().item()
                            if e > MLP_TOL * w.abs().max().item():
                                raise AssertionError(
                                    f"build {name} N{n} D{d} {what}: max "
                                    f"|err| {e:.3e}")
                    rows[name]["ms"].append(time_ms(run))
                    for k, v in kernel_ms(run).items():
                        rows[name]["kernels"].setdefault(k, []).append(v)
            for row in rows.values():
                print(f"N{n} D{d} {row['build']:>10s}: call "
                      + " / ".join(f"{t:.3f}" for t in row["ms"]) + " ms",
                      flush=True)
                for k, v in sorted(row["kernels"].items()):
                    print(f"    {' / '.join(f'{t:.4f}' for t in v)} ms  "
                          f"{k[:90]}", flush=True)
                results.append(row)
            del x, dy, want
    finally:
        from transformer_stm_tpu_torch.kernels import _build
        fused_mlp.library = _build.library
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, builds=BUILDS,
                                                  results=results), indent=1))


if __name__ == "__main__":
    main()
