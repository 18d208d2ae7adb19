"""Rows 9-12 of PERF.md's kernel table on float32 x, timed on the card, and
the outputs that must not change, so that two trees compare in one call.

    python3 transformer_stm_tpu_torch/tools/f32_layer_times.py \
        --label NAME [--dump FILE]
    python3 transformer_stm_tpu_torch/tools/f32_layer_times.py --compare A B

Run it from the root of the tree to measure: the port's package and
``chip_smoke.py`` are imported from the working directory, so the same
script, given by its path, measures another checkout too (a parent commit
unpacked with ``git archive``).  At ViT-S/16 widths (E 384, H 6, hidden
1536, 197 tokens padded to 200), B 192, weights from chip_smoke's seed, it
times ``attn_layer_infer``, ``ln_mlp_infer``, ``vit_layer_infer`` and
``vit_layer_infer_int8`` on float32 x one call alone (``time_ms``: CUDA
events, median of 10 after 2 warm-ups, host work included) and 10 back to
back (``time_ms_batched``), beside their plain versions and, for the whole
layer, nn.TransformerEncoderLayer in float32 (TF32 off), and checks each
against its plain version.  For ``vit_layer_infer_int8`` it also gives
the device time of one call by kernel and of its int8 products one by one
(``chunk_gemm_s8``, four launches a chunk: q|k|v, the out projection,
fc1, fc2), from one profiled call in a process that has profiled nothing
before (in a long process the profiler was seen to drop launches).  It
prints one JSON line with the card's name and power limit.

``--dump FILE`` saves outputs on fixed inputs that a change of the float32
layer must leave as they are: the int8 layer on float32 x and the four
bf16 kernels at ViT-S B 8, and the training MLP's forward and backward at
D 384 and 768 (N 591, rate 0.1).  ``--compare A B`` says, tensor by
tensor, whether two dumps are bit-equal; it runs on the CPU.  The int8
layer on float32 x shares the float32 layer's chunks and its flash
forward, so a change of the float32 layer may move it: it is held within
``TOLERANCES`` (chip_smoke.py's VIT_INT8_TOL, of max |A|) instead.
"""

import argparse
import json
import os
import sys

# outputs held within tol * max |A| rather than bit for bit
TOLERANCES = {"vit_layer_infer_int8 f32": 1e-2}
PRODUCTS = ("qkv", "out", "fc1", "fc2")  # chunk_gemm_s8's launches a chunk


def _setup():
    sys.path.insert(0, os.getcwd())
    import chip_smoke  # noqa: E402

    card = chip_smoke.phase_env()
    return chip_smoke, card


def split(launches):
    """{kernel: device ms} and {product: device ms} of one call's launches,
    (name, ms) in launch order; the products are chunk_gemm_s8's, four a
    chunk in PRODUCTS' order (None where it ran no whole chunk)."""
    kernels = {}
    for name, ms in launches:
        key = name.replace("(anonymous namespace)::", "").split("(")[0]
        key = key.split("<")[0].split("::")[-1].split()[-1]
        kernels[key] = kernels.get(key, 0.0) + ms
    s8 = [ms for name, ms in launches if "chunk_gemm_s8" in name]
    products = ({k: sum(s8[j::4]) for j, k in enumerate(PRODUCTS)}
                if s8 and len(s8) % 4 == 0 else None)
    return kernels, products


def profile_launches(fn):
    """(kernel name, device ms) of each launch of one call of fn, in order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in events]


def times(cs, card, label):
    import torch

    from transformer_stm_tpu_torch.kernels import fused_layer as fl

    e, h, t, tp, b = 384, 6, 197, 200, 192
    mods = cs.vit_layer(e, h, cs.SEED, torch.float32)
    n1, attn, n2, mlp = mods
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    x = torch.randn(b, tp, e, device="cuda", generator=gen)
    x[:, t:] = 0.0
    x = x.reshape(b * tp, e)
    layer = dict(t_pad=tp, t_real=t)
    lib = cs.library_layer(mods, torch.float32)
    xl = x.reshape(b, tp, e)[:, :t].contiguous()
    rows = (
        ("attn_layer_infer",
         lambda: fl.attn_layer_infer(x, n1, attn, **layer),
         lambda: fl.attn_layer_infer_plain(x, n1, attn, **layer)),
        ("ln_mlp_infer", lambda: fl.ln_mlp_infer(x, n2, mlp),
         lambda: fl.ln_mlp_infer_plain(x, n2, mlp)),
        ("vit_layer_infer", lambda: fl.vit_layer_infer(x, *mods, **layer),
         lambda: fl.vit_layer_infer_plain(x, *mods, **layer)),
        ("vit_layer_infer_int8",
         lambda: fl.vit_layer_infer_int8(x, *mods, **layer),
         lambda: fl.vit_layer_infer_int8_plain(x, *mods, **layer)))
    out = {}
    with torch.inference_mode():
        kernels, products = split(profile_launches(rows[3][1]))
        for name, kernel, plain in rows:
            got, want = kernel(), plain()
            scale = want.abs().max().item()
            out[name] = dict(
                ms=cs.time_ms(kernel), batched_ms=cs.time_ms_batched(kernel),
                plain_ms=cs.time_ms(plain),
                max_rel_err=(got - want).abs().max().item() / scale)
            del got, want
        out["vit_layer_infer"]["library_ms"] = cs.time_ms(lambda: lib(xl))
        out["vit_layer_infer_int8"].update(kernels_ms=kernels,
                                           products_ms=products)
    print(json.dumps({"label": label, "card": card, "batch": b,
                      "rows": out}), flush=True)


def dump(cs, path):
    import torch

    from transformer_stm_tpu_torch.kernels import fused_layer as fl
    from transformer_stm_tpu_torch.kernels.fused_mlp import (
        fused_mlp_train_bwd, fused_mlp_train_fwd)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    e, h, t, tp, b = 384, 6, 197, 200, 8
    x = torch.randn(b, tp, e, device="cuda", generator=gen)
    x[:, t:] = 0.0
    x = x.reshape(b * tp, e)
    layer = dict(t_pad=tp, t_real=t)
    saved = {}
    with torch.inference_mode():
        m32 = cs.vit_layer(e, h, cs.SEED, torch.float32)
        saved["vit_layer_infer_int8 f32"] = fl.vit_layer_infer_int8(
            x, *m32, **layer)
        n1, attn, n2, mlp = cs.vit_layer(e, h, cs.SEED, torch.bfloat16)
        xb = x.to(torch.bfloat16)
        saved["attn_layer_infer bf16"] = fl.attn_layer_infer(xb, n1, attn,
                                                             **layer)
        saved["ln_mlp_infer bf16"] = fl.ln_mlp_infer(xb, n2, mlp)
        saved["vit_layer_infer bf16"] = fl.vit_layer_infer(
            xb, n1, attn, n2, mlp, **layer)
        saved["vit_layer_infer_int8 bf16"] = fl.vit_layer_infer_int8(
            xb, n1, attn, n2, mlp, **layer)
    n = 591
    for d in (384, 768):
        hd = 4 * d
        xs = torch.randn(n, d, device="cuda", generator=gen)
        w1 = torch.randn(d, hd, device="cuda", generator=gen) / d ** 0.5
        b1 = 0.1 * torch.randn(hd, device="cuda", generator=gen)
        w2 = torch.randn(hd, d, device="cuda", generator=gen) / hd ** 0.5
        b2 = 0.1 * torch.randn(d, device="cuda", generator=gen)
        dy = torch.randn(n, d, device="cuda", generator=gen)
        seed = torch.randint(0, 2 ** 31 - 1, (2,), device="cuda",
                             generator=gen, dtype=torch.int32)
        args = (xs, w1, b1, w2, b2, seed, 0.1)
        saved[f"fused_mlp_train fwd D{d}"] = fused_mlp_train_fwd(*args)
        for name, g in zip(("dx", "dW1", "db1", "dW2", "db2"),
                           fused_mlp_train_bwd(*args, dy)):
            saved[f"fused_mlp_train bwd D{d} {name}"] = g
    torch.save({k: v.cpu() for k, v in saved.items()}, path)
    print(f"saved {len(saved)} outputs to {path}", flush=True)


def compare(a, b):
    import torch

    da, db = torch.load(a), torch.load(b)
    same = sorted(k for k in da if k in db and torch.equal(da[k], db[k]))
    close = {}
    for k in sorted(set(da) & set(db) & set(TOLERANCES) - set(same)):
        scale = da[k].float().abs().max().item()
        err = (da[k].float() - db[k].float()).abs().max().item()
        if err <= TOLERANCES[k] * scale:
            close[k] = err / scale
    differ = sorted((set(da) | set(db)) - set(same) - set(close))
    for k in same:
        print(f"bit-equal  {k}")
    for k, rel in close.items():
        print(f"within     {k}: max |B - A| {rel:.3e} of max |A| (limit "
              f"{TOLERANCES[k]})")
    for k in differ:
        print(f"DIFFERENT  {k}")
    return not differ


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    cs, card = _setup()
    if args.dump:
        dump(cs, args.dump)
    times(cs, card, args.label)


if __name__ == "__main__":
    main()
