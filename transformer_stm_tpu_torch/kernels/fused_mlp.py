"""The fused MLPs: GELU(x W1 + b1) W2 + b2 with the hidden activation on
chip, for evaluation and, with dropout, for training.

``fused_mlp`` ports the Pallas TPU kernel ``fused_mlp``
(transformer_stm_tpu/kernels/fused_mlp.py:62; body ``_mlp_kernel`` :52),
the inference MLP of every CvT block; its CUDA kernel is
``csrc/fused_mlp.cu``, f32 products in 3xTF32 on the tensor cores (each
operand split into two TF32 halves, ``tf32_split``; csrc/tf32x3.cuh).  The
kernel reads W1^T and W2^T as big/small pairs, K-major, which
``packed_mlp_weights`` makes once per pair of weights and keeps while they live
unchanged.  It has no backward: it raises while autograd records (grad
enabled and an input requires grad) rather than return a result cut off
from the graph.

``fused_mlp_train`` ports ``make_fused_mlp_train`` (:291), the training
MLP y = Drop2(Drop1(GELU(x W1 + b1)) W2 + b2) with both masks drawn inside
the kernels: the forward ``_mlp_train_fwd_kernel`` (:170) and the backward
``_mlp_train_bwd_kernel`` (:189), both on the tensor cores in 3xTF32, at
the CvT widths (``WIDTHS``) and the ViT widths (``VIT_WIDTHS``).  At the
CvT widths and D 192 the forward is ``csrc/fused_mlp.cu``'s body with its
dropout flag, on weights it splits at every call (training changes them
every step), and the backward ``csrc/fused_mlp_train.cu``'s fused kernels,
which write one weight and bias partial per row slot (``train_bwd_slots``),
summed over the slots in a fixed order by their last launch.  At
``CHUNKED_WIDTHS`` (D 384 and 768) both run as products over row chunks,
each done once, with the chunk's hidden in scratch (``csrc/fused_mlp_train.cu``,
namespace chunk; ``train_chunk_rows``, ``train_fwd_chunk_rows``).  It takes
float32 or bfloat16 x: the kernels compute in float32, y and dx come back
in x's type and the weight and bias gradients in the weights' float32, as
the JAX ``custom_vjp`` returns them (:354, :437-441).  It is the autograd
Function ``FusedMLPTrain``, which saves x, the weights and the seed, never
the hidden activation; the backward recomputes it.  A mask element is a
pure function of the (2,) int32 seed and the element's global index
(``dropout_mask``), so the masks do not depend on the block size and
forward and backward agree; parity
with JAX holds in distribution only, as for the TPU kernel, whose bits came
from the TPU's own generator.

Every wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, or raises.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..ops.common import compute_type, dense, gelu
from ..debug import check_kernel
from ._build import aligned16, library

WIDTHS = (64, 128, 256)  # the CvT stage widths the kernels are built for
VIT_WIDTHS = (192, 384, 768)  # and the ViT widths (ViT-Ti, -S, -B)
HIDDEN_CHUNK = 64
# Widths at which the inference kernel splits fc2's hidden units between its
# two warpgroups (csrc/fused_mlp.cu, SPLIT_K_MAX_D)
SPLIT_K_WIDTHS = (64, 128)
# Row tiles and hidden tiles of the training backward (csrc/fused_mlp_train.cu)
TRAIN_BWD_TILE = 64
# Widths at which the training MLP runs as products over row chunks, each
# done once (csrc/fused_mlp_train.cu, namespace chunk), in tiles of 128 x 192
CHUNKED_WIDTHS = (384, 768)
CHUNK_TILE_M, CHUNK_TILE_N = 128, 192
# The backward's chunk rows by width: of the sizes whose scratch (two sets
# of the arrays the products read) stays within 64 MiB at D 384 and 96 MiB
# at D 768, the fastest on the H100 at ViT-S and ViT-B B 64
BWD_CHUNK_ROWS = {384: 768, 768: 384}


def fused_mlp_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in PyTorch, exact erf GELU.
    x: (..., D); w1: (D, Hd); w2: (Hd, D) -> (..., D)."""
    return dense(gelu(dense(x, w1, b1)), w2, b2)


def tf32_round(x):
    """x (float32) rounded to TF32, 10 explicit mantissa bits, to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: half of the low 13
    bits' range added to the magnitude's bits, then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(big, small), both TF32, with big + small = x to within 2^-22 |x|:
    the operand split of the 3xTF32 products."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def kpos_order(w_t):
    """w_t (rows, K) with each group of 8 columns in the order in which an
    accumulator feeds a product as its register A operand (``kpos`` of
    csrc/tf32x3.cuh): column 8 j + 2 a + b moves to 8 j + 4 b + a."""
    rows, k = w_t.shape
    return w_t.reshape(rows, k // 8, 4, 2).transpose(-1, -2).reshape(rows, k)


def pack_mlp_weights(w1, w2):
    """(W1^T, W2^T) as the kernel reads them: (2, Hd, D) and (2, D, Hd),
    each the TF32 big half then the small half, contiguous float32, from
    weights of any float type.  At the split-K widths W2^T's columns (the
    hidden units) are in ``kpos_order``: there fc2 takes the hidden
    activation from registers (csrc/fused_mlp.cu)."""
    w2_t = w2.t()
    if w2.shape[1] in SPLIT_K_WIDTHS:
        w2_t = kpos_order(w2_t)
    return tuple(torch.stack(tf32_split(w.float().contiguous()))
                 for w in (w1.t(), w2_t))


# (id(w1), id(w2)) -> (weakrefs of both, their state, the packed pair)
_PACKS = {}


def _weight_state(w1, w2):
    """The version counter, storage, dtype and device of both weights, as
    ``fused_layer._state`` keys a layer's parameters; None if either is an
    inference tensor, whose in-place updates leave no version behind."""
    if w1.is_inference() or w2.is_inference():
        return None
    return tuple((w._version, w.data_ptr(), w.dtype, w.device)
                 for w in (w1, w2))


def packed_mlp_weights(w1, w2):
    """``pack_mlp_weights(w1, w2)``, kept while w1 and w2 live and keep
    their version counters, storage, dtype and device: an in-place update
    through autograd's view of them, or a rebinding of ``.data`` (as
    ``torch.nn.utils.vector_to_parameters`` does), repacks at the next call.
    An in-place write through ``.data`` (``w.data.copy_(...)``) changes
    neither the version nor the storage, so nothing here can see it: after
    one, call ``kernels.clear_weight_packs()``.  Inference tensors keep no
    version counter and are packed at every call."""
    key = (id(w1), id(w2))
    state = _weight_state(w1, w2)
    hit = _PACKS.get(key)
    if hit is not None and hit[0]() is w1 and hit[1]() is w2 and \
            state is not None and hit[2] == state:
        return hit[3]
    packed = pack_mlp_weights(w1, w2)
    packed_mlp_weights.packings += 1
    if state is not None:
        def drop(_, key=key):
            _PACKS.pop(key, None)
        _PACKS[key] = (weakref.ref(w1, drop), weakref.ref(w2, drop),
                       state, packed)
    return packed


# Weight packings so far (misses of the cache).
packed_mlp_weights.packings = 0


def _check(x, w1, b1, w2, b2, what="fused_mlp", widths=WIDTHS,
           packed=False, **more):
    """Devices, types and shapes; with ``packed`` the weights only reach the
    kernel through their pack, so they may be of any float type and
    layout."""
    tensors = (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
               *more.items())
    for name, t in tensors:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must lie on the CUDA device "
                             f"of x, got {t.device} and {x.device}")
        if packed and name in ("w1", "w2") and t.is_floating_point():
            continue
        want = torch.int32 if name == "seed" else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {want}, "
                             f"got {t.dtype}")
    d = x.shape[-1]
    hd = w1.shape[-1] if w1.dim() == 2 else -1
    if d not in widths:
        raise ValueError(f"{what}: width {d} not in {widths}")
    if w1.shape != (d, hd) or hd % HIDDEN_CHUNK or b1.shape != (hd,) or \
            w2.shape != (hd, d) or b2.shape != (d,):
        raise ValueError(f"{what}: weight shapes do not match: x "
                         f"{tuple(x.shape)} w1 {tuple(w1.shape)} b1 "
                         f"{tuple(b1.shape)} w2 {tuple(w2.shape)} b2 "
                         f"{tuple(b2.shape)}; the hidden width must be a "
                         f"multiple of {HIDDEN_CHUNK}")


def fused_mlp(x, w1, b1, w2, b2):
    """x: (..., D), D in WIDTHS or VIT_WIDTHS; w1 (D, Hd); w2 (Hd, D).

    The kernel computes in float32.  A bfloat16 x or biases are converted
    to float32 here, bfloat16 weights inside their pack (which stays keyed
    on the caller's own weights), and the result is returned in x's type,
    as the TPU kernel casts x and the weights to float32 and writes in x's
    type (kernels/fused_mlp.py:52-59)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(
            "fused_mlp is an inference kernel with no backward; run it under "
            "torch.no_grad() or torch.inference_mode(), or train through "
            "mlp(..., train=True), which takes the plain MLP")
    dtype = x.dtype
    if all(t.device.type == "cpu" for t in (x, w1, b1, w2, b2)):
        return fused_mlp_plain(*(t.float() for t in (x, w1, b1, w2,
                                                     b2))).to(dtype)
    x, b1, b2 = (t.float().contiguous() for t in (x, b1, b2))
    _check(x, w1, b1, w2, b2, widths=WIDTHS + VIT_WIDTHS, packed=True)
    d, hd = w1.shape
    n = x.numel() // d
    x = aligned16(x)
    p1, p2 = packed_mlp_weights(w1, w2)
    y = torch.empty_like(x)
    rc = library().launch_fused_mlp(
        x.data_ptr(), p1.data_ptr(), b1.data_ptr(), p2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, d, hd, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_fused_mlp failed: CUDA error {rc}")
    fused_mlp.launches += 1
    check_kernel("fused_mlp", y)
    return y.to(dtype)


# Kernel launches so far; a caller resets it to 0 to count a run.
fused_mlp.launches = 0


# ---------------------------------------------------------------------------
# Training MLP with in-kernel dropout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
STREAM_HIDDEN, STREAM_OUT = 1, 2  # counter word 1 of m1 and of m2


def keep_threshold(rate: float) -> int:
    """A unit is kept iff its uint32 word is >= this, compared unsigned
    (the formula of ``_keep_mask``, fused_mlp.py:155)."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) in float32, the multiplier of a kept unit."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a in [0, 2^32) and a
    32-bit constant m, without leaving int64: m is split into 16-bit
    halves so that no partial product passes 2^49."""
    p1, p2 = a * (m & 0xFFFF), a * (m >> 16)
    mid = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words: the counter (c0, c1, c2, c3) under the key (k0, k1) ->
    four words, as ``philox4x32_10`` of csrc/fused_mlp_train.cu."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_mask(seed, rows: int, width: int, stream: int, rate: float):
    """The (rows, width) float32 multipliers, 0 or ``keep_scale(rate)``, of
    one dropout mask, on the seed's device.  Element e = row * width + col
    takes word e & 3 of Philox-4x32-10 keyed on the seed's two words at the
    counter (lo32(e >> 2), stream, hi32(e >> 2), 0), and is kept iff that
    word >= ``keep_threshold(rate)``.  width must be a multiple of 4."""
    if rate == 0.0:
        return torch.ones(rows, width, device=seed.device)
    g = torch.arange(rows * width // 4, device=seed.device, dtype=torch.int64)
    k = seed.to(torch.int64) & _M32
    words = torch.stack(philox4x32_10(g & _M32, stream, g >> 32, 0,
                                      k[0], k[1]), dim=-1)
    keep = words.reshape(rows, width) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


def _gelu_grad(a):
    """d/da [a Phi(a)] = Phi(a) + a phi(a), exact erf form."""
    return (0.5 * (1.0 + torch.special.erf(a * 0.7071067811865476))
            + a * torch.exp(-0.5 * a * a) * 0.3989422804014327)


def fused_mlp_train_plain(x, w1, b1, w2, b2, seed, rate: float):
    """The forward kernel's arithmetic in PyTorch, with the same masks:
    (GELU(x W1 + b1) m1) W2 + b2, times m2, in float32 (float64 for float64
    x) and returned in x's type.  x: (..., D); seed: (2,) int32."""
    d, hd = w1.shape
    n = x.numel() // d
    ct = compute_type(x)
    w1, b1, w2, b2 = (t.to(ct) for t in (w1, b1, w2, b2))
    m1 = dropout_mask(seed, n, hd, STREAM_HIDDEN, rate).to(ct)
    m2 = dropout_mask(seed, n, w2.shape[1], STREAM_OUT, rate).to(ct)
    h = gelu(dense(x.reshape(n, d).to(ct), w1, b1)) * m1
    y = dense(h, w2, b2) * m2
    return y.reshape(*x.shape[:-1], w2.shape[1]).to(x.dtype)


def fused_mlp_train_bwd_plain(x, w1, b1, w2, b2, seed, rate: float, dy):
    """The backward kernel's arithmetic in PyTorch, in the forward's type: a,
    h and both masks recomputed; g = dy m2, dh = (g W2^T) m1, da = dh
    GELU'(a); -> (dx = da W1^T in x's type, dW1 = x^T da, db1 = sum da,
    dW2 = h^T g, db2 = sum g in the weights' type)."""
    d, hd = w1.shape
    n = x.numel() // d
    ct = compute_type(x)
    wt = w1.dtype
    w1, b1, w2 = (t.to(ct) for t in (w1, b1, w2))
    xf = x.reshape(n, d).to(ct)
    m1 = dropout_mask(seed, n, hd, STREAM_HIDDEN, rate).to(ct)
    m2 = dropout_mask(seed, n, w2.shape[1], STREAM_OUT, rate).to(ct)
    a = dense(xf, w1, b1)
    h = gelu(a) * m1
    g = dy.reshape(n, -1).to(ct) * m2
    da = (g @ w2.T) * m1 * _gelu_grad(a)
    wgrads = (xf.T @ da, da.sum(0), h.T @ g, g.sum(0))
    return ((da @ w1.T).reshape(x.shape).to(x.dtype),
            *(t if ct == torch.float64 else t.to(wt) for t in wgrads))


def _train_check(x, w1, b1, w2, b2, seed, **more):
    _check(x, w1, b1, w2, b2, "fused_mlp_train", widths=WIDTHS + VIT_WIDTHS,
           seed=seed, **more)
    if seed.shape != (2,):
        raise ValueError(f"fused_mlp_train: seed must have shape (2,), got "
                         f"{tuple(seed.shape)}")


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def train_chunk_rows(n: int, d: int) -> int:
    """Rows of a chunk of the training backward at the chunked widths
    (``BWD_CHUNK_ROWS``), fewer for a smaller n: whole tiles of 192 rows."""
    return min(BWD_CHUNK_ROWS[d], _round_up(n, CHUNK_TILE_N))


def train_fwd_chunk_rows(n: int, d: int) -> int:
    """Rows of a chunk of the chunked training forward: 132 x 128 x 192 / D
    (4,224 at D 768, 8,448 at D 384), so that fc2 fills 132 SMs with whole
    tiles and fc1 four times that; fewer for a smaller n (whole tiles of
    128 rows)."""
    return min(132 * CHUNK_TILE_M * CHUNK_TILE_N // d,
               _round_up(n, CHUNK_TILE_M))


def _chunk_check(hd):
    if hd % (3 * CHUNK_TILE_M):
        raise ValueError(f"fused_mlp_train: at the chunked widths "
                         f"{CHUNKED_WIDTHS} the hidden width must be a "
                         f"multiple of {3 * CHUNK_TILE_M}, got {hd}")


def _train_fwd_fused(x, w1, b1, w2, b2, seed, rate, y):
    """csrc/fused_mlp.cu's body with its dropout flag, after a launch that
    splits the weights as ``pack_mlp_weights`` does into scratch of 4 D Hd
    floats (kept for no later call: the weights change every step)."""
    d, hd = w1.shape
    pack = x.new_empty(4 * d * hd)
    return library().launch_fused_mlp_train_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), seed.data_ptr(), y.data_ptr(), pack.data_ptr(),
        x.numel() // d, d, hd, d, keep_threshold(rate), keep_scale(rate),
        torch.cuda.current_stream(x.device).cuda_stream)


def _train_fwd_chunked(x, w1, b1, w2, b2, seed, rate, y):
    """The chunked forward of csrc/fused_mlp_train.cu: W1^T and W2^T split
    into scratch, then per chunk of ``train_fwd_chunk_rows`` rows both
    masks as bits, h = Drop1(GELU(x W1 + b1)) into the scratch's (rows, Hd)
    hidden and y = Drop2(h W2 + b2); 4 D Hd + rows Hd + rows (Hd + D) / 32
    floats of scratch."""
    d, hd = w1.shape
    _chunk_check(hd)
    n = x.numel() // d
    r = train_fwd_chunk_rows(n, d)
    scratch = x.new_empty(4 * d * hd + r * hd + r * (hd + d) // 32)
    return library().launch_fused_mlp_train_fwd_chunked(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), seed.data_ptr(), y.data_ptr(), scratch.data_ptr(), n,
        d, hd, r, keep_threshold(rate), keep_scale(rate),
        torch.cuda.current_stream(x.device).cuda_stream)


def fused_mlp_train_fwd(x, w1, b1, w2, b2, seed, rate: float):
    """y (..., D) in x's type outside autograd: the plain version on the
    CPU, else on x in float32 the chunked forward at ``CHUNKED_WIDTHS`` and
    csrc/fused_mlp.cu's body at the other widths."""
    if _on_cpu(x, w1, b1, w2, b2, seed):
        return fused_mlp_train_plain(x, w1, b1, w2, b2, seed, rate)
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x = x.float().contiguous()
    _train_check(x, w1, b1, w2, b2, seed)
    x = aligned16(x)
    y = torch.empty_like(x)
    launch = (_train_fwd_chunked if w1.shape[0] in CHUNKED_WIDTHS
              else _train_fwd_fused)
    rc = launch(x, w1, b1, w2, b2, seed, rate, y)
    if rc != 0:
        raise RuntimeError(f"the training MLP's forward launch failed: CUDA "
                           f"error {rc}")
    fused_mlp_train.launches += 1
    check_kernel("fused_mlp_train", y)
    return y.to(dtype)


def train_bwd_slots(n: int, hd: int, sms: int = 132) -> int:
    """Row slots of the training backward's weight kernel: its blocks take
    (hidden tile, slot) pairs, about one block an SM, and slot s walks row
    tiles s, s + slots, ...; there are no more slots than row tiles."""
    tiles = -(-n // TRAIN_BWD_TILE)
    return max(1, min(sms // (hd // TRAIN_BWD_TILE), tiles))


def train_bwd_scratch(n: int, d: int, hd: int, sms: int = 132):
    """The float32 sizes of the training backward's scratch.  At the CvT
    widths and D 192: the packed weights (W1^T, W2 and W1 in kpos order,
    each split) and the row slots' partials, slot by slot dW1 (D, Hd), dW2
    (Hd, D), db1 (Hd), db2 (D); it does not grow with n once n passes slots
    row tiles.  At ``CHUNKED_WIDTHS``, for chunks of r =
    ``train_chunk_rows`` rows: W1^T (Hd, D); x and g split, the sums of da
    (r / 32, Hd) and of g (r / 32, D) over 32 rows, dx's four partial sums over
    quarters of Hd (4, r, D), m1's bits (r Hd / 32 words); and for each of
    two chunks (one's products run beside the next one's scores) x^T and
    g^T split, h^T and da^T as stored, and da split.  It does not grow with
    n once n passes one chunk."""
    if d in CHUNKED_WIDTHS:
        r = train_chunk_rows(n, d)
        return [d * hd, 8 * r * d + r // 32 * (hd + d) + r * hd // 32,
                2 * (4 * r * d + 4 * r * hd)]
    return [6 * d * hd, train_bwd_slots(n, hd, sms) * (2 * d * hd + hd + d)]


def fused_mlp_train_bwd(x, w1, b1, w2, b2, seed, rate: float, dy):
    """(dx, dW1, db1, dW2, db2) for the output gradient dy (contiguous):
    the plain version on the CPU, else the backward kernels on x and dy in
    float32, whose per-slot partials their last launch sums in slot order
    (the JAX package sums its partials outside the kernel, :437-441).  dx
    comes back in x's type."""
    if _on_cpu(x, w1, b1, w2, b2, seed, dy):
        return fused_mlp_train_bwd_plain(x, w1, b1, w2, b2, seed, rate, dy)
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, dy = x.float().contiguous(), dy.float().contiguous()
    _train_check(x, w1, b1, w2, b2, seed, dy=dy)
    if dy.shape != x.shape:
        raise ValueError(f"fused_mlp_train_bwd: dy {tuple(dy.shape)} does "
                         f"not match x {tuple(x.shape)}")
    d, hd = w1.shape
    n = x.numel() // d
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    x, dy = aligned16(x), aligned16(dy)
    dx = torch.empty_like(x)
    sizes = train_bwd_scratch(n, d, hd, sms)
    grads = x.new_empty(2 * d * hd + hd + d)  # dW1, dW2, db1, db2
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if d in CHUNKED_WIDTHS:
        _chunk_check(hd)
        scratch = x.new_empty(sum(sizes))
        rc = library().launch_fused_mlp_train_bwd_chunked(
            x.data_ptr(), dy.data_ptr(), aligned16(w1).data_ptr(),
            b1.data_ptr(), aligned16(w2).data_ptr(), seed.data_ptr(),
            dx.data_ptr(), grads.data_ptr(), scratch.data_ptr(), n, d, hd,
            train_chunk_rows(n, d), keep_threshold(rate), keep_scale(rate),
            stream)
    else:
        pack, part = x.new_empty(sum(sizes)).split(sizes)
        rc = library().launch_fused_mlp_train_bwd(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), seed.data_ptr(), dx.data_ptr(), grads.data_ptr(),
            pack.data_ptr(), part.data_ptr(), n, d, hd, d,
            train_bwd_slots(n, hd, sms), keep_threshold(rate),
            keep_scale(rate), stream)
    if rc != 0:
        raise RuntimeError(f"launch_fused_mlp_train_bwd failed: CUDA error "
                           f"{rc}")
    fused_mlp_train_bwd.launches += 1
    check_kernel("fused_mlp_train_bwd", dx, grads)
    dw1, dw2, db1, db2 = grads.split([d * hd, hd * d, hd, d])
    return dx.to(dtype), dw1.view(d, hd), db1, dw2.view(hd, d), db2


class FusedMLPTrain(torch.autograd.Function):
    """The training MLP: the forward kernel, and the backward kernel from
    the saved x, weights and seed (the hidden activation is recomputed)."""

    @staticmethod
    def forward(x, w1, b1, w2, b2, seed, rate):
        return fused_mlp_train_fwd(x, w1, b1, w2, b2, seed, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, rate = inputs
        ctx.save_for_backward(*tensors)
        ctx.rate = rate

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, seed = ctx.saved_tensors
        grads = fused_mlp_train_bwd(x, w1, b1, w2, b2, seed, ctx.rate,
                                    dy.contiguous())
        return (*grads, None, None)


def fused_mlp_train(x, w1, b1, w2, b2, seed, rate: float):
    """x: (..., D) float32 or bfloat16, D in WIDTHS or VIT_WIDTHS; w1 (D,
    Hd), b1, w2 (Hd, D), b2 float32; seed (2,) int32 on x's device (0 <=
    rate < 1) -> (..., D) in x's type, differentiable in x and the
    weights."""
    return FusedMLPTrain.apply(x, w1, b1, w2, b2, seed, rate)


# Kernel launches so far; a caller resets them to 0 to count a run.  Each
# call counts once, whatever its launches: the forward's packing and fused
# kernel, or its chunks' launches at CHUNKED_WIDTHS; the backward's four
# kernels (packing, dx, the weight partials, their sum), or its chunks'.
fused_mlp_train.launches = 0
fused_mlp_train_bwd.launches = 0
