"""Fused ViT-layer inference kernels, each beside its plain PyTorch version.

Ports of the Pallas TPU kernels of transformer_stm_tpu/kernels/fused_layer.py
(``csrc/vit_layer_sm90.cu`` holds all four in bfloat16, on wgmma and TMA;
``csrc/fused_layer.cu`` holds them in float32 x, as products over chunks
of whole images with the 3xTF32 flash forward of ``csrc/flash_attention.cu``
between them: the first three on ``chunk_gemm`` of ``csrc/chunk_gemm.cuh``
(3xTF32 ``wgmma``), the int8 layer on its sibling ``chunk_gemm_s8`` (s8
``wgmma``)):

- ``attn_layer_infer`` (:200, ``_attn_layer_kernel`` :62):
  y = x + OutProj(MHA(LN1 x));
- ``ln_mlp_infer`` (:602, ``_ln_mlp_kernel`` :590): y = x + MLP(LN2 x);
- ``vit_layer_infer`` (:335, ``_layer_kernel`` :279): the whole layer,
  z = x + MHA(LN1 x), y = z + MLP(LN2 z), with z kept in float32;
- ``vit_layer_infer_int8`` (:509, ``_layer_kernel_int8`` :440): that layer
  with all six projections int8 x int8 -> int32, weights quantised per
  column here (``quant_cols``), rows per row inside the kernel (on
  ``wgmma`` with s8 operands, in bfloat16 and on float32 x).

Tokens are folded: x is (B * t_pad, E), t_pad a multiple of 8, keys at or
past t_real are masked and padded query rows carry junk.  x is float32 or
bfloat16; the weights are taken from the port's modules (``LayerNorm``,
``MHA``, ``MLP``) and cast to x's type (int8 for the int8 kernel), q's
pre-scaled by 1/sqrt(Dh), as the JAX wrappers pack them.  They are packed
once per model (``packed_weights``): the packed tensors, and for bfloat16
their TMA descriptors, are cached per layer until a parameter changes;
``pack_weights.packings`` counts the packings.

Tensors on the CPU take the plain versions; tensors on a CUDA device launch
the kernel, or raise: for shapes outside the CUDA design, for a token count
whose attention phase overflows a block's shared memory
(``FusedLayerSharedMemoryError``, which ``fused_layer_fits`` predicts: past
t_pad 576 in bfloat16; on float32 x every layer, the int8 one included,
runs its attention on the flash forward, which takes any count), and while
autograd records (the kernels have no backward).
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch

from ..ops.common import erf_rational
from ..debug import check_kernel
from ._build import aligned16, library
from .fused_mlp import CHUNK_TILE_M, CHUNK_TILE_N, tf32_split

HEAD_DIM = 64        # the attention phase's head dim
TILE = 64            # E, H * Dh and the hidden width are multiples of this
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
# csrc/flash_attention.cu, the float32 layer's attention: 1 KB of alignment,
# 1 KB of barriers, q, K and V^T big and small (8 tiles of 16 KB) and two
# raw K/V stages of 32 KB, whatever t_pad
FLASH_FWD_SMEM = 2 * 1024 + 8 * 16_384 + 2 * 32_768
SMS = 132            # SMs of the H100, for layer_chunk_rows off the card
# csrc/vit_layer_sm90.cu: a ring of 3 stages of 56 KB and a 16 KB hidden
# chunk, or Q, K and V of one head in 64-row tiles of 8 KB, beside 2 KB of
# barriers and alignment
SM90_GEMM_BYTES = 3 * 57_344 + 16_384
SM90_TILE_BYTES = 8_192
SM90_EXTRA_BYTES = 2_048
SM90_ROWS = 64       # rows of a tile of the bf16 layer
TMA_MAP_BYTES = 128  # one CUtensorMap
NEG_INF = -1e30
MODE_ATTN, MODE_MLP, MODE_Q8 = 1, 2, 4


class FusedLayerSharedMemoryError(ValueError):
    """Raised when a fused layer kernel's attention phase needs more shared
    memory than one block may use on the card (``SMEM_LIMIT``, 227 KB on
    Hopper), ``attention_smem_bytes``: past t_pad 576 in bfloat16, the int8
    layer included.  On float32 x every layer, the int8 one included, fits
    at any t_pad.  ``fused_layer_fits`` predicts it; callers route to the
    composable impl='small' path instead."""


def attention_smem_bytes(t_pad: int, itemsize: int = 2) -> int:
    """Shared memory a block of the kernel that runs the attention at t_pad
    needs.  float32 x, the int8 layer included: the flash forward
    (``FLASH_FWD_SMEM``), whatever t_pad.  bfloat16, the int8 layer too
    (``smem_bytes`` of csrc/vit_layer_sm90.cu): the larger of the product
    ring with its hidden chunk and Q, K and V of one head in 64-row tiles,
    beside the barriers."""
    if itemsize == 4:
        return FLASH_FWD_SMEM
    tiles = -(-t_pad // SM90_ROWS)
    return SM90_EXTRA_BYTES + max(SM90_GEMM_BYTES,
                                  3 * tiles * SM90_TILE_BYTES)


def fused_layer_fits(t_pad: int, e: int, heads: int, dh: int, hidden: int,
                     itemsize: int = 2, int8: bool = False) -> bool:
    """True iff the CUDA fused-layer kernels take these model dims in x's
    type (``itemsize`` 4 for float32, 2 for bfloat16; ``int8`` for the int8
    layer, whose limits are the float layer's in x's type): Dh 64; E, H * Dh
    and the hidden width multiples of 64; t_pad a multiple of 8 whose
    attention fits a block's shared memory (any t_pad in float32, t_pad <=
    576 in bfloat16).  Unlike JAX's, the answer is the same for the merged
    layer and the pair."""
    return (dh == HEAD_DIM and e % TILE == 0 and (heads * dh) % TILE == 0
            and hidden % TILE == 0 and t_pad % 8 == 0
            and attention_smem_bytes(t_pad, itemsize) <= SMEM_LIMIT)


# ---------------------------------------------------------------------------
# Weights, packed as the JAX wrappers pack them
# ---------------------------------------------------------------------------

def _attn_weights(attn, dtype):
    """(wqkv (E, 3 HD) in ``dtype`` = [Wq / sqrt(Dh) | Wk | Wv], bqkv (3 HD)
    f32, wo (HD, E) in ``dtype``, bo (E) f32); q's kernel is scaled in its
    own type and then cast, as ``packed`` (:238-241) scales it."""
    e, h, dh = attn.query.kernel.shape
    hd = h * dh
    scale = 1.0 / math.sqrt(dh)
    wqkv = torch.cat([(attn.query.kernel.reshape(e, hd) * scale).to(dtype),
                      attn.key.kernel.reshape(e, hd).to(dtype),
                      attn.value.kernel.reshape(e, hd).to(dtype)], dim=1)
    bqkv = torch.cat([attn.query.bias.float().reshape(hd) * scale,
                      attn.key.bias.float().reshape(hd),
                      attn.value.bias.float().reshape(hd)])
    return (wqkv, bqkv, attn.out.kernel.reshape(hd, e).to(dtype),
            attn.out.bias.float())


def _norm(ln):
    return ln.gamma.float(), ln.beta.float()


def _mlp_weights(mlp, dtype):
    return (mlp.fc1.kernel.to(dtype), mlp.fc1.bias.float(),
            mlp.fc2.kernel.to(dtype), mlp.fc2.bias.float())


def quant_cols(w):
    """``_quant_cols`` (:421): per-column symmetric int8 of an (in, out)
    matrix -> (int8 weights, f32 (out,) dequantisation scales)."""
    w = w.float()
    amax = w.abs().amax(dim=0).clamp_min(1e-6)
    q = torch.clamp(torch.round(w * (127.0 / amax)), -127.0, 127.0)
    return q.to(torch.int8), amax * (1.0 / 127.0)


def quant_rows(x):
    """``_quant_rows`` (:410): per-row symmetric int8 of an f32 block ->
    (int8 values, f32 (R, 1) scales); all-zero rows quantise to zeros."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    q = torch.clamp(torch.round(x * (127.0 / amax)), -127.0, 127.0)
    return q.to(torch.int8), amax * (1.0 / 127.0)


def _int8_weights(attn, mlp):
    """The six projections quantised per column (``vit_layer_infer_int8``
    :543-553): ((wqkv, sqkv), bqkv, (wo, so), bo, (w1, s1), b1, (w2, s2),
    b2); q's kernel is scaled in its own type before it is quantised."""
    wqkv, bqkv, wo, bo = _attn_weights(attn, attn.query.kernel.dtype)
    w1, b1, w2, b2 = _mlp_weights(mlp, mlp.fc1.kernel.dtype)
    return (quant_cols(wqkv), bqkv, quant_cols(wo), bo, quant_cols(w1), b1,
            quant_cols(w2), b2)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic and rounding points in PyTorch
# ---------------------------------------------------------------------------

def _ln_rows(x, gamma, beta, eps):
    """``_layer_norm_rows`` (:54) on f32 rows."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma + beta


def _mm(a, w):
    """a @ w with a's and w's values, summed in float32."""
    return torch.matmul(a.float(), w.float())


def gelu_exact(x):
    """``_gelu_exact`` (kernels/fused_mlp.py:46): GELU with the
    Abramowitz-Stegun erf, in float32."""
    return x * 0.5 * (1.0 + erf_rational(x * 0.7071067811865476))


def _attention_rows(qkv, t_pad, t_real, heads, dtype):
    """Per image and head: f32 scores of the rounded q and k (q pre-scaled),
    keys >= t_real masked to -1e30, p = exp(s - m), l = sum p, o = (p rounded
    to ``dtype``) v / l, rounded to ``dtype``.  qkv: (B t_pad, 3 HD)."""
    n = qkv.shape[0]
    b = n // t_pad
    q, k, v = qkv.float().reshape(b, t_pad, 3, heads, HEAD_DIM).unbind(2)
    s = torch.einsum("bthd,bshd->bhts", q, k)
    s = s.masked_fill(torch.arange(t_pad, device=s.device) >= t_real,
                      NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p.to(dtype).float(), v)
    o = o / l.permute(0, 2, 1, 3)
    return o.reshape(n, heads * HEAD_DIM).to(dtype)


def _qdot(xq, sx, wq, sw, b):
    """``_qdot`` (:430): the int8 product summed exactly (in float64 here,
    exact for these depths, where the kernel sums int32), converted to f32,
    then ((acc * sx) * sw) + b."""
    acc = torch.matmul(xq.double(), wq.double()).float()
    return acc * sx * sw + b


def attn_layer_infer_plain(x, norm1, attn, *, t_pad: int, t_real: int,
                           eps: float = 1e-6):
    """``_attn_layer_kernel`` in PyTorch: y = x + bo + OutProj(MHA(LN1 x)),
    in x's type."""
    dt = x.dtype
    wqkv, bqkv, wo, bo = _attn_weights(attn, dt)
    xf = x.float()
    xn = _ln_rows(xf, *_norm(norm1), eps).to(dt)
    qkv = (_mm(xn, wqkv) + bqkv).to(dt)
    o = _attention_rows(qkv, t_pad, t_real, attn.query.bias.shape[0], dt)
    return (xf + bo + _mm(o, wo)).to(dt)


def ln_mlp_infer_plain(x, norm2, mlp, *, eps: float = 1e-6):
    """``_ln_mlp_kernel`` in PyTorch: y = x + MLP(LN2 x), the hidden rounded
    to x's type before the second product."""
    dt = x.dtype
    w1, b1, w2, b2 = _mlp_weights(mlp, dt)
    xf = x.float()
    xn = _ln_rows(xf, *_norm(norm2), eps).to(dt)
    hid = gelu_exact(_mm(xn, w1) + b1).to(dt)
    return (xf + (_mm(hid, w2) + b2)).to(dt)


def vit_layer_infer_plain(x, norm1, attn, norm2, mlp, *, t_pad: int,
                          t_real: int, eps: float = 1e-6):
    """``_layer_kernel`` in PyTorch: z = x + bo + OutProj(MHA(LN1 x)) kept
    in f32, y = z + MLP(LN2 z), in x's type."""
    dt = x.dtype
    wqkv, bqkv, wo, bo = _attn_weights(attn, dt)
    w1, b1, w2, b2 = _mlp_weights(mlp, dt)
    xf = x.float()
    xn = _ln_rows(xf, *_norm(norm1), eps).to(dt)
    qkv = (_mm(xn, wqkv) + bqkv).to(dt)
    o = _attention_rows(qkv, t_pad, t_real, attn.query.bias.shape[0], dt)
    z = xf + bo + _mm(o, wo)
    zn = _ln_rows(z, *_norm(norm2), eps).to(dt)
    hid = gelu_exact(_mm(zn, w1) + b1).to(dt)
    return (z + (_mm(hid, w2) + b2)).to(dt)


def vit_layer_infer_int8_plain(x, norm1, attn, norm2, mlp, *, t_pad: int,
                               t_real: int, eps: float = 1e-6):
    """``_layer_kernel_int8`` in PyTorch: LN outputs and the MLP hidden
    quantised per row from f32, the attention output rounded to x's type
    before it is quantised; q/k/v rounded to x's type; z in f32."""
    dt = x.dtype
    (wqkv, sqkv), bqkv, (wo, so), bo, (w1, s1), b1, (w2, s2), b2 = \
        _int8_weights(attn, mlp)
    xf = x.float()
    xq, sx = quant_rows(_ln_rows(xf, *_norm(norm1), eps))
    qkv = _qdot(xq, sx, wqkv, sqkv, bqkv).to(dt)
    o = _attention_rows(qkv, t_pad, t_real, attn.query.bias.shape[0], dt)
    oq, s_o = quant_rows(o.float())
    z = xf + _qdot(oq, s_o, wo, so, bo)
    zq, sz = quant_rows(_ln_rows(z, *_norm(norm2), eps))
    hq, sh = quant_rows(gelu_exact(_qdot(zq, sz, w1, s1, b1)))
    return (z + _qdot(hq, sh, w2, s2, b2)).to(dt)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)


def layer_chunk_rows(n: int, e: int, t_pad: int = None,
                     sms: int = SMS) -> int:
    """Rows of a chunk of the layers on float32 x (csrc/fused_layer.cu, the
    int8 layer included): about sms x 128 x 192 / E rows, so that the
    products with E output columns (the out projection and fc2) fill the
    SMs with whole tiles, in whole images of t_pad rows (the attention
    modes) or whole tiles of 128 rows; the rows spread evenly over the
    chunks that takes, and no more units than n fills."""
    unit = t_pad or CHUNK_TILE_M
    units = -(-n // unit)
    cap = max(1, sms * CHUNK_TILE_M * CHUNK_TILE_N // e // unit)
    chunks = -(-units // cap)
    return -(-units // chunks) * unit


def workspace_bytes(mode: int, rows: int, e: int, hd: int,
                    hidden: int) -> int:
    """Bytes of the workspace of a layer on float32 x for chunks of
    ``rows`` rows.  Modes 1-3 (``workspace_floats`` of csrc/fused_layer.cu):
    xn, the LN output (rows, E); in the merged mode z (rows, E); and one
    region for the wide arrays: q|k|v (rows, 3 HD) and o (rows, HD) in the
    attention modes, the MLP hidden (rows, hidden) over them.  The int8
    layer (``MODE_Q8``, ``q8layer::workspace_bytes``): z and the same wide
    region in f32, the int8 rows that every product reads (rows, max(E,
    HD, hidden)) and two f32 values a row (their scales, the hidden's row
    maxima).  It grows with the chunk, not with the rows of x."""
    attn, mlp = bool(mode & MODE_ATTN), bool(mode & MODE_MLP)
    wide = max(4 * hd if attn else 0, hidden if mlp else 0)
    if mode & MODE_Q8:
        return rows * (4 * e + 4 * wide + max(e, hd, hidden) + 8)
    return 4 * rows * ((2 if attn and mlp else 1) * e + wide)


def _no_grad(what, x, *modules):
    """Raises while autograd records: the kernels have no backward."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for m in modules for p in m.parameters())):
        raise RuntimeError(f"{what} is an inference kernel with no backward; "
                           "run it under torch.no_grad() or "
                           "torch.inference_mode()")


def _sm90(dtype):
    """True where csrc/vit_layer_sm90.cu runs the launch: bfloat16, the
    int8 layer included."""
    return dtype == torch.bfloat16


def sm90_workspace_bytes(mode: int, n: int, t_pad: int, e: int, hd: int,
                         slots: int, hidden: int = 0) -> int:
    """Bytes of the workspace of csrc/vit_layer_sm90.cu (``layout`` there):
    the item counter and the per-tile and per-image counters, q|k|v and the
    attention output of every row in the attention modes, each block's slot
    (bf16 xn, then zn; for int8 the quantised rows, max(E, HD, hidden)
    bytes a row), in the merged modes its f32 slot (z) and for int8 its f32
    slot of the MLP hidden; each region rounded up to 1 KB."""
    def a(b):
        return -(-b // 1024) * 1024
    attn = bool(mode & MODE_ATTN)
    q8 = bool(mode & MODE_Q8)
    tiles = -(-n // SM90_ROWS)
    images = n // t_pad if attn else 0
    row = max(e, hd, hidden) if q8 else e * 2
    total = a(4 * (1 + tiles + images)) + a(slots * SM90_ROWS * row)
    if attn:
        total += a(n * 3 * hd * 2) + a(n * hd * 2)
    if mode & MODE_ATTN and mode & MODE_MLP:
        total += a(slots * SM90_ROWS * e * 4)
    if q8:
        total += a(slots * SM90_ROWS * hidden * 4)
    return total


def _split_t(w):
    """W^T (out, in) of an (in, out) float32 matrix, split into its TF32
    big and small halves: (2, out, in), the B operand of chunk_gemm."""
    return torch.stack(tf32_split(w.t().contiguous()))


def pack_weights(mode, dtype, device, norm1, attn, norm2, mlp):
    """The weight operands of one launch in the kernel's order, contiguous
    on ``device``, with a one-element placeholder for each operand ``mode``
    does not read; adds one to ``pack_weights.packings``.

    bfloat16 (csrc/vit_layer_sm90.cu): (wqkv^T (3 HD, E), wo^T (E, HD),
    w1^T (hidden, E), w2^T (E, hidden) in bf16, every product's operands
    K-major; g1, be1, bqkv, bo, g2, be2, b1, b2 in f32), and in
    ``MODE_Q8``, in either type, the four W^T in int8 followed by their
    column scales sqkv, so, s1, s2 (f32).  float32 modes 1-3
    (csrc/fused_layer.cu): (wqkv^T, bqkv, wo^T, bo, w1^T, b1, w2^T, b2, g1,
    be1, g2, be2), each W^T split into its TF32 halves, (2, out, in)."""
    pack_weights.packings += 1
    null = torch.zeros(1, device=device)
    if mode & MODE_Q8:
        (wqkv, sqkv), bqkv, (wo, so), bo, (w1, s1), b1, (w2, s2), b2 = \
            _int8_weights(attn, mlp)
    else:
        sqkv = so = s1 = s2 = null
        wqkv, bqkv, wo, bo = (_attn_weights(attn, dtype) if attn is not None
                              else (null,) * 4)
        w1, b1, w2, b2 = (_mlp_weights(mlp, dtype) if mlp is not None
                          else (null,) * 4)
    g1, be1 = _norm(norm1) if norm1 is not None else (null, null)
    g2, be2 = _norm(norm2) if norm2 is not None else (null, null)
    if _sm90(dtype) or mode & MODE_Q8:
        t = [w.t() if w is not null else w for w in (wqkv, wo, w1, w2)]
        ops = (*t, g1, be1, bqkv, bo, g2, be2, b1, b2)
        if mode & MODE_Q8:
            ops += (sqkv, so, s1, s2)
    else:
        wqkv, wo, w1, w2 = (_split_t(w) if w is not null else w
                            for w in (wqkv, wo, w1, w2))
        ops = (wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1, be1, g2, be2)
    return [t.to(device).contiguous() for t in ops]


pack_weights.packings = 0  # a caller resets it to 0 to count a run

# The layer's attention module (or its MLP) -> {(mode, dtype, device):
# entry}.  Held beside the modules, not on them, so that a module pickles
# and deep-copies without packed tensors or device addresses.
_PACKS = weakref.WeakKeyDictionary()


def _params(m, out):
    """Appends m's parameters and its submodules' to out, in the order of
    ``m.parameters()`` (a fraction of its cost, which a launch pays)."""
    out.extend(p for p in m._parameters.values() if p is not None)
    for c in m._modules.values():
        if c is not None:
            _params(c, out)
    return out


def _state(mods):
    """The identity, version counter, storage, dtype and device of every
    parameter of mods (None entries skipped); None if one is an inference
    tensor, whose in-place updates leave no version behind."""
    key = []
    for m in mods:
        if m is not None:
            for p in _params(m, []):
                if p.is_inference():
                    return None
                key.append((id(p), p._version, p.data_ptr(), p.dtype,
                            p.device))
    return tuple(key)


def _current(entry):
    """True while the modules an entry was packed from live and match its
    key."""
    mods = tuple(r() if r is not None else None for r in entry["mods"])
    return (all(m is not None for m, r in zip(mods, entry["mods"])
                if r is not None) and _state(mods) == entry["key"])


def packed_weights(mode, dtype, device, norm1, attn, norm2, mlp):
    """``pack_weights`` once per model: the cache entry of the layer for
    (mode, dtype, device), a dict with the packed operands under "ops" and,
    once a bfloat16 launch has built them, their TMA descriptors under
    "maps".  The entry holds while every parameter of the modules keeps its
    identity, version counter, storage, dtype and device: an in-place
    update, ``load_state_dict`` or ``.to()`` repacks at the next call, which
    also drops the layer's entries that no longer match their modules (a
    dtype or device the model has left).  Rebinding a parameter's ``.data``
    (as ``torch.nn.utils.vector_to_parameters`` does) changes its storage
    and repacks too.  An in-place write through ``.data``
    (``p.data.copy_(...)``) changes neither its version nor its storage, so
    no key can see it: after one, call ``kernels.clear_weight_packs()``.
    Modules with an inference tensor among their parameters (made under
    ``torch.inference_mode()``) are packed at every call: nothing would show
    their in-place updates."""
    mods = (norm1, attn, norm2, mlp)
    owner = attn if attn is not None else mlp
    key = _state(mods)
    where = (mode, dtype, torch.device(device))
    cache = _PACKS.get(owner, {})
    entry = cache.get(where)
    if key is not None and entry is not None and entry["key"] == key:
        return entry
    entry = {"key": key, "maps": None,
             "mods": tuple(weakref.ref(m) if m is not None else None
                           for m in mods),
             "ops": pack_weights(mode, dtype, device, *mods)}
    if key is None:
        _PACKS.pop(owner, None)
        return entry
    kept = {w: e for w, e in cache.items() if w != where and _current(e)}
    kept[where] = entry
    _PACKS[owner] = kept
    return entry


def _check(what, mode, x, t_pad, t_real, attn, mlp):
    """Checks the shapes against the CUDA design, then the device; returns
    (heads, hidden)."""
    n, e = x.shape
    heads = attn.query.bias.shape[0] if attn is not None else 1
    hd = heads * HEAD_DIM
    hidden = mlp.fc1.kernel.shape[1] if mlp is not None else TILE
    dh = attn.query.bias.shape[1] if attn is not None else HEAD_DIM
    it = x.element_size()
    q8 = bool(mode & MODE_Q8)
    seg = t_pad if mode & MODE_ATTN else 8
    if not fused_layer_fits(seg, e, heads, dh, hidden, it, q8):
        if dh == HEAD_DIM and e % TILE == 0 and hd % TILE == 0 and \
                hidden % TILE == 0 and seg % 8 == 0:
            raise FusedLayerSharedMemoryError(
                f"{what}: t_pad={seg} needs "
                f"{attention_smem_bytes(seg, it)} bytes of shared "
                f"memory for its attention, over the {SMEM_LIMIT} a block "
                "may use; use the composable impl='small' path")
        raise ValueError(f"{what}: E={e} heads={heads} Dh={dh} "
                         f"hidden={hidden} t_pad={seg} are outside the CUDA "
                         "design (Dh 64; E, H*Dh and hidden multiples of 64; "
                         "t_pad a multiple of 8)")
    if mode & MODE_ATTN and (n % t_pad or not 0 < t_real <= t_pad):
        raise ValueError(f"{what}: {n} rows are not whole images of t_pad="
                         f"{t_pad} with 0 < t_real={t_real} <= t_pad")
    if x.device.type != "cuda" or x.dtype not in _DTYPES or \
            not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous float32 or "
                         f"bfloat16 tensor on a CUDA device, got {x.dtype} "
                         f"on {x.device}")
    return heads, hidden


def _launch(what, mode, x, t_pad, t_real, norm1, attn, norm2, mlp, eps):
    """Checks the shapes and the device, takes the packed weights
    (``packed_weights``), allocates the output and the workspace and
    launches ``launch_vit_layer_sm90`` (bfloat16), ``launch_fused_layer``
    (the int8 layer on float32 x) or ``launch_fused_layer_tf32x3`` (the
    float32 modes) in ``mode``; t_pad and t_real are None in ``MODE_MLP``.
    A launch that is refused raises: there is no other path on the card."""
    heads, hidden = _check(what, mode, x, t_pad, t_real, attn, mlp)
    if _sm90(x.dtype):
        return _launch_sm90(what, mode, x, t_pad, t_real, norm1, attn, norm2,
                            mlp, eps, heads, hidden)
    launch = _launch_q8 if mode & MODE_Q8 else _launch_tf32x3
    rc, y = launch(mode, x, t_pad, t_real, norm1, attn, norm2, mlp, eps,
                   heads, hidden)
    if rc != 0:
        raise RuntimeError(f"{launch.__name__[1:]} ({what}) failed: CUDA "
                           f"error {rc}")
    return y


def _launch_tf32x3(mode, x, t_pad, t_real, norm1, attn, norm2, mlp, eps,
                   heads, hidden):
    """One call of csrc/fused_layer.cu's float32 modes: chunks of
    ``layer_chunk_rows`` rows through a workspace of ``workspace_bytes``."""
    n, e = x.shape
    dev = x.device
    wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1, be1, g2, be2 = packed_weights(
        mode, x.dtype, dev, norm1, attn, norm2, mlp)["ops"]
    hd = heads * HEAD_DIM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attention = bool(mode & MODE_ATTN)
    rows = layer_chunk_rows(n, e, t_pad if attention else None, sms)
    ws = torch.empty(workspace_bytes(mode, rows, e, hd, hidden) // 4,
                     dtype=torch.float32, device=dev)
    x = aligned16(x)
    y = torch.empty_like(x)
    rc = library().launch_fused_layer_tf32x3(
        mode, x.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), rows,
        g1.data_ptr(), be1.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), g2.data_ptr(), be2.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), n,
        t_pad if attention else 0, t_real if attention else 0, e, heads,
        hidden, eps, torch.cuda.current_stream(dev).cuda_stream)
    return rc, y


def _launch_q8(mode, x, t_pad, t_real, norm1, attn, norm2, mlp, eps, heads,
               hidden):
    """One call of the int8 layer on float32 x (csrc/fused_layer.cu, mode
    7): chunks of ``layer_chunk_rows`` rows (whole images) through a
    workspace of ``workspace_bytes``."""
    n, e = x.shape
    dev = x.device
    wqkv, wo, w1, w2, g1, be1, bqkv, bo, g2, be2, b1, b2, sqkv, so, s1, s2 = (
        packed_weights(mode, x.dtype, dev, norm1, attn, norm2, mlp)["ops"])
    hd = heads * HEAD_DIM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = layer_chunk_rows(n, e, t_pad, sms)
    ws = torch.empty(workspace_bytes(mode, rows, e, hd, hidden),
                     dtype=torch.uint8, device=dev)
    x = aligned16(x)
    y = torch.empty_like(x)
    rc = library().launch_fused_layer(
        mode, x.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), rows,
        g1.data_ptr(), be1.data_ptr(), wqkv.data_ptr(), sqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
        g2.data_ptr(), be2.data_ptr(), w1.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), n, t_pad,
        t_real, e, heads, hidden, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    return rc, y


def _launch_sm90(what, mode, x, t_pad, t_real, norm1, attn, norm2, mlp, eps,
                 heads, hidden):
    """One launch of csrc/vit_layer_sm90.cu; builds the weights' TMA
    descriptors into the cache entry at its first launch."""
    n, e = x.shape
    dev = x.device
    lib = library()
    entry = packed_weights(mode, x.dtype, dev, norm1, attn, norm2, mlp)
    wqkv, wo, w1, w2, g1, be1, bqkv, bo, g2, be2, b1, b2, *scales = \
        entry["ops"]
    q8 = bool(mode & MODE_Q8)
    if entry["maps"] is None:
        maps = ctypes.create_string_buffer(4 * TMA_MAP_BYTES)
        a, m = attn is not None, mlp is not None
        rc = lib.vit_layer_sm90_weight_maps(
            ctypes.addressof(maps), wqkv.data_ptr() if a else None,
            wo.data_ptr() if a else None, w1.data_ptr() if m else None,
            w2.data_ptr() if m else None, e, heads, hidden, int(q8))
        if rc != 0:
            raise RuntimeError(f"vit_layer_sm90_weight_maps ({what}) failed: "
                               f"error {rc}")
        entry["maps"] = maps.raw  # bytes, so that the modules still pickle
    if not mode & MODE_ATTN:
        t_pad, t_real = SM90_ROWS, 1
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty(sm90_workspace_bytes(mode, n, t_pad, e,
                                          heads * HEAD_DIM, slots, hidden),
                     dtype=torch.uint8, device=dev)
    y = torch.empty_like(x)
    scale_ptrs = [t.data_ptr() for t in scales] if q8 else [None] * 4
    rc = lib.launch_vit_layer_sm90(
        mode, x.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), slots,
        entry["maps"], g1.data_ptr(), be1.data_ptr(),
        bqkv.data_ptr(), bo.data_ptr(), g2.data_ptr(), be2.data_ptr(),
        b1.data_ptr(), b2.data_ptr(), *scale_ptrs, n, t_pad, t_real, e, heads, hidden, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_vit_layer_sm90 ({what}) failed: error "
                           f"{rc}")
    return y


def attn_layer_infer(x, norm1, attn, *, t_pad: int, t_real: int,
                     eps: float = 1e-6):
    """x: (B * t_pad, E) folded tokens -> same shape, y = x + MHA(LN1(x)).
    norm1: ``LayerNorm``; attn: ``MHA``."""
    _no_grad("attn_layer_infer", x, norm1, attn)
    if x.device.type == "cpu":
        return attn_layer_infer_plain(x, norm1, attn, t_pad=t_pad,
                                      t_real=t_real, eps=eps)
    y = _launch("attn_layer_infer", MODE_ATTN, x, t_pad, t_real, norm1, attn,
                None, None, eps)
    attn_layer_infer.launches += 1
    check_kernel("attn_layer_infer", y)
    return y


def ln_mlp_infer(x, norm2, mlp, *, eps: float = 1e-6):
    """x: (N, E) token rows -> same shape, y = x + MLP(LN2(x)).
    norm2: ``LayerNorm``; mlp: ``MLP`` (fc1 (E, Hd), fc2 (Hd, E))."""
    _no_grad("ln_mlp_infer", x, norm2, mlp)
    if x.device.type == "cpu":
        return ln_mlp_infer_plain(x, norm2, mlp, eps=eps)
    y = _launch("ln_mlp_infer", MODE_MLP, x, None, None, None, None, norm2,
                mlp, eps)
    ln_mlp_infer.launches += 1
    check_kernel("ln_mlp_infer", y)
    return y


def vit_layer_infer(x, norm1, attn, norm2, mlp, *, t_pad: int, t_real: int,
                    eps: float = 1e-6):
    """The whole ViT layer in one launch on folded (B * t_pad, E) rows,
    z kept in float32 between the sublayers."""
    _no_grad("vit_layer_infer", x, norm1, attn, norm2, mlp)
    if x.device.type == "cpu":
        return vit_layer_infer_plain(x, norm1, attn, norm2, mlp, t_pad=t_pad,
                                     t_real=t_real, eps=eps)
    y = _launch("vit_layer_infer", MODE_ATTN | MODE_MLP, x, t_pad, t_real,
                norm1, attn, norm2, mlp, eps)
    vit_layer_infer.launches += 1
    check_kernel("vit_layer_infer", y)
    return y


def vit_layer_infer_int8(x, norm1, attn, norm2, mlp, *, t_pad: int,
                         t_real: int, eps: float = 1e-6):
    """``vit_layer_infer`` with the six projections int8 x int8 -> int32:
    weights quantised per column here, rows per row in the kernel; an
    opt-in serving mode that drifts by about 1% of the logit scale."""
    _no_grad("vit_layer_infer_int8", x, norm1, attn, norm2, mlp)
    if x.device.type == "cpu":
        return vit_layer_infer_int8_plain(x, norm1, attn, norm2, mlp,
                                          t_pad=t_pad, t_real=t_real,
                                          eps=eps)
    y = _launch("vit_layer_infer_int8", MODE_ATTN | MODE_MLP | MODE_Q8, x,
                t_pad, t_real, norm1, attn, norm2, mlp, eps)
    vit_layer_infer_int8.launches += 1
    check_kernel("vit_layer_infer_int8", y)
    return y


# Kernel launches so far; a caller resets them to 0 to count a run.
attn_layer_infer.launches = 0
ln_mlp_infer.launches = 0
vit_layer_infer.launches = 0
vit_layer_infer_int8.launches = 0
