"""The fused ViT-layer kernels' weights, packed once per model.

``packed_weights`` caches what ``pack_weights`` returns per layer and
(mode, dtype, device), beside the modules, and ``pack_weights.packings``
counts the packings.  On the CPU (and on ``meta`` tensors, which stand in
for the card):

- a second call returns the same packed tensors and packs nothing;
- an in-place update of any parameter, ``load_state_dict`` and a change of
  dtype or device repack, and the new operands follow the new weights;
- entries for a dtype or device the modules have left are dropped, entries
  of another launch kind of the same layer are kept;
- modules made under ``torch.inference_mode()`` are packed at every call,
  so an in-place update there is followed too;
- the modules deep-copy and pickle without the cache;
- the int8 layer's per-column quantisation through the cache equals
  ``quant_cols`` bit for bit;
- the bf16 layer (csrc/vit_layer_sm90.cu) takes every product's weights
  transposed (K-major), the other kernels as the JAX wrappers pack them;
- the bf16 layer's workspace and shared memory at ViT-S, B 192.

The CUDA kernels run only on the card, where ``python3 chip_smoke.py``
(phase 7) checks that a second ViT forward packs nothing.
"""

import copy
import gc
import math
import pickle
import weakref

import numpy as np
import pytest
import torch

from transformer_stm_tpu_torch.kernels import fused_layer
from transformer_stm_tpu_torch.kernels.fused_layer import (
    MODE_ATTN, MODE_MLP, MODE_Q8, pack_weights, packed_weights, quant_cols)
from transformer_stm_tpu_torch.ops.attention import MHA
from transformer_stm_tpu_torch.ops.blocks import MLP
from transformer_stm_tpu_torch.ops.common import LayerNorm

BOTH = MODE_ATTN | MODE_MLP
# (mode, dtype) of each launch kind: the bf16 layer and pair, f32, int8
KINDS = [(BOTH, torch.bfloat16), (MODE_ATTN, torch.bfloat16),
         (MODE_MLP, torch.bfloat16), (BOTH, torch.float32),
         (BOTH | MODE_Q8, torch.bfloat16)]
KIND_IDS = ["bf16_layer", "bf16_attn", "bf16_mlp", "f32_layer", "int8_layer"]


def layer(e=128, h=2, seed=0, dtype=torch.float32):
    """(LayerNorm, MHA, LayerNorm, MLP) with random parameters from numpy."""
    rng = np.random.default_rng(seed)
    mods = (LayerNorm(e), MHA(e, h), LayerNorm(e), MLP(e, 4 * e))
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                p.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return [m.to(dtype) for m in mods]


def used(mode, mods):
    """The modules a launch in ``mode`` reads (None for the others)."""
    n1, attn, n2, mlp = mods
    return (n1 if mode & MODE_ATTN else None,
            attn if mode & MODE_ATTN else None,
            n2 if mode & MODE_MLP else None, mlp if mode & MODE_MLP else None)


def same(a, b):
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_second_call_packs_nothing(mode, dtype):
    mods = used(mode, layer(dtype=dtype))
    start = pack_weights.packings
    first = packed_weights(mode, dtype, "cpu", *mods)
    again = packed_weights(mode, dtype, torch.device("cpu"), *mods)
    assert pack_weights.packings == start + 1
    assert again is first and same(again["ops"], first["ops"])
    assert equal(first["ops"], pack_weights(mode, dtype, "cpu", *mods))


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_in_place_update_repacks(mode, dtype):
    mods = used(mode, layer(dtype=dtype))
    old = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    target = mods[1] if mods[1] is not None else mods[3]
    with torch.no_grad():
        next(target.parameters()).mul_(2.0)
    start = pack_weights.packings
    new = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    assert pack_weights.packings == start + 1
    assert not equal(new, old)
    assert equal(new, pack_weights(mode, dtype, "cpu", *mods))
    # an LN parameter alone counts too
    norm = mods[0] if mods[0] is not None else mods[2]
    with torch.no_grad():
        norm.beta.add_(1.0)
    start = pack_weights.packings
    assert not same(packed_weights(mode, dtype, "cpu", *mods)["ops"], new)
    assert pack_weights.packings == start + 1


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_load_state_dict_repacks(mode, dtype):
    mods = used(mode, layer(dtype=dtype))
    other = used(mode, layer(seed=1, dtype=dtype))
    old = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    for m, o in zip(mods, other):
        if m is not None:
            m.load_state_dict(o.state_dict())
    new = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    assert not equal(new, old)
    assert equal(new, pack_weights(mode, dtype, "cpu", *other))


def test_dtype_and_device_changes_repack():
    mods = layer()
    f32 = packed_weights(BOTH, torch.float32, "cpu", *mods)
    # the same modules cast in place of their data: repacked in bf16
    bf = [m.to(torch.bfloat16) for m in mods]
    start = pack_weights.packings
    b16 = packed_weights(BOTH, torch.bfloat16, "cpu", *bf)
    assert pack_weights.packings == start + 1 and b16 is not f32
    assert all(t.dtype == torch.bfloat16 for t in b16["ops"][:4])
    # the card's stand-in: a separate entry on the meta device, repacked
    # again once the parameters themselves move there
    meta = packed_weights(BOTH, torch.bfloat16, "meta", *bf)
    assert meta is not b16 and all(t.device.type == "meta"
                                   for t in meta["ops"])
    assert pack_weights.packings == start + 2
    moved = [m.to("meta") for m in bf]
    again = packed_weights(BOTH, torch.bfloat16, "meta", *moved)
    assert again is not meta and pack_weights.packings == start + 3
    assert packed_weights(BOTH, torch.bfloat16, "meta", *moved) is again


def test_int8_through_the_cache_equals_quant_cols():
    """The bf16 int8 layer (csrc/vit_layer_sm90.cu) takes each projection as
    int8 W^T (out, in), its column scales after the biases."""
    n1, attn, n2, mlp = layer(dtype=torch.bfloat16)
    ops = packed_weights(BOTH | MODE_Q8, torch.bfloat16, "cpu", n1, attn, n2,
                         mlp)["ops"]
    wqkv, _, wo, _ = fused_layer._attn_weights(attn, attn.query.kernel.dtype)
    w1, _, w2, _ = fused_layer._mlp_weights(mlp, mlp.fc1.kernel.dtype)
    assert len(ops) == 16
    for q, s, w in zip(ops[:4], ops[12:], (wqkv, wo, w1, w2)):
        want_q, want_s = quant_cols(w)
        assert q.dtype == torch.int8 and torch.equal(q, want_q.t())
        assert q.is_contiguous() and torch.equal(s, want_s)


def test_bf16_layer_takes_the_weights_transposed():
    n1, attn, n2, mlp = layer(dtype=torch.bfloat16)
    ops = packed_weights(BOTH, torch.bfloat16, "cpu", n1, attn, n2,
                         mlp)["ops"]
    wqkv, bqkv, wo, bo = fused_layer._attn_weights(attn, torch.bfloat16)
    w1, b1, w2, b2 = fused_layer._mlp_weights(mlp, torch.bfloat16)
    assert equal(ops, [wqkv.t(), wo.t(), w1.t(), w2.t(), n1.gamma.float(),
                       n1.beta.float(), bqkv, bo, n2.gamma.float(),
                       n2.beta.float(), b1, b2])
    assert all(t.is_contiguous() for t in ops)
    # q's columns carry 1/sqrt(Dh), applied in q's own type
    e, h, dh = attn.query.kernel.shape
    q = (attn.query.kernel.reshape(e, h * dh) / math.sqrt(dh)).to(
        torch.bfloat16)
    assert torch.equal(ops[0][:h * dh], q.t())


def test_bf16_layer_workspace_and_shared_memory():
    """ViT-S at B 192 on 132 blocks: q|k|v and the attention output of every
    row (117,964,800 bytes), the slots (6.5 MB in bf16, 13 MB of z in f32),
    and a block's shared memory under the 227 KB limit at t_pad 200."""
    n, e, hd, slots = 192 * 200, 384, 384, 132
    got = fused_layer.sm90_workspace_bytes(BOTH, n, 200, e, hd, slots)
    tiles = n // 64
    flags = -(-4 * (1 + tiles + 192) // 1024) * 1024
    assert got == (flags + n * 3 * hd * 2 + n * hd * 2 + slots * 64 * e * 2
                   + slots * 64 * e * 4)
    only_mlp = fused_layer.sm90_workspace_bytes(MODE_MLP, n, 200, e, hd,
                                                slots)
    assert only_mlp == -(-4 * (1 + tiles) // 1024) * 1024 + slots * 64 * e * 2
    assert fused_layer.attention_smem_bytes(200) == 2048 + 3 * 57344 + 16384
    assert fused_layer.attention_smem_bytes(200) <= fused_layer.SMEM_LIMIT


def test_entries_the_modules_left_are_dropped():
    mods = layer()
    owner = mods[1]
    packed_weights(BOTH, torch.float32, "cpu", *mods)
    packed_weights(MODE_ATTN, torch.float32, "cpu", *used(MODE_ATTN, mods))
    packed_weights(BOTH, torch.float32, "meta", *mods)
    assert set(fused_layer._PACKS[owner]) == {
        (BOTH, torch.float32, torch.device("cpu")),
        (MODE_ATTN, torch.float32, torch.device("cpu")),
        (BOTH, torch.float32, torch.device("meta"))}
    # another launch kind of the same layer does not evict them
    start = pack_weights.packings
    for mode in (BOTH, MODE_ATTN, BOTH):
        packed_weights(mode, torch.float32, "cpu", *used(mode, mods))
    assert pack_weights.packings == start
    # the modules move: every entry of their old state goes at the next miss
    moved = [m.to(torch.bfloat16) for m in mods]
    packed_weights(BOTH, torch.bfloat16, "cpu", *moved)
    assert set(fused_layer._PACKS[owner]) == {
        (BOTH, torch.bfloat16, torch.device("cpu"))}
    # an update of the MLP alone keeps the attention's entry
    packed_weights(MODE_ATTN, torch.bfloat16, "cpu", *used(MODE_ATTN, moved))
    with torch.no_grad():
        moved[3].fc1.bias.add_(1.0)
    packed_weights(BOTH, torch.bfloat16, "meta", *moved)
    assert set(fused_layer._PACKS[owner]) == {
        (MODE_ATTN, torch.bfloat16, torch.device("cpu")),
        (BOTH, torch.bfloat16, torch.device("meta"))}


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_inference_tensors_are_packed_every_call(mode, dtype):
    with torch.inference_mode():
        mods = used(mode, [m.to(dtype) for m in layer(dtype=dtype)])
        assert all(p.is_inference() for m in mods if m is not None
                   for p in m.parameters())
        start = pack_weights.packings
        old = packed_weights(mode, dtype, "cpu", *mods)["ops"]
        target = mods[1] if mods[1] is not None else mods[3]
        next(target.parameters()).mul_(2.0)
        new = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    assert pack_weights.packings == start + 2
    assert not equal(new, old)
    assert equal(new, pack_weights(mode, dtype, "cpu", *mods))
    assert (mods[1] if mods[1] is not None else mods[3]) not in \
        fused_layer._PACKS


def test_modules_copy_and_pickle_without_the_cache():
    mods = layer(dtype=torch.bfloat16)
    packed_weights(BOTH, torch.bfloat16, "cpu", *mods)
    attn = mods[1]
    assert attn in fused_layer._PACKS
    assert not any("pack" in k for k in vars(attn))
    twin = copy.deepcopy(attn)
    assert twin not in fused_layer._PACKS
    loaded = pickle.loads(pickle.dumps(attn))
    assert loaded not in fused_layer._PACKS
    # the copy packs its own entry; the cache does not keep a module alive
    start = pack_weights.packings
    packed_weights(BOTH, torch.bfloat16, "cpu", mods[0], twin, *mods[2:])
    assert pack_weights.packings == start + 1
    gone = weakref.ref(twin)
    del twin
    gc.collect()
    assert gone() is None


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_vector_to_parameters_repacks(mode, dtype):
    """``vector_to_parameters`` rebinds each parameter's ``.data`` and bumps
    no version counter; the storage in the key sees it."""
    mods = used(mode, layer(dtype=dtype))
    params = [p for m in mods if m is not None for p in m.parameters()]
    old = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    versions = [p._version for p in params]
    new_values = torch.nn.utils.parameters_to_vector(params) * 0.5 + 1.0
    torch.nn.utils.vector_to_parameters(new_values, params)
    assert [p._version for p in params] == versions
    start = pack_weights.packings
    new = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    assert pack_weights.packings == start + 1
    assert not equal(new, old)
    assert equal(new, pack_weights(mode, dtype, "cpu", *mods))


@pytest.mark.parametrize("mode,dtype", KINDS, ids=KIND_IDS)
def test_write_through_data_then_clear_weight_packs(mode, dtype):
    """A write through ``.data`` changes neither version nor storage, so the
    cache keeps its entry; ``kernels.clear_weight_packs()`` drops it."""
    from transformer_stm_tpu_torch.kernels import clear_weight_packs

    mods = used(mode, layer(dtype=dtype))
    old = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    target = mods[1] if mods[1] is not None else mods[3]
    next(target.parameters()).data.copy_(2.0)
    assert packed_weights(mode, dtype, "cpu", *mods)["ops"] is old
    clear_weight_packs()
    assert target not in fused_layer._PACKS
    start = pack_weights.packings
    new = packed_weights(mode, dtype, "cpu", *mods)["ops"]
    assert pack_weights.packings == start + 1
    assert equal(new, pack_weights(mode, dtype, "cpu", *mods))
    assert not equal(new, old)
