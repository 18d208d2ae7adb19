"""Keras/TensorFlow compatibility of the port
(transformer_stm_tpu/train/keras_compat.py): the reference architecture's
Keras twin and weight import.

Users of the reference have ``.h5`` weight files named
``cvt_model_weights_{freq}_{proj}_cls{bool}.h5`` (reference:
models/CvT(Par).py:489).  The twin is an independent Keras implementation
of the reference architecture (models/CvT(Par).py:83-354) whose weights map
one to one onto the JAX layout's trees, which ``from_jax_params`` loads into
the port's ``CvT``; the tests hold the port's forward against it.

TensorFlow and h5py are optional: each is imported inside the function that
needs it, and nothing in the compute path imports this module.
"""

from __future__ import annotations

import numpy as np

from ..config import CvTSpec


# ---------------------------------------------------------------------------
# Twin Keras model (independent implementation of the reference architecture)
# ---------------------------------------------------------------------------

class KerasTwinCvT:
    """The reference CvT rebuilt from its observed behavior as a flat bag of
    Keras layers + explicit forward — used to validate numerics, not to run.

    Architecture per reference models/CvT(Par).py: 3x [ConvEmbed ->
    ConvTransformerBlock], cls or token-mean head, optional Dense(256,relu)x2
    process branch, final linear Dense.  Quirks included: identity 'linear'
    projection, q_proj 'linear' when method='avg', shared norm1, dead embed
    norm, attention called on (q, v, k).
    """

    def __init__(self, spec: CvTSpec, seed: int = 0):
        import tensorflow as tf
        from tensorflow.keras import layers

        self.spec = spec
        self.tf = tf
        rng = np.random.default_rng(seed)
        self.stages = []
        for st in spec.stages:
            s = {}
            s["embed_conv"] = layers.Conv2D(st.embed_dim, st.patch_size,
                                            strides=st.stride, padding="same")
            s["norm1"] = layers.LayerNormalization(epsilon=1e-6)
            method = st.qkv_method

            def make_proj(m):
                if m == "dw_bn":
                    return {"conv": layers.DepthwiseConv2D(
                                st.kernel_size, strides=st.strides,
                                padding="same", use_bias=False),
                            "bn": layers.BatchNormalization()}
                if m == "avg":
                    return {"pool": layers.AveragePooling2D(
                        pool_size=st.kernel_size, strides=st.strides,
                        padding="same")}
                return {}

            s["q_proj"] = make_proj("linear" if method == "avg" else method)
            s["k_proj"] = make_proj(method)
            s["v_proj"] = make_proj(method)
            s["proj_q"] = layers.Dense(st.embed_dim)
            s["proj_k"] = layers.Dense(st.embed_dim)
            s["proj_v"] = layers.Dense(st.embed_dim)
            s["mha"] = layers.MultiHeadAttention(
                num_heads=st.num_heads,
                key_dim=st.embed_dim // st.num_heads)
            s["attn_out"] = layers.Dense(st.embed_dim)
            s["mlp1"] = layers.Dense(st.embed_dim * st.mlp_ratio,
                                     activation=tf.nn.gelu)
            s["mlp2"] = layers.Dense(st.embed_dim)
            if st.with_cls_token:
                s["cls_token"] = tf.Variable(
                    np.zeros((1, 1, st.embed_dim), np.float32),
                    name="cls_token")
            self.stages.append(s)

        self.head_norm = layers.LayerNormalization(epsilon=1e-6)
        if spec.proc_dim > 0:
            self.proc_fc1 = layers.Dense(spec.proc_hidden, activation="relu")
            self.proc_fc2 = layers.Dense(spec.proc_hidden, activation="relu")
        self.final = layers.Dense(spec.num_classes)
        del rng

    def _projection(self, proj, x, method, training):
        if "conv" in proj:
            return proj["bn"](proj["conv"](x), training=training)
        if "pool" in proj:
            return proj["pool"](x)
        return x

    def __call__(self, images, proc=None, training: bool = False):
        tf = self.tf
        x = tf.convert_to_tensor(images, tf.float32)
        cls_out = None
        for st, s in zip(self.spec.stages, self.stages):
            x = s["embed_conv"](x)
            b = tf.shape(x)[0]
            h, w, c = x.shape[1], x.shape[2], x.shape[3]
            tokens = tf.reshape(x, [b, h * w, c])
            if st.with_cls_token:
                cls = tf.tile(s["cls_token"], [b, 1, 1])
                tokens = tf.concat([cls, tokens], axis=1)

            y = s["norm1"](tokens)
            if st.with_cls_token:
                cls_y, grid_y = y[:, :1, :], y[:, 1:, :]
            else:
                cls_y, grid_y = None, y
            grid_y = tf.reshape(grid_y, [b, h, w, c])
            method = st.qkv_method
            q = self._projection(s["q_proj"], grid_y,
                                 "linear" if method == "avg" else method,
                                 training)
            k = self._projection(s["k_proj"], grid_y, method, training)
            v = self._projection(s["v_proj"], grid_y, method, training)
            q = tf.reshape(q, [b, -1, c])
            k = tf.reshape(k, [b, -1, c])
            v = tf.reshape(v, [b, -1, c])
            if st.with_cls_token:
                q = tf.concat([cls_y, q], axis=1)
                k = tf.concat([cls_y, k], axis=1)
                v = tf.concat([cls_y, v], axis=1)
            q = s["proj_q"](q)
            k = s["proj_k"](k)
            v = s["proj_v"](v)
            # reference: attention(q, v, k) = (query, value, key)
            attn = s["mha"](q, v, k, training=training)
            attn = s["attn_out"](attn)
            tokens = attn + tokens

            y = s["norm1"](tokens)  # shared norm quirk
            tokens = tokens + s["mlp2"](s["mlp1"](y))

            if st.with_cls_token:
                cls_out, grid = tokens[:, :1, :], tokens[:, 1:, :]
            else:
                grid = tokens
            x = tf.reshape(grid, [b, h, w, c])

        if cls_out is not None:
            feat = tf.squeeze(self.head_norm(cls_out), axis=1)
        else:
            b = tf.shape(x)[0]
            tokens = tf.reshape(x, [b, x.shape[1] * x.shape[2], x.shape[3]])
            feat = tf.reduce_mean(self.head_norm(tokens), axis=1)

        if self.spec.proc_dim > 0:
            p = self.proc_fc2(self.proc_fc1(tf.convert_to_tensor(
                proc, tf.float32)))
            feat = tf.concat([feat, p], axis=-1)
        return self.final(feat)


# ---------------------------------------------------------------------------
# Weight mapping Keras twin -> the JAX layout's numpy trees
# ---------------------------------------------------------------------------

def _dense_params(layer):
    return {"kernel": np.asarray(layer.kernel),
            "bias": np.asarray(layer.bias)}


def _ln_params(layer):
    return {"gamma": np.asarray(layer.gamma), "beta": np.asarray(layer.beta)}


def _mha_params(layer):
    return {
        "query": {"kernel": np.asarray(layer._query_dense.kernel),
                  "bias": np.asarray(layer._query_dense.bias)},
        "key": {"kernel": np.asarray(layer._key_dense.kernel),
                "bias": np.asarray(layer._key_dense.bias)},
        "value": {"kernel": np.asarray(layer._value_dense.kernel),
                  "bias": np.asarray(layer._value_dense.bias)},
        "out": {"kernel": np.asarray(layer._output_dense.kernel),
                "bias": np.asarray(layer._output_dense.bias)},
    }


def _proj_params(proj):
    if "conv" in proj:
        conv = proj["conv"]
        bn = proj["bn"]
        kernel = np.asarray(conv.kernel if hasattr(conv, "kernel")
                            else conv.depthwise_kernel)
        params = {"conv": {"kernel": kernel},
                  "bn": {"gamma": np.asarray(bn.gamma),
                         "beta": np.asarray(bn.beta)}}
        state = {"bn": {"mean": np.asarray(bn.moving_mean),
                        "var": np.asarray(bn.moving_variance)}}
        return params, state
    return {}, {}


def twin_to_pytree(twin: KerasTwinCvT):
    """The twin's weights as (params, state) numpy trees in the JAX layout
    (``init_cvt``'s structure exactly), ready for ``from_jax_params``."""
    spec = twin.spec
    params = {"stages": []}
    state = {"stages": []}
    for st, s in zip(spec.stages, twin.stages):
        qp, qs = _proj_params(s["q_proj"])
        kp, ks = _proj_params(s["k_proj"])
        vp, vs = _proj_params(s["v_proj"])
        block = {
            "norm1": _ln_params(s["norm1"]),
            "attn": {
                "q_proj": qp, "k_proj": kp, "v_proj": vp,
                "proj_q": _dense_params(s["proj_q"]),
                "proj_k": _dense_params(s["proj_k"]),
                "proj_v": _dense_params(s["proj_v"]),
                "mha": _mha_params(s["mha"]),
                "proj": _dense_params(s["attn_out"]),
            },
            "mlp": {"fc1": _dense_params(s["mlp1"]),
                    "fc2": _dense_params(s["mlp2"])},
        }
        if st.with_cls_token:
            block["cls_token"] = np.asarray(s["cls_token"])
        params["stages"].append({
            "embed": {"proj": {"kernel": np.asarray(s["embed_conv"].kernel),
                               "bias": np.asarray(s["embed_conv"].bias)}},
            "blocks": [block],
        })
        state["stages"].append(
            {"blocks": [{"attn": {"q_proj": qs, "k_proj": ks,
                                  "v_proj": vs}}]})

    params["head_norm"] = _ln_params(twin.head_norm)
    if spec.proc_dim > 0:
        params["proc_fc1"] = _dense_params(twin.proc_fc1)
        params["proc_fc2"] = _dense_params(twin.proc_fc2)
    params["final"] = _dense_params(twin.final)
    return params, state


def build_twin(spec: CvTSpec, batch: int = 1, seed: int = 0,
               randomize: bool = True) -> KerasTwinCvT:
    """Build + trace the twin so all weights exist; optionally randomize every
    weight (incl. BN moving stats) so parity checks are non-trivial."""
    twin = KerasTwinCvT(spec, seed)
    imgs = np.zeros((batch, spec.image_height, spec.image_width,
                     spec.num_channels), np.float32)
    proc = np.zeros((batch, spec.proc_dim), np.float32) \
        if spec.proc_dim > 0 else None
    twin(imgs, proc)  # build
    if randomize:
        rng = np.random.default_rng(seed)
        for s in twin.stages:
            for key, obj in s.items():
                if key in ("q_proj", "k_proj", "v_proj") and "bn" in obj:
                    bn = obj["bn"]
                    bn.gamma.assign(rng.normal(1.0, 0.1, bn.gamma.shape)
                                    .astype(np.float32))
                    bn.beta.assign(rng.normal(0.0, 0.1, bn.beta.shape)
                                   .astype(np.float32))
                    bn.moving_mean.assign(
                        rng.normal(0.0, 0.5, bn.moving_mean.shape)
                        .astype(np.float32))
                    bn.moving_variance.assign(
                        rng.uniform(0.5, 2.0, bn.moving_variance.shape)
                        .astype(np.float32))
            if "cls_token" in s:
                s["cls_token"].assign(
                    rng.normal(0.0, 0.02, s["cls_token"].shape)
                    .astype(np.float32))
    return twin


# ---------------------------------------------------------------------------
# Direct .h5 / .weights.h5 import (no TF needed at load time)
# ---------------------------------------------------------------------------

def load_h5_weight_arrays(path: str):
    """Flat {path: np.ndarray} from a Keras weights HDF5 file: the legacy
    Keras-2 layout (layer groups and 'weight_names' attributes, what the
    reference's save_weights wrote, models/CvT(Par).py:489) and the Keras-3
    '.weights.h5' layout ('_layer_checkpoint_dependencies') alike."""
    from .h5_import import _load_arrays

    return _load_arrays(path)
