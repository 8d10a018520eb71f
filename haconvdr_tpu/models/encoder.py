"""ANCE dual encoder.

Functional JAX re-design of the reference ANCE/BERT dual-encoder models
(/root/reference/src/models.py:20-110): a RoBERTa-base (or BERT) transformer
encoder, a 768-d ``embeddingHead`` Linear + LayerNorm projection, and
first-token (CLS) pooling with an optional masked-mean mode.  The query and
passage towers share this single encoder (``doc_emb == query_emb``,
src/models.py:48-49).

Design choices (deliberately not a torch translation):
  * params are a plain nested-dict pytree -> trivially shardable with
    jax.sharding.NamedSharding, checkpointable with orbax, and convertible
    from HF torch checkpoints (see models/hf_import.py);
  * the whole forward is one jit-compilable pure function with static
    shapes; attention takes the padding mask once per layer;
  * matmul compute dtype is configurable (float32 at full fp32 precision,
    or bfloat16), parameters and LayerNorm statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.ops import backend

EncoderParams = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def _dense_init(key, in_dim, out_dim, std=0.02):
    kkey, _ = jax.random.split(key)
    return {
        "kernel": jax.random.normal(kkey, (in_dim, out_dim), jnp.float32) * std,
        "bias": jnp.zeros((out_dim,), jnp.float32),
    }


def _ln_init(dim):
    return {"scale": jnp.ones((dim,), jnp.float32), "bias": jnp.zeros((dim,), jnp.float32)}


def init_encoder_params(key: jax.Array, cfg: ModelConfig) -> EncoderParams:
    """Random init mirroring the reference's normal(0, 0.02) scheme
    (src/models.py:32-37)."""
    keys = jax.random.split(key, 8 + 8 * cfg.num_hidden_layers)
    ki = iter(keys)
    H, I = cfg.hidden_size, cfg.intermediate_size
    params: EncoderParams = {
        "embeddings": {
            "word_embeddings": jax.random.normal(next(ki), (cfg.vocab_size, H), jnp.float32) * 0.02,
            "position_embeddings": jax.random.normal(
                next(ki), (cfg.max_position_embeddings, H), jnp.float32
            )
            * 0.02,
            "token_type_embeddings": jax.random.normal(
                next(ki), (cfg.type_vocab_size, H), jnp.float32
            )
            * 0.02,
            "layer_norm": _ln_init(H),
        },
        "layers": [],
        "embedding_head": _dense_init(next(ki), H, cfg.embedding_dim),
        "norm": _ln_init(cfg.embedding_dim),
    }
    for _ in range(cfg.num_hidden_layers):
        layer = {
            "attention": {
                "query": _dense_init(next(ki), H, H),
                "key": _dense_init(next(ki), H, H),
                "value": _dense_init(next(ki), H, H),
                "output": _dense_init(next(ki), H, H),
                "output_layer_norm": _ln_init(H),
            },
            "intermediate": _dense_init(next(ki), H, I),
            "output": _dense_init(next(ki), I, H),
            "output_layer_norm": _ln_init(H),
        }
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(
    x: jax.Array, p: Dict[str, jax.Array], eps: float, out_dtype=None
) -> jax.Array:
    # normalize in >= float32 (float64 params promote for parity testing);
    # ``out_dtype`` casts the result back to the compute dtype so bf16
    # activations stay bf16 end-to-end (mixed-precision policy: params and
    # LN/softmax internals in f32, carry in the compute dtype)
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    y = y * p["scale"] + p["bias"]
    return y if out_dtype is None else y.astype(out_dtype)


def _acc_dtype(dtype):
    # accumulate in f32; promote to f64 only for parity testing
    return jnp.promote_types(dtype, jnp.float32)


def _dense(x: jax.Array, p: Dict[str, jax.Array], dtype, out_dtype=None) -> jax.Array:
    k = p["kernel"]
    if k.dtype == jnp.int8:
        # int8 x int8 dense (quantize_encoder_params): weights are
        # per-output-channel symmetric int8; activations are quantized
        # per-token symmetric HERE (dynamic — one abs-max pass, then an
        # int8 matmul with exact int32 accumulation; |dot| <= 3072*127^2 =
        # 49.5M << 2^31, and the int32 -> f32 cast error is <= 2^-24
        # relative).  Dequant = act_scale/127 x w_scale per (row,
        # out-channel).
        xf = x.astype(jnp.float32)
        xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-30)
        xq = jnp.clip(jnp.round(xf / xs * 127.0), -127, 127).astype(jnp.int8)
        y = jnp.dot(xq, k, preferred_element_type=jnp.int32)
        y = y.astype(jnp.float32) * (xs / 127.0) * p["kernel_scale"]
        y = y + p["bias"]
        return y.astype(out_dtype) if out_dtype is not None else y
    y = jnp.dot(
        x.astype(dtype), k.astype(dtype),
        precision=backend.matmul_precision(dtype),
        preferred_element_type=_acc_dtype(dtype),
    )
    y = y + p["bias"]
    return y if out_dtype is None else y.astype(out_dtype)


def _gelu(x: jax.Array, dtype) -> jax.Array:
    """HF 'gelu' is the exact erf form.  Under bfloat16 compute the tanh
    approximation's error (<~3e-3 absolute) is below bf16 rounding of the
    surrounding activations, so bf16 uses the cheaper tanh form; f32/f64
    keep erf for golden parity (tests/test_encoder.py)."""
    return jax.nn.gelu(x, approximate=jnp.dtype(dtype) == jnp.bfloat16)


def roberta_position_ids(input_ids: jax.Array, pad_token_id: int) -> jax.Array:
    """RoBERTa-style position ids: pads get ``pad_token_id``; real tokens get
    ``pad_token_id + running index`` (matches HF
    create_position_ids_from_input_ids, needed for ANCE weight parity)."""
    mask = (input_ids != pad_token_id).astype(jnp.int32)
    incremental = jnp.cumsum(mask, axis=-1) * mask
    return incremental + pad_token_id


def _dropout(x, rate, rng):
    """Inverted dropout; no-op when rng is None (inference/frozen towers).

    The mask bits come from XLA's RngBitGenerator (the ``rbg`` PRNG impl)
    with a uint16 threshold compare, NOT ``jax.random.bernoulli``:
    threefry computes one 32-bit counter-mode block per element, which is
    several times the work for the [B, H, L, L] attention-probs masks of
    every layer (regenerated under remat).  Deterministic per key on a
    fixed backend — dropout keys are derived per layer from the
    train-state threefry key; only the BULK bits use rbg.  Threshold
    quantization bias <= 1/65536 keep-rate."""
    if rng is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    data = (
        jax.random.key_data(rng)
        if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key)
        else rng
    )
    rbg = jax.random.wrap_key_data(
        jnp.concatenate([data, data]).astype(jnp.uint32), impl="rbg"
    )
    thresh = jnp.uint16(min(65535, int(round(keep * 65536))))
    bits = jax.random.bits(rbg, x.shape, jnp.uint16)
    return jnp.where(bits < thresh, x / keep, jnp.zeros((), x.dtype))


def dot_product_attention(
    qkv: jax.Array,  # [B, L, 3H]: the fused q|k|v projection
    attention_mask: jax.Array,  # [B, L], 1 = token, 0 = right padding
    num_heads: int,
    dtype,
    implementation: str,
) -> jax.Array:
    """Multi-head attention context [B, L, H] through
    ``jax.nn.dot_product_attention``.

    The head split is a free reshape of [B, L, 3H] to [B, L, 3, heads, d].
    ``implementation="cudnn"`` is cuDNN's fused attention (bf16/fp16
    only); it takes the padding as per-row key lengths, so the mask must
    be right padding, as every builder in data/ and index/ produces.
    ``"xla"`` takes the mask itself and runs f32 at HIGHEST."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    t = qkv.astype(dtype).reshape(B, L, 3, num_heads, H // num_heads)
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    if implementation == "cudnn":
        lengths = jnp.sum(attention_mask, axis=1).astype(jnp.int32)
        ctx = jax.nn.dot_product_attention(
            q, k, v, key_value_seq_lengths=lengths, implementation="cudnn"
        )
    else:
        mask = attention_mask.astype(bool)[:, None, None, :]
        highest = backend.matmul_precision(dtype) == jax.lax.Precision.HIGHEST
        with jax.default_matmul_precision("highest" if highest else None):
            ctx = jax.nn.dot_product_attention(
                q, k, v, mask=mask, implementation="xla"
            )
    return ctx.reshape(B, L, H)


def _attention(x, attention_mask, p, num_heads, dtype, attn_drop=0.0, rng=None):
    B, L, H = x.shape
    d = H // num_heads

    # fused QKV: one [H, 3H] matmul instead of three (the concat of the
    # stacked param slices is trivial next to the projection itself);
    # int8 kernels concat along the out axis with their per-out-channel
    # scales — per-channel semantics are preserved under concat
    qkv_p = {
        "kernel": jnp.concatenate(
            [p["query"]["kernel"], p["key"]["kernel"], p["value"]["kernel"]], axis=-1
        ),
        "bias": jnp.concatenate(
            [p["query"]["bias"], p["key"]["bias"], p["value"]["bias"]]
        ),
    }
    if "kernel_scale" in p["query"]:
        qkv_p["kernel_scale"] = jnp.concatenate(
            [
                p["query"]["kernel_scale"],
                p["key"]["kernel_scale"],
                p["value"]["kernel_scale"],
            ]
        )
    qkv = _dense(x, qkv_p, dtype, out_dtype=dtype)

    if rng is None or attn_drop <= 0.0:
        ctx = dot_product_attention(
            qkv, attention_mask, num_heads, dtype,
            backend.attention_impl(dtype),
        )
        return _dense(ctx, p["output"], dtype)

    # attention-probs dropout (the trained tower): the plain XLA form,
    # since no fused attention JAX exposes takes dropout
    def split_heads(t):
        return t.reshape(B, L, num_heads, d).transpose(0, 2, 1, 3)

    q = split_heads(qkv[..., :H])
    k = split_heads(qkv[..., H : 2 * H])
    v = split_heads(qkv[..., 2 * H :])
    acc = _acc_dtype(dtype)
    prec = backend.matmul_precision(dtype)
    mask_bias = (1.0 - attention_mask.astype(jnp.float32))[:, None, None, :] * -1e9
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q.astype(dtype), k.astype(dtype),
        precision=prec, preferred_element_type=acc,
    ) / math.sqrt(d)
    scores = scores + mask_bias  # [B, 1, 1, L] additive
    probs = jax.nn.softmax(scores, axis=-1)
    probs = _dropout(probs, attn_drop, rng)  # HF attention-probs dropout
    ctx = jnp.einsum(
        "bhqk,bhkd->bhqd", probs.astype(dtype), v.astype(dtype),
        precision=prec, preferred_element_type=acc,
    )
    ctx = ctx.transpose(0, 2, 1, 3).reshape(B, L, H)
    return _dense(ctx, p["output"], dtype)


def encoder_hidden_states(
    params: EncoderParams,
    cfg: ModelConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    dropout_rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Transformer stack -> last_hidden_state [B, L, H].

    ``dropout_rng`` enables training-mode dropout with the reference's HF
    placements (embeddings post-LN, attention probs, both residual
    branches); None = eval mode (the reference's frozen/no-grad towers)."""
    dtype = jnp.dtype(cfg.dtype)
    hd, ad = cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob
    layers = params["layers"]
    stacked = isinstance(layers, dict)
    n_layers = (
        jax.tree_util.tree_leaves(layers)[0].shape[0] if stacked else len(layers)
    )
    if dropout_rng is not None:
        all_keys = jax.random.split(dropout_rng, 1 + 3 * n_layers)
        emb_key = all_keys[0]
        layer_keys = all_keys[1:].reshape(n_layers, 3, -1)
    else:
        emb_key = None
        layer_keys = None

    emb = params["embeddings"]
    if cfg.model_type.upper().startswith("BERT"):
        position_ids = jnp.arange(input_ids.shape[1])[None, :]
    else:
        position_ids = roberta_position_ids(input_ids, cfg.pad_token_id)

    # the residual carry stays in the compute dtype (bf16 end-to-end when
    # dtype=bf16); LN internals run f32 regardless
    carry_dtype = jnp.promote_types(dtype, jnp.bfloat16)

    def _res_ln(x, branch_out, p):
        return _layer_norm(
            x + branch_out.astype(x.dtype), p, cfg.layer_norm_eps,
            out_dtype=carry_dtype,
        )

    x = (
        emb["word_embeddings"][input_ids]
        + emb["position_embeddings"][position_ids]
        + emb["token_type_embeddings"][jnp.zeros_like(input_ids)]
    )
    x = _layer_norm(x, emb["layer_norm"], cfg.layer_norm_eps, out_dtype=carry_dtype)
    x = _dropout(x, hd, emb_key)

    def mlp_fn(x, layer, rng_c):
        inter = _gelu(_dense(x, layer["intermediate"], dtype, out_dtype=dtype), dtype)
        out = _dropout(_dense(inter, layer["output"], dtype), hd, rng_c)
        return _res_ln(x, out, layer["output_layer_norm"])

    if cfg.remat == "mlp":
        # MLP-only remat: drops the [B, L, 4H] MLP intermediates and
        # re-runs only two dense matmuls in the backward, instead of the
        # whole layer forward
        mlp_fn = jax.checkpoint(mlp_fn)

    def layer_fn(x, layer, rng_a, rng_b, rng_c):
        attn_out = _attention(
            x, attention_mask, layer["attention"], cfg.num_attention_heads,
            dtype, attn_drop=ad, rng=rng_a,
        )
        attn_out = _dropout(attn_out, hd, rng_b)
        x = _res_ln(x, attn_out, layer["attention"]["output_layer_norm"])
        return mlp_fn(x, layer, rng_c)

    if cfg.remat and cfg.remat != "mlp":
        layer_fn = jax.checkpoint(layer_fn)

    if stacked:
        # stacked layout ([num_layers, ...] leaves): one lax.scan instance
        # instead of num_layers unrolled copies — compiles ~12x smaller
        # programs for base-size training (see stack_layer_params)
        if layer_keys is not None:

            def body(x, xs):
                layer, lk = xs
                return layer_fn(x, layer, lk[0], lk[1], lk[2]), None

            x, _ = jax.lax.scan(body, x, (layers, layer_keys))
        else:

            def body(x, layer):
                return layer_fn(x, layer, None, None, None), None

            x, _ = jax.lax.scan(body, x, layers)
        return x

    for li, layer in enumerate(layers):
        if layer_keys is not None:
            x = layer_fn(
                x, layer, layer_keys[li, 0], layer_keys[li, 1], layer_keys[li, 2]
            )
        else:
            x = layer_fn(x, layer, None, None, None)
    return x


def encode(
    params: EncoderParams,
    cfg: ModelConfig,
    input_ids: jax.Array,
    attention_mask: jax.Array,
    use_mean: bool = False,
    dropout_rng: Optional[jax.Array] = None,
) -> jax.Array:
    """Full ANCE embedding: encoder -> pooling -> embeddingHead -> LayerNorm.

    Mirrors ANCE.query_emb (src/models.py:39-45): pooling is first-token
    (CLS) by default, masked mean when ``use_mean`` (src/models.py:52-61);
    ``doc_emb`` is identical (src/models.py:48-49).  ``dropout_rng``
    activates training-mode dropout (the reference trains the query tower
    in torch train mode, src/train_HAConvDR_topiocqa.py:125).
    Returns [B, embedding_dim] float32.
    """
    hidden = encoder_hidden_states(
        params, cfg, input_ids, attention_mask, dropout_rng=dropout_rng,
    )
    if use_mean:
        m = attention_mask.astype(jnp.float32)[:, :, None]
        pooled = jnp.sum(hidden * m, axis=1) / jnp.sum(m, axis=1)
    else:
        pooled = hidden[:, 0]
    proj = _dense(pooled, params["embedding_head"], jnp.dtype(cfg.dtype))
    return _layer_norm(proj, params["norm"], 1e-5)


def quantize_encoder_params(params: EncoderParams) -> EncoderParams:
    """int8-quantize the transformer layers' dense kernels (per-output-
    channel symmetric): each dense dict gains ``kernel_scale`` [..., out]
    and its ``kernel`` becomes int8.  ``_dense`` detects the int8 leaf and
    runs an int8 x int8 matmul with dynamic per-token activation
    quantization on the six dense matmuls per layer (~90% of encoder
    FLOPs at L=512).

    Embeddings, LayerNorms, and the embedding head stay float32: they are
    cheap and quality-sensitive (the head feeds the retrieval embedding
    directly).  Intended for gradient-free towers only — the frozen
    passage towers in training (TrainConfig.frozen_dtype='int8') and
    corpus encoding; quantized params are derived artifacts, never
    checkpointed.  Works on both the list-of-layers and the stacked
    ([num_layers, in, out]) layouts (reduction axis is -2 either way).
    """

    def quant_tree(t):
        if isinstance(t, dict):
            if "kernel" in t and getattr(t["kernel"], "ndim", 0) >= 2:
                k = jnp.asarray(t["kernel"], jnp.float32)
                scale = jnp.maximum(
                    jnp.max(jnp.abs(k), axis=-2, keepdims=True), 1e-30
                )
                kq = jnp.clip(jnp.round(k / scale * 127.0), -127, 127).astype(
                    jnp.int8
                )
                return {
                    **t,
                    "kernel": kq,
                    "kernel_scale": (scale / 127.0).reshape(
                        scale.shape[:-2] + scale.shape[-1:]
                    ),
                }
            return {kk: quant_tree(v) for kk, v in t.items()}
        if isinstance(t, list):
            return [quant_tree(v) for v in t]
        return t

    return {**params, "layers": quant_tree(params["layers"])}


def stack_layer_params(params: EncoderParams) -> EncoderParams:
    """list-of-layer-dicts -> one dict with [num_layers, ...] leaves.

    The stacked layout drives the lax.scan path of encoder_hidden_states:
    the compiled program contains ONE layer instance instead of
    ``num_layers`` unrolled copies, which keeps base-size training programs
    small enough to compile quickly.  Checkpoint interop
    (models/hf_import.py) uses the list layout; convert at load time.
    """
    layers = params["layers"]
    if isinstance(layers, dict):
        return params
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *layers)
    return {**params, "layers": stacked}


def unstack_layer_params(params: EncoderParams) -> EncoderParams:
    """Inverse of stack_layer_params (for HF export)."""
    layers = params["layers"]
    if not isinstance(layers, dict):
        return params
    n = jax.tree_util.tree_leaves(layers)[0].shape[0]
    unstacked = [
        jax.tree_util.tree_map(lambda a, i=i: a[i], layers) for i in range(n)
    ]
    return {**params, "layers": unstacked}


class AnceEncoder:
    """Thin object wrapper bundling (params, config) with jitted methods.

    The compute path stays functional; this class only provides ergonomic
    ``query_emb`` / ``doc_emb`` entry points equivalent to the reference
    module API (src/models.py:39-64).
    """

    def __init__(self, params: EncoderParams, cfg: ModelConfig):
        self.params = params
        self.cfg = cfg
        self._encode = jax.jit(
            lambda p, ids, mask: encode(p, cfg, ids, mask), donate_argnums=()
        )

    def query_emb(self, input_ids, attention_mask) -> np.ndarray:
        return np.asarray(self._encode(self.params, jnp.asarray(input_ids), jnp.asarray(attention_mask)))

    # shared tower: doc_emb == query_emb (src/models.py:48-49)
    doc_emb = query_emb

    def __call__(self, input_ids, attention_mask):
        return self.query_emb(input_ids, attention_mask)
