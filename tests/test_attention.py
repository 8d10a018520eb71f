"""models/encoder.py attention and int8 dense against plain references.

The attention wrapper (``dot_product_attention``, XLA implementation here;
cuDNN takes the same call on the card) must equal the einsum form the
encoder used before: QK^T / sqrt(d) + padding bias -> softmax -> PV.
Tolerances: f32 at HIGHEST differs only in summation order (atol 1e-5 on
O(1) contexts); bf16 rounds q, k, v and the probabilities to 8 bits
(atol 2e-2)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.models import encoder


def _einsum_attention(qkv, mask, num_heads):
    """Reference: the plain einsum attention, f32 at HIGHEST."""
    qkv = jnp.asarray(qkv, jnp.float32)
    B, L, H3 = qkv.shape
    H = H3 // 3
    d = H // num_heads

    def heads(t):
        return t.reshape(B, L, num_heads, d).transpose(0, 2, 1, 3)

    q, k, v = heads(qkv[..., :H]), heads(qkv[..., H:2 * H]), heads(qkv[..., 2 * H:])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision="highest") / math.sqrt(d)
    s = s + (1.0 - mask.astype(jnp.float32))[:, None, None, :] * -1e9
    p = jax.nn.softmax(s, axis=-1)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", p, v, precision="highest")
    return ctx.transpose(0, 2, 1, 3).reshape(B, L, H)


def _mask(rng, B, L, padded):
    if not padded:
        return np.ones((B, L), np.int32)
    lens = rng.randint(1, L + 1, B)
    lens[0] = L
    return (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("L", [128, 384, 512])
@pytest.mark.parametrize("padded", [False, True])
def test_attention_wrapper_matches_einsum(rng, dtype, atol, L, padded):
    B, heads, d = 2, 4, 16
    qkv = rng.randn(B, L, 3 * heads * d).astype(np.float32)
    mask = _mask(rng, B, L, padded)
    got = encoder.dot_product_attention(
        jnp.asarray(qkv, dtype), jnp.asarray(mask), heads, jnp.dtype(dtype), "xla"
    )
    ref = _einsum_attention(jnp.asarray(qkv, dtype), jnp.asarray(mask), heads)
    assert got.shape == (B, L, heads * d) and got.dtype == jnp.dtype(dtype)
    valid = mask.astype(bool)  # outputs at padded query rows are unused
    np.testing.assert_allclose(
        np.asarray(got, np.float32)[valid], np.asarray(ref)[valid], atol=atol
    )


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("float64", 1e-6)])
def test_trained_tower_gradients_match_einsum(rng, dtype, atol):
    """Gradients through the wrapper equal gradients through the einsum
    reference (a trained tower without attention dropout takes the
    wrapper).  float64 keeps f32-level agreement: the library runs the
    softmax in f32."""
    B, L, heads, d = 2, 128, 4, 8
    qkv = jnp.asarray(rng.randn(B, L, 3 * heads * d), dtype)
    mask = jnp.asarray(_mask(rng, B, L, True))
    w = jnp.asarray(rng.randn(B, L, heads * d), dtype) * mask[:, :, None]

    def loss(f):
        return lambda x: jnp.sum(f(x) * w)

    g = jax.grad(loss(lambda x: encoder.dot_product_attention(x, mask, heads, jnp.dtype(dtype), "xla")))(qkv)
    g_ref = jax.grad(loss(lambda x: _einsum_attention(x, mask, heads).astype(dtype)))(qkv)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=atol)


def test_encoder_dropout_path_trains(rng):
    """With attention-probs dropout the encoder takes the einsum form
    with _dropout: gradients exist and are finite, and the dropout key
    changes the output."""
    cfg = ModelConfig.tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    params = encoder.init_encoder_params(jax.random.PRNGKey(0), cfg)
    ids = jnp.asarray(rng.randint(4, cfg.vocab_size, (2, 16)))
    mask = jnp.ones((2, 16), jnp.int32)

    def f(p, key):
        return jnp.sum(encoder.encode(p, cfg, ids, mask, dropout_rng=key) ** 2)

    g = jax.grad(f)(params, jax.random.PRNGKey(1))
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert f(params, jax.random.PRNGKey(1)) != f(params, jax.random.PRNGKey(2))


@pytest.mark.parametrize("shape", [(5, 32, 48), (2, 7, 32, 64)])
def test_int8_dense_matches_dequantized_reference(rng, shape):
    """_dense on int8 kernels: per-token activation codes times
    per-channel weight codes, summed exactly, scaled back — equal to the
    same arithmetic in float64 up to the f32 rescale (rtol 1e-5)."""
    *lead, din, dout = shape
    x = rng.randn(*lead, din).astype(np.float32)
    p = {"kernel": rng.randn(din, dout).astype(np.float32) * 0.05,
         "bias": rng.randn(dout).astype(np.float32)}
    q = encoder.quantize_encoder_params({"layers": [{"d": p}]})["layers"][0]["d"]
    assert q["kernel"].dtype == jnp.int8
    got = np.asarray(encoder._dense(jnp.asarray(x), q, jnp.float32))
    xs = np.maximum(np.abs(x).max(axis=-1, keepdims=True), 1e-30)
    xq = np.clip(np.round(x / xs * 127.0), -127, 127)
    ints = xq.astype(np.float64) @ np.asarray(q["kernel"], np.float64)
    ref = ints * (xs / 127.0) * np.asarray(q["kernel_scale"], np.float64) + p["bias"]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # and close to the float dense (quantisation error only)
    np.testing.assert_allclose(got, x @ p["kernel"] + p["bias"], atol=0.05)
