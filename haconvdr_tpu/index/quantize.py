"""Symmetric int8 scalar quantization for embedding indexes.

A beyond-the-reference memory lever: the reference serves flat f32 blocks
(7.3 GB per 2.5M x 768 block, src/test_HAConvDR_topiocqa.py:82-95) and its
54M-passage QReCC corpus is 167 GB f32 / 83 GB bf16 — this module stores
the index as int8 + per-dimension float32 scales (42 GB at 54M).

Scheme: per-dimension symmetric (faiss ``ScalarQuantizer QT_8bit``-style,
but zero-offset so the scale FOLDS INTO THE QUERY):

    x_int8[d] = round(x[d] / scale[d]),   scale[d] = max|x[:, d]| / 127
    score(q, x) = sum_d q[d] * (x_int8[d] * scale[d])
                = sum_d (q[d] * scale[d]) * x_int8[d]

Search folds ``q' = q * scale`` once per (query batch, scale group), then
quantises each folded query to symmetric int8 (ops/topk.quantize_queries)
and scores int8 x int8 in int32: every score is an exact integer
(768 * 127^2 < 2^24, so also exact in f32) times the query's scale / 127.
Query-side rounding is ~1/254 relative, below the index's own int8 error.
The win is memory *capacity* and host-to-device *bandwidth*, both halved
vs bf16.

Scales may be grouped per shard / per block (each group quantized with its
own [D] scale): folding happens inside the shard_map / per-block dispatch,
which keeps cross-group score comparisons consistent: every score is the
exact integer product of that group's codes, scaled back to the
dequantized rows' units.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_int8(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] float -> ([N, D] int8, [D] float32 per-dim scales).

    Symmetric, zero-offset; all-zero dimensions get scale 1 (their rows
    quantize to 0 and contribute 0 to every score, exactly like the
    float path).
    """
    emb = np.asarray(emb, np.float32)
    amax = np.abs(emb).max(axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(emb / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Exact float32 reconstruction the int8 search path scores against."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)


# device-side (jax) pieces of the same scheme, shared by the IVF
# quantizer so the formula lives in exactly one place
def scale_from_amax(amax):
    import jax.numpy as jnp

    return jnp.where(amax > 0, amax / 127.0, 1.0)


def encode_int8(x, scale):
    import jax.numpy as jnp

    return jnp.clip(
        jnp.round(x.astype(jnp.float32) / scale), -127, 127
    ).astype(jnp.int8)
