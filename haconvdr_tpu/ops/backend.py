"""The one place that picks an implementation for the platform JAX runs on.

Every choice between a hand-written kernel and the plain XLA path, and the
matmul precision of each dtype, is made here from ``jax.default_backend()``
and the operand dtype.  A backend this module does not know is an error,
never a silent default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

KNOWN_PLATFORMS = ("cpu", "gpu")

# the fused search kernel's selection assumes at most this many results
# per query (its flagged-window rate grows with k**2)
FUSED_MAX_K = 128


def platform() -> str:
    p = jax.default_backend()
    if p not in KNOWN_PLATFORMS:
        raise RuntimeError(
            f"no implementation is chosen for JAX backend {p!r}; "
            f"known: {KNOWN_PLATFORMS}"
        )
    return p


def matmul_precision(dtype) -> jax.lax.Precision:
    """float32 means float32: f32 operands multiply at HIGHEST (true fp32;
    the GPU's default for f32 is TF32, PERF.md), which is what faiss's
    fp32 SGEMM did.  Narrower dtypes are the fast modes and keep the
    default (bf16 products summed in f32)."""
    if jnp.dtype(dtype) in (jnp.float32, jnp.float64):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


# index dtypes for which the fused kernel beat the plain path on the card
# (PERF.md, Findings); f32 is not one: Triton's fp32 product runs without
# tensor cores, far behind cuBLAS's SGEMM
FUSED_SEARCH_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.int8))


def search_impl(dtype, k: int, dim: int) -> str:
    """"fused" (ops/triton_topk.py, the score tile stays on chip) or "xla"
    (ops/topk.topk_block, score tiles through device memory)."""
    if platform() != "gpu":
        return "xla"
    if k > FUSED_MAX_K or dim % 16:
        return "xla"
    return "fused" if jnp.dtype(dtype) in FUSED_SEARCH_DTYPES else "xla"


def attention_impl(dtype) -> str:
    """``jax.nn.dot_product_attention`` implementation: cuDNN's fused
    attention for bf16/fp16 towers on the GPU (it takes no f32), XLA's
    otherwise."""
    if platform() == "gpu" and jnp.dtype(dtype) in (jnp.bfloat16, jnp.float16):
        return "cudnn"
    return "xla"
