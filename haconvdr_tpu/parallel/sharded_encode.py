"""Mesh-sharded encoder execution: data-parallel batches, optional tensor
parallelism.

Replaces torch ``DataParallel`` replication (src/train_HAConvDR_topiocqa.py:89-90,
gen_doc_embeddings.py:194-195) and the rank-mod StreamingDataset sharding
(src/utils.py:126-147) with GSPMD: the batch dimension is sharded over the
``dp`` mesh axis and, when ``tp > 1``, encoder weight matrices are sharded
Megatron-style over ``tp`` (attention heads / FFN hidden dim) — XLA inserts
the all-reduces.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.models.encoder import EncoderParams, encode


def encoder_param_pspecs(params: EncoderParams) -> EncoderParams:
    """PartitionSpec tree for tensor-parallel sharding of the encoder.

    Megatron layout: qkv and FFN-up kernels column-sharded on 'tp',
    attention-output and FFN-down kernels row-sharded; everything else
    (embeddings, LayerNorms, biases of row-sharded layers) replicated.
    """

    stacked = isinstance(params["layers"], dict)
    sample = params["layers"] if stacked else params["layers"][0]
    quantized = "kernel_scale" in sample["attention"]["query"]

    def layer_spec(_layer=None) -> Dict[str, Any]:
        # stacked layout carries a leading num_layers axis on every leaf
        if stacked:
            col = {"kernel": P(None, None, "tp"), "bias": P(None, "tp")}
            row = {"kernel": P(None, "tp", None), "bias": P(None)}
            ln = {"scale": P(None), "bias": P(None)}
        else:
            col = {"kernel": P(None, "tp"), "bias": P("tp")}
            row = {"kernel": P("tp", None), "bias": P()}
            ln = {"scale": P(), "bias": P()}
        if quantized:
            # int8 kernels (quantize_encoder_params): the per-out-channel
            # kernel_scale follows the OUT axis — tp-sharded for
            # column-parallel kernels, replicated for row-parallel ones
            col = {**col, "kernel_scale": P(None, "tp") if stacked else P("tp")}
            row = {**row, "kernel_scale": P(None) if stacked else P()}
        return {
            "attention": {
                "query": dict(col),
                "key": dict(col),
                "value": dict(col),
                "output": dict(row),
                "output_layer_norm": dict(ln),
            },
            "intermediate": dict(col),
            "output": dict(row),
            "output_layer_norm": dict(ln),
        }

    return {
        "embeddings": {
            "word_embeddings": P(),
            "position_embeddings": P(),
            "token_type_embeddings": P(),
            "layer_norm": {"scale": P(), "bias": P()},
        },
        "layers": layer_spec() if stacked else [layer_spec(l) for l in params["layers"]],
        "embedding_head": {"kernel": P(), "bias": P()},
        "norm": {"scale": P(), "bias": P()},
    }


def shard_params(mesh: Mesh, params: EncoderParams, tp: bool = False) -> EncoderParams:
    if tp:
        specs = encoder_param_pspecs(params)
    else:
        specs = jax.tree_util.tree_map(lambda _: P(), params)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        params,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def make_sharded_encode_fn(
    mesh: Mesh, cfg: ModelConfig, tp: bool = False
) -> Callable[[EncoderParams, jax.Array, jax.Array], jax.Array]:
    """jit-compiled encode with batch sharded over 'dp' and output sharded
    the same way; params replicated or tp-sharded."""
    data_sharding = NamedSharding(mesh, P("dp", None))

    @jax.jit
    def fn(params, input_ids, attention_mask):
        input_ids = jax.lax.with_sharding_constraint(input_ids, data_sharding)
        attention_mask = jax.lax.with_sharding_constraint(attention_mask, data_sharding)
        out = encode(params, cfg, input_ids, attention_mask)
        return jax.lax.with_sharding_constraint(out, data_sharding)

    return fn


def encode_batches(
    encode_fn,
    params: EncoderParams,
    batches,
    mesh: Mesh,
    key_ids: str,
    key_mask: str,
) -> (np.ndarray, list):
    """Stream batches through the sharded encoder, dropping padded rows.

    Equivalent of the reference's no-grad inference loops
    (src/test_HAConvDR_topiocqa.py:188-216, gen_doc_embeddings.py:92-121)
    with static shapes: each batch dict carries a ``valid`` mask from
    data.loader.collate.
    """
    embs, ids = [], []
    for batch in batches:
        e = np.asarray(
            encode_fn(
                params,
                jnp.asarray(batch[key_ids]),
                jnp.asarray(batch[key_mask]),
            )
        )
        valid = np.asarray(batch["valid"]).astype(bool)
        embs.append(e[valid])
        ids.extend([s for s, v in zip(batch["sample_id"], valid) if v])
    return np.concatenate(embs, axis=0), ids
