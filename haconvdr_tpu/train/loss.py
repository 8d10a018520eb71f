"""Contrastive ranking losses.

JAX re-derivation of the reference losses:
  * :func:`ranking_loss`      — cal_ranking_loss
    (src/train_HAConvDR_topiocqa.py:47-58): CE over
    [in-batch positives | optional 1 hard negative], labels = arange(B);
  * :func:`ranking_loss_prepos` — cal_ranking_loss_prepos (":60-75"):
    pos score matrix optionally ADDED to alpha x pseudo-prepos score matrix
    (not concatenated!), then 1 bm25-hard-neg column, then 1 prepos-neg
    column;
  * :func:`kd_loss`           — cal_kd_loss MSE (":77-79", unused by the
    reference training loop but part of its API surface).

Divergence from the reference (documented): the reference only includes
pseudo/prepos terms when the whole batch has them (and crashes on ragged
batches, src/data.py:333).  Here per-example presence masks gate the terms:
absent pseudo columns contribute no alpha-term, absent prepos-neg entries
score -inf (excluded from the softmax), and rows padded by the static-shape
loader are masked out of the mean.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from haconvdr_tpu.ops import backend

_NEG = -1e9


def _ce_rows(score_mat: jax.Array, valid_rows: jax.Array) -> jax.Array:
    """Cross-entropy with labels=arange(B), averaged over valid rows."""
    B = score_mat.shape[0]
    logprobs = jax.nn.log_softmax(score_mat, axis=1)
    picked = logprobs[jnp.arange(B), jnp.arange(B)]
    v = valid_rows.astype(jnp.float32)
    return -(picked * v).sum() / jnp.maximum(v.sum(), 1.0)


def _mask_invalid_columns(pos_scores: jax.Array, valid: jax.Array) -> jax.Array:
    """Padded examples must not act as in-batch negatives: kill their
    columns (keep the diagonal so padded rows stay finite pre-masking)."""
    B = pos_scores.shape[0]
    col_ok = valid.astype(bool)[None, :]
    eye = jnp.eye(B, dtype=bool)
    return jnp.where(col_ok | eye, pos_scores, _NEG)


def _scores(a: jax.Array, b: jax.Array) -> jax.Array:
    """[B, B] inner products at the dtype's precision (f32: HIGHEST)."""
    return jnp.matmul(a, b.T, precision=backend.matmul_precision(a.dtype))


def ranking_loss(
    query_embs: jax.Array,  # [B, D]
    pos_doc_embs: jax.Array,  # [B, D]
    neg_doc_embs: Optional[jax.Array] = None,  # [B, D] or [B, R, D]
    valid: Optional[jax.Array] = None,  # [B]
    neg_valid: Optional[jax.Array] = None,  # [B, R] 0/1 (multineg padding)
) -> jax.Array:
    B = query_embs.shape[0]
    valid = jnp.ones((B,), jnp.int32) if valid is None else valid
    pos_scores = _scores(query_embs, pos_doc_embs)  # [B, B]
    score_mat = _mask_invalid_columns(pos_scores, valid)
    if neg_doc_embs is not None:
        if neg_doc_embs.ndim == 3:  # R negatives per example (Retrieval_qrecc_negs)
            neg_scores = jnp.einsum(
                "bd,brd->br", query_embs, neg_doc_embs,
                precision=backend.matmul_precision(query_embs.dtype),
            )
            if neg_valid is not None:
                # rows clamped/padded to a static R: padded slots leave the
                # softmax entirely
                neg_scores = jnp.where(neg_valid.astype(bool), neg_scores, _NEG)
        else:  # single hard negative (":51")
            neg_scores = jnp.sum(query_embs * neg_doc_embs, axis=1)[:, None]
        score_mat = jnp.concatenate([score_mat, neg_scores], axis=1)
    return _ce_rows(score_mat, valid)


def ranking_loss_prepos(
    query_embs: jax.Array,  # [B, D]
    pos_doc_embs: jax.Array,  # [B, D]
    bm25_neg_doc_embs: jax.Array,  # [B, D]
    pseudo_prepos_embs: Optional[jax.Array] = None,  # [B, D]
    prepos_neg_doc_embs: Optional[jax.Array] = None,  # [B, D]
    has_pseudo: Optional[jax.Array] = None,  # [B] 0/1
    has_prepos_neg: Optional[jax.Array] = None,  # [B] 0/1
    alpha: float = 1.0,
    is_pseudo_prepos: bool = True,
    is_prepos_neg: bool = True,
    valid: Optional[jax.Array] = None,  # [B]
) -> jax.Array:
    B = query_embs.shape[0]
    valid = jnp.ones((B,), jnp.int32) if valid is None else valid
    pos_scores = _scores(query_embs, pos_doc_embs)  # [B, B]
    score_mat = pos_scores
    if is_pseudo_prepos and pseudo_prepos_embs is not None:
        pseudo_scores = _scores(query_embs, pseudo_prepos_embs)  # [B, B] (":65-66")
        if has_pseudo is not None:
            pseudo_scores = pseudo_scores * has_pseudo.astype(jnp.float32)[None, :]
        score_mat = pos_scores + alpha * pseudo_scores
    score_mat = _mask_invalid_columns(score_mat, valid)
    bm25_scores = jnp.sum(query_embs * bm25_neg_doc_embs, axis=1)[:, None]  # (":67")
    score_mat = jnp.concatenate([score_mat, bm25_scores], axis=1)
    if is_prepos_neg and prepos_neg_doc_embs is not None:
        pn = jnp.sum(query_embs * prepos_neg_doc_embs, axis=1)[:, None]  # (":69-71")
        if has_prepos_neg is not None:
            pn = jnp.where(has_prepos_neg.astype(bool)[:, None], pn, _NEG)
        score_mat = jnp.concatenate([score_mat, pn], axis=1)
    return _ce_rows(score_mat, valid)


def kd_loss(query_embs: jax.Array, kd_embs: jax.Array) -> jax.Array:
    return jnp.mean(jnp.square(query_embs - kd_embs))
