"""CLI: IVF recall validation on REAL ENCODER geometry (no external data).

The standing gap (NOTES.md): the IVF serving index's recall
was only ever measured on synthetic Gaussian mixtures, whose geometry is
far friendlier to k-means than actual transformer-encoder output
manifolds (anisotropic, low effective rank, cone-shaped — the known hard
case for inner-product clustering).  Real dataset dumps and the
`ad-hoc-ance-msmarco` checkpoint are unavailable in this environment, so
this harness produces the closest locally-constructible proxy:

  1. generate TOPIC-STRUCTURED synthetic token streams on device
     (each passage blends token bands of 1-2 of `n_topics` topics;
     queries are short single-topic strings) — content structure, not
     embedding-space structure;
  2. contrastively train the real ANCE-architecture encoder
     (models/encoder.py, the same tower the framework trains) for a few
     hundred in-batch CE steps (+ an auxiliary topic-classification
     head that makes random-init training escapable — see
     train_encoder), exactly long enough that embeddings carry the
     topic manifold the way a retrieval encoder's do;
  3. embed a corpus (default 1M passages) with the trained tower;
  4. run the standard IVF tuning sweep (cli/ivf_sweep.sweep) on those
     embeddings: recall@k vs the exact fused scan, per-query latency,
     memory overhead, scanned fraction.

Outputs one JSON line per (nlist, slack, nprobe) configuration, plus a
`geometry` preamble row (effective rank, mean cosine to centroid) that
lets the numbers be compared against real-checkpoint embeddings the
moment those exist.

    python -m haconvdr_tpu.cli.ivf_geometry_check \
        n=1000000 steps=300 n_topics=2000 nlist=1024,4096 \
        nprobe=8,16,32,64,128 out=geometry_sweep.jsonl

steps=0 skips training (untrained-encoder geometry: a harder, more
degenerate cone).  Reference scope: this validates the beyond-reference
IVF serving path only; the reference itself is exact-scan-only
(/root/reference/src/test_HAConvDR_topiocqa.py:74-162).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


def _parse_args(argv: List[str]) -> Dict[str, str]:
    out = {}
    for a in argv:
        k, eq, v = a.partition("=")
        if not eq:
            raise SystemExit(f"expected key=value, got {a!r}")
        out[k] = v
    return out


def make_topic_batch(key, batch, length, n_topics, vocab, topics=None):
    """Token ids whose content blends 1-2 topic bands (device-side).

    Each topic owns a contiguous band of ~``vocab // 64`` token ids; a
    passage draws each token from its primary topic's band with p=0.7,
    a secondary topic's with p=0.2, and the global vocab with p=0.1.
    """
    import jax
    import jax.numpy as jnp

    kt, ks, kp, kg, kc = jax.random.split(key, 5)
    band = max(64, vocab // 64)
    if topics is None:
        topics = jax.random.randint(kt, (batch,), 0, n_topics)
    second = jax.random.randint(ks, (batch,), 0, n_topics)
    centers = (topics.astype(jnp.float32) / n_topics * (vocab - band - 4)).astype(jnp.int32) + 4
    centers2 = (second.astype(jnp.float32) / n_topics * (vocab - band - 4)).astype(jnp.int32) + 4
    off = jax.random.randint(kp, (batch, length), 0, band)
    gtok = jax.random.randint(kg, (batch, length), 4, vocab)
    mix = jax.random.uniform(kc, (batch, length))
    ids = jnp.where(
        mix < 0.7,
        centers[:, None] + off,
        jnp.where(mix < 0.9, centers2[:, None] + off, gtok),
    )
    return jnp.clip(ids, 4, vocab - 1), topics


def train_encoder(key, cfg, steps, batch, q_len, p_len, n_topics, lr=1e-4,
                  wd=0.0, warmup=100):
    """A few hundred in-batch CE steps: query tower == passage tower
    (the ANCE convention, src/models.py:48-49), bf16 compute, no dropout
    (geometry only — this is not a quality training run).

    Scores are temperature-scaled by 1/sqrt(d): raw 768-dim dot products
    from random init start at O(30) logit scale, and adamw's weight
    decay then finds the degenerate all-scores-equal point (loss pinned
    at ln(batch)) before any topic structure forms — observed at lr=1e-4
    unscaled.  The scaling only stabilises training; the saved
    embeddings remain raw unnormalised dot-product vectors, which is
    what the IVF index scores."""
    import jax
    import jax.numpy as jnp
    import optax

    from haconvdr_tpu.models.encoder import (
        encode,
        init_encoder_params,
        stack_layer_params,
    )

    enc_params = stack_layer_params(init_encoder_params(key, cfg))
    # From random init (no pretrained weights exist in this image) pure
    # in-batch CE is unescapable: transformer outputs are near
    # input-independent at init, and EXACT collapse (constant output) is
    # a ZERO-GRADIENT stationary point of the contrastive loss — for
    # query i the gradient is mean_j(p_j) - p_i == 0 when all p_j are
    # equal.  Measured: 12L/4L, f32/bf16, lr 1e-4..1e-3 all pin at
    # ln(batch) within 25 steps and never move.  The fix is an auxiliary
    # TOPIC-CLASSIFICATION head (a constant output cannot separate
    # n_topics classes, so collapse is never stationary for the
    # combined loss); the head is dropped after training and the saved
    # embeddings are the raw encoder outputs the IVF index scores.
    kc = jax.random.fold_in(key, 17)
    w_cls = (
        jax.random.normal(kc, (cfg.embedding_dim, n_topics), jnp.float32)
        * 0.02
    )
    params = {"enc": enc_params, "w_cls": w_cls}
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, max(warmup, 1)),
         optax.constant_schedule(lr)],
        [max(warmup, 1)],
    )
    opt = optax.adamw(sched, weight_decay=wd)
    opt_state = opt.init(params)
    inv_temp = 1.0 / float(np.sqrt(cfg.embedding_dim))
    xent = optax.softmax_cross_entropy_with_integer_labels

    def loss_fn(params, qids, qmask, pids, pmask, topics, w_contrast):
        # Masked-mean pooling (the reference's own ANCE option,
        # src/models.py:52-61): at RANDOM init a linear probe on
        # mean-pooled 12L features hits 0.99 held-out topic accuracy vs
        # 0.06 for CLS pooling (.probe_geom_sep.py) — CLS's signal at 12
        # random layers is linearly inaccessible, so CLS-pooled training
        # never gets traction (measured: loss pinned at chance for both
        # the contrastive and the cls objective, all lrs).
        q = encode(params["enc"], cfg, qids, qmask, use_mean=True)
        p = encode(params["enc"], cfg, pids, pmask, use_mean=True)
        # Batch-center before BOTH losses: at init only ~0.3% of the
        # embedding variance is input-dependent (LN shells make the
        # common mode unit-scale), and the first few Adam steps perturb
        # the common mode by more than that — the signal drowns and
        # emb-std collapses 0.073 -> 0.001 within 3 steps (measured,
        # .probe_geom_diag.py).  Centering removes the common mode from
        # the gradient entirely; with it the input-dependent spread GROWS
        # (0.073 -> 0.45 in 40 steps) and both losses descend.  The saved
        # embeddings remain raw (uncentered) encoder outputs.
        q = q - q.mean(axis=0, keepdims=True)
        p = p - p.mean(axis=0, keepdims=True)
        scores = (q @ p.T) * inv_temp  # in-batch CE: diagonal positive
        labels = jnp.arange(q.shape[0])
        contrastive = xent(scores, labels).mean()
        w = params["w_cls"].astype(q.dtype)
        cls = 0.5 * (xent(q @ w, topics) + xent(p @ w, topics)).mean()
        return w_contrast * contrastive + cls, contrastive

    @jax.jit
    def step(params, opt_state, key, w_contrast):
        kq, kp = jax.random.split(key)
        pids, topics = make_topic_batch(kp, batch, p_len, n_topics, cfg.vocab_size)
        qids, _ = make_topic_batch(
            kq, batch, q_len, n_topics, cfg.vocab_size, topics=topics
        )
        ones_q = jnp.ones((batch, q_len), jnp.int32)
        ones_p = jnp.ones((batch, p_len), jnp.int32)
        (loss, contrastive), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params, qids, ones_q, pids, ones_p, topics, w_contrast)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, (loss, contrastive)

    # Stage 1 (first half): classification ONLY — builds topic structure
    # from random init, which pure contrastive cannot (collapse is its
    # zero-gradient attractor and it drags joint training back in,
    # measured: joint-from-scratch pins contrastive at ln(batch) while
    # cls sits at chance).  Stage 2: joint — contrastive now starts from
    # topic-clustered features, where its diagonal signal exists.
    losses = []
    stage1 = steps // 2
    for s in range(steps):
        w_contrast = jnp.float32(0.0 if s < stage1 else 1.0)
        params, opt_state, (loss, contrastive) = step(
            params, opt_state, jax.random.PRNGKey(1000 + s), w_contrast
        )
        if s % 25 == 0 or s == steps - 1:
            losses.append(float(contrastive))
            logger.info(
                "train step %d loss %.4f (contrastive %.4f)",
                s, float(loss), float(contrastive),
            )
    return params["enc"], losses


def embed_corpus(params, cfg, n, length, n_topics, batch=512, q_len=0,
                 batches_per_dispatch=64):
    """Encode ``n`` topic-structured passages (or queries when q_len>0)
    with the trained tower; returns float32 [n, 768] on host.

    Chunked into ``batches_per_dispatch``-batch scans with a host sync
    per chunk (one 1,954-iteration single-jit scan held the chip for
    ~10 min unsynced and tripped a worker restart; chunking keeps each
    dispatch ~15 s and lets a fault lose one chunk, not the run)."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.models.encoder import encode

    L = q_len or length
    n_batches = -(-n // batch)
    n_chunks = -(-n_batches // batches_per_dispatch)

    @jax.jit
    def run_chunk(params, keys):
        def body(c, k):
            ids, _ = make_topic_batch(k, batch, L, n_topics, cfg.vocab_size)
            e = encode(params, cfg, ids, jnp.ones((batch, L), jnp.int32),
                       use_mean=True)
            return c, e.astype(jnp.bfloat16)

        _, embs = jax.lax.scan(body, jnp.int32(0), keys)
        return embs.reshape(keys.shape[0] * batch, -1)

    seed = 7 if q_len else 3
    keys = jax.random.split(
        jax.random.PRNGKey(seed), n_chunks * batches_per_dispatch
    ).reshape(n_chunks, batches_per_dispatch, -1)
    parts = []
    for c in range(n_chunks):
        parts.append(np.asarray(run_chunk(params, keys[c]), np.float32))
        if c % 8 == 0:
            logger.info("embed chunk %d/%d", c + 1, n_chunks)
    return np.concatenate(parts, axis=0)[:n]


def geometry_stats(emb: np.ndarray, sample: int = 100_000) -> dict:
    """Effective rank + cone concentration — lets synthetic geometry be
    compared against real-checkpoint embeddings later."""
    x = emb[:: max(1, len(emb) // sample)]
    mu = x.mean(axis=0)
    xc = x - mu
    s = np.linalg.svd(xc, compute_uv=False)
    p = (s**2) / (s**2).sum()
    eff_rank = float(np.exp(-(p * np.log(np.maximum(p, 1e-12))).sum()))
    norms = np.linalg.norm(x, axis=1)
    cos_mu = (x @ mu) / (np.maximum(norms, 1e-9) * max(np.linalg.norm(mu), 1e-9))
    return {
        "metric": "geometry",
        "n_sampled": int(len(x)),
        "effective_rank": round(eff_rank, 1),
        "mean_cos_to_centroid": round(float(cos_mu.mean()), 4),
        "norm_cv": round(float(norms.std() / norms.mean()), 4),
    }


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    n = int(args.get("n", "1000000"))
    steps = int(args.get("steps", "600"))
    n_topics = int(args.get("n_topics", "2000"))
    p_len = int(args.get("p_len", "192"))
    q_len = int(args.get("q_len", "32"))
    n_queries = int(args.get("n_queries", "2048"))
    batch = int(args.get("batch", "128"))
    nlists = [int(x) for x in args.get("nlist", "1024,4096").split(",")]
    nprobes = [int(x) for x in args.get("nprobe", "8,16,32,64,128").split(",")]
    slacks = [float(x) for x in args.get("slack", "1.3").split(",")]
    k = int(args.get("k", "100"))
    out_path = args.get("out", "")

    import jax

    from haconvdr_tpu.cli.ivf_sweep import sweep
    from haconvdr_tpu.config import ModelConfig

    remat_arg = args.get("remat", "mlp")
    cfg = ModelConfig(
        dtype=args.get("dtype", "bfloat16"),
        # remat bounds the backward's saved [12, B, L, 768] layer stacks
        remat={"0": False, "1": True}.get(remat_arg, remat_arg),
        num_hidden_layers=int(args.get("layers", "12")),
        hidden_size=int(args.get("hidden", "768")),
        num_attention_heads=int(args.get("heads", "12")),
        intermediate_size=int(args.get("intermediate", "3072")),
        vocab_size=int(args.get("vocab", "50265")),
    )
    t0 = time.time()
    params, losses = train_encoder(
        jax.random.PRNGKey(0), cfg, steps, batch, q_len, p_len, n_topics,
        lr=float(args.get("lr", "1e-4")),
        wd=float(args.get("wd", "0.0")),
        warmup=int(args.get("warmup", "100")),
    )
    logger.info("trained %d steps in %.0f s (losses %s)", steps, time.time() - t0, losses)

    t0 = time.time()
    emb = embed_corpus(params, cfg, n, p_len, n_topics)
    logger.info("embedded %d passages in %.0f s", n, time.time() - t0)
    queries = embed_corpus(params, cfg, n_queries, p_len, n_topics, q_len=q_len)
    if args.get("save_emb"):
        # reusable by cli/ivf_sweep.py (embeddings=/queries=) — later
        # sweeps skip the ~15 min train+embed phase
        np.save(args["save_emb"], emb)
        np.save(args["save_emb"].replace(".npy", "") + "_queries.npy", queries)
        logger.info("saved embeddings to %s", args["save_emb"])

    rows = [geometry_stats(emb)]
    rows[0]["train_steps"] = steps
    rows += sweep(emb, queries, nlists, nprobes, slacks, k=k)
    out = open(out_path, "w") if out_path else sys.stdout
    for r in rows:
        print(json.dumps(r), file=out, flush=True)
    if out_path:
        out.close()
    return rows


if __name__ == "__main__":
    main()
