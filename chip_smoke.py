"""Proof that HAConvDR runs end to end on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]     # one card: every phase below
    python3 chip_smoke.py --four         # four cards: the multi-card paths

One process, no network, seeded random weights (RoBERTa-base width:
``ModelConfig()``) and data made from ``--seed``.  Phases, in order:

1. device  — a GPU or exit 1 (no CPU fallback); card name and power limit.
2. serve   — ``serve.Retriever`` over a resident 2,500,000 x 768 f32
             ``EmbeddingBlockStore``, behind ``BatchingRetriever`` and
             ``serve_http.RetrievalServer`` on localhost; a few
             ``POST /retrieve`` and one ``/retrieve_batch``.  Top-100 ids
             against a plain f32 HIGHEST ``jnp.dot`` + ``lax.top_k``
             oracle, query embeddings against a plain f32 HIGHEST einsum
             encoder.
3. search  — ``ShardedIndex`` and ``BlockSearcher`` (two streamed 2.5M
             blocks) at Q=2048, k=100 for f32, bf16 and int8, against the
             same kind of oracle on the same rounded operands.
4. encode  — ``index.build.encode_corpus`` at L=384, B=512 in bf16 and
             with int8 weights, against the f32 reference encoder.
5. train   — ``make_train_step`` for 3 steps at the reference geometry
             (B=64, concat 512, doc 384, prepos-neg and pseudo-prepos,
             dropout, remat as configs/topiocqa_train.toml).
6. memory  — ``compiled.memory_analysis()`` of the train and encode steps.

``--four`` runs only the paths across cards: ``sharded_topk`` over four
cards at QReCC scale (54,573,064 x 768 bf16 made on the cards) against a
per-shard oracle merged on the host, and a dp=4 train step of the full
12-layer tower (remat "mlp") against one card at the same global batch.
The script makes only the first one (or, with ``--four``, four) of the
visible cards visible to JAX.

Any failed check raises; the script then exits non-zero and prints no
result line.  The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

TOP_K = 100
DIM = 768
BLOCK_ROWS = 2_500_000  # IndexConfig.per_block_passage_num
QRECC_ROWS = 54_573_064
HIGHEST = "highest"
U32 = 2.0**-24  # f32 unit roundoff
EMB_TOL = 1e-4  # served vs reference f32 embeddings, max |diff|
GRAD_TOL = 5e-5  # dp vs one card, gradient difference / largest gradient


# ---------------------------------------------------------------------------
# references: plain jax.numpy, independent of the code under test
# ---------------------------------------------------------------------------


def oracle_topk(queries, passages, k, post_scale=None, chunk=262_144, n_rows=None):
    """f32 ``jnp.dot`` at HIGHEST + ``lax.top_k`` over row chunks of the
    first ``n_rows`` rows, merged with the earlier chunk first on equal
    scores (lowest row wins, as a single ``lax.top_k`` over all rows
    would).  ``post_scale`` [Q] multiplies each query's scores (int8: the
    query scale / 127)."""
    import jax
    import jax.numpy as jnp

    q = jnp.asarray(queries, jnp.float32)

    @jax.jit
    def part(q, rows, base):
        s = jnp.dot(q, rows.astype(jnp.float32).T, precision=HIGHEST)
        if post_scale is not None:
            s = s * post_scale[:, None]
        ts, ti = jax.lax.top_k(s, min(k, rows.shape[0]))
        return ts, ti + base

    best_s = best_i = None
    n = passages.shape[0] if n_rows is None else n_rows
    for c0 in range(0, n, chunk):
        s, i = part(q, passages[c0 : min(c0 + chunk, n)], c0)
        if best_s is not None:
            s, pos = jax.lax.top_k(jnp.concatenate([best_s, s], axis=1), k)
            i = jnp.take_along_axis(jnp.concatenate([best_i, i], axis=1), pos, 1)
        best_s, best_i = s, i
    return np.asarray(best_s), np.asarray(best_i)


def row_scores(queries, passages, ids, post_scale=None):
    """The oracle's score of each returned row: [Q, k] at HIGHEST."""
    import jax.numpy as jnp

    rows = jnp.asarray(passages)[jnp.asarray(np.maximum(ids, 0))]
    s = jnp.einsum(
        "qd,qkd->qk", jnp.asarray(queries, jnp.float32),
        rows.astype(jnp.float32), precision=HIGHEST,
    )
    if post_scale is not None:
        s = s * post_scale[:, None]
    return np.asarray(s)


def reorder_tolerance(queries, passages, n_rows=None):
    """[Q, 1] limit on the difference between two f32 sums of the same D
    products taken in different orders: sqrt(D) * u * |q| * max_row |p|
    over the first ``n_rows`` rows.  Rounding errors of random sign grow
    like sqrt(D) * u * sum_d |q_d p_d|, and that sum is at most |q| |p|.
    At 768-d unit-normal rows this is about 1.5e-3: on an H100 two HIGHEST
    orders of the same f32 or bf16 operands differ by at most 2.6e-4,
    while a TF32 product misses HIGHEST by 0.047 (PERF.md), so the check
    passes the first and fails the second."""
    import jax
    import jax.numpy as jnp

    n = passages.shape[0] if n_rows is None else n_rows

    @jax.jit
    def max_sq_norm(p):  # one fused reduction: no f32 copy of the rows
        sq = jnp.sum(jnp.square(p.astype(jnp.float32)), axis=1)
        return jnp.max(jnp.where(jnp.arange(p.shape[0]) < n, sq, 0.0))

    pmax = float(np.sqrt(float(max_sq_norm(jnp.asarray(passages)))))
    q = np.asarray(queries, np.float64)
    return np.sqrt(q.shape[1]) * U32 * np.linalg.norm(q, axis=1, keepdims=True) * pmax


def int8_query_codes(queries):
    """The int8 tier's query operands: per-query symmetric int8 codes and
    their post-scale (scale / 127), as ops.topk.quantize_queries makes
    them on the device — the oracle scores the same rounded operands.
    The codes are checked against a numpy quantisation: they may differ
    by one step where a value sits within float rounding of a .5
    boundary, nowhere else."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.ops.topk import quantize_queries

    codes, scale = jax.jit(quantize_queries)(jnp.asarray(queries, jnp.float32))
    post = jax.jit(lambda s: s / 127.0)(scale)
    qf = np.asarray(queries, np.float32)
    qs = np.maximum(np.abs(qf).max(axis=1), np.float32(1e-30))
    ref = np.clip(np.round(qf / qs[:, None] * np.float32(127.0)), -127, 127)
    off = np.abs(np.asarray(codes, np.float32) - ref)
    assert off.max() <= 1 and (off > 0).mean() < 1e-3, (off.max(), (off > 0).sum())
    return np.asarray(codes, np.float32), post


def scale_tolerance(post_scale, scores):
    """[Q, 1] tolerance of the int8 tier: its scores are exact integers
    times one f32 multiply by the query scale, which the compiler may
    round differently (e.g. through the reciprocal of 127): 4 ulp."""
    return 4 * U32 * np.abs(np.asarray(scores)).max(axis=1, keepdims=True)


def check_topk(name, s, i, ref_s, ref_i, true_s, tol):
    """A correct top-k up to ties within ``tol`` ([Q, 1]; 0 = exact):
    the score lists agree, every returned row has the score it claims,
    rows are unique, and where an id differs from the oracle's, the two
    rows' oracle scores tie within ``tol``.  Returns (positions whose id
    differs, max |score - oracle score|)."""
    s, i = np.asarray(s), np.asarray(i)
    assert s.shape == ref_s.shape == i.shape, (name, s.shape, ref_s.shape)
    assert np.isfinite(s).all(), f"{name}: non-finite scores"
    err = np.abs(s - ref_s)
    assert (err <= tol).all(), f"{name}: scores differ from the oracle by {err.max()}"
    assert (np.abs(true_s - s) <= tol).all(), (
        f"{name}: a returned id does not have its returned score "
        f"({np.abs(true_s - s).max()})"
    )
    for r in range(i.shape[0]):
        assert len(set(i[r].tolist())) == i.shape[1], f"{name}: duplicate ids"
    swapped = i != ref_i
    tie = np.abs(true_s - ref_s) <= tol
    assert tie[swapped].all(), (
        f"{name}: an id differs from the oracle's without a tie "
        f"({np.abs(true_s - ref_s)[swapped].max()})"
    )
    return int(swapped.sum()), float(err.max())


def reference_encode(params, cfg, ids, mask):
    """Plain f32 RoBERTa + ANCE head at HIGHEST, from the HF definitions
    (list-of-layers params as models.encoder.init_encoder_params makes)."""
    import jax
    import jax.numpy as jnp

    def ln(x, p, eps):
        m = x.mean(-1, keepdims=True)
        v = ((x - m) ** 2).mean(-1, keepdims=True)
        return (x - m) / jnp.sqrt(v + eps) * p["scale"] + p["bias"]

    def dense(x, p):
        return jnp.einsum("...i,io->...o", x, p["kernel"], precision=HIGHEST) + p["bias"]

    @jax.jit
    def run(params, ids, mask):
        eps = cfg.layer_norm_eps
        e = params["embeddings"]
        real = (ids != cfg.pad_token_id).astype(jnp.int32)
        pos = jnp.cumsum(real, axis=1) * real + cfg.pad_token_id
        x = e["word_embeddings"][ids] + e["position_embeddings"][pos]
        x = ln(x + e["token_type_embeddings"][0], e["layer_norm"], eps)
        B, L, H = x.shape
        nh = cfg.num_attention_heads
        d = H // nh
        key_ok = mask.astype(bool)[:, None, None, :]
        for layer in params["layers"]:
            a = layer["attention"]
            q, k, v = (dense(x, a[n]).reshape(B, L, nh, d) for n in ("query", "key", "value"))
            s = jnp.einsum("bqhd,bkhd->bhqk", q, k, precision=HIGHEST) / np.sqrt(d)
            p = jax.nn.softmax(jnp.where(key_ok, s, -jnp.inf), axis=-1)
            c = jnp.einsum("bhqk,bkhd->bqhd", p, v, precision=HIGHEST).reshape(B, L, H)
            x = ln(x + dense(c, a["output"]), a["output_layer_norm"], eps)
            h = jax.nn.gelu(dense(x, layer["intermediate"]), approximate=False)
            x = ln(x + dense(h, layer["output"]), layer["output_layer_norm"], eps)
        return ln(dense(x[:, 0], params["embedding_head"]), params["norm"], 1e-5)

    return np.asarray(run(params, jnp.asarray(ids), jnp.asarray(mask)))


def check_attention(seed, batch=64, length=384, heads=12, head_dim=64):
    """The encoder's attention as chosen for bf16 on this backend (cuDNN
    on the GPU) against the plain f32 HIGHEST einsum form, with right
    padding.  bf16 rounds q, k, v and the probabilities: max |diff| on
    the O(1) context <= 3e-2.  Returns (implementation, max |diff|)."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.models.encoder import dot_product_attention
    from haconvdr_tpu.ops import backend

    rs = np.random.RandomState(seed)
    H = heads * head_dim
    qkv = rs.randn(batch, length, 3 * H).astype(np.float32)
    lens = rs.randint(1, length + 1, batch)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    impl = backend.attention_impl(jnp.bfloat16)
    got = jax.jit(lambda x, m: dot_product_attention(x, m, heads, jnp.bfloat16, impl))(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask))
    t = jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32).reshape(batch, length, 3, heads, head_dim)
    s = jnp.einsum("bqhd,bkhd->bhqk", t[:, :, 0], t[:, :, 1], precision=HIGHEST) / np.sqrt(head_dim)
    p = jax.nn.softmax(jnp.where(jnp.asarray(mask, bool)[:, None, None, :], s, -jnp.inf), -1)
    ref = jnp.einsum("bhqk,bkhd->bqhd", p, t[:, :, 2], precision=HIGHEST).reshape(batch, length, H)
    valid = mask.astype(bool)
    err = float(np.abs(np.asarray(got, np.float32)[valid] - np.asarray(ref)[valid]).max())
    assert err <= 3e-2, f"attention ({impl}) differs from the einsum form by {err}"
    return impl, err


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def device_rows(n, d, seed, dtype="float32"):
    """[n, d] standard-normal rows made on the device in slices."""
    import jax
    import jax.numpy as jnp

    gen = jax.jit(
        lambda key: jax.random.normal(key, (min(n, 1 << 20), d), jnp.float32).astype(dtype)
    )
    key = jax.random.PRNGKey(seed)
    parts = [gen(jax.random.fold_in(key, c))[: n - c0] for c, c0 in enumerate(range(0, n, 1 << 20))]
    return jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

_WORDS = [f"w{i}" for i in range(5000)]


def _conversation(rs, turns):
    def text(n):
        return " ".join(rs.choice(_WORDS, n))

    history = [(text(rs.randint(4, 12)), text(rs.randint(8, 40))) for _ in range(turns)]
    passages = [text(rs.randint(60, 200)) for _ in range(turns)]
    return {"question": text(rs.randint(4, 12)), "history": history, "history_passages": passages}


def phase_serve(model_cfg, n_rows, seed, n_single=3, n_batch=4):
    """Retriever + BatchingRetriever + RetrievalServer on localhost."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.config import SearchConfig
    from haconvdr_tpu.index.store import EmbeddingBlockStore
    from haconvdr_tpu.models.encoder import init_encoder_params
    from haconvdr_tpu.serve import Retriever
    from haconvdr_tpu.serve_http import RetrievalServer
    from haconvdr_tpu.utils.testing import FakeTokenizer

    t0 = time.time()
    rows = device_rows(n_rows, model_cfg.embedding_dim, seed)
    params = init_encoder_params(jax.random.PRNGKey(seed), model_cfg)
    rs = np.random.RandomState(seed)
    convs = [_conversation(rs, rs.randint(1, 8)) for _ in range(n_single + n_batch)]
    with tempfile.TemporaryDirectory() as tmp:
        store = EmbeddingBlockStore(tmp)
        store.write_block(0, np.asarray(rows), np.arange(n_rows, dtype=np.int64))
        search_cfg = SearchConfig(top_k=TOP_K)
        retriever = Retriever(
            FakeTokenizer(), params, model_cfg, store, search_cfg=search_cfg,
            resident=True,
        )
        # the served embeddings, through the serving encoder at the same
        # bucket shapes the batcher uses (1 per single request, 4 per batch)
        exs = [retriever.build_query(**c) for c in convs]
        emb = np.concatenate(
            [retriever.embed([e]) for e in exs[:n_single]]
            + [retriever.embed(exs[n_single:])]
        )
        setup_s = time.time() - t0
        server = RetrievalServer(
            retriever, port=0, max_batch=n_batch, max_wait_ms=50.0,
            request_timeout_s=600.0,
        ).start()
        try:
            url = f"http://{server.host}:{server.port}"

            def post(path, obj):
                req = urllib.request.Request(
                    url + path, data=json.dumps(obj).encode(),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with urllib.request.urlopen(req, timeout=900) as r:
                    assert r.status == 200, r.status
                    return json.loads(r.read())

            answers = [post("/retrieve", c) for c in convs[:n_single]]
            answers += post("/retrieve_batch", {"queries": convs[n_single:]})["results"]
            stats = server.stats()
        finally:
            server.close()
    assert stats["served"] == n_single + n_batch and stats["errors"] == 0, stats
    got_i = np.asarray([[h["pid"] for h in a["hits"]] for a in answers])
    got_s = np.asarray([[h["score"] for h in a["hits"]] for a in answers], np.float32)
    ref_s, ref_i = oracle_topk(emb, rows, TOP_K)
    tol = reorder_tolerance(emb, rows)
    mism, score_err = check_topk(
        "serve", got_s, got_i, ref_s, ref_i, row_scores(emb, rows, got_i), tol
    )
    # served embeddings vs the plain encoder: both f32 at HIGHEST, so
    # they differ only by summation order through 12 layers of unit-scale
    # LayerNorm outputs.  On an H100 they differ by 4.1e-6; f32 operands
    # rounded to TF32 move them by more than 1e-3 (tests/test_chip_smoke.py)
    ref_emb = reference_encode(
        params, model_cfg,
        np.stack([e["conv_qp"] for e in exs]), np.stack([e["conv_qp_mask"] for e in exs]),
    )
    emb_err = float(np.abs(emb - ref_emb).max())
    assert emb_err <= EMB_TOL, f"served embeddings differ from the reference by {emb_err}"
    return {
        "phase": "serve", "rows": n_rows, "requests": n_single + n_batch,
        "id_mismatches": mism, "score_max_abs_err": score_err,
        "embedding_max_abs_err": emb_err,
        "setup_s": round(setup_s, 1), "p50_ms": stats["latency_ms"]["p50"],
    }


def phase_search(n_rows, n_queries, seed, dim=DIM, chunk=65_536, passage_chunk=131_072):
    """ShardedIndex (one device) and BlockSearcher (two streamed blocks)
    for f32, bf16 and int8 against the oracle on the same operands."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.index.quantize import quantize_int8
    from haconvdr_tpu.ops.topk import BlockSearcher
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_search import ShardedIndex

    from haconvdr_tpu.ops import backend

    mesh = make_mesh(devices=jax.devices()[:1])
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (n_queries, dim), jnp.float32))
    blocks = [np.asarray(device_rows(n_rows, dim, seed + 2 + b)) for b in range(2)]
    out = {"phase": "search", "rows": n_rows, "queries": n_queries}
    for dt in ("float32", "bfloat16", "int8"):
        out[f"{dt}_impl"] = backend.search_impl(jnp.dtype(dt), TOP_K, dim)
        # resident: one ShardedIndex over block 0
        index = ShardedIndex(mesh, blocks[0], chunk=chunk, dtype=dt)
        s, i = index.search(q, TOP_K)
        if dt == "int8":
            codes = np.asarray(index.passages)[:n_rows]
            qc, post = int8_query_codes(q * np.asarray(index.scales)[0])
            ops = (qc, codes)
        else:
            qo = np.asarray(jnp.asarray(q, dt).astype(jnp.float32))
            ops, post = (qo, index.passages), None
        ref_s, ref_i = oracle_topk(*ops, TOP_K, post_scale=post, n_rows=n_rows)
        tol = (scale_tolerance(post, ref_s) if dt == "int8"
               else reorder_tolerance(*ops, n_rows=n_rows))
        true_s = row_scores(*ops, i, post_scale=post)
        out[f"sharded_{dt}_id_mismatches"], out[f"sharded_{dt}_score_err"] = check_topk(
            f"ShardedIndex {dt}", s, i, ref_s, ref_i, true_s, tol
        )
        del index, ops
        # streamed: the eval path's BlockSearcher over two blocks
        searcher = BlockSearcher(
            top_k=TOP_K, passage_chunk=passage_chunk, query_chunk=256,
            compute_dtype="bfloat16" if dt == "bfloat16" else "float32",
        )
        ids = [np.arange(b * n_rows, (b + 1) * n_rows, dtype=np.int64) for b in range(2)]
        if dt == "int8":
            qb = [quantize_int8(blk) for blk in blocks]
            items = [(c, ids[b], sc) for b, (c, sc) in enumerate(qb)]
        else:
            items = list(zip(blocks, ids))
        s, i = searcher.search(q, items)
        parts = []
        for b in range(2):
            if dt == "int8":
                qc, post = int8_query_codes(q * qb[b][1])
                ops = (qc, qb[b][0])
            else:
                ops, post = (qo, jnp.asarray(blocks[b], dt)), None
            bs, bi = oracle_topk(*ops, TOP_K, post_scale=post)
            parts.append((bs, bi + b * n_rows, ops, post))
        cat_s = np.concatenate([parts[0][0], parts[1][0]], 1)
        cat_i = np.concatenate([parts[0][1], parts[1][1]], 1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :TOP_K]
        ref_s, ref_i = np.take_along_axis(cat_s, order, 1), np.take_along_axis(cat_i, order, 1)
        true_s = np.zeros_like(s)
        tol = scale_tolerance(None, ref_s) if dt == "int8" else np.zeros((n_queries, 1))
        for b, (_, _, ops, post) in enumerate(parts):
            own = (i >= b * n_rows) & (i < (b + 1) * n_rows)
            sc = row_scores(*ops, np.where(own, i - b * n_rows, 0), post_scale=post)
            true_s = np.where(own, sc, true_s)
            if dt != "int8":
                tol = np.maximum(tol, reorder_tolerance(*ops))
        out[f"stream_{dt}_id_mismatches"], out[f"stream_{dt}_score_err"] = check_topk(
            f"BlockSearcher {dt}", s, i, ref_s, ref_i, true_s, tol
        )
    return out


def _tokenized_corpus(path, n, length, seed, vocab):
    from haconvdr_tpu.index.store import TokenizedCorpus, TokenizedCorpusWriter

    rs = np.random.RandomState(seed)
    w = TokenizedCorpusWriter(path, max_seq_length=length)
    lens = rs.randint(length // 4, length - 1, n)
    lens[: n // 2] = length - 2  # half the passages fill the window
    for pid in range(n):
        w.add(pid, [0] + rs.randint(4, vocab, lens[pid]).tolist() + [2])
    w.finalize()
    return TokenizedCorpus(path)


def _compile(fn, *args):
    """(compiled, its memory_analysis() as a dict)."""
    compiled = fn.lower(*args).compile()
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return compiled, {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def phase_encode(model_cfg, n_batches, batch, length, seed):
    """encode_corpus in bf16 and with int8 weights vs the f32 reference."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.index.build import encode_corpus
    from haconvdr_tpu.models.encoder import init_encoder_params, quantize_encoder_params
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_encode import make_sharded_encode_fn, shard_params

    mesh = make_mesh()
    n = n_batches * batch
    params = init_encoder_params(jax.random.PRNGKey(seed), model_cfg)
    bf16_cfg = dataclasses.replace(model_cfg, dtype="bfloat16")
    out = {"phase": "encode", "passages": n, "length": length, "batch": batch}
    out["attention_impl"], out["attention_max_err"] = check_attention(seed, length=length)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = _tokenized_corpus(f"{tmp}/corpus", n, length, seed, model_cfg.vocab_size)
        _, ids, mask = next(corpus.batches(64))
        ref = reference_encode(params, model_cfg, ids, mask)
        # cosine floors: bf16 rounds each of ~50 ops per layer at 2^-9,
        # int8 adds per-token activation rounding at 1/254 — both leave
        # embeddings within a few percent, so cos >= 0.999 / 0.99
        for name, p, floor in (
            ("bf16", params, 0.999),
            ("int8", quantize_encoder_params(params), 0.99),
        ):
            fn = make_sharded_encode_fn(mesh, bf16_cfg)
            sp = shard_params(mesh, p)
            t0 = time.time()
            store = encode_corpus(corpus, fn, sp, f"{tmp}/{name}", batch_size=batch)
            out[f"{name}_s"] = round(time.time() - t0, 2)
            emb, got_ids = store.read_block(0)
            assert emb.shape == (n, model_cfg.embedding_dim), emb.shape
            assert np.isfinite(np.asarray(emb, np.float32)).all()
            cos = cosine(np.asarray(emb, np.float32)[:64], ref)
            out[f"{name}_min_cos"] = float(cos.min())
            assert cos.min() >= floor, f"{name} encode: min cosine {cos.min()}"
            out[f"{name}_memory"] = _compile(
                fn, sp, jnp.zeros((batch, length), jnp.int32), jnp.ones((batch, length), jnp.int32)
            )[1]
    return out


def _train_batch(rs, b, lq, ld, vocab):
    def seqs(n, length):
        lens = rs.randint(length // 4, length + 1, n)
        ids = rs.randint(4, vocab, (n, length)).astype(np.int32)
        mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
        return np.where(mask == 1, ids, 1).astype(np.int32), mask

    batch = {"valid": np.ones((b,), np.int32), "has_pseudo_prepos": np.ones((b,), np.int32),
             "has_prepos_neg": np.ones((b,), np.int32)}
    batch["conv_qp"], batch["conv_qp_mask"] = seqs(b, lq)
    for key in ("pos_docs", "neg_docs", "pseudo_prepos_docs", "prepos_neg_docs"):
        batch[key], batch[key + "_mask"] = seqs(b, ld)
    return batch


def phase_train(model_cfg, batch, lq, ld, steps, seed):
    """make_train_step at the reference geometry: finite losses, params
    that change."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.config import TrainConfig
    from haconvdr_tpu.models.encoder import init_encoder_params, stack_layer_params
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.train.trainer import init_train_state, make_optimizer, make_train_step

    tcfg = TrainConfig(
        per_device_train_batch_size=batch, accumulation_steps=1,
        is_pseudo_prepos=True, is_prepos_neg=True,
    )
    mesh = make_mesh()
    opt = make_optimizer(tcfg, 100)
    step = make_train_step(mesh, model_cfg, tcfg, opt)
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(seed), model_cfg))
    state = init_train_state(params, opt, seed=seed)
    b = {k: jnp.asarray(v) for k, v in _train_batch(
        np.random.RandomState(seed), batch, lq, ld, model_cfg.vocab_size).items()}
    step, memory = _compile(step, state, params, b)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.time()
        state, loss = step(state, params, b)
        losses.append(float(loss))
        times.append(time.time() - t0)
    assert np.isfinite(losses).all(), losses
    delta = max(
        float(jnp.max(jnp.abs(a - p)))
        for a, p in zip(jax.tree_util.tree_leaves(state.params), jax.tree_util.tree_leaves(params))
    )
    assert delta > 0, "train steps left the params unchanged"
    return {"phase": "train", "batch": batch, "losses": losses, "max_param_change": delta,
            "step_s": [round(t, 3) for t in times], "remat": model_cfg.remat, "memory": memory}


def phase_four_search(n_rows, n_queries, seed, dim=DIM, chunk=65_536):
    """sharded_topk over every device at ``n_rows`` bf16 rows made on the
    devices, against a per-shard HIGHEST oracle merged on the host."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from haconvdr_tpu.parallel.sharded_search import _flat_mesh, sharded_topk
    from haconvdr_tpu.parallel.mesh import make_mesh

    fmesh = _flat_mesh(make_mesh())
    n_dev = fmesh.devices.size
    shard_rows = -(-(-(-n_rows // n_dev)) // chunk) * chunk

    def gen_local(key):
        # each card fills its own shard slice by slice: no card ever
        # holds more than its shard plus one f32 slice
        key = jax.random.fold_in(key, jax.lax.axis_index("d"))

        def body(c, buf):
            blk = jax.random.normal(jax.random.fold_in(key, c), (chunk, dim), jnp.float32)
            return jax.lax.dynamic_update_slice(buf, blk.astype(jnp.bfloat16), (c * chunk, 0))

        buf = jnp.zeros((shard_rows, dim), jnp.bfloat16)
        return jax.lax.fori_loop(0, shard_rows // chunk, body, buf)

    passages = jax.jit(jax.shard_map(
        gen_local, mesh=fmesh, in_specs=P(), out_specs=P("d", None), check_vma=False,
    ))(jax.random.PRNGKey(seed))
    devs = {sh.device for sh in passages.addressable_shards}
    assert len(devs) == n_dev and all(
        sh.data.shape == (shard_rows, dim) for sh in passages.addressable_shards
    ), "each shard must live on its own card"
    q = jax.random.normal(jax.random.PRNGKey(seed + 1), (n_queries, dim), jnp.float32)
    qb = jnp.asarray(q, jnp.bfloat16)
    t0 = time.time()
    s, i = jax.jit(lambda q, p: sharded_topk(fmesh, q, p, n_rows, TOP_K, chunk))(qb, passages)
    s, i = np.asarray(s), np.asarray(i)
    first_s = time.time() - t0
    qo = np.asarray(qb.astype(jnp.float32))
    cat_s, cat_i, true_s = [], [], np.zeros_like(s)
    tol = np.zeros((n_queries, 1))
    for sh in sorted(passages.addressable_shards, key=lambda sh: sh.index[0].start):
        base = sh.index[0].start
        valid = max(0, min(shard_rows, n_rows - base))
        if valid == 0:  # an all-padding shard holds no candidates
            continue
        rows = sh.data  # rows at or beyond `valid` are padding
        qd = jax.device_put(qo, sh.device)
        bs, bi = oracle_topk(qd, rows, TOP_K, n_rows=valid)
        cat_s.append(bs)
        cat_i.append(bi + base)
        own = (i >= base) & (i < base + valid)
        sc = row_scores(qd, rows, np.where(own, i - base, 0))
        true_s = np.where(own, sc, true_s)
        tol = np.maximum(tol, reorder_tolerance(qo, rows, n_rows=valid))
    cat_s, cat_i = np.concatenate(cat_s, 1), np.concatenate(cat_i, 1)
    order = np.argsort(-cat_s, axis=1, kind="stable")[:, :TOP_K]
    mism, score_err = check_topk(
        "sharded_topk x4", s, i, np.take_along_axis(cat_s, order, 1),
        np.take_along_axis(cat_i, order, 1), true_s, tol,
    )
    return {"phase": "four_search", "rows": n_rows, "shard_rows": shard_rows,
            "cards": n_dev, "queries": n_queries, "id_mismatches": mism, "score_max_abs_err": score_err,
            "first_call_s": round(first_s, 1)}


def phase_four_train(model_cfg, batch, lq, ld, seed):
    """One dp=len(devices) train step vs one card at the same global
    batch; dropout off so both compute the same function."""
    import dataclasses

    import jax

    from haconvdr_tpu.models.encoder import init_encoder_params, stack_layer_params

    cfg = dataclasses.replace(model_cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(seed), cfg))
    b_np = _train_batch(np.random.RandomState(seed), batch, lq, ld, cfg.vocab_size)
    l_dp, g_dp = train_grads(cfg, params, b_np, jax.devices(), seed)
    l_one, g_one = train_grads(cfg, params, b_np, jax.devices()[:1], seed)
    # the same f32 HIGHEST math, reduced across cards in another order
    assert abs(l_dp - l_one) <= 1e-5 * abs(l_one), (l_dp, l_one)
    gdiff = grad_rel_diff(g_dp, g_one)
    assert gdiff <= GRAD_TOL, f"dp and one-card gradients differ by {gdiff} of the largest"
    return {"phase": "four_train", "dp": len(jax.devices()), "batch": batch,
            "loss_dp": l_dp, "loss_one": l_one, "max_rel_grad_diff": gdiff,
            "layers": cfg.num_hidden_layers, "remat": cfg.remat}


def train_grads(cfg, params, batch, devices, seed):
    """(loss, gradients as numpy) of one make_train_step over a mesh of
    ``devices``.  Two-step accumulation, so the step leaves the raw
    gradients in the state."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.config import TrainConfig
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.train.trainer import init_train_state, make_optimizer, make_train_step

    tcfg = TrainConfig(per_device_train_batch_size=len(batch["valid"]), accumulation_steps=2,
                       is_pseudo_prepos=True, is_prepos_neg=True)
    opt = make_optimizer(tcfg, 2)
    step = make_train_step(make_mesh(devices=devices), cfg, tcfg, opt)
    state = init_train_state(params, opt, seed=seed)
    state, loss = step(state, params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, state.accum_grads)


def grad_rel_diff(grads_a, grads_b) -> float:
    """Largest entry-wise difference of two gradient trees over the largest
    entry of ``grads_b``: some gradients (the key bias's) are zero up to
    rounding, so entries are measured against the largest.  On H100s a
    dp=4 step and one card at HIGHEST differ by 9.0e-6 (2 layers) and
    1.54e-5 (12 layers); with the loss matmuls in TF32 the 2-layer
    comparison read 1.28e-4, and TF32-rounded operands move it past
    GRAD_TOL (tests/test_chip_smoke.py)."""
    import jax

    leaves = list(zip(jax.tree_util.tree_leaves(grads_a), jax.tree_util.tree_leaves(grads_b)))
    gmax = max(float(np.abs(b).max()) for _, b in leaves)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in leaves) / gmax


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true", help="run the four-card paths only")
    args = ap.parse_args(argv)
    want = 4 if args.four else 1
    # JAX sees only the first ``want`` visible cards, so every mesh and
    # the reported count are theirs on a larger host
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [str(d) for d in range(want)] if visible is None else visible.split(",")
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:want])

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    if len(devices) != want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print(card_line(), flush=True)
    print(f"device_kind={devices[0].device_kind} jax={jax.__version__} devices={len(devices)}",
          flush=True)

    def run(fn, *a, **kw):
        t0 = time.time()
        res = fn(*a, **kw)
        res["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(res), flush=True)

    t_all = time.time()
    if args.four:
        run(phase_four_search, QRECC_ROWS, 1024, args.seed)
        run(phase_four_train, ModelConfig(remat="mlp"), 64, 512, 384, args.seed)
    else:
        run(phase_serve, ModelConfig(), BLOCK_ROWS, args.seed)
        run(phase_search, BLOCK_ROWS, 2048, args.seed)
        run(phase_encode, ModelConfig(), 3, 512, 384, args.seed)
        run(phase_train, ModelConfig(remat="mlp"), 64, 512, 384, 3, args.seed)
    print(f"total_s={time.time() - t_all:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
