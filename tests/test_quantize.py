"""int8 scalar-quantized index: exactness w.r.t. the dequantized rows,
recall parity vs the f32 index, and the store/from_store plumbing."""

import numpy as np
import jax
import jax.numpy as jnp

from haconvdr_tpu.index.quantize import dequantize_int8, quantize_int8
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.ops.topk import topk_block
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.parallel.sharded_search import ShardedIndex


def test_quantize_roundtrip_bound(rng):
    emb = rng.randn(257, 24).astype(np.float32) * rng.rand(24)
    q, scale = quantize_int8(emb)
    assert q.dtype == np.int8
    deq = dequantize_int8(q, scale)
    # symmetric rounding: per-element error <= scale/2
    assert np.all(np.abs(deq - emb) <= scale[None, :] / 2 + 1e-7)
    # all-zero dims survive with scale 1
    emb[:, 3] = 0.0
    q, scale = quantize_int8(emb)
    assert scale[3] == 1.0 and np.all(q[:, 3] == 0)


def _deq_oracle_scores(q, int8_rows, scale):
    """The exact arithmetic the int8 search path performs: queries folded
    with the per-dim scale in f32, quantised per query to symmetric int8,
    int8 x int8 products summed exactly (an integer below 2**24, so the
    float64 sum here is exact), times the query scale / 127 in f32."""
    qf = q.astype(np.float32) * scale[None, :]
    qs = np.maximum(np.abs(qf).max(axis=1), np.float32(1e-30))
    codes = np.clip(np.round(qf / qs[:, None] * np.float32(127.0)), -127, 127)
    ints = codes.astype(np.float64) @ np.asarray(int8_rows, np.float64).T
    return ints.astype(np.float32) * (qs / np.float32(127.0))[:, None]


def test_topk_block_int8_matches_dequantized_oracle(rng):
    Q, N, D, k = 16, 512, 32, 9
    emb = rng.randn(N, D).astype(np.float32)
    queries = rng.randn(Q, D).astype(np.float32)
    int8_rows, scale = quantize_int8(emb)
    q_folded = jnp.asarray(queries * scale[None, :], jnp.float32)
    s, i = topk_block(q_folded, jnp.asarray(int8_rows), jnp.int32(N), k, chunk=128)
    full = _deq_oracle_scores(queries, int8_rows, scale)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(full), k)
    np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_sharded_index_int8_exact_vs_dequantized(rng):
    mesh = make_mesh()
    n, d, nq, k = 1111, 16, 6, 17
    passages = rng.randn(n, d).astype(np.float32)
    queries = rng.randn(nq, d).astype(np.float32)
    index = ShardedIndex(mesh, passages, chunk=64, dtype="int8")
    assert index.passages.dtype == jnp.int8 and index.scales is not None
    s, i = index.search(queries, k)

    # reconstruct the oracle from the index's own shards + scales
    int8_all = np.asarray(index.passages)
    scales = np.asarray(index.scales)
    n_shards = scales.shape[0]
    shard_rows = int8_all.shape[0] // n_shards
    parts = [
        _deq_oracle_scores(queries, int8_all[s0 * shard_rows : (s0 + 1) * shard_rows], scales[s0])
        for s0 in range(n_shards)
    ]
    full = np.concatenate(parts, axis=1)[:, :n]
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(full), k)
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, np.asarray(ref_i))


def test_int8_recall_parity_vs_f32(rng):
    """Approximate-recall property on realistic geometry: unit-norm 768-d
    embeddings, top-10 overlap with the exact f32 index stays high."""
    mesh = make_mesh()
    n, d, nq, k = 4096, 768, 8, 10
    passages = rng.randn(n, d).astype(np.float32)
    passages /= np.linalg.norm(passages, axis=1, keepdims=True)
    queries = rng.randn(nq, d).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    f32 = ShardedIndex(mesh, passages, chunk=64)
    i8 = ShardedIndex(mesh, passages, chunk=64, dtype="int8")
    _, ids_f = f32.search(queries, k)
    _, ids_q = i8.search(queries, k)
    overlap = np.mean(
        [len(set(ids_f[r]) & set(ids_q[r])) / k for r in range(nq)]
    )
    assert overlap >= 0.8, overlap


def test_from_store_int8_and_single_read_sizing(rng, tmp_path):
    mesh = make_mesh()
    d, k = 16, 7
    store = EmbeddingBlockStore(str(tmp_path), fmt="npy")
    sizes = [130, 70, 55]
    base = 0
    all_emb = []
    for b, nrows in enumerate(sizes):
        emb = rng.randn(nrows, d).astype(np.float32)
        store.write_block(b, emb, np.arange(base, base + nrows, dtype=np.int64))
        all_emb.append(emb)
        base += nrows
    # cheap sizing reads only npy headers
    assert [store.block_size(b) for b in range(3)] == sizes

    queries = rng.randn(4, d).astype(np.float32)
    index = ShardedIndex.from_store(mesh, store, chunk=8, dtype="int8")
    assert index.n_valid == sum(sizes) and index.passages.dtype == jnp.int8
    s, i = index.search(queries, k)

    # the streaming build must be bit-identical to the in-memory build:
    # same shard cuts, same per-shard scales, same int8 rows
    mem = ShardedIndex(mesh, np.concatenate(all_emb), chunk=8, dtype="int8")
    np.testing.assert_array_equal(np.asarray(index.passages), np.asarray(mem.passages))
    np.testing.assert_array_equal(np.asarray(index.scales), np.asarray(mem.scales))
    s_m, i_m = mem.search(queries, k)
    np.testing.assert_array_equal(i, i_m)
    np.testing.assert_array_equal(s, s_m)

    # and close to the exact f32 index (quantization-level tolerance)
    f32 = ShardedIndex.from_store(mesh, store, chunk=8)
    s_f, i_f = f32.search(queries, k)
    np.testing.assert_allclose(s, s_f, rtol=0.05, atol=0.05)
    overlap = np.mean([len(set(i[r]) & set(i_f[r])) / k for r in range(4)])
    assert overlap >= 0.7, overlap


def test_block_size_pickle_format(rng, tmp_path):
    store = EmbeddingBlockStore(str(tmp_path), fmt="pickle")
    emb = rng.randn(42, 8).astype(np.float32)
    store.write_block(0, emb, np.arange(42, dtype=np.int64))
    assert store.block_size(0) == 42


def test_streaming_int8_blocks_match_dequantized_oracle(rng, monkeypatch):
    """BlockSearcher over int8 blocks (scale as the third tuple element):
    per-block scale folding must reproduce the dequantized-oracle ranking,
    on both the plain scan path and the fused kernel (interpreted)."""
    from haconvdr_tpu.ops import backend
    from haconvdr_tpu.ops.topk import BlockSearcher

    Q, D, k = 16, 16, 8
    queries = rng.randn(Q, D).astype(np.float32)
    sizes = [200, 150]
    blocks, deq_scores, base = [], [], 0
    for n in sizes:
        emb = rng.randn(n, D).astype(np.float32)
        i8, sc = quantize_int8(emb)
        blocks.append((i8, np.arange(base, base + n, dtype=np.int64), sc))
        deq_scores.append(_deq_oracle_scores(queries, i8, sc))
        base += n
    full = np.concatenate(deq_scores, axis=1)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(full), k)

    xla = BlockSearcher(top_k=k, passage_chunk=64)
    s1, i1 = xla.search(queries, list(blocks))
    np.testing.assert_allclose(s1, np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_array_equal(i1, np.asarray(ref_i))

    monkeypatch.setattr(backend, "search_impl", lambda *a: "fused")
    fused = BlockSearcher(top_k=k, passage_chunk=64)
    s2, i2 = fused.search(queries, list(blocks))
    np.testing.assert_allclose(s2, np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_array_equal(i2, np.asarray(ref_i))


def test_encode_corpus_int8_store_roundtrip(tmp_path, rng):
    """encode_corpus(store_dtype='int8') writes int8 blocks + scale
    sidecars; scale-unaware readers get dequantized f32 transparently and
    rank like the float store."""
    import jax as _jax

    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.index.build import encode_corpus
    from haconvdr_tpu.index.store import TokenizedCorpus, TokenizedCorpusWriter
    from haconvdr_tpu.models.encoder import encode, init_encoder_params
    from haconvdr_tpu.ops.topk import BlockSearcher

    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=6)
    for pid in range(20):
        w.add(pid, [4 + pid, 5, 6])
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "c"))
    cfg = ModelConfig.tiny()
    params = init_encoder_params(_jax.random.PRNGKey(0), cfg)
    fn = lambda p, ids, mask: encode(p, cfg, ids, mask)  # noqa: E731
    store = encode_corpus(
        corpus, fn, params, str(tmp_path / "e"), batch_size=4,
        per_block_passage_num=8, store_dtype="int8",
    )
    f32_store = encode_corpus(
        corpus, fn, params, str(tmp_path / "f"), batch_size=4,
        per_block_passage_num=8, store_dtype="float32",
    )
    emb, ids = store.read_block(0)
    scale = store.block_scale(0)
    assert emb.dtype == np.int8 and scale is not None and scale.shape == (emb.shape[1],)

    # default iteration dequantizes; embeddings match the float store to
    # quantization precision
    deq = {}
    for e, i in store.iter_blocks():
        assert e.dtype == np.float32
        for row, off in zip(e, i):
            deq[int(off)] = row
    ref = {}
    for e, i in f32_store.iter_blocks():
        for row, off in zip(np.asarray(e), i):
            ref[int(off)] = row
    assert deq.keys() == ref.keys()
    for off in ref:
        np.testing.assert_allclose(deq[off], ref[off], atol=2e-2, rtol=0.1)

    # raw int8 streaming search agrees with the float store's ranking
    q = rng.randn(3, emb.shape[1]).astype(np.float32)
    searcher = BlockSearcher(top_k=5, passage_chunk=8)
    s_q, i_q = searcher.search(q, store.iter_blocks(with_scales=True))
    s_f, i_f = searcher.search(q, f32_store.iter_blocks())
    overlap = np.mean([len(set(i_q[r]) & set(i_f[r])) / 5 for r in range(3)])
    assert overlap >= 0.8, overlap
