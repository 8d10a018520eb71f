"""Sharded search/encode on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from haconvdr_tpu.config import ModelConfig
from haconvdr_tpu.models.encoder import encode, init_encoder_params
from haconvdr_tpu.ops.topk import exact_topk_oracle
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.parallel.sharded_encode import (
    make_sharded_encode_fn,
    shard_params,
)
from haconvdr_tpu.parallel.sharded_search import ShardedIndex


def test_sharded_index_matches_oracle(rng):
    mesh = make_mesh()  # 8 devices -> dp=8, tp=1
    n, d, q, k = 1111, 16, 6, 17
    passages = rng.randn(n, d).astype(np.float32)
    queries = rng.randn(q, d).astype(np.float32)
    index = ShardedIndex(mesh, passages, chunk=64)
    s, i = index.search(queries, k)
    ref_s, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(passages), k)
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i, np.asarray(ref_i))


def test_sharded_index_with_id_mapping(rng):
    mesh = make_mesh()
    n, d = 300, 8
    passages = rng.randn(n, d).astype(np.float32)
    ids = (np.arange(n) * 7 + 3).astype(np.int64)
    queries = rng.randn(4, d).astype(np.float32)
    index = ShardedIndex(mesh, passages, ids=ids, chunk=32)
    s, got = index.search(queries, 9)
    _, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(passages), 9)
    np.testing.assert_array_equal(got, ids[np.asarray(ref_i)])


def test_dp_sharded_encode_matches_single_device(rng):
    cfg = ModelConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh(dp=8, tp=1)
    B, L = 16, 10
    ids = rng.randint(4, cfg.vocab_size, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)

    fn = make_sharded_encode_fn(mesh, cfg)
    sharded = np.asarray(fn(shard_params(mesh, params), jnp.asarray(ids), jnp.asarray(mask)))
    single = np.asarray(encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


def test_tp_sharded_encode_matches_single_device(rng):
    cfg = ModelConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(1), cfg)
    mesh = make_mesh(dp=2, tp=4)
    B, L = 4, 8
    ids = rng.randint(4, cfg.vocab_size, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)

    fn = make_sharded_encode_fn(mesh, cfg, tp=True)
    out = np.asarray(
        fn(shard_params(mesh, params, tp=True), jnp.asarray(ids), jnp.asarray(mask))
    )
    single = np.asarray(encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(out, single, rtol=1e-4, atol=1e-4)


def test_sharded_index_from_store(rng, tmp_path):
    from haconvdr_tpu.index.store import EmbeddingBlockStore
    from haconvdr_tpu.parallel.sharded_search import ShardedIndex

    mesh = make_mesh()
    n, d = 530, 8
    emb = rng.randn(n, d).astype(np.float32)
    ids = (np.arange(n) * 2 + 1).astype(np.int64)
    store = EmbeddingBlockStore(str(tmp_path / "blk"))
    store.write_block(0, emb[:200], ids[:200])
    store.write_block(1, emb[200:430], ids[200:430])
    store.write_block(2, emb[430:], ids[430:])

    index = ShardedIndex.from_store(mesh, store, chunk=16)
    assert index.n_valid == n
    queries = rng.randn(6, d).astype(np.float32)
    s, got = index.search(queries, 11)
    ref_s, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(emb), 11)
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, ids[np.asarray(ref_i)])


def test_sharded_index_from_store_bf16(rng, tmp_path):
    from haconvdr_tpu.index.store import EmbeddingBlockStore
    from haconvdr_tpu.parallel.sharded_search import ShardedIndex

    mesh = make_mesh()
    n, d = 200, 8
    emb = rng.randn(n, d).astype(np.float32)
    store = EmbeddingBlockStore(str(tmp_path / "blk"))
    store.write_block(0, emb, np.arange(n, dtype=np.int64))
    index = ShardedIndex.from_store(mesh, store, chunk=8, dtype="bfloat16")
    assert str(index.passages.dtype) == "bfloat16"
    queries = rng.randn(4, d).astype(np.float32)
    s, got = index.search(queries, 10)
    _, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(emb), 10)
    # bf16 scoring: require high overlap with the exact ranking
    overlap = np.mean([
        len(set(got[i]) & set(np.asarray(ref_i)[i])) / 10 for i in range(4)
    ])
    assert overlap >= 0.9, overlap


def test_sharded_topk_pallas_v4_matches_xla(rng, monkeypatch):
    """The fused search kernel (ops/triton_topk.py, interpreted here)
    inside sharded_topk's shard_map body must reproduce the plain chunked
    path (scores and global ids), including the cross-shard n_valid
    clipping on the last shard.  Scores: rtol 1e-5, the two paths sum the
    same f32 products in a different order."""
    from haconvdr_tpu.ops import backend
    from haconvdr_tpu.parallel.sharded_search import sharded_topk

    mesh = make_mesh()
    n_valid, d, q, k = 7_777, 32, 40, 23
    rows = 8 * 1024  # 8 shards x 1024
    passages = np.zeros((rows, d), np.float32)
    passages[:n_valid] = rng.randn(n_valid, d)
    queries = rng.randn(q, d).astype(np.float32)
    pj, qj = jnp.asarray(passages), jnp.asarray(queries)

    ref_s, ref_i = sharded_topk(mesh, qj, pj, n_valid, k, chunk=1024)
    monkeypatch.setattr(backend, "search_impl", lambda *a: "fused")
    s, i = sharded_topk(mesh, qj, pj, n_valid, k, chunk=1024)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(ref_s), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_two_host_encode_simulation(rng, tmp_path):
    """Multi-host corpus encode simulated on the virtual mesh: two
    stride/offset passes (the 'hosts' — the analog of the reference's
    rank-mod StreamingDataset, src/utils.py:133-147) write disjoint block
    ranges into one shared store; stitched, they must reproduce the
    single-pass encode exactly (same offset -> embedding map)."""
    from haconvdr_tpu.index.build import encode_corpus
    from haconvdr_tpu.index.store import (
        EmbeddingBlockStore,
        TokenizedCorpus,
        TokenizedCorpusWriter,
    )

    cfg = ModelConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(2), cfg)
    mesh = make_mesh(dp=8)
    fn = make_sharded_encode_fn(mesh, cfg)
    sp = shard_params(mesh, params)

    L, n = 10, 53  # ragged vs batch (8) and block (16) sizes
    w = TokenizedCorpusWriter(str(tmp_path / "tok"), L)
    for i in range(n):
        w.add(
            1000 + i,
            rng.randint(4, cfg.vocab_size, size=rng.randint(3, L + 1)).tolist(),
        )
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "tok"))

    encode_corpus(
        corpus, fn, sp, str(tmp_path / "single"),
        batch_size=8, per_block_passage_num=16,
    )
    shared = str(tmp_path / "shared")
    # host 0: even offsets, blocks [0, 2); host 1: odd offsets, blocks [2, ..)
    encode_corpus(
        corpus, fn, sp, shared, batch_size=8, per_block_passage_num=16,
        stride=2, offset=0, start_block_id=0,
    )
    encode_corpus(
        corpus, fn, sp, shared, batch_size=8, per_block_passage_num=16,
        stride=2, offset=1, start_block_id=2,
    )

    def id_map(store_dir):
        store = EmbeddingBlockStore(store_dir)
        out = {}
        for b in range(store.num_blocks()):
            emb, ids = store.read_block(b)
            for row, off in zip(np.asarray(emb), np.asarray(ids)):
                assert int(off) not in out
                out[int(off)] = row
        return out

    single = id_map(str(tmp_path / "single"))
    stitched = id_map(shared)
    assert set(single) == set(stitched) == set(range(n))
    for off in single:
        np.testing.assert_array_equal(single[off], stitched[off])
