"""Index store tests: native layouts, reference-format interop, integrity."""

import json
import os

import numpy as np
import pytest

from haconvdr_tpu.index.store import (
    EmbeddingBlockStore,
    ReferenceEmbeddingCacheReader,
    TokenizedCorpus,
    TokenizedCorpusWriter,
)


def test_tokenized_corpus_roundtrip(tmp_path, rng):
    w = TokenizedCorpusWriter(str(tmp_path / "corpus"), max_seq_length=8)
    recs = [(17, [1, 2, 3]), (42, [4, 5, 6, 7, 8, 9, 10, 11, 12]), (3, [9])]
    for pid, ids in recs:
        w.add(pid, ids)
    w.finalize()

    c = TokenizedCorpus(str(tmp_path / "corpus"))
    assert len(c) == 3
    np.testing.assert_array_equal(c.pids, [17, 42, 3])
    np.testing.assert_array_equal(c.lengths, [3, 8, 1])
    np.testing.assert_array_equal(c.tokens[0], [1, 2, 3, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(c.tokens[1], [4, 5, 6, 7, 8, 9, 10, 11])
    assert c.offset2pid() == [17, 42, 3]

    batches = list(c.batches(2))
    assert len(batches) == 2
    offs, ids, mask = batches[0]
    np.testing.assert_array_equal(offs, [0, 1])
    np.testing.assert_array_equal(mask[0], [1, 1, 1, 0, 0, 0, 0, 0])


def test_tokenized_corpus_rank_mod_sharding(tmp_path):
    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=4)
    for pid in range(10):
        w.add(pid, [pid])
    w.finalize()
    c = TokenizedCorpus(str(tmp_path / "c"))
    offs = np.concatenate([o for o, _, _ in c.batches(3, stride=3, offset=1)])
    np.testing.assert_array_equal(offs, [1, 4, 7])


def test_reference_embedding_cache_reader(tmp_path):
    """Read the reference's byte-record format: len(4B big-endian) +
    int32 ids[max_seq] (gen_tokenized_doc.py:161-183)."""
    base = str(tmp_path / "passages")
    L = 6
    records = [([5, 6, 7], 3), ([1] * 6, 6)]
    with open(base, "wb") as f:
        for ids, n in records:
            padded = np.zeros(L, np.int32)
            padded[: len(ids)] = ids
            f.write(int(n).to_bytes(4, "big") + padded.tobytes())
    with open(base + "_meta", "w") as f:
        json.dump({"type": "int32", "total_number": 2, "embedding_size": L}, f)

    r = ReferenceEmbeddingCacheReader(base)
    assert r.total_number == 2
    batches = list(r.batches(10))
    offs, ids, mask = batches[0]
    np.testing.assert_array_equal(ids[0], [5, 6, 7, 0, 0, 0])
    np.testing.assert_array_equal(mask[0], [1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(mask[1], [1] * 6)


def test_block_store_pickle_interop(tmp_path, rng):
    """Reference pickle blocks (passage_emb_block_*.pb) read/write."""
    emb = rng.randn(5, 4).astype(np.float32)
    ids = np.arange(5, dtype=np.int64)
    w = EmbeddingBlockStore(str(tmp_path / "blk"), fmt="pickle")
    w.write_block(0, emb, ids)
    assert os.path.exists(tmp_path / "blk" / "passage_emb_block_0.pb")

    r = EmbeddingBlockStore.open_auto(str(tmp_path / "blk"))
    assert r.fmt == "pickle"
    e2, i2 = r.read_block(0)
    np.testing.assert_array_equal(e2, emb)
    np.testing.assert_array_equal(i2, ids)


def test_block_store_missing_middle_block_raises(tmp_path, rng):
    store = EmbeddingBlockStore(str(tmp_path / "blk"))
    store.write_block(0, rng.randn(3, 4).astype(np.float32), np.arange(3))
    store.write_block(2, rng.randn(3, 4).astype(np.float32), np.arange(3))
    # declared 3 blocks but block 1 missing -> raise, never silently truncate
    with pytest.raises(FileNotFoundError):
        list(store.iter_blocks(3))
    # auto mode stops at the contiguous prefix
    assert store.num_blocks() == 1


def test_bfloat16_block_store_roundtrip(tmp_path, rng):
    """bfloat16 store halves index bytes (the QReCC 54M memory plan);
    np.save/load roundtrips via ml_dtypes and search accepts the blocks."""
    import ml_dtypes

    emb = rng.randn(40, 8).astype(np.float32).astype(ml_dtypes.bfloat16)
    ids = np.arange(40, dtype=np.int64)
    store = EmbeddingBlockStore(str(tmp_path / "bf16"))
    store.write_block(0, emb, ids)
    e2, i2 = store.read_block(0)
    assert e2.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(e2), np.asarray(emb))

    from haconvdr_tpu.ops.topk import BlockSearcher, exact_topk_oracle
    import jax.numpy as jnp

    q = rng.randn(3, 8).astype(np.float32)
    s, got = BlockSearcher(top_k=5, passage_chunk=8).search(
        q, store.iter_blocks()
    )
    ref_s, ref_i = exact_topk_oracle(
        jnp.asarray(q), jnp.asarray(np.asarray(emb, np.float32)), 5
    )
    np.testing.assert_array_equal(got, np.asarray(ref_i))


def test_encode_corpus_bfloat16_store(tmp_path, rng):
    """encode_corpus(store_dtype='bfloat16') actually writes bf16 blocks."""
    import jax
    import ml_dtypes

    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.index.build import encode_corpus
    from haconvdr_tpu.models.encoder import encode, init_encoder_params

    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=6)
    for pid in range(10):
        w.add(pid, [4 + pid, 5, 6])
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "c"))
    cfg = ModelConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(0), cfg)
    fn = lambda p, ids, mask: encode(p, cfg, ids, mask)  # noqa: E731
    store = encode_corpus(
        corpus, fn, params, str(tmp_path / "e"), batch_size=4,
        per_block_passage_num=8, store_dtype="bfloat16",
    )
    emb, ids = store.read_block(0)
    assert emb.dtype == ml_dtypes.bfloat16


def test_encode_corpus_multi_chunk_output(tmp_path, rng):
    """An encoder emitting [B, n_chunks, D] (long-sequence multi-chunk
    output, gen_doc_embeddings.py:115-121) stores one row per chunk, all
    carrying the passage's offset, in the reference's chunk-major order."""
    from haconvdr_tpu.index.build import encode_corpus

    w = TokenizedCorpusWriter(str(tmp_path / "c"), max_seq_length=4)
    for pid in range(6):
        w.add(pid + 100, [1 + pid, 2])
    w.finalize()
    corpus = TokenizedCorpus(str(tmp_path / "c"))

    D, n_chunks = 3, 2

    def chunked_fn(params, ids, mask):
        import jax.numpy as jnp

        b = ids.shape[0]
        base = jnp.arange(b, dtype=jnp.float32)[:, None, None]
        chunk = jnp.arange(n_chunks, dtype=jnp.float32)[None, :, None]
        return (
            base * 10.0
            + chunk
            + jnp.zeros((b, n_chunks, D))
            + ids[:, :1, None].astype(jnp.float32) * 100.0
        )

    store = encode_corpus(
        corpus, chunked_fn, None, str(tmp_path / "e"), batch_size=4,
        per_block_passage_num=100,
    )
    emb, offs = store.read_block(0)
    # 6 passages over batches of 4 (4 + tail 2) -> 2 chunks each = 12 rows
    assert emb.shape == (6 * n_chunks, D)
    # per drained batch: chunk-major rows, offsets tiled per chunk
    np.testing.assert_array_equal(offs, [0, 1, 2, 3, 0, 1, 2, 3, 4, 5, 4, 5])
    # chunk identity survives in the stored values (row = token*100 + b*10 + chunk)
    first_tok = corpus.tokens[:, 0].astype(np.float32)
    expect_b0 = [first_tok[o] * 100 + (i % 4) * 10 for i, o in enumerate(offs[:4])]
    np.testing.assert_allclose(emb[:4, 0], expect_b0)
    np.testing.assert_allclose(emb[4:8, 0], np.asarray(expect_b0) + 1.0)
